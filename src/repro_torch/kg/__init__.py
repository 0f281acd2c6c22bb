"""Knowledge-graph substrate: dictionary encoding, triple store, generators, query IR."""
from repro_torch.kg.dictionary import Dictionary
from repro_torch.kg.query import Term, Var, Const, TriplePattern, Query
from repro_torch.kg.triples import TripleStore

__all__ = ["Dictionary", "Term", "Var", "Const", "TriplePattern", "Query", "TripleStore"]
