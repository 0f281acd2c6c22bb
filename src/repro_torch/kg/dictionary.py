"""String <-> int32 dictionary encoding for RDF terms.

Every IRI / literal in the knowledge graph is interned to a dense int32 id.
This is the tensor-world replacement for Virtuoso's term dictionary: triples
become an (N, 3) int32 array and all engine work happens on integers.
"""
from __future__ import annotations

from typing import Iterable


class Dictionary:
    """Bidirectional term dictionary with dense int ids."""

    def __init__(self) -> None:
        self._term_to_id: dict[str, int] = {}
        self._id_to_term: list[str] = []

    def __len__(self) -> int:
        return len(self._id_to_term)

    def intern(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
        return tid

    def intern_all(self, terms: Iterable[str]) -> list[int]:
        return [self.intern(t) for t in terms]

    def id_of(self, term: str) -> int:
        """Lookup without interning. Raises KeyError if absent."""
        return self._term_to_id[term]

    def __contains__(self, term: str) -> bool:
        return term in self._term_to_id

    def term_of(self, tid: int) -> str:
        return self._id_to_term[tid]

    def decode(self, ids: Iterable[int]) -> list[str]:
        return [self._id_to_term[i] for i in ids]
