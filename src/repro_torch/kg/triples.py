"""Dictionary-encoded triple store with sorted tensor indexes.

This is the tensor analogue of the paper's Lucene-indexed Virtuoso store:
an (N, 3) int32 array plus three sorted permutations (PSO, POS, SPO) and a
predicate run table, so that materializing a *Predicate* (P) or
*Predicate-Object* (PO) feature — "all triples sharing p (and o)" — is a
binary-search range, not a scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch.kg.dictionary import Dictionary

S, P, O = 0, 1, 2


def _lex_order(tr: np.ndarray, cols: tuple[int, ...]) -> np.ndarray:
    # np.lexsort sorts by last key first
    keys = tuple(tr[:, c] for c in reversed(cols))
    return np.lexsort(keys).astype(np.int64)


@dataclass
class TripleStore:
    triples: np.ndarray  # (N, 3) int32
    dictionary: Dictionary

    @staticmethod
    def from_string_triples(striples: list[tuple[str, str, str]],
                            dictionary: Dictionary | None = None) -> "TripleStore":
        d = dictionary if dictionary is not None else Dictionary()
        arr = np.asarray(
            [[d.intern(s), d.intern(p), d.intern(o)] for (s, p, o) in striples],
            dtype=np.int32,
        ).reshape(-1, 3)
        arr = np.unique(arr, axis=0)  # RDF set semantics
        return TripleStore(arr, d)

    def __len__(self) -> int:
        return int(self.triples.shape[0])

    # ---- sorted indexes ------------------------------------------------
    @cached_property
    def order_pso(self) -> np.ndarray:
        return _lex_order(self.triples, (P, S, O))

    @cached_property
    def order_pos(self) -> np.ndarray:
        return _lex_order(self.triples, (P, O, S))

    @cached_property
    def order_spo(self) -> np.ndarray:
        return _lex_order(self.triples, (S, P, O))

    @cached_property
    def _p_sorted(self) -> np.ndarray:
        return self.triples[self.order_pos]

    # ---- feature materialization (the paper's Lucene role) -------------
    def predicate_range(self, p: int) -> tuple[int, int]:
        """[lo, hi) of triples with predicate p in POS order."""
        col = self._p_sorted[:, P]
        lo = int(np.searchsorted(col, p, side="left"))
        hi = int(np.searchsorted(col, p, side="right"))
        return lo, hi

    def p_feature_rows(self, p: int) -> np.ndarray:
        """Row indices (into self.triples) of the P(p) feature."""
        lo, hi = self.predicate_range(p)
        return self.order_pos[lo:hi]

    def po_feature_rows(self, p: int, o: int) -> np.ndarray:
        """Row indices of the PO(p, o) feature."""
        lo, hi = self.predicate_range(p)
        ocol = self._p_sorted[lo:hi, O]
        olo = int(np.searchsorted(ocol, o, side="left"))
        ohi = int(np.searchsorted(ocol, o, side="right"))
        return self.order_pos[lo + olo: lo + ohi]

    def p_feature_size(self, p: int) -> int:
        lo, hi = self.predicate_range(p)
        return hi - lo

    def po_feature_size(self, p: int, o: int) -> int:
        return int(self.po_feature_rows(p, o).shape[0])

    @cached_property
    def predicates(self) -> np.ndarray:
        """Distinct predicate ids present in the store."""
        return np.unique(self.triples[:, P])

    def objects_of_predicate(self, p: int) -> np.ndarray:
        lo, hi = self.predicate_range(p)
        return np.unique(self._p_sorted[lo:hi, O])

    # ---- pattern scan (host-side oracle; the JAX engine mirrors this) --
    def scan(self, s: int | None, p: int | None, o: int | None) -> np.ndarray:
        """Triples matching the given constants (None = wildcard). (M,3)."""
        tr = self.triples
        mask = np.ones(len(tr), dtype=bool)
        if s is not None:
            mask &= tr[:, S] == s
        if p is not None:
            mask &= tr[:, P] == p
        if o is not None:
            mask &= tr[:, O] == o
        return tr[mask]
