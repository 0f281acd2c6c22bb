"""Basic-graph-pattern query IR.

A query is a conjunction of triple patterns over variables and constants —
the SPARQL BGP fragment that WawPart's analysis operates on (the paper's
queries are BGPs plus occasional FILTERs, which do not affect partitioning).
Terms are stored symbolically (strings); `bind()` resolves constants through
the dataset dictionary into int ids for the engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union


@dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"?{self.name}"


@dataclass(frozen=True)
class Const:
    term: str

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{self.term}>"


Term = Union[Var, Const]


@dataclass(frozen=True)
class TriplePattern:
    s: Term
    p: Term
    o: Term

    def vars(self) -> tuple[str, ...]:
        out = []
        for t in (self.s, self.p, self.o):
            if isinstance(t, Var) and t.name not in out:
                out.append(t.name)
        return tuple(out)

    def constants(self) -> tuple[str, ...]:
        return tuple(t.term for t in (self.s, self.p, self.o) if isinstance(t, Const))


@dataclass(frozen=True)
class Query:
    name: str
    patterns: tuple[TriplePattern, ...]
    select: tuple[str, ...] = field(default=())

    def __post_init__(self) -> None:
        if not self.select:
            # default: select all variables in pattern order
            seen: list[str] = []
            for pat in self.patterns:
                for v in pat.vars():
                    if v not in seen:
                        seen.append(v)
            object.__setattr__(self, "select", tuple(seen))

    def vars(self) -> tuple[str, ...]:
        seen: list[str] = []
        for pat in self.patterns:
            for v in pat.vars():
                if v not in seen:
                    seen.append(v)
        return tuple(seen)

    def join_edges(self) -> list[tuple[int, int, str]]:
        """(i, j, kind) for every pair of patterns sharing a variable.

        kind is the paper's join-shape feature: SS (subject-subject star),
        OS (object-subject elbow), OO (object-object), or a combination key
        when a variable occurs in predicate position (rare; flagged 'PV').
        """
        edges: list[tuple[int, int, str]] = []
        pats = self.patterns
        for i in range(len(pats)):
            for j in range(i + 1, len(pats)):
                for kind_i, ti in (("S", pats[i].s), ("P", pats[i].p), ("O", pats[i].o)):
                    for kind_j, tj in (("S", pats[j].s), ("P", pats[j].p), ("O", pats[j].o)):
                        if isinstance(ti, Var) and isinstance(tj, Var) and ti.name == tj.name:
                            if kind_i == "P" or kind_j == "P":
                                kind = "PV"
                            else:
                                pair = "".join(sorted((kind_i, kind_j)))
                                kind = {"SS": "SS", "OS": "OS", "OO": "OO"}[pair]
                            edges.append((i, j, kind))
        return edges


def v(name: str) -> Var:
    return Var(name)


def c(term: str) -> Const:
    return Const(term)
