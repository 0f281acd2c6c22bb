"""Plain PyTorch versions of the fused triple-scan kernel's two epilogues.

They are the engine's "torch" backend (`engine/primitives.scan_hits`,
`engine/primitives.scan_select`): one formulation serves as the CPU
execution path and as the yardstick the CUDA kernel is held against on the
card.
"""
from __future__ import annotations

from repro_torch.engine.primitives import scan_hits, scan_select


def scan_hits_ref(triples, valid, spo=None, eq=None, *,
                  with_cum: bool = True):
    """(hit, cum): fused SPO/equality predicate + inclusive int32 hit count
    (None unless ``with_cum``).

    triples: (…, N, 3) int32 or None (then hit = valid); valid: (…, N) bool;
    spo: (…, 3) int32 with -1 = wildcard, -2 = never-match; eq: (…, 3) bool
    gates over EQ_PAIRS or None.
    """
    return scan_hits(triples, valid, spo, eq, backend="torch",
                     with_cum=with_cum)


def scan_select_ref(triples, valid, cap: int, spo=None, eq=None, *,
                    with_hit: bool = True):
    """(hit or None, idx, sel, total): the stable compaction of the same
    predicate's hits by the torch backend's route, an int32 ``cumsum`` and
    a ``searchsorted`` for 1..k (k = min(cap, N))."""
    return scan_select(triples, valid, cap, spo, eq, backend="torch",
                       with_hit=with_hit)
