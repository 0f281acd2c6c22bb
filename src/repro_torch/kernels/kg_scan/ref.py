"""Plain PyTorch version of the fused triple-scan kernel.

It is the engine's "torch" backend (`engine/primitives.scan_hits`): one
formulation serves as the CPU execution path and as the yardstick the CUDA
kernel is held against on the card.
"""
from __future__ import annotations

from repro_torch.engine.primitives import scan_hits


def scan_hits_ref(triples, valid, spo=None, eq=None):
    """(hit, cum): fused SPO/equality predicate + inclusive int32 hit count.

    triples: (…, N, 3) int32 or None (then hit = valid); valid: (…, N) bool;
    spo: (…, 3) int32 with -1 = wildcard, -2 = never-match; eq: (…, 3) bool
    gates over EQ_PAIRS or None.
    """
    return scan_hits(triples, valid, spo, eq, backend="torch")
