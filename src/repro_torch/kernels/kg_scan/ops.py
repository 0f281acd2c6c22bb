"""Public fused triple-scan op: leading-dim folding and dispatch.

A CPU tensor runs the plain version (`ref.scan_hits_ref`); a CUDA tensor
launches the kg_scan kernel, and anything the kernel does not take raises.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.kg_scan.kernel import scan_hits_kernel
from repro_torch.kernels.kg_scan.ref import scan_hits_ref


def scan_hits(triples, valid, spo=None, eq=None):
    """(hit (…, N) bool, cum (…, N) int32): fused triple-pattern predicate
    plus inclusive hit-count prefix sum over shard blocks.

    triples (…, N, 3) int32, valid (…, N) bool, spo (…, 3) int32, eq (…, 3)
    bool or None; leading dims broadcast to valid's. ``triples=None`` makes
    the predicate ``valid`` itself (the prefix sum of a plain mask).
    """
    if valid.device.type == "cpu":
        return scan_hits_ref(triples, valid, spo, eq)
    lead = valid.shape[:-1]
    n = valid.shape[-1]
    flat = valid.reshape(-1, n).contiguous()
    t = s = e = None
    if triples is not None:
        t = triples.expand(*lead, n, 3).reshape(-1, n, 3).contiguous()
        s = spo.expand(*lead, 3).reshape(-1, 3).contiguous()
        if eq is not None:
            e = eq.expand(*lead, 3).reshape(-1, 3).contiguous()
    hit, cum = scan_hits_kernel(t, flat, s, e)
    scan_hits.launches += 1
    hit = valid if hit is None else hit.reshape(valid.shape)
    return hit, cum.reshape(valid.shape)


scan_hits.launches = 0

