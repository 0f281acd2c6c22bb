"""Public fused triple-scan ops: leading-dim folding and dispatch.

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches the
kg_scan kernel, and anything the kernel does not take raises. There is no
fallback from the card to the plain version. Each op call on the card is
one launch of the one-pass scan (after the zeroing of its tile status).
A meta tensor gets meta outputs and its work counted in
`kernels.meta_cost` (see the package's docstring).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import is_meta, lead_strides, meta_cost, nbytes
from repro_torch.kernels.kg_scan.kernel import MAX_LEAD, scan_kernel
from repro_torch.kernels.kg_scan.ref import scan_hits_ref, scan_select_ref


def _fold(triples, valid, spo, eq):
    """The inputs as the kernel reads them, in place: their last dims made
    contiguous where they are not, and their strides over valid's leading
    dims (0 where broadcast); more than MAX_LEAD leading dims are folded
    into one by a copy. Returns (triples, valid, spo, eq, lead, strides)
    with strides per input in that order: valid, triples, spo, eq."""
    lead = tuple(valid.shape[:-1])
    n = valid.shape[-1]
    if len(lead) > MAX_LEAD:
        valid = valid.reshape(-1, n)
        if triples is not None:
            triples = triples.expand(*lead, n, 3).reshape(-1, n, 3)
            spo = spo.expand(*lead, 3).reshape(-1, 3)
            if eq is not None:
                eq = eq.expand(*lead, 3).reshape(-1, 3)
        lead = (valid.shape[0],)
    if n > 1 and valid.stride(-1) != 1:
        valid = valid.contiguous()
    if triples is not None:
        if triples.stride(-1) != 1 or (n > 1 and triples.stride(-2) != 3):
            triples = triples.contiguous()
        if spo.stride(-1) != 1:
            spo = spo.contiguous()
        if eq is not None and eq.stride(-1) != 1:
            eq = eq.contiguous()
    strides = (lead_strides(valid, 1, lead), lead_strides(triples, 2, lead),
               lead_strides(spo, 1, lead), lead_strides(eq, 1, lead))
    return triples, valid, spo, eq, lead, strides


def _meta_lead(triples, valid, spo, eq) -> torch.Size:
    return torch.broadcast_shapes(
        valid.shape[:-1], *(() if t is None else t.shape[:t.dim() - n]
                            for t, n in ((triples, 2), (spo, 1), (eq, 1))))


def _meta_count(name, triples, valid, spo, eq, rows, out_bytes) -> None:
    """The scan's bound: its inputs read once, ``out_bytes`` written, 20
    integer operations a row with a pattern (2 over a plain mask)."""
    n_bytes = nbytes(valid) + nbytes(triples) + nbytes(spo) + nbytes(eq)
    meta_cost.add(name, ops=rows * (2 if triples is None else 20),
                  n_bytes=n_bytes + out_bytes)


def _meta_hits(triples, valid, spo, eq, with_cum):
    lead = _meta_lead(triples, valid, spo, eq)
    n = valid.shape[-1]
    rows = lead.numel() * n
    hit = valid if triples is None else torch.empty(
        (*lead, n), dtype=torch.bool, device="meta")
    cum = torch.empty((*lead, n), dtype=torch.int32, device="meta") \
        if with_cum else None
    _meta_count("scan_hits", triples, valid, spo, eq, rows,
                (0 if triples is None else rows) + (rows * 4 if with_cum
                                                    else 0))
    return hit, cum


def _meta_select(triples, valid, cap, spo, eq, with_hit):
    lead = _meta_lead(triples, valid, spo, eq)
    n = valid.shape[-1]
    k = min(cap, n)
    rows = lead.numel() * n
    hit = None if triples is None or not with_hit else torch.empty(
        (*lead, n), dtype=torch.bool, device="meta")
    _meta_count("scan_select", triples, valid, spo, eq, rows,
                (0 if hit is None else rows) + lead.numel() * (k * 5 + 4))
    return (hit, torch.empty((*lead, k), dtype=torch.int32, device="meta"),
            torch.empty((*lead, k), dtype=torch.bool, device="meta"),
            torch.empty(lead, dtype=torch.int32, device="meta"))


def scan_hits(triples, valid, spo=None, eq=None, *, with_cum: bool = True):
    """(hit (…, N) bool, cum (…, N) int32): fused triple-pattern predicate
    plus inclusive hit-count prefix sum over shard blocks.

    triples (…, N, 3) int32, valid (…, N) bool, spo (…, 3) int32, eq (…, 3)
    bool or None; leading dims broadcast to valid's and are read in place.
    ``triples=None`` makes the predicate ``valid`` itself (the prefix sum
    of a plain mask). Without ``with_cum`` the kernel writes only hit (no
    count, no look-back) and cum is None; that form needs the triples.
    """
    if triples is None and not with_cum:
        raise ValueError("scan_hits without cum needs the triples")
    if valid.device.type == "cpu":
        return scan_hits_ref(triples, valid, spo, eq, with_cum=with_cum)
    if is_meta(valid):
        return _meta_hits(triples, valid, spo, eq, with_cum)
    t, v, s, e, lead, strides = _fold(triples, valid, spo, eq)
    hit, cum = scan_kernel(t, v, s, e, lead, strides, with_cum=with_cum)
    scan_hits.launches += 1
    if v.dim() != valid.dim():                  # leading dims were folded
        hit = None if hit is None else hit.reshape(valid.shape)
        cum = None if cum is None else cum.reshape(valid.shape)
    return (valid if hit is None else hit), cum


scan_hits.launches = 0


def scan_select(triples, valid, cap: int, spo=None, eq=None, *,
                with_hit: bool = True):
    """(hit (…, N) bool or None, idx (…, k) int32, sel (…, k) bool, total
    (…,) int32) with k = min(cap, N): the stable compaction of the fused
    predicate's hits, ``select_from_cum(scan_hits(…)[1], cap)`` bit for
    bit, without an (…, N) prefix sum on the card.

    idx[…, j] is the row of the (j+1)-th hit, N - 1 past ``total``; sel =
    arange(k) < total; hit is None when ``triples`` is None or not
    ``with_hit`` (then it is neither allocated nor written). The kernel
    writes the others. Arguments as for `scan_hits`.
    """
    if valid.device.type == "cpu":
        return scan_select_ref(triples, valid, cap, spo, eq,
                               with_hit=with_hit)
    n = valid.shape[-1]
    if n == 0:
        raise ValueError("scan_select needs at least one row")
    if is_meta(valid):
        return _meta_select(triples, valid, cap, spo, eq, with_hit)
    k = min(cap, n)
    t, v, s, e, lead, strides = _fold(triples, valid, spo, eq)
    out = scan_kernel(t, v, s, e, lead, strides, k=k, with_hit=with_hit)
    scan_select.launches += 1
    if v.dim() != valid.dim():                  # leading dims were folded
        hit, idx, sel, total = out
        lead_shape = valid.shape[:-1]
        out = (None if hit is None else hit.reshape(valid.shape),
               idx.reshape(*lead_shape, k), sel.reshape(*lead_shape, k),
               total.reshape(lead_shape))
    return out


scan_select.launches = 0
