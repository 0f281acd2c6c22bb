"""Graph pipelines: synthetic benchmark-shaped graphs, a real fanout neighbor
sampler over CSR (the minibatch_lg requirement), and padded GraphBatch
construction for every assigned GNN shape.

Every array is drawn in numpy with the same generator calls, in the same
order, as the reference's `data/graphs.py`, and only then becomes a tensor
on the requested device: the same seed gives the same graph bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.engine.batch import resolve_device
from repro_torch.models.gnn.common import GraphBatch

GNN_SHAPE_SIZES = {
    # name: (n_nodes, n_edges) targets of the assigned shapes
    "full_graph_sm": (2_708, 10_556),
    "minibatch_lg": (232_965, 114_615_892),
    "ogb_products": (2_449_029, 61_859_140),
    "molecule": (30 * 128, 64 * 128),
}


@dataclass
class CSRGraph:
    indptr: np.ndarray
    indices: np.ndarray
    n_nodes: int

    @staticmethod
    def from_edges(senders, receivers, n_nodes: int) -> "CSRGraph":
        order = np.argsort(receivers, kind="stable")
        s, r = senders[order], receivers[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr, s.astype(np.int32), n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def synthetic_graph(n_nodes: int, n_edges: int, *, seed: int = 0,
                    power_law: bool = True):
    """(senders, receivers) with a power-law-ish degree profile."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = rng.pareto(1.5, n_nodes) + 1.0
        p = w / w.sum()
        senders = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
        receivers = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    else:
        senders = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        receivers = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return senders, receivers


def neighbor_sample(csr: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                    rng: np.random.Generator):
    """GraphSAGE-style layered fanout sampling (the minibatch_lg sampler).

    Returns (node_ids, senders, receivers): global ids of all visited nodes
    plus sampled edges in the LOCAL index space of node_ids. Layer l samples
    up to fanouts[l] in-neighbors of the previous layer's frontier."""
    nodes: list[int] = [int(v) for v in seeds.tolist()]
    index = {v: i for i, v in enumerate(nodes)}
    s_out: list[int] = []
    r_out: list[int] = []
    frontier = list(nodes)
    for fan in fanouts:
        nxt: list[int] = []
        for v in frontier:
            nb = csr.neighbors(v)
            if nb.shape[0] == 0:
                continue
            take = nb if nb.shape[0] <= fan else rng.choice(
                nb, fan, replace=False)
            for u in (int(x) for x in take):
                if u not in index:
                    index[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                s_out.append(index[u])
                r_out.append(index[v])
        frontier = nxt
    return (np.asarray(nodes, np.int64), np.asarray(s_out, np.int32),
            np.asarray(r_out, np.int32))


def _pad_to(x: np.ndarray, n: int, fill=0):
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def make_graph_batch(shape_id: str, *, d_feat: int, n_classes: int,
                     seed: int = 0, reduced: bool = False,
                     fanouts=(15, 10), batch_nodes: int = 1024,
                     device="cuda") -> GraphBatch:
    """Build a padded GraphBatch for an assigned GNN shape on ``device``.

    reduced=True shrinks sizes ~1000x for CPU tests. At full size the
    ogb_products batch holds 2,449,029 nodes and 64,308,169 edges (self
    loops included). Geometric models read positions/species; GCN reads
    node_feat; every batch carries all of them so any arch runs on any
    shape.
    """
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(seed)
    if shape_id == "minibatch_lg":
        n_base, e_base = ((4_000, 40_000) if reduced
                          else GNN_SHAPE_SIZES["minibatch_lg"])
        bn = min(batch_nodes, 64 if reduced else batch_nodes)
        s, r = synthetic_graph(n_base, e_base, seed=seed)
        csr = CSRGraph.from_edges(s, r, n_base)
        seeds = rng.choice(n_base, bn, replace=False)
        nodes, ls, lr = neighbor_sample(csr, seeds, list(fanouts), rng)
        n_pad = _round_up(max(len(nodes), 1), 128)
        e_pad = _round_up(max(len(ls), 1), 512)
        n, e = len(nodes), len(ls)
        node_feat = rng.normal(size=(n, d_feat)).astype(np.float32)
        labels = rng.integers(0, n_classes, n).astype(np.int32)
        lmask = np.zeros(n, bool)
        lmask[:bn] = True                    # loss on seed nodes only
        return GraphBatch(
            node_feat=t(_pad_to(node_feat, n_pad)),
            positions=t(_pad_to(
                rng.normal(size=(n, 3)).astype(np.float32), n_pad)),
            senders=t(_pad_to(ls, e_pad)),
            receivers=t(_pad_to(lr, e_pad)),
            edge_mask=t(_pad_to(np.ones(e, bool), e_pad, False)),
            node_mask=t(_pad_to(np.ones(n, bool), n_pad, False)),
            labels=t(_pad_to(labels, n_pad)),
            label_mask=t(_pad_to(lmask, n_pad, False)),
            graph_ids=t(np.zeros(n_pad, np.int32)), n_graphs=1,
            species=t(_pad_to(
                rng.integers(0, 16, n).astype(np.int32), n_pad)))

    if shape_id == "molecule":
        n_per, e_per = 30, 64
        bsz = 8 if reduced else 128
        n, e = n_per * bsz, e_per * bsz
        senders = np.concatenate([
            rng.integers(0, n_per, e_per) + g * n_per for g in range(bsz)
        ]).astype(np.int32)
        receivers = np.concatenate([
            rng.integers(0, n_per, e_per) + g * n_per for g in range(bsz)
        ]).astype(np.int32)
        gid = np.repeat(np.arange(bsz, dtype=np.int32), n_per)
        species = rng.integers(0, 16, n).astype(np.int32)
        feat = np.eye(d_feat, dtype=np.float32)[species % d_feat]
        return GraphBatch(
            node_feat=t(feat),
            positions=t(rng.normal(size=(n, 3)).astype(np.float32)),
            senders=t(senders), receivers=t(receivers),
            edge_mask=t(np.ones(e, bool)), node_mask=t(np.ones(n, bool)),
            labels=t(rng.integers(0, n_classes, n).astype(np.int32)),
            label_mask=t(np.ones(n, bool)),
            graph_ids=t(gid), n_graphs=bsz,
            species=t(species))

    # full-batch shapes
    n, e = GNN_SHAPE_SIZES[shape_id]
    if reduced:
        n, e = max(n // 1000, 64), max(e // 1000, 256)
    s, r = synthetic_graph(n, e, seed=seed)
    # add self loops (GCN convention)
    s = np.concatenate([s, np.arange(n, dtype=np.int32)])
    r = np.concatenate([r, np.arange(n, dtype=np.int32)])
    e2 = e + n
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    return GraphBatch(
        node_feat=t(rng.normal(size=(n, d_feat)).astype(np.float32)),
        positions=t(rng.normal(size=(n, 3)).astype(np.float32) * 3),
        senders=t(s), receivers=t(r),
        edge_mask=t(np.ones(e2, bool)), node_mask=t(np.ones(n, bool)),
        labels=t(labels), label_mask=t(np.ones(n, bool)),
        graph_ids=t(np.zeros(n, np.int32)), n_graphs=1,
        species=t(rng.integers(0, 16, n).astype(np.int32)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
