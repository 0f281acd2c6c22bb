"""Placement of the federated KG on the shard mesh.

The JAX package's `kg_specs` / `kg_shardings` put the KG-resident tensors
(triples, valid, the sort permutations) one block per device along the
mesh's shard axis, and replicate the plan data and the parameters. On the
port's mesh each rank is one such device: `kg_local` gives it its own
block, with the shard dim kept (size 1), and every rank receives the same
plan data and parameters.
"""
from __future__ import annotations

import torch


def kg_local(kg, mesh, perms=None):
    """Rank ``mesh.rank``'s ``(triples[r:r+1], valid[r:r+1],
    perms[r:r+1])`` of a `ShardedKG` on the mesh's device: int32 (1, N,
    3), bool (1, N) and int64 (1, 3, N).

    ``perms`` (``engine.batch.shard_perms(kg)``, all shards) is sliced
    when given; otherwise the rank sorts its own block by each triple
    position, stably, as `shard_perms` does.
    """
    r, dev = mesh.rank, mesh.device
    if kg.n_shards != mesh.size:
        raise ValueError(f"the KG has {kg.n_shards} shards, the mesh "
                         f"{mesh.size} ranks")
    tr = torch.from_numpy(kg.triples[r:r + 1]).to(dev)
    va = torch.from_numpy(kg.valid[r:r + 1]).to(dev)
    if perms is not None:
        pe = torch.from_numpy(perms[r:r + 1]).to(dev).long()
    else:
        pe = torch.stack([torch.sort(tr[0, :, pos], stable=True).indices
                          for pos in range(3)])[None]
    return tr, va, pe
