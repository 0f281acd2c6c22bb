"""BSBM engine config (the paper's second evaluation workload); a copy of
the JAX package's, which tests/test_torch_rewriter.py holds equal to it."""
from repro_torch.configs.lubm import KGEngineConfig


def full() -> KGEngineConfig:
    return KGEngineConfig(name="bsbm", n_universities=0, scale=1.0,
                          n_shards=3)


def smoke() -> KGEngineConfig:
    return KGEngineConfig(name="bsbm-smoke", n_universities=0, scale=0.2)
