"""LUBM engine config (the paper's own evaluation workload); a copy of the
JAX package's, which tests/test_torch_rewriter.py holds equal to it."""
from dataclasses import dataclass


@dataclass(frozen=True)
class KGEngineConfig:
    name: str = "lubm"
    n_universities: int = 1
    scale: float = 1.0
    n_shards: int = 3
    linkage: str = "single"
    balance_tol: float = 0.15
    join_impl: str = "expand"      # paper-faithful baseline
    max_per_row: int = 64
    seed: int = 0


def full() -> KGEngineConfig:
    return KGEngineConfig()


def smoke() -> KGEngineConfig:
    return KGEngineConfig(name="lubm-smoke", scale=0.2)
