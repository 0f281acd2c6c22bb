"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from repro_torch.models.gnn.egnn import EGNNConfig

FAMILY = "gnn"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def full() -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64)


def smoke() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16)
