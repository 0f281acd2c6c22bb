"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 RBF, cutoff 5."""
from repro_torch.models.gnn.nequip import NequIPConfig

FAMILY = "gnn"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def full() -> NequIPConfig:
    return NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0)


def smoke() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                        n_rbf=4, cutoff=5.0)
