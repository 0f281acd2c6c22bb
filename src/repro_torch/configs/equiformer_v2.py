"""equiformer-v2 [arXiv:2306.12059]: 12 layers, 128 channels, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN convolutions."""
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

FAMILY = "gnn"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def full() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                              l_max=6, m_max=2, n_heads=8)


def smoke() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2,
                              d_hidden=16, l_max=3, m_max=2, n_heads=4)
