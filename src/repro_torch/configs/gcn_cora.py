"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean agg, sym norm."""
from repro_torch.models.gnn.gcn import GCNConfig

FAMILY = "gnn"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]

# per-shape input feature/class dims (the graph pipeline matches these)
SHAPE_DIMS = {
    "full_graph_sm": dict(d_feat=1433, n_classes=7),     # Cora
    "minibatch_lg": dict(d_feat=602, n_classes=41),      # Reddit-scale
    "ogb_products": dict(d_feat=100, n_classes=47),      # ogbn-products
    "molecule": dict(d_feat=16, n_classes=4),            # one-hot species
}


def full(shape: str = "full_graph_sm") -> GCNConfig:
    d = SHAPE_DIMS[shape]
    return GCNConfig(name="gcn-cora", n_layers=2, d_in=d["d_feat"],
                     d_hidden=16, n_classes=d["n_classes"], norm="sym")


def smoke() -> GCNConfig:
    return GCNConfig(name="gcn-smoke", n_layers=2, d_in=32, d_hidden=16,
                     n_classes=7)
