"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, MLP 400-400."""
from repro_torch.models.recsys.xdeepfm import XDeepFMConfig, default_vocab_sizes

FAMILY = "recsys"
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

# requests per forward of the two serving shapes
SERVE_BATCH = {"serve_p99": 512, "serve_bulk": 262144}
# examples per step of the train_batch shape (the reference's
# launch/cells.RECSYS_SHAPE_DEFS)
TRAIN_BATCH = 65536


def full() -> XDeepFMConfig:
    return XDeepFMConfig(name="xdeepfm", n_sparse=39, n_dense=13,
                         embed_dim=10, cin_layers=(200, 200, 200),
                         mlp_layers=(400, 400),
                         vocab_sizes=default_vocab_sizes(39))


def smoke() -> XDeepFMConfig:
    return XDeepFMConfig(name="xdeepfm-smoke", n_sparse=39, n_dense=13,
                         embed_dim=10, cin_layers=(20, 20), mlp_layers=(32,),
                         vocab_sizes=tuple([500] * 39))
