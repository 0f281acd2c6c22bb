"""granite-20b-code [arXiv:2405.04324]: 52L MQA (kv=1), GPT-BigCode-style
non-gated GELU MLP (d_ff = 4 * d_model)."""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full() -> LMConfig:
    return LMConfig(
        name="granite-20b", n_layers=52, d_model=6144, n_heads=48,
        n_kv_heads=1, d_head=128, d_ff=24576, vocab_size=49152,
        mlp="gelu", rope_theta=10_000.0)


def smoke() -> LMConfig:
    return LMConfig(
        name="granite-20b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_head=16, d_ff=256, vocab_size=512, mlp="gelu")
