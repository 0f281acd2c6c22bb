"""granite-3-8b [hf:ibm-granite/granite-3.0-8b-base]: dense 40L GQA(kv=8).

vocab 49,155 is padded to 49,280 (=16*3,080) for TP divisibility (DESIGN §5).
"""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full() -> LMConfig:
    return LMConfig(
        name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=12800, vocab_size=49155,
        mlp="swiglu", rope_theta=10_000.0)


def smoke() -> LMConfig:
    return LMConfig(
        name="granite-3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=160, vocab_size=512, mlp="swiglu")
