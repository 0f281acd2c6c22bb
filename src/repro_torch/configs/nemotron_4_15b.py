"""nemotron-4-15b [arXiv:2402.16819]: 32L GQA(kv=8), squared-ReLU MLP,
vocab 256,000."""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full() -> LMConfig:
    return LMConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=24576, vocab_size=256000,
        mlp="relu2", rope_theta=10_000.0)


def smoke() -> LMConfig:
    return LMConfig(
        name="nemotron-4-15b-smoke", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=2, d_head=8, d_ff=192, vocab_size=1024, mlp="relu2")
