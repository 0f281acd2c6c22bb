"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L MHA(kv=16), 60 routed
experts top-4 + 4 shared (shared_d_ff = 4 * 1408 = 5632).

60 experts do not divide the 16-wide model axis -> expert-TP over d_ff
(DESIGN §5)."""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full() -> LMConfig:
    return LMConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=5632, vocab_size=151936,
        mlp="swiglu", moe=True, n_experts=60, top_k=4, n_shared_experts=4,
        moe_d_ff=1408, shared_d_ff=5632, first_dense_layers=0,
        capacity_factor=1.25, rope_theta=1_000_000.0)


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=512, mlp="swiglu",
        moe=True, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=32,
        shared_d_ff=128, capacity_factor=2.0)
