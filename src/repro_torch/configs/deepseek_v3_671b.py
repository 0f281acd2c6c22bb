"""deepseek-v3-671b [arXiv:2412.19437]: 61L MLA, 1 shared + 256 routed top-8,
MTP depth 1, first 3 layers dense (d_ff 18432).

256 experts / 16-wide model axis -> true EP (16 experts per column); training
state needs FSDP + bf16 moments and still exceeds a single 16GB/chip pod —
see EXPERIMENTS.md §Dry-run for the honest memory table."""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_head=128, d_ff=18432, vocab_size=129280,
        mlp="swiglu", attn="mla",
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        moe=True, n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
        shared_d_ff=2048, first_dense_layers=3, capacity_factor=1.25,
        mtp_depth=1, rope_theta=10_000.0)


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=192, vocab_size=512, mlp="swiglu",
        attn="mla", q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16,
        moe=True, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=48,
        shared_d_ff=48, first_dense_layers=1, capacity_factor=2.0,
        mtp_depth=1)
