"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H GQA-kv8 ff8192 v202048,
128 experts top-1, alternating dense/MoE layers (early fusion backbone)
[hf:meta-llama/Llama-4-Maverick; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    moe_experts=128, moe_top_k=1, moe_every=2,
)

SMOKE = ModelConfig(
    arch_id="llama4-maverick-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab=256, head_dim=8,
    moe_experts=8, moe_top_k=1, moe_every=2, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
