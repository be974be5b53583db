"""grok-1-314b [moe]: 64L d6144 48H GQA-kv8 ff32768 v131072, 8 experts top-2.
Every layer MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    moe_experts=8, moe_top_k=2, moe_every=1,
)

SMOKE = ModelConfig(
    arch_id="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=8,
    moe_experts=4, moe_top_k=2, moe_every=1, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
