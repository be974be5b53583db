"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H GQA-kv8 ff24576 v65536,
MoE 16e top-2.  Mamba:attn 7:1 interleave, MoE every other layer
[arXiv:2403.19887; hf].  Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    moe_experts=16, moe_top_k=2, moe_every=2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=8,
    attn_every=8, subquadratic=True,
)

SMOKE = ModelConfig(
    arch_id="jamba-1.5-large-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=8,
    moe_experts=4, moe_top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=2,
    attn_every=8, ssm_chunk=16, subquadratic=True, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
