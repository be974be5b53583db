"""mamba2-1.3b [ssm]: 48L d2048 attn-free, ssm_state=128, SSD
[arXiv:2405.21060; unverified].  Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    subquadratic=True,
)

SMOKE = ModelConfig(
    arch_id="mamba2-1.3b-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256, head_dim=0,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
    ssm_chunk=16, subquadratic=True, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
