"""deepseek-coder-33b [dense]: 62L d7168 56H GQA-kv8 ff19200 v32256.
Llama-arch (RMSNorm, RoPE, SwiGLU, GQA) [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
)

SMOKE = ModelConfig(
    arch_id="deepseek-coder-33b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256, head_dim=8, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
