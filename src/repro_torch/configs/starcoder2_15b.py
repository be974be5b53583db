"""starcoder2-15b [dense]: 40L d6144 48H GQA-kv4 ff24576 v49152.
GQA + RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128,
)

SMOKE = ModelConfig(
    arch_id="starcoder2-15b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=256, head_dim=8, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
