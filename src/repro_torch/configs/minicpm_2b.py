"""minicpm-2b [dense]: 40L d2304 36H MHA(kv=36) ff5760 v122753.
WSD schedule, tied embeddings, llama-like arch [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="minicpm-2b-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
    d_ff=120, vocab=256, head_dim=8, tie_embeddings=True, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
