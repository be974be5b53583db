"""internvl2-76b [vlm]: 80L d8192 64H GQA-kv8 ff28672 v128256.
InternViT frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings (input_kind='embeddings' for prefill).
Backbone = llama-3-70b-style dense decoder [arXiv:2404.16821; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128, input_kind="embeddings",
)

SMOKE = ModelConfig(
    arch_id="internvl2-76b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256, head_dim=8, input_kind="embeddings", remat="none",
    param_dtype="float32", compute_dtype="float32",
)
