"""musicgen-medium [audio]: 48L d1536 24H MHA(kv=24) ff6144 v2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB per
assignment (input_specs() provides frame embeddings) [arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64, input_kind="embeddings",
)

SMOKE = ModelConfig(
    arch_id="musicgen-medium-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
    d_ff=96, vocab=128, head_dim=8, input_kind="embeddings", remat="none",
    param_dtype="float32", compute_dtype="float32",
)
