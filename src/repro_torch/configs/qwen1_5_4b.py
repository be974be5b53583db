"""qwen1.5-4b [dense]: 40L d2560 20H MHA(kv=20) ff6912 v151936.
QKV bias [hf:Qwen/Qwen1.5-4B].  The 152k vocab is the NTTD-embedding
compression showcase (see repro.models.nttd_embed)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="qwen1.5-4b-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
    d_ff=128, vocab=512, head_dim=8, qkv_bias=True, remat="none",
    param_dtype="float32", compute_dtype="float32",
)
