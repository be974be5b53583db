"""Model and shape configuration dataclasses, a copy of ``repro.configs.base``.

``attn_impl`` names an impl of ``repro_torch.kernels.ops.attention``:
"ref" (the oracle, the reference's default) or "auto"/"cuda" (the flash
kernel).  The serving launcher asks for the kernel explicitly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                # dense | moe | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1         # every n-th layer has an MoE FFN (1 = all)
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    attn_every: int = 1        # hybrid: 1 attention sublayer per n sublayers
    # --- misc -------------------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "float32"    # master weights (train); bf16 for serve
    compute_dtype: str = "bfloat16"
    remat: str = "dots"        # none | dots | full (scan-block remat policy)
    input_kind: str = "tokens"  # tokens | embeddings (vlm/audio stub frontends)
    scan_layers: bool = True
    attn_impl: str = "ref"     # kernels.ops impl selector
    # annotate why long_500k is skipped (full-attention archs)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_size(self) -> int:
        """Layers per scan block (hybrid: attn_every; moe-interleave: moe_every)."""
        if self.family == "hybrid":
            return self.attn_every
        if self.family == "moe" and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_size == 0
        return self.n_layers // self.block_size

    def param_count(self) -> int:
        """Analytic total parameter count (for 6ND roofline math)."""
        from repro_torch.models import model as model_lib

        return model_lib.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model as model_lib

        return model_lib.param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
