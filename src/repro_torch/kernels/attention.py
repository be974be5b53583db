"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.attention``.  On a CUDA tensor it launches
one of the kernel's two hand-written bodies on the current stream or
raises; on a CPU tensor it runs the plain version ``ref.flash_attention``.
``flash_body`` names the body: the tensor-core one (``"wgmma"``) for bf16
at the LMs' head widths, the scalar one (``"simt"``) for f32, which must
hold 1e-5, and for D = 8, below wgmma's depth.  ``launches`` counts kernel
launches of either body, nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import DTYPE_CODES, check_cuda_operands, check_shape

# The reference kernel's DEFAULT_TILE_Q / DEFAULT_TILE_KV: sequence lengths
# must be multiples (``ops.attention`` pads).  The CUDA bodies' own tiles
# (simt 64 x 64, wgmma 128 q x 64 kv) divide them.
TILE_Q = 128
TILE_KV = 128
HEAD_DIMS = (8, 64, 128)  # the head widths the kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 128)
launches = 0


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The body a CUDA call runs: "wgmma" for bf16 at D in (64, 128), else
    "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "simt"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in
    ``q.dtype``.  Sq and Skv are multiples of 128; ``kv_valid`` is the
    count of real kv positions when k/v were padded (columns at or past it
    are masked).  See ``ref.flash_attention`` for the exact function."""
    global launches
    bsz, sq, hq, dim = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sq % TILE_Q or skv % TILE_KV:
        raise ValueError(f"seq lengths ({sq},{skv}) not multiples of tiles")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads do not group over {hkv} kv heads")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_valid=kv_valid)
    lib = _build.library()
    device = check_cuda_operands("flash_attention", {"q": q, "k": k, "v": v}, q.dtype)
    check_shape("flash_attention", "k", k, (bsz, skv, hkv, dim))
    check_shape("flash_attention", "v", v, (bsz, skv, hkv, dim))
    if dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dim} not in {HEAD_DIMS}")
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {key} must be 16-byte aligned")
    if bsz * hq > 65_535:
        raise ValueError(f"flash_attention: B * Hq = {bsz * hq} exceeds the grid's 65,535 rows")
    valid = skv if kv_valid is None else int(kv_valid)
    if not 0 <= valid <= skv:
        raise ValueError(f"flash_attention: kv_valid {kv_valid} outside [0, {skv}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    body = flash_body(q.dtype, dim)
    launch = lib.repro_flash_attention_wgmma if body == "wgmma" else lib.repro_flash_attention
    with torch.cuda.device(device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, sq, skv, hq, hkv, dim, int(q_offset), valid, int(causal),
            ctypes.c_float(1.0 / dim**0.5), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, f"flash_attention ({body})", err)
    launches += 1
    return out
