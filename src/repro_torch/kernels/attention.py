"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.attention``.  On a CUDA tensor it launches
the hand-written kernel on the current stream or raises; on a CPU tensor
it runs the plain version ``ref.flash_attention``.  ``launches`` counts
kernel launches, nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import DTYPE_CODES, check_cuda_operands, check_shape

# The reference kernel's DEFAULT_TILE_Q / DEFAULT_TILE_KV: sequence lengths
# must be multiples (``ops.attention`` pads).  The CUDA kernel's own tiles
# (64 x 64) divide them.
TILE_Q = 128
TILE_KV = 128
HEAD_DIMS = (8, 64, 128)  # the head widths the kernel is instantiated for
launches = 0


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
    with torch.cuda.device(device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, sq, skv, hq, hkv, dim, int(q_offset), valid, int(causal),
            ctypes.c_float(1.0 / dim**0.5), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "flash_attention", err)
    launches += 1
    return out
