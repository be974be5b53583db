"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.attention``.  On a CUDA tensor it launches
one of the kernel's two hand-written bodies on the current stream or
raises; on a CPU tensor it runs the plain version ``ref.flash_attention``.
``flash_body`` names the body: ``"wgmma"``, bf16 tensor-core products, for
bf16 at the LMs' head widths (64, 128); ``"tf32x3"``, each product as three
TF32 tensor-core products of operands split into hi and lo parts, for f32,
which must hold 1e-5, and for bf16 at D = 8, below the bf16 products'
depth of 16.  ``tf32x3_plan`` chooses that body's launch, built into
the kernel (``_build.flash_flags``).  ``launches``
counts kernel launches of either body, ``tf32x3_launches`` those of the
tf32x3 body alone, nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    MAX_SMEM_BYTES,
    check_cuda_operands,
    check_shape,
)

# The reference kernel's DEFAULT_TILE_Q / DEFAULT_TILE_KV: sequence lengths
# must be multiples (``ops.attention`` pads).  The CUDA bodies' own tiles
# (wgmma 128 q x 64 kv, tf32x3 64 q x 32 or 64 kv) divide them.
TILE_Q = 128
TILE_KV = 128
HEAD_DIMS = (8, 64, 128)  # the head widths the kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 128)
TF32X3_TILE_Q = 64         # q rows a CTA: one consumer warpgroup
TF32X3_THREADS = 256       # the consumer warpgroup and the staging warpgroup
TF32X3_MAX_STAGES = 4
launches = 0
tf32x3_launches = 0


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The body a CUDA call runs: "wgmma" for bf16 at D in (64, 128), else
    "tf32x3"."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "tf32x3"


@dataclasses.dataclass(frozen=True)
class Tf32x3Plan:
    """The tf32x3 body's launch: q rows and kv rows a tile, ring slots,
    threads, dynamic shared-memory bytes of a CTA, the fresh accumulators
    S's hi.hi is split into (one a 32-column slab of D), and whether O's
    running sum lives in shared memory rather than registers."""

    tile_q: int
    tile_kv: int
    stages: int
    threads: int
    smem_bytes: int
    s_pieces: int
    o_shared: bool


def tf32x3_plan(d: int) -> Tf32x3Plan:
    """The tf32x3 body's launch at head width ``d``; ``_build`` compiles
    ``csrc/flash_attention.cu`` with it (``TfPlan``), whose ``TfLayout``
    must come to the same bytes.  Shared memory holds q_hi and q_lo (64 x
    D f32 each), per ring slot k_hi, k_lo (kv x D) and the transposed
    vt_hi, vt_lo (D x kv), every operand in 32-column slabs of 128-byte
    rows (at D = 8 a row holds 8 used columns), plus four 8-byte mbarriers
    a slot and 1024 bytes to align the base.  The kv tile is 32 rows at D
    = 128 (a 64-row slot, 128 KB, would leave no room for a second) and 64
    below.  A consumer thread holds a tile's P V (D / 2 registers) and,
    below D = 128, O's running sum beside it; at D = 128 the two would take
    128 registers with S's pieces still to come, so the sum moves to
    shared memory (64 x D f32).  The ring takes as many slots as fit, up
    to ``TF32X3_MAX_STAGES``, and at least two."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    slabs = -(-d // 32)
    tile_kv = 32 if d > 64 else 64
    o_shared = d > 64
    q_bytes = 2 * TF32X3_TILE_Q * 128 * slabs
    o_bytes = TF32X3_TILE_Q * d * 4 if o_shared else 0
    slot = 2 * tile_kv * 128 * slabs + 2 * d * 128 * (tile_kv // 32) + 32
    stages = min(TF32X3_MAX_STAGES, (MAX_SMEM_BYTES - 1024 - q_bytes - o_bytes) // slot)
    if stages < 2:
        raise ValueError(f"flash_attention: two tf32x3 slots at D {d} exceed shared memory")
    return Tf32x3Plan(TF32X3_TILE_Q, tile_kv, stages, TF32X3_THREADS,
                      q_bytes + stages * slot + o_bytes + 1024, max(1, d // 32), o_shared)


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
    global launches, tf32x3_launches
    bsz, sq, hq, dim = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sq % TILE_Q or skv % TILE_KV:
        raise ValueError(f"seq lengths ({sq},{skv}) not multiples of tiles")
    if skv == 0:
        raise ValueError("flash_attention: no kv positions to attend to")
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, sq, skv, hq, hkv, dim, int(q_offset), valid, int(causal),
            ctypes.c_float(1.0 / dim**0.5))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if body == "wgmma":
            err = lib.repro_flash_attention_wgmma(*args, DTYPE_CODES[q.dtype], stream)
        else:
            err = lib.repro_flash_attention_tf32x3(*args, DTYPE_CODES[q.dtype], stream)
    _build.check(lib, f"flash_attention ({body})", err)
    launches += 1
    tf32x3_launches += body == "tf32x3"
    return out
