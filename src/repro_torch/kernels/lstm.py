"""Wrapper of the LSTM scan kernel (``csrc/lstm.cu``), forward only.

Counterpart of ``repro.kernels.lstm``.  On a CUDA tensor it launches one of
the kernel's two hand-written bodies on the current stream or raises; on a
CPU tensor it runs the plain version ``ref.lstm_scan``.  ``lstm_body``
names the body, by shape: the register body (``"register"``,
``csrc/lstm.cu``) for hidden widths up to the largest bucket, 64, run in
the smallest bucket of ``BUCKETS`` that holds the width and padded inside
the kernel; the simt body (``"simt"``, ``csrc/lstm_dispatch.cu``) for
wider LSTMs: a block owns a tile of sequences (``simt_tile``) for all T
steps, keeps their state in shared memory and runs each step as one FP32
product over the tile, the weights streamed through shared memory once a
block, as the fused decode's simt body does.  ``launches`` counts kernel
launches of either body, ``simt_launches`` those of the simt body; nothing
else counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    MAX_SMEM_BYTES,
    SIMT_TILE_STEP,
    check_cuda_operands,
    check_shape,
    largest_simt_tile,
    simt_stage_floats,
)

# hidden widths the register body is instantiated for, smallest first, as
# REPRO_LSTM_BUCKETS in csrc/lstm.cuh lists them: the decode buckets'
# widths, holding every LSTM width the repo runs (5, 8, 12, 16, 18, 24, 64)
BUCKETS = (12, 16, 20, 32, 64)
launches = 0
simt_launches = 0


def bucket_for(hid: int) -> int:
    """The smallest instantiated hidden width holding ``hid``."""
    for bucket in BUCKETS:
        if hid <= bucket:
            return bucket
    raise ValueError(f"lstm_scan: hidden {hid} exceeds the largest bucket {BUCKETS[-1]}")


def lstm_body(hid: int) -> str:
    """The body a CUDA call runs: "register" up to hidden 64, else "simt"."""
    return "register" if hid <= BUCKETS[-1] else "simt"


def simt_smem_bytes(hid: int, tile: int) -> int:
    """Dynamic shared memory of a simt block owning ``tile`` sequences, as
    ``lstm_simt_smem_floats`` in ``csrc/lstm_dispatch.cu`` counts it: x, h,
    h_new and c ([H][tile] each) and two weight stages."""
    return 4 * (tile * 4 * hid + 2 * simt_stage_floats(hid))


def simt_tile(hid: int) -> int:
    """Sequences a simt block owns: the largest multiple of 8 whose state
    and weight stages (``simt_smem_bytes``) fit a block's shared memory (176
    at H 68, 112 at 96, 88 at 114, 40 at 256, 8 at 1304); raises when one
    tile of 8 does not fit (above H 1304)."""
    tile = largest_simt_tile(lambda n: simt_smem_bytes(hid, n))
    if tile < SIMT_TILE_STEP:
        raise ValueError(
            f"lstm_scan: one tile of {SIMT_TILE_STEP} sequences needs "
            f"{simt_smem_bytes(hid, SIMT_TILE_STEP)} bytes of shared memory at hidden {hid}, "
            f"more than the {MAX_SMEM_BYTES} a Hopper block can have"
        )
    return tile


def vector_rows(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the register body reads x and writes out four values at a
    time: every row whole vectors (hidden % 4 == 0) and both pointers
    aligned to a vector (16 bytes in f32, 8 in bf16)."""
    width = 4 * x.element_size()
    return x.shape[-1] % 4 == 0 and x.data_ptr() % width == 0 and out.data_ptr() % width == 0


def lstm_scan(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """x: [B, T, H], wi: [H, 4H], wh: [H, 4H], b: [4H] -> hs [B, T, H]
    in ``x.dtype``."""
    global launches, simt_launches
    if x.device.type == "cpu":
        return ref.lstm_scan(x, wi, wh, b)
    lib = _build.library()
    bsz, t_steps, hid = x.shape
    device = check_cuda_operands(
        "lstm_scan", {"x": x, "wi": wi, "wh": wh, "b": b}, x.dtype
    )
    check_shape("lstm_scan", "wi", wi, (hid, 4 * hid))
    check_shape("lstm_scan", "wh", wh, (hid, 4 * hid))
    check_shape("lstm_scan", "b", b, (4 * hid,))
    body = lstm_body(hid)
    if body == "simt":
        tile = simt_tile(hid)
    elif x.numel() >= 2**31:
        raise ValueError(f"lstm_scan: x's {x.numel()} elements exceed the register body's "
                         "2**31 - 1")
    out = torch.empty_like(x)
    if bsz == 0 or t_steps == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (x.data_ptr(), wi.data_ptr(), wh.data_ptr(), b.data_ptr(), out.data_ptr())
    with torch.cuda.device(device):
        if body == "register":
            err = lib.repro_lstm_scan_register(
                *ptrs, bsz, t_steps, hid, bucket_for(hid), int(vector_rows(x, out)),
                DTYPE_CODES[x.dtype], stream,
            )
        else:
            err = lib.repro_lstm_scan(*ptrs, bsz, t_steps, hid, tile, DTYPE_CODES[x.dtype],
                                      stream)
    _build.check(lib, f"lstm_scan ({body})", err)
    launches += 1
    simt_launches += body == "simt"
    return out
