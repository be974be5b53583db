"""Wrapper of the fused NTTD decode kernel (``csrc/decode_tile.cu``).

Counterpart of ``repro.kernels.decode_tile``.  On a CUDA tensor it
launches the hand-written kernel on the current stream or raises; on a
CPU tensor it runs the plain version ``ref.nttd_decode_tile``.
``launches`` counts kernel launches, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    check_cuda_operands,
    check_shape,
    check_smem,
)

THREADS = 64  # kDecodeThreads in csrc/decode_tile.cu
launches = 0


def decode_tile(
    idx: torch.Tensor,
    emb: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    w_first: torch.Tensor,
    b_first: torch.Tensor,
    w_mid: torch.Tensor,
    b_mid: torch.Tensor,
    w_last: torch.Tensor,
    b_last: torch.Tensor,
) -> torch.Tensor:
    """Fused NTTD decode of a tile of folded indices.

    idx:      [B, T] int32 folded indices (T = d' >= 2)
    emb:      [T, M, H] per-step embedding tables, padded to M rows
    wi, wh:   [H, 4H] LSTM gate weights; b: [4H]
    w_first:  [H, R],   b_first: [R]
    w_mid:    [H, R*R], b_mid:   [R*R]   (unused when T == 2)
    w_last:   [H, R],   b_last:  [R]
    returns   [B] in ``emb.dtype``
    """
    global launches
    weights = (emb, wi, wh, b, w_first, b_first, w_mid, b_mid, w_last, b_last)
    if idx.device.type == "cpu":
        return ref.nttd_decode_tile(idx, *weights)
    lib = _build.library()
    bsz, t_steps = idx.shape
    if t_steps < 2:
        raise ValueError(f"decode_tile needs T >= 2 steps, got {t_steps}")
    _, m_rows, hid = emb.shape
    rank = b_first.shape[0]
    names = ("emb", "wi", "wh", "b", "w_first", "b_first", "w_mid", "b_mid",
             "w_last", "b_last")
    device = check_cuda_operands("decode_tile", dict(zip(names, weights)), emb.dtype)
    if idx.dtype != torch.int32 or idx.device != device or not idx.is_contiguous():
        raise ValueError(
            f"decode_tile: idx must be contiguous int32 on {device}, "
            f"got {idx.dtype} on {idx.device}"
        )
    for key, t, shape in (
        ("emb", emb, (t_steps, m_rows, hid)),
        ("wi", wi, (hid, 4 * hid)),
        ("wh", wh, (hid, 4 * hid)),
        ("b", b, (4 * hid,)),
        ("w_first", w_first, (hid, rank)),
        ("b_first", b_first, (rank,)),
        ("w_mid", w_mid, (hid, rank * rank)),
        ("b_mid", b_mid, (rank * rank,)),
        ("w_last", w_last, (hid, rank)),
        ("b_last", b_last, (rank,)),
    ):
        check_shape("decode_tile", key, t, shape)
    check_smem("decode_tile", THREADS, 4 * hid + 2 * rank)
    out = torch.empty((bsz,), dtype=emb.dtype, device=device)
    if bsz == 0:
        return out
    with torch.cuda.device(device):
        err = lib.repro_decode_tile(
            idx.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
            bsz, t_steps, m_rows, hid, rank, DTYPE_CODES[emb.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "decode_tile", err)
    launches += 1
    return out
