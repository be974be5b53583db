"""Wrapper of the TT chain contraction kernel (``csrc/tt_contract.cu``),
forward only.

Counterpart of ``repro.kernels.tt_contract``.  On a CUDA tensor it
launches the hand-written kernel on the current stream or raises; on a
CPU tensor it runs the plain version ``ref.tt_contract``.  The kernel
takes K >= 1 and any R >= 1 in one body, a lane group per entry
(``lanes_per_entry`` lanes, reading each row of ``mid`` coalesced);
``ops.tt_contract`` turns K == 0 into a row dot.  ``launches`` counts
kernel launches, nothing else.
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

THREADS = 256  # kTTThreads in csrc/tt_contract.cu
launches = 0


def lanes_per_entry(rank: int) -> int:
    """Lanes sharing one entry: the smallest power of two >= ``rank``, at
    most a warp (32)."""
    return min(32, 1 << (rank - 1).bit_length()) if rank > 1 else 1


def tt_contract(first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """first: [B, R], mid: [B, K, R, R] with K >= 1, last: [B, R] -> [B]
    in ``first.dtype``."""
    global launches
    if first.device.type == "cpu":
        return ref.tt_contract(first, mid, last)
    lib = _build.library()
    bsz, rank = first.shape
    k_steps = mid.shape[1]
    if k_steps < 1:
        raise ValueError("tt_contract kernel needs K >= 1 mid cores (ops handles K == 0)")
    device = check_cuda_operands(
        "tt_contract", {"first": first, "mid": mid, "last": last}, first.dtype
    )
    check_shape("tt_contract", "mid", mid, (bsz, k_steps, rank, rank))
    check_shape("tt_contract", "last", last, (bsz, rank))
    group = lanes_per_entry(rank)
    # v and v_new of each of the block's THREADS / group entries
    check_smem("tt_contract", THREADS // group, 2 * rank)
    out = torch.empty((bsz,), dtype=first.dtype, device=device)
    if bsz == 0:
        return out
    with torch.cuda.device(device):
        err = lib.repro_tt_contract(
            first.data_ptr(), mid.data_ptr(), last.data_ptr(), out.data_ptr(),
            bsz, k_steps, rank, group, DTYPE_CODES[first.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "tt_contract", err)
    launches += 1
    return out
