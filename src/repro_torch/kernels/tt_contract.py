"""Wrapper of the TT chain contraction kernel (``csrc/tt_contract.cu``)
and of its backward (``csrc/tt_contract_bwd.cu``).

Counterpart of ``repro.kernels.tt_contract``.  On a CUDA tensor
``tt_contract`` launches the hand-written forward kernel on the current
stream or raises; it is a ``torch.autograd.Function`` whose backward is the
hand-written backward kernel (``tt_contract_bwd``), so a gradient asked of
it runs that kernel.  On a CPU tensor both run their plain versions
(``ref.tt_contract``, which autograd differentiates, and
``ref.tt_contract_bwd``).  The forward takes K >= 1 and any R >= 1 in one
body, a lane group per entry (``lanes_per_entry`` lanes, reading each row
of ``mid`` coalesced); the backward, the same lane groups, takes f32 and
R <= ``MAX_BWD_RANK``.  ``ops.tt_contract`` turns K == 0 into a row dot.
``launches`` counts forward kernel launches, ``bwd_launches`` backward
ones, nothing else.
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

THREADS = 256  # kTTThreads in csrc/tt_contract.cu, kTTBwdThreads in tt_contract_bwd.cu
# the widest chain the backward takes: the budget rule's largest rank
# (NTTDCodec._rank_for_budget tries ranks up to 128)
MAX_BWD_RANK = 128
launches = 0
bwd_launches = 0


def lanes_per_entry(rank: int) -> int:
    """Lanes sharing one entry: the smallest power of two >= ``rank``, at
    most a warp (32)."""
    return min(32, 1 << (rank - 1).bit_length()) if rank > 1 else 1


def _forward(first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors."""
    global launches
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


class _TTContract(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, first, mid, last):
        ctx.save_for_backward(first, mid, last)
        return _forward(first, mid, last)

    @staticmethod
    def backward(ctx, dout):
        return tt_contract_bwd(*ctx.saved_tensors, dout.contiguous())


def tt_contract(first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """first: [B, R], mid: [B, K, R, R] with K >= 1, last: [B, R] -> [B]
    in ``first.dtype``."""
    if first.device.type == "cpu":
        return ref.tt_contract(first, mid, last)
    return _TTContract.apply(first, mid, last)


def check_bwd(dtype: torch.dtype, rank: int, k_steps: int) -> None:
    """What the backward kernel takes, checked before any launch: f32, K >=
    1 and R <= ``MAX_BWD_RANK``; raises ``ValueError`` otherwise."""
    if dtype != torch.float32:
        raise ValueError(f"tt_contract backward: dtype {dtype} not supported (float32 only)")
    if not 1 <= rank <= MAX_BWD_RANK:
        raise ValueError(f"tt_contract backward: rank {rank} outside 1..{MAX_BWD_RANK}")
    if k_steps < 1:
        raise ValueError("tt_contract backward needs K >= 1 mid cores (ops handles K == 0)")


def tt_contract_bwd(
    first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor, dout: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dfirst [B, R], dmid [B, K, R, R], dlast [B, R]) of ``tt_contract``
    against ``dout`` [B]: one launch of the backward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global bwd_launches
    if first.device.type == "cpu":
        return ref.tt_contract_bwd(first, mid, last, dout)
    bsz, rank = first.shape
    k_steps = mid.shape[1]
    check_bwd(first.dtype, rank, k_steps)
    lib = _build.library()
    device = check_cuda_operands(
        "tt_contract_bwd", {"first": first, "mid": mid, "last": last, "dout": dout},
        torch.float32,
    )
    check_shape("tt_contract_bwd", "mid", mid, (bsz, k_steps, rank, rank))
    check_shape("tt_contract_bwd", "last", last, (bsz, rank))
    check_shape("tt_contract_bwd", "dout", dout, (bsz,))
    group = lanes_per_entry(rank)
    # v_0 .. v_K and two u rows of each of the block's THREADS / group entries
    check_smem("tt_contract_bwd", THREADS // group, (k_steps + 3) * rank)
    dfirst, dmid, dlast = torch.empty_like(first), torch.empty_like(mid), torch.empty_like(last)
    if bsz == 0:
        return dfirst, dmid, dlast
    with torch.cuda.device(device):
        err = lib.repro_tt_contract_bwd(
            first.data_ptr(), mid.data_ptr(), last.data_ptr(), dout.data_ptr(),
            dfirst.data_ptr(), dmid.data_ptr(), dlast.data_ptr(), bsz, k_steps, rank, group,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "tt_contract_bwd", err)
    bwd_launches += 1
    return dfirst, dmid, dlast
