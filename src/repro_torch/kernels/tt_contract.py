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
of ``mid`` coalesced).  The backward takes f32 and R <= ``MAX_BWD_RANK`` in
two plans (``bwd_plan``): "slab", where two buffers of an entry fit half an
SM's shared memory, persistent blocks copying slabs of entries into shared
memory once and sweeping them there; "wide" above (``wide_plan``),
persistent clusters of 1 to 8 blocks that split each core's rows, so that
the cluster holds an entry and reads its ``mid`` once, the sweeps' partial
sums and vectors handed between the blocks through distributed shared
memory.  ``ops.tt_contract`` turns K == 0 into a row dot.  ``launches``
counts forward kernel launches, ``bwd_launches`` backward ones and
``wide_launches`` the backward's launches in the wide plan, nothing else.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    MAX_SMEM_BYTES,
    check_cuda_operands,
    check_shape,
    check_smem,
)

# kTTThreads in csrc/tt_contract.cu
THREADS = 256
# the widest chain the backward takes: the budget rule's largest rank
# (NTTDCodec._rank_for_budget tries ranks up to 128)
MAX_BWD_RANK = 128
# the backward's slab plan: at most kTTBwdSlabThreads threads a block, and
# two blocks a SM, each within half an H100 SM's shared memory less what
# the hardware reserves a block
BWD_SLAB_THREADS = 256
# the backward's wide plan: threads a block (the kernel takes up to
# kTTBwdWideThreads, 512), the registers a thread its launch bounds allow
# (64: two blocks of 512 a SM) and the largest cluster it takes (the
# portable cluster size)
BWD_WIDE_THREADS = 256
BWD_WIDE_REGISTERS = 64
MAX_CLUSTER = 8
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_SMEM = 1024
H100_SMS = 132
launches = 0
bwd_launches = 0
wide_launches = 0


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


@dataclasses.dataclass(frozen=True)
class TTBwdPlan:
    """A launch of the backward kernel: its plan ("slab" or "wide"), the
    entries a slab (slab) or a cluster (wide: 1) sweeps at once, the floats
    of a slot (slab: an entry's; wide: a block's rows of one core), threads
    and blocks (wide: at most; the launch takes no more clusters than fit
    the card at once), the shared memory of a block in bytes and the blocks
    of a cluster (slab: 1)."""
    kind: str
    entries: int
    stride: int
    threads: int
    blocks: int
    smem_bytes: int
    cluster: int = 1


def slab_smem_bytes(rank: int, k_steps: int, entries: int, stride: int) -> int:
    """A slab block's shared memory: two mbarriers (16 bytes), two buffers
    of ``entries`` slots of ``stride`` floats, and each entry's v_0 .. v_K
    and two u rows, (K + 3) R floats."""
    return 16 + 4 * entries * (2 * stride + (k_steps + 3) * rank)


def bank_ways(stride: int, rank: int, entries: int) -> int:
    """The worst bank conflict of the slab sweeps' buffer reads, summed over
    the two sweeps: in a warp, thread t = e R + j reads float e stride + r R
    + j (prefix, column j) and e stride + j R + c (suffix, row j), all
    threads at the same r or c; the most threads of a warp on one of the 32
    banks, for each sweep."""
    worst = [0, 0]
    for w0 in range(0, entries * rank, 32):
        lanes = [divmod(t, rank) for t in range(w0, min(w0 + 32, entries * rank))]
        for n, col in enumerate((1, rank)):
            banks = collections.Counter((e * stride + j * col) % 32 for e, j in lanes)
            worst[n] = max(worst[n], max(banks.values()))
    return sum(worst)


def slab_stride(rank: int, k_steps: int, entries: int) -> int:
    """Floats of an entry's slot in a slab buffer: K R^2 and room for the
    entry's offset from the 16-byte grid (up to 3 floats), a multiple of 4,
    and of the 8 such strides from the least, the one with the fewest bank
    conflicts (``bank_ways``; the least on a tie).  At K 8, R 10 K R^2 = 800
    is a multiple of 32, which would put the entries of a warp on the same
    banks."""
    least = (k_steps * rank * rank + 6) // 4 * 4
    return min(range(least, least + 32, 4), key=lambda s: (bank_ways(s, rank, entries), s))


def slab_plan(rank: int, k_steps: int, bsz: int, entries: int, sms: int = H100_SMS) -> TTBwdPlan:
    """The slab plan with ``entries`` entries a slab: E R threads rounded up
    to whole warps, as many persistent blocks as fit the SMs (by shared
    memory and threads), at most one a slab."""
    stride = slab_stride(rank, k_steps, entries)
    smem = slab_smem_bytes(rank, k_steps, entries, stride)
    threads = -(-entries * rank // 32) * 32
    per_sm = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM), 2048 // threads, 32)
    blocks = max(1, min(-(-bsz // entries), per_sm * sms))
    return TTBwdPlan("slab", entries, stride, threads, blocks, smem)


def slab_entries(rank: int, k_steps: int) -> int:
    """Entries of a slab: the most whose block has at most
    ``BWD_SLAB_THREADS`` threads and leaves room for a second block on the
    SM; 0 where not even one entry does (the wide plan)."""
    half = SM_SMEM_BYTES // 2 - BLOCK_RESERVED_SMEM
    least = (k_steps * rank * rank + 6) // 4 * 4  # slab_stride's least
    fixed = slab_smem_bytes(rank, k_steps, 0, 0)
    entries = min(BWD_SLAB_THREADS // rank,
                  (half - fixed) // (slab_smem_bytes(rank, k_steps, 1, least) - fixed))
    while entries and slab_smem_bytes(rank, k_steps, entries,
                                      slab_stride(rank, k_steps, entries)) > half:
        entries -= 1
    return entries


def wide_rows(rank: int, cluster: int) -> int:
    """Rows of every core a block of a wide cluster holds: ceil(R / C) (the
    last block the rest)."""
    return -(-rank // cluster)


def wide_slot(rank: int, cluster: int) -> int:
    """Floats of a wide block's slot for one core: its rows and room for
    their offset from the 16-byte grid (up to 3 floats), a multiple of 4."""
    return (wide_rows(rank, cluster) * rank + 6) // 4 * 4


def wide_smem_bytes(rank: int, k_steps: int, cluster: int) -> int:
    """A wide block's shared memory: K + 4 mbarriers (a slot's each, and
    two sets each of the exchanges of partial sums and of u; 8 bytes each,
    rounded up to 16), K slots, its rows of v_0 .. v_K, every u_0 .. u_K
    ((K + 1) R) and two sets of the prefix's partial sums (C P rows each, P
    = threads / R)."""
    rows = wide_rows(rank, cluster)
    return (((k_steps + 4) * 8 + 15) // 16 * 16
            + 4 * (k_steps * wide_slot(rank, cluster) + (k_steps + 1) * (rows + rank)
                   + 2 * cluster * (BWD_WIDE_THREADS // rank) * rows))


def wide_blocks_per_sm(smem: int) -> int:
    """Wide blocks an SM holds at once, by shared memory, threads and
    registers."""
    return min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM), 2048 // BWD_WIDE_THREADS,
               65536 // (BWD_WIDE_THREADS * BWD_WIDE_REGISTERS))


def wide_cluster(rank: int, k_steps: int) -> int:
    """Blocks of a wide cluster: the fewest, of 1, 2, 4 and 8, each holding
    at least one row, whose blocks fit two a SM; else 8."""
    for cluster in (1, 2, 4):
        if (wide_rows(rank, cluster) * (cluster - 1) < rank
                and wide_blocks_per_sm(wide_smem_bytes(rank, k_steps, cluster)) >= 2):
            return cluster
    return MAX_CLUSTER


def wide_plan(rank: int, k_steps: int, bsz: int, sms: int = H100_SMS) -> TTBwdPlan:
    """The wide plan: ``wide_cluster``'s clusters of ``BWD_WIDE_THREADS``
    threads a block, as many persistent clusters as fit the SMs, at most one
    an entry."""
    cluster = wide_cluster(rank, k_steps)
    smem = wide_smem_bytes(rank, k_steps, cluster)
    clusters = max(1, min(bsz, wide_blocks_per_sm(smem) * sms // cluster))
    return TTBwdPlan("wide", 1, wide_slot(rank, cluster), BWD_WIDE_THREADS, clusters * cluster,
                     smem, cluster)


@functools.lru_cache(maxsize=None)
def bwd_plan(rank: int, k_steps: int, bsz: int, sms: int = H100_SMS) -> TTBwdPlan:
    """The backward's launch at (R, K, B): the slab plan wherever
    ``slab_entries`` finds room, with at most B / (2 ``sms``) entries a slab,
    so that a small batch still makes two blocks a SM; else the wide plan
    (``wide_plan``)."""
    entries = slab_entries(rank, k_steps)
    if entries:
        return slab_plan(rank, k_steps, bsz, min(entries, -(-bsz // (2 * sms))), sms)
    return wide_plan(rank, k_steps, bsz, sms)


def check_bwd(dtype: torch.dtype, rank: int, k_steps: int) -> None:
    """What the backward kernel takes, checked before any launch: f32, K >=
    1 and R <= ``MAX_BWD_RANK``; raises ``ValueError`` otherwise."""
    if dtype != torch.float32:
        raise ValueError(f"tt_contract backward: dtype {dtype} not supported (float32 only)")
    if not 1 <= rank <= MAX_BWD_RANK:
        raise ValueError(f"tt_contract backward: rank {rank} outside 1..{MAX_BWD_RANK}")
    if k_steps < 1:
        raise ValueError("tt_contract backward needs K >= 1 mid cores (ops handles K == 0)")


def _like_on_grid(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``t`` whose data lies at the same offset
    from the 16-byte grid as ``t``'s (the slab plan stores dmid's 16-byte
    chunks from where it copied mid's)."""
    pad = t.data_ptr() % 16 // t.element_size()
    if not pad:
        return torch.empty_like(t)
    return torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)[pad:].view(t.shape)


def tt_contract_bwd(
    first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor, dout: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dfirst [B, R], dmid [B, K, R, R], dlast [B, R]) of ``tt_contract``
    against ``dout`` [B]: one launch of the backward kernel in
    ``bwd_plan``'s launch on CUDA tensors, the plain version on CPU
    tensors."""
    global bwd_launches, wide_launches
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
    plan = bwd_plan(rank, k_steps, bsz,
                    torch.cuda.get_device_properties(device).multi_processor_count)
    check_smem("tt_contract_bwd", 1, -(-plan.smem_bytes // 4))
    dfirst, dmid, dlast = torch.empty_like(first), _like_on_grid(mid), torch.empty_like(last)
    if bsz == 0:
        return dfirst, dmid, dlast
    with torch.cuda.device(device):
        err = lib.repro_tt_contract_bwd(
            first.data_ptr(), mid.data_ptr(), last.data_ptr(), dout.data_ptr(),
            dfirst.data_ptr(), dmid.data_ptr(), dlast.data_ptr(), bsz, k_steps, rank,
            ("slab", "wide").index(plan.kind), plan.entries, plan.stride, plan.threads,
            plan.blocks, plan.cluster, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "tt_contract_bwd", err)
    bwd_launches += 1
    wide_launches += plan.kind == "wide"
    return dfirst, dmid, dlast
