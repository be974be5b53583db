"""Wrapper of the LSTM scan kernel (``csrc/lstm.cu``) and of its backward
(``csrc/lstm_bwd.cu``).

Counterpart of ``repro.kernels.lstm``.  On a CUDA tensor ``lstm_scan``
launches one of the forward kernel's two hand-written bodies on the
current stream or raises; it is a ``torch.autograd.Function`` whose
backward is the hand-written backward kernel (``lstm_scan_bwd``).  On a
CPU tensor both run their plain versions (``ref.lstm_scan``, which
autograd differentiates, and ``ref.lstm_scan_bwd``).  ``lstm_body``
names the forward's body, by shape: the register body (``"register"``,
``csrc/lstm.cu``) for hidden widths up to the largest bucket, 64, run in
the smallest bucket of ``BUCKETS`` that holds the width and padded inside
the kernel; the simt body (``"simt"``, ``csrc/lstm_dispatch.cu``) for
wider LSTMs: a block owns a tile of sequences (``simt_tile``) for all T
steps, keeps their state in shared memory and runs each step as one FP32
product over the tile, the weights streamed through shared memory once a
block, as the fused decode's simt body does.  The backward takes f32 and
H <= ``MAX_BWD_HIDDEN`` in one kernel with three plans by shape
(``bwd_plan``): a block owns ``bwd_tile(H, B)`` sequences, runs the gates
forward from the saved hidden states as register-tiled products over the
tile, then sweeps the steps backwards and writes dx, the gates' gradient
G and the operand rows A = [x_t | h_{t-1} | 1]; dwi, dwh and db are one
batched matrix product A^T G over B T (``weight_grads``).  ``launches`` counts forward
launches of either body, ``simt_launches`` those of the simt body,
``bwd_launches`` backward launches; nothing else counts.
"""
from __future__ import annotations

import dataclasses

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
bwd_launches = 0
# the backward kernel (csrc/lstm_bwd.cu): its widest LSTM (the budget
# rule's hidden = 2 rank reaches 256); its plans, by where the weights are
# read from (``LstmBwdKind``), with the sequences of a thread's tile, the
# threads of a block at most and the floats a thread keeps of every step
# (c; c and the four gates)
MAX_BWD_HIDDEN = 256
BWD_KINDS = ("narrow", "mid", "wide")
BWD_SEQS = {"narrow": 4, "mid": 8, "wide": 8}
BWD_THREADS = {"narrow": 128, "mid": 384, "wide": 256}
BWD_KEPT = {"narrow": 4, "mid": 40, "wide": 40}
# [wi; wh] in shared memory for the whole kernel: the narrow plan up to 64
# KB (H <= 45), the mid plan up to 160 KB (H <= 71), one block a SM
BWD_NARROW_BYTES = 65_536
BWD_MID_BYTES = 163_840
# the H100's SMs, which the mid plan's tile fills in whole waves
H100_SMS = 132
# rows of a chunk of the weight gradients' product: A and G are padded to a
# whole number of chunks (``bwd_rows``), each chunk's A^T G is one batched
# product and the chunks are summed
BWD_CHUNK = 256


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


def _forward(x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel's body for this shape, on CUDA
    tensors."""
    global launches, simt_launches
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


class _LstmScan(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel from the
    saved x and hidden states."""

    @staticmethod
    def forward(ctx, x, wi, wh, b):
        hs = _forward(x, wi, wh, b)
        ctx.save_for_backward(x, wi, wh, b, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x, wi, wh, b, hs = ctx.saved_tensors
        return lstm_scan_bwd(x, wi, wh, b, hs, dhs.contiguous())


def lstm_scan(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """x: [B, T, H], wi: [H, 4H], wh: [H, 4H], b: [4H] -> hs [B, T, H]
    in ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.lstm_scan(x, wi, wh, b)
    return _LstmScan.apply(x, wi, wh, b)


def bwd_row_stride(hid: int) -> int:
    """Floats of a row of the backward's unit-major weights: 4 a unit, an
    odd number of units (``lstm_bwd_row_stride``)."""
    return 4 * (hid | 1)


def bwd_kind(hid: int) -> str:
    """The backward's plan at hidden ``hid``, by the bytes of [wi; wh]
    unit-major (2H rows of ``bwd_row_stride(H)`` floats): "narrow" up to
    ``BWD_NARROW_BYTES`` (H <= 45), "mid" up to ``BWD_MID_BYTES`` (H <=
    71), else "wide"."""
    size = 2 * hid * bwd_row_stride(hid) * 4
    return "narrow" if size <= BWD_NARROW_BYTES else "mid" if size <= BWD_MID_BYTES else "wide"


def bwd_tile(hid: int, bsz: int = 8192, sms: int = H100_SMS) -> int:
    """Sequences a backward block owns: S G, a thread owning one unit of S
    sequences.  Narrow: S 4 and G = max(1, 64 // H), blocks of about two
    warps; at B 8192 and H 18, 683 blocks of 12 sequences and 64 threads,
    5.2 a SM, each with 17.4 KB of shared memory and at most 128 registers
    a thread, so eight fit a SM and every block runs at once.
    Mid: S 8 and one block a SM (its weights take most of the SM's shared
    memory), so G is sized to the batch: the fewest waves of ``sms``
    blocks that G up to its most (384 threads and the shared memory left
    beside the weights) allows, then the smallest G filling them: at B
    4096 and H 68, G 4, 128 blocks.  Wide: S 8, G 1 (each block reads the
    weights through the L1 cache once a product)."""
    kind = bwd_kind(hid)
    if kind == "narrow":
        return 4 * max(1, 64 // hid)
    if kind == "wide":
        return 8
    room = MAX_SMEM_BYTES // 4 - 2 * hid * bwd_row_stride(hid)
    most = max(1, min(BWD_THREADS["mid"] // hid, room // (8 * hid) // 8))
    waves = max(1, -(-bsz // (8 * most * sms)))
    return 8 * max(1, min(most, -(-bsz // (8 * sms * waves))))


def bwd_rows(bsz: int, t_steps: int) -> int:
    """Rows of the kernel's A and G: B T rounded up to whole ``BWD_CHUNK``s
    (the pad rows are zero)."""
    return -(-bsz * t_steps // BWD_CHUNK) * BWD_CHUNK


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """A backward block (``LstmBwdPlan`` in ``csrc/lstm_bwd.cu``): its plan
    (``bwd_kind``), tile of sequences and threads, and its shared memory in
    bytes."""
    hid: int
    kind: str
    tile: int
    threads: int
    smem_bytes: int

    def blocks(self, bsz: int) -> int:
        return -(-bsz // self.tile)

    def scratch_floats(self, bsz: int, t_steps: int) -> int:
        """Floats of the scratch: what a thread keeps of every step
        (``BWD_KEPT``), for every thread of every block."""
        return self.blocks(bsz) * t_steps * self.threads * BWD_KEPT[self.kind]


def bwd_plan(hid: int, bsz: int = 8192, sms: int = H100_SMS) -> BwdPlan:
    """The backward's block at (H, B).  Shared memory holds x_t | h_{t-1}
    (two buffers) and dG_t, 8 H TB floats, and the narrow and mid plans'
    weights; it does not depend on T.  What a thread keeps of every step
    goes to the scratch (``scratch_floats``): c, 4 floats a thread and step
    (narrow), or c and the gates, 40 (mid, wide)."""
    kind = bwd_kind(hid)
    tile = bwd_tile(hid, bsz, sms)
    threads = -(-(tile // BWD_SEQS[kind]) * hid // 32) * 32
    floats = 8 * hid * tile + (2 * hid * bwd_row_stride(hid) if kind != "wide" else 0)
    return BwdPlan(hid, kind, tile, threads, 4 * floats)


def check_bwd(dtype: torch.dtype, hid: int) -> None:
    """What the backward kernel takes, checked before any launch: f32 and
    1 <= H <= ``MAX_BWD_HIDDEN``; raises ``ValueError`` otherwise."""
    if dtype != torch.float32:
        raise ValueError(f"lstm_scan backward: dtype {dtype} not supported (float32 only)")
    if not 1 <= hid <= MAX_BWD_HIDDEN:
        raise ValueError(f"lstm_scan backward: hidden {hid} outside 1..{MAX_BWD_HIDDEN}")


def lstm_scan_bwd(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, hs: torch.Tensor,
    dhs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dwi, dwh, db) of ``lstm_scan`` against ``dhs`` [B, T, H], given
    the forward's hidden states ``hs``.  On CUDA tensors the backward
    kernel writes dx, the gates' gradient G and the operand rows A
    (``bwd_gates``: the recurrence), then dwi, dwh and db are one matrix
    product over B T (``weight_grads``); on CPU tensors the plain version
    (``hs`` unused)."""
    if x.device.type == "cpu":
        return ref.lstm_scan_bwd(x, wi, wh, b, dhs)
    dx, g, a = bwd_gates(x, wi, wh, b, hs, dhs)
    return (dx, *weight_grads(a, g))


def weight_grads(
    a: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dwi, dwh, db) from the kernel's A [R, 2H + 1], row b T + t = [x[b, t]
    | h_{t-1} | 1] (h_{-1} = 0), and G [R, 4H], row b T + t = dG[b, t], R =
    ``bwd_rows`` (the pad rows zero): A^T G stacks x^T dG, h_prev^T dG and
    sum dG.  It is summed in chunks of ``BWD_CHUNK`` rows, one batched
    product, then over the chunks, so that no sum runs sequentially over all
    B T rows (db, the ones column's sum, would lose accuracy)."""
    hid = g.shape[1] // 4
    n = a.shape[0] // BWD_CHUNK
    w = torch.bmm(a.view(n, BWD_CHUNK, 2 * hid + 1).transpose(1, 2),
                  g.view(n, BWD_CHUNK, 4 * hid)).sum(0)
    return w[:hid], w[hid:2 * hid], w[2 * hid]


def bwd_weights(wi: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[wi; wh] unit-major for a wide plan: [2H, 4 (H | 1)], gate g of unit u
    of row k at [k, 4 u + g] (the pad unit is never read)."""
    hid = wi.shape[0]
    out = torch.empty((2, hid, bwd_row_stride(hid) // 4, 4), dtype=wi.dtype, device=wi.device)
    out[:, :, :hid] = torch.stack((wi, wh)).view(2, hid, 4, hid).transpose(2, 3)
    return out.view(2 * hid, bwd_row_stride(hid))


def bwd_gates(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, hs: torch.Tensor,
    dhs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel on CUDA tensors: dx [B, T, H], G [R,
    4H], the gradient of every step's gate pre-activations (i, f, g, o), and
    A [R, 2H + 1], every step's [x_t | h_{t-1} | 1], their rows past B T
    zero (R = ``bwd_rows``)."""
    global bwd_launches
    bsz, t_steps, hid = x.shape
    check_bwd(x.dtype, hid)
    lib = _build.library()
    device = check_cuda_operands(
        "lstm_scan_bwd", {"x": x, "wi": wi, "wh": wh, "b": b, "hs": hs, "dhs": dhs},
        torch.float32,
    )
    check_shape("lstm_scan_bwd", "wi", wi, (hid, 4 * hid))
    check_shape("lstm_scan_bwd", "wh", wh, (hid, 4 * hid))
    check_shape("lstm_scan_bwd", "b", b, (4 * hid,))
    check_shape("lstm_scan_bwd", "hs", hs, (bsz, t_steps, hid))
    check_shape("lstm_scan_bwd", "dhs", dhs, (bsz, t_steps, hid))
    if bsz >= 2**31:
        raise ValueError(f"lstm_scan_bwd: {bsz} sequences exceed the kernel's 2**31 - 1")
    dx = torch.empty_like(x)
    rows, bt = bwd_rows(bsz, t_steps), bsz * t_steps
    g = torch.empty((rows, 4 * hid), dtype=torch.float32, device=device)
    a = torch.empty((rows, 2 * hid + 1), dtype=torch.float32, device=device)
    if rows > bt:
        g[bt:].zero_()
        a[bt:].zero_()
    if bt == 0:
        return dx, g, a
    plan = bwd_plan(hid, bsz, torch.cuda.get_device_properties(device).multi_processor_count)
    scratch = torch.empty((plan.scratch_floats(bsz, t_steps),), dtype=torch.float32,
                          device=device)
    wt = bwd_weights(wi, wh) if plan.kind == "wide" else None
    with torch.cuda.device(device):
        err = lib.repro_lstm_scan_bwd(
            x.data_ptr(), wi.data_ptr(), wh.data_ptr(), None if wt is None else wt.data_ptr(),
            b.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dx.data_ptr(), g.data_ptr(),
            a.data_ptr(), scratch.data_ptr(), bsz, t_steps, hid, plan.tile, plan.threads,
            BWD_KINDS.index(plan.kind), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "lstm_scan_bwd", err)
    bwd_launches += 1
    return dx, g, a
