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
H <= ``MAX_BWD_HIDDEN`` in one body: a block owns ``bwd_tile(H)``
sequences, recomputes the gates from the saved hidden states and sweeps
the steps backwards, writing the gates' gradient dG; dx, dwi, dwh and db
are plain matrix products of dG over B T.  ``launches`` counts forward
launches of either body, ``simt_launches`` those of the simt body,
``bwd_launches`` backward launches; nothing else counts.
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
bwd_launches = 0
# the backward kernel (csrc/lstm_bwd.cu): its widest LSTM (the budget
# rule's hidden = 2 rank reaches 256), threads a block and sequences an item
MAX_BWD_HIDDEN = 256
BWD_THREADS = 128
BWD_SEQS = 4


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


def bwd_tile(hid: int) -> int:
    """Sequences a backward block owns: ``BWD_SEQS`` per work item and
    about one item (a hidden unit of ``BWD_SEQS`` sequences) a thread."""
    return BWD_SEQS * max(1, BWD_THREADS // hid)


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
    kernel writes the gates' gradient dG [B, T, 4H] (``bwd_gates``: the
    recurrence), then dx = dG wi^T, dwi = x^T dG, dwh = h_prev^T dG and db =
    sum dG are matrix products over B T; on CPU tensors the plain version
    (``hs`` unused)."""
    if x.device.type == "cpu":
        return ref.lstm_scan_bwd(x, wi, wh, b, dhs)
    bsz, t_steps, hid = x.shape
    dg = bwd_gates(x, wi, wh, b, hs, dhs).view(bsz * t_steps, 4 * hid)
    h_prev = torch.cat([hs.new_zeros((bsz, 1, hid)), hs[:, :-1]], dim=1)
    return ((dg @ wi.t()).view(bsz, t_steps, hid), x.reshape(-1, hid).t() @ dg,
            h_prev.reshape(-1, hid).t() @ dg, dg.sum(0))


def bwd_gates(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, hs: torch.Tensor,
    dhs: torch.Tensor,
) -> torch.Tensor:
    """One launch of the backward kernel on CUDA tensors: dG [B, T, 4H], the
    gradient of every step's gate pre-activations (i, f, g, o)."""
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
    dg = torch.empty((bsz, t_steps, 4 * hid), dtype=torch.float32, device=device)
    if bsz == 0 or t_steps == 0:
        return dg
    cbuf = torch.empty_like(x)  # c of every step, the kernel's scratch
    wht = wh.t().contiguous()   # read coalesced along the units by dh_rec = dG wh^T
    with torch.cuda.device(device):
        err = lib.repro_lstm_scan_bwd(
            x.data_ptr(), wi.data_ptr(), wh.data_ptr(), b.data_ptr(), hs.data_ptr(),
            dhs.data_ptr(), wht.data_ptr(), dg.data_ptr(), cbuf.data_ptr(), bsz, t_steps, hid,
            bwd_tile(hid), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "lstm_scan_bwd", err)
    bwd_launches += 1
    return dg
