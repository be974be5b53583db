"""Wrapper of the fused NTTD decode kernel: two hand-written CUDA bodies.

Counterpart of ``repro.kernels.decode_tile``.  On a CUDA tensor it
launches a kernel on the current stream or raises; on a CPU tensor it runs
the plain version ``ref.nttd_decode_tile``.  ``decode_body`` names the
body, by shape alone:

* ``"register"`` (``csrc/decode_tile.cu``): state in registers, compiled
  for the (hidden, rank) buckets of the codec's own architectures.  Any
  shape a bucket holds runs through the smallest such bucket, on weights
  zero-padded by ``pad_to_bucket``; that is exact, since a padded hidden
  unit's gates are (1/2, 1/2, 0, 1/2), so its c and h stay 0, and a padded
  rank column of v stays 0.
* ``"simt"`` (``csrc/decode_tile_simt.cu``): every shape above the largest
  bucket, hidden and rank as run-time values, state in shared memory, its
  block sized to that memory (``simt_threads``).

The weights are fixed for a payload, so the codec readies them once
(``bucket_operands``, through ``core.nttd.decode_operands``): padded for
the register body, as they are for the simt body.  ``launches`` counts
kernel launches of either body, ``simt_launches`` those of the simt body,
nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    check_cuda_operands,
    check_shape,
    threads_for_smem,
)

# (hidden, rank) instantiations of csrc/decode_tile.cu, smallest first, as
# REPRO_DECODE_BUCKETS in csrc/decode_tile.cuh lists them:
# 12/6 (paper SMALL), 8/8 and 5/5 run in (12, 8); 16/8 (the default) in
# (16, 8); 18/10 (paper MEDIUM) in (20, 12); hidden = 2 rank up to rank 16
# in (32, 16); (64, 32) is the largest shape tested
BUCKETS = ((12, 8), (16, 8), (20, 12), (32, 16), (64, 32))
SIMT_MAX_THREADS = 64  # kDecodeSimtThreads in csrc/decode_tile_simt.cu
launches = 0
simt_launches = 0


def decode_body(hid: int, rank: int) -> str:
    """The body a CUDA call runs: "register" where a bucket holds the shape
    (``bucket_for``), else "simt"."""
    return "register" if any(hid <= h and rank <= r for h, r in BUCKETS) else "simt"


def simt_threads(hid: int, rank: int) -> int:
    """Threads per block of the simt body: the most, up to 64, whose x, h,
    h_new, c, v and v_new ((4 H + 2 R) floats a thread) fit a block's shared
    memory (45 at (256, 128)); raises only when one thread's do not."""
    return threads_for_smem("decode_tile", 4 * hid + 2 * rank, SIMT_MAX_THREADS)


def bucket_for(hid: int, rank: int) -> tuple[int, int]:
    """The smallest instantiated (hidden, rank) bucket holding the shape."""
    for bucket in BUCKETS:
        if hid <= bucket[0] and rank <= bucket[1]:
            return bucket
    raise ValueError(
        f"decode_tile: hidden {hid}, rank {rank} exceed the largest bucket "
        f"(hidden <= {BUCKETS[-1][0]}, rank <= {BUCKETS[-1][1]})"
    )


def pad_to_bucket(
    weights: tuple[torch.Tensor, ...], hid_to: int, rank_to: int
) -> tuple[torch.Tensor, ...]:
    """Zero-pad the ten weight operands of ``decode_tile`` (emb, wi, wh, b,
    w_first, b_first, w_mid, b_mid, w_last, b_last) to hidden ``hid_to``
    and rank ``rank_to``; the gate blocks (i, f, g, o) of ``wi``, ``wh``
    and ``b`` and the R x R blocks of ``w_mid`` and ``b_mid`` are padded
    each on its own."""
    emb, wi, wh, b, w_first, b_first, w_mid, b_mid, w_last, b_last = weights
    hid, rank = emb.shape[2], b_first.shape[0]
    dh, dr = hid_to - hid, rank_to - rank
    if dh < 0 or dr < 0:
        raise ValueError(f"cannot pad hidden {hid}, rank {rank} to {hid_to}, {rank_to}")
    pad = torch.nn.functional.pad

    def gates(w):  # [..., 4H] -> [..., 4 H_to]
        return pad(w.reshape(*w.shape[:-1], 4, hid), (0, dh)).reshape(*w.shape[:-1], 4 * hid_to)

    def cores(w):  # [..., R*R] -> [..., R_to*R_to]
        return pad(w.reshape(*w.shape[:-1], rank, rank), (0, dr, 0, dr)).reshape(
            *w.shape[:-1], rank_to * rank_to)

    return (
        pad(emb, (0, dh)),
        pad(gates(wi), (0, 0, 0, dh)), pad(gates(wh), (0, 0, 0, dh)), gates(b),
        pad(w_first, (0, dr, 0, dh)), pad(b_first, (0, dr)),
        pad(cores(w_mid), (0, 0, 0, dh)), cores(b_mid),
        pad(w_last, (0, dr, 0, dh)), pad(b_last, (0, dr)),
    )


def bucket_operands(weights: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """The ten weight operands of ``decode_tile`` as its body takes them,
    contiguous: zero-padded to their bucket for the register body, unpadded
    for the simt body; returned as they are when already so."""
    hid, rank = weights[0].shape[2], weights[5].shape[0]
    if decode_body(hid, rank) == "register":
        bucket = bucket_for(hid, rank)
        if bucket != (hid, rank):
            weights = pad_to_bucket(weights, *bucket)
    return tuple(t.contiguous() for t in weights)


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
    global launches, simt_launches
    weights = (emb, wi, wh, b, w_first, b_first, w_mid, b_mid, w_last, b_last)
    if idx.device.type == "cpu":
        return ref.nttd_decode_tile(idx, *weights)
    lib = _build.library()
    bsz, t_steps = idx.shape
    if t_steps < 2:
        raise ValueError(f"decode_tile needs T >= 2 steps, got {t_steps}")
    if bsz >= 2**31:
        raise ValueError(f"decode_tile: {bsz} entries exceed the kernel's 2**31 - 1")
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
    body = decode_body(hid, rank)
    weights = bucket_operands(weights)
    if body == "register":
        entry = lib.repro_decode_tile
        widths = (weights[0].shape[2], weights[5].shape[0])  # the bucket
        for key in ("emb", "w_mid"):  # read as vectors from device memory
            if weights[names.index(key)].data_ptr() % 16:
                raise ValueError(f"decode_tile: {key} must be 16-byte aligned")
    else:
        entry = lib.repro_decode_tile_simt
        widths = (hid, rank, simt_threads(hid, rank))
    out = torch.empty((bsz,), dtype=emb.dtype, device=device)
    if bsz == 0:
        return out
    with torch.cuda.device(device):
        err = entry(
            idx.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
            bsz, t_steps, m_rows, *widths, DTYPE_CODES[emb.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, f"decode_tile ({body})", err)
    launches += 1
    if body == "simt":
        simt_launches += 1
    return out
