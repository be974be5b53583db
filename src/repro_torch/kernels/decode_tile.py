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
  bucket, hidden and rank as run-time values.  A block owns a tile of
  entries (``simt_tile``) for all T steps, keeps their state in shared
  memory and runs each step as FP32 products over the tile, the weights
  streamed through shared memory once a block.

Operand layout.  Both bodies take the ten weights in the layout
``decode_tile`` documents, contiguous.  The register body takes them
zero-padded to its bucket.  The simt body takes them zero-padded to rank
``simt_rank(R)``, R rounded up to a multiple of 4 (hidden unchanged), so
that every row of R weights is whole 16-byte vectors; it is exact for the
same reason.  It reads them in place: ``wi`` and ``wh`` as the two halves
of K of one [2H, 4H] gate product (regrouping the gate columns by unit as
it stages them into shared memory), ``w_mid`` [H, R R] as [H R, R] (row
k R + r sits at k R^2 + r R) and ``b_mid`` [R R] as [R, R]; the three heads'
weights and biases must be 16-byte aligned.
The weights are fixed for a payload, so the codec readies them once
(``bucket_operands``, through ``core.nttd.decode_operands``); operands
passed unpadded are padded at each call.  ``launches`` counts kernel
launches of either body, ``simt_launches`` those of the simt body, nothing
else.
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

# (hidden, rank) instantiations of csrc/decode_tile.cu, smallest first, as
# REPRO_DECODE_BUCKETS in csrc/decode_tile.cuh lists them:
# 12/6 (paper SMALL), 8/8 and 5/5 run in (12, 8); 16/8 (the default) in
# (16, 8); 18/10 (paper MEDIUM) in (20, 12); hidden = 2 rank up to rank 16
# in (32, 16); (64, 32) is the largest shape tested
BUCKETS = ((12, 8), (16, 8), (20, 12), (32, 16), (64, 32))
launches = 0
simt_launches = 0


def decode_body(hid: int, rank: int) -> str:
    """The body a CUDA call runs: "register" where a bucket holds the shape
    (``bucket_for``), else "simt"."""
    return "register" if any(hid <= h and rank <= r for h, r in BUCKETS) else "simt"


def simt_rank(rank: int) -> int:
    """The rank the simt body runs: R rounded up to a multiple of 4, so that
    every row of R weights is whole 16-byte vectors."""
    return -(-rank // 4) * 4


def simt_smem_bytes(hid: int, rank: int, tile: int) -> int:
    """Dynamic shared memory of a simt block owning ``tile`` entries, as
    ``simt_smem_floats`` in ``csrc/decode_tile_simt.cu`` counts it: x, h,
    h_new and c ([H][tile] each), v and v_new ([Rp][tile] each, Rp = R
    rounded up to 4) and two weight stages."""
    rp = simt_rank(rank)
    return 4 * (tile * (4 * hid + 2 * rp) + 2 * simt_stage_floats(hid, rp))


def simt_tile(hid: int, rank: int) -> int:
    """Entries a simt block owns: the largest multiple of 8 whose state and
    weight stages (``simt_smem_bytes``) fit a block's shared memory (136 at
    (68, 34), 72 at (114, 57), 32 at (256, 128)); raises only when one
    thread's tile of 8 entries does not fit."""
    tile = largest_simt_tile(lambda n: simt_smem_bytes(hid, rank, n))
    if tile < SIMT_TILE_STEP:
        raise ValueError(
            f"decode_tile: one tile of {SIMT_TILE_STEP} entries needs "
            f"{simt_smem_bytes(hid, rank, SIMT_TILE_STEP)} bytes of shared memory at "
            f"hidden {hid}, rank {rank}, more than the {MAX_SMEM_BYTES} a Hopper block "
            "can have"
        )
    return tile


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
    each on its own.  An operand with nothing to pad is returned as it is."""
    emb, wi, wh, b, w_first, b_first, w_mid, b_mid, w_last, b_last = weights
    hid, rank = emb.shape[2], b_first.shape[0]
    dh, dr = hid_to - hid, rank_to - rank
    if dh < 0 or dr < 0:
        raise ValueError(f"cannot pad hidden {hid}, rank {rank} to {hid_to}, {rank_to}")

    def pad(t, widths):
        return torch.nn.functional.pad(t, widths) if any(widths) else t

    def gates(w):  # [..., 4H] -> [..., 4 H_to]
        if not dh:
            return w
        return pad(w.reshape(*w.shape[:-1], 4, hid), (0, dh)).reshape(*w.shape[:-1], 4 * hid_to)

    def cores(w):  # [..., R*R] -> [..., R_to*R_to]
        if not dr:
            return w
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
    contiguous: zero-padded to their bucket for the register body, and to
    rank ``simt_rank(R)`` (hidden unchanged) for the simt body; returned as
    they are when already so."""
    hid, rank = weights[0].shape[2], weights[5].shape[0]
    if decode_body(hid, rank) == "register":
        bucket = bucket_for(hid, rank)
        if bucket != (hid, rank):
            weights = pad_to_bucket(weights, *bucket)
    elif simt_rank(rank) != rank:
        weights = pad_to_bucket(weights, hid, simt_rank(rank))
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
    widths = (weights[0].shape[2], weights[5].shape[0])  # the bucket, or the simt rank
    if body == "register":
        entry = lib.repro_decode_tile
        vectors = ("emb", "w_mid")
    else:
        entry = lib.repro_decode_tile_simt
        widths += (simt_tile(*widths),)
        vectors = ("w_first", "b_first", "w_mid", "b_mid", "w_last", "b_last")
    for key in vectors:  # read as 16-byte vectors from device memory
        if weights[names.index(key)].data_ptr() % 16:
            raise ValueError(f"decode_tile: {key} must be 16-byte aligned")
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
