"""The port's plain kernels (``repro_torch.kernels.ref``) and dispatcher
against the JAX package's oracles, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.  The
grids are those of ``tests/test_kernels.py``.  Tolerance: 1e-5 in f32,
0.1 in bf16 (rtol = atol).  In bf16 ``tt_contract`` is held against the
JAX oracle run in f32 on the same bf16 inputs: the port contracts in f32
like the Pallas kernel, while the JAX oracle contracts in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 0.1}
# one compiled program per shape instead of one eager dispatch per op
_J_DECODE = jax.jit(jref.nttd_decode_tile)
_J_LSTM = jax.jit(jref.lstm_scan)
_J_TT = jax.jit(jref.tt_contract)


def _pair(arr: np.ndarray, dt: str):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(arr, jdt), torch.from_numpy(np.asarray(arr, np.float32)).to(tdt)


def _close(got: torch.Tensor, want, dt: str) -> None:
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=TOL[dt], atol=TOL[dt]
    )


def _decode_args(b, t, m, hid, rank, seed=1, width_scaled=False):
    """Decode operands scaled as the reference's tests; ``width_scaled``
    multiplies every product over the hidden width by sqrt(16 / hid), so
    that a wide shape's values stay O(1) as they do at H 16 (with fixed
    scales the chain grows like (0.5 sqrt(R))^(T-2) and an f32 sum's
    rounding outgrows the tolerance where such values cancel)."""
    rng = np.random.default_rng(seed)
    width = np.sqrt(16 / hid) if width_scaled else 1.0

    def mk(*shape, scale=0.3):
        return rng.normal(size=shape) * scale

    idx = rng.integers(0, m, size=(b, t)).astype(np.int32)
    return idx, [
        mk(t, m, hid),
        mk(hid, 4 * hid, scale=0.3 * width), mk(hid, 4 * hid, scale=0.3 * width),
        mk(4 * hid, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
        mk(hid, rank * rank, scale=0.5 / np.sqrt(rank) * width), mk(rank * rank, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
    ]


def _decode_pair(idx, ws, dt):
    pairs = [_pair(w, dt) for w in ws]
    return (
        (jnp.asarray(idx), [p[0] for p in pairs]),
        (torch.from_numpy(idx), [p[1] for p in pairs]),
    )


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [2, 3, 8])
@pytest.mark.parametrize("rank", [4, 8, 32])
def test_decode_tile_matches_jax_oracle(rank, t, dt):
    idx, ws = _decode_args(33, t, 10, 16, rank)
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, dt)
    want = _J_DECODE(jidx, *jws)
    got = tref.nttd_decode_tile(tidx, *tws)
    assert got.dtype == DTYPES[dt][1] and got.shape == (33,)
    _close(got, want, dt)
    # on the CPU every kernel impl runs the plain version
    for impl in ("cuda", "fused", "auto"):
        assert torch.equal(tops.nttd_decode_tile(tidx, *tws, impl=impl), got)


@pytest.mark.parametrize("rank,t,dt", [(4, 2, "float32"), (8, 3, "bfloat16"), (32, 8, "float32")])
def test_decode_tile_matches_pallas_interpret(rank, t, dt):
    idx, ws = _decode_args(33, t, 7, 16, rank, seed=2)
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, dt)
    want = jops.nttd_decode_tile(jidx, *jws, impl="pallas_interpret", tile_b=16)
    _close(tops.nttd_decode_tile(tidx, *tws, impl="auto"), want, dt)


def test_decode_tile_out_of_range_index_gathers_zero_row():
    """An index outside [0, M) contributes a zero embedding, as the Pallas
    kernel's one-hot gather does."""
    idx, ws = _decode_args(33, 3, 7, 16, 8, seed=3)
    idx[0, 1] = 7
    idx[1, 2] = -1
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, "float32")
    want = jops.nttd_decode_tile(jidx, *jws, impl="pallas_interpret", tile_b=16)
    got = tops.nttd_decode_tile(tidx, *tws, impl="ref")
    _close(got, want, "float32")
    # the same as gathering an explicit zero row
    emb = torch.cat([tws[0], torch.zeros(3, 1, 16, dtype=tws[0].dtype)], dim=1)
    fixed = tidx.clone()
    fixed[0, 1] = 7
    fixed[1, 2] = 7
    assert torch.allclose(tref.nttd_decode_tile(fixed, emb, *tws[1:]), got, atol=0, rtol=0)


@pytest.mark.parametrize("impl", ["ref", "cuda", "fused", "auto"])
def test_decode_tile_empty_batch(impl):
    idx, ws = _decode_args(0, 3, 7, 16, 8)
    for dt in ("float32", "bfloat16"):
        _, (tidx, tws) = _decode_pair(idx, ws, dt)
        out = tops.nttd_decode_tile(tidx, *tws, impl=impl)
        assert out.shape == (0,) and out.dtype == DTYPES[dt][1]


def test_decode_tile_rejects_short_chain():
    idx, ws = _decode_args(8, 2, 7, 16, 8)
    _, (tidx, tws) = _decode_pair(idx, ws, "float32")
    tws[0] = tws[0][:1]
    for impl in ("ref", "cuda"):
        with pytest.raises(ValueError, match="T >= 2"):
            tops.nttd_decode_tile(tidx[:, :1], *tws, impl=impl)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,k,r", [(32, 0, 4), (64, 5, 8), (100, 10, 16), (7, 3, 8), (256, 8, 32), (33, 1, 4),
              (17, 3, 34), (9, 2, 57), (8, 2, 128)]
)
def test_tt_contract_matches_jax(b, k, r, dt):
    rng = np.random.default_rng(10 * k + r)
    jf, tf = _pair(rng.normal(size=(b, r)), dt)
    jm, tm = _pair(rng.normal(size=(b, k, r, r)) * (0.5 / np.sqrt(r)), dt)
    jl, tl = _pair(rng.normal(size=(b, r)), dt)
    f32 = jnp.float32
    want = _J_TT(jf.astype(f32), jm.astype(f32), jl.astype(f32)).astype(jf.dtype)
    got = tref.tt_contract(tf, tm, tl)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)
    # K == 0 is a row dot in the dispatcher; every impl agrees on the CPU
    for impl in ("cuda", "auto"):
        _close(tops.tt_contract(tf, tm, tl, impl=impl), want, dt)


def test_tt_contract_empty_batch():
    for impl in ("ref", "cuda"):
        out = tops.tt_contract(
            torch.zeros(0, 4), torch.zeros(0, 3, 4, 4), torch.zeros(0, 4), impl=impl
        )
        assert out.shape == (0,)


def _lstm_args(b, t, h, seed):
    """x, wi, wh, b scaled as the reference's tests (weights 0.3, bias 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h)), rng.normal(size=(h, 4 * h)) * 0.3,
            rng.normal(size=(h, 4 * h)) * 0.3, rng.normal(size=(4 * h,)) * 0.1)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h", [(16, 6, 8), (50, 9, 16), (33, 12, 32), (8, 3, 64), (0, 3, 16),
                                   (9, 4, 68), (7, 3, 114), (5, 3, 256)])
def test_lstm_scan_matches_jax(b, t, h, dt):
    """The last three widths are the simt body's (the budget rule's 1 MB, 4 MB
    and widest), at the reference's scales: the gates saturate rather than
    grow with H, so the f32 sums stay within the tolerance unscaled."""
    (jx, tx), (jwi, twi), (jwh, twh), (jb, tb) = (_pair(a, dt) for a in
                                                  _lstm_args(b, t, h, b + t + h))
    want = _J_LSTM(jx, jwi, jwh, jb)
    got = tref.lstm_scan(tx, twi, twh, tb)
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, t, h)
    _close(got, want, dt)
    assert torch.equal(tops.lstm_scan(tx, twi, twh, tb, impl="cuda"), got)


def test_lstm_scan_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(33, 9, 16)), rng.normal(size=(16, 64)) * 0.3,
            rng.normal(size=(16, 64)) * 0.3, rng.normal(size=(64,)) * 0.1]
    j, t = zip(*(_pair(a, "float32") for a in arrs))
    want = jops.lstm_scan(*j, impl="pallas_interpret", tile_b=16)
    _close(tops.lstm_scan(*t, impl="auto"), want, "float32")


def test_unknown_impl_raises():
    idx, ws = _decode_args(4, 3, 7, 16, 8)
    _, (tidx, tws) = _decode_pair(idx, ws, "float32")
    for impl in ("pallas", "pallas_interpret", "triton"):
        with pytest.raises(ValueError, match="unknown kernel impl"):
            tops.nttd_decode_tile(tidx, *tws, impl=impl)
        with pytest.raises(ValueError, match="unknown kernel impl"):
            tops.lstm_scan(torch.zeros(1, 2, 4), torch.zeros(4, 16), torch.zeros(4, 16),
                           torch.zeros(16), impl=impl)


def test_cpu_runs_count_no_launches():
    tops.reset_launch_counts()
    idx, ws = _decode_args(8, 3, 7, 16, 8)
    _, (tidx, tws) = _decode_pair(idx, ws, "float32")
    tops.nttd_decode_tile(tidx, *tws, impl="auto")
    q = torch.zeros((1, 130, 2, 8))
    tops.attention(q, q, q, impl="auto")
    x = torch.randn((4, 3, 16), requires_grad=True)
    first = torch.randn((4, 8), requires_grad=True)
    hs = tops.lstm_scan(x, *(w.detach() for w in tws[1:4]), impl="cuda")
    (hs.sum() + tops.tt_contract(first, torch.randn((4, 2, 8, 8)), first, impl="cuda").sum()
     ).backward()
    assert x.grad is not None and first.grad is not None
    assert tops.launch_counts() == {"decode_tile": 0, "lstm_scan": 0, "tt_contract": 0,
                                    "flash_attention": 0, "lstm_scan_bwd": 0,
                                    "tt_contract_bwd": 0}


@pytest.mark.parametrize("hid,rank", [(12, 5), (4, 2), (12, 6), (18, 10)])
def test_decode_tile_bucket_padding_is_exact(hid, rank):
    """The CUDA decode runs other (hidden, rank) shapes through a bucket on
    zero-padded weights.  The plain decode on the padded weights equals the
    JAX oracle on the unpadded ones: the identity the kernel relies on."""
    from repro_torch.kernels import decode_tile as tdecode

    idx, ws = _decode_args(65, 4, 9, hid, rank, seed=3)
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, "float32")
    want = _J_DECODE(jidx, *jws)
    bucket = tdecode.bucket_for(hid, rank)
    padded = tdecode.pad_to_bucket(tuple(tws), *bucket)
    assert padded[0].shape[2] == bucket[0] and padded[5].shape == (bucket[1],)
    _close(tref.nttd_decode_tile(tidx, *padded), want, "float32")
    with pytest.raises(ValueError, match="largest bucket"):
        tdecode.bucket_for(65, 4)


def test_decode_tile_buckets_hold_the_repo_configs():
    """Each NTTD architecture the repo runs lands in a bucket close to it,
    and ``bucket_operands`` pads only what is off a bucket."""
    from repro.configs import tensorcodec_paper
    from repro.core import nttd as jnttd
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_tile as tdecode

    from repro_torch.kernels import lstm as tlstm

    assert _build.decode_buckets() == tdecode.BUCKETS  # the C dispatch's list
    # decode_tile.cu and lstm.cu are built once per bucket and dtype
    assert len(_build.units()) == (len(_build.SOURCES) - 2 + 2 * len(tdecode.BUCKETS)
                                   + 2 * len(tlstm.BUCKETS))
    default = jnttd.NTTDConfig()
    for cfg, bucket in ((tensorcodec_paper.SMALL, (12, 8)), (default, (16, 8)),
                        (tensorcodec_paper.MEDIUM, (20, 12))):
        assert tdecode.bucket_for(cfg.hidden, cfg.rank) == bucket
    for shape, bucket in (((8, 8), (12, 8)), ((5, 5), (12, 8)), ((16, 4), (16, 8)),
                          ((24, 12), (32, 16)), ((16, 32), (64, 32)), ((64, 32), (64, 32))):
        assert tdecode.bucket_for(*shape) == bucket
    _, ws = _decode_args(3, 4, 9, 16, 8)
    tws = tuple(torch.from_numpy(np.asarray(w, np.float32)) for w in ws)
    assert all(a is b for a, b in zip(tdecode.bucket_operands(tws), tws))
    _, ws = _decode_args(3, 4, 9, 18, 10)
    padded = tdecode.bucket_operands(tuple(torch.from_numpy(np.asarray(w, np.float32))
                                           for w in ws))
    assert padded[0].shape == (4, 9, 20) and padded[6].shape == (20, 144)
    assert all(t.is_contiguous() for t in padded)


@pytest.mark.parametrize("hid,rank,body", [
    (1, 1, "register"), (12, 6, "register"), (16, 8, "register"), (18, 10, "register"),
    (24, 12, "register"), (16, 32, "register"), (64, 32, "register"),
    (68, 34, "simt"), (114, 57, "simt"), (256, 128, "simt"), (20, 40, "simt"), (65, 4, "simt"),
])
def test_decode_body_by_shape(hid, rank, body):
    """The register body runs exactly where a bucket holds the shape; every
    other shape, the budget rule's wide ones among them, runs the simt
    body, and ``bucket_for`` still refuses it."""
    from repro_torch.kernels import decode_tile as tdecode

    assert tdecode.decode_body(hid, rank) == body
    if body == "register":
        bucket = tdecode.bucket_for(hid, rank)
        assert hid <= bucket[0] and rank <= bucket[1]
    else:
        with pytest.raises(ValueError, match="largest bucket"):
            tdecode.bucket_for(hid, rank)


def test_bucket_operands_leaves_simt_shapes_unpadded():
    """The simt body's operands keep their hidden width unpadded and take
    rank R rounded up to a multiple of 4, zero-filled: at (68, 34), the
    1 MB budget rule's architecture, rank 36, the original weights in the
    top-left of each padded block; at (256, 128) the same tensors."""
    from repro_torch.kernels import decode_tile as tdecode

    _, ws = _decode_args(3, 4, 9, 68, 34)
    tws = tuple(torch.from_numpy(np.asarray(w, np.float32)) for w in ws)
    got = tdecode.bucket_operands(tws)
    assert tdecode.simt_rank(34) == 36
    shapes = [(4, 9, 68), (68, 272), (68, 272), (272,), (68, 36), (36,), (68, 36 * 36),
              (36 * 36,), (68, 36), (36,)]
    assert [tuple(t.shape) for t in got] == shapes
    assert all(t.is_contiguous() for t in got)
    assert all(a is b for a, b in zip(got[:4], tws[:4]))  # emb and the LSTM as they are
    for key in (4, 5, 8, 9):  # first and last heads: R columns, then zeros
        assert torch.equal(got[key][..., :34], tws[key]) and not got[key][..., 34:].any()
    mid = got[6].view(68, 36, 36)
    assert torch.equal(mid[:, :34, :34], tws[6].view(68, 34, 34))
    assert not mid[:, 34:].any() and not mid[:, :, 34:].any()
    bmid = got[7].view(36, 36)
    assert torch.equal(bmid[:34, :34], tws[7].view(34, 34))
    assert not bmid[34:].any() and not bmid[:, 34:].any()
    _, ws = _decode_args(3, 4, 9, 256, 128)
    tws = tuple(torch.from_numpy(np.asarray(w, np.float32)) for w in ws)
    assert all(a is b for a, b in zip(tdecode.bucket_operands(tws), tws))
    # a transposed (non-contiguous) operand comes back contiguous and equal
    wt = tws[1].t().contiguous().t()
    got = tdecode.bucket_operands(tws[:1] + (wt,) + tws[2:])
    assert got[1].is_contiguous() and torch.equal(got[1], tws[1])


@pytest.mark.parametrize("shape,tile", [
    ((68, 34), 136), ((114, 57), 72), ((256, 128), 32), ((65, 4), 184), ((1290, 28), 8),
])
def test_simt_tile_fits_shared_memory(shape, tile):
    """The simt decode body's tile is the largest multiple of 8 entries
    whose state and two weight stages fit a Hopper block's 232,448 bytes of
    shared memory."""
    from repro_torch.kernels import _common
    from repro_torch.kernels import decode_tile as tdecode

    got = tdecode.simt_tile(*shape)
    assert got == tile
    assert got % 8 == 0
    assert tdecode.simt_smem_bytes(*shape, got) <= _common.MAX_SMEM_BYTES
    assert tdecode.simt_smem_bytes(*shape, got + 8) > _common.MAX_SMEM_BYTES
    # the tile is chosen on the rank the body runs, R rounded up to 4
    assert tdecode.simt_tile(shape[0], tdecode.simt_rank(shape[1])) == got


@pytest.mark.parametrize("hid,tile", [(68, 176), (96, 112), (114, 88), (256, 40), (1304, 8)])
def test_lstm_simt_tile_fits_shared_memory(hid, tile):
    """The simt lstm_scan body's tile is the largest multiple of 8 sequences
    whose state (x, h, h_new, c: 4 H floats a sequence) and two weight
    stages fit a Hopper block's 232,448 bytes of shared memory."""
    from repro_torch.kernels import _common
    from repro_torch.kernels import lstm as tlstm

    got = tlstm.simt_tile(hid)
    assert got == tile
    assert got % 8 == 0
    assert tlstm.simt_smem_bytes(hid, got) <= _common.MAX_SMEM_BYTES
    assert tlstm.simt_smem_bytes(hid, got + 8) > _common.MAX_SMEM_BYTES
    # the decode's rule with no rank: the same state and weight stages
    from repro_torch.kernels import decode_tile as tdecode

    assert tlstm.simt_smem_bytes(hid, got) == tdecode.simt_smem_bytes(hid, 0, got)


@pytest.mark.parametrize("shape", [(14_600, 1), (1, 29_057), (1291, 28)])
def test_simt_tile_raises_past_one_tile(shape):
    """Only a shape whose tile of 8 entries exceeds a block's shared memory
    is refused."""
    from repro_torch.kernels import decode_tile as tdecode

    with pytest.raises(ValueError, match="one tile of 8 entries needs .* bytes of shared memory"):
        tdecode.simt_tile(*shape)


@pytest.mark.parametrize("hid", [1305, 14_529])
def test_lstm_simt_tile_raises_past_one_tile(hid):
    """Only a width whose tile of 8 sequences exceeds a block's shared
    memory is refused."""
    from repro_torch.kernels import lstm as tlstm

    with pytest.raises(ValueError, match="one tile of 8 sequences needs .* bytes of shared memory"):
        tlstm.simt_tile(hid)


def _simt_layout_decode(idx: torch.Tensor, ws: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The decode as the simt body computes it, in plain torch, from the
    operands as ``bucket_operands`` lays them out: the gates as one product
    of [x | h] with [wi; wh], and the mid step as (h (x) v) . W_mid read as
    [H R, R] (row k R + r) plus v . b_mid read as [R, R]."""
    emb, wi, wh, b, wf, bf, wm, bm, wl, bl = ws
    hid, rank = emb.shape[2], bf.shape[0]
    rows = wm.view(hid * rank, rank)  # no copy: row k R + r at k R^2 + r R
    assert rows.data_ptr() == wm.data_ptr()
    w_gates, rows, b_rows = torch.cat([wi, wh]).float(), rows.float(), bm.view(rank, rank).float()
    emb, b, wf, bf, wl, bl = (t.float() for t in (emb, b, wf, bf, wl, bl))
    bsz, t_steps = idx.shape
    h = torch.zeros((bsz, hid))
    c = torch.zeros((bsz, hid))
    for t in range(t_steps):
        gates = torch.cat([emb[t][idx[:, t].long()], h], dim=1) @ w_gates + b
        i, f, g, o = gates.split(hid, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        if t == 0:
            v = h @ wf + bf
        elif t == t_steps - 1:
            out = (v * (h @ wl + bl)).sum(-1)
        else:
            v = (h[:, :, None] * v[:, None, :]).reshape(bsz, hid * rank) @ rows + v @ b_rows
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [3, 10])
@pytest.mark.parametrize("hid,rank", [(68, 34), (114, 57), (256, 128)])
def test_simt_layout_decode_matches_jax_oracle(hid, rank, t, dt):
    """The sum and the operand layout the simt body relies on: the decode
    from ``bucket_operands``' simt layout (rank padded to a multiple of 4,
    W_mid read as [H R, R]) equals the JAX oracle on the unpadded
    weights."""
    from repro_torch.kernels import decode_tile as tdecode

    idx, ws = _decode_args(9, t, 9, hid, rank, seed=hid + t, width_scaled=True)
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, dt)
    want = _J_DECODE(jidx, *jws)
    laid = tdecode.bucket_operands(tuple(tws))
    assert laid[5].shape == (tdecode.simt_rank(rank),)
    _close(_simt_layout_decode(tidx, laid), want, dt)


def _simt_layout_lstm(x, wi, wh, b) -> torch.Tensor:
    """The LSTM scan as the simt body computes it, in plain torch: each
    step's gates as one product of [x_t | h] with [wi; wh] (x's K rows, then
    h's), plus b, in f32; every h in x's dtype."""
    bsz, t_steps, hid = x.shape
    w_gates, b = torch.cat([wi, wh]).float(), b.float()
    h = torch.zeros((bsz, hid))
    c = torch.zeros((bsz, hid))
    outs = []
    for t in range(t_steps):
        gates = torch.cat([x[:, t].float(), h], dim=1) @ w_gates + b
        i, f, g, o = gates.split(hid, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1).to(x.dtype)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hid", [68, 96, 114, 256])
def test_simt_layout_lstm_matches_jax_oracle(hid, dt):
    """The order of sums the simt lstm_scan body relies on: one K = 2H
    product over [x_t | h] per step, against the JAX oracle's two."""
    from repro_torch.kernels import lstm as tlstm

    assert tlstm.lstm_body(hid) == "simt"
    (jx, tx), (jwi, twi), (jwh, twh), (jb, tb) = (_pair(a, dt) for a in
                                                  _lstm_args(11, 6, hid, hid))
    want = _J_LSTM(jx, jwi, jwh, jb)
    got = _simt_layout_lstm(tx, twi, twh, tb)
    assert got.dtype == DTYPES[dt][1] and got.shape == (11, 6, hid)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("hid,rank,b", [(68, 34, 33), (256, 128, 8)])
def test_decode_tile_wide_matches_jax_oracle(hid, rank, b, t, dt):
    """The simt body's shapes: the port's decode (on the CPU, its plain
    version, through every kernel impl) against the JAX oracle."""
    from repro_torch.kernels import decode_tile as tdecode

    assert tdecode.decode_body(hid, rank) == "simt"
    idx, ws = _decode_args(b, t, 9, hid, rank, seed=hid + t, width_scaled=True)
    (jidx, jws), (tidx, tws) = _decode_pair(idx, ws, dt)
    want = _J_DECODE(jidx, *jws)
    got = tref.nttd_decode_tile(tidx, *tws)
    assert got.dtype == DTYPES[dt][1] and got.shape == (b,)
    _close(got, want, dt)
    for impl in ("cuda", "fused", "auto"):
        assert torch.equal(tops.nttd_decode_tile(tidx, *tws, impl=impl), got)


@pytest.mark.parametrize("rank,group", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (9, 16),
                                        (16, 16), (17, 32), (32, 32), (34, 32), (128, 32)])
def test_tt_contract_lanes_per_entry(rank, group):
    """The lane group of the tt_contract body: the smallest power of two
    holding a row of R, at most a warp."""
    from repro_torch.kernels import tt_contract as ttt

    assert ttt.lanes_per_entry(rank) == group


@pytest.mark.parametrize("hid,bucket", [(5, 12), (8, 12), (12, 12), (16, 16), (18, 20),
                                        (24, 32), (64, 64)])
def test_lstm_bucket_for_the_repo_widths(hid, bucket):
    """Every LSTM width the repo runs lands in the smallest register-body
    bucket that holds it."""
    from repro_torch.kernels import lstm as tlstm

    assert tlstm.bucket_for(hid) == bucket
    assert tlstm.lstm_body(hid) == "register"


@pytest.mark.parametrize("hid,body", [(1, "register"), (64, "register"), (65, "simt"),
                                      (68, "simt"), (96, "simt"), (114, "simt")])
def test_lstm_body_by_shape(hid, body):
    """Up to the largest bucket the register body runs, above it the simt
    body, which has no bucket."""
    from repro_torch.kernels import lstm as tlstm

    assert tlstm.lstm_body(hid) == body
    if body == "simt":
        with pytest.raises(ValueError, match="largest bucket"):
            tlstm.bucket_for(hid)


def test_lstm_buckets_match_the_header():
    """The wrapper's buckets are the ones ``csrc/lstm.cuh`` instantiates."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import lstm as tlstm

    assert _build.lstm_buckets() == tlstm.BUCKETS


@pytest.mark.parametrize("hid,dt,offset,vec", [
    (16, torch.float32, 0, True),
    (18, torch.float32, 0, False),   # 72-byte rows
    (16, torch.float32, 1, False),   # x 4 bytes off the 16-byte grid
    (16, torch.bfloat16, 4, True),   # 8 bytes off: a whole bf16 vector
    (16, torch.bfloat16, 2, False),
])
def test_lstm_vector_rows(hid, dt, offset, vec):
    """The register body reads and writes rows as vectors only when every
    row is whole vectors and x and out are aligned to one."""
    from repro_torch.kernels import lstm as tlstm

    x = torch.zeros(3 * 4 * hid + offset, dtype=dt)[offset:].view(3, 4, hid)
    assert x.is_contiguous()
    assert tlstm.vector_rows(x, torch.empty_like(x)) is vec
    assert tlstm.vector_rows(torch.empty_like(x), x) is vec  # out's alignment counts too


@pytest.mark.parametrize("hid", [5, 12, 18, 24])
def test_lstm_bucket_padding_is_exact(hid):
    """The register body runs a hidden width off its buckets on weights and
    x padded to the bucket inside the kernel, each gate block on its own.
    The plain scan on so padded inputs, sliced back, equals the JAX oracle
    on the unpadded ones, and the padded units stay exactly 0: the identity
    the kernel's staging relies on."""
    from repro_torch.kernels import lstm as tlstm

    rng = np.random.default_rng(hid)
    x = rng.normal(size=(33, 7, hid))
    wi, wh = (rng.normal(size=(hid, 4 * hid)) * 0.3 for _ in range(2))
    b = rng.normal(size=(4 * hid,)) * 0.1
    want = _J_LSTM(*(jnp.asarray(a, jnp.float32) for a in (x, wi, wh, b)))
    pad = tlstm.bucket_for(hid) - hid

    def gates(w):  # [..., 4 hid] -> [..., 4 H], each gate block padded
        w = w.reshape(*w.shape[:-1], 4, hid)
        return np.pad(w, [(0, 0)] * (w.ndim - 1) + [(0, pad)]).reshape(*w.shape[:-2], -1)

    padded = (np.pad(x, ((0, 0), (0, 0), (0, pad))),
              np.pad(gates(wi), ((0, pad), (0, 0))), np.pad(gates(wh), ((0, pad), (0, 0))),
              gates(b))
    got = tref.lstm_scan(*(torch.from_numpy(np.asarray(a, np.float32)) for a in padded))
    assert got.shape == (33, 7, hid + pad)
    _close(got[..., :hid], want, "float32")
    assert not got[..., hid:].any()


# ---------------------------------------------------------------------------
# backward kernels: plain versions against jax.grad, and the kernels' sums
# ---------------------------------------------------------------------------
BWD_TOL = dict(rtol=1e-4, atol=1e-6)


def _close_all(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


def _lstm_bwd_case(b, t, h, seed, width_scaled=False):
    """x, wi, wh, b as ``_lstm_args`` and a gradient dhs, all f32 numpy.
    ``width_scaled`` multiplies x, wi and wh by sqrt(16 / H), so that a wide
    case's gates and gradients stay at H 16's scale (the codec's own
    embeddings start at N(0, 1 / H)): at unit scale and H 256 the gradients
    reach ~7, and the two packages' f32 sums in different orders differ by
    up to 2.6e-6 there, past the 1e-6 atol on the elements near 0."""
    x, wi, wh, bias = _lstm_args(b, t, h, seed)
    if width_scaled:
        x, wi, wh = (a * np.sqrt(16 / h) for a in (x, wi, wh))
    dhs = np.random.default_rng(seed + 1).normal(size=(b, t, h))
    return [np.asarray(a, np.float32) for a in (x, wi, wh, bias, dhs)]


def _jax_lstm_grads(x, wi, wh, b, dhs):
    _, vjp = jax.vjp(jref.lstm_scan, *(jnp.asarray(a) for a in (x, wi, wh, b)))
    return vjp(jnp.asarray(dhs))


@pytest.mark.parametrize("b,t,h,scaled", [(9, 6, 5, False), (9, 6, 12, False), (9, 10, 18, False),
                                          (7, 5, 68, False), (5, 4, 256, True)])
def test_lstm_scan_bwd_matches_jax_grad(b, t, h, scaled):
    """ref.lstm_scan_bwd and the wrapper's CPU route against jax.grad of the
    reference oracle; H 256 with its weights scaled to the width."""
    from repro_torch.kernels import lstm as tlstm

    arrs = _lstm_bwd_case(b, t, h, seed=h + t, width_scaled=scaled)
    want = _jax_lstm_grads(*arrs)
    tx, twi, twh, tb, tdhs = (torch.from_numpy(a) for a in arrs)
    _close_all(tref.lstm_scan_bwd(tx, twi, twh, tb, tdhs), want)
    hs = tops.lstm_scan(tx, twi, twh, tb)
    _close_all(tlstm.lstm_scan_bwd(tx, twi, twh, tb, hs, tdhs), want)


def _lstm_bwd_as_kernel(x, wi, wh, b, hs, dhs):
    """The lstm_scan backward as csrc/lstm_bwd.cu computes it, in plain
    torch: phase 1 recomputes every step's gates from x_t and the saved
    h_{t-1} and runs c forward; phase 2 sweeps t backwards (dh = dhs_t +
    dh_rec, dc carried through f, dG_t, dh_rec = dG_t wh^T); then the
    wrapper's products over B T."""
    bsz, t_steps, hid = x.shape
    h_prev = torch.cat([torch.zeros((bsz, 1, hid)), hs[:, :-1]], dim=1)
    acts, cs, c = [], [], torch.zeros((bsz, hid))
    for t in range(t_steps):
        gates = torch.cat([x[:, t], h_prev[:, t]], dim=1) @ torch.cat([wi, wh]) + b
        i, f, g, o = gates.split(hid, dim=1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        acts.append((i, f, g, o))
        cs.append(c)
    dg = torch.empty((bsz, t_steps, 4 * hid))
    dh_rec, dc_carry = torch.zeros((bsz, hid)), torch.zeros((bsz, hid))
    for t in reversed(range(t_steps)):
        i, f, g, o = acts[t]
        c_prev = cs[t - 1] if t else torch.zeros((bsz, hid))
        dh = dhs[:, t] + dh_rec
        tc = torch.tanh(cs[t])
        dc = dc_carry + dh * o * (1 - tc * tc)
        dc_carry = dc * f
        dg[:, t] = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                              dc * i * (1 - g * g), dh * tc * o * (1 - o)], dim=1)
        dh_rec = dg[:, t] @ wh.t().contiguous()  # dG_t . wh^T, as the kernel reads wh^T
    dg2 = dg.reshape(-1, 4 * hid)
    return ((dg2 @ wi.t()).view(bsz, t_steps, hid), x.reshape(-1, hid).t() @ dg2,
            h_prev.reshape(-1, hid).t() @ dg2, dg2.sum(0))


@pytest.mark.parametrize("h", [5, 18, 68, 256])
def test_lstm_bwd_kernel_sums_match_jax_grad(h):
    """The backward kernel's algorithm (recompute from the saved h, reverse
    sweep, products over B T) against jax.grad."""
    arrs = _lstm_bwd_case(6, 5, h, seed=3 * h, width_scaled=h > 64)
    tx, twi, twh, tb, tdhs = (torch.from_numpy(a) for a in arrs)
    _close_all(_lstm_bwd_as_kernel(tx, twi, twh, tb, tref.lstm_scan(tx, twi, twh, tb), tdhs),
               _jax_lstm_grads(*arrs))


def _tt_bwd_case(b, k, r, seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(a, np.float32) for a in (
        rng.normal(size=(b, r)), rng.normal(size=(b, k, r, r)) * (0.5 / np.sqrt(r)),
        rng.normal(size=(b, r)), rng.normal(size=(b,)))]


def _jax_tt_grads(first, mid, last, dout):
    _, vjp = jax.vjp(jref.tt_contract, *(jnp.asarray(a) for a in (first, mid, last)))
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("k", [0, 1, 8])
@pytest.mark.parametrize("r", [1, 6, 10, 34])
def test_tt_contract_bwd_matches_jax_grad(r, k):
    """ref.tt_contract_bwd, the wrapper's CPU route and autograd through the
    dispatcher (K == 0: its row dot) against jax.grad of the oracle."""
    from repro_torch.kernels import tt_contract as ttt

    arrs = _tt_bwd_case(13, k, r, seed=10 * k + r)
    want = _jax_tt_grads(*arrs)
    tf, tm, tl, td = (torch.from_numpy(a) for a in arrs)
    _close_all(tref.tt_contract_bwd(tf, tm, tl, td), want)
    _close_all(ttt.tt_contract_bwd(tf, tm, tl, td), want)
    leaves = [a.clone().requires_grad_() for a in (tf, tm, tl)]
    torch.autograd.backward(tops.tt_contract(*leaves, impl="cuda"), td)
    # K == 0: mid (empty) is not reached and keeps no gradient
    _close_all([torch.zeros_like(a) if a.grad is None else a.grad for a in leaves], want)


def _tt_bwd_as_kernel(first, mid, last, dout):
    """The tt_contract backward as csrc/tt_contract_bwd.cu computes it:
    every prefix v_0 .. v_K kept, then the suffix u swept from ``last``,
    dmid_k = g v_{k-1} (x) u_{k+1} and u_k = mid_k u_{k+1} row by row."""
    k_steps = mid.shape[1]
    vs = [first]
    for k in range(k_steps):
        vs.append(torch.einsum("br,brs->bs", vs[-1], mid[:, k]))
    g = dout[:, None]
    dmid = torch.empty_like(mid)
    u = last
    for k in reversed(range(k_steps)):
        dmid[:, k] = g[:, :, None] * vs[k][:, :, None] * u[:, None, :]
        u = (mid[:, k] * u[:, None, :]).sum(-1)
    return g * u, dmid, g * vs[k_steps]


@pytest.mark.parametrize("b,k,r", [(13, 1, 6), (13, 8, 10), (5, 4, 128)])
def test_tt_bwd_kernel_sums_match_jax_grad(b, k, r):
    arrs = _tt_bwd_case(b, k, r, seed=r)
    tf, tm, tl, td = (torch.from_numpy(a) for a in arrs)
    _close_all(_tt_bwd_as_kernel(tf, tm, tl, td), _jax_tt_grads(*arrs))


def test_tt_contract_bwd_wide_matches_jax_grad():
    """The widest chain the budget rule reaches, R 128."""
    arrs = _tt_bwd_case(5, 4, 128, seed=128)
    _close_all(tref.tt_contract_bwd(*(torch.from_numpy(a) for a in arrs)), _jax_tt_grads(*arrs))


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,hid,match", [
    (torch.bfloat16, 16, "float32 only"), (torch.float16, 16, "float32 only"),
    (torch.float32, 257, "hidden 257 outside 1..256"), (torch.float32, 1304, "outside 1..256"),
])
def test_lstm_scan_bwd_wrapper_limits(dtype, hid, match):
    """The backward kernel's wrapper refuses what the kernel does not take
    before it builds or launches anything (meta tensors: no card)."""
    from repro_torch.kernels import lstm as tlstm

    args = [_meta(4, 3, hid, dtype=dtype), _meta(hid, 4 * hid, dtype=dtype),
            _meta(hid, 4 * hid, dtype=dtype), _meta(4 * hid, dtype=dtype),
            _meta(4, 3, hid, dtype=dtype), _meta(4, 3, hid, dtype=dtype)]
    with pytest.raises(ValueError, match=match):
        tlstm.lstm_scan_bwd(*args)


@pytest.mark.parametrize("dtype,rank,k,match", [
    (torch.bfloat16, 8, 2, "float32 only"), (torch.float32, 129, 2, "rank 129 outside 1..128"),
    (torch.float32, 8, 0, "K >= 1"),
])
def test_tt_contract_bwd_wrapper_limits(dtype, rank, k, match):
    from repro_torch.kernels import tt_contract as ttt

    args = [_meta(4, rank, dtype=dtype), _meta(4, k, rank, rank, dtype=dtype),
            _meta(4, rank, dtype=dtype), _meta(4, dtype=dtype)]
    with pytest.raises(ValueError, match=match):
        ttt.tt_contract_bwd(*args)


@pytest.mark.parametrize("hid,tile", [(5, 100), (12, 40), (18, 28), (68, 4), (128, 4),
                                      (256, 4)])
def test_lstm_bwd_tile(hid, tile):
    """Sequences a backward block owns: 4 an item, about one item a thread
    of 128; its shared memory (6 H rows of tile + 4 floats) fits a block."""
    from repro_torch.kernels import lstm as tlstm
    from repro_torch.kernels._common import MAX_SMEM_BYTES

    assert tlstm.bwd_tile(hid) == tile
    assert 4 * 6 * hid * (tile + 4) <= MAX_SMEM_BYTES
