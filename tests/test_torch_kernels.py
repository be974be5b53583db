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
_J_LSTM_UNROLLED = jax.jit(jref.lstm_unrolled)
_J_TT_UNROLLED = jax.jit(jref.tt_contract_unrolled)


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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,r", [(32, 0, 4), (64, 5, 8), (7, 3, 8), (33, 1, 4), (8, 2, 128)])
def test_tt_contract_unrolled_matches_jax(b, k, r, dt):
    """``impl="ref_unrolled"`` against the reference's unrolled oracle (in
    bf16 run in f32 on the same bf16 inputs, as above)."""
    rng = np.random.default_rng(10 * k + r + 1)
    jf, tf = _pair(rng.normal(size=(b, r)), dt)
    jm, tm = _pair(rng.normal(size=(b, k, r, r)) * (0.5 / np.sqrt(r)), dt)
    jl, tl = _pair(rng.normal(size=(b, r)), dt)
    f32 = jnp.float32
    want = _J_TT_UNROLLED(jf.astype(f32), jm.astype(f32), jl.astype(f32)).astype(jf.dtype)
    got = tops.tt_contract(tf, tm, tl, impl="ref_unrolled")
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)
    _close(tref.tt_contract_unrolled(tf, tm, tl), want, dt)


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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h", [(16, 6, 8), (50, 9, 16), (8, 3, 64), (0, 3, 16), (9, 4, 68)])
def test_lstm_unrolled_matches_jax(b, t, h, dt):
    """``impl="ref_unrolled"`` against the reference's unrolled oracle."""
    (jx, tx), (jwi, twi), (jwh, twh), (jb, tb) = (_pair(a, dt) for a in
                                                  _lstm_args(b, t, h, b + t + h + 1))
    want = _J_LSTM_UNROLLED(jx, jwi, jwh, jb)
    got = tops.lstm_scan(tx, twi, twh, tb, impl="ref_unrolled")
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, t, h)
    _close(got, want, dt)
    assert torch.equal(tref.lstm_unrolled(tx, twi, twh, tb), got)


def test_ref_unrolled_is_the_unfused_route_only():
    """"ref_unrolled" names the two unfused kernels' plain route; the fused
    decode and attention refuse it, as they refuse any unknown impl."""
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.nttd_decode_tile(torch.zeros((2, 3), dtype=torch.int32), *(torch.zeros(1),) * 10,
                              impl="ref_unrolled")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.attention(*(torch.zeros((1, 4, 2, 8)),) * 3, impl="ref_unrolled")


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
    torch: the forward sweep runs every step's gates from x_t and the saved
    h_{t-1}, keeps c (and the gates) of every step and writes the operand
    rows A = [x_t | h_{t-1} | 1]; the reverse sweep forms dG_t (dh = dhs_t +
    dh_rec, dc carried through f) into G and runs [dx_t | dh_rec] = dG_t
    [wi; wh]^T as one product; the weight gradients are the wrapper's own
    product A^T G over B T (``lstm.weight_grads``)."""
    from repro_torch.kernels import lstm as tlstm

    bsz, t_steps, hid = x.shape
    w = torch.cat([wi, wh])
    zeros = torch.zeros((bsz, hid))
    a_rows = torch.empty((bsz, t_steps, 2 * hid + 1))
    gates, cs, c = [], [], zeros
    for t in range(t_steps):
        a_rows[:, t] = torch.cat([x[:, t], hs[:, t - 1] if t else zeros,
                                  torch.ones((bsz, 1))], dim=1)
        i, f, g, o = (a_rows[:, t, :-1] @ w + b).split(hid, dim=1)
        gates.append((torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)))
        c = gates[-1][1] * c + gates[-1][0] * gates[-1][2]
        cs.append(c)
    dx = torch.empty_like(x)
    dg = torch.empty((bsz, t_steps, 4 * hid))
    dh_rec, dc_carry = zeros, zeros
    for t in reversed(range(t_steps)):
        i, f, g, o = gates[t]
        c_prev = cs[t - 1] if t else zeros
        dh = dhs[:, t] + dh_rec
        tc = torch.tanh(cs[t])
        dc = dc_carry + dh * o * (1 - tc * tc)
        dc_carry = dc * f
        dg[:, t] = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                              dc * i * (1 - g * g), dh * tc * o * (1 - o)], dim=1)
        dx[:, t], dh_rec = (dg[:, t] @ w.t()).split(hid, dim=1)
    rows, bt = tlstm.bwd_rows(bsz, t_steps), bsz * t_steps
    a_pad, g_pad = torch.zeros((rows, 2 * hid + 1)), torch.zeros((rows, 4 * hid))
    a_pad[:bt], g_pad[:bt] = a_rows.reshape(bt, -1), dg.reshape(bt, -1)
    return (dx, *tlstm.weight_grads(a_pad, g_pad))


@pytest.mark.parametrize("h", [5, 18, 68, 256])
def test_lstm_bwd_kernel_sums_match_jax_grad(h):
    """The backward kernel's algorithm (recompute from the saved h, reverse
    sweep, products over B T) against jax.grad."""
    arrs = _lstm_bwd_case(6, 5, h, seed=3 * h, width_scaled=h > 64)
    tx, twi, twh, tb, tdhs = (torch.from_numpy(a) for a in arrs)
    _close_all(_lstm_bwd_as_kernel(tx, twi, twh, tb, tref.lstm_scan(tx, twi, twh, tb), tdhs),
               _jax_lstm_grads(*arrs))


@pytest.mark.parametrize("b,t", [(1, 1), (3, 1), (4, 2)])
def test_lstm_bwd_kernel_sums_short_sequences(b, t):
    """The operand rows at their edges: T 1 (every h_{t-1} is 0, so dwh is
    exactly 0) and T 2, and a single sequence."""
    arrs = _lstm_bwd_case(b, t, 5, seed=7 * t + b)
    tx, twi, twh, tb, tdhs = (torch.from_numpy(a) for a in arrs)
    got = _lstm_bwd_as_kernel(tx, twi, twh, tb, tref.lstm_scan(tx, twi, twh, tb), tdhs)
    _close_all(got, _jax_lstm_grads(*arrs))
    if t == 1:
        assert not got[2].any()


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
    """The tt_contract backward in the slab plan's order of work
    (csrc/tt_contract_bwd.cu): mid copied into a buffer once; the prefix
    sweep keeps every v_0 .. v_K, v_{k+1}[j] = v_k . column j of mid_k; the
    suffix sweep, k = K down to 1, computes u_k[j] = row j of mid_k .
    u_{k+1}, then writes dmid_k = g v_k (x) u_{k+1} in mid_k's place; the
    buffer is dmid."""
    k_steps = mid.shape[1]
    buf = mid.clone()
    vs = [first]
    for k in range(k_steps):
        vs.append((vs[-1][:, :, None] * buf[:, k]).sum(1))
    g = dout[:, None]
    u = last
    for k in reversed(range(k_steps)):
        u_k = (buf[:, k] * u[:, None, :]).sum(-1)
        buf[:, k] = (g * vs[k])[:, :, None] * u[:, None, :]
        u = u_k
    return g * u, buf, g * vs[k_steps]


@pytest.mark.parametrize("b,k,r", [(13, 1, 6), (13, 8, 10), (5, 4, 128), (7, 3, 5)])
def test_tt_bwd_kernel_sums_match_jax_grad(b, k, r):
    """(7, 3, 5): K R^2 = 75, not a multiple of 4 (ragged heads and tails)."""
    arrs = _tt_bwd_case(b, k, r, seed=r)
    tf, tm, tl, td = (torch.from_numpy(a) for a in arrs)
    _close_all(_tt_bwd_as_kernel(tf, tm, tl, td), _jax_tt_grads(*arrs))


def _entry_span(first_float: int, per: int) -> tuple[int, int, int]:
    """The slab plan's split of an entry (csrc/tt_contract_bwd.cu:
    entry_span): its first float's offset from the 16-byte grid, the floats
    before the 16-byte-aligned interior, and the interior's floats (a
    multiple of 4; none when the entry holds no aligned 16 bytes)."""
    shift = first_float % 4
    head = min((4 - shift) % 4, per)
    chunks = (per - head) // 4
    return shift, head if chunks else per, 4 * chunks


@pytest.mark.parametrize("k,r", [(8, 10), (8, 6), (3, 5), (1, 1), (1, 3), (2, 1), (4, 7)])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_tt_bwd_slab_reads_each_float_once(k, r, base):
    """The slab plan's copies of mid, and its stores of dmid, at every
    entry of a slab walk over B 1001 with mid ``base`` floats off the
    16-byte grid: every float of every entry once, the bulk interior (the
    loads' TMA copy, the stores' 16-byte chunks) 16-byte aligned both in
    device memory and in its slot of the buffer, a whole number of 16
    bytes, the rest (the ragged head and tail) at most 3 + 3 plain floats;
    the persistent blocks' slabs, block b taking b, b + blocks, ..., cover
    every entry once."""
    from repro_torch.kernels import tt_contract as ttt

    bsz, per = 1001, k * r * r
    plan = ttt.bwd_plan(r, k, bsz)
    assert plan.kind == "slab"
    slabs = -(-bsz // plan.entries)
    walked = sorted(s for blk in range(plan.blocks) for s in range(blk, slabs, plan.blocks))
    assert walked == list(range(slabs))
    for e in range(bsz):
        start = base + e * per
        shift, head, bulk = _entry_span(start, per)
        tail = per - head - bulk
        assert 0 <= tail and (bulk == 0 or (head <= 3 and tail <= 3))
        if bulk:
            slot = e % plan.entries * plan.stride + shift
            assert (start + head) % 4 == 0 and (slot + head) % 4 == 0 and bulk % 4 == 0
        assert shift + per <= plan.stride


def test_tt_bwd_plans_fit_shared_memory():
    """Both plans at every R 1..128 and K 1..16 (B 8192): the block fits a
    Hopper block's shared memory; a slab block also leaves room for a second
    on the SM, its threads are whole warps of which only the last's tail
    idles, and its slots hold an entry and its offset from the 16-byte grid
    in a multiple of 4 floats.  The wide plan, taken only where not one
    entry's slab block fits twice a SM: the fewest blocks a cluster (1, 2,
    4 or 8) that each hold a row and fit two a SM (else 8), a prefix thread
    for every column, slots for a block's rows of a core and their offset
    from the grid, whole clusters of persistent blocks, as many as the SMs
    hold at once."""
    from repro_torch.kernels import tt_contract as ttt
    from repro_torch.kernels._common import MAX_SMEM_BYTES

    for r in range(1, 129):
        for k in range(1, 17):
            plan = ttt.bwd_plan(r, k, 8192)
            assert plan.smem_bytes <= MAX_SMEM_BYTES, (r, k, plan)
            if plan.kind == "slab":
                assert 2 * (plan.smem_bytes + ttt.BLOCK_RESERVED_SMEM) <= ttt.SM_SMEM_BYTES
                assert plan.threads % 32 == 0 and 0 <= plan.threads - plan.entries * r < 32
                assert plan.threads <= ttt.BWD_SLAB_THREADS
                assert plan.stride % 4 == 0 and plan.stride >= k * r * r + 3
                assert plan.blocks <= -(-8192 // plan.entries)
                assert plan.cluster == 1
                continue
            assert plan.kind == "wide" and ttt.slab_entries(r, k) == 0
            c = plan.cluster
            rows = ttt.wide_rows(r, c)
            assert c in (1, 2, 4, 8) and rows * (c - 1) < r, (r, k, plan)
            fits_two = [n for n in (1, 2, 4, 8) if ttt.wide_rows(r, n) * (n - 1) < r
                        and 2 * (ttt.wide_smem_bytes(r, k, n) + ttt.BLOCK_RESERVED_SMEM)
                        <= ttt.SM_SMEM_BYTES]
            assert c == (fits_two[0] if fits_two else 8), (r, k, plan)
            assert plan.smem_bytes == ttt.wide_smem_bytes(r, k, c)
            assert plan.threads == ttt.BWD_WIDE_THREADS >= r and plan.threads % 32 == 0
            assert plan.stride % 4 == 0 and plan.stride >= rows * r + 3
            per_sm = ttt.wide_blocks_per_sm(plan.smem_bytes)
            assert per_sm >= 1 and plan.entries == 1 and plan.blocks % c == 0
            assert plan.blocks == c * min(8192, per_sm * ttt.H100_SMS // c)


@pytest.mark.parametrize("b,k,r,kind,entries,threads,blocks", [
    (8192, 8, 10, "slab", 16, 160, 264), (8192, 8, 6, "slab", 32, 192, 256),
    (1001, 3, 5, "slab", 4, 32, 251), (1001, 8, 10, "slab", 4, 64, 251),
    (4096, 8, 34, "slab", 1, 64, 396), (517, 5, 57, "wide", 1, 256, 396),
    (256, 4, 128, "wide", 1, 256, 396), (16384, 8, 43, "wide", 1, 256, 396),
    (16384, 8, 57, "wide", 1, 256, 264), (8192, 8, 128, "wide", 1, 256, 392),
])
def test_tt_bwd_plan_by_shape(b, k, r, kind, entries, threads, blocks):
    """The plan at chip_smoke's backward shapes.  The MEDIUM fit shape (B
    8192, K 8, R 10) takes the slab plan with 16 entries a slab in 160
    threads, five whole warps (no thread idles), and two persistent blocks
    on each of the H100's 132 SMs; a small B takes smaller slabs, at most B
    / 264 entries, so that its blocks still number two a SM (R 6 at B 8192,
    B 1001).  The first rank past the slab plan at K 8 (43), the 4 MB fit's
    (57) and (517, 5, 57) take the wide plan in clusters of one block (an
    entry's cores in 64,144 and 110,056 bytes at K 8: three and two blocks
    a SM); R 128 in clusters of 4 (K 4) and 8 (K 8), three blocks a SM."""
    from repro_torch.kernels import tt_contract as ttt

    plan = ttt.bwd_plan(r, k, b)
    assert (plan.kind, plan.entries, plan.threads, plan.blocks) == (
        kind, entries, threads, blocks)
    assert plan.cluster == {(4, 128): 4, (8, 128): 8}.get((k, r), 1)
    if kind == "slab":
        per_sm = ttt.SM_SMEM_BYTES // (plan.smem_bytes + ttt.BLOCK_RESERVED_SMEM)
        assert per_sm >= 2 and plan.blocks == min(-(-b // entries), per_sm * ttt.H100_SMS)
    else:
        per_sm = ttt.wide_blocks_per_sm(plan.smem_bytes)
        assert per_sm == (2 if (k, r) == (8, 57) else 3)
        assert plan.blocks == per_sm * ttt.H100_SMS // plan.cluster * plan.cluster


def _tt_bwd_wide_as_kernel(first, mid, last, dout, plan):
    """The tt_contract backward in the wide plan's order of work
    (csrc/tt_contract_bwd.cu: tt_contract_bwd_wide_cluster_kernel) for
    every entry at once: block c of a cluster holds rows [c S, c S + S) of
    every core.  Prefix: thread (p, j) of block c sums column j of its rows
    p, p + P, ... against its rows of v_k and puts the partial in slot c P
    + p of the block owning row j; each block adds its slots in order.
    Suffix: lane q of a row's group of L lanes sums the row's columns q + L
    i, i from the row's rotated start, the lanes' sums then added; each
    block writes dmid_k's rows g v_k (x) u_{k+1}, dfirst's and dlast's."""
    from repro_torch.kernels import tt_contract as ttt

    b, k_steps, r, _ = mid.shape
    nc, nt = plan.cluster, plan.threads
    rows, parts = ttt.wide_rows(r, nc), nt // r
    spans = [(c * rows, min(rows, r - c * rows)) for c in range(nc)]
    g = dout[:, None]
    vs = [[first[:, r0:r0 + nr]] for r0, nr in spans]
    for k in range(k_steps):
        slots = torch.zeros(b, nc, nc * parts, rows)
        for c, (r0, nr) in enumerate(spans):
            m = mid[:, k, r0:r0 + nr]
            for p in range(parts):
                part = torch.zeros(b, r)
                for row in range(p, nr, parts):
                    part = part + vs[c][k][:, row:row + 1] * m[:, row]
                for j in range(r):
                    slots[:, j // rows, c * parts + p, j % rows] = part[:, j]
        for c, (r0, nr) in enumerate(spans):
            total = torch.zeros(b, nr)
            for i in range(nc * parts):
                total = total + slots[:, c, i, :nr]
            vs[c].append(total)
    dmid = torch.empty_like(mid)
    dfirst, dlast = torch.empty_like(first), torch.empty_like(last)
    for c, (r0, nr) in enumerate(spans):
        dlast[:, r0:r0 + nr] = g * vs[c][k_steps]
    u = last
    for k in reversed(range(k_steps)):
        u_k = torch.empty_like(u)
        for c, (r0, nr) in enumerate(spans):
            lanes = 32
            while lanes > 1 and nr * lanes > nt:
                lanes //= 2
            n_spans = -(-r // lanes)
            for row in range(nr):
                total = torch.zeros(b)
                for q in range(lanes):
                    acc = torch.zeros(b)
                    for i in range(n_spans):
                        j = q + lanes * ((i + row % n_spans) % n_spans)
                        if j < r:
                            acc = acc + mid[:, k, r0 + row, j] * u[:, j]
                    total = total + acc
                u_k[:, r0 + row] = total
            dmid[:, k, r0:r0 + nr] = (g * vs[c][k])[:, :, None] * u[:, None, :]
        u = u_k
    dfirst[:] = g * u
    return dfirst, dmid, dlast


@pytest.mark.parametrize("b,k,r,cluster", [(3, 5, 57, 1), (2, 4, 128, 4), (2, 8, 128, 8),
                                           (3, 2, 128, 2), (2, 16, 30, 1), (2, 8, 60, 2)])
def test_tt_bwd_wide_sums_match_jax_grad(b, k, r, cluster):
    """The wide plan's partial sums, slots and rotated columns, in clusters
    of 1, 2, 4 and 8 blocks, against jax.grad."""
    from repro_torch.kernels import tt_contract as ttt

    plan = ttt.bwd_plan(r, k, 8192)
    assert (plan.kind, plan.cluster) == ("wide", cluster)
    arrs = _tt_bwd_case(b, k, r, seed=r + k)
    tf, tm, tl, td = (torch.from_numpy(a) for a in arrs)
    _close_all(_tt_bwd_wide_as_kernel(tf, tm, tl, td, plan), _jax_tt_grads(*arrs))


@pytest.mark.parametrize("b,k,r,base", [
    (517, 5, 57, 0), (517, 5, 57, 3), (256, 4, 128, 0), (256, 4, 128, 1),
    (16384, 8, 43, 2), (16384, 8, 57, 1), (8192, 8, 128, 0), (999, 2, 128, 3),
    (300, 16, 128, 1), (777, 16, 30, 2),
])
def test_tt_bwd_wide_reads_each_float_once(b, k, r, base):
    """The wide plan's copies of mid and stores of dmid with mid ``base``
    floats off the 16-byte grid: the blocks of a cluster split every core's
    rows, each row in one block; each (entry, core, block) chunk's bulk
    interior is 16-byte aligned in device memory and in its slot, a whole
    number of 16 bytes, its head and tail at most 3 + 3 plain floats, the
    chunk within its slot, so the chunks cover every float of every entry
    once; a thread's stores of dmid walk (row, column) by increments, each
    float of a chunk once; and the persistent clusters, cluster q taking
    entries q, q + clusters, ..., walk every entry once."""
    from repro_torch.kernels import tt_contract as ttt

    plan = ttt.bwd_plan(r, k, b)
    assert plan.kind == "wide"
    nc, nt, slot = plan.cluster, plan.threads, plan.stride
    rows = ttt.wide_rows(r, nc)
    spans = [(c * rows, min(rows, r - c * rows)) for c in range(nc)]
    assert sorted(row for r0, nr in spans for row in range(r0, r0 + nr)) == list(range(r))
    clusters = plan.blocks // nc
    walked = np.sort(np.concatenate([np.arange(q, b, clusters) for q in range(clusters)]))
    assert np.array_equal(walked, np.arange(b))
    per = k * r * r
    covered = np.zeros(per, np.int64)
    for r0, nr in spans:
        count = nr * r
        start = (base + np.arange(b)[:, None] * per + np.arange(k)[None, :] * r * r
                 + r0 * r).ravel()
        shift = start % 4
        head = np.minimum((4 - shift) % 4, count)
        chunks = (count - head) // 4
        head = np.where(chunks > 0, head, count)
        bulk = 4 * chunks
        tail = count - head - bulk
        assert (tail >= 0).all() and ((bulk == 0) | ((head <= 3) & (tail <= 3))).all()
        assert ((start + head) % 4 == 0)[bulk > 0].all() and (bulk % 4 == 0).all()
        slots = np.arange(b * k) % k * slot + shift
        assert ((slots + head) % 4 == 0)[bulk > 0].all()
        assert (shift + count <= slot).all()
        for kk in range(k):
            covered[kk * r * r + r0 * r:kk * r * r + (r0 + nr) * r] += 1
    assert (covered == 1).all()
    for r0, nr in spans:
        count, seen = nr * r, np.zeros(nr * r, np.int64)
        dr, dj = divmod(nt, r)
        for tid in range(nt):
            row, col = divmod(tid, r)
            for f in range(tid, count, nt):
                assert (row, col) == divmod(f, r)
                seen[f] += 1
                row, col = row + dr, col + dj
                if col >= r:
                    row, col = row + 1, col - r
        assert (seen == 1).all()


def test_tt_bwd_slab_stride_spreads_banks():
    """At the fit shape K R^2 = 800 floats, a multiple of 32: slots of 804
    floats would already spread the entries; the chosen stride's conflicts
    (``bank_ways``) are the fewest of the eight candidates, and fewer than
    an unpadded 800-float stride's."""
    from repro_torch.kernels import tt_contract as ttt

    stride = ttt.slab_stride(10, 8, 16)
    ways = {s: ttt.bank_ways(s, 10, 16) for s in range(804, 836, 4)}
    assert ttt.bank_ways(stride, 10, 16) == min(ways.values())
    assert ttt.bank_ways(stride, 10, 16) < ttt.bank_ways(800, 10, 16)


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


@pytest.mark.parametrize("hid,kind,tile", [(5, "narrow", 48), (12, "narrow", 20),
                                           (18, "narrow", 12), (45, "narrow", 4),
                                           (46, "mid", 64), (68, "mid", 32), (71, "mid", 24),
                                           (72, "wide", 8), (256, "wide", 8)])
def test_lstm_bwd_tile(hid, kind, tile):
    """Sequences a backward block owns at B 8192: narrow (H <= 45), groups
    of 4 sequences, about 64 thread tiles a block; mid (H <= 71), groups of
    8 sized to the batch; wide, one group of 8.  The block fits its shared
    memory and its plan's thread limit."""
    from repro_torch.kernels import lstm as tlstm
    from repro_torch.kernels._common import MAX_SMEM_BYTES

    assert tlstm.bwd_kind(hid) == kind and tlstm.bwd_tile(hid) == tile
    plan = tlstm.bwd_plan(hid)
    assert plan.tile == tile and plan.smem_bytes <= MAX_SMEM_BYTES
    seqs, most = tlstm.BWD_SEQS[kind], tlstm.BWD_THREADS[kind]
    assert plan.threads % 32 == 0 and tile // seqs * hid <= plan.threads <= most


@pytest.mark.parametrize("hid,bsz,blocks", [(68, 4096, 128), (68, 8192, 256), (68, 1000, 125),
                                            (46, 8192, 128), (46, 100_000, 1563)])
def test_lstm_bwd_mid_tile_fills_waves(hid, bsz, blocks):
    """The mid plan runs one block a SM, so its tile makes the blocks fill
    whole waves of the H100's 132 SMs as closely as the largest tile
    allows."""
    from repro_torch.kernels import lstm as tlstm

    plan = tlstm.bwd_plan(hid, bsz)
    assert plan.kind == "mid" and plan.blocks(bsz) == blocks


def _bwd_weight_bytes(hid):
    """Bytes of [wi; wh] unit-major."""
    from repro_torch.kernels import lstm as tlstm

    return 2 * hid * tlstm.bwd_row_stride(hid) * 4


@pytest.mark.parametrize("t_steps", [1, 10, 96, 1000])
def test_lstm_bwd_plan_fits_shared_memory(t_steps):
    """Every H from 1 to 256, at batches from 1 to 2^20: the block fits
    232,448 bytes as ``lstm_bwd_smem_floats`` counts it, whatever T, within
    its plan's thread limit; what a thread keeps of every step goes to the
    scratch."""
    from repro_torch.kernels import lstm as tlstm
    from repro_torch.kernels._common import MAX_SMEM_BYTES

    for hid in range(1, tlstm.MAX_BWD_HIDDEN + 1):
        for bsz in (1, 1000, 8192, 1 << 20):
            p = tlstm.bwd_plan(hid, bsz)
            floats = 8 * hid * p.tile + (p.kind != "wide") * _bwd_weight_bytes(hid) // 4
            assert p.smem_bytes == 4 * floats <= MAX_SMEM_BYTES, (hid, bsz, p)
            assert p.kind == ("narrow" if hid <= 45 else "mid" if hid <= 71 else "wide")
            assert p.tile % tlstm.BWD_SEQS[p.kind] == 0
            assert p.threads <= tlstm.BWD_THREADS[p.kind]
            assert p.scratch_floats(bsz, t_steps) == (
                p.blocks(bsz) * t_steps * p.threads * tlstm.BWD_KEPT[p.kind])


@pytest.mark.parametrize("bsz,t_steps,rows", [(8192, 10, 81920), (1024, 5, 5120), (1, 1, 256),
                                              (33, 8, 512), (0, 10, 0)])
def test_lstm_bwd_rows(bsz, t_steps, rows):
    """A and G hold B T rows rounded up to whole chunks of 256."""
    from repro_torch.kernels import lstm as tlstm

    assert tlstm.bwd_rows(bsz, t_steps) == rows


@pytest.mark.parametrize("hid", [5, 46, 72])
def test_lstm_bwd_weights_unit_major(hid):
    """The unit-major copy a wide plan reads: gate g of unit u of row k
    (k < H: wi, else wh) at [k, 4 u + g], rows of 4 (H | 1) floats."""
    from repro_torch.kernels import lstm as tlstm

    gen = torch.Generator().manual_seed(hid)
    wi, wh = torch.randn((hid, 4 * hid), generator=gen), torch.randn((hid, 4 * hid), generator=gen)
    got = tlstm.bwd_weights(wi, wh)
    assert got.shape == (2 * hid, tlstm.bwd_row_stride(hid))
    want = torch.cat([wi, wh]).view(2 * hid, 4, hid).transpose(1, 2).reshape(2 * hid, 4 * hid)
    assert torch.equal(got[:, :4 * hid], want)


def test_lstm_bwd_plan_occupancy_at_fit_shape():
    """The paper's MEDIUM fit (B 8192, T 10, H 18): at least two blocks on
    each of the H100's 132 SMs, by the grid and by a SM's shared memory
    (228 KB, 1 KB reserved a block) and threads (2048); c of every step
    goes to a scratch of 7 MB, which stays in the 50 MB L2."""
    from repro_torch.kernels import lstm as tlstm

    p = tlstm.bwd_plan(18)
    assert p.kind == "narrow"
    assert p.blocks(8192) >= 2 * 132
    assert 233_472 // (p.smem_bytes + 1024) >= 2 and 2048 // p.threads >= 2
    assert 4 * p.scratch_floats(8192, 10) < 8 << 20


@pytest.mark.parametrize("hid,t_steps", [(18, 95), (18, 96), (12, 100), (12, 101), (68, 1),
                                          (256, 5)])
def test_lstm_bwd_plan_c_scratch(hid, t_steps):
    """c of every step sits in the scratch at every T: it holds c of 4
    sequences a thread and step of every block (c and the four gates of 8
    sequences in the mid and wide plans)."""
    from repro_torch.kernels import lstm as tlstm

    p = tlstm.bwd_plan(hid, 1000)
    kept = 4 if p.kind == "narrow" else 40
    assert p.scratch_floats(1000, t_steps) == p.blocks(1000) * t_steps * kept * p.threads
