"""The port's attention (``repro_torch.kernels``) against the JAX package, on
the CPU.

Inputs are made by numpy from a seed and handed to both packages.  The
grids are those of ``tests/test_kernels.py``.  Tolerances: 2e-5 in f32
(rtol = atol, the reference's own for its flash kernel against its
oracle); in bf16 at most 2 bf16 ulps of the case's largest |value|, since
both sides compute in f32 and round once.

On the CPU the flash wrapper runs its plain version, so
``ops.attention(impl="cuda")`` here checks the padding, the ``kv_valid``
mask and the kernel's exact function (``-1e30`` sentinel, softmax over the
padded grid) against ``impl="pallas_interpret"``.  The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattention
from repro_torch.kernels._common import MAX_SMEM_BYTES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = 2e-5
BF16_ULPS = 2
GRID = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (2, 128, 4, 1, 128)]


def _qkv(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)), rng.normal(size=(b, skv, hkv, d)),
            rng.normal(size=(b, skv, hkv, d)))


def _pair(arrays, dtype: str):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in arrays])


def _close(got: torch.Tensor, want, dtype: str) -> None:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    else:
        top = float(np.abs(w).max())
        ulp = math.ldexp(1.0, math.frexp(top)[1] - 8)
        assert float(np.abs(g - w).max()) <= BF16_ULPS * ulp


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d", GRID)
def test_mha_attention_matches_jax(b, s, hq, hkv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(b, s, s, hq, hkv, d), dtype)
    _close(tref.mha_attention(tq, tk, tv), jref.mha_attention(jq, jk, jv), dtype)


@pytest.mark.parametrize("q_offset", [0, 128])
def test_mha_attention_offset_and_kv_len_match_jax(q_offset):
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(3, 8, 256, 4, 2, 16, seed=1), "float32")
    kv_len = np.asarray([10, 137, 256], np.int32)
    want = jref.mha_attention(jq, jk, jv, causal=True, q_offset=q_offset,
                              kv_len=jnp.asarray(kv_len))
    got = tref.mha_attention(tq, tk, tv, causal=True, q_offset=q_offset,
                             kv_len=torch.from_numpy(kv_len))
    _close(got, want, "float32")


def test_kv_len_masks_the_tail():
    """Only the first kv_len[b] positions take part (the reference's check)."""
    _, (tq, tk, tv) = _pair(_qkv(3, 1, 64, 2, 2, 16, seed=2), "float32")
    kv_len = torch.tensor([10, 32, 64], dtype=torch.int32)
    out = tref.mha_attention(tq, tk, tv, causal=False, kv_len=kv_len)
    out0 = tref.mha_attention(tq[:1], tk[:1, :10], tv[:1, :10], causal=False)
    torch.testing.assert_close(out[:1], out0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_ragged_tail_matches_jax(causal, dtype):
    """sq = 2049 = 4 * 512 + 1: the ragged tail is attended on its own."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(1, 2049, 2049, 2, 1, 32, seed=3), dtype)
    want = jref.mha_attention_chunked(jq, jk, jv, causal=causal, chunk=512)
    got = tref.mha_attention_chunked(tq, tk, tv, causal=causal, chunk=512)
    _close(got, want, dtype)
    if dtype == "float32":
        _close(got, jref.mha_attention(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_gradients_match_jax(dtype):
    """dq, dk, dv of the chunked oracle (each full chunk rematerialised, the
    ragged tail not) against ``jax.grad`` of the reference's at S 37 in
    chunks of 8: four checkpointed chunks and a tail of 5."""
    arrays = _qkv(2, 37, 37, 4, 2, 16, seed=4)
    cot = np.random.default_rng(5).normal(size=arrays[0].shape)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    jcot, tcot = _pair([cot], dtype)[0][0], _pair([cot], dtype)[1][0]
    _, vjp = jax.vjp(lambda q, k, v: jref.mha_attention_chunked(q, k, v, chunk=8), jq, jk, jv)
    want = vjp(jcot)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tref.mha_attention_chunked(*leaves, chunk=8)
    got = torch.autograd.grad(out, leaves, tcot)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_chunked_attention_keeps_one_chunk_for_the_backward():
    """S 2048 in chunks of 512: what autograd keeps between the forward and
    the backward is at most one chunk's f32 score block [B, H, 512, S]
    (16.8 MB here) beside q, k, v and the output; keeping every chunk's
    probabilities held 72.9 MB.  The forward is bitwise the one without
    autograd and the concatenation of the chunks' plain oracle."""
    b, s, h, d, chunk = 1, 2048, 4, 16, 512
    q, k, v = (torch.from_numpy(a.astype(np.float32)).requires_grad_()
               for a in _qkv(b, s, s, h, h, d, seed=6))
    kept = {}

    def pack(t):
        kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tref.mha_attention_chunked(q, k, v, chunk=chunk)
    block = b * h * chunk * s * 4
    assert sum(kept.values()) <= block + 4 * q.numel() * 4
    with torch.no_grad():
        assert torch.equal(out, tref.mha_attention_chunked(q, k, v, chunk=chunk))
        assert torch.equal(out, torch.cat([tref.mha_attention(q[:, i:i + chunk], k, v,
                                                              q_offset=i)
                                           for i in range(0, s, chunk)], 1))


# ---------------------------------------------------------------------------
# the kernel route: pad, mask, the kernel's function
# ---------------------------------------------------------------------------
KERNEL_CASES = [
    # (b, sq, skv, hq, hkv, d, q_offset, causal)
    *[(b, s, s, hq, hkv, d, 0, True) for b, s, hq, hkv, d in GRID],
    (2, 128, 256, 4, 4, 64, 128, True),   # the reference's decode-offset case
    (1, 130, 130, 2, 2, 64, 0, False),    # odd lengths: the pad path
    (1, 130, 130, 2, 2, 64, 0, True),
    (1, 128, 130, 2, 2, 64, 0, True),     # ragged kv only
    (1, 200, 333, 8, 2, 8, 0, True),      # GQA, head dim 8, both padded
    (1, 128, 128, 2, 2, 64, -64, True),   # rows 0..63 fully masked
    (1, 130, 130, 2, 1, 8, -100, True),   # fully masked rows over a padded grid
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,q_offset,causal", KERNEL_CASES)
def test_kernel_route_matches_pallas_interpret(b, sq, skv, hq, hkv, d, q_offset, causal):
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(b, sq, skv, hq, hkv, d, seed=4), "float32")
    want = jops.attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                          impl="pallas_interpret")
    got = tops.attention(tq, tk, tv, causal=causal, q_offset=q_offset, impl="cuda")
    _close(got, want, "float32")


def test_kernel_route_bf16_matches_pallas_interpret():
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(1, 130, 130, 4, 2, 64, seed=5), "bfloat16")
    want = jops.attention(jq, jk, jv, impl="pallas_interpret")
    _close(tops.attention(tq, tk, tv, impl="cuda"), want, "bfloat16")


def test_fully_masked_rows_are_the_mean_of_v_over_the_padded_grid():
    """The -1e30 sentinel turns a fully masked row into a uniform softmax:
    the row is the mean of v over every (padded) kv column, not 0."""
    _, (tq, tk, tv) = _pair(_qkv(1, 130, 130, 2, 2, 8, seed=6), "float32")
    out = tops.attention(tq, tk, tv, causal=True, q_offset=-100, impl="cuda")
    padded_mean = tv.sum(1) / 256  # 130 real columns padded to 256 with zeros
    for row in range(100):
        torch.testing.assert_close(out[:, row], padded_mean, rtol=1e-5, atol=1e-6)
    # row 100 sees exactly column 0
    torch.testing.assert_close(out[:, 100], tv[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["cuda", "auto", "fused"])
def test_kernel_impls_pad_to_the_tile_and_call_the_wrapper(monkeypatch, impl):
    seen = []
    real = tattention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattention, "flash_attention", spy)
    _, (tq, tk, tv) = _pair(_qkv(1, 2100, 2100, 2, 2, 8, seed=7), "float32")
    out = tops.attention(tq, tk, tv, impl=impl)
    assert out.shape == tq.shape
    assert seen == [((1, 2176, 2, 8), (1, 2176, 2, 8),
                     {"causal": True, "q_offset": 0, "kv_valid": 2100})]
    # an aligned length is not padded and masks nothing
    _, (aq, ak, av) = _pair(_qkv(1, 128, 128, 2, 2, 8, seed=8), "float32")
    tops.attention(aq, ak, av, impl=impl)
    assert seen[-1][2]["kv_valid"] is None


def test_oracle_routes(monkeypatch):
    """ref/chunked and kv_len go to the oracles, chunked from Sq >= 2048;
    none of them reaches the kernel's wrapper."""
    def boom(*a, **kw):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(tattention, "flash_attention", boom)
    _, (tq, tk, tv) = _pair(_qkv(1, 2048, 2048, 2, 1, 8, seed=9), "float32")
    long_ref = tops.attention(tq, tk, tv, impl="ref")
    torch.testing.assert_close(long_ref, tref.mha_attention_chunked(tq, tk, tv),
                               rtol=0, atol=0)
    short = tops.attention(tq[:, :64], tk[:, :64], tv[:, :64], impl="chunked")
    torch.testing.assert_close(short, tref.mha_attention(tq[:, :64], tk[:, :64], tv[:, :64]))
    kv_len = torch.tensor([100], dtype=torch.int32)
    dec = tops.attention(tq[:, :1], tk, tv, causal=False, kv_len=kv_len, impl="cuda")
    torch.testing.assert_close(
        dec, tref.mha_attention(tq[:, :1], tk, tv, causal=False, kv_len=kv_len),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.attention(tq, tk, tv, impl="pallas")


def test_wrapper_rejects_untiled_lengths():
    _, (tq, tk, tv) = _pair(_qkv(1, 130, 130, 2, 2, 8, seed=10), "float32")
    with pytest.raises(ValueError, match="not multiples of tiles"):
        tattention.flash_attention(tq, tk, tv)


def test_wrapper_rejects_empty_kv():
    """No kv position leaves the kernels' tile loops nothing to start from:
    the wrapper refuses the call on either device."""
    q = torch.zeros((1, 128, 2, 8))
    kv = torch.zeros((1, 0, 2, 8))
    with pytest.raises(ValueError, match="no kv positions"):
        tattention.flash_attention(q, kv, kv)


def test_flash_body_selection_and_cpu_route():
    """bf16 at the LMs' head widths runs the bf16 tensor-core body, f32 and
    D = 8 the split-TF32 one; a CPU tensor runs the plain version and
    counts no launch."""
    for d in (64, 128):
        assert tattention.flash_body(torch.bfloat16, d) == "wgmma"
    for d in (8, 64, 128):
        assert tattention.flash_body(torch.float32, d) == "tf32x3"
    assert tattention.flash_body(torch.bfloat16, 8) == "tf32x3"
    _, (tq, tk, tv) = _pair(_qkv(1, 128, 128, 2, 1, 64, seed=11), "bfloat16")
    tattention.tf32x3_launches = 1
    tops.reset_launch_counts()
    assert tattention.tf32x3_launches == 0
    got = tattention.flash_attention(tq, tk, tv, causal=True)
    assert tops.launch_counts()["flash_attention"] == 0
    assert tattention.tf32x3_launches == 0
    torch.testing.assert_close(got, tref.flash_attention(tq, tk, tv, causal=True),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the tf32x3 body's arithmetic: a plain-torch replica of its order of work
# ---------------------------------------------------------------------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 product reads of an f32: its 13 low mantissa bits
    cleared (0xffffe000 as an int32 is -8192)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """The body's hi part: x rounded to the nearest TF32 value, ties away
    from zero (``cvt.rna.tf32.f32``): half a TF32 ulp added to the
    magnitude's bits, then the 13 low bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, products: int, pieces: int = 1) -> torch.Tensor:
    """a @ b as the body's tensor cores take it: three TF32 products of
    the split operands, hi = _tf32_hi(x) and lo = x - hi (itself read as
    TF32), hi.hi in ``pieces`` sums over equal slices of the reduction
    axis, added in order, then the corrections lo.hi + hi.lo summed apart,
    in f32; products=1: the single-TF32 control, _tf32(a) @ _tf32(b)."""
    if products == 1:
        return _tf32(a) @ _tf32(b)
    a_hi, b_hi = _tf32_hi(a), _tf32_hi(b)
    width = a.shape[-1] // pieces
    hi = a_hi[..., :width] @ b_hi[..., :width, :]
    for n in range(1, pieces):
        hi = hi + a_hi[..., n * width:(n + 1) * width] @ b_hi[..., n * width:(n + 1) * width, :]
    return hi + (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi))


def _kv_tiles(q0, tile_q, tile_kv, skv, kv_valid, causal, q_offset):
    """``kv_tiles`` of ``csrc/flash_attention.cu``: the kv tiles a q tile
    walks."""
    if kv_valid <= 0 or (causal and q0 + q_offset < 0):
        return skv // tile_kv
    limit = min(kv_valid, q0 + tile_q + q_offset) if causal else kv_valid
    return min(skv, -(-limit // tile_kv) * tile_kv) // tile_kv


def _flash_tf32x3_as_kernel(q, k, v, *, causal=True, q_offset=0, kv_valid=None, products=3):
    """The tf32x3 body's function in its order of work, on the padded q
    [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] that the wrapper receives:
    per 64-row q tile the kv tiles of ``tf32x3_plan(D)`` that ``_kv_tiles``
    walks; s = q k^T through ``_product`` on the unscaled inputs, hi.hi in
    the plan's ``s_pieces``, times log2(e)/sqrt(D) in f32, masked to
    -1e30; the online (m, l) in base 2; each tile's p v through
    ``_product`` into a sum of its own, which joins acc once the next
    tile's max is known, acc = (acc + pv) alpha; out = (acc + the last
    tile's pv) / l (l == 0 -> 1)."""
    bsz, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    plan = tattention.tf32x3_plan(d)
    tq, tk = plan.tile_q, plan.tile_kv
    valid = skv if kv_valid is None else kv_valid
    scale_log2 = (torch.tensor(1.0 / d**0.5, dtype=torch.float32)
                  * torch.tensor(1.4426950408889634, dtype=torch.float32))
    qh = q.float().permute(0, 2, 1, 3)                          # [B, Hq, Sq, D]
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
    out = torch.empty_like(qh)
    for q0 in range(0, sq, tq):
        qt = qh[:, :, q0:q0 + tq]
        qpos = torch.arange(q0, q0 + tq)[:, None]
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros_like(qt)
        pv = None
        for j in range(_kv_tiles(q0, tq, tk, skv, valid, causal, q_offset)):
            k0 = j * tk
            kpos = torch.arange(k0, k0 + tk)[None, :]
            keep = kpos < valid
            if causal:
                keep = keep & (qpos + q_offset >= kpos)
            s = _product(qt, kh[:, :, k0:k0 + tk].transpose(-1, -2), products,
                         plan.s_pieces) * scale_log2
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_next = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_next)
            p = torch.exp2(s - m_next[..., None])
            l = alpha * l + p.sum(-1)
            if pv is not None:
                acc = (acc + pv) * alpha[..., None]
            pv = _product(p, vh[:, :, k0:k0 + tk], products)
            m = m_next
        out[:, :, q0:q0 + tq] = (acc + pv) / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _replica_route(monkeypatch, products: int) -> None:
    """Route ``ops.attention``'s kernel call through the replica, so it
    runs behind the port's own padding."""
    def replica(q, k, v, **kw):
        return _flash_tf32x3_as_kernel(q, k, v, products=products, **kw)

    monkeypatch.setattr(tattention, "flash_attention", replica)


def _within_1e5(got: torch.Tensor, want) -> bool:
    """``chip_smoke.py``'s f32 check of the kernel: every element within
    1e-5 + 1e-5 |want|."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return bool(np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w)))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,q_offset,causal", KERNEL_CASES)
def test_flash_tf32x3_replica_matches_pallas_interpret(monkeypatch, b, sq, skv, hq, hkv, d,
                                                       q_offset, causal):
    """Three TF32 products a product, in the body's tiles and order, hold
    the f32 tolerance against the reference's kernel, and 1e-5 as the
    card's check does."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(b, sq, skv, hq, hkv, d, seed=4), "float32")
    want = jops.attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                          impl="pallas_interpret")
    _replica_route(monkeypatch, 3)
    got = tops.attention(tq, tk, tv, causal=causal, q_offset=q_offset, impl="cuda")
    _close(got, want, "float32")
    assert _within_1e5(got, want)


def test_flash_single_tf32_replica_misses_the_tolerance(monkeypatch):
    """The control: one TF32 product of the truncated values errs beyond
    1e-5 where the split replica stays within it, so the tolerance sees
    single-TF32 rounding."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv(2, 128, 128, 4, 1, 128, seed=4), "float32")
    want = jops.attention(jq, jk, jv, causal=True, impl="pallas_interpret")
    errs = {}
    for products in (1, 3):
        _replica_route(monkeypatch, products)
        got = tops.attention(tq, tk, tv, causal=True, impl="cuda")
        errs[products] = (float(np.abs(got.numpy() - np.asarray(want)).max()),
                          _within_1e5(got, want))
    assert errs[3][1] and not errs[1][1], errs
    assert errs[1][0] > 100 * errs[3][0], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", tattention.HEAD_DIMS)
def test_flash_tf32x3_plan_fits_shared_memory(dtype, d):
    """Where the tf32x3 body runs, its plan fits a Hopper block: q_hi and
    q_lo, at least two ring slots of k_hi, k_lo, vt_hi and vt_lo with
    their four mbarriers, O's running sum where it is shared, and the
    alignment slack, within 232,448 bytes, with no room for one more slot
    below four; its tiles divide the wrapper's 128-row padding, and S's
    pieces are whole 32-column slabs of D."""
    if tattention.flash_body(dtype, d) != "tf32x3":
        assert dtype == torch.bfloat16 and d in tattention.WGMMA_HEAD_DIMS
        return
    plan = tattention.tf32x3_plan(d)
    slabs = -(-d // 32)
    q_bytes = 2 * plan.tile_q * 128 * slabs
    slot = 2 * plan.tile_kv * 128 * slabs + 2 * d * 128 * (plan.tile_kv // 32)
    o_bytes = plan.tile_q * d * 4 if plan.o_shared else 0
    assert plan.smem_bytes == q_bytes + plan.stages * (slot + 32) + o_bytes + 1024
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.smem_bytes + slot + 32 > MAX_SMEM_BYTES or plan.stages == 4
    assert 2 <= plan.stages <= 4 and plan.threads == 256
    assert tattention.TILE_Q % plan.tile_q == 0 and tattention.TILE_KV % plan.tile_kv == 0
    assert plan.tile_kv % 32 == 0 and plan.tile_kv * d // 4 % 128 == 0
    assert d % plan.s_pieces == 0 and (plan.s_pieces == 1 or d // plan.s_pieces == 32)
    assert ({8: (64, 4, 1, False), 64: (64, 3, 2, False), 128: (32, 2, 4, True)}[d]
            == (plan.tile_kv, plan.stages, plan.s_pieces, plan.o_shared))


def test_flash_build_flags_carry_the_tf32x3_plans():
    """The kernel is compiled with ``tf32x3_plan`` itself: ``_build``'s
    defines name every head width and, per width, each field of its plan,
    the shared bytes that the kernel's layout must reproduce included."""
    flags = dict(f[2:].split("=") for f in _build.flash_flags())
    assert flags.pop("REPRO_TF32X3_HEAD_DIMS") == "".join(
        f"X({d})" for d in tattention.HEAD_DIMS)
    want = {}
    for d in tattention.HEAD_DIMS:
        plan = tattention.tf32x3_plan(d)
        want.update({f"REPRO_TF32X3_TK_{d}": str(plan.tile_kv),
                     f"REPRO_TF32X3_STAGES_{d}": str(plan.stages),
                     f"REPRO_TF32X3_S_PIECES_{d}": str(plan.s_pieces),
                     f"REPRO_TF32X3_O_SHARED_{d}": str(int(plan.o_shared)),
                     f"REPRO_TF32X3_SMEM_{d}": str(plan.smem_bytes)})
    assert flags == want
    assert all("," not in f for f in _build.flash_flags())  # nvcc splits a define at commas
    assert ("flash_attention.cu", "flash_attention.cu", _build.flash_flags()) in _build.units()
