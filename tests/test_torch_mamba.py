"""The port's Mamba2 block (``repro_torch.models.mamba``) against the JAX
package, on the CPU.

Weights are drawn by the reference's ``mamba_specs`` and carried over as
numpy; the decay (``a_log``), ``dt_bias`` and ``conv_b`` are redrawn from a
numpy seed so that none is at its zeros/ones init.  Tolerances: 1e-5 in
f32 (rtol = atol, the repo's f32 tolerance); gradients to atol 1e-5 +
rtol 1e-4 of the leaf's largest value; bf16 outputs to 2 bf16 ulps of the
largest value.  Sequence lengths cover one chunk, two, a padded tail (24,
40 at chunk 16) and a single short chunk (13), at 1 and 2 groups (a group
repeated in place over its heads).  Short prompts (1 and 2 tokens, below
the conv's k-1 = 3) are held against the reference's teacher-forced
``forward`` on the extended sequence, never against its decode (ROADMAP
C.8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jsharding
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.models import mamba
from repro_torch.models import model as tmodel

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ARCH = "mamba2-1.3b"
GROUPS = [1, 2]
SEQS = [13, 16, 24, 40]


def _cfgs(groups: int, dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), ssm_groups=groups,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), ssm_groups=groups, compute_dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, seed: int = 0) -> dict:
    """One block's weights as numpy, from the reference's specs."""
    p = jsharding.materialize(jax.random.PRNGKey(seed), jmamba.mamba_specs(jcfg), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.default_rng(seed + 100)
    p["a_log"] = (rng.normal(size=p["a_log"].shape) * 0.5).astype(np.float32)
    p["dt_bias"] = (rng.normal(size=p["dt_bias"].shape) * 0.5).astype(np.float32)
    p["conv_b"] = (rng.normal(size=p["conv_b"].shape) * 0.1).astype(np.float32)
    return p


def _x(jcfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model)).astype(np.float32)


def _jax(p: dict, dtype=jnp.float32) -> dict:
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _torch(p: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _random_state(tcfg, b: int, seed: int) -> dict:
    d = mamba.dims(tcfg)
    rng = np.random.default_rng(seed)
    return {
        "conv": rng.normal(size=(b, tcfg.ssm_conv - 1, d["conv_dim"])).astype(np.float32),
        "ssm": rng.normal(size=(b, d["n_heads"], tcfg.ssm_head_dim,
                                tcfg.ssm_state)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# the block against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("seq", SEQS)
def test_mamba_forward_matches_jax(seq, groups):
    jcfg, tcfg = _cfgs(groups)
    p, x = _params(jcfg), _x(jcfg, 2, seq)
    want, _ = jmamba.mamba_forward(_jax(p), jnp.asarray(x), jcfg)
    got, _ = mamba.mamba_forward(_torch(p), torch.from_numpy(x), tcfg)
    assert got.shape == (2, seq, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("seq", SEQS)
def test_mamba_prefill_state_matches_jax(seq, groups):
    """The state a prompt leaves: the pre-conv tail and the f32 SSM state,
    exact through a padded last chunk (dt = 0 on the padding)."""
    jcfg, tcfg = _cfgs(groups)
    p, x = _params(jcfg), _x(jcfg, 2, seq, seed=2)
    _, want = jmamba.mamba_forward(_jax(p), jnp.asarray(x), jcfg)
    _, got = mamba.mamba_forward(_torch(p), torch.from_numpy(x), tcfg)
    assert got["ssm"].dtype == torch.float32
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        _close(got[name], want[name])


@pytest.mark.parametrize("groups", GROUPS)
def test_mamba_decode_step_matches_jax(groups):
    jcfg, tcfg = _cfgs(groups)
    p, x = _params(jcfg, seed=3), _x(jcfg, 2, 1, seed=3)
    state = _random_state(tcfg, 2, seed=4)
    want_y, want = jmamba.mamba_forward(_jax(p), jnp.asarray(x), jcfg, _jax(state))
    got_y, got = mamba.mamba_forward(_torch(p), torch.from_numpy(x), tcfg, _torch(state))
    _close(got_y, want_y)
    for name in ("conv", "ssm"):
        _close(got[name], want[name])


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("groups", GROUPS)
def test_mamba_gradients_match_jax(groups, steep):
    """Through the padded chunks: each gradient matches ``jax.grad``.  With
    a steep decay (a ~ -20) the masked-out exponents of a chunk pass f32's
    range: the mask inside the exp keeps every gradient finite."""
    jcfg, tcfg = _cfgs(groups)
    p, x = _params(jcfg, seed=5), _x(jcfg, 2, 24, seed=5)
    if steep:
        p["a_log"] = p["a_log"] + np.float32(3.0)
    wgt = np.random.default_rng(6).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(params, xin):
        y, st = jmamba.mamba_forward(params, xin, jcfg)
        return jnp.sum(y * wgt) + jnp.sum(st["ssm"] ** 2) * 1e-2

    want = jax.grad(jloss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, st = mamba.mamba_forward(tp, tx, tcfg)
    (torch.sum(y * torch.from_numpy(wgt)) + torch.sum(st["ssm"] ** 2) * 1e-2).backward()
    for name, g in [*((k, v.grad) for k, v in tp.items()), ("x", tx.grad)]:
        w = np.asarray(want[0][name] if name != "x" else want[1])
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()),
                                   err_msg=name)


def test_mamba_bf16_keeps_the_reference_cast_points():
    """bf16 compute: the f32 state and inter-chunk products, the intra-chunk
    weights cast to bf16, as the reference casts them."""
    jcfg, tcfg = _cfgs(2, "bfloat16")
    p, x = _params(jcfg, seed=7), _x(jcfg, 2, 40, seed=7)
    want_y, want = jmamba.mamba_forward(_jax(p), jnp.asarray(x, jnp.bfloat16), jcfg)
    got_y, got = mamba.mamba_forward(_torch(p), torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got_y.dtype == torch.bfloat16 and got["conv"].dtype == torch.bfloat16
    assert got["ssm"].dtype == torch.float32
    for g, w in ((got_y, want_y), (got["ssm"], want["ssm"])):
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=2 * ulp)


# ---------------------------------------------------------------------------
# the port's own forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("seq", [13, 24])
def test_chunked_matches_recurrent(seq, groups):
    """The chunked SSD over a sequence equals the exact recurrence run one
    token at a time from the zero state (outputs and final state)."""
    _, tcfg = _cfgs(groups)
    p = _torch(_params(_cfgs(groups)[0], seed=8))
    x = torch.from_numpy(_x(tcfg, 2, seq, seed=8))
    want_y, want = mamba.mamba_forward(p, x, tcfg)
    d = mamba.dims(tcfg)
    state = {"conv": torch.zeros(2, tcfg.ssm_conv - 1, d["conv_dim"]),
             "ssm": torch.zeros(2, d["n_heads"], tcfg.ssm_head_dim, tcfg.ssm_state)}
    ys = []
    for t in range(seq):
        y, state = mamba.mamba_forward(p, x[:, t : t + 1], tcfg, state)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), want_y, rtol=TOL, atol=TOL)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(state[name], want[name], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prompt_len", [1, 2, 3])
def test_short_prompt_decode_matches_teacher_forcing(prompt_len):
    """ROADMAP C.8: a prompt shorter than the conv's k-1 leaves a
    zero-padded conv state, so prefill plus one decode step equals the
    reference's teacher-forced forward on the S+1 tokens."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(9)
    for name in ("a_log", "dt_bias", "conv_b"):  # off their zeros init
        leaf = jp["blocks"]["mamba"][name]
        jp["blocks"]["mamba"][name] = (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
    tp = convert.params_from_numpy(jp, "cpu")
    toks = rng.integers(0, jcfg.vocab, size=(2, prompt_len + 2))
    want, _ = jmodel.forward(jax.tree.map(jnp.asarray, jp), jcfg, tokens=jnp.asarray(toks))
    want = np.asarray(want)

    cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    logits, cache = tmodel.prefill(tp, tcfg, tokens=torch.from_numpy(toks[:, :prompt_len]),
                                   cache=cache)
    _close(logits[:, 0], want[:, prompt_len - 1])
    for step in range(2):
        pos = prompt_len + step
        logits, cache = tmodel.decode_step(tp, tcfg, token=torch.from_numpy(toks[:, pos:pos + 1]),
                                           cache=cache, cache_len=pos)
        _close(logits[:, 0], want[:, pos])


def test_prefill_overwrites_a_used_slot():
    """The state is written in place: a cache that served one prompt, then
    prefilled with another, holds exactly what a zero cache would."""
    cfg = configs.get_smoke(ARCH)
    params = tmodel.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(10)
    first, second = (torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, n))) for n in (9, 2))
    used = tmodel.init_cache(cfg, 1, 16, device="cpu")
    tmodel.prefill(params, cfg, tokens=first, cache=used)
    tmodel.decode_step(params, cfg, token=first[:, :1], cache=used, cache_len=9)
    ids = {name: leaf.data_ptr() for name, leaf in used["mamba"].items()}
    _, used = tmodel.prefill(params, cfg, tokens=second, cache=used)
    _, fresh = tmodel.prefill(params, cfg, tokens=second,
                              cache=tmodel.init_cache(cfg, 1, 16, device="cpu"))
    for name, leaf in used["mamba"].items():
        assert leaf.data_ptr() == ids[name]
        assert torch.equal(leaf, fresh["mamba"][name]), name
