"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package,
on the CPU.

Weights are drawn by the reference's ``moe_specs`` and carried over as
numpy; activations come from numpy seeds.  Outputs and the aux loss to 1e-5
in f32 (rtol = atol); gradients to atol 1e-5 + rtol 1e-4 of the leaf's
largest value; expert ids, capacities and drops bitwise against the
reference's own ``jax.lax.top_k`` and dispatch arithmetic.  Cases: a
router without drops, a skewed router that overflows the capacity at the
reference's factor 1.25, a router whose experts tie exactly (the lower
index wins, as in ``jax.lax.top_k``), and decode (S = 1, C = k), on grok's
top-2 and llama4's top-1 smoke configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jsharding
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
CASES = ["no_drops", "drops", "ties", "decode"]


def _cfgs(arch: str, **change):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **change),
            dataclasses.replace(configs.get_smoke(arch), **change))


def _case(arch: str, case: str, seed: int = 0):
    """(jcfg, tcfg, params as numpy, x [B, S, d] as numpy) of one case."""
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=8.0 if case == "no_drops" else 1.25)
    p = jsharding.materialize(jax.random.PRNGKey(seed), jmoe.moe_specs(jcfg), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.default_rng(seed + 1)
    s = 1 if case == "decode" else 24
    x = rng.normal(size=(3, s, jcfg.d_model)).astype(np.float32)
    if case == "drops":  # most tokens prefer expert 1
        p["router"][:, 1] += 0.4 * np.sign(x.mean((0, 1)))
    if case == "ties":  # every even expert equals expert 0, every odd one 1
        p["router"][:] = p["router"][:, np.arange(jcfg.moe_experts) % 2]
    return jcfg, tcfg, p, x


def _jax_dispatch(jcfg, p, x):
    """The reference's expert ids, capacity and in-capacity flags, by its
    own ops (``repro/models/moe.py:62-99``)."""
    b, s, _ = x.shape
    k = jcfg.moe_top_k
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    cap = jmoe.group_capacity(s, jcfg)
    eids = gate_idx.reshape(b, s * k)
    order = jnp.argsort(eids, axis=1, stable=True)
    eids_s = jnp.take_along_axis(eids, order, axis=1)
    counts = jnp.sum(eids[:, :, None] == jnp.arange(jcfg.moe_experts)[None, None, :], axis=1)
    seg_start = jnp.cumsum(counts, axis=1) - counts
    rank = jnp.arange(s * k)[None, :] - jnp.take_along_axis(seg_start, eids_s, axis=1)
    return np.asarray(gate_idx), cap, np.asarray(rank < cap)


# ---------------------------------------------------------------------------
# top-k order
# ---------------------------------------------------------------------------
def test_top_k_takes_the_lower_index_among_ties():
    probs = torch.tensor([0.5, 1.0, 1.0, 0.2, 1.0])
    vals, idx = moe.top_k(probs, 2)
    assert idx.tolist() == [1, 2] and vals.tolist() == [1.0, 1.0]
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    # a tie-rich grid: values on 4 levels over 128 experts
    grid = np.random.default_rng(0).integers(0, 4, size=(64, 128)).astype(np.float32) / 4
    for k in (1, 2, 8):
        vals, idx = moe.top_k(torch.from_numpy(grid), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(grid), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


@pytest.mark.parametrize("arch", ARCHS)
def test_group_capacity_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for s in (1, 2, 5, 13, 24, 100, 1000, 4096):
        assert moe.group_capacity(s, tcfg) == jmoe.group_capacity(s, jcfg), s


# ---------------------------------------------------------------------------
# the FFN against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dispatch_is_the_reference_s(arch, case):
    """Expert ids, capacity and drops equal bitwise."""
    jcfg, tcfg, p, x = _case(arch, case)
    want_ids, want_cap, want_in = _jax_dispatch(jcfg, p, x)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, _, ids = moe.route(tp, torch.from_numpy(x), tcfg)
    cap = moe.group_capacity(x.shape[1], tcfg)
    _, _, _, in_cap = moe.dispatch(ids, cap, tcfg.moe_experts)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert cap == want_cap
    np.testing.assert_array_equal(in_cap.numpy(), want_in)
    drops = int((~in_cap).sum())
    if case == "drops":
        assert drops > 0
    elif case in ("no_drops", "decode"):
        assert drops == 0
    if case == "ties":  # of a tied pair, the lower index comes first
        ids = ids.numpy()
        assert np.isin(ids[..., 0], [0, 1]).all()
        if tcfg.moe_top_k == 2:
            np.testing.assert_array_equal(ids[..., 1], ids[..., 0] + 2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, case):
    jcfg, tcfg, p, x = _case(arch, case)
    want_y, want_aux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), jcfg)
    got_y, got_aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), tcfg)
    assert got_y.shape == x.shape and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["no_drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax(arch, case):
    """Gradients of the output and the aux loss against ``jax.grad``: a
    dropped slot passes no gradient to its token."""
    jcfg, tcfg, p, x = _case(arch, case, seed=3)
    wgt = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(params, xin):
        y, aux = jmoe.moe_ffn(params, xin, jcfg)
        return jnp.sum(y * wgt) + aux

    want = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                           jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(tp, tx, tcfg)
    (torch.sum(y * torch.from_numpy(wgt)) + aux).backward()
    for name, g in [*((k, v.grad) for k, v in tp.items()), ("x", tx.grad)]:
        w = np.asarray(want[0][name] if name != "x" else want[1])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_agrees_with_teacher_forcing(arch):
    """C = k at S = 1 drops nothing: each token alone gives its row of a
    full-sequence pass whose capacity drops nothing either."""
    _, tcfg, p, x = _case(arch, "no_drops", seed=5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    full, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    rows = [moe.moe_ffn(tp, torch.from_numpy(x[:, t : t + 1]), tcfg)[0]
            for t in range(x.shape[1])]
    torch.testing.assert_close(torch.cat(rows, 1), full, rtol=TOL, atol=TOL)


def test_bf16_router_ties_route_like_jax():
    """bf16 router logits tie often over 128 experts; both packages take
    the lower index, so the routed experts and outputs agree."""
    jcfg, tcfg = _cfgs("llama4-maverick-400b-a17b", moe_experts=128, d_model=64,
                       compute_dtype="bfloat16")
    p = jsharding.materialize(jax.random.PRNGKey(6), jmoe.moe_specs(jcfg), jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    x = np.random.default_rng(7).normal(size=(2, 64, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    logits = jnp.einsum("bsd,de->bse", jx, jp["router"]).astype(jnp.float32)
    _, want_ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 1)
    _, _, ids = moe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    want_y, _ = jmoe.moe_ffn(jp, jx, jcfg)
    got_y, _ = moe.moe_ffn(tp, tx, tcfg)
    want_y = np.asarray(want_y, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want_y).max())) - 7)
    np.testing.assert_allclose(got_y.float().numpy(), want_y, rtol=0, atol=2 * ulp)
