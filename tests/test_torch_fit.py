"""The port's fitting path (Alg. 1) against the JAX package's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages; where
both must start from the same theta, the JAX init is carried across with
``repro_torch.convert.params_from_numpy``.  The reference fits through its
jnp oracles (``kernel_impl="ref"``); the port is run with "ref" (its plain
versions) and "auto" (the kernels' wrappers, which run the plain versions
on CPU tensors).  Tolerances: Adam updates 1e-7 (f32 arithmetic in the same
order); loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6 (sums over the
batch in another order); whole fits: loss history rtol 1e-4, fitness 1e-4,
and 0.02 with the port's own initialisation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codecs as jcodecs
from repro.codecs.adapters import NTTDCodec as JNTTDCodec
from repro.core import codec as jcodec
from repro.core import nttd as jnttd
from repro.core import reorder as jreorder
from repro.core.folding import make_folding_spec as jfolding
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.codecs import get_codec
from repro_torch.codecs.adapters import NTTDCodec as TNTTDCodec
from repro_torch.core import codec as tcodec
from repro_torch.core import nttd as tnttd
from repro_torch.core import reorder as treorder
from repro_torch.core.folding import make_folding_spec as tfolding
from repro_torch.optim import optimizers as topt

SHAPE = (12, 10, 9)  # d' = 4 by default: two mid cores
FIT = dict(rank=4, hidden=8, batch_size=128, lr=1e-2)


def _tensor(seed=3, shuffle=False):
    """A smooth 12 x 10 x 9 tensor plus noise; ``shuffle`` permutes every
    mode, so that Alg. 3 has swaps to find."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(0, 1, n) for n in SHAPE], indexing="ij")
    x = np.sin(3 * g[0]) * np.cos(2 * g[1]) + g[2] ** 2 + 0.05 * rng.normal(size=SHAPE)
    if shuffle:
        x = x[rng.permutation(SHAPE[0])][:, rng.permutation(SHAPE[1])][:, :, rng.permutation(
            SHAPE[2])]
    return x.astype(np.float32)


def _jax_params(shape, rank, hidden, d_prime=None, seed=0):
    spec = jfolding(shape, d_prime)
    cfg = jnttd.NTTDConfig(rank=rank, hidden=hidden)
    return jax.tree.map(np.asarray, jnttd.init_params(jax.random.PRNGKey(seed), spec, cfg))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in _leaves(tree[k]):
                yield f"{k}/{path}" if path else k, leaf
    else:
        yield "", tree


def _assert_trees_close(got, want, rtol, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        g = got[key].detach().cpu().numpy() if isinstance(got[key], torch.Tensor) else got[key]
        np.testing.assert_allclose(g, np.asarray(want[key]), rtol=rtol, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
def test_adam_steps_match_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 7)), "b": {"w": rng.normal(size=(3,)) * 1e-3}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    grads = [jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape), np.float32), params)
             for _ in range(3)]
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    jp, tp = params, convert.params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(g, js, jp)
        tu, ts = to.update(convert.params_from_numpy(g, "cpu"), ts, tp)
        _assert_trees_close(tu, ju, rtol=0, atol=1e-7)
        _assert_trees_close(ts.mu, js.mu, rtol=0, atol=1e-7)
        _assert_trees_close(ts.nu, js.nu, rtol=0, atol=1e-7)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _assert_trees_close(tp, jp, rtol=0, atol=1e-7)
    assert int(ts.step) == int(js.step) == 3 and ts.mu["a"].dtype == torch.float32


def test_global_norm_clip_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 4)).astype(np.float32), "b": np.ones(3, np.float32)}
    jclip, jnorm = jopt.clip_by_global_norm(tree, 1.5)
    tclip, tnorm = topt.clip_by_global_norm(convert.params_from_numpy(tree, "cpu"), 1.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _assert_trees_close(tclip, jclip, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["ref", "auto"])
@pytest.mark.parametrize("d_prime", [2, 4, 6])
def test_train_step_loss_and_grads_match_reference(d_prime, impl):
    """d' = 2 is the K == 0 chain (a row dot), d' 4 and 6 run mid cores."""
    shape = (7, 9, 5)
    np_params = _jax_params(shape, rank=5, hidden=6, d_prime=d_prime)
    rng = np.random.default_rng(d_prime)
    pos = np.stack([rng.integers(0, n, 64) for n in shape], axis=1)
    vals = rng.normal(size=64).astype(np.float32)

    jspec = jfolding(shape, d_prime)
    jcfg = jnttd.NTTDConfig(rank=5, hidden=6)

    def jloss(p):
        preds = jnttd.apply_at_positions(p, jnp.asarray(pos, jnp.int32), jspec, jcfg)
        return jnp.sum(jnp.square(preds - vals))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, np_params))
    tspec = tfolding(shape, d_prime)
    tcfg = tnttd.NTTDConfig(rank=5, hidden=6, kernel_impl=tcodec.training_impl(impl))
    tl, tg = tcodec._make_value_and_grad(tspec, tcfg)(
        convert.params_from_numpy(np_params, "cpu"), torch.as_tensor(pos), torch.as_tensor(vals))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_trees_close(tg, jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("factors", [
    [[2, 2, 2, 1], [2, 2, 1, 2], [2, 1, 2, 2]],  # folded (8, 4, 4, 4): one table shared
    [[1, 2, 1, 2], [2, 2, 1, 2], [2, 2, 2, 1]],  # folded (4, 8, 2, 4): tables interleaved
])
def test_embed_matches_per_mode_gathers(factors):
    """The training forward's embedding (one F.embedding a distinct table)
    gives the per-mode gathers' values exactly, and their gradient."""
    from repro_torch.core.folding import spec_from_factors

    factors = np.array(factors)
    spec = spec_from_factors(tuple(int(n) for n in factors.prod(axis=1)), factors)
    rng = np.random.default_rng(5)
    tables = {f"embed_{m}": torch.tensor(rng.normal(size=(m, 3)), dtype=torch.float32,
                                         requires_grad=True)
              for m in set(spec.folded_shape)}
    idx = torch.as_tensor(np.stack([rng.integers(0, m, 50) for m in spec.folded_shape], 1))
    want = torch.stack([tables[f"embed_{m}"][idx[:, j]]
                        for j, m in enumerate(spec.folded_shape)], dim=1)
    got = tnttd._embed(tables, idx, spec)
    assert torch.equal(got, want)
    dout = torch.randn(got.shape)
    want_g = torch.autograd.grad(want, list(tables.values()), dout)
    got_g = torch.autograd.grad(got, list(tables.values()), dout)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_training_impl_is_the_unfused_route():
    assert [tcodec.training_impl(i) for i in ("ref", "auto", "fused", "cuda")] == [
        "ref", "cuda", "cuda", "cuda"]
    assert tcodec.CodecConfig().kernel_impl == "auto"


def test_fused_decode_refuses_a_gradient():
    """The fused decode has no backward: asking it for a gradient raises
    rather than leaving the operands' gradients unset."""
    from repro_torch.kernels import ops

    shape = (7, 9, 5)
    params = convert.params_from_numpy(_jax_params(shape, rank=5, hidden=6), "cpu")
    spec = tfolding(shape)
    ws = [w.requires_grad_() for w in tnttd.fused_decode_inputs(params, spec,
                                                               tnttd.NTTDConfig(5, 6))]
    idx = spec.fold_indices(torch.zeros((4, 3), dtype=torch.int64)).to(torch.int32)
    out = ops.nttd_decode_tile(idx, *ws, impl="auto")
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()
    assert ops.nttd_decode_tile(idx, *ws, impl="ref").sum().requires_grad


# ---------------------------------------------------------------------------
# reordering
# ---------------------------------------------------------------------------
def test_tsp_init_matches_reference():
    for x in (_tensor(), _tensor(5, shuffle=True)):
        for got, want in zip(treorder.tsp_init(x), jreorder.tsp_init(x)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(treorder.order_objective(x, 1, np.arange(10)),
                                  jreorder.order_objective(x, 1, np.arange(10)))


@pytest.mark.parametrize("samples", [4096, 30])
def test_update_orders_matches_reference(samples):
    """The same params, pi and seed give the same pi and SwapStats: slices
    within the sample budget take the exact delta < 0 rule, 30 samples a
    slice the t-statistic rule."""
    x = _tensor(7, shuffle=True)
    np_params = _jax_params(SHAPE, **{k: FIT[k] for k in ("rank", "hidden")})
    pi0 = [np.random.default_rng(k).permutation(n) for k, n in enumerate(SHAPE)]
    jspec = jfolding(SHAPE)
    jcfg = jnttd.NTTDConfig(rank=FIT["rank"], hidden=FIT["hidden"])
    jpi, jstats = jreorder.update_orders(x, jax.tree.map(jnp.asarray, np_params), pi0, jspec,
                                         jcfg, np.random.default_rng(11), samples)
    tcfg = tnttd.NTTDConfig(rank=FIT["rank"], hidden=FIT["hidden"])
    tpi, tstats = treorder.update_orders(x, convert.params_from_numpy(np_params, "cpu"), pi0,
                                         tfolding(SHAPE), tcfg, np.random.default_rng(11), samples)
    for got, want in zip(tpi, jpi):
        np.testing.assert_array_equal(got, want)
    assert [(s.mode, s.pairs, s.accepted) for s in tstats] == [
        (s.mode, s.pairs, s.accepted) for s in jstats]
    np.testing.assert_allclose([s.delta_sum for s in tstats], [s.delta_sum for s in jstats],
                               rtol=1e-4, atol=1e-6)
    assert samples == 30 or sum(s.accepted for s in jstats) > 0  # the exact rule swapped


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------
def _carry_init(monkeypatch, np_params):
    """The port's compress starts from the JAX init."""
    monkeypatch.setattr(tnttd, "init_params",
                        lambda gen, spec, cfg, device=None: convert.params_from_numpy(
                            np_params, device))


@pytest.mark.parametrize("impl", ["ref", "auto"])
@pytest.mark.parametrize("init_reorder", [True, False])
def test_compress_matches_reference_with_carried_init(monkeypatch, capsys, init_reorder, impl):
    """6 epochs with one Alg. 3 sweep after the fifth (the exact rule: every
    slice is within the sample budget), from the same theta.  Without the
    TSP init the shuffled tensor gives the sweep swaps to accept.  Where a
    mode's accepted swaps differ (a delta within float noise of 0 decides
    it), the test prints the mode and holds everything before the sweep."""
    x = _tensor(5, shuffle=True)
    cfg = dict(FIT, epochs=6, init_reorder=init_reorder)
    jct, jlog = jcodec.compress(x, jcodec.CodecConfig(**cfg))
    _carry_init(monkeypatch, _jax_params(SHAPE, FIT["rank"], FIT["hidden"]))
    tct, tlog = tcodec.compress(x, tcodec.CodecConfig(**cfg, kernel_impl=impl), device="cpu")
    assert len(tlog.reorder_stats) == len(jlog.reorder_stats) == 1
    jst, tst = jlog.reorder_stats[0], tlog.reorder_stats[0]
    noisy = [t.mode for t, j in zip(tst, jst) if t.accepted != j.accepted]
    if noisy:
        print(f"modes whose swap decisions differ (delta within noise of 0): {noisy}: "
              f"port {tst}, reference {jst}")
        n = 5  # the epochs before the sweep's effect
    else:
        n = 6
        np.testing.assert_allclose([s.delta_sum for s in tst], [s.delta_sum for s in jst],
                                   rtol=1e-4, atol=1e-6)
        for got, want in zip(tct.pi, jct.pi):
            np.testing.assert_array_equal(got, want)
    assert [(s.mode, s.pairs) for s in tst] == [(s.mode, s.pairs) for s in jst]
    np.testing.assert_allclose(tlog.loss_history[:n], jlog.loss_history[:n], rtol=1e-4)
    np.testing.assert_allclose(tlog.fitness_history[:n], jlog.fitness_history[:n], atol=1e-4)
    assert tlog.epochs_run == jlog.epochs_run == 6
    assert init_reorder or sum(s.accepted for s in jst) > 0  # the sweep did swap
    capsys.readouterr()


def test_compress_own_init_within_eps():
    """The port's own theta init (torch generator): after 20 epochs the
    fitted payload's fitness is within 0.02 of the reference's."""
    x = _tensor()
    cfg = dict(FIT, epochs=20)
    jenc = jcodecs.get_codec("nttd").fit(x, **cfg)
    tenc = get_codec("nttd").fit(x, device="cpu", **cfg)
    assert tenc.log is not None and tenc.log.epochs_run == jenc.log.epochs_run
    assert abs(tenc.fitness(x) - jenc.fitness(x)) < 0.02
    assert tenc.ct.device.type == "cpu" and tenc.ct.cfg.kernel_impl == "auto"


def test_best_snapshot_is_not_aliased(monkeypatch):
    """The best epoch's params are copied: with updates applied in place
    and fitness falling after the first epoch, compress returns the first
    epoch's params, not the last."""
    seen = []

    def fitness(params, *args):
        seen.append(topt.tree_map(torch.clone, params))
        return 0.9 - 0.1 * len(seen)

    def in_place(params, updates):
        topt.tree_map(lambda p, u: p.add_(u), params, updates)
        return params

    monkeypatch.setattr(tcodec, "_fitness", fitness)
    monkeypatch.setattr(topt, "apply_updates", in_place)
    ct, log = tcodec.compress(_tensor(), tcodec.CodecConfig(**FIT, epochs=3, patience=10),
                              device="cpu")
    assert log.fitness_history == pytest.approx([0.8, 0.7, 0.6]) and len(seen) == 3
    _assert_trees_close(ct.params, seen[0], rtol=0, atol=0)
    assert not torch.equal(ct.params["lstm"]["wi"], seen[-1]["lstm"]["wi"])


# ---------------------------------------------------------------------------
# the codec API
# ---------------------------------------------------------------------------
PEMS_SF = (963, 144, 440)


@pytest.mark.parametrize("shape,budget", [
    (PEMS_SF, 200_000), (PEMS_SF, 1_000_000), (PEMS_SF, 4_000_000), ((183, 24, 1140), 1 << 20),
    ((12, 10, 9), 2_000), ((48, 36, 12, 30), 50_000), ((64, 32, 32), 10 << 20),
])
def test_rank_for_budget_matches_reference(shape, budget):
    want = JNTTDCodec()._rank_for_budget(shape, budget, {})
    assert TNTTDCodec()._rank_for_budget(shape, budget, {}) == want
    if shape == PEMS_SF:
        assert want == {200_000: 18, 1_000_000: 34, 4_000_000: 57}[budget]


def test_rank_for_budget_raises_below_rank_one():
    with pytest.raises(ValueError, match="cannot meet budget"):
        TNTTDCodec()._rank_for_budget((12, 10, 9), 100, {})


def test_fit_with_budget_fits_the_budget():
    x = _tensor()
    enc = get_codec("nttd").fit(x, budget=3_000, device="cpu", epochs=1, batch_size=256)
    assert enc.ct.cfg.rank == TNTTDCodec()._rank_for_budget(SHAPE, 3_000, {})
    assert enc.ct.cfg.hidden == 2 * enc.ct.cfg.rank and enc.payload_bytes() <= 3_000
    assert tnttd.count_params(enc.ct.params) == tnttd.count_param_shapes(enc.ct.spec,
                                                                          enc.ct.cfg)


def test_port_fitted_payload_decodes_in_reference():
    x = _tensor(9)
    tenc = get_codec("nttd").fit(x, device="cpu", **FIT, epochs=3)
    jenc = jcodecs.load_bytes(tenc.save())
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, n, 200) for n in SHAPE], axis=1)
    np.testing.assert_allclose(jenc.decode_at(idx), tenc.decode_at(idx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jenc.to_dense(), tenc.to_dense(), rtol=1e-5, atol=1e-6)
    assert [list(p) for p in jenc.pi] == [list(p) for p in tenc.pi]


def test_stream_fitter_is_not_ported():
    with pytest.raises(NotImplementedError, match="streaming"):
        get_codec("nttd").stream_fitter((4, 4, 4))


def test_paper_configs_match_reference():
    from repro.configs import tensorcodec_paper as jpaper
    from repro_torch.configs import tensorcodec_paper as tpaper

    for name in ("SMALL", "MEDIUM", "CONFIG", "SMOKE"):
        want = dataclasses.asdict(getattr(jpaper, name))
        got = dataclasses.asdict(getattr(tpaper, name))
        assert got == {**want, "kernel_impl": "auto"}, name


def test_synthetic_tensors_match_reference_generators():
    """The port's copy generates the reference's tensors from the same
    Generator; only ``load``'s per-name seed differs (a stable crc32 where
    the reference adds the per-process salted ``hash``)."""
    import zlib

    from repro.data import synthetic_tensors as jdata
    from repro_torch.data import synthetic_tensors as tdata

    assert tdata.DATASETS.keys() == jdata.DATASETS.keys()
    for name, spec in tdata.DATASETS.items():
        assert (spec.shape, spec.mini_shape) == (jdata.DATASETS[name].shape,
                                                 jdata.DATASETS[name].mini_shape)
        if name in ("uber", "pems_sf", "absorb"):
            got = tdata.load(name)
            want = jdata.DATASETS[name].generator(
                spec.mini_shape, np.random.default_rng(zlib.crc32(name.encode()) % 2**31))
            np.testing.assert_array_equal(got, want.astype(np.float32))
            np.testing.assert_array_equal(tdata.load(name), got)
