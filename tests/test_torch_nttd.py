"""The port's folding and NTTD apply against the JAX package, on the CPU.

Params come from the JAX ``init_params`` and cross over as numpy arrays
(``repro_torch.convert``); positions are made by numpy from a seed.
Tolerance 1e-5 (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folding as jfolding
from repro.core import nttd as jnttd
from repro_torch import convert
from repro_torch.core import folding as tfolding
from repro_torch.core import nttd as tnttd

SHAPES = [(20, 18, 12), (6, 5, 4), (963, 144, 440), (7, 3), (5, 4, 3, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_folding_spec_matches_reference(shape):
    js, ts = jfolding.make_folding_spec(shape), tfolding.make_folding_spec(shape)
    assert ts.folded_shape == js.folded_shape and ts.shape == js.shape
    for name in ("factors", "strides", "fstrides"):
        assert np.array_equal(getattr(ts, name), getattr(js, name))
    assert tfolding.default_d_prime(shape) == jfolding.default_d_prime(shape)


def test_choose_factors_matches_reference():
    for dim in range(1, 300, 7):
        for d_prime in range(4, 12):
            if jfolding.MAX_FACTOR**d_prime >= dim:
                assert tfolding.choose_factors(dim, d_prime) == jfolding.choose_factors(
                    dim, d_prime
                )


@pytest.mark.parametrize("shape", SHAPES)
def test_fold_unfold_match_reference(shape):
    js, ts = jfolding.make_folding_spec(shape), tfolding.make_folding_spec(shape)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, 500) for n in shape], axis=1)
    want = js.fold_indices(idx)
    assert np.array_equal(js.fold_indices(jnp.asarray(idx, jnp.int32)), want)
    assert np.array_equal(ts.fold_indices(idx), want)  # numpy path
    folded = ts.fold_indices(torch.from_numpy(idx))    # torch path
    assert folded.dtype == torch.int64
    assert np.array_equal(folded.numpy(), want)
    assert np.array_equal(ts.unfold_indices(folded).numpy(), idx)
    assert np.array_equal(ts.unfold_indices(want), js.unfold_indices(want))


def _jax_params(spec_shape, rank, hidden, seed=3, d_prime=None):
    jspec = jfolding.make_folding_spec(spec_shape, d_prime)
    cfg = jnttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl="ref")
    params = jnttd.init_params(jax.random.PRNGKey(seed), jspec, cfg)
    return jspec, cfg, params


@pytest.mark.parametrize(
    "shape,rank,hidden,d_prime",
    [((20, 18, 12), 6, 12, None), ((6, 5, 4), 2, 4, None), ((4, 3), 3, 8, 2),
     ((50, 40, 30), 8, 16, None),
     # the budget rule's wide architectures, which the CUDA decode runs
     # through its simt body (d' 3 and 5)
     ((6, 5, 4), 34, 68, 3), ((20, 18, 12), 34, 68, 5), ((6, 5, 4), 128, 256, 3),
     ((20, 18, 12), 128, 256, 5)],
)
def test_apply_matches_reference(shape, rank, hidden, d_prime):
    jspec, jcfg, jparams = _jax_params(shape, rank, hidden, d_prime=d_prime)
    tspec = tfolding.make_folding_spec(shape, d_prime)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    pos = np.stack([rng.integers(0, s, 257) for s in shape], axis=1)
    want = {
        impl: np.asarray(jnttd.make_predict(
            jspec, jnttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl=impl)
        )(jparams, jnp.asarray(pos, jnp.int32)))
        for impl in ("ref", "fused")
    }
    np.testing.assert_allclose(want["fused"], want["ref"], rtol=1e-5, atol=1e-5)
    for impl in ("ref", "fused", "cuda", "auto"):
        cfg = tnttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl=impl)
        got = tnttd.apply_at_positions(tparams, torch.from_numpy(pos), tspec, cfg)
        assert got.shape == (257,) and got.dtype == torch.float32
        for ref_impl in ("ref", "fused"):
            np.testing.assert_allclose(got.numpy(), want[ref_impl], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,rank,hidden,d_prime",
                         [((20, 18, 12), 6, 12, None), ((4, 3), 3, 8, 2), ((6, 5, 4), 34, 68, 3)])
def test_apply_ref_unrolled_matches_reference(shape, rank, hidden, d_prime):
    """``kernel_impl="ref_unrolled"`` through ``nttd.apply`` against the
    reference's ``nttd.apply`` with the same impl."""
    jspec, jcfg, jparams = _jax_params(shape, rank, hidden, d_prime=d_prime)
    tspec = tfolding.make_folding_spec(shape, d_prime)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(6)
    pos = np.stack([rng.integers(0, s, 129) for s in shape], axis=1)
    want = np.asarray(jnttd.make_predict(
        jspec, jnttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl="ref_unrolled")
    )(jparams, jnp.asarray(pos, jnp.int32)))
    cfg = tnttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl="ref_unrolled")
    got = tnttd.apply_at_positions(tparams, torch.from_numpy(pos), tspec, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_generate_tensor_matches_reference():
    jspec, jcfg, jparams = _jax_params((6, 5, 4), 3, 6)
    tspec = tfolding.make_folding_spec((6, 5, 4))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    want = jnttd.generate_tensor(jparams, jspec, jcfg, batch=64)
    for impl in ("ref", "auto"):
        cfg = tnttd.NTTDConfig(rank=3, hidden=6, kernel_impl=impl)
        got = tnttd.generate_tensor(tparams, tspec, cfg, batch=64)
        assert got.shape == (6, 5, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_decode_inputs_match_reference():
    jspec, jcfg, jparams = _jax_params((20, 18, 12), 4, 8)
    tspec = tfolding.make_folding_spec((20, 18, 12))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    want = jnttd.fused_decode_inputs(jparams, jspec, jcfg)
    got = tnttd.fused_decode_inputs(tparams, tspec, tnttd.NTTDConfig(rank=4, hidden=8))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_params_shapes_and_distributions():
    jspec, jcfg, jparams = _jax_params((963, 144, 440), 8, 16)
    tspec = tfolding.make_folding_spec((963, 144, 440))
    cfg = tnttd.NTTDConfig(rank=8, hidden=16)
    tparams = tnttd.init_params(torch.Generator().manual_seed(0), tspec, cfg, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tnp = convert.params_to_numpy(tparams)
    assert sorted(tnp) == sorted(jparams)
    for path, leaf in jflat:
        node = tnp
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape and node.dtype == np.float32
    assert tnttd.count_params(tparams) == jnttd.count_params(jparams)
    np.testing.assert_array_equal(tnp["head_mid"]["b"], np.eye(8).reshape(64))
    np.testing.assert_allclose(tnp["head_first"]["b"], np.full(8, 1 / np.sqrt(8)), rtol=1e-6)
    assert not tnp["lstm"]["b"].any()
    emb = tnp["embed_8"]
    assert abs(emb.std() - 1 / np.sqrt(16)) < 0.05
    # the same generator state gives the same params
    again = tnttd.init_params(torch.Generator().manual_seed(0), tspec, cfg, "cpu")
    assert torch.equal(again["lstm"]["wi"], tparams["lstm"]["wi"])


def test_params_numpy_round_trip():
    _, _, jparams = _jax_params((20, 18, 12), 4, 8)
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_numpy(convert.params_from_numpy(tree, "cpu"))
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(tree)[0],
        jax.tree_util.tree_flatten_with_path(back)[0],
    ):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_init_params_defaults_to_cuda(monkeypatch):
    """Without a device, ``init_params`` resolves CUDA like every entry point
    of the port: with no CUDA device it raises, and ``device="cpu"`` builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tfolding.make_folding_spec((6, 5, 4))
    cfg = tnttd.NTTDConfig(rank=3, hidden=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnttd.init_params(torch.Generator().manual_seed(0), spec, cfg)
    params = tnttd.init_params(torch.Generator().manual_seed(0), spec, cfg, device="cpu")
    assert tnttd.params_device(params) == torch.device("cpu")
    assert tnttd.count_params(params) > 0


def test_compressed_tensor_builds_decode_operands_once(monkeypatch):
    """A payload stacks (and on CUDA pads) the fused decode's operands once,
    not per request; its answers equal a fresh ``apply``."""
    from repro_torch.core.codec import CompressedTensor

    shape = (20, 18, 12)
    jspec, jcfg, jparams = _jax_params(shape, 6, 12)
    tspec = tfolding.make_folding_spec(shape)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = tnttd.NTTDConfig(rank=6, hidden=12)
    calls = []
    inputs = tnttd.fused_decode_inputs
    monkeypatch.setattr(tnttd, "fused_decode_inputs",
                        lambda *a: calls.append(1) or inputs(*a))
    pi = [np.arange(n) for n in shape]
    ct = CompressedTensor(tparams, pi, tspec, cfg)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, n, 100) for n in shape], axis=1)
    first, second = ct.decode(idx), ct.decode(idx)
    dense = ct.to_dense(batch=1000)
    assert len(calls) == 1
    # on the CPU the plain version runs, on the operands as they are
    assert ct.decode_operands[0].shape == (tspec.d_prime, max(tspec.folded_shape), 12)
    want = tnttd.apply_at_positions(tparams, torch.from_numpy(idx), tspec, cfg).numpy()
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    np.testing.assert_array_equal(dense[tuple(idx.T)], want)
