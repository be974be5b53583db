"""The five competitor codecs (ttd, tucker, cpd, tensor_ring, szlite)
against the JAX package's, on the CPU.

Both packages fit the same seeded array at the same byte budget.  These
codecs are NumPy on the host in both packages, so the bodies must be
byte-identical and the decodes equal; each package loads the other's
container, and the budget rules raise the same errors.
"""
import numpy as np
import pytest

import repro.codecs as jcodecs
from repro.codecs import container as jcontainer
from repro_torch import codecs as tcodecs
from repro_torch.codecs import container as tcontainer

SHAPE = (12, 10, 8)
BUDGET = 4000
COMPETITORS = ["ttd", "tucker", "cpd", "tensor_ring", "szlite"]


def _tensor() -> np.ndarray:
    rng = np.random.default_rng(7)
    x = (np.sin(np.linspace(0, 6, SHAPE[0]))[:, None, None]
         + np.cos(np.linspace(0, 3, SHAPE[1]))[None, :, None]
         + 0.1 * rng.normal(size=SHAPE))
    return x.astype(np.float32)


def _indices(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, size=n) for s in SHAPE], axis=1)


@pytest.fixture(scope="module")
def fitted():
    """{codec: (reference payload, port payload)} at ``BUDGET`` bytes."""
    x = _tensor()
    return {name: (jcodecs.get_codec(name).fit(x, BUDGET), tcodecs.get_codec(name).fit(x, BUDGET))
            for name in COMPETITORS}


def test_available_matches_reference():
    assert tcodecs.available() == jcodecs.available()
    for name in tcodecs.available():
        codec = tcodecs.get_codec(name)
        assert codec.name == name and codec.encoded_cls.codec_name == name
        assert codec.bytes_per_param == jcodecs.get_codec(name).bytes_per_param


@pytest.mark.parametrize("name", COMPETITORS)
def test_to_bytes_identical_and_decodes_equal(fitted, name):
    ref, port = fitted[name]
    assert port.to_bytes() == ref.to_bytes()
    assert tcodecs.save_bytes(port) == jcodecs.save_bytes(ref)
    assert port.shape == ref.shape == SHAPE
    assert port.payload_bytes() == ref.payload_bytes() <= BUDGET
    idx = _indices()
    np.testing.assert_array_equal(port.decode_at(idx), ref.decode_at(idx))
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
    assert port.fitness(_tensor()) == ref.fitness(_tensor())


@pytest.mark.parametrize("name", COMPETITORS)
def test_each_package_loads_the_others_container(fitted, name):
    ref, port = fitted[name]
    idx = _indices(seed=4)
    from_ref = tcodecs.load_bytes(ref.save(), device="cpu")
    from_port = jcodecs.load_bytes(port.save())
    assert type(from_ref) is type(port) and type(from_port) is type(ref)
    assert from_ref.to_bytes() == from_port.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(from_ref.decode_at(idx), ref.decode_at(idx))
    np.testing.assert_array_equal(from_port.decode_at(idx), port.decode_at(idx))


def _error(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("name", COMPETITORS)
def test_budget_errors_match_reference(name):
    """Without a budget or a native knob every codec refuses with the
    reference's message; szlite also refuses a budget below its stream
    floor, naming the floor."""
    x = _tensor()
    for fit in ((lambda c: c.fit(x)),) + (((lambda c: c.fit(x, 16)),) if name == "szlite" else ()):
        assert _error(lambda: fit(tcodecs.get_codec(name))) == _error(
            lambda: fit(jcodecs.get_codec(name)))


@pytest.mark.parametrize("budget", [600, 4000, 30000])
def test_budget_translation_matches_reference(budget):
    """Each codec's budget -> knob rule: the same native rank(s) at three
    budgets (the payload sizes fix the ranks, so the bodies' lengths agree
    as well)."""
    from repro.core import cpd as jcpd, tensor_ring as jtr, ttd as jttd, tucker as jtucker
    from repro_torch.core import cpd, tensor_ring, ttd, tucker

    n = budget // 8
    assert ttd.tt_rank_for_budget(SHAPE, n) == jttd.tt_rank_for_budget(SHAPE, n)
    assert tucker.tucker_ranks_for_budget(SHAPE, n) == jtucker.tucker_ranks_for_budget(SHAPE, n)
    assert cpd.cp_rank_for_budget(SHAPE, n) == jcpd.cp_rank_for_budget(SHAPE, n)
    assert tensor_ring.tr_rank_for_budget(SHAPE, n) == jtr.tr_rank_for_budget(SHAPE, n)
    x = _tensor()
    for name in COMPETITORS:
        try:
            want = len(jcodecs.get_codec(name).fit(x, budget).to_bytes())
        except ValueError as err:
            assert _error(lambda: tcodecs.get_codec(name).fit(x, budget)) == str(err)
            continue
        assert len(tcodecs.get_codec(name).fit(x, budget).to_bytes()) == want


def test_native_knobs_match_reference():
    """The codec-native options that bypass the budget rule."""
    x = _tensor()
    for name, opts in (("ttd", dict(eps=0.1)), ("ttd", dict(max_rank=3)),
                       ("tucker", dict(ranks=[3, 2, 4], iters=2)),
                       ("cpd", dict(rank=3, iters=5, seed=2)),
                       ("tensor_ring", dict(max_rank=3)), ("szlite", dict(error_bound=0.05))):
        want = jcodecs.get_codec(name).fit(x, **opts).to_bytes()
        assert tcodecs.get_codec(name).fit(x, **opts).to_bytes() == want, (name, opts)


def test_szlite_dense_cache_counters():
    """SZ-lite's cached reconstruction behaves as the reference's: built on
    first use, counted, dropped by ``drop_caches``, and ``to_dense`` never
    aliases it."""
    port = tcodecs.get_codec("szlite").fit(_tensor(), error_bound=0.01)
    ref = jcodecs.get_codec("szlite").fit(_tensor(), error_bound=0.01)
    idx = _indices()
    for enc in (port, ref):
        enc.decode_at(idx)
        enc.decode_at(idx)
    assert (port.cache_misses, port.cache_hits) == (ref.cache_misses, ref.cache_hits) == (1, 1)
    assert port.cache_nbytes() == ref.cache_nbytes() > 0
    dense = port.to_dense()
    dense[...] = 0
    assert port.decode_at(idx).any()
    port.drop_caches()
    assert port.cache_nbytes() == 0


def test_array_bodies_match_reference():
    """``pack_arrays``/``unpack_arrays``, the decomposition codecs' body
    framing, byte for byte, with its count limit."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(1, 4, 3)), rng.normal(size=(3, 5)).astype(np.float32),
              np.arange(4, dtype=np.int64), np.frombuffer(b"abc", dtype=np.uint8)]
    blob = tcontainer.pack_arrays(*arrays)
    assert blob == jcontainer.pack_arrays(*arrays)
    for got, want in zip(tcontainer.unpack_arrays(blob), arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="u8 count"):
        tcontainer.pack_arrays(*([np.zeros(1)] * 256))
    with pytest.raises(ValueError, match="array count"):
        tcontainer.unpack_arrays(b"")
    with pytest.raises(ValueError, match="truncated"):
        tcontainer.unpack_arrays(blob[:-1])
