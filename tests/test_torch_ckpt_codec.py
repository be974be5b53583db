"""The port's compressed checkpoints (``compress.checkpoint_codec``) and
NTTD embedding (``models.nttd_embed``) against the JAX package, on the CPU.

One tree has a leaf clearly above the fitness gate (a smooth matrix,
fitness ~0.98 in both packages at the settings below, gate 0.5), one
clearly below (noise, fitness ~0) and one too small to fit.  Both
packages must choose the same kinds and write the same raw bytes, and
each package's payloads and ``VersionedCheckpointer`` directories must
restore in the other.  Decodes agree within rtol 1e-5 / atol 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro.compress import checkpoint_codec as jcc
from repro.models.nttd_embed import NTTDEmbedding as JEmbedding
from repro_torch import codecs as tcodecs
from repro_torch import convert
from repro_torch.compress import checkpoint_codec as tcc
from repro_torch.models.nttd_embed import NTTDEmbedding

RTOL, ATOL = 1e-5, 1e-6
GATE = dict(min_elements=1024, min_fitness=0.5, epochs=20, rank=8, hidden=16, batch_size=1024)


def _tree() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    a, b = np.linspace(0, 3, 128), np.linspace(0, 2, 64)
    smooth = np.outer(np.sin(a), np.cos(b)) + 0.5 * np.outer(np.cos(2 * a), np.sin(3 * b)) + 2
    return {"blocks": {"w": smooth.astype(np.float32),
                       "noise": rng.normal(size=(128, 64)).astype(np.float32)},
            "bias": rng.normal(size=(8,)).astype(np.float32)}


def _ttree(tree):
    return convert.params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def compressed():
    tree = _tree()
    jout = jcc.compress_tree(jax.tree.map(jnp.asarray, tree), jcc.CodecCheckpointConfig(**GATE))
    tout = tcc.compress_tree(_ttree(tree), tcc.CodecCheckpointConfig(**GATE), device="cpu")
    return tree, jout, tout


def test_same_keys_kinds_and_raw_bytes(compressed):
    _, (jpay, jstats), (tpay, tstats) = compressed
    assert list(tpay) == list(jpay) == ["bias", "blocks/noise", "blocks/w"]
    assert {k: v["kind"] for k, v in tpay.items()} == {k: v["kind"] for k, v in jpay.items()} == {
        "bias": "raw", "blocks/noise": "raw", "blocks/w": "nttd"}
    for k, v in jpay.items():
        if v["kind"] == "raw":
            assert tpay[k]["data"] == v["data"], k
        else:
            assert tpay[k]["dtype"] == v["dtype"] and tpay[k]["shape"] == v["shape"]
            assert len(tpay[k]["data"]) == len(v["data"])
            assert tpay[k]["fitness"] > 0.9 and v["fitness"] > 0.9
    assert {k: tstats[k] for k in jstats} == jstats and tstats["ratio"] > 1
    assert [(x["key"], x["kind"], x["elements"]) for x in tstats["leaves"]] == [
        ("bias", "raw", 8), ("blocks/noise", "raw", 8192), ("blocks/w", "nttd", 8192)]
    assert tstats["leaves"][0]["fitness"] is None and tstats["leaves"][1]["fitness"] < 0.5


def test_decompress_restores_raw_bitwise_and_codec_leaves_lossy(compressed):
    tree, _, (tpay, _) = compressed
    template = _ttree(tree)
    restored = tcc.decompress_tree(tpay, template, device="cpu")
    assert torch.equal(restored["bias"], template["bias"])
    assert torch.equal(restored["blocks"]["noise"], template["blocks"]["noise"])
    w = tree["blocks"]["w"]
    rel = np.linalg.norm(restored["blocks"]["w"].numpy() - w) / np.linalg.norm(w)
    assert rel < 0.1 and restored["blocks"]["w"].dtype == torch.float32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_payloads_decode_in_the_other_package(compressed, writer):
    tree, (jpay, _), (tpay, _) = compressed
    blob = (tpay if writer == "port" else jpay)["blocks/w"]["data"]
    want = np.asarray(jcodecs.load_bytes(blob).to_dense())
    got = tcodecs.load_bytes(blob, device="cpu").to_dense()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the whole payload dict through the other package's decompress_tree
    if writer == "reference":
        restored = tcc.decompress_tree(jpay, _ttree(tree), device="cpu")
        np.testing.assert_allclose(restored["blocks"]["w"].numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(restored["bias"].numpy(), tree["bias"])
    else:
        restored = jcc.decompress_tree(tpay, jax.tree.map(jnp.asarray, tree))
        np.testing.assert_allclose(np.asarray(restored["blocks"]["w"]), got, rtol=RTOL,
                                   atol=ATOL)


def test_gate_below_fitness_and_infeasible_budget_store_raw():
    tree = {"noise": np.random.default_rng(3).normal(size=(64, 40)).astype(np.float32)}
    cfg = tcc.CodecCheckpointConfig(min_elements=1024, min_fitness=0.99, epochs=2,
                                    batch_size=1024)
    pay, stats = tcc.compress_tree(_ttree(tree), cfg, device="cpu")
    assert pay["noise"]["kind"] == "raw" and stats["leaves_raw"] == 1
    # a budget no codec can meet: the fit raises ValueError -> raw
    cfg = tcc.CodecCheckpointConfig(codec="ttd", min_elements=16, budget_ratio=1e-6)
    pay, _ = tcc.compress_tree(_ttree(tree), cfg, device="cpu")
    assert pay["noise"]["kind"] == "raw"


def test_bf16_leaf_compresses_and_restores_in_its_dtype():
    w = _tree()["blocks"]["w"]
    tree = {"w": torch.from_numpy(w).to(torch.bfloat16), "b": torch.ones(4, dtype=torch.bfloat16)}
    pay, _ = tcc.compress_tree(tree, tcc.CodecCheckpointConfig(**GATE), device="cpu")
    assert pay["w"]["kind"] == "nttd" and pay["w"]["dtype"] == "bfloat16"
    out = tcc.decompress_tree(pay, tree, device="cpu")
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["b"], tree["b"])


# ---------------------------------------------------------------------------
# VersionedCheckpointer
# ---------------------------------------------------------------------------
VOPTS = dict(min_elements=1024, min_fitness=0.5, chunk_bytes=4096,
             keyframe_opts=dict(rank=4, hidden=8, epochs=10, batch_size=1024, seed=0),
             delta_opts=dict(rank=2, hidden=4, batch_size=1024, seed=0))


def _steps():
    tree = _tree()
    nxt = {"blocks": {"w": tree["blocks"]["w"] * 1.01 + 0.01, "noise": tree["blocks"]["noise"]},
           "bias": tree["bias"] + 1}
    return [tree, nxt]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_versioned_checkpointer_restores_in_the_other_package(tmp_path, writer):
    steps = _steps()
    d = str(tmp_path / writer)
    if writer == "port":
        with tcc.VersionedCheckpointer(d, tcc.VersionedCheckpointConfig(**VOPTS),
                                       device="cpu") as ck:
            stats = [ck.save_step(_ttree(t)) for t in steps]
    else:
        with jcc.VersionedCheckpointer(d, jcc.VersionedCheckpointConfig(**VOPTS)) as ck:
            stats = [ck.save_step(jax.tree.map(jnp.asarray, t)) for t in steps]
    assert stats[0]["leaves_store"] == 1 and stats[0]["keyframes"] == 1
    files = sorted(os.listdir(d))
    assert files == ["leaf2.tcdc", "manifest.json", "raw_step0.npz", "raw_step1.npz"]
    treader = tcc.VersionedCheckpointer(d, device="cpu")
    jreader = jcc.VersionedCheckpointer(d)
    assert treader.n_steps == jreader.n_steps == 2
    for step, want_tree in enumerate(steps):
        got = treader.restore_step(step, _ttree(want_tree))
        want = jreader.restore_step(step, jax.tree.map(jnp.asarray, want_tree))
        np.testing.assert_array_equal(got["bias"].numpy(), want_tree["bias"])
        np.testing.assert_array_equal(got["blocks"]["noise"].numpy(),
                                      np.asarray(want["blocks"]["noise"]))
        np.testing.assert_allclose(got["blocks"]["w"].numpy(), np.asarray(want["blocks"]["w"]),
                                   rtol=RTOL, atol=ATOL)
        w = want_tree["blocks"]["w"]
        assert np.linalg.norm(got["blocks"]["w"].numpy() - w) / np.linalg.norm(w) < 0.5


def test_versioned_checkpointer_demotes_and_refuses_like_the_reference(tmp_path):
    d = str(tmp_path / "v")
    opts = {**VOPTS, "min_fitness": 0.999}
    noise = {"n": np.random.default_rng(5).normal(size=(64, 40)).astype(np.float32)}
    with tcc.VersionedCheckpointer(d, tcc.VersionedCheckpointConfig(**opts), device="cpu") as ck:
        st = ck.save_step(_ttree(noise))
        assert st["leaves_store"] == 0 and st["leaves_raw"] == 1
        with pytest.raises(ValueError, match="appeared after step 0"):
            ck.save_step(_ttree({**noise, "m": np.zeros((2, 2), np.float32)}))
    assert sorted(os.listdir(d)) == ["manifest.json", "raw_step0.npz"]
    with pytest.raises(ValueError, match="out of range"):
        tcc.VersionedCheckpointer(d, device="cpu").restore_step(3, _ttree(noise))


# ---------------------------------------------------------------------------
# NTTDEmbedding
# ---------------------------------------------------------------------------
def _table(rng):
    # the reference test's table: rows are smooth functions of a latent
    # coordinate, with arbitrary (shuffled) token ids
    lat = np.linspace(0, 3, 128)
    basis = np.stack([np.sin(lat * f + p) for f, p in [(1, 0), (2, 1), (3, 2), (0.5, 0.5)]], 1)
    table = (basis @ rng.normal(size=(4, 32))).astype(np.float32)
    return table[rng.permutation(128)]


def test_lookup_on_a_reference_payload_matches_reference():
    rng = np.random.default_rng(0)
    table = _table(rng)
    jemb = JEmbedding.fit(table, rank=6, hidden=12, epochs=3)
    ct = jemb.ct
    tct = convert.compressed_from_numpy(
        jax.tree.map(np.asarray, ct.params), ct.pi, ct.spec.shape, ct.spec.factors,
        ct.norm_mean, ct.norm_std, device="cpu")
    temb = NTTDEmbedding(tct, jemb.vocab, jemb.d_model)
    ids = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    want = np.asarray(jemb.lookup(jnp.asarray(ids)))
    got = temb.lookup(torch.from_numpy(ids))
    assert got.shape == (3, 7, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert temb.payload_bytes() == jemb.payload_bytes() and temb.raw_bytes() == jemb.raw_bytes()


def test_port_fit_meets_the_reference_test_bar():
    rng = np.random.default_rng(0)
    table = _table(rng)
    emb = NTTDEmbedding.fit(table, rank=8, hidden=16, epochs=150, device="cpu")
    ids = rng.integers(0, 128, size=(2, 5))
    out = emb.lookup(torch.from_numpy(ids)).numpy()
    want = table[ids]
    rel = np.linalg.norm(out - want) / np.linalg.norm(want)
    assert rel < 0.5, rel
    assert emb.payload_bytes() < emb.raw_bytes()
