"""The port's LM serving slice (``repro_torch.models``, ``serve``, ``launch``)
against the JAX package, on the CPU.

Weights are the reference's ``init_params`` carried over with
``convert.params_from_numpy``; tokens and activations come from numpy
seeds.  Tolerance: 1e-5 in f32 (rtol = atol, the repo's f32 tolerance;
measured differences on the smoke configs are at most 4e-6 on logits up
to 4.7), and greedy tokens equal.  The kernel route of the port
(``attn_impl="cuda"``, the flash kernel's plain version on the CPU) is
held against the reference's ``pallas_interpret``.

jamba's smoke config (16 residual updates, 7 of them Mamba) is held to
1e-5 of its largest value instead of elementwise: its f32 logits sit
1.3e-5 (the port) and 1.5e-5 (the reference) from an f64 evaluation at a
largest logit of 3.6, so the two packages' f32 rounding differs by up to
2.2e-5 there (every sublayer alone agrees within 2e-6).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs, convert
from repro_torch.dist import sharding
from repro_torch.launch import serve as tserve
from repro_torch.models import layers
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-5
SMOKE_ARCHS = ["qwen1.5-4b", "starcoder2-15b", "minicpm-2b", "musicgen-medium",
               "internvl2-76b", "mamba2-1.3b", "grok-1-314b", "llama4-maverick-400b-a17b",
               "jamba-1.5-large-398b"]
SCALED_TOL_ARCHS = ("jamba-1.5-large-398b",)
ROUTES = [("ref", "ref"), ("pallas_interpret", "cuda")]  # (reference impl, port impl)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_model(arch: str, got: torch.Tensor, want) -> None:
    if arch not in SCALED_TOL_ARCHS:
        return _close(got, want)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL * (1.0 + float(np.abs(want).max())))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _pair_cfgs(arch: str, jimpl: str, timpl: str):
    return (dataclasses.replace(jconfigs.get_smoke(arch), attn_impl=jimpl),
            dataclasses.replace(configs.get_smoke(arch), attn_impl=timpl))


def _pair_params(jcfg):
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(2, 5, 48)) * 3, rng.normal(size=(48,))
    _close(layers.rmsnorm(_t(x), _t(w), 1e-5),
           jlayers.rmsnorm(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32), 1e-5))


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_matches_jax(batched_positions):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16))
    pos = np.arange(7) + 5
    if batched_positions:
        pos = np.stack([pos, pos + 11])
    _close(layers.rope(_t(x), torch.from_numpy(pos), 10000.0),
           jlayers.rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos), 10000.0))


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    p = {"w_gate": rng.normal(size=(48, 96)) * 0.1, "w_up": rng.normal(size=(48, 96)) * 0.1,
         "w_down": rng.normal(size=(96, 48)) * 0.1}
    x = rng.normal(size=(2, 5, 48))
    _close(layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), torch.float32),
           jlayers.mlp({k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
                       jnp.asarray(x, jnp.float32), jnp.float32))


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_unembed_match_jax(tie):
    rng = np.random.default_rng(3)
    p = {"embed": rng.normal(size=(256, 32))}
    if not tie:
        p["unembed"] = rng.normal(size=(32, 256))
    tokens = rng.integers(0, 200, size=(2, 9))
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    _close(layers.embed_lookup(tp, torch.from_numpy(tokens), torch.float32),
           jlayers.embed_lookup(jp, jnp.asarray(tokens), jnp.float32))
    x = rng.normal(size=(2, 9, 32))
    _close(layers.unembed(tp, _t(x), torch.float32),
           jlayers.unembed(jp, jnp.asarray(x, jnp.float32), jnp.float32))
    # bf16: gather-then-cast gives the values of cast-then-gather
    got = layers.embed_lookup(tp, torch.from_numpy(tokens), torch.bfloat16)
    assert torch.equal(got, tp["embed"].to(torch.bfloat16)[torch.from_numpy(tokens)])


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(4)
    logits, labels = rng.normal(size=(2, 5, 256)), rng.integers(0, 200, size=(2, 5))
    got = layers.softmax_xent(_t(logits), torch.from_numpy(labels), valid_vocab=200)
    want = jlayers.softmax_xent(jnp.asarray(logits, jnp.float32), jnp.asarray(labels), 200)
    _close(got, want)


@pytest.mark.parametrize("valid_vocab", [None, 200])
def test_softmax_xent_grad_matches_jax(valid_vocab):
    """The logits' gradient, ``jax.grad`` of the reference's loss: the
    oracle that the mesh route's vocab-parallel backward is held to
    (``tests/test_torch_tp_worlds.py``)."""
    rng = np.random.default_rng(6)
    logits, labels = rng.normal(size=(3, 4, 256)) * 3, rng.integers(0, 200, size=(3, 4))
    x = _t(logits).requires_grad_()
    layers.softmax_xent(x, torch.from_numpy(labels), valid_vocab=valid_vocab).backward()
    want = jax.grad(lambda a: jlayers.softmax_xent(a, jnp.asarray(labels), valid_vocab))(
        jnp.asarray(logits, jnp.float32))
    _close(x.grad, want, 1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_oracle_lse_matches_jax_logsumexp(causal):
    """``mha_attention(..., return_lse=True)``: the output is the
    reference's oracle's where a row has a valid position, and the
    log-sum-exp is ``jax.nn.logsumexp`` of the reference's scaled scores
    over the valid positions; a row with none (``kv_len`` 0, or the causal
    mask) gets -inf and an output of 0."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(7)
    b, sq, skv, hq, hkv, d, offset = 3, 3, 9, 4, 2, 8, 2
    q, k, v = (rng.normal(size=s) for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    kv_len = np.array([0, 4, 9], np.int32)
    out, lse = tref.mha_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=offset,
                                  kv_len=torch.from_numpy(kv_len), return_lse=True)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    scores = jnp.einsum("bqhgd,bkhd->bqhgk", (jq / jnp.sqrt(d)).reshape(b, sq, hkv, hq // hkv, d),
                        jk).reshape(b, sq, hq, skv)
    valid = np.arange(skv)[None, None, None, :] < kv_len[:, None, None, None]
    if causal:
        valid = valid & (np.arange(sq)[:, None] + offset >= np.arange(skv))[None, :, None, :]
    valid = np.broadcast_to(valid, scores.shape)
    want_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1, where=jnp.asarray(valid)))
    empty = ~valid.any(-1)
    assert empty[0].all() and not empty[1:].any()  # kv_len 0: nothing valid in any row
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), empty)
    np.testing.assert_allclose(lse.numpy()[~empty], want_lse[~empty], rtol=TOL, atol=TOL)
    want = np.asarray(jref.mha_attention(jq, jk, jv, causal=causal, q_offset=offset,
                                         kv_len=jnp.asarray(kv_len)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy()[empty], 0.0)
    np.testing.assert_allclose(out.numpy()[~empty], want[~empty], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jimpl,timpl", ROUTES)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_model_paths_match_jax(arch, jimpl, timpl):
    jcfg, tcfg = _pair_cfgs(arch, jimpl, timpl)
    jp, tp = _pair_params(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, size=(2, 12))

    jl, jaux = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks))
    tl, aux = tmodel.forward(tp, tcfg, tokens=torch.from_numpy(toks))
    _close_model(arch, tl, jl)
    if tcfg.moe_experts:
        _close(aux, jaux)
    else:
        assert float(aux) == 0.0

    jcache = jmodel.init_cache(jcfg, 2, 32)
    tcache = tmodel.init_cache(tcfg, 2, 32, device="cpu")
    jl, jcache = jmodel.prefill(jp, jcfg, tokens=jnp.asarray(toks), cache=jcache)
    tl, tcache = tmodel.prefill(tp, tcfg, tokens=torch.from_numpy(toks), cache=tcache)
    _close_model(arch, tl, jl)
    _caches_close(arch, tcache, jcache)

    for step, nxt in enumerate(([[3], [5]], [[7], [11]])):
        jl, jcache = jmodel.decode_step(jp, jcfg, token=jnp.asarray(nxt), cache=jcache,
                                        cache_len=jnp.int32(12 + step))
        tl, tcache = tmodel.decode_step(tp, tcfg, token=torch.tensor(nxt), cache=tcache,
                                        cache_len=12 + step)
        _close_model(arch, tl, jl)
    _caches_close(arch, tcache, jcache)


def _caches_close(arch, tcache, jcache) -> None:
    """Every cache leaf (attention k/v, Mamba conv/ssm) equal, dtypes too."""
    got, want = _flat(tcache), _flat(jcache)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert str(leaf.dtype).split(".")[-1] == str(want[key].dtype), key
        _close_model(arch, leaf, want[key])


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS if a != "mamba2-1.3b"])
def test_cache_max_len_matches_jax(arch):
    """``transformer.cache_max_len`` of an abstract cache, as the reference's."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer

    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    got = transformer.cache_max_len(tmodel.abstract_cache(cfg, 2, 48))
    assert got == jtransformer.cache_max_len(jmodel.abstract_cache(jcfg, 2, 48)) == 48


def test_bf16_serving_params_carry_over_exactly():
    """A bf16 JAX tree (ml_dtypes leaves) and an f32 tree cast with
    ``dtype=`` give the same bf16 tensors, and the model runs on them."""
    cfg = configs.get_smoke("qwen1.5-4b")
    jcfg = jconfigs.get_smoke("qwen1.5-4b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    from_bf16 = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp), "cpu")
    cast = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                     dtype=torch.bfloat16)
    for a, b in zip(sharding.leaves(from_bf16), sharding.leaves(cast)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    bcfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    logits, _ = tmodel.forward(cast, bcfg, tokens=torch.tensor([[1, 2, 3]]))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
ENGINE_SETUPS = [
    # (arch, slots, max_len, prompt lengths, max_new) — tests/test_system.py's
    # two setups; the batching one on a ported dense config
    ("qwen1.5-4b", 2, 64, [12], 6),
    ("minicpm-2b", 3, 48, [8] * 7, 4),
    ("starcoder2-15b", 2, 64, [5, 13, 9], 5),
    # the reference's Mamba decode needs prompts of 3 tokens or more (C.8);
    # a reused slot must start from its new prompt's state
    ("mamba2-1.3b", 2, 48, [3, 17, 9, 5], 5),
    ("grok-1-314b", 2, 48, [5, 13, 9], 4),
    ("jamba-1.5-large-398b", 2, 48, [7, 20, 4], 4),
]


@pytest.mark.parametrize("timpl", ["ref", "cuda"])
@pytest.mark.parametrize("arch,slots,max_len,lens,max_new", ENGINE_SETUPS)
def test_serve_engine_tokens_match_jax(arch, slots, max_len, lens, max_new, timpl):
    jcfg, tcfg = _pair_cfgs(arch, "ref", timpl)
    jp, tp = _pair_params(jcfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in lens]
    jeng = JServeEngine(jcfg, jp, batch_slots=slots, max_len=max_len)
    teng = ServeEngine(tcfg, tp, batch_slots=slots, max_len=max_len)
    for uid, prompt in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        teng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = teng.run()
    assert {r.uid: r.tokens for r in got} == want
    assert all(len(r.margins) == len(r.tokens) == max_new for r in got)
    assert all(m >= 0 for r in got for m in r.margins)


def test_serve_engine_matches_manual_greedy():
    cfg = configs.get_smoke("qwen1.5-4b")
    params = tmodel.init_params(cfg, 0, "cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=12)
    engine = ServeEngine(cfg, params, batch_slots=2, max_len=64, keep_prefill_logits=True)
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    res = engine.run()[0]
    toks = torch.as_tensor(prompt)[None]
    want = []
    for i in range(6):
        logits, _ = tmodel.forward(params, cfg, tokens=toks)
        if i == 0:
            torch.testing.assert_close(res.prefill_logits, logits[0, -1, : cfg.vocab],
                                       rtol=TOL, atol=TOL)
        nxt = int(torch.argmax(logits[0, -1, : cfg.vocab]))
        want.append(nxt)
        toks = torch.cat([toks, torch.tensor([[nxt]])], dim=1)
    assert res.tokens == want


def test_temperature_sampling_is_seeded():
    cfg = configs.get_smoke("minicpm-2b")
    params = tmodel.init_params(cfg, 0, "cpu")
    prompt = np.arange(6)

    def run(seed):
        eng = ServeEngine(cfg, params, 1, 32, temperature=1.0, seed=seed)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
        return eng.run()[0].tokens

    assert run(3) == run(3)
    assert run(3) != run(4)


def test_launcher_serves_on_the_cpu():
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--requests", "5", "--slots", "2",
            "--prompt-len", "12,130,7", "--max-new", "4", "--max-len", "160",
            "--device", "cpu", "--keep-logits"]
    kernel = sorted(tserve.main(argv), key=lambda r: r.uid)
    oracle = sorted(tserve.main(argv + ["--attn-impl", "ref"]), key=lambda r: r.uid)
    assert [r.uid for r in kernel] == list(range(5))
    assert all(len(r.tokens) == 4 and r.prefill_logits.shape == (512,) for r in kernel)
    assert [r.tokens for r in kernel] == [r.tokens for r in oracle]
    for a, b in zip(kernel, oracle):
        torch.testing.assert_close(a.prefill_logits, b.prefill_logits, rtol=TOL, atol=TOL)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("qwen1.5-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen1.5-4b", "--smoke"])


# ---------------------------------------------------------------------------
# params: specs, init, counts, registry
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [True, False])
def test_param_tree_matches_jax_eval_shape(arch, smoke):
    jcfg = jconfigs.get_smoke(arch) if smoke else jconfigs.get(arch)
    tcfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    want = _flat(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg)))
    got = _flat(tmodel.abstract_params(tcfg))
    assert sorted(got) == sorted(want)  # JAX keeps dict keys sorted
    for key, leaf in got.items():
        assert tuple(leaf.shape) == want[key].shape, key
        assert str(leaf.dtype).split(".")[-1] == str(want[key].dtype), key
    assert tmodel.param_count(tcfg) == jmodel.param_count(jcfg)
    assert tmodel.param_count(tcfg, active_only=True) == jmodel.param_count(jcfg, active_only=True)
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_init_params_follow_the_reference_rule(arch):
    """Same keys, shapes and dtypes as the reference's draw; zeros and ones
    exact; every random leaf's std within 5 sampling errors of the rule's
    std (and of the reference leaf's own std)."""
    cfg = configs.get_smoke(arch)
    got = _flat(tmodel.init_params(cfg, 0, "cpu"))
    want = _flat(jmodel.init_params(jax.random.PRNGKey(0), jconfigs.get_smoke(arch)))
    specs = _flat(tmodel.param_specs(cfg))
    assert sorted(got) == sorted(want)  # JAX keeps dict keys sorted
    for key, leaf in got.items():
        spec = specs[key]
        assert tuple(leaf.shape) == want[key].shape and leaf.dtype == torch.float32
        std = sharding.init_std(spec)
        if std is None:
            fill = 0.0 if spec.init == "zeros" else 1.0
            assert bool((leaf == fill).all()), key
            continue
        n = leaf.numel()
        err = 5 * std / math.sqrt(2 * n)
        assert abs(float(leaf.std()) - std) < err, key
        assert abs(float(np.asarray(want[key]).std()) - std) < err, key
        assert abs(float(leaf.mean())) < 5 * std / math.sqrt(n), key
    # adding a leaf never reshuffles the others: the seed is per path
    again = _flat(sharding.materialize(0, {"extra": specs["/tok/embed"],
                                           **tmodel.param_specs(cfg)}, torch.float32, "cpu"))
    drawn = [k for k, spec in specs.items() if k.startswith("/blocks/") and spec.init == "fan_in"]
    assert drawn and all(torch.equal(again[k], got[k]) for k in drawn)


def test_cache_specs_and_registry():
    cfg = configs.get_smoke("starcoder2-15b")
    cache = tmodel.init_cache(cfg, 1, 40, device="cpu")
    assert tuple(cache["attn"]["k"].shape) == (3, 1, 1, 40, 2, 8)
    assert not cache["attn"]["v"].any()
    assert configs.get("grok-1-314b").family == "moe"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("grok-2")
    with pytest.raises(ValueError, match="rwkv"):
        tmodel.param_specs(dataclasses.replace(cfg, family="rwkv"))
    ssm = tmodel.init_cache(configs.get_smoke("mamba2-1.3b"), 1, 40, device="cpu")
    assert sorted(ssm) == ["mamba"]
    assert tuple(ssm["mamba"]["ssm"].shape) == (3, 1, 1, 8, 16, 16)
    assert ssm["mamba"]["ssm"].dtype == torch.float32 and not ssm["mamba"]["ssm"].any()
    assert layers.dtype_of("bfloat16") is torch.bfloat16
    assert layers.padded_vocab(122753) == 122880 and layers.padded_vocab(151936) == 151936
