"""The port on a 2 x 2 (data, model) mesh against the port on one device.

Imports no JAX, so it runs wherever torch does; DTensor's operator
coverage differs between torch releases, so run it on the torch a mesh
will train on:

    PYTHONPATH=src python -m pytest -q tests/test_torch_tp_worlds.py

One spawned gloo world of 4 CPU ranks (``torch_ranks.run_ranks``) runs,
under ``sharding_ctx`` with ``BASE_RULES``, each against the same work on
one device in the same rank:

* ``shard`` on a None axis and on one its mesh axes do not divide:
  ``Replicate()`` there, as the reference's ``logical_pspec`` resolves them;
* the forward of all ten LM smoke configs, params drawn straight into
  their ``param_shardings``: logits and aux at rtol = atol = 1e-5 (f32
  sums in another order); jamba's logits within 1e-5 of their largest
  magnitude, as ``tests/test_torch_lm.py`` holds them (they read 2.3e-5
  at a largest logit of 4.0);
* one train step of the MoE, Mamba2, hybrid, MoE-interleaved and
  embedding-input smoke configs: the gradients the step hands its
  optimizer (its ``grad_transform`` hook) leaf by leaf within 1e-5 of the
  leaf's largest magnitude (jamba 5e-5: its gradients, norm 35, read up
  to 1.1e-5, and its f32 logits already sit 1.3e-5 from an f64 evaluation
  on one device, ``tests/test_torch_lm.py``; a missing or doubled sum over
  a mesh dim reads 0.5 or more), ``grad_norm`` and the loss at rtol 1e-4, the
  params after the Adam step at lr 1e-3 within atol 5e-4 (the update moves
  an element by about 1e-3 whatever its gradient: a zero or sign-flipped
  gradient reads 1e-3 or more, a sound run at most 2.7e-4 where a gradient
  is near Adam's eps); each gradient in its master's placements and local
  shape, reduced over ``data`` before the optimizer sees it; grok-1's and
  llama4-maverick's step also under ``FSDP_RULES`` (expert, attention and
  embedding leaves split over ``data``);
* a vocab-sharded ``embed_lookup`` and its gradient (the lookup bitwise,
  the gradient to 1e-6, left a ``Partial`` sum over ``data`` for the train
  step's layout step);
* prefill then DECODE_TOKENS greedy tokens of qwen1.5-4b's and minicpm-2b's
  smoke configs (f32) through ``train.step``'s prefill and decode steps,
  the cache laid out by ``cache_shardings`` three ways: ``batch`` (the
  base rules: batch on ``data``, KV heads on ``model``), ``kv_seq`` (the
  serving rules of ``effective_rules``: the cache's length on ``model``)
  and ``long`` (the long-context rules at batch 1: the length on ``data``
  through ``long_kv``, the heads on ``model``): the logits at rtol = atol
  = 1e-5, the tokens equal, and the cache still in its layout after the
  last token.  The prompt fills 14 of 32 positions, so on a split length
  the first tokens find the second piece empty and the later ones in use;
* decode attention against a cache split over its length, with a
  ``kv_len`` in each row that leaves the second piece empty (3, 16), or
  not (17, 32): at 1e-6 of the oracle on one device;
* ``softmax_xent`` of vocab-split logits [4, 6, 256] with ``valid_vocab``
  200: the loss and the logits' gradient (in the logits' layout) at
  rtol = atol = 1e-6 of one device's autograd;
* ``launch.train --mesh 2x2`` with int8 and top-k gradient compression,
  against the one-device launcher (run here) after 3 steps: the losses at
  rtol 1e-4 (the second and third read the updated params) and the params
  within atol 5e-4 (a step at lr 3e-3 moves an element by about 3e-3).
"""
import json

import numpy as np
import pytest
from torch_ranks import run_ranks

from repro_torch import configs
from repro_torch.launch import train as tlaunch
from repro_torch.optim import optimizers as toptim

LOSS_RTOL, PARAM_ATOL, FWD_REL, GRAD_REL, EMBED_GRAD_TOL = 1e-4, 5e-4, 1e-5, 1e-5, 1e-6
DECODE_ARCHS, DECODE_LAYOUTS, DECODE_TOL = ("qwen1.5-4b", "minicpm-2b"), ("batch", "kv_seq",
                                                                         "long"), 1e-5
EMPTY_TOL, XENT_TOL = 1e-6, 1e-6
JAMBA, JAMBA_GRAD_REL = "jamba-1.5-large-398b", 5e-5  # f32 sums sensitive to their order
STEP_ARCHS = ("grok-1-314b", "mamba2-1.3b", "jamba-1.5-large-398b",
              "llama4-maverick-400b-a17b", "musicgen-medium")
FSDP_STEP_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")  # the expert leaves
COMPRESSORS = ("int8", "topk")
LAUNCH = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
          "--steps", "3", "--lr", "3e-3", "--log-every", "100"]

WORLD_BODY = """
import json

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import NamedSharding, PartitionSpec
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention, layers, model
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib

DECODE_TOKENS, DECODE_PROMPT, DECODE_MAX_LEN = 4, 14, 32


def inputs(cfg, batch, seq):
    rng = np.random.default_rng(1)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)))
    if cfg.input_kind == "embeddings":
        return {"embeds": torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32)), "labels": labels}
    return {"tokens": labels, "labels": torch.roll(labels, -1, 1)}


def forward(mesh, rules, arch, res):
    cfg = configs.get_smoke(arch)
    data = inputs(cfg, 4, 16)
    name = "embeds" if "embeds" in data else "tokens"
    with torch.no_grad():
        params = model.init_params(cfg, 0, "cpu")
        want, want_aux = model.forward(params, cfg, **{name: data[name]})
        pd = model.init_params(cfg, 0, "cpu", step_lib.param_shardings(mesh, cfg, rules))
        for a, b in zip(optimizers.tree_leaves(params), optimizers.tree_leaves(pd)):
            assert torch.equal(a, b.full_tensor())  # drawn straight into the layout
        xd = sharding.distribute(data[name], step_lib.batch_shardings(
            mesh, cfg, {name: data[name]}, rules)[name])
        with sharding.sharding_ctx(mesh, rules):
            got, aux = model.forward(pd, cfg, **{name: xd})
    res["fwd/" + arch] = got.full_tensor().numpy()
    res["fwd_want/" + arch] = want.numpy()
    res["aux/" + arch] = np.array([float(sharding.replicate(aux)), float(want_aux)])


def layout(tree):
    return {k: [str(list(v.placements)), list(v.to_local().shape)]
            for k, v in sharding.keyed_leaves(tree).items() if sharding.is_dtensor(v)}


def train_step(cfg, params, state, batch, opt):
    grads, laid = {}, {}
    masters = layout(params)

    def capture(g):  # whole copies: the update clips the gradients in place
        whole = lambda x: x.full_tensor() if sharding.is_dtensor(x) else x
        laid.update({k: v for k, v in layout(g).items() if v != masters[k]})
        grads.update(sharding.keyed_leaves(optimizers.tree_map(lambda x: whole(x).clone(), g)))
        return g

    params, _, metrics = step_lib.make_train_step(cfg, opt, capture)(params, state, batch)
    return params, {k: float(v) for k, v in metrics.items()}, grads, laid


def step(mesh, rules, arch, res, prefix=""):
    cfg = configs.get_smoke(arch)
    batch = inputs(cfg, 4, 16)
    opt = optimizers.adamw(1e-3, max_grad_norm=1.0)
    p1 = model.init_params(cfg, 0, "cpu")
    p1, m1, g1, _ = train_step(cfg, p1, opt.init(p1), batch, opt)
    p2 = model.init_params(cfg, 0, "cpu", step_lib.param_shardings(mesh, cfg, rules))
    state = sharding.device_put(opt.init(p2), step_lib.opt_shardings(mesh, cfg, rules))
    bd = sharding.device_put(batch, step_lib.batch_shardings(mesh, cfg, batch, rules))
    with sharding.sharding_ctx(mesh, rules):
        p2, m2, g2, laid = train_step(cfg, p2, state, bd, opt)
    key = prefix + arch
    # per leaf: (max |mesh - one device|, max |one device|)
    res["grads/" + key] = np.array(json.dumps(
        {k: [float((g2[k] - g1[k]).abs().max()), float(g1[k].abs().max())] for k in g1}))
    res["metrics/" + key] = np.array(json.dumps({"mesh": m2, "one": m1}))
    # the gradients the hook saw that are not laid out as their masters
    res["grad_layout/" + key] = np.array(json.dumps(laid))
    res["param_err/" + key] = np.array(max(
        float((a - b.full_tensor()).abs().max())
        for a, b in zip(optimizers.tree_leaves(p1), optimizers.tree_leaves(p2))))


def embed(mesh, rules, res):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((256, 8), dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, 256, (4, 6)))
    cot = torch.from_numpy(rng.standard_normal((4, 6, 8), dtype=np.float32))
    t1 = table.clone().requires_grad_()
    y1 = layers.embed_lookup({"embed": t1}, tokens, torch.float32)
    (y1 * cot).sum().backward()
    td = sharding.distribute(table, NamedSharding(mesh, PartitionSpec("model", None)))
    td.requires_grad_()
    with sharding.sharding_ctx(mesh, rules):
        tok = sharding.distribute(tokens, NamedSharding(mesh, PartitionSpec("data", None)))
        y2 = layers.embed_lookup({"embed": td}, tok, torch.float32)
        (y2 * cot).sum().backward()
    res["embed"] = y2.detach().full_tensor().numpy()
    res["embed/want"] = y1.detach().numpy()
    res["embed/grad"] = td.grad.full_tensor().numpy()
    res["embed/grad_want"] = t1.grad.numpy()
    res["embed/layouts"] = np.array(json.dumps([[
        "partial" if p.is_partial() else p.dim if p.is_shard() else None for p in t.placements]
        for t in (td, td.grad)]))


def decode_layout(mesh, cfg, label):
    # (rules, batch, long_ctx): "batch" the base rules, "kv_seq" and "long"
    # the serving rules effective_rules makes at batch 4 and at batch 1
    # (which the data axis cannot split)
    if label == "batch":
        return sharding.BASE_RULES, 4, False
    batch = 4 if label == "kv_seq" else 1
    rules = step_lib.effective_rules(mesh, ShapeConfig("decode", DECODE_MAX_LEN, batch, "decode"),
                                     sharding.BASE_RULES, cfg)
    return rules, batch, rules["batch"] is None


def greedy(cfg, params, cache, tokens, put=lambda t: t, whole=lambda t: t):
    # prefill, then DECODE_TOKENS greedy tokens: (the last position's logits
    # of each step [DECODE_TOKENS + 1, B, V], the tokens, the cache)
    prefill, decode = step_lib.make_prefill_step(cfg), step_lib.make_decode_step(cfg)
    logits, cache = prefill(params, cache, {"tokens": put(tokens)})
    out, toks = [whole(logits)[:, -1]], []
    for i in range(DECODE_TOKENS):
        toks.append(out[-1].argmax(-1)[:, None])
        logits, cache = decode(params, cache, {"tokens": put(toks[-1])}, tokens.shape[1] + i)
        out.append(whole(logits)[:, -1])
    return torch.stack(out), torch.cat(toks, 1), cache


def decode_run(mesh, arch, label, res):
    cfg = configs.get_smoke(arch)
    rules, batch, long_ctx = decode_layout(mesh, cfg, label)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab,
                                                                (batch, DECODE_PROMPT)))
    with torch.no_grad():
        want, want_tok, _ = greedy(cfg, model.init_params(cfg, 0, "cpu"), model.init_cache(
            cfg, batch, DECODE_MAX_LEN, long_ctx, device="cpu"), tokens)
    params = model.init_params(cfg, 0, "cpu", step_lib.param_shardings(mesh, cfg, rules))
    layout = step_lib.cache_shardings(mesh, cfg, batch, DECODE_MAX_LEN, long_ctx, rules)
    cache = sharding.device_put(model.init_cache(cfg, batch, DECODE_MAX_LEN, long_ctx,
                                                 device="cpu"), layout)
    put = step_lib.batch_shardings(mesh, cfg, {"tokens": 0}, rules)["tokens"]
    with sharding.sharding_ctx(mesh, rules):
        got, got_tok, cache = greedy(cfg, params, cache, tokens,
                                     lambda t: sharding.distribute(t, put),
                                     lambda t: t.full_tensor())
    key = f"{arch}/{label}"
    res["decode/" + key] = got.numpy()
    res["decode_want/" + key] = want.numpy()
    res["decode_tokens/" + key] = np.array([got_tok.numpy(), want_tok.numpy()])
    res["decode_layout/" + key] = np.array(json.dumps({
        name: [[p.dim if p.is_shard() else None for p in cache["attn"][name].placements],
               [p.dim if p.is_shard() else None for p in layout["attn"][name].placements]]
        for name in ("k", "v")}))


def empty_piece(mesh, res):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((4, 1, 4, 8), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 32, 2, 8), dtype=np.float32))
            for _ in "kv")
    kv_len = torch.tensor([3, 16, 17, 32], dtype=torch.int32)  # pieces [0, 16) and [16, 32)
    want = ops.attention(q, k, v, impl="ref", causal=False, kv_len=kv_len)
    layout = NamedSharding(mesh, PartitionSpec(None, "data", "model", None))
    with sharding.sharding_ctx(mesh, sharding.BASE_RULES):
        qd = sharding.distribute(q, NamedSharding(mesh, PartitionSpec(None, None, "model", None)))
        got = attention._attend(qd, sharding.distribute(k, layout),
                                sharding.distribute(v, layout), "ref", causal=False,
                                kv_len=kv_len)
    res["empty"] = got.full_tensor().numpy()
    res["empty/want"] = want.numpy()


def xent(mesh, res):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((4, 6, 256), dtype=np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, 200, (4, 6)))
    l1 = logits.clone().requires_grad_()
    loss1 = layers.softmax_xent(l1, labels, valid_vocab=200)
    loss1.backward()
    ld = sharding.distribute(logits, NamedSharding(mesh, PartitionSpec("data", None, "model")))
    ld.requires_grad_()
    with sharding.sharding_ctx(mesh, sharding.BASE_RULES):
        lab = sharding.distribute(labels, NamedSharding(mesh, PartitionSpec("data", None)))
        loss2 = layers.softmax_xent(ld, lab, valid_vocab=200)
        loss2.backward()
    res["xent"] = np.array([float(loss2.detach().full_tensor()), float(loss1.detach())])
    res["xent/grad"] = ld.grad.full_tensor().numpy()
    res["xent/grad_want"] = l1.grad.numpy()
    res["xent/layouts"] = np.array(json.dumps([[p.dim if p.is_shard() else None
                                                for p in t.placements]
                                               for t in (ld.grad, loss2)]))


def shard_rules(mesh, rules, res):
    # a None axis, and 'mlp' on 3 rows that 'model' (2) does not divide,
    # resolve to Replicate(); 'batch' on 4 rows to Shard(0) on 'data'
    x = sharding.distribute(torch.arange(12.0).reshape(4, 3),
                            NamedSharding(mesh, PartitionSpec(None, "model")))
    out = {}
    with sharding.sharding_ctx(mesh, rules):
        for axes in ((None, "mlp"), ("batch", None), ("batch", "mlp")):
            y = sharding.shard(x, *axes)
            assert torch.equal(y.full_tensor(), x.full_tensor())
            out[repr(axes)] = [p.dim if p.is_shard() else None for p in y.placements]
    res["shard"] = np.array(json.dumps(out))


def main():
    mesh = make_debug_mesh(2, 2, device="cpu")
    rules = sharding.BASE_RULES
    res = {}
    shard_rules(mesh, rules, res)
    for arch in configs.ARCH_IDS:
        forward(mesh, rules, arch, res)
    for arch in STEP_ARCHS:
        step(mesh, rules, arch, res)
    for arch in FSDP_STEP_ARCHS:
        step(mesh, sharding.FSDP_RULES, arch, res, "fsdp/")
    embed(mesh, rules, res)
    empty_piece(mesh, res)
    xent(mesh, res)
    for arch in DECODE_ARCHS:
        for label in DECODE_LAYOUTS:
            decode_run(mesh, arch, label, res)
    for comp in COMPRESSORS:
        run = launcher.run(LAUNCH + ["--grad-compress", comp, "--mesh", "2x2"])
        res["losses/" + comp] = np.array(run.losses)
        res.update(flatten({"launch": {comp: optimizers.tree_map(lambda x: x.full_tensor(),
                                                                 run.params)}}))
    if RANK == 0:
        np.savez(os.path.join(OUT, "world.npz"), **res)
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + k + "/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_2x2")
    body = (f"STEP_ARCHS = {STEP_ARCHS!r}\nFSDP_STEP_ARCHS = {FSDP_STEP_ARCHS!r}\n"
            f"COMPRESSORS = {COMPRESSORS!r}\n"
            f"LAUNCH = {LAUNCH!r}\nDECODE_ARCHS = {DECODE_ARCHS!r}\n"
            f"DECODE_LAYOUTS = {DECODE_LAYOUTS!r}\n" + WORLD_BODY)
    run_ranks(out, 4, body)
    return dict(np.load(out / "world.npz"))


def test_shard_replicates_none_and_indivisible_axes(world):
    # each mesh dim (data, model): the tensor dim it splits, None where replicated
    assert json.loads(str(world["shard"])) == {
        "(None, 'mlp')": [None, None], "('batch', None)": [0, None],
        "('batch', 'mlp')": [0, None]}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_2x2_matches_one_device(world, arch):
    got, want = world["fwd/" + arch], world["fwd_want/" + arch]
    assert got.shape == want.shape and np.isfinite(got).all()
    if arch == JAMBA:
        assert np.abs(got - want).max() <= FWD_REL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=FWD_REL, atol=FWD_REL)
    aux, want_aux = world["aux/" + arch]
    assert aux == pytest.approx(want_aux, rel=FWD_REL, abs=FWD_REL)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_2x2_gradients_match_one_device(world, arch):
    _step_matches_one_device(world, arch, JAMBA_GRAD_REL if arch == JAMBA else GRAD_REL)


@pytest.mark.parametrize("arch", FSDP_STEP_ARCHS)
def test_fsdp_train_step_2x2_gradients_match_one_device(world, arch):
    """Under ``FSDP_RULES``: the expert, attention and embedding leaves
    split over ``data`` as well, each gradient reduce-scattered onto its
    master's shard."""
    _step_matches_one_device(world, "fsdp/" + arch, GRAD_REL)


def _step_matches_one_device(world, key: str, rel: float) -> None:
    grads = json.loads(str(world["grads/" + key]))
    assert any(scale > 0 for _, scale in grads.values())
    for leaf, (err, scale) in grads.items():  # an unread leaf's is 0 on both
        assert err <= rel * scale, (leaf, err, scale)
    metrics = json.loads(str(world["metrics/" + key]))
    for name in ("loss", "grad_norm"):
        assert metrics["mesh"][name] == pytest.approx(metrics["one"][name], rel=LOSS_RTOL)
    assert float(world["param_err/" + key]) <= PARAM_ATOL
    # every gradient the optimizer gets is laid out as its master
    assert json.loads(str(world["grad_layout/" + key])) == {}


def test_vocab_sharded_embed_lookup_and_grad_match_one_device(world):
    np.testing.assert_array_equal(world["embed"], world["embed/want"])
    np.testing.assert_allclose(world["embed/grad"], world["embed/grad_want"],
                               rtol=EMBED_GRAD_TOL, atol=EMBED_GRAD_TOL)
    # the table: vocab (dim 0) on 'model', replicated on 'data'; its gradient
    # the same on 'model' and a sum over the token shards on 'data', which
    # the train step's layout step reduces once with the unembedding's share
    # of a tied table
    assert json.loads(str(world["embed/layouts"])) == [[None, 0], ["partial", 0]]


@pytest.mark.parametrize("label", DECODE_LAYOUTS)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_2x2_matches_one_device(world, arch, label):
    key = f"{arch}/{label}"
    got, want = world["decode/" + key], world["decode_want/" + key]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
    tokens, want_tokens = world["decode_tokens/" + key]
    np.testing.assert_array_equal(tokens, want_tokens)
    # the cache is still laid out as cache_shardings put it: never replicated
    for name, (after, laid) in json.loads(str(world["decode_layout/" + key])).items():
        assert after == laid, (name, after, laid)
    # stacked [blocks, layers, B, S, KV, hd] over (data, model)
    assert laid == {"batch": [2, 4], "kv_seq": [2, 3], "long": [3, 4]}[label]


def test_decode_attention_with_an_empty_kv_piece_matches_one_device(world):
    got, want = world["empty"], world["empty/want"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EMPTY_TOL, atol=EMPTY_TOL)


def test_vocab_parallel_xent_and_grad_match_one_device(world):
    loss, want = world["xent"]
    assert loss == pytest.approx(want, rel=XENT_TOL, abs=XENT_TOL)
    np.testing.assert_allclose(world["xent/grad"], world["xent/grad_want"], rtol=XENT_TOL,
                               atol=XENT_TOL)
    # the gradient in the logits' layout (batch on data, vocab on model), the
    # loss replicated
    assert json.loads(str(world["xent/layouts"])) == [[0, 2], [None, None]]


@pytest.mark.parametrize("comp", COMPRESSORS)
def test_launcher_compressed_2x2_matches_one_device(world, comp):
    run = tlaunch.run(LAUNCH + ["--grad-compress", comp])
    np.testing.assert_allclose(world["losses/" + comp], run.losses, rtol=LOSS_RTOL)
    want = _flat({"launch": {comp: toptim.tree_map(lambda x: x.numpy(), run.params)}})
    for k in want:
        np.testing.assert_allclose(world[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
