"""The port's LM training slice (``optim.schedules``, the in-place Adam,
``data.pipeline``, ``models.model.loss_fn``, ``remat``, ``train.step``,
``dist.grad_compress``, ``launch.train``) against the JAX package, on the
CPU.

Weights come from the reference's ``init_params`` through ``convert``;
batches from the pipeline's numpy seeds.  Tolerances, set from f32: the
schedules to rtol 1e-6; the loss to rtol 1e-5; each gradient, parameter
and moment to atol 1e-5 + rtol 1e-4 of its leaf's largest value.  The
pipeline, the int8 compressor and the in-place update are held bitwise.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.dist import grad_compress as jgc
from repro.models import model as jmodel
from repro.optim import optimizers as joptim
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch import configs, convert
from repro_torch.configs.base import SHAPES
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import grad_compress as tgc
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as toptim
from repro_torch.optim import schedules as tsched
from repro_torch.train import step as tstep

ARCH = "minicpm-2b"
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_close(got: torch.Tensor, want, where: str = "") -> None:
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=GRAD_ATOL + GRAD_RTOL * scale, err_msg=where)


def _tree_close(got: dict, want: dict, where: str = "") -> None:
    for key in want:
        if isinstance(want[key], dict):
            _tree_close(got[key], want[key], f"{where}/{key}")
        else:
            _leaf_close(got[key], want[key], f"{where}/{key}")


def _batch(cfg, b=2, s=16, step=0, seed=0):
    src = jpipe.SyntheticSource(jpipe.PipelineConfig(batch_size=b, seq_len=s,
                                                     vocab=cfg.vocab, seed=seed))
    return src.batch_at(step)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(arch=ARCH):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.params_from_numpy(_np(jp), "cpu")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
SCHEDULES = [
    ("constant", (3e-4,), {}),
    ("cosine", (1e-3, 100), {"warmup": 10}),
    ("cosine", (3e-3, 37), {"warmup": 0, "min_ratio": 0.2}),
    ("wsd", (1e-3, 100), {"warmup": 10}),
    ("wsd", (3e-4, 8), {"warmup": 0}),
    ("wsd", (2e-3, 50), {"warmup": 5, "decay_frac": 0.3, "min_ratio": 0.05}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedule_matches_reference_at_every_step(name, args, kw):
    js, ts = getattr(jsched, name)(*args, **kw), getattr(tsched, name)(*args, **kw)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.array([float(js(jnp.asarray(s))) for s in steps])
    got = np.array([float(ts(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert ts(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,rank,world,step", [(0, 0, 1, 0), (7, 1, 2, 3), (3, 2, 4, 11),
                                                  (1, 0, 8, 250)])
def test_synthetic_batches_bitwise_the_reference(seed, rank, world, step):
    cfg = dict(batch_size=4, seq_len=32, vocab=1000, seed=seed, rank=rank, world=world)
    want = jpipe.SyntheticSource(jpipe.PipelineConfig(**cfg)).batch_at(step)
    got = tpipe.SyntheticSource(tpipe.PipelineConfig(**cfg)).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_ranks_disjoint_and_next_token_labels():
    mk = lambda r: tpipe.SyntheticSource(tpipe.PipelineConfig(  # noqa: E731
        batch_size=4, seq_len=32, vocab=100, seed=7, rank=r, world=2))
    a, c = mk(0).batch_at(3), mk(1).batch_at(3)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_mmap_source_bitwise_the_reference(tmp_path):
    toks = np.random.default_rng(0).integers(0, 50, size=10000).astype(np.int32)
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tpipe.write_corpus(tpath, toks)
    jpipe.write_corpus(jpath, toks)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for rank in (0, 1):
        cfg = dict(batch_size=3, seq_len=64, vocab=50, seed=1, rank=rank, world=2)
        tsrc = tpipe.MMapSource(tpath, tpipe.PipelineConfig(**cfg))
        jsrc = jpipe.MMapSource(jpath, jpipe.PipelineConfig(**cfg))
        for step in (0, 5):
            got, want = tsrc.batch_at(step), jsrc.batch_at(step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    r0 = tpipe.MMapSource(tpath, tpipe.PipelineConfig(3, 64, 50, 1, 0, 2)).batch_at(2)
    r1 = tpipe.MMapSource(tpath, tpipe.PipelineConfig(3, 64, 50, 1, 1, 2)).batch_at(2)
    assert not np.array_equal(r0["tokens"], r1["tokens"])


# ---------------------------------------------------------------------------
# loss, gradients, remat
# ---------------------------------------------------------------------------
def _ref_loss_and_grads(jcfg, jp, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch), has_aux=True)(jp)
    return float(loss), metrics, _np(grads)


def test_loss_and_gradients_match_reference():
    jcfg, tcfg, jp, tp = _pair()
    batch = _batch(jcfg)
    want_loss, want_m, want_g = _ref_loss_and_grads(jcfg, jp, batch)
    (loss, metrics), grads = tstep.value_and_grad(
        lambda p, b: tmodel.loss_fn(p, tcfg, b), tp, _tbatch(batch))
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert float(metrics["xent"]) == pytest.approx(float(want_m["xent"]), rel=LOSS_RTOL)
    assert float(metrics["aux"]) == 0.0
    _tree_close(grads, want_g, "grads")


@pytest.mark.parametrize("attn_impl,b,seq", [("ref", 2, 24), ("chunked", 1, 520)])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_modes_agree_with_none(remat, attn_impl, b, seq):
    """The oracle route, and the q-chunked one at 520 tokens (one 512-row
    chunk, rematerialised inside the block's own remat, and a tail of 8)."""
    _, tcfg, _, tp = _pair()
    batch = _tbatch(_batch(tcfg, b=b, s=seq))
    runs = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(tcfg, remat=mode, attn_impl=attn_impl)
        runs[mode] = tstep.value_and_grad(lambda p, b: tmodel.loss_fn(p, cfg, b), tp, batch)
    (l0, _), g0 = runs["none"]
    (l1, _), g1 = runs[remat]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recompute_runs_under_the_forwards_sharding_context(remat):
    """A CUDA backward runs on autograd's device thread, where the
    sharding context of the forward's thread (a thread-local) is not set:
    the block's recompute must run under the forward's, or its ``shard``
    constraints lay its activations out otherwise (minicpm-2b at full
    width on a (data 2, model 1) mesh of gloo ranks on an H100 under
    ``FSDP_RULES`` recomputed a batch of 8 where the forward had 4)."""
    import threading

    from repro_torch.dist import sharding
    from repro_torch.models import transformer

    seen = []

    def block(x):
        seen.append(sharding.current_ctx())
        return (x.sin() * x.cos()).sum()

    body = transformer._remat_wrap(block, dataclasses.replace(configs.get_smoke(ARCH),
                                                              remat=remat))
    x = torch.ones(3, requires_grad=True)
    mesh = object()
    with sharding.sharding_ctx(mesh, sharding.FSDP_RULES):
        y = body(x)
    thread = threading.Thread(target=lambda: torch.autograd.grad(y, x))
    thread.start()
    thread.join()
    assert len(seen) == 2 and seen[1] is not None and seen[1][0] is mesh
    assert seen[1] == seen[0]


def test_remat_rejects_unknown_policy():
    _, tcfg, _, tp = _pair()
    cfg = dataclasses.replace(tcfg, remat="some")
    with pytest.raises(ValueError):
        tmodel.loss_fn(tp, cfg, _tbatch(_batch(tcfg)))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _opts():
    kw = dict(weight_decay=0.1, max_grad_norm=0.5)
    return (joptim.adamw(jsched.wsd(3e-3, 6, warmup=1), **kw),
            toptim.adamw(tsched.wsd(3e-3, 6, warmup=1), **kw))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_three_train_steps_match_reference(compute):
    jcfg, tcfg, jp, tp = _pair()
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute)
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute, remat="dots")
    jopt, topt = _opts()
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt))
    tfn = tstep.make_train_step(tcfg, topt)
    for s in range(3):
        batch = _batch(jcfg, step=s)
        jp, jstate, jm = jfn(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tm = tfn(tp, tstate, _tbatch(batch))
        rel = LOSS_RTOL if compute == "float32" else 1e-2
        for k in ("loss", "xent", "aux", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel, abs=1e-7), (s, k)
    if compute == "float32":
        _tree_close(tp, _np(jp), "params")
        _tree_close(tstate.mu, _np(jstate.mu), "mu")
        _tree_close(tstate.nu, _np(jstate.nu), "nu")
    assert int(tstate.step) == int(jstate.step) == 3


def test_in_place_step_bitwise_the_out_of_place_step():
    """The step (in place) against the same step built out of place from
    ``value_and_grad``, ``update`` and ``apply_updates``."""
    _, tcfg, _, tp = _pair()
    assert tcfg.compute_dtype == tcfg.param_dtype  # no compute copy to make
    _, topt = _opts()
    clone = lambda t: toptim.tree_map(torch.clone, t)  # noqa: E731
    pa, pb = clone(tp), clone(tp)
    sa, sb = topt.init(pa), topt.init(pb)

    def fa(params, state, batch):
        (loss, metrics), grads = tstep.value_and_grad(
            lambda p, b: tmodel.loss_fn(p, tcfg, b), params, batch)
        metrics = {**metrics, "loss": loss, "grad_norm": toptim.global_norm(grads)}
        updates, state = topt.update(grads, state, params)
        return toptim.apply_updates(params, updates), state, metrics

    fb = tstep.make_train_step(tcfg, topt)
    leaves_b = toptim.tree_leaves(pb)
    for s in range(3):
        batch = _tbatch(_batch(tcfg, step=s))
        pa, sa, ma = fa(pa, sa, batch)
        pb, sb, mb = fb(pb, sb, batch)
        assert set(ma) == set(mb)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for a, b in zip(toptim.tree_leaves(pa) + toptim.tree_leaves(sa.mu) + toptim.tree_leaves(sa.nu),
                    toptim.tree_leaves(pb) + toptim.tree_leaves(sb.mu) + toptim.tree_leaves(sb.nu)):
        assert torch.equal(a, b)
    # in place: the same tensors, updated
    assert all(x is y for x, y in zip(toptim.tree_leaves(pb), leaves_b))


def test_in_place_update_groups_bitwise(monkeypatch):
    monkeypatch.setattr(toptim, "GROUP_ELEMENTS", 100)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(7, 9, generator=gen), "b": {"c": torch.randn(300, generator=gen),
                                                           "d": torch.randn(3, generator=gen)}}
    opt = toptim.adamw(tsched.cosine(1e-2, 10, warmup=2), weight_decay=0.1, max_grad_norm=1.0)
    p1, p2 = (toptim.tree_map(torch.clone, params) for _ in range(2))
    s1, s2 = opt.init(p1), opt.init(p2)
    for _ in range(4):
        grads = toptim.tree_map(lambda x: 3 * torch.randn(x.shape, generator=gen), params)
        upd, s1 = opt.update(grads, s1, p1)
        p1 = toptim.apply_updates(p1, upd)
        s2 = opt.apply_(toptim.tree_map(torch.clone, grads), s2, p2)
    for a, b in zip(toptim.tree_leaves(p1) + toptim.tree_leaves(s1.nu),
                    toptim.tree_leaves(p2) + toptim.tree_leaves(s2.nu)):
        assert torch.equal(a, b)


def test_adam_state_carries_over_from_reference():
    jcfg, tcfg, jp, tp = _pair()
    jopt, topt = _opts()
    jstate = jopt.init(jp)
    jp2, jstate, _ = jax.jit(jstep.make_train_step(jcfg, jopt))(
        jp, jstate, {k: jnp.asarray(v) for k, v in _batch(jcfg).items()})
    tstate = convert.adam_state_from_numpy(_np(jstate), "cpu")
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 1
    _tree_close(tstate.mu, _np(jstate.mu))
    # one more step from the same state in both packages
    tp2 = convert.params_from_numpy(_np(jp2), "cpu")
    batch = _batch(jcfg, step=1)
    jp3, _, jm = jax.jit(jstep.make_train_step(jcfg, jopt))(
        jp2, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp3, _, tm = tstep.make_train_step(tcfg, topt)(tp2, tstate, _tbatch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    _tree_close(tp3, _np(jp3))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_and_abstract_state_match_reference(shape):
    jcfg, tcfg = jconfigs.get(ARCH), configs.get(ARCH)
    want = jstep.input_specs(jcfg, jconfigs.SHAPES[shape])
    got = tstep.input_specs(tcfg, SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} == {
        k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in want.items()}
    js, ts = jstep.abstract_opt_state(jcfg), tstep.abstract_opt_state(tcfg)
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    from repro_torch.train.checkpoint import _flatten

    tl = _flatten(ts)
    assert [jax.tree_util.keystr(p) for p, _ in jl] and len(jl) == len(tl)
    assert [tuple(x.shape) for _, x in jl] == [tuple(t.shape) for _, t in tl]
    assert all(t.device.type == "meta" for _, t in tl)


def test_prefill_and_decode_steps_match_model():
    _, tcfg, _, tp = _pair()
    toks = torch.from_numpy(_batch(tcfg, b=2, s=8)["tokens"])
    cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    logits, cache = tstep.make_prefill_step(tcfg)(tp, cache, {"tokens": toks})
    want, _ = tmodel.prefill(tp, tcfg, tokens=toks,
                             cache=tmodel.init_cache(tcfg, 2, 16, device="cpu"))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = logits.argmax(-1).to(torch.int32)
    out, _ = tstep.make_decode_step(tcfg)(tp, cache, {"tokens": nxt}, 8)
    assert out.shape == (2, 1, logits.shape[-1]) and not out.requires_grad


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def test_int8_error_feedback_bitwise_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (17, 5), "b": {"c": (64,), "z": (3, 3)}}
    jc, tc = jgc.ErrorFeedbackInt8(), tgc.ErrorFeedbackInt8()
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
    js, ts = jc.init(zeros), tc.init(convert.params_from_numpy(zeros, "cpu"))
    for step in range(4):
        g = jax.tree.map(lambda s: (rng.standard_normal(s) * 10 ** (step - 2)).astype(np.float32),
                         shapes, is_leaf=lambda s: isinstance(s, tuple))
        if step == 3:
            g["b"]["z"] = np.zeros((3, 3), np.float32)  # scale 0 leaf
        jg, js = jc.transform(jax.tree.map(jnp.asarray, g), js)
        tg, ts = tc.transform(convert.params_from_numpy(g, "cpu"), ts)
        for a, b in zip(jax.tree.leaves(_np(jg)) + jax.tree.leaves(_np(js)),
                        toptim.tree_leaves(tg) + toptim.tree_leaves(ts)):
            np.testing.assert_array_equal(b.numpy(), a)


def test_round_half_to_even_like_jnp():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


@pytest.mark.parametrize("fraction", [0.25, 0.1, 1.0])
def test_topk_keeps_the_reference_set_ties_included(fraction):
    rng = np.random.default_rng(1)
    # many ties at the threshold: integers in [-4, 4]
    g = {"w": rng.integers(-4, 5, size=(40,)).astype(np.float32),
         "v": rng.standard_normal((6, 7)).astype(np.float32)}
    jc, tc = jgc.TopK(fraction), tgc.TopK(fraction)
    js = jc.init(jax.tree.map(jnp.asarray, g))
    ts = tc.init(convert.params_from_numpy(g, "cpu"))
    for _ in range(3):
        jg, js = jc.transform(jax.tree.map(jnp.asarray, g), js)
        tg, ts = tc.transform(convert.params_from_numpy(g, "cpu"), ts)
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy() != 0, np.asarray(jg[k]) != 0)
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    if fraction < 1:  # ties at the k-th magnitude keep more than k
        assert int((tg["w"] != 0).sum()) > int(np.ceil(40 * fraction))


def test_topk_fraction_validated():
    with pytest.raises(ValueError):
        tgc.TopK(0.0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
SMOKE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
         "--log-every", "100"]


def test_launcher_loss_decreases():
    run = tlaunch.run(SMOKE + ["--steps", "16", "--lr", "3e-3"])
    assert len(run.losses) == 16 and run.losses[-1] < run.losses[0] - 0.3, run.losses
    assert all(np.isfinite(run.losses)) and int(run.opt_state.step) == 16
    assert all(t.device.type == "cpu" for t in toptim.tree_leaves(run.params))


def test_launcher_resume_continues_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    full = tlaunch.run(SMOKE + ["--steps", "6", "--lr", "3e-3"])
    first = tlaunch.main(SMOKE + ["--steps", "6", "--lr", "3e-3", "--ckpt-dir", d,
                                  "--ckpt-every", "2"])
    # a run cut at step 4: keep only its first two checkpoints
    import shutil

    shutil.rmtree(os.path.join(d, "step_0000000006"))
    rest = tlaunch.run(SMOKE + ["--steps", "6", "--lr", "3e-3", "--ckpt-dir", d,
                                "--resume", "auto"])
    assert rest.start_step == 4 and len(rest.losses) == 2
    assert first == full.losses and rest.losses == full.losses[4:]
    for a, b in zip(toptim.tree_leaves(rest.params), toptim.tree_leaves(full.params)):
        assert torch.equal(a, b)
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000004", "step_0000000006"]


def test_launcher_sigterm_writes_final_checkpoint(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    real = tlaunch.SyntheticSource.batch_at

    def batch_at(self, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    monkeypatch.setattr(tlaunch.SyntheticSource, "batch_at", batch_at)
    before = signal.getsignal(signal.SIGTERM)
    run = tlaunch.run(SMOKE + ["--steps", "10", "--ckpt-dir", d, "--ckpt-every", "100"])
    assert run.stopped and len(run.losses) == 3 and run.last_step == 3
    assert os.listdir(d) == ["step_0000000003"]
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_launcher_with_grad_compression(method):
    losses = tlaunch.main(SMOKE + ["--steps", "12", "--lr", "3e-3", "--grad-compress", method])
    assert len(losses) == 12 and all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_launcher_mmap_data(tmp_path):
    path = str(tmp_path / "corpus.bin")
    toks = np.random.default_rng(0).integers(0, 256, size=4096).astype(np.int32)
    tpipe.write_corpus(path, toks)
    losses = tlaunch.main(SMOKE + ["--steps", "3", "--data", path])
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_launcher_refuses_a_mesh_and_a_missing_card(monkeypatch, tmp_path):
    import torch.distributed as dist

    # outside a process group: one device only
    with pytest.raises(ValueError, match="process group"):
        tlaunch.main(SMOKE + ["--steps", "1", "--mesh", "2x2"])
    # inside one: the mesh must be the group's size
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="has 4 devices; the process group has 1"):
            tlaunch.main(SMOKE + ["--steps", "1", "--mesh", "2x2"])
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in SMOKE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(argv + ["--steps", "1"])


MESH_BODY = """
from repro_torch.launch import train as launcher
from repro_torch.optim import optimizers


def main():
    run = launcher.run(ARGV)
    full = optimizers.tree_map(lambda x: x.full_tensor(), run.params)
    if RANK == 0:
        np.savez(os.path.join(OUT, "mesh.npz"), losses=np.array(run.losses), **flatten(full))
"""


def test_launcher_mesh_2x2_matches_one_device(tmp_path):
    """``--mesh 2x2`` in a 4-rank gloo world: the losses of the one-device
    launcher over 3 steps (rtol 1e-4; the second and third read the
    updated params), its params (atol 5e-4: a step at lr 3e-3 moves an
    element by about 3e-3 whatever its gradient, so a zero or flipped
    gradient reads more), and checkpoints of whole leaves that one device
    restores."""
    from torch_ranks import run_ranks

    from repro_torch.train import checkpoint as ckpt_lib

    ck = str(tmp_path / "ck")
    argv = SMOKE + ["--steps", "3", "--lr", "3e-3"]
    run_ranks(tmp_path, 4, f"ARGV = {argv + ['--mesh', '2x2', '--ckpt-dir', ck]!r}\n"
              + MESH_BODY)
    got = dict(np.load(tmp_path / "mesh.npz"))
    want = tlaunch.run(argv)
    np.testing.assert_allclose(got.pop("losses"), want.losses, rtol=1e-4)
    flat = dict(ckpt_lib._flatten(want.params))
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=5e-4, err_msg=k)
    restored, manifest = ckpt_lib.Checkpointer(ck).restore(None, {"params": want.params})
    assert manifest["step"] == 3
    for k, v in ckpt_lib._flatten(restored["params"]):
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
