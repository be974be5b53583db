"""The port's tensor-parallel LM step against the JAX package's, on the CPU.

A spawned gloo world of 8 ranks (``torch_ranks.run_ranks``) runs the
port's train step on ``DTensor`` params under ``sharding_ctx`` with
``BASE_RULES`` on a 2 x 4 (data, model) mesh: one step of minicpm-2b's
smoke config on a (8, 16) batch, from the reference's init.  It is held
against the reference's unsharded ``jax.jit(make_train_step)`` on the same
numpy params and batch (the reference's own sharded run,
``tests/test_spmd.py``, fails on JAX 0.9.0, ROADMAP C.3):

* the gradients the step hands its optimizer (each step's
  ``grad_transform`` hook), leaf by leaf within 1e-5 of the leaf's largest
  magnitude, and ``grad_norm`` and the loss at rtol 1e-4;
* the params after the step within atol 5e-4 (``tests/test_spmd.py``
  allows 2e-3; an Adam step at lr 1e-3 moves an element by about 1e-3
  whatever its gradient, so a zero or sign-flipped gradient reads 1e-3 or
  more, and a sound run at most 2.7e-4 where a gradient is near Adam's
  eps);
* the metrics come back replicated and the leaves keep the rules' layouts.

The port's other mesh checks hold it against itself on one device and
need no JAX: ``tests/test_torch_tp_worlds.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ranks import run_ranks

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.optim import optimizers as joptim
from repro.train import step as jstep

LOSS_RTOL, PARAM_ATOL, GRAD_REL = 1e-4, 5e-4, 1e-5
TP_BATCH = (8, 16)

STEP_BODY = """
import json

from repro_torch import configs, convert
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib


def layout(x):  # the sharded tensor dim on each mesh dim, None where replicated
    return [p.dim if p.is_shard() else None for p in x.placements]


def main():
    cfg = configs.get_smoke("minicpm-2b")
    mesh = make_debug_mesh(2, 4, device="cpu")
    rules = sharding.BASE_RULES
    params = convert.params_from_numpy(unflatten(np.load(os.path.join(OUT, "params.npz"))),
                                       "cpu")
    inp = np.load(os.path.join(OUT, "batch.npz"))
    batch = {k: torch.from_numpy(inp[k]) for k in inp.files}
    opt = optimizers.adamw(1e-3, max_grad_norm=1.0)
    params = sharding.device_put(params, step_lib.param_shardings(mesh, cfg, rules))
    state = sharding.device_put(opt.init(params), step_lib.opt_shardings(mesh, cfg, rules))
    batch = sharding.device_put(batch, step_lib.batch_shardings(mesh, cfg, batch, rules))
    grads = {}

    def capture(g):  # whole copies: the update clips the gradients in place
        grads.update(optimizers.tree_map(lambda x: x.full_tensor().clone(), g))
        return g

    with sharding.sharding_ctx(mesh, rules):
        params, state, metrics = step_lib.make_train_step(cfg, opt, capture)(
            params, state, batch)
    placements = {k: layout(v) for k, v in metrics.items() if sharding.is_dtensor(v)}
    layouts = {"embed": layout(params["tok"]["embed"]),
               "w_gate": layout(params["blocks"]["mlp"]["w_gate"]),
               "wq": layout(params["blocks"]["attn"]["wq"]),
               "mu/w_gate": layout(state.mu["blocks"]["mlp"]["w_gate"]),
               "tokens": layout(batch["tokens"]), "metrics": placements}
    full = optimizers.tree_map(lambda x: x.full_tensor(), params)
    if RANK == 0:
        np.savez(os.path.join(OUT, "step.npz"), **flatten({"params": full, "grads": grads}),
                 metrics=np.array(json.dumps({k: float(v) for k, v in metrics.items()})),
                 layouts=np.array(json.dumps(layouts)))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + k + "/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _reference_step(jcfg, params, batch):
    """The reference's jitted unsharded step: (params, metrics, the
    gradients its ``grad_transform`` hook is handed)."""
    opt = joptim.adamw(1e-3, max_grad_norm=1.0)

    def step(p, b):
        seen = {}

        def capture(g):
            seen["grads"] = g
            return g

        p, _, metrics = jstep.make_train_step(jcfg, opt, capture)(p, opt.init(p), b)
        return p, metrics, seen["grads"]

    return jax.jit(step)(params, {k: jnp.asarray(v) for k, v in batch.items()})


def test_tp_step_2x4_matches_reference_unsharded(tmp_path):
    jcfg = jconfigs.get_smoke("minicpm-2b")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, TP_BATCH).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    np.savez(tmp_path / "params.npz", **_flat(jax.tree.map(np.asarray, jp)))
    np.savez(tmp_path / "batch.npz", **batch)
    want, wm, wgrads = _reference_step(jcfg, jp, batch)
    run_ranks(tmp_path, 8, STEP_BODY)
    got = dict(np.load(tmp_path / "step.npz"))
    metrics = json.loads(str(got.pop("metrics")))
    layouts = json.loads(str(got.pop("layouts")))
    assert metrics["loss"] == pytest.approx(float(wm["loss"]), rel=LOSS_RTOL)
    assert metrics["grad_norm"] == pytest.approx(float(wm["grad_norm"]), rel=LOSS_RTOL)
    want = _flat({"params": jax.tree.map(np.asarray, want),
                  "grads": jax.tree.map(np.asarray, wgrads)})
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("grads/"):
            scale = float(np.abs(want[k]).max())
            err = float(np.abs(got[k] - want[k]).max())
            assert scale > 0 and err <= GRAD_REL * scale, (k, err, scale)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    # each mesh dim (data, model): the tensor dim it splits, None where replicated
    assert layouts["embed"] == [None, 0]                     # vocab on 'model'
    assert layouts["w_gate"] == layouts["mu/w_gate"] == [None, 3]  # mlp on 'model'
    assert layouts["wq"] == [None, None]   # 6 heads: 'model' (4) does not divide them
    assert layouts["tokens"] == [0, None]                    # batch on 'data'
    assert set(layouts["metrics"]) == {"loss", "xent", "grad_norm"}
    assert all(v == [None, None] for v in layouts["metrics"].values())
