"""The train step hands its optimizer every gradient in its master's layout,
each reduced once, on fake worlds of four and eight ranks; imports no JAX.

``torch.autograd.grad`` gives a ``DTensor`` master's gradient back as a
``Partial`` sum over the mesh dims that split the batch.  ``train.step``
lays each out as its master before ``grad_transform``, the global norm and
Adam: a block's slice as its backward ends (``transformer._laid_out``),
the other leaves as the backward pass ends (``step.value_and_grad``).  The
cost pass's fake process group (torch's ``fake`` backend, ``FakeTensor`` shards) runs
minicpm-2b's, grok-1's and llama4-maverick's smoke configs under the base
and FSDP rules on 2 x 2 and 4 x 1 (data, model) meshes, batch 8 x 32:

* every gradient the ``grad_transform`` hook sees has its master's
  placements and local shape (before the repair an FSDP leaf's came back
  whole over ``data``: grok-1's ``moe.w_gate`` [2, 1, 2, 64, 128] for a
  master of [2, 1, 2, 32, 128]);
* on the 4 x 1 world under the base rules minicpm-2b's step all-reduces
  each gradient once: one all-reduce a leaf a block, and all-reduce bytes
  no more than one ring all-reduce of the f32 gradients plus the loss's
  (before the repair 2,314,504 bytes against 736,904); in bf16 compute
  too, where the gradients are still summed in f32, the masters' dtype;
* under remat "dots" on 2 x 2 each block's gradients are reduced right
  after its backward, before the next block's recompute;
* under the FSDP rules in bf16 compute (minicpm-2b with remat "dots",
  grok-1), traced by ``chip_smoke.layout_trace`` as phase ``fsdp`` traces
  the step on the card: each weight split over ``data`` is all-gathered
  in bf16 by ``sharding.gather_dp`` before its products, each gradient
  reaches its layout node as a ``Partial`` sum and is reduced there once,
  in f32, and nothing else is reduced over ``data`` but
  ``chip_smoke.FSDP_OTHER_REDUCTIONS`` (ROADMAP C.14: before the repair
  grok-1's expert products split the activations over ``data`` and
  reduced them, and its expert weights' gradients came in split);
* on a (pod 2, data 2, model 2) mesh each FSDP gradient is
  reduce-scattered over ``pod``, then over ``data`` (ROADMAP C.15).

Every fake group lives in a subprocess of its own, as in
``tests/test_torch_dryrun_cost.py``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 300
ARCHS = ("minicpm-2b", "grok-1-314b", "llama4-maverick-400b-a17b")
RULES = ("base", "fsdp")
WORLDS = ("2x2", "4x1")
F32 = 4
RING = 2  # an all-reduce's bytes on the wire a rank: the reference's ring factor
# the FSDP steps traced in bf16 compute (arch, remat): "dots" recomputes each
# block in the backward pass, which gathers the block's weights again
TRACED = (("minicpm-2b", "dots"), ("grok-1-314b", "none"))

BODY = """
import dataclasses, json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import chip_smoke
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import model
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib


def layout(tree):
    return {k: [[str(p) for p in v.placements], list(v.to_local().shape)]
            for k, v in sharding.keyed_leaves(tree).items()}


def traced(mesh, arch, remat):
    # the FSDP step in bf16 compute, its collectives traced as phase fsdp
    # of chip_smoke.py traces them on the card
    cfg = dataclasses.replace(configs.get_smoke(arch), compute_dtype="bfloat16", remat=remat)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    fn, args, cfg, _, rules = dryrun.build_cell(
        arch, ShapeConfig("smoke", 32, 8, "train"), mesh, "fsdp", cfg=cfg, fake_mode=fake_mode)
    masters = layout(args[0])
    with fake_mode, sharding.sharding_ctx(mesh, rules), chip_smoke.layout_trace(
            torch, args[0]) as (counter, nodes):
        fn(*args)
    return {"masters": masters, "n_blocks": cfg.n_blocks, "tied": cfg.tie_embeddings,
            **chip_smoke.layout_reductions(counter, nodes, masters, cfg.n_blocks,
                                           "torch.bfloat16")}


dryrun.fake_world(RANKS)
out = {}
for world in WORLDS:
    d, m = (int(x) for x in world.split("x"))
    mesh = mesh_lib.make_debug_mesh(d, m, device="cpu")
    runs = [(arch, rules_name, None) for arch in ARCHS for rules_name in RULES]
    for arch, rules_name, compute in runs + list(EXTRA):
        cfg = configs.get_smoke(arch)
        if compute is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        _, args, cfg, _, rules = dryrun.build_cell(
            arch, ShapeConfig("smoke", 32, 8, "train"), mesh, rules_name, cfg=cfg,
            fake_mode=fake_mode)
        seen = {}

        def hook(grads):
            seen.update(layout(grads))
            return grads

        opt = optimizers.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
        masters = layout(args[0])
        r = dryrun.measure(step_lib.make_train_step(cfg, opt, hook), args, mesh, rules,
                           fake_mode)
        counter = r["counter"]
        out["/".join([world, arch, rules_name] + [compute] * (compute is not None))] = {
            "masters": masters, "grads": seen, "param_count": model.param_count(cfg),
            "n_blocks": cfg.n_blocks, "op_counts": dict(counter.op_counts),
            "all_reduce_bytes": dryrun.collective_bytes_per_device(
                counter.collectives)["all-reduce"]}
    for arch, remat in TRACED:
        out[f"{world}/{arch}/fsdp/bfloat16/{remat}"] = traced(mesh, arch, remat)
if POD:  # a (pod 2, data 2, model 2) mesh: two DP axes
    out["pod/minicpm-2b/fsdp/bfloat16"] = traced(mesh_lib.make_debug_mesh(2, 2, 2, device="cpu"),
                                                 "minicpm-2b", "none")
print(json.dumps(out))
"""

# the order in which the backward pass lays the blocks' gradients out: a
# block's reductions ("r", logged as their autograd nodes run) against the
# blocks' forward runs and remat "dots" recomputes ("b"), minicpm-2b on 2 x 2
ORDER = """
import dataclasses, json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import transformer

events = []


class Logged(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        events.append("r")
        return g


layout_grad, apply_block = transformer.layout_grad, transformer.apply_block
transformer.layout_grad = lambda t: Logged.apply(layout_grad(t)) if t.requires_grad else t


def logged_block(*args, **kwargs):
    events.append("b")
    return apply_block(*args, **kwargs)


transformer.apply_block = logged_block
dryrun.fake_world(4)
mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
cfg = dataclasses.replace(configs.get_smoke("minicpm-2b"), remat="dots")
fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
fn, args, cfg, _, rules = dryrun.build_cell("minicpm-2b", ShapeConfig("smoke", 32, 8, "train"),
                                            mesh, "base", cfg=cfg, fake_mode=fake_mode)
with fake_mode, sharding.sharding_ctx(mesh, rules):
    fn(*args)
print(json.dumps({"order": {"events": "".join(events), "n_blocks": cfg.n_blocks,
                            "block_leaves": len(sharding.keyed_leaves(args[0]["blocks"]))}}))
"""


@pytest.fixture(scope="module")
def cells():
    """Every cell, a process a world (the pod mesh's of 8 ranks), and the
    order's process, all run together."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"}
    extra = {"4x1": (("minicpm-2b", "base", "bfloat16"),)}
    codes = [f"ARCHS, RULES, WORLDS = {ARCHS!r}, {RULES!r}, {(world,)!r}\n"
             f"EXTRA, TRACED, POD, RANKS = {extra.get(world, ())!r}, {TRACED!r}, False, 4\n"
             + textwrap.dedent(BODY) for world in WORLDS]
    codes += ["ARCHS, RULES, WORLDS, EXTRA, TRACED, POD, RANKS = (), (), (), (), (), True, 8\n"
              + textwrap.dedent(BODY), textwrap.dedent(ORDER)]
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in codes]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, stderr[-3000:]
            (line,) = [x for x in stdout.splitlines() if x.startswith("{")]
            out.update(json.loads(line))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_reach_the_optimizer_in_their_masters_layout(cells, arch, rules, world):
    got = cells[f"{world}/{arch}/{rules}"]
    assert got["grads"].keys() == got["masters"].keys()
    wrong = {k: (got["masters"][k], g) for k, g in got["grads"].items()
             if g != got["masters"][k]}
    assert not wrong, wrong


def test_each_blocks_gradients_are_reduced_as_its_backward_ends(cells):
    """The autograd engine runs a ready node made later first: a block's
    layout nodes, made just before the block runs, reduce its gradients
    right after its backward (under remat "dots", its recompute), before
    the next block's; made with the others before the first block, they
    would wait for the whole backward pass, holding every block's
    gradients unreduced (deepseek-coder-33b × train_4k × single: 67.5 GB
    of bf16 weight slices at the peak)."""
    got = cells["order"]
    n, leaves = got["n_blocks"], got["block_leaves"]
    assert got["events"] == "b" * n + ("b" + "r" * leaves) * n


def test_data_parallel_step_all_reduces_each_gradient_once(cells):
    """minicpm-2b's smoke config on 4 x 1 under the base rules: every
    leaf is replicated, so each is all-reduced, a stacked leaf once a
    block; the one other all-reduce is the loss's (the cross-entropy's sum
    over the batch shards, one f32, a ``c10d`` all-reduce)."""
    _all_reduced_once(cells["4x1/minicpm-2b/base"])


def test_bf16_compute_step_sums_each_gradient_in_f32(cells):
    """The same step in bf16 compute: each block's f32 master slices are
    laid out before they are cast, so every gradient is all-reduced once
    and in f32, as at one device (bf16 sums would halve the bytes)."""
    _all_reduced_once(cells["4x1/minicpm-2b/base/bfloat16"])


def _all_reduced_once(got):
    blocks = got["n_blocks"]
    leaves = got["masters"].keys()
    one_a_leaf = sum(blocks if k.startswith("['blocks']") else 1 for k in leaves)
    assert got["op_counts"] == {"_c10d_functional.all_reduce": one_a_leaf,
                                "c10d.allreduce_": 1}
    gradients = RING * F32 * got["param_count"]  # 2 x 4 x 92,112 = 736,896
    loss = RING * F32 * 1
    assert gradients == 736_896
    assert got["all_reduce_bytes"] == gradients + loss


def _traced(cells, world, arch, remat):
    return cells[f"{world}/{arch}/fsdp/bfloat16/{remat}"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch,remat", TRACED)
def test_fsdp_step_gathers_each_weight_over_data_in_bf16(cells, arch, remat, world):
    """Under ``FSDP_RULES`` each product reads its weight gathered over
    ``data`` (``sharding.gather_dp``), after the cast: in bf16.  Each
    weight the rules split over ``data`` is gathered once a block, and
    again in the block's "dots" recompute (the gathered weight is not kept
    for the backward pass); the router and the token table are read whole
    on the batch shards (``Shards.weight``), the table also gathered here
    as the tied unembedding."""
    got = _traced(cells, world, arch, remat)
    passes = 2 if remat == "dots" else 1
    split = [k for k, (placements, _) in got["masters"].items() if placements[0] != "R"]
    want = {k: got["n_blocks"] * passes if k.startswith("['blocks']") else 1 for k in split
            if not k.endswith("['router']") and (k != "['tok']['embed']" or got["tied"])}
    assert got["gather_dp"]["leaves"] == want
    assert got["gather_dp"]["dtypes"] == ["torch.bfloat16"]
    assert got["gather_dp"]["count"] == got["gather_dp"]["weights"] == sum(want.values())
    assert got["gathers_off_dtype"] == {}  # no all-gather over data in f32


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch,remat", TRACED)
def test_fsdp_step_reduces_each_gradient_once_in_f32_at_its_layout_node(cells, arch, remat,
                                                                        world):
    """Every gradient, the norms' too, reaches its layout node as a
    ``Partial`` sum over ``data`` and is reduced there once, in f32 (and
    once over ``model`` too where it is a sum over that axis as well)."""
    got = _traced(cells, world, arch, remat)
    assert got["layout_nodes"] == got["layout_nodes_expected"] > 0
    assert got["nodes_wrong"] == [] and got["reductions_wrong"] == []
    assert got["needed_none"] == {}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch,remat", TRACED)
def test_fsdp_step_reduces_no_activation_over_data(cells, arch, remat, world):
    """Outside the layout nodes the step reduces over ``data`` only what
    ``chip_smoke.FSDP_OTHER_REDUCTIONS`` names (the cross-entropy's sum,
    the MoE load-balance loss's means, the gradient norm's sums), in f32:
    no product splits the activations on ``data`` and reduces them."""
    got = _traced(cells, world, arch, remat)
    assert got["unlisted"] == {}
    assert any(k.startswith("models/layers.py") for k in got["other_reductions"])


def test_fsdp_step_reduce_scatters_each_gradient_over_pod_then_data(cells):
    """On a (pod 2, data 2, model 2) mesh a gradient that is a ``Partial``
    sum over both DP axes of a master split over both is reduce-scattered
    over ``pod``, then its shard over ``data``: one mesh dim at a time
    (``_ForwardLayoutGrad``), where DTensor's own plan all-reduces it whole
    over ``data`` first (ROADMAP C.15; the production multi-pod mesh's
    grok-1 × train_4k cell: 78.9 GB of f32 all-reduce results a step
    against 2.6 GB of reduce-scatters).  A replicated master's (the
    norms', also a sum over ``model``) is all-reduced over each axis."""
    got = cells["pod/minicpm-2b/fsdp/bfloat16"]

    def nodes(leaves):  # a stacked leaf's node runs once a block
        return sum(got["n_blocks"] if k.startswith("['blocks']") else 1 for k in leaves)

    split = [k for k, (placements, _) in got["masters"].items() if placements[:2] != ["R", "R"]]
    whole = [k for k in got["masters"] if k not in split]
    assert got["nodes_wrong"] == [] and got["reductions_wrong"] == []
    assert got["node_issued"] == {"reduce-scatter pod, reduce-scatter data": nodes(split),
                                  "all-reduce pod, all-reduce data, all-reduce model":
                                      nodes(whole)}
    assert split and whole
