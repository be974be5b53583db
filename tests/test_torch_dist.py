"""The port's distribution layer against the JAX package's, on the CPU.

Rule resolution (``logical_pspec``, ``tree_shardings``) is held against
the reference's on the same rules and mesh shapes (JAX's ``AbstractMesh``,
no devices); ``placements`` against what DTensor can express.  The
data-parallel NTTD epoch and elastic checkpoint restore run in spawned
gloo worlds on the CPU: each rank is a process of its own, joined by a
``FileStore`` under the test's temporary directory (no TCP port, so
parallel test workers never collide), with a join timeout.  The epoch is
held against the reference's single-device ``_make_train_epoch`` on the
inputs of ``tests/test_spmd.py``'s DP test: loss rtol 1e-5, params rtol
1e-4 / atol 1e-6 (sums over the batch in another order), the ranks'
params bitwise equal.  Checkpoints cross between the packages both ways.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.core import codec as jcodec
from repro.core import nttd as jnttd
from repro.core.folding import make_folding_spec as jfolding
from repro.dist import sharding as jsharding
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jckpt
from repro_torch.dist import sharding
from repro_torch.dist.sharding import MeshShape
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.launch import mesh as mesh_lib
from torch_ranks import run_ranks



def _jmesh(sizes, names):
    return AbstractMesh(tuple(sizes), tuple(names))


# ------------------------------------------------------------ rule resolution
# the cases of tests/test_dist.py, each resolved by both packages
PSPEC_CASES = [
    # missing mesh axes ('pod', 'model') are dropped / replicated
    ((1,), ("data",), ("batch", "heads", "mlp"),
     {"batch": ("pod", "data"), "heads": "model", "mlp": None}, None),
    # unknown logical axis and None replicate
    ((1,), ("data",), ("never_named", None), {}, None),
    # first dim wins a reused mesh axis
    ((1,), ("data",), ("embed", "vocab"), {"embed": "data", "vocab": "data"}, None),
    # the production rules on a (2, 4) mesh, with and without shapes
    ((2, 4), ("data", "model"), ("ffn_in", "heads", "head_dim"), "base", (48, 6, 8)),
    ((2, 4), ("data", "model"), ("ffn_in", "mlp"), "base", (48, 120)),
    ((2, 4), ("data", "model"), ("batch", "seq", "act_embed"), "base", (8, 16, 48)),
    ((2, 4), ("data", "model"), ("no_such_axis",), "base", (7,)),
    ((2, 4), ("data", "model"), ("batch", "seq", "act_embed"), "base", (7, 16, 48)),
    # multi-pod: a dim on both DP axes, FSDP's weight dims, divisibility
    ((2, 16, 16), ("pod", "data", "model"), ("batch", "seq"), "base", None),
    ((2, 16, 16), ("pod", "data", "model"), ("embed", "mlp"), "fsdp", (2048, 5632)),
    ((2, 16, 16), ("pod", "data", "model"), ("embed", "mlp"), "fsdp", (2047, 5632)),
    ((2, 16, 16), ("pod", "data", "model"), ("experts", "expert_in", "expert_mlp"), "fsdp",
     (16, 4096, 1024)),
    ((16, 16), ("data", "model"), ("layers", "embed", "heads", "head_dim"), "fsdp",
     (40, 2304, 36, 64)),
]


def _rules(which, port: bool):
    if isinstance(which, dict):
        return which
    mod = sharding if port else jsharding
    return mod.BASE_RULES if which == "base" else mod.FSDP_RULES


@pytest.mark.parametrize("case", range(len(PSPEC_CASES)))
def test_logical_pspec_matches_reference(case):
    sizes, names, axes, rules, shape = PSPEC_CASES[case]
    want = jsharding.logical_pspec(axes, _rules(rules, False), _jmesh(sizes, names), shape)
    got = sharding.logical_pspec(axes, _rules(rules, True), MeshShape(sizes, names), shape)
    assert isinstance(got, P) and len(got) == len(axes)
    assert tuple(got) == tuple(want), (got, want)


def test_rules_tables_are_the_reference_s():
    assert sharding.BASE_RULES == jsharding.BASE_RULES
    assert sharding.FSDP_RULES == jsharding.FSDP_RULES


def test_tree_shardings_match_reference_on_a_2x4_mesh():
    specs = {
        "wq": ((48, 6, 8), ("ffn_in", "heads", "head_dim")),
        "w_gate": ((48, 120), ("ffn_in", "mlp")),
        "act": ((8, 16, 48), ("batch", "seq", "act_embed")),
        "odd": ((7,), ("no_such_axis",)),
    }
    jsh = jsharding.tree_shardings(
        _jmesh((2, 4), ("data", "model")),
        {k: jsharding.ParamSpec(*v) for k, v in specs.items()}, jsharding.BASE_RULES)
    mesh = MeshShape((2, 4), ("data", "model"))
    tsh = sharding.tree_shardings(mesh, {k: sharding.ParamSpec(*v) for k, v in specs.items()},
                                  sharding.BASE_RULES)
    for k, (shape, _) in specs.items():
        assert tuple(tsh[k].spec) == tuple(jsh[k].spec), k
        assert tsh[k].mesh is mesh
        assert tsh[k].shard_shape(shape) == jsh[k].shard_shape(shape), k
    assert tsh["wq"].spec == P(None, None, None) and tsh["w_gate"].spec == P(None, "model")


def test_partition_spec_normalizes_as_jax():
    assert tuple(P(None, ("data",))) == tuple(JP(None, ("data",))) == (None, "data")
    assert tuple(P(("pod", "data"), None)) == tuple(JP(("pod", "data"), None))
    assert P("data", None) != P("data")


def test_shard_shape_raises_where_a_dim_does_not_divide():
    mesh = MeshShape((2, 4), ("data", "model"))
    s = sharding.NamedSharding(mesh, P("data", "model"))
    assert s.shard_shape((8, 8)) == NamedSharding(
        _jmesh((2, 4), ("data", "model")), JP("data", "model")).shard_shape((8, 8))
    with pytest.raises(ValueError):
        s.shard_shape((8, 6))


# ----------------------------------------------------------------- placements
def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    assert sharding.placements(P("model", "data"), MeshShape((4, 2), ("data", "model"))) == (
        Shard(1), Shard(0))


@pytest.mark.parametrize("spec", [P(("data", "pod")), P(("model", "data"), None),
                                  P("data", "data"), P("nowhere")])
def test_placements_refuse_what_dtensor_cannot_express(spec):
    with pytest.raises(ValueError):
        sharding.placements(spec, MeshShape((2, 16, 16), ("pod", "data", "model")))


# --------------------------------------------------------- shard and context
def test_shard_is_identity_outside_ctx_and_checks_rank():
    x = torch.ones(2, 3)
    assert sharding.shard(x, "batch", "act_embed") is x
    assert jsharding.shard(jnp.ones((2, 3)), "batch", "act_embed").shape == (2, 3)
    with pytest.raises(ValueError):
        sharding.shard(x, "batch")
    with pytest.raises(ValueError):
        jsharding.shard(jnp.ones((2, 3)), "batch")


def test_sharding_ctx_nests_and_shard_refuses_a_plain_tensor():
    mesh = MeshShape((2, 4), ("data", "model"))
    assert sharding.current_ctx() is None
    with sharding.sharding_ctx(mesh, sharding.BASE_RULES):
        assert sharding.current_ctx()[0] is mesh
        with sharding.sharding_ctx(mesh, {"batch": None}):
            assert sharding.current_ctx()[1] == {"batch": None}
        assert sharding.current_ctx()[1] == sharding.BASE_RULES
        with pytest.raises(TypeError):
            sharding.shard(torch.ones(2, 3), "batch", None)
    assert sharding.current_ctx() is None


def test_production_meshes():
    single, multi = mesh_lib.make_production_mesh(), mesh_lib.make_production_mesh(
        multi_pod=True)
    assert (single.sizes, single.axis_names, single.size) == ((16, 16), ("data", "model"), 256)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert sharding.mesh_axes(multi) == {"pod": 2, "data": 16, "model": 16}
    # the roofline constants are an H100's, never the reference's TPU v5e figures
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW, mesh_lib.LINK_BW) == (989e12, 3.35e12,
                                                                             50e9)
    assert not hasattr(mesh_lib, "ICI_BW")


# -------------------------------------------------------------- spawned worlds
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + k + "/").items()}
    return {prefix[:-1]: np.asarray(tree)}


# ----------------------------------------------------------- data-parallel fit
DP_SHAPE, DP_RANK, DP_HIDDEN, DP_STEPS, DP_BATCH = (16, 12, 10), 4, 8, 4, 512

DP_BODY = """
from repro_torch import convert
from repro_torch.core import codec, nttd
from repro_torch.core.folding import make_folding_spec
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim import optimizers


def main():
    pods = int(os.environ["PODS"])
    mesh = make_debug_mesh(data=WORLD // max(pods, 1), model=1, pods=pods, device="cpu")
    inputs = np.load(os.path.join(OUT, "inputs.npz"))
    params = convert.params_from_numpy(unflatten(np.load(os.path.join(OUT, "params.npz"))),
                                       "cpu")
    spec = make_folding_spec(tuple(int(n) for n in inputs["shape"]))
    cfg = nttd.NTTDConfig(rank=int(inputs["rank"]), hidden=int(inputs["hidden"]),
                          kernel_impl="cuda")  # the training route; plain versions on the CPU
    opt = optimizers.adam(1e-2)
    epoch = codec._make_train_epoch(spec, cfg, opt, mesh=mesh)
    pos = torch.as_tensor(inputs["pos"], dtype=torch.int32)
    vals = torch.as_tensor(inputs["vals"])
    try:
        epoch(params, opt.init(params), pos[:, :-1], vals[:, :-1])
    except ValueError as e:
        print("refused:", e)
    else:
        raise AssertionError("an indivisible batch ran")
    p, _, loss = epoch(params, opt.init(params), pos, vals)
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), loss=loss.numpy(), **flatten(p))
    # shard under a context: a replicated DTensor laid out on its batch dim
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.arange(8.0 * WORLD).reshape(2 * WORLD, 4), mesh,
                          [Replicate()] * mesh.ndim)
    with sharding.sharding_ctx(mesh, sharding.BASE_RULES):
        y = sharding.shard(x, "batch", None)
    assert y.placements[:-1] == (Shard(0),) * (mesh.ndim - 1), y.placements
    assert torch.equal(y.full_tensor(), x.full_tensor())
"""


@pytest.mark.parametrize("world,pods", [(2, 0), (4, 2)])
def test_dp_epoch_matches_reference_single_device(tmp_path, world, pods):
    """2 ranks on a (data 2, model 1) mesh; 4 on (pod 2, data 2, model 1),
    where a rank's block index is pod-major, as JAX's ('pod', 'data')."""
    spec = jfolding(DP_SHAPE)
    cfg = jnttd.NTTDConfig(rank=DP_RANK, hidden=DP_HIDDEN)
    params = jnttd.init_params(jax.random.PRNGKey(0), spec, cfg)
    opt = jopt.adam(1e-2)
    rng = np.random.default_rng(0)
    pos = np.stack([rng.integers(0, n, (DP_STEPS, DP_BATCH)) for n in spec.shape],
                   -1).astype(np.int32)
    vals = rng.normal(size=(DP_STEPS, DP_BATCH)).astype(np.float32)
    np.savez(tmp_path / "params.npz", **_flat(jax.tree.map(np.asarray, params)))
    np.savez(tmp_path / "inputs.npz", pos=pos, vals=vals, shape=np.asarray(DP_SHAPE),
             rank=DP_RANK, hidden=DP_HIDDEN)
    jp, _, jloss = jcodec._make_train_epoch(spec, cfg, opt)(
        params, opt.init(params), jnp.asarray(pos), jnp.asarray(vals))
    want = _flat(jax.tree.map(np.asarray, jp))

    outs = run_ranks(tmp_path, world, DP_BODY, PODS=str(pods))
    assert all("refused: data-parallel epoch: batch 511" in o for o in outs), outs
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for r in range(1, world):  # replicated params stay bitwise equal
        for k in got[0]:
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"rank {r} {k}")
    np.testing.assert_allclose(float(got[0].pop("loss")), float(jloss), rtol=1e-5)
    assert got[0].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# --------------------------------------------------------------- elastic restore
ELASTIC_BODY = """
from torch.distributed.tensor import distribute_tensor
from repro_torch.dist.sharding import NamedSharding, PartitionSpec as P, placements
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train import checkpoint as ckpt_lib


def check(tree, want, sh_b):
    w = tree["w"]
    assert w.placements == sh_b["w"].placements, w.placements
    assert torch.equal(w.full_tensor(), want)
    # each rank's chunk is its slice: 'model' (size 2) on dim 0, 'data' (4) on dim 1
    c = dict(zip(w.device_mesh.mesh_dim_names, w.device_mesh.get_coordinate()))
    assert torch.equal(w.to_local(), want[c["model"] * 4:(c["model"] + 1) * 4,
                                          c["data"] * 2:(c["data"] + 1) * 2])
    assert not isinstance(tree["s"], type(w)) and float(tree["s"]) == 3.0


def main():
    want = torch.arange(64.0).reshape(8, 8)
    mesh_a = make_debug_mesh(data=2, model=4, device="cpu")
    w_a = distribute_tensor(want, mesh_a, placements(P("data", "model"), mesh_a))
    assert w_a.to_local().shape == (4, 2)
    ck = ckpt_lib.Checkpointer(os.path.join(OUT, "port"), async_save=False)
    ck.save(1, {"w": w_a, "s": torch.tensor(3.0)})
    dist.barrier()

    # restore onto a DIFFERENT mesh shape: its own and the reference's file
    mesh_b = make_debug_mesh(data=4, model=2, device="cpu")
    sh_b = {"w": NamedSharding(mesh_b, P("model", "data")), "s": None}
    template = {"w": torch.empty(8, 8), "s": torch.empty(())}
    for d in ("port", "reference"):
        tree, manifest = ckpt_lib.Checkpointer(os.path.join(OUT, d)).restore(1, template, sh_b)
        check(tree, want, sh_b)
        print(d, "restored", manifest["step"])
"""


def test_elastic_restore_2x4_to_4x2_and_across_packages(tmp_path):
    """As tests/test_spmd.py's elastic test: a (2, 4) mesh's save restores
    onto (4, 2) with the dims' axes swapped.  The ranks' save is read by
    the reference, and the reference's save by the ranks."""
    tree = {"w": jnp.arange(64.0).reshape(8, 8), "s": jnp.float32(3.0)}
    jckpt.Checkpointer(str(tmp_path / "reference"), async_save=False).save(1, tree)
    outs = run_ranks(tmp_path, 8, ELASTIC_BODY)
    assert all("port restored 1" in o and "reference restored 1" in o for o in outs)
    restored, _ = jckpt.Checkpointer(str(tmp_path / "port")).restore(1, tree)
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.arange(64.0).reshape(8, 8))
    assert float(restored["s"]) == 3.0
    assert sorted(os.listdir(tmp_path / "port" / "step_0000000001")) == sorted(
        os.listdir(tmp_path / "reference" / "step_0000000001"))


def test_chip_smoke_world_fails_at_once_on_a_failing_rank(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase dist's worlds: a rank that exits non-zero
    (here: no inputs to read) fails the world as soon as it exits, its
    peers killed, well before the world's timeout."""
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    (tmp_path / "dist").mkdir()
    t = time.monotonic()
    with pytest.raises(chip_smoke.SmokeFailure, match="rank exit codes"):
        chip_smoke.run_world("x", 2, "gloo", "cpu", str(tmp_path))
    assert time.monotonic() - t < chip_smoke.DIST_TIMEOUT / 4
