"""The port's dry-run rule check against the JAX package's, on the CPU.

Every cell of the reference's sweep (10 archs x 4 shapes x the single
16 x 16 and multi-pod 2 x 16 x 16 meshes x the base and FSDP rules) is
resolved by both packages with no devices: the reference's
``build_cell`` up to its lowering on JAX's ``AbstractMesh``, the port's
``check_cell`` on its ``MeshShape``.  Every param, optimizer, batch and
cache leaf's spec must agree by ``keystr`` path (a path on one side only
fails the case), and so must each tree's bytes per device (the
reference's ``NamedSharding.shard_shape``).  Cells the reference's
``should_skip`` drops must be skipped by the port with the same reason.
The codec's data-parallel cell is checked the same way.
"""
import dataclasses
import json
import math
import os

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.core import nttd as jnttd
from repro.core.folding import make_folding_spec as jfolding
from repro.dist import sharding as jsharding
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.launch import dryrun, dryrun_codec


def _import_reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it
    is imported; keep this process's setting, which later subprocesses
    inherit."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


jdryrun = _import_reference_dryrun()

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, m, r) for a in jconfigs.ARCH_IDS for s in JSHAPES for m in MESHES
         for r in ("base", "fsdp")]


def _keyed(shardings, abstract) -> tuple[dict, int]:
    """The reference's {keystr: spec} of a tree and its bytes per device."""
    sh = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        shardings)[0]}
    ab = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        abstract)[0]}
    assert sh.keys() == ab.keys()
    nbytes = sum(math.prod(sh[k].shard_shape(a.shape)) * a.dtype.itemsize for k, a in ab.items())
    return {k: tuple(s.spec) for k, s in sh.items()}, nbytes


def reference_cell(arch, shape_name, mesh_name, rules_name):
    """``repro.launch.dryrun.build_cell`` up to the lowering, on an
    ``AbstractMesh``."""
    cfg = jconfigs.get(arch)
    shape = JSHAPES[shape_name]
    skip = jdryrun.should_skip(cfg, shape)
    if skip:
        return {"status": "skip", "reason": skip}
    mesh = AbstractMesh(*MESHES[mesh_name])
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    base = jsharding.BASE_RULES if rules_name == "base" else jsharding.FSDP_RULES
    rules = jstep.effective_rules(mesh, shape, base, cfg)
    batch_spec = jstep.input_specs(cfg, shape)
    long_ctx = rules.get("batch") is None
    trees = {"params": (jstep.param_shardings(mesh, cfg, rules), jmodel.abstract_params(cfg)),
             "batch": (jstep.batch_shardings(mesh, cfg, batch_spec, rules), batch_spec)}
    if shape.kind == "train":
        trees["opt"] = (jstep.opt_shardings(mesh, cfg, rules), jstep.abstract_opt_state(cfg))
    else:
        trees["cache"] = (
            jstep.cache_shardings(mesh, cfg, shape.global_batch, shape.seq_len, long_ctx, rules),
            jmodel.abstract_cache(cfg, shape.global_batch, shape.seq_len, long_ctx))
    specs, nbytes = {}, {}
    for name, (sh, ab) in trees.items():
        specs[name], nbytes[name] = _keyed(sh, ab)
    return {"status": "ok", "rules": rules, "long_ctx": long_ctx, "specs": specs,
            "bytes_per_device": nbytes}


def test_the_sweep_has_128_cells_and_the_reference_s_skips():
    kept = [c for c in CELLS if not jdryrun.should_skip(jconfigs.get(c[0]), JSHAPES[c[1]])]
    assert len(CELLS) == 160 and len(kept) == 128
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch,shape,mesh,rules", CELLS)
def test_check_cell_matches_reference(arch, shape, mesh, rules):
    want = reference_cell(arch, shape, mesh, rules)
    got = dryrun.check_cell(arch, shape, mesh, rules)
    assert got["status"] == want["status"]
    if want["status"] == "skip":
        assert got["reason"] == want["reason"]
        return
    assert got["effective_rules"] == want["rules"]
    assert got["long_ctx"] == want["long_ctx"]
    assert got["n_devices"] == math.prod(MESHES[mesh][0])
    assert got["specs"].keys() == want["specs"].keys()
    for tree, specs in want["specs"].items():
        port = {k: tuple(v) for k, v in got["specs"][tree].items()}
        only = port.keys() ^ specs.keys()
        assert not only, f"{tree}: paths on one side only: {sorted(only)[:5]}"
        diff = {k: (port[k], v) for k, v in specs.items() if port[k] != v}
        assert not diff, f"{tree}: {len(diff)} specs differ, e.g. {list(diff.items())[:3]}"
    assert got["bytes_per_device"] == want["bytes_per_device"]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_auto_rules_and_should_skip_match_reference(arch):
    for name, shape in JSHAPES.items():
        jcfg, tcfg = jconfigs.get(arch), configs.get(arch)
        if shape.kind != "train":
            jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
            tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
        assert dryrun.should_skip(tcfg, shape) == jdryrun.should_skip(jcfg, shape), name
        assert dryrun.auto_rules(tcfg, shape) == jdryrun.auto_rules(jcfg, shape), name
        got = dryrun.check_cell(arch, name, "single", "auto")
        assert got["rules"] == ("auto" if got["status"] == "skip"
                                else jdryrun.auto_rules(jcfg, shape))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_codec_dp_cell_matches_reference(mesh):
    """The argument shardings of ``repro.launch.dryrun_codec.run`` at its
    default shape and batch 2^20."""
    got = dryrun_codec.check(mesh)
    steps, batch, shape = 4, 1 << 20, dryrun_codec.DEFAULT_SHAPE
    assert shape == (16384, 4096, 1024) and (got["batch"], got["steps"]) == (batch, steps)
    jm = AbstractMesh(*MESHES[mesh])
    spec = jfolding(shape)
    ab_params = jax.eval_shape(lambda k: jnttd.init_params(k, spec, jnttd.NTTDConfig(8, 16)),
                               jax.random.PRNGKey(0))
    ab_opt = jax.eval_shape(jopt.adam(1e-2).init, ab_params)
    repl = NamedSharding(jm, JP())
    dp = NamedSharding(jm, JP(None, ("pod", "data") if "pod" in jm.axis_names else ("data",)))
    args = {"params": (jax.tree.map(lambda _: repl, ab_params), ab_params),
            "opt": (jax.tree.map(lambda _: repl, ab_opt), ab_opt),
            "positions": (dp, jax.ShapeDtypeStruct((steps, batch, len(shape)), "int32")),
            "values": (dp, jax.ShapeDtypeStruct((steps, batch), "float32"))}
    for name, (sh, ab) in args.items():
        specs, nbytes = _keyed(sh, ab)
        assert {k: tuple(v) for k, v in got["specs"][name].items()} == specs, name
        assert got["bytes_per_device"][name] == nbytes, name


def test_dryrun_cli_prints_a_line_per_cell(capsys):
    assert dryrun.main(["--check", "--arch", "mamba2-1.3b", "--shape", "long_500k", "--mesh",
                        "both", "--rules", "fsdp"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["mesh"], x["status"], x["rules"]) for x in lines] == [
        ("single", "ok", "fsdp"), ("multi", "ok", "fsdp")]
    assert all(x["leaves"]["cache"] > 0 and "specs" not in x for x in lines)
    assert dryrun_codec.main(["--check", "--mesh", "multi"]) == 0
    assert json.loads(capsys.readouterr().out)["bytes_per_device"]["positions"] == (
        4 * (1 << 20) * 3 * 4 // 32)
