"""Multi-pod dry-run, the rule check of ``repro.launch.dryrun``: resolve
every (arch x shape x mesh x rules) cell's sharding trees on the
production meshes, with no devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \
        --shape decode_32k --mesh single --rules base
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --rules auto

``check_cell`` repeats the reference's ``build_cell`` up to its lowering
(serving cells hold bf16 weights; ``rules="auto"`` resolves by model
size; a batch the DP axes cannot fill makes the cache long-context) and
returns the resolved spec of every param, optimizer, batch and cache leaf
by its ``keystr`` path, with each tree's bytes per device: the leaves'
shapes divided by their shard counts.  Nothing is compiled and no
hardware constant is used.  The CLI prints one JSON line per cell (its
leaves counted, not listed) and writes no file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.train import step as step_lib


def auto_rules(cfg, shape) -> str:
    """Weights + optimizer must fit 16GB/chip alongside activations: big
    models shard weights over the DP axes too (FSDP rules)."""
    n = model.param_count(cfg)
    if shape.kind == "train":
        return "fsdp" if n >= 10e9 else "base"
    return "fsdp" if n * 2 / 16 >= 12e9 else "base"  # bf16 over 16-way TP


def should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: long_500k requires sub-quadratic decode (DESIGN.md §6)"
    return None


def tree_bytes_per_device(shardings: dict, abstract: dict) -> int:
    """Bytes one device holds of a tree: each leaf's shard shape (``keyed``
    like ``shardings``) times its element size."""
    return sum(math.prod(shardings[k].shard_shape(tuple(leaf.shape))) * leaf.element_size()
               for k, leaf in abstract.items())


def check_cell(arch: str, shape_name: str, mesh_name: str, rules_name: str = "base") -> dict:
    """The resolved sharding trees of one cell on the production mesh
    ``mesh_name`` ("single" or "multi")."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "rules": rules_name}
    skip = should_skip(cfg, shape)
    if skip:
        return dict(result, status="skip", reason=skip)
    mesh = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
    if shape.kind != "train":
        # serving runs bf16 weights (no optimizer master copies)
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if rules_name == "auto":
        rules_name = auto_rules(cfg, shape)
    base = sharding.BASE_RULES if rules_name == "base" else sharding.FSDP_RULES
    rules = step_lib.effective_rules(mesh, shape, base, cfg)
    batch_spec = step_lib.input_specs(cfg, shape)
    long_ctx = rules.get("batch") is None

    trees = {"params": (step_lib.param_shardings(mesh, cfg, rules), model.abstract_params(cfg)),
             "batch": (step_lib.batch_shardings(mesh, cfg, batch_spec, rules), batch_spec)}
    if shape.kind == "train":
        trees["opt"] = (step_lib.opt_shardings(mesh, cfg, rules),
                        step_lib.abstract_opt_state(cfg))
    else:
        trees["cache"] = (
            step_lib.cache_shardings(mesh, cfg, shape.global_batch, shape.seq_len, long_ctx,
                                     rules),
            model.abstract_cache(cfg, shape.global_batch, shape.seq_len, long_ctx))
    specs, nbytes = {}, {}
    for name, (shardings, abstract) in trees.items():
        shardings = sharding.keyed_leaves(shardings)
        abstract = sharding.keyed_leaves(abstract)
        if shardings.keys() != abstract.keys():
            raise ValueError(f"{arch}/{shape_name}: the {name} shardings and leaves differ")
        specs[name] = {k: s.spec for k, s in shardings.items()}
        nbytes[name] = tree_bytes_per_device(shardings, abstract)
    return dict(result, rules=rules_name, status="ok", n_devices=mesh.size, long_ctx=long_ctx,
                effective_rules=rules, specs=specs, bytes_per_device=nbytes)


def cells(mesh: str = "both", arch: str | None = None, shape: str | None = None) -> list:
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    archs = [arch] if arch else configs.ARCH_IDS
    shapes = [shape] if shape else list(SHAPES)
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="auto", choices=["auto", "base", "fsdp"])
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    for arch, shape, mesh_name in cells(args.mesh, None if args.all else args.arch,
                                        None if args.all else args.shape):
        res = check_cell(arch, shape, mesh_name, args.rules)
        if res["status"] == "ok":
            res["leaves"] = {k: len(v) for k, v in res.pop("specs").items()}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
