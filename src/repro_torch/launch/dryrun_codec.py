"""Dry-run cell of the paper's own workload, the rule check of
``repro.launch.dryrun_codec``: the NTTD compression epoch, data-parallel
over sampled tensor entries on the production mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_codec \
        [--mesh single|multi] [--batch 1048576] [--steps 4] [--rank 8] [--hidden 16]

``check`` returns the epoch's argument shardings, the reference's: the
params and the optimizer state replicated, the positions [S, B, d] and
values [S, B] split on their batch dim over the DP axes (``pod`` and
``data``), with each argument's bytes per device.  What runs under them is
``core.codec._make_train_epoch(..., mesh=)``.  Nothing is compiled; the
CLI prints one JSON line and writes no file.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import nttd
from repro_torch.core.folding import make_folding_spec
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import optimizers

# the paper's largest tensor family, scaled to a production-sized workload:
# compressing a (16384, 4096, 1024) dense tensor (~0.5 TB fp64)
DEFAULT_SHAPE = (16384, 4096, 1024)


def check(mesh_name: str, batch: int = 1 << 20, steps: int = 4, rank: int = 8,
          hidden: int = 16, shape=DEFAULT_SHAPE) -> dict:
    mesh = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
    spec = make_folding_spec(shape)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hidden)
    ab_params = optimizers.tree_map(lambda s: torch.empty(s, device="meta"),
                                    nttd.param_shapes(spec, cfg))
    ab_opt = optimizers.adam(1e-2).init(ab_params)
    args = {"params": ab_params, "opt": ab_opt,
            "positions": torch.empty((steps, batch, len(shape)), dtype=torch.int32,
                                     device="meta"),
            "values": torch.empty((steps, batch), device="meta")}
    repl = sharding.NamedSharding(mesh, sharding.PartitionSpec())
    dp = sharding.NamedSharding(mesh, sharding.PartitionSpec(None, sharding.dp_axes(mesh)))
    specs, nbytes = {}, {}
    for name, tree in args.items():
        leaves = sharding.keyed_leaves(tree)
        shardings = {k: dp if name in ("positions", "values") else repl for k in leaves}
        specs[name] = {k: s.spec for k, s in shardings.items()}
        nbytes[name] = dryrun.tree_bytes_per_device(shardings, leaves)
    return {"arch": "tensorcodec-codec", "shape": list(shape), "batch": batch, "steps": steps,
            "rank": rank, "hidden": hidden, "mesh": mesh_name, "rules": "dp", "status": "ok",
            "n_devices": mesh.size, "specs": specs, "bytes_per_device": nbytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    args = ap.parse_args(argv)
    print(json.dumps(check(args.mesh, args.batch, args.steps, args.rank, args.hidden)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
