"""Dry-run cell of the paper's own workload, as in
``repro.launch.dryrun_codec``: the NTTD compression epoch, data-parallel
over sampled tensor entries on the production mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_codec \
        [--mesh single|multi] [--impl ref|ref_unrolled] [--batch 1048576] \
        [--steps 4] [--rank 8] [--hidden 16] [--out DIR] [--check]

``check`` returns the epoch's argument shardings, the reference's: the
params and the optimizer state replicated, the positions [S, B, d] and
values [S, B] split on their batch dim over the DP axes (``pod`` and
``data``), with each argument's bytes per device.

``run`` is the cost pass of ``launch.dryrun`` over that epoch:
``core.codec._make_train_epoch(..., mesh=)`` on a ``DeviceMesh`` of the
production mesh over a fake process group, the positions and values
``DTensor``s laid out as ``check`` says (each rank's block a
``FakeTensor``), the params and Adam's state replicated.  It returns the
reference's dict: the epoch's memory, and one step's FLOPs, bytes and
collectives (the epoch's divided by its steps: the reference's XLA cost
counts its scanned step once), the analytic ``model_flops`` and the
roofline over the H100 constants of ``launch.mesh``.  The pass runs the
plain versions ("ref" or "ref_unrolled"): a fake tensor launches no
kernel.  The port's step all-reduces the gradients and the loss in one
flat buffer, once a DP axis.

The CLI prints one JSON line; ``--out DIR`` also writes ``cell_path``'s
file there, and ``--check`` prints the rule check instead.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.core import nttd
from repro_torch.core.folding import make_folding_spec
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import optimizers

# the paper's largest tensor family, scaled to a production-sized workload:
# compressing a (16384, 4096, 1024) dense tensor (~0.5 TB fp64)
DEFAULT_SHAPE = (16384, 4096, 1024)


def _arguments(shape, batch: int, steps: int, rank: int, hidden: int, device: str):
    """The epoch's params, Adam state, positions [S, B, d] and values
    [S, B], empty on ``device``."""
    spec = make_folding_spec(shape)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hidden)
    params = optimizers.tree_map(lambda s: torch.empty(s, device=device),
                                 nttd.param_shapes(spec, cfg))
    return {"params": params, "opt": optimizers.adam(1e-2).init(params),
            "positions": torch.empty((steps, batch, len(shape)), dtype=torch.int32,
                                     device=device),
            "values": torch.empty((steps, batch), device=device)}


def _shardings(mesh, args: dict) -> dict:
    repl = sharding.NamedSharding(mesh, sharding.PartitionSpec())
    dp = sharding.NamedSharding(mesh, sharding.PartitionSpec(None, sharding.dp_axes(mesh)))
    return {name: dp if name in ("positions", "values") else repl for name in args}


def check(mesh_name: str, batch: int = 1 << 20, steps: int = 4, rank: int = 8,
          hidden: int = 16, shape=DEFAULT_SHAPE) -> dict:
    mesh = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
    args = _arguments(shape, batch, steps, rank, hidden, "meta")
    specs, nbytes = {}, {}
    for name, target in _shardings(mesh, args).items():
        leaves = sharding.keyed_leaves(args[name])
        shardings = {k: target for k in leaves}
        specs[name] = {k: s.spec for k, s in shardings.items()}
        nbytes[name] = dryrun.tree_bytes_per_device(shardings, leaves)
    return {"arch": "tensorcodec-codec", "shape": list(shape), "batch": batch, "steps": steps,
            "rank": rank, "hidden": hidden, "mesh": mesh_name, "rules": "dp", "status": "ok",
            "n_devices": mesh.size, "specs": specs, "bytes_per_device": nbytes}


def model_flops(shape, batch: int, rank: int, hidden: int) -> float:
    """Useful FLOPs of one step, the reference's: per entry the LSTM (8h^2
    a step over d' steps), the heads and the chain, x3 for forward and
    backward."""
    d_prime = make_folding_spec(shape).d_prime
    per_entry = d_prime * (8 * hidden * hidden + 2 * hidden * rank * rank) + (
        d_prime - 2
    ) * 2 * rank * rank
    return 3.0 * per_entry * batch


def _cost(mesh, impl: str, batch: int, steps: int, rank: int, hidden: int,
          shape=DEFAULT_SHAPE) -> dict:
    """The cost pass of one epoch on ``mesh`` (a ``DeviceMesh`` over a fake
    process group): its memory, and one step's counter figures."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = make_folding_spec(shape)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hidden, kernel_impl=impl)
    epoch_fn = codec_lib._make_train_epoch(spec, cfg, optimizers.adam(1e-2), mesh=mesh)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        args = _arguments(shape, batch, steps, rank, hidden, "cpu")
    targets = _shardings(mesh, args)
    for name in ("positions", "values"):
        args[name] = dryrun.fake_tree(targets[name], args[name], mesh, fake_mode)
    m = dryrun.measure(epoch_fn, list(args.values()), mesh, None, fake_mode)
    counter = m["counter"]
    per_step = dryrun.cost_dict(counter)
    return {"memory": m["memory"],
            "flops": per_step["flops"] / steps, "bytes": per_step["bytes accessed"] / steps,
            "collectives": [(k, dt, n / steps) for k, dt, n in counter.collectives],
            "collective_ops": {k: v / steps for k, v in counter.op_counts.items()}}


def run(mesh_name: str, impl: str, batch: int, steps: int, rank: int,
        hidden: int, shape=DEFAULT_SHAPE, verbose: bool = True) -> dict:
    if impl not in ("ref", "ref_unrolled"):
        raise ValueError(f"the cost pass runs the plain versions: impl {impl!r}")
    mesh = dryrun.fake_mesh(mesh_name)
    c = _cost(mesh, impl, batch, steps, rank, hidden, shape)
    mem = c["memory"]
    n_dev = mesh.size()
    flops, bytes_ = c["flops"], c["bytes"]
    coll = dryrun.collective_bytes_per_device(c["collectives"])
    mf = model_flops(shape, batch, rank, hidden)
    roof = dryrun.roofline(flops, bytes_, coll, mf, n_dev, mem["argument_bytes"])
    res = {
        "arch": "tensorcodec-codec",
        "shape": f"entries{batch}x{steps}_impl-{impl}",
        "mesh": mesh_name,
        "rules": "dp",
        "status": "ok",
        "n_devices": n_dev,
        "memory": mem,
        "flops_per_device": flops,
        "hlo_bytes_per_device": bytes_,
        "collective_bytes_per_device": coll,
        "collective_ops": c["collective_ops"],
        "model_flops": mf,
        "useful_flops_ratio": mf / max(flops * n_dev, 1.0),
        "roofline": roof,
    }
    if verbose:
        print(f"[codec x {mesh_name} x impl={impl} x batch={batch}]")
        print(f"  memory: args={mem['argument_bytes']/1e6:.1f}MB "
              f"temp={mem['temp_bytes']/1e6:.1f}MB")
        print(f"  flops/dev={flops:.3e} bytes/dev={bytes_:.3e} coll/dev={coll['total']:.3e}")
        print("  roofline: " + " ".join(f"{k}={roof[k]:.6f}s" for k in
                                        ("compute_s", "memory_s", "collective_s"))
              + f" dominant={roof['dominant']} fraction={roof['roofline_fraction']:.3f}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--impl", default="ref", choices=["ref", "ref_unrolled"])
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the cell's JSON file here")
    ap.add_argument("--check", action="store_true",
                    help="the rule check alone: specs and bytes per device, no cost pass")
    args = ap.parse_args(argv)
    if args.check:
        print(json.dumps(check(args.mesh, args.batch, args.steps, args.rank, args.hidden)))
        return 0
    res = run(args.mesh, args.impl, args.batch, args.steps, args.rank, args.hidden,
              verbose=False)
    print(json.dumps(res))
    if args.out:
        path = dryrun.cell_path("tensorcodec-codec", f"b{args.batch}-{args.impl}",
                                args.mesh, "dp", args.out)
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
