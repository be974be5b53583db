#!/usr/bin/env python3
"""A long-sequence LM train step: the cost pass's prediction against the card.

    python3 scripts/torch_long_step.py [--root DIR]

The cell (``CELL``) is minicpm-2b at full width cut to 4 layers, a batch of
2 x 4096 tokens, remat "dots", on a 1 x 1 (data, model) mesh under the
base rules.  From 2048 tokens the attention oracle attends q chunks of
512 rows (``kernels/ops.py``, ``kernels/ref.py``).

``cost`` runs the dry-run's cost pass over the cell (a fake process group
of one rank, ``FakeTensor`` shards): its FLOPs and peak, the live bytes at
the peak grouped by the port's source line (``peak_terms``, as
``scripts/torch_dryrun_sweep.py`` groups them), the largest of those made
by the oracle (``attention_term``, none where the oracle holds nothing at
the peak) and the most bytes the oracle holds at once over the step
(``oracle_most``), beside ``score_block``, one chunk's f32 score block,
and ``oracle_bound``, what one chunk may hold.  ``card_step`` runs the
same step on the card on one NCCL rank and reads
``torch.cuda.max_memory_allocated`` over the second of two steps.

``main`` prints one JSON line with both, the card's name and power limit.
``--root`` runs another checkout's port (``DIR/src``, whose
``dryrun.CostCounter`` takes ``under``), e.g. a ``git archive`` of the
parent commit under ``build/``.  ``chip_smoke.py`` phase
``dryrun`` runs ``cost`` and ``card_step``.  About a minute on an H100.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = dict(arch="minicpm-2b", layers=4, batch=2, seq=4096, remat="dots")
CHUNK = 512  # kernels/ref.py mha_attention_chunked's q rows a chunk


def _use_port(root: str | None) -> None:
    """Import ``repro_torch`` from ``root``'s checkout (this one's unless
    given); call before the first import of it."""
    src = os.path.join(root or ROOT, "src")
    if src in sys.path:
        sys.path.remove(src)
    sys.path.insert(0, src)


def cell_config():
    from repro_torch import configs

    return dataclasses.replace(configs.get(CELL["arch"]), n_layers=CELL["layers"],
                               remat=CELL["remat"])


def score_block(cfg) -> int:
    """One q chunk's f32 scores [B, H, CHUNK, S] on one rank."""
    return CELL["batch"] * cfg.n_heads * CHUNK * CELL["seq"] * 4


def oracle_bound(cfg) -> int:
    """What the chunked oracle may hold at once: one chunk's two f32 score
    blocks (the scores and their softmax), its mask [CHUNK, S], k and v
    in f32, and three f32 tensors of q's size (the chunks' scaled q and
    outputs, and the concatenated output)."""
    b, s = CELL["batch"], CELL["seq"]
    operands = (2 * cfg.n_kv_heads + 3 * cfg.n_heads) * b * s * cfg.head_dim * 4
    return 2 * score_block(cfg) + CHUNK * s + operands


def cost() -> dict:
    """The cost pass of the cell on a 1 x 1 mesh of a fake group of one
    rank (joined here unless this process is in one of that size)."""
    import torch_dryrun_sweep

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun, mesh as mesh_lib

    cfg = cell_config()
    counter = torch_dryrun_sweep.counter_class()(under=ref.__file__)
    dryrun.fake_world(1)
    r = dryrun.cost_cell(CELL["arch"], ShapeConfig("long", CELL["seq"], CELL["batch"], "train"),
                         mesh_lib.make_debug_mesh(1, 1, device="cpu"), "base", cfg=cfg,
                         counter=counter)
    oracle = [t for t in counter.terms if t["where"].startswith("kernels/ref.py")]
    return {"flops": r["flops_per_device"], "peak_bytes": r["memory"]["peak_per_device"],
            "memory": r["memory"], "peak_terms": counter.terms,
            "attention_term": max(oracle, key=lambda t: t["bytes"]) if oracle else None,
            "oracle_most_bytes": counter.peak_under,
            "score_block_bytes": score_block(cfg),
            "oracle_bound_bytes": oracle_bound(cfg),
            "seconds_cost_pass": r["seconds_cost_passes"]}


def card_step(torch, seed: int = 0) -> dict:
    """The cell's train step on ``DTensor``s of a 1 x 1 mesh on the card
    (this process must be rank 0 of a process group of one rank): the peak
    allocated bytes over the second of two steps, and its loss."""
    import numpy as np

    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = cell_config()
    batch, seq = CELL["batch"], CELL["seq"]
    mesh = mesh_lib.make_debug_mesh(1, 1, device="cuda")
    rules = sharding.BASE_RULES
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)),
                             dtype=torch.int32, device=device)
    data = sharding.device_put({"tokens": tokens, "labels": torch.roll(tokens, -1, 1)},
                               step_lib.batch_shardings(mesh, cfg, {"tokens": 0, "labels": 0},
                                                        rules))
    params = model.init_params(cfg, seed, device, step_lib.param_shardings(mesh, cfg, rules))
    opt = optimizers.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
    state = sharding.device_put(opt.init(params), step_lib.opt_shardings(mesh, cfg, rules))
    step = step_lib.make_train_step(cfg, opt)
    with sharding.sharding_ctx(mesh, rules):
        step(params, state, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, metrics = step(params, state, data)
        loss = float(metrics["loss"].full_tensor())
    torch.cuda.synchronize()
    return {"peak_bytes": torch.cuda.max_memory_allocated(), "loss": loss}


def _cost_to_file(root, path) -> None:
    import torch_dryrun_sweep  # noqa: F401 - it puts this checkout's src first

    _use_port(root)
    with open(path, "w") as f:
        json.dump(cost(), f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    _use_port(args.root)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("torch_long_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "cost.json")
    # a fake group cannot share a process with a real one
    proc = multiprocessing.get_context("spawn").Process(target=_cost_to_file,
                                                        args=(args.root, path))
    proc.start()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        card = card_step(torch)
    finally:
        dist.destroy_process_group()
        proc.join()
    if proc.exitcode != 0:
        print(f"torch_long_step: the cost pass exited {proc.exitcode}", file=sys.stderr)
        return 1
    with open(path) as f:
        pred = json.load(f)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": args.root or ROOT, **CELL, "predicted": pred, "card": card,
                      "peak_rel_err": abs(pred["peak_bytes"] - card["peak_bytes"])
                      / card["peak_bytes"], "name_power_limit": smi.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
