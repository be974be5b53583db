"""Spawned gloo worlds on the CPU for the port's tests; imports no JAX.

``run_ranks(out, world, body)`` runs ``body`` (a script defining
``main()``) on ``world`` ranks, each a process of its own joined by a
``FileStore`` under ``out`` (no TCP port, so parallel test workers never
collide).  The prelude gives each rank ``RANK``, ``WORLD``, ``OUT``,
``np``, ``torch``, ``dist`` and the ``flatten``/``unflatten`` helpers of
``/``-keyed ``.npz`` trees.
"""
import os
import subprocess
import sys
import textwrap
import time

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 120  # seconds for a spawned world, start-up included

PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), os.environ["OUT"]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(OUT, "store"), WORLD),
                        rank=RANK, world_size=WORLD)


def unflatten(npz):
    tree = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return tree


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, prefix + k + "/").items()}
    return {prefix[:-1]: tree.detach().cpu().numpy()}
"""
EPILOGUE = """
try:
    main()
finally:
    dist.destroy_process_group()
"""


def run_ranks(out, world: int, body: str, timeout: float = RANK_TIMEOUT, **env) -> list[str]:
    """Run ``body`` (which defines ``main()``) on ``world`` gloo ranks, one
    process each, with ``env`` added to their environment; every rank must
    exit 0 within ``timeout`` seconds.  Returns each rank's output."""
    script = PRELUDE + textwrap.dedent(body) + EPILOGUE
    env = {**os.environ, "PYTHONPATH": SRC, "WORLD_SIZE": str(world), "OUT": str(out),
           "OMP_NUM_THREADS": "1", **env}
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script], env={**env, "RANK": str(r)},
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:  # until all exit, one fails (its peers may wait on it forever) or time is up
        while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
               and not any(p.returncode for p in procs)):
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    outs = [open(log.name).read() for log in logs]
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text}"
    return outs
