"""End-to-end driver on the PyTorch port: serve a small LM with batched
requests through the continuous-batching engine, as
``examples/serve_llm.py`` does with the JAX package.

    PYTHONPATH=src python examples/torch_serve_llm.py [--device cpu] [--requests 12]

Runs on ``--device``, CUDA unless given; the engine's prefill attention is
``attn_impl="auto"``, the flash kernel there (the plain oracle on the CPU).
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch import configs
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="CUDA unless given")
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(configs.get_smoke("qwen1.5-4b"), attn_impl="auto")
    print(f"serving {cfg.arch_id}: {cfg.n_layers}L d{cfg.d_model} vocab {cfg.vocab}")
    params = model.init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=96)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.requests):
        engine.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab, size=rng.integers(8, 24)),
            max_new_tokens=12,
        ))
    results = engine.run()
    dt = time.time() - t0
    total = sum(len(r.tokens) for r in results)
    for r in sorted(results, key=lambda r: r.uid)[:3]:
        print(f"  req {r.uid}: generated {r.tokens}")
    print(f"{len(results)} requests, {total} tokens, {dt:.1f}s "
          f"({total / dt:.1f} tok/s on {device})")


if __name__ == "__main__":
    main()
