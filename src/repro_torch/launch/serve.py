"""Serving launcher: batched requests through the slot engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        --requests 8 --slots 4 --prompt-len 128,2048,300 --max-new 16 --max-len 4096

Port of ``repro.launch.serve`` with the same flags, plus ``--device``
(CUDA unless given), ``--attn-impl`` (``auto``, the flash kernel, unless
given; ``ref`` serves through the oracle) and ``--keep-logits`` (keep each
prefill's logits in its result).  ``--prompt-len`` also takes
comma-separated lengths, cycled over the requests.  Weights are random
(seed 0, as in the reference) and held in the compute dtype (bf16 for the
full-size configs), which gives the values the reference gets by casting
its f32 masters at every use.  ``main(argv)`` returns the results.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", default="16",
                    help="a prompt length, or comma-separated lengths cycled over the requests")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--keep-logits", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl, param_dtype=cfg.compute_dtype)
    lens = [int(n) for n in args.prompt_len.split(",")]
    params = model.init_params(cfg, 0, device)
    engine = ServeEngine(cfg, params, args.slots, args.max_len,
                         temperature=args.temperature,
                         keep_prefill_logits=args.keep_logits)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.requests):
        engine.submit(
            Request(
                uid=uid,
                prompt=rng.integers(0, cfg.vocab, size=lens[uid % len(lens)]),
                max_new_tokens=args.max_new,
            )
        )
    results = engine.run()  # ends in a read of the last sampled token
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in results)
    for r in sorted(results, key=lambda r: r.uid)[:4]:
        print(f"req {r.uid}: {r.tokens[:8]}...")
    print(
        f"served {len(results)} requests, {total_new} tokens in {dt:.2f}s "
        f"({total_new/dt:.1f} tok/s)"
    )
    return results


if __name__ == "__main__":
    main()
