#!/usr/bin/env python3
"""Time the PyTorch port's simt decode body (``csrc/decode_tile_simt.cu``)
and variants of its source, on one GPU.

    python3 scripts/torch_decode_simt.py [--variants FILE]

A variant is the checkout's ``decode_tile_simt.cu`` and the gate product
it includes, ``simt_tile.cuh``, with text substitutions applied (each to
the file that holds its text).  ``FILE`` is a JSON object, name -> ``{"subs":
[[old, new], ...], "tiles": {"H,R": tile}}`` (both keys optional; "tiles"
overrides ``simt_tile`` at a shape); without it the one variant is the
body as it is.  Each variant is built alone with ``nvcc`` and the
package's flags into ``build/decode_simt_variants/<name>/``, all in parallel,
and called through its C entry on the operands ``bucket_operands`` lays
out.  Per variant it prints its ptxas registers and spills, then per shape
of ``chip_smoke.WIDE_TIMING`` (B 65,536, T 10, M 8, f32, inputs from seed
0 scaled to the width as ``chip_smoke.py`` scales them) one JSON line:

* ``ms``: CUDA events, mean of 20 launches after 2 warm-ups;
* ``max_abs_err`` against the plain version on the card (a variant that
  removes a phase computes something else, and its error says so);
* ``bound_ms`` and ``share``: ``chip_smoke.decode_cost`` over 67 TFLOP/s
  FP32, and that bound over ``ms``; ``plain_ms`` (5 calls).

``scripts/decode_simt_knockouts.json`` holds the variants that split the
body's time by phase.  The last line is the card's name and power limit
from ``nvidia-smi``.  It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "build", "decode_simt_variants")
VARIANT_SOURCES = ("decode_tile_simt.cu", "simt_tile.cuh")  # the body first


def build(item: tuple[str, dict]) -> tuple[str, str, str]:
    """Compile one variant -> (name, library path, nvcc output).  The
    variant's copies of the body and ``simt_tile.cuh`` sit side by side, so
    the body's include finds the copy; other headers come from ``csrc/``."""
    from repro_torch.kernels import _build

    name, spec = item
    texts = {}
    for source in VARIANT_SOURCES:
        with open(os.path.join(CSRC, source)) as f:
            texts[source] = f.read()
    for old, new in spec.get("subs", []):
        holders = [source for source, text in texts.items() if old in text]
        if not holders:
            raise ValueError(f"variant {name}: {old!r} is in none of {VARIANT_SOURCES}")
        texts[holders[0]] = texts[holders[0]].replace(old, new)
    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    for source, text in texts.items():
        with open(os.path.join(out, source), "w") as f:
            f.write(text)
    cu, so = os.path.join(out, VARIANT_SOURCES[0]), os.path.join(out, f"{name}.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", cu,
                          "-o", so], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, so, res.stdout + res.stderr


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_simt: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from repro_torch.kernels import decode_tile, ref
    from repro_torch.kernels._common import DTYPE_CODES

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"body": {}}
    if args.variants:
        with open(args.variants) as f:
            variants = json.load(f)
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants.items()))
    device = torch.device("cuda")
    plain_ms = {}
    for name, so, log in built:
        ptxas = smoke.ptxas_resources(log)
        print(json.dumps({"variant": name, "ptxas": [
            {k: row[k] for k in ("registers", "spill_store_bytes", "spill_load_bytes",
                                 "stack_bytes")} for row in ptxas]}), flush=True)
        fn = ctypes.CDLL(so).repro_decode_tile_simt
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for hid, rank in smoke.WIDE_TIMING:
            b, t, m = smoke.REQUEST, 10, 8
            gen = torch.Generator().manual_seed(0)
            idx, ws = smoke.decode_inputs(torch, gen, b, t, m, hid, rank, torch.float32,
                                          device, width_scaled=True)
            laid = decode_tile.bucket_operands(ws)
            rp = decode_tile.simt_rank(rank)
            tile = variants[name].get("tiles", {}).get(f"{hid},{rank}",
                                                       decode_tile.simt_tile(hid, rp))
            out = torch.empty((b,), device=device)

            def call():
                err = fn(idx.data_ptr(), *(w.data_ptr() for w in laid), out.data_ptr(), b, t, m,
                         hid, rp, tile, DTYPE_CODES[torch.float32],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")
                return out

            want = ref.nttd_decode_tile(idx, *ws)
            if (hid, rank) not in plain_ms:
                plain_ms[hid, rank] = smoke.time_ms(
                    torch, lambda: ref.nttd_decode_tile(idx, *ws), 5)
            row = {"variant": name, "H": hid, "R": rank, "B": b, "T": t, "tile": tile,
                   "max_abs_err": float((call() - want).abs().max()),
                   "ms": smoke.time_ms(torch, call, 20), "plain_ms": plain_ms[hid, rank],
                   **smoke.bound(smoke.decode_cost(b, t, hid, rank), 0, smoke.PEAK_FP32)}
            row["share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
