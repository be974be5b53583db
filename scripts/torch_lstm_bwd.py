#!/usr/bin/env python3
"""Time the PyTorch port's ``lstm_scan`` backward (``csrc/lstm_bwd.cu`` and
its wrapper) at ``chip_smoke.py``'s backward shapes, on one GPU.

    python3 scripts/torch_lstm_bwd.py [--root DIR] [--variants FILE] [--chunks N,...]
                                      [--cases B,T,H;...]

``--root`` names a checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so two versions are compared on one card by
running the script once per checkout in one call, in the order A, B, B, A.
Per (B, T, H) of ``chip_smoke.BWD_LSTM_CASES``, or of ``--cases`` (inputs
from ``chip_smoke.lstm_bwd_inputs``, seed 0, hs from the forward kernel),
it prints one JSON line:

* ``ms``: the whole call, ``lstm.lstm_scan_bwd`` (dx, dwi, dwh, db);
  ``kernel_ms``: the kernel alone, ``lstm.bwd_gates``; CUDA events, mean of
  20 launches after 2 warm-ups;
* ``max_abs_err``: each gradient against the plain version on the card;
* ``kernel_bound_ms`` and ``kernel_bound_by``, ``bound_ms`` and
  ``bound_by``: ``chip_smoke.lstm_bwd_kernel_cost`` and ``lstm_bwd_cost``
  over 67 TFLOP/s FP32 or 3.35 TB/s;
* ``device_ops_per_call``: the device kernels and copies of one whole
  call with their device microseconds, every case's call in one
  ``torch.profiler`` session.

``--variants FILE`` instead builds variants of this checkout's
``lstm_bwd.cu``: a JSON object, name -> ``{"subs": [[old, new], ...],
"plan": {field: value}, "plans": {"H": {field: value}}}`` (all optional;
"plan" overrides fields of ``lstm.bwd_plan`` at every case, e.g.
``{"tile": 16, "threads": 64}``, "plans" at one hidden width).
``scripts/lstm_bwd_variants.json`` holds the variants that split the
kernel's time by phase, and ``wide_pipeline``: the wide plan's weights
staged through shared memory by ``simt_tile.cuh``'s double-buffered
``pipeline`` instead of read through L1 (time it with ``--cases
"1024,5,256;2048,10,114"``).  Each is built alone
with ``nvcc`` and the package's flags into
``build/lstm_bwd_variants/<name>/``, all in parallel, and called through
its C entry; per variant it prints its ptxas registers and spills, then
per case its kernel ms and its dx's, G's and A's largest difference from
this checkout's kernel (a variant that removes a phase computes something else,
and that difference says so).

``--chunks 256,2048`` instead times the weight gradients' product alone
(``lstm.weight_grads``) at each chunk size of rows, on the kernel's A and G
padded to it, per case: ms (CUDA events, 20 calls after 2 warm-ups) and
the largest error of [dwi; dwh; db] against A^T G in f64.

The last line is the card's name and power limit from ``nvidia-smi``.  It
exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "build", "lstm_bwd_variants")


def build(item: tuple[str, dict]) -> tuple[str, str, str]:
    """Compile one variant of ``lstm_bwd.cu`` -> (name, library, nvcc
    output); its headers come from ``csrc/``."""
    from repro_torch.kernels import _build

    name, spec = item
    with open(os.path.join(CSRC, "lstm_bwd.cu")) as f:
        text = f.read()
    for old, new in spec.get("subs", []):
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in lstm_bwd.cu")
        text = text.replace(old, new)
    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "lstm_bwd.cu"), os.path.join(out, f"{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", cu,
                          "-o", so], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, so, res.stdout + res.stderr


def run_variants(torch, smoke, path: str, shapes) -> None:
    from repro_torch.kernels import lstm

    with open(path) as f:
        variants = json.load(f)
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants.items()))
    device = torch.device("cuda")
    cases = []
    for b, t, h in shapes:
        x, lw, dhs = smoke.lstm_bwd_inputs(torch, torch.Generator().manual_seed(0), b, t, h,
                                           device)
        hs = lstm.lstm_scan(x, *lw)
        cases.append((b, t, h, x, lw, hs, dhs, lstm.bwd_gates(x, *lw, hs, dhs)))
    for name, so, log in built:
        print(json.dumps({"variant": name, "ptxas": [
            {k: row[k] for k in ("kernel", "registers", "spill_store_bytes", "spill_load_bytes")}
            for row in smoke.ptxas_resources(log)]}), flush=True)
        fn = ctypes.CDLL(so).repro_lstm_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        spec = variants[name]
        for b, t, h, x, lw, hs, dhs, want in cases:
            plan = dataclasses.replace(lstm.bwd_plan(h, b), **spec.get("plan", {}),
                                       **spec.get("plans", {}).get(str(h), {}))
            dx, g, a = (torch.zeros_like(w) for w in want)
            scratch = torch.empty((max(1, plan.scratch_floats(b, t)),), device=device)
            wt = lstm.bwd_weights(lw[0], lw[1])

            def call():
                err = fn(x.data_ptr(), lw[0].data_ptr(), lw[1].data_ptr(), wt.data_ptr(),
                         lw[2].data_ptr(), hs.data_ptr(), dhs.data_ptr(), dx.data_ptr(),
                         g.data_ptr(), a.data_ptr(), scratch.data_ptr(), b, t, h, plan.tile,
                         plan.threads, lstm.BWD_KINDS.index(plan.kind),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")

            call()
            print(json.dumps({
                "variant": name, "B": b, "T": t, "H": h, "plan": dataclasses.asdict(plan),
                "kernel_ms": smoke.time_ms(torch, call, 20),
                **{f"{k}_diff": float((got - w).abs().max())
                   for k, got, w in zip(("dx", "g", "a"), (dx, g, a), want)}}), flush=True)


def run_cases(torch, smoke, root: str, shapes) -> None:
    from repro_torch.kernels import lstm, ref

    device = torch.device("cuda")
    calls = []
    for b, t, h in shapes:
        x, lw, dhs = smoke.lstm_bwd_inputs(torch, torch.Generator().manual_seed(0), b, t, h,
                                           device)
        hs = lstm.lstm_scan(x, *lw)
        got = lstm.lstm_scan_bwd(x, *lw, hs, dhs)
        want = ref.lstm_scan_bwd(x, *lw, dhs)
        k_ops, k_bytes = smoke.lstm_bwd_kernel_cost(b, t, h)
        kernel_bound = smoke.bound(k_ops, k_bytes, smoke.PEAK_FP32)
        print(json.dumps({
            "root": root, "B": b, "T": t, "H": h,
            "ms": smoke.time_ms(torch, lambda: lstm.lstm_scan_bwd(x, *lw, hs, dhs), 20),
            "kernel_ms": smoke.time_ms(torch, lambda: lstm.bwd_gates(x, *lw, hs, dhs), 20),
            "max_abs_err": dict(zip(("dx", "dwi", "dwh", "db"), (
                float((g - w).abs().max()) for g, w in zip(got, want)))),
            "kernel_bound_ms": kernel_bound["bound_ms"],
            "kernel_bound_by": kernel_bound["bound_by"],
            **smoke.bound(*smoke.lstm_bwd_cost(b, t, h), smoke.PEAK_FP32)}), flush=True)
        calls.append((lambda x=x, lw=lw, hs=hs, dhs=dhs: lstm.lstm_scan_bwd(x, *lw, hs, dhs)))
    ops = smoke.device_kernels(torch, calls, times=True)
    print(json.dumps({"root": root, "device_ops_per_call": {
        h: [[name[:100], us] for name, us in call]
        for (_, _, h), call in zip(shapes, ops)}}), flush=True)


def run_chunks(torch, smoke, chunks: list[int], shapes) -> None:
    from repro_torch.kernels import lstm

    device = torch.device("cuda")
    default = lstm.BWD_CHUNK
    for b, t, h in shapes:
        x, lw, dhs = smoke.lstm_bwd_inputs(torch, torch.Generator().manual_seed(0), b, t, h,
                                           device)
        _, g, a = lstm.bwd_gates(x, *lw, lstm.lstm_scan(x, *lw), dhs)
        bt = b * t
        exact = a[:bt].double().t() @ g[:bt].double()
        for chunk in chunks:
            rows = -(-bt // chunk) * chunk
            ap, gp = a.new_zeros((rows, a.shape[1])), g.new_zeros((rows, g.shape[1]))
            ap[:bt], gp[:bt] = a[:bt], g[:bt]
            lstm.BWD_CHUNK = chunk
            try:
                got = torch.cat([w.reshape(-1, 4 * h) for w in lstm.weight_grads(ap, gp)])
                ms = smoke.time_ms(torch, lambda: lstm.weight_grads(ap, gp), 20)
            finally:
                lstm.BWD_CHUNK = default
            print(json.dumps({"B": b, "T": t, "H": h, "chunk": chunk, "ms": ms,
                              "max_abs_err_vs_f64": float((got.double() - exact).abs().max()),
                              "largest": float(exact.abs().max())}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variants", default=None)
    parser.add_argument("--chunks", default=None)
    parser.add_argument("--cases", default=None, help='"B,T,H;B,T,H": shapes to time')
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_bwd: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = (smoke.BWD_LSTM_CASES if args.cases is None else
              [tuple(int(v) for v in case.split(",")) for case in args.cases.split(";")])
    if args.chunks:
        run_chunks(torch, smoke, [int(c) for c in args.chunks.split(",")], shapes)
    elif args.variants:
        run_variants(torch, smoke, args.variants, shapes)
    else:
        run_cases(torch, smoke, os.path.relpath(root, HERE), shapes)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
