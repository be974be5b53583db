#!/usr/bin/env python3
"""Time the PyTorch port's ``tt_contract`` backward (``csrc/tt_contract_bwd.cu``
and its wrapper) at ``chip_smoke.py``'s backward shapes, on one GPU.

    python3 scripts/torch_tt_bwd.py [--root DIR] [--cases "B,K,R;..."] [--entries 4,8,16]
                                    [--variants FILE]

``--root`` names a checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so two versions are compared on one card by
running the script once per checkout in one call, in the order A, B, B, A.
Per (B, K, R) of ``chip_smoke.BWD_TT_CASES``, or of ``--cases`` (inputs
from ``chip_smoke.tt_bwd_inputs``, seed 0), it prints one JSON line:

* ``ms``: ``tt_contract.tt_contract_bwd``, CUDA events, mean of 20 calls
  after 2 warm-ups, back to back (where a call's host work outlasts its
  kernel, this is the host's time a call);
* ``kernel_ms``: the device time of one call's kernel, the median of
  ``REPEATS`` calls, each framed by idle host time and preceded by a write
  of ``FLUSH_BYTES`` that evicts the 50 MB L2 (so a call whose operands
  would fit there reads them cold, as a training step does), every call of
  the run in one ``torch.profiler`` session (``chip_smoke.device_kernels``);
  ``device_ops``: the device operations of a call;
* ``bound_ms`` and ``bound_by`` (``chip_smoke.tt_bwd_cost`` over 67 TFLOP/s
  FP32 or 3.35 TB/s); ``share`` and ``kernel_share``, the bound over
  ``ms`` and over ``kernel_ms``;
* ``max_abs_err``: each gradient against the plain version on the card;
* ``plan``: the launch ``tt_contract.bwd_plan`` picks, where the checkout
  has one.

``--entries`` also times the slab plan at each count of entries a slab
(``tt_contract.slab_plan``, launched through the kernel's C entry) at
every case that plan takes, one line each (a count whose block exceeds
the plan's threads or shared memory is skipped).  ``--variants FILE``
also builds variants of this checkout's ``tt_contract_bwd.cu``, a JSON
object name -> ``{"subs": [[old, new], ...]}``
(``scripts/tt_bwd_variants.json``: knock-outs that remove one phase of
the slab plan each, and the wide plan's stores of dmid), each with
``nvcc`` and the package's flags into ``build/tt_bwd_variants/<name>/``,
all in parallel, and times each at
every case through its C entry with ``bwd_plan``'s launch, one line each
with its ptxas registers and its largest difference from this checkout's
kernel (a knock-out computes something else, and that difference says
so).  The last line is the card's name and power limit from
``nvidia-smi``.  It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys

REPEATS = 5
FLUSH_BYTES = 256 << 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "build", "tt_bwd_variants")


def build(item: tuple[str, dict]) -> tuple[str, str, str]:
    """Compile one variant of ``tt_contract_bwd.cu`` -> (name, library,
    nvcc output); its headers come from ``csrc/``."""
    from repro_torch.kernels import _build

    name, spec = item
    with open(os.path.join(CSRC, "tt_contract_bwd.cu")) as f:
        text = f.read()
    for old, new in spec.get("subs", []):
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in tt_contract_bwd.cu")
        text = text.replace(old, new)
    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "tt_contract_bwd.cu"), os.path.join(out, f"{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", cu,
                          "-o", so], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, so, res.stdout + res.stderr


def launcher(torch, fn, operands, plan, name: str):
    """A call of the C entry ``fn`` in ``plan`` on ``operands`` (first,
    mid, last, dout), writing gradients made once; it returns them."""
    grads = tuple(torch.zeros_like(a) for a in operands[:3])
    (bsz, rank), k_steps = operands[0].shape, operands[1].shape[1]

    def call():
        err = fn(*(a.data_ptr() for a in (*operands, *grads)), bsz, k_steps, rank,
                 ("slab", "wide").index(plan.kind), plan.entries, plan.stride, plan.threads,
                 plan.blocks, plan.cluster, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return grads
    return call


def variant_calls(torch, smoke, path: str, cases) -> list[tuple[dict, object]]:
    """(row, call) of every variant in ``path`` at every case: the call
    launches the variant's kernel in ``bwd_plan``'s launch."""
    with open(path) as f:
        variants = json.load(f)
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants.items()))
    out = []
    for name, so, log in built:
        ptxas = [{k: row[k] for k in ("kernel", "registers", "spill_store_bytes")}
                 for row in smoke.ptxas_resources(log)]
        fn = ctypes.CDLL(so).repro_tt_contract_bwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for (b, k, r), operands, mine, plan in cases:
            call = launcher(torch, fn, operands, plan, f"variant {name}")
            grads = call()
            out.append(({"variant": name, "ptxas": ptxas, "B": b, "K": k, "R": r,
                         "ms": smoke.time_ms(torch, call, 20),
                         "diff": max(float((g - w).abs().max()) for g, w in zip(grads, mine)),
                         "plan": dataclasses.asdict(plan)}, call))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--cases", default=None, help='"B,K,R;B,K,R": shapes to time')
    parser.add_argument("--entries", default=None, help="slab sizes to time: 4,8,16")
    parser.add_argument("--variants", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tt_bwd: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import tt_contract as tt
    from repro_torch.kernels._common import MAX_SMEM_BYTES

    shapes = (smoke.BWD_TT_CASES if args.cases is None else
              [tuple(int(v) for v in case.split(",")) for case in args.cases.split(";")])
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    names = ("dfirst", "dmid", "dlast")
    rows, calls, cases = [], [], []
    for b, k, r in shapes:
        operands = smoke.tt_bwd_inputs(torch, torch.Generator().manual_seed(0), b, k, r, device)
        want = ref.tt_contract_bwd(*operands)
        cost = smoke.bound(*smoke.tt_bwd_cost(b, k, r), smoke.PEAK_FP32)
        # the wrapper in its own plan (the only one a checkout without
        # bwd_plan has), then the slab plan at each --entries
        plans = [(tt.bwd_plan(r, k, b, sms) if hasattr(tt, "bwd_plan") else None,
                  lambda operands=operands: tt.tt_contract_bwd(*operands))]
        if plans[0][0] is not None:
            cases.append(((b, k, r), operands, tt.tt_contract_bwd(*operands), plans[0][0]))
            if args.entries and plans[0][0].kind == "slab":
                fn = _build.library().repro_tt_contract_bwd
                plans += [(plan, launcher(torch, fn, operands, plan, "tt_contract_bwd"))
                          for plan in (tt.slab_plan(r, k, b, int(e), sms)
                                       for e in args.entries.split(","))
                          if plan.threads <= tt.BWD_SLAB_THREADS
                          and plan.smem_bytes <= MAX_SMEM_BYTES]
        for plan, call in plans:
            got = call()
            ms = smoke.time_ms(torch, call, 20)
            rows.append({
                "root": os.path.relpath(root, HERE), "B": b, "K": k, "R": r, "ms": ms, **cost,
                "share": cost["bound_ms"] / ms,
                "max_abs_err": dict(zip(names, (float((g - w).abs().max())
                                                for g, w in zip(got, want)))),
                "plan": None if plan is None else dataclasses.asdict(plan)})
            calls.append(call)
    if args.variants:
        for row, call in variant_calls(torch, smoke, args.variants, cases):
            row.update(smoke.bound(*smoke.tt_bwd_cost(row["B"], row["K"], row["R"]),
                                   smoke.PEAK_FP32))
            rows.append(row)
            calls.append(call)
    scratch = torch.empty(FLUSH_BYTES // 4, device=device)
    seen = smoke.device_kernels(torch, [fn for call in calls for _ in range(REPEATS)
                                        for fn in (scratch.zero_, call)], times=True)[1::2]
    for n, row in enumerate(rows):
        profiled = seen[n * REPEATS:(n + 1) * REPEATS]
        row["kernel_ms"] = statistics.median(sum(us for _, us in ops) for ops in profiled) / 1e3
        row["kernel_share"] = row["bound_ms"] / row["kernel_ms"]
        row["device_ops"] = [name[:60] for name, _ in profiled[0]]
        print(json.dumps(row), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
