#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py            # from the root of the checkout

Phases, each printing JSON lines:

1. device: the card's name and power limit, and the kernel build
   (``nvcc`` for ``sm_90a`` from ``src/repro_torch/kernels/csrc``) with
   each kernel's registers, shared memory, stack and spills from
   ``-Xptxas -v`` (the ``lstm_scan`` register body at H 16, the main
   path's, must not spill and must leave room for three blocks a SM);
   the simt decode body's resources, which must show no spills, and its
   tile of entries and shared-memory bytes at each wide shape
   (``device.decode_simt``); the simt ``lstm_scan`` body's resources,
   which must show no spills either, and its tile of sequences and
   shared-memory bytes at H 68, 96, 114 and 256 (``device.lstm_simt``);
   then the count of
   tensor-core instructions (``HGMMA``) per kernel in the library's SASS
   (``cuobjdump -sass``).
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   over the reference's test grid (R in {4, 8, 32}, T in {2, 3, 8}, f32
   and bf16, B = 33 and B = 0), at the main path's shapes, at H = 64,
   R = 32, at every instantiated (H, R) bucket of ``decode_tile`` and at
   shapes padded to one (H 12, R 5; the paper's 12/6 and 18/10), and
   at a step of the stream phase (B 8192, T 14, M 8, H 12, R 6: K 12),
   through its simt body above the largest bucket at the reference budget
   rule's (68, 34) and (114, 57) (B 4096, T 10) and (256, 128) (B 1000,
   T 5), on inputs scaled to the width; every decode case names its body
   (``decode_body``) and bucket or simt tile of entries
   (``kernels.decode_buckets``);
   ``lstm_scan`` at B 1000, T 10 at every hidden bucket of its register
   body (12, 16, 20, 32, 64), at widths padded into one (5, 18, 24), on an
   x whose rows are off the 16-byte grid (the scalar-load route), and at
   H 68, 96, 114 and 256 through its simt body; every lstm case names its
   body, bucket or simt tile of sequences, and load route
   (``kernels.lstm_buckets``);
   ``tt_contract`` over the reference's grid and at R 34, 57 and 128, each
   case with its lanes per entry (``kernels.tt_cases``);
   ``flash_attention`` over the reference's
   attention grid, ``q_offset`` 128, odd and ragged lengths (the pad path),
   starcoder2's 48/4 grouping, fully masked rows (``q_offset`` < 0), head
   dims 8, 64 and 128, the serve path's shapes up to S 4096, and the edges
   of the tensor-core body (B 2 with GQA 4/1, D 64 at S 1024, ``q_offset``
   > 0 with Skv > Sq, ``kv_valid`` inside a kv tile, fully masked rows at
   D 128); every flash case names the body that ran (``flash_body``).
   Tolerance: 1e-5 in f32, 0.1 in bf16 (rtol = atol); in bf16
   also at most 2 bf16 ulps of the case's largest plain value, a limit
   that scales with the data.  Every bf16 flash output is also held
   element by element: within 1 bf16 ulp of each element's own value plus
   2^-16 of its row's largest, which a kernel that rounds p to bf16
   fails (the timing row shows that on a bf16-p control).
   kernels.bwd: the two backward kernels (``lstm_scan``'s, ``csrc/lstm_bwd.cu``,
   and ``tt_contract``'s, ``csrc/tt_contract_bwd.cu``) against their plain
   versions, autograd of the plain forwards: ``lstm_scan`` at (B 8192, T 10,
   H 12), (8192, 10, 18), (4096, 10, 68), (1024, 5, 256) and the stream's
   (8192, 14, 12), ``tt_contract`` at (B 8192, K 8, R 6), (8192, 8, 10),
   (4096, 8, 34), (256, 4, 128), (1001, 8, 10), B off the block, (1001, 3,
   5) and the stream's (8192, 12, 6), on the operands a training step makes
   (``training_inputs``); each gradient within atol 1e-5 + rtol 1e-4 of its
   largest value, and every ``lstm_scan`` gradient no further from an f64
   evaluation than 4x the plain version's (a weight's gradient sums B T
   rows, which near 0 no two f32 summation orders hold to 1e-5); then once
   through autograd, where the Functions' backward passes must be the
   kernels.  The device phase prints their ptxas rows and the
   ``lstm_scan`` backward's plan at each case (``device.bwd``); that kernel
   must not spill.
3. golden: the four golden files (``tests/golden/v2_nttd.bin``,
   ``v3_mono.tcdc``, ``v3_chunked.tcdc`` and ``v4_delta.tcdc`` at its
   latest version) loaded with ``load_bytes(..., device="cuda")`` and
   decoded against ``tests/golden/expected.npz`` (rtol 1e-5, atol 1e-6),
   and the chunked
   NTTD payload ``benchmarks/results/fig5_stream_payload.tcdc`` decoded
   whole through the kernel against the plain version.
4. main path: a PEMS-SF-shaped (963 x 144 x 440) NTTD payload at the
   default architecture (rank 8, hidden 16) with random weights from a
   seed is saved to a v3 container, loaded onto the card with
   ``load_bytes``, answers 8 ``decode_at`` requests of 65,536 entries
   through the fused kernel and 2 through ``lstm_scan`` + ``tt_contract``,
   and reconstructs all 61,015,680 entries with ``to_dense``.  Everything
   is compared with the plain version on the card, and every kernel must
   have been launched by this phase.
5. wide: the payloads the reference's budget rule makes at 1 MB, decoded
   through the default impl: a PEMS-SF-shaped payload at hidden 68, rank
   34 saved, loaded onto the card and asked two ``decode_at`` requests of
   65,536 entries, and an Uber-shaped one (183 x 24 x 1140, paper Table II)
   reconstructed whole with ``to_dense``, both against the plain version
   on the card (rtol = atol = 1e-5).  Every fused launch of the phase must
   be the simt decode body's.  Two more ``decode_at`` requests of the
   PEMS-SF payload go through the unfused route (``kernel_impl="cuda"``):
   ``lstm_scan`` at B 65,536, T 10, H 68 on its simt body, then
   ``tt_contract`` at K 8, R 34, held to the plain route at 1e-5; the
   phase launches each exactly twice.
6. fit: Alg. 1 at full width, ``get_codec("nttd").fit`` on its default
   device with the paper's MEDIUM (rank 10, hidden 18, batch 8192, lr
   1e-2) on the PEMS-SF replica at its Table II shape (963 x 144 x 440,
   ``repro_torch.data.synthetic_tensors``), 6 epochs of 2^21 entries with
   one Alg. 3 sweep (the cuts are in its ``reduced`` field).  Every
   training step launches the forward and backward ``lstm_scan`` and
   ``tt_contract`` kernels once, every epoch's fitness the fused decode,
   and no plain version runs (counted).  It prints the seconds of TSP
   init, training, reorder and fitness, steps/s, entries/s, the fitness
   and loss per epoch, the swaps, the launches and the payload's size; the
   payload's exact fitness over all entries must match the best sampled
   one within 1e-2, and the saved payload must load and answer as fitted.
   fit.parity: ``compress`` twice on the mini replica from the same seed,
   the plain versions ("ref") against the kernels ("auto"): fitness within
   1e-3 at every epoch; a mode whose accepted swaps differ is printed.
   stream: out-of-core compression at the reference's fig5 FULL shape,
   ``fit_stream("nttd", SyntheticTensorSource((16384, 64, 64),
   slab_entries=2^18, seed=1), rank=6, hidden=12, steps_per_slab=2,
   batch_size=8192, lr=2e-2, seed=0)`` on its default device: 2^26
   entries in 256 slabs, 512 steps, the tensor never materialised (lr is
   the reference's end-to-end stream test's; ``STREAM_CHANGED``).  Every
   step launches the forward and backward ``lstm_scan`` and
   ``tt_contract`` kernels once and no plain version runs (counted).  The
   payload goes through ``write_chunked(..., chunk_bytes=2048)`` with a
   ``sample_heldout`` sample of five slabs into a temporary directory,
   ``load_file(..., device="cuda")`` reads it back and answers 65,536
   entries through the fused kernel, equal to the fitted payload's
   answers; its decode must correlate with ``values_at`` over 2^20
   entries above 0.5; a second fitter resumed at slab 128 must give the
   same ``save_bytes``.  It prints the seconds by part (source values,
   host sampling, training dispatch, the device's drain, reservoir, write,
   read), slabs/s, steps/s, entries/s, the correlation, the payload's
   bytes, the launches and the card's name and power limit.
   stream.parity: the first 16 slabs through "ref" and "auto" from the
   same seed: every param within rtol 1e-4 / atol 1e-6, the sampled
   fitness within 1e-3.  stream.delta: a (256, 64, 64) keyframe from
   ``fit_stream`` and two residuals (0.05 x the seed-2 and seed-3
   sources) from one ``DeltaFitter``, written by the delta-mode
   ``ChunkedWriter`` with a ``sync()`` after each version; read back on
   the card it is a ``ChainEncoded`` whose answers are the f64 sum of its
   components', one fused launch each.
   service (``phase_service``): the codec service on the card.  Phase
   main's PEMS-SF payload is written as a chunked v3 file of 8 chunks
   with a held-out block of 4,096 entries (the plain route's decode), and
   a ``VersionedStore`` is written on the card at fig10's NTTD settings
   ((24, 16, 16), 8 versions, keyframe interval 8; its fits launch the
   four training kernels and the fused decode, no plain version;
   ``service.store``).  ``CodecService(cache_bytes=64 MiB,
   canary_fraction=0.25, canary_min_fitness=0.999)`` serves the PEMS-SF
   file lazily, direct and through tiles of 65,536 entries (932 tiles of
   256 KiB), phase stream's fig5 file and phase stream.delta's and the
   store's v4 files: 32 direct requests of 65,536 entries, 64 tiled
   requests inside a window of 64 tiles, one request swept over 512 tiles
   (which must evict), 64 submits of 1,024 entries and one flush, every
   version of both v4 files and 8 requests of the fig5 file (canaries).
   The traffic runs with prefetch off, on, with tracing on, and through
   the plain route (``REPRO_DECODE_IMPL=ref``): answers and stats of the
   first three bitwise equal, every answer within 1e-5 of the plain
   pass's, versioned answers equal to ``VersionedReader.decode_at``.  The
   first pass runs no plain version and launches ``decode_tile`` exactly
   once per counted decode call and canary check; resident bytes stay
   within the budget; device memory is what the materialized payloads hold
   (within 1 MiB) at every check and back to the baseline after the
   unloads; the trace holds the service's spans and ``kernel_decode`` and
   exports to JSON that loads.  It prints request ms (direct, tiled miss
   and hit, sweep, flush, versioned), the traced materialize ms, the hit
   ratio, resident bytes, launches, the canary stats and breach events.
   fleet (``phase_fleet``): the serving fleet on the card, over phase
   service's PEMS-SF file and traffic (direct requests, window requests,
   the sweep, 64 submits and a flush).  ``fleet.local``: 4 in-process
   members, replication 2, 64 MiB and canaries 0.25 each; every answer
   bitwise phase service's first pass, zero failed tickets, each member's
   resident bytes within its budget, a rebalance removing ``i3`` and one
   adding ``i4`` (submits queued before each all answered after it; the
   add warms tiles into ``i4``), the direct requests again after each,
   ``decode_tile`` launched exactly once per decode call and canary check
   the members report, no plain version.  ``fleet.procs``: 3
   ``repro_torch.fleet.worker`` processes on the card, started together,
   over the same file and traffic, bitwise the same; each worker holds a
   CUDA context (its pid in ``nvidia-smi``, or, where nvidia-smi reports
   the container's processes under another pid, the card's device node
   open in the worker and the card's used memory grown by 100 MiB a
   worker); one traced request is one trace whose worker spans, down to
   ``kernel_decode``, hang under the frontend's ``transport.flush``; the
   frontend launches nothing; ``close()`` leaves no worker behind.  Both
   print request ms, spawn seconds and a traced request's split between
   the frontend and its members.  ``fleet.slo`` and ``fleet.repair`` run
   ``scripts/torch_slo_smoke.py`` and ``scripts/torch_repair_drill.py``
   on the card (the controller admits and retires ``s0``; a corrupt chunk
   restored byte-exactly; the quality refit launching ``lstm_scan``,
   ``tt_contract`` and both backward kernels here, no plain version, the
   canary clearing), printing ``time_to_repair_s`` and the refit's
   entries/s.  Every kernel row gets ``launches_fleet``: this process's
   launches in the phase (workers count theirs in their own processes).
7. serve: the LM serving path, ``repro_torch.launch.serve.main`` on
   qwen1.5-4b at full width (40 layers, d_model 2560, 20 heads of 128,
   vocab 151,936) in bf16 with random weights from seed 0: 8 requests of
   seeded prompt lengths (128, 2048 and six others, at least one not a
   multiple of 128) over 4 slots, 16 new tokens each, max_len 4096.  Every
   prefill attention must go through the flash kernel (40 launches per
   prompt).  The same requests are served again through the oracle
   (``--attn-impl ref``): the prefill logits must agree within
   ``LOGIT_REL_TOL`` of max|logit|, and the greedy tokens wherever the
   oracle run's top-2 margin exceeds twice the largest logit difference.
8. timing: each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function (cuDNN ``nn.LSTM`` for
   ``lstm_scan``, one ``torch.einsum`` over the whole chain for
   ``tt_contract``, ``scaled_dot_product_attention`` for
   ``flash_attention``, with its error beside the kernel's) at the main
   paths' shapes, with CUDA events; the bound is computed from the shapes
   against the H100 SXM's published peaks.  At the flash timing shape the
   kernel's error must be below SDPA's and pass the per-element check,
   and a bf16-p control must fail it.  The ``lstm_scan`` row names the
   body, bucket and load route that ran, and the device kernels one call
   runs as ``torch.profiler`` sees them, which must be the register kernel
   alone; the ``tt_contract`` row likewise names its body and lanes per
   entry, its one device kernel a call, and its bf16 time and bound at the
   same shape.  The simt decode body is timed at B 65,536, T 10 at (68, 34)
   and (114, 57) like every row (``timing.decode_simt``, with the plain
   version and the bound beside each, and its error there held to 1e-5);
   the first is the ``decode_tile_simt`` row, with the wide phase's
   launches.  The simt ``lstm_scan`` body is timed at B 65,536, T 10 at
   H 68, 96 and 114 beside its plain version, cuDNN ``nn.LSTM`` and the
   bound (``timing.lstm_simt``, its error there held to 1e-5); the first
   is the ``lstm_scan_simt`` row, with the wide phase's launches, and the
   one profiler session also requires that a call at H 68 runs the simt
   kernel alone.  The two backward kernels are timed at the MEDIUM fit
   shape (B 8192, T 10, H 18, R 10, K 8): the whole backward call a step
   makes (for ``lstm_scan`` also the kernel alone, dx and G, with its own
   bound, its plan, and the device operations of one call from the same
   profiler session as the forward rows', which must hold the backward
   kernel once), the plain version and, for ``lstm_scan``, cuDNN
   ``nn.LSTM``'s backward; a ``timing.fit_step`` line sets the four kernels
   of a step beside the fit's seconds a step, and a ``timing.stream_step``
   line the same four at a step of the stream (B 8192, T 14, H 12, R 6)
   beside the stream's seconds a step.
   Every forward row also carries its launches on the fit path
   (``launches_fit``), and every row on the stream path its launches in
   phase ``stream`` (``launches_stream``).

The line before the last is the card's ``name, power.limit`` as
``nvidia-smi`` reports them; the last line is the result object.  Any
failure exits non-zero without printing it.  Without CUDA, or without the
rest of the checkout beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SEED = 0
PEMS_SHAPE = (963, 144, 440)  # paper Table II, PEMS-SF
RANK, HIDDEN = 8, 16          # the repo's default NTTD architecture
REQUEST = 65_536              # entries per decode_at request
DENSE_BATCH = 65_536          # entries per launch of to_dense (its default batch)
TOL = {"float32": 1e-5, "bfloat16": 0.1}
BF16_ULPS = 2                 # bf16 also within 2 ulps of the case's largest |value|
# bf16 flash outputs, element by element: within 1 bf16 ulp of the element's
# own |value| plus this fraction of its row's largest |value| (2^-16: the
# precision to which the split P.V keeps p); rounding p to bf16 fails it
FLASH_ROW_FLOOR = 2.0**-16
PEAK_FP32 = 67e12             # H100 SXM, FP32 outside the tensor cores
PEAK_BF16 = 989e12            # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PROFILE_PAD_S = 0.05          # idle host time around each profiled call
SOURCES = {
    "decode_tile": ("src/repro_torch/kernels/csrc/decode_tile.cu",
                    "src/repro/kernels/decode_tile.py:147"),
    "decode_tile_simt": ("src/repro_torch/kernels/csrc/decode_tile_simt.cu",
                         "src/repro/kernels/decode_tile.py:147"),
    "lstm_scan": ("src/repro_torch/kernels/csrc/lstm.cu",
                  "src/repro/kernels/lstm.py:67"),
    "lstm_scan_simt": ("src/repro_torch/kernels/csrc/lstm_dispatch.cu",
                       "src/repro/kernels/lstm.py:67"),
    "tt_contract": ("src/repro_torch/kernels/csrc/tt_contract.cu",
                    "src/repro/kernels/tt_contract.py:60"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:114"),
    "lstm_scan_bwd": ("src/repro_torch/kernels/csrc/lstm_bwd.cu",
                      "src/repro/kernels/lstm.py:67"),
    "tt_contract_bwd": ("src/repro_torch/kernels/csrc/tt_contract_bwd.cu",
                        "src/repro/kernels/tt_contract.py:60"),
}
NTTD_KERNELS = ("decode_tile", "lstm_scan", "tt_contract")
SERVE_ARCH = "qwen1.5-4b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_MAX_LEN = 8, 4, 16, 4096
# The kernel and the oracle routes differ only in how attention rounds to
# bf16 (1 ulp of an output, here and there); carried through 40 bf16
# layers that stays well under 5 % of the largest logit, about 13 bf16
# ulps at the top of the logits.
LOGIT_REL_TOL = 5e-2
FLASH_SHAPE = (1, 2048, 20, 128)  # B, S, H, D of one full-width prefill


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) in the binade of ``x``."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8) if x else 0.0


def compare(torch, got, want, dtype_name: str) -> tuple[float, float]:
    """(max abs error, in bf16 that error in ulps of the largest |want|).

    Fails beyond the dtype's tolerance (rtol = atol) and, in bf16, beyond
    ``BF16_ULPS`` ulps of the largest |want|: both versions compute in f32
    and round once, so they may differ by the last bit only.
    """
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(got.dtype == want.dtype, f"dtype {got.dtype} != {want.dtype}")
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    tol = TOL[dtype_name]
    err = (g - w).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    bad = int((err > tol + tol * w.abs()).sum())
    require(bad == 0, f"{bad} values beyond tolerance {tol}, max abs err {max_err}")
    ulps = 0.0
    if dtype_name == "bfloat16" and w.numel():
        ulp = bf16_ulp(float(w.abs().max()))
        ulps = max_err / ulp if ulp else (0.0 if max_err == 0 else math.inf)
        require(ulps <= BF16_ULPS,
                f"bf16 max abs err {max_err} is {ulps} ulps of the largest value")
    return max_err, ulps


def flash_elementwise(torch, got, want) -> dict:
    """Per-element reading of a bf16 attention output against the plain
    one: how many elements lie beyond 1 bf16 ulp of their own |want| plus
    ``FLASH_ROW_FLOOR`` of their row's (last axis) largest |want|, and the
    largest error in units of that limit."""
    g, w = got.float(), want.float()
    a = w.abs()
    ulp = torch.where(a > 0, torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8),
                      torch.zeros_like(a))
    limit = ulp + FLASH_ROW_FLOOR * a.amax(-1, keepdim=True)
    err = (g - w).abs()
    beyond = err > limit
    ratio = torch.where(limit > 0, err / limit, torch.where(err > 0, math.inf, 0.0))
    return {"beyond": int(beyond.sum()), "elements": int(err.numel()),
            "worst_over_limit": float(ratio.max()) if err.numel() else 0.0}


def flash_bf16p_control(torch, q, k, v):
    """Causal attention as the plain version computes it, but with p rounded
    to bf16 before P.V (as SDPA's kernels do): the weaker design that the
    per-element check must reject.  MHA, no offset, no padding."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / d**0.5), k.float())
    n = s.shape[-1]
    keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return (out / p.sum(-1).permute(0, 2, 1)[..., None]).to(q.dtype)


def device_kernels(torch, fns, times: bool = False) -> list[list]:
    """Names of the device kernels and copies that each of the calls
    ``fns`` runs, in the order the device ran them, from one
    ``torch.profiler`` session: one list a call (with ``times``, (name,
    device microseconds) pairs).

    One session serves every call: a second session in one process has
    been seen to return no device events.  Each call is synchronised and
    framed by ``PROFILE_PAD_S`` of idle host time, so that a kernel whose
    device timestamp maps a little off the host clock stays inside the
    capture window, and the calls' events are told apart by those gaps
    (a call's own operations follow each other within microseconds).
    Fails unless there are as many groups as calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    groups, last = [], None
    for e in events:
        if last is None or e.time_range.start - last > PROFILE_PAD_S * 1e6 / 2:
            groups.append([])
        groups[-1].append((e.name, e.time_range.elapsed_us()) if times else e.name)
        last = e.time_range.end
    require(len(groups) == len(fns),
            f"{len(fns)} profiled calls ran {len(groups)} groups of device operations: {groups}")
    return groups


def bound(n_ops: int, n_bytes: int, peak_ops: float) -> dict:
    """``bound_ms`` and ``bound_by``: the larger of ``n_ops`` over
    ``peak_ops`` and ``n_bytes`` over ``PEAK_BYTES``."""
    t_ops, t_bytes = n_ops / peak_ops * 1e3, n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lstm_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of an f32 LSTM scan: 16 h^2 FLOP per entry and step;
    x read and every h written once, the weights read once."""
    return b * t * 16 * h * h, (2 * b * t * h + 8 * h * h + 4 * h) * 4


def cudnn_lstm(torch, wi, wh, bias):
    """cuDNN ``torch.nn.LSTM`` holding wi, wh [H, 4H] and b [4H] (gates i,
    f, g, o), as a function x [B, T, H] -> every h: ``lstm_scan``'s
    library yardstick."""
    h = wi.shape[0]
    net = torch.nn.LSTM(h, h, batch_first=True).to(wi.device)
    with torch.no_grad():
        net.weight_ih_l0.copy_(wi.T)
        net.weight_hh_l0.copy_(wh.T)
        net.bias_ih_l0.copy_(bias)
        net.bias_hh_l0.zero_()

    def run(x):
        with torch.no_grad():
            return net(x)[0]
    return run


def chain_equation(k: int) -> str:
    """``torch.einsum`` equation of first . mid_1 ... mid_k . last -> [B]."""
    chain = "acdefghijklmnopqrstuvwxyz"[: k + 1]
    terms = ["b" + chain[0]] + ["b" + chain[j : j + 2] for j in range(k)] + ["b" + chain[k]]
    return ",".join(terms) + "->b"


def decode_inputs(torch, gen, b, t, m, hid, rank, dtype, device, width_scaled=False):
    """Random operands of the fused decode, scaled as the reference's tests.
    ``width_scaled`` multiplies every product over the hidden width by
    sqrt(16 / hid), so a wide shape's values stay O(1) as they do at H 16
    (with fixed scales the chain grows like (0.5 sqrt(R))^(T-2), and where
    such values cancel an f32 sum's rounding outgrows the tolerance)."""
    width = (16 / hid) ** 0.5 if width_scaled else 1.0

    def mk(*shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)

    idx = torch.randint(0, m, (b, t), generator=gen, dtype=torch.int32).to(device)
    return idx, (
        mk(t, m, hid),
        mk(hid, 4 * hid, scale=0.3 * width), mk(hid, 4 * hid, scale=0.3 * width),
        mk(4 * hid, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
        mk(hid, rank * rank, scale=0.5 / rank**0.5 * width), mk(rank * rank, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
    )


def decode_cost(b: int, t: int, hid: int, rank: int) -> int:
    """FP32 operations of the fused decode: the LSTM gates, the head
    projections and the chain, per entry."""
    return b * (t * 16 * hid * hid + 2 * hid * (2 * rank + (t - 2) * rank * rank)
                + 2 * (t - 2) * rank * rank + 2 * rank)


def simt_tile(hid: int, rank: int) -> dict:
    """The simt decode body's block at (hid, rank): the rank it runs (R
    rounded up to 4), its tile of entries and its shared-memory bytes."""
    from repro_torch.kernels import decode_tile as _decode_tile

    rp = _decode_tile.simt_rank(rank)
    tile = _decode_tile.simt_tile(hid, rp)
    return {"H": hid, "R": rank, "simt_rank": rp, "tile": tile,
            "smem_bytes": _decode_tile.simt_smem_bytes(hid, rp, tile)}


def lstm_simt_tile(hid: int) -> dict:
    """The simt lstm_scan body's block at ``hid``: its tile of sequences
    and its shared-memory bytes."""
    from repro_torch.kernels import lstm as _lstm

    tile = _lstm.simt_tile(hid)
    return {"H": hid, "tile": tile, "smem_bytes": _lstm.simt_smem_bytes(hid, tile)}


def tt_bytes(b: int, k: int, r: int, elem: int) -> int:
    """Bytes ``tt_contract`` must move: first, mid and last read once, the
    output written once."""
    return (2 * b * r + b * k * r * r + b) * elem


def lstm_inputs(torch, gen, b, t, h, dtype, device, offset=0):
    """x [b, t, h], starting ``offset`` elements into its buffer, and wi,
    wh, b scaled as the reference's tests."""
    x = torch.randn((b * t * h + offset,), generator=gen).to(device, dtype)[offset:]
    return x.view(b, t, h), tuple(
        (torch.randn(shape, generator=gen) * scale).to(device, dtype)
        for shape, scale in (((h, 4 * h), 0.3), ((h, 4 * h), 0.3), ((4 * h,), 0.1)))


def flash_inputs(torch, gen, b, sq, skv, hq, hkv, d, dtype, device):
    """q, k, v padded to the 128 tile as ``ops.attention`` pads them, and
    the ``kv_valid`` it passes."""
    def mk(s, h):
        x = torch.randn((b, s, h, d), generator=gen)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, (-s) % 128))
        return x.to(device=device, dtype=dtype)

    return mk(sq, hq), mk(skv, hkv), mk(skv, hkv), (skv if skv % 128 else None)


# (b, sq, skv, hq, hkv, d, q_offset, causal)
FLASH_CASES = (
    (1, 128, 128, 4, 4, 64, 0, True),     # the reference's grid
    (2, 256, 256, 8, 2, 64, 0, True),
    (2, 128, 128, 4, 1, 128, 0, True),
    (2, 128, 256, 4, 4, 64, 128, True),   # q_offset = 128
    (1, 130, 130, 2, 2, 64, 0, True),     # odd Sq and Skv: the pad path
    (1, 130, 130, 2, 2, 64, 0, False),
    (1, 128, 130, 2, 2, 64, 0, True),     # ragged kv only
    (1, 200, 200, 48, 4, 128, 0, True),   # starcoder2's 48 / 4 grouping
    (1, 128, 128, 2, 2, 64, -64, True),   # rows 0..63 fully masked
    (1, 130, 130, 2, 1, 8, -100, True),   # fully masked rows, padded grid
    (1, 256, 256, 6, 6, 8, 0, True),      # the smoke configs' head dim
    (1, 128, 128, 20, 20, 128, 0, True),  # the serve path's shapes
    (1, 300, 300, 20, 20, 128, 0, True),
    (1, 2048, 2048, 20, 20, 128, 0, True),
    # the tensor-core body's edges
    (2, 512, 512, 4, 1, 128, 0, True),    # B 2, GQA 4/1: two kv heads of work
    (1, 1024, 1024, 4, 4, 64, 0, True),   # minicpm's head dim 64
    (1, 128, 384, 4, 4, 128, 256, True),  # q_offset > 0 with Skv > Sq
    (1, 256, 230, 4, 2, 128, 0, True),    # kv_valid 230 inside a 64-row kv tile
    (1, 128, 128, 2, 2, 128, -64, True),  # rows 0..63 fully masked at D 128
    (1, 4096, 4096, 20, 20, 128, 0, True),  # the serve shape at S 4096
)
# shapes off the buckets, run on zero-padded weights: (12, 5) in (12, 8),
# the paper's SMALL 12/6 in (12, 8), its MEDIUM 18/10 in (20, 12)
PADDED_DECODE = ((12, 5), (12, 6), (18, 10))
# the simt decode body's cases, (hidden, rank, B, T): the reference's budget
# rule (NTTDCodec._rank_for_budget) picks (68, 34) at 1 MB and (114, 57) at
# 4 MB for PEMS-SF and Uber, and reaches (256, 128)
WIDE_DECODE = ((68, 34, 4096, 10), (114, 57, 4096, 10), (256, 128, 1000, 5))
# the wide phase: the 1 MB rule's architecture on a PEMS-SF-shaped payload
# (two decode_at requests) and an Uber-shaped one (183 x 24 x 1140, paper
# Table II, 5,006,880 entries: one to_dense)
WIDE_RANK, WIDE_HIDDEN = 34, 68
UBER_SHAPE = (183, 24, 1140)
WIDE_REQUESTS = 2
# the simt decode body timed at B REQUEST, T 10 (f32)
WIDE_TIMING = ((68, 34), (114, 57))
# lstm_scan cases beside its register body's buckets: (hidden, x's offset
# in elements into its buffer).  5 (fig8), 18 (paper MEDIUM) and 24 (fleet
# repair) are padded inside the kernel, 18's 72-byte rows and an x one
# element off the 16-byte grid take the scalar loads; 68 and 114 (the
# budget rule at 1 and 4 MB), 96 and 256 (its widest) the simt body.
LSTM_EXTRA = ((5, 0), (18, 0), (24, 0), (16, 1), (68, 0), (96, 0), (114, 0), (256, 0))
# the simt lstm_scan body timed at B REQUEST, T 10 (f32); the first is the
# wide phase's width
LSTM_SIMT_TIMING = (68, 96, 114)
# tt_contract cases (B, K, R): the reference's grid, then the budget rule's
# ranks 34, 57 and 128
TT_CASES = ((64, 5, 8), (100, 10, 16), (7, 3, 8), (256, 8, 32), (1000, 8, 34), (517, 5, 57),
            (200, 3, 128))
LSTM_B, LSTM_T = 1000, 10
# registers a thread that leave room for three blocks of 128 threads a SM
# (65,536 registers, allocated in steps of 8 a thread)
LSTM_H16_REGISTERS = 168
# the backward kernels against their plain versions, per gradient
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
# lstm_scan backward cases (B, T, H): the paper's SMALL and MEDIUM widths
# at their fit batches, the budget rule's 1 MB width and its widest, and a
# step of the stream phase (d' 14)
BWD_LSTM_CASES = ((8192, 10, 12), (8192, 10, 18), (4096, 10, 68), (1024, 5, 256),
                  (8192, 14, 12))
# tt_contract backward cases (B, K, R): SMALL's and MEDIUM's ranks at K 8
# (PEMS-SF's d' 10), the 1 MB rank, the widest (the wide plan; the others
# take the slab plan), a B off the slab of entries (16 a slab at R 10), and
# a K R^2 that is not a multiple of 4 (the slab plan's ragged heads and
# tails), and a step of the stream phase (K 12)
BWD_TT_CASES = ((8192, 8, 6), (8192, 8, 10), (4096, 8, 34), (256, 4, 128), (1001, 8, 10),
                (1001, 3, 5), (8192, 12, 6))
# the fit phase: the paper's MEDIUM on the PEMS-SF replica at its Table II
# shape, 6 epochs so that one Alg. 3 sweep runs after the fifth, 2^21
# entries (256 steps of 8192) an epoch
FIT_DATASET = "pems_sf"
FIT_EPOCHS, FIT_REORDER = 6, 5
FIT_ENTRIES = 1 << 21
FIT_REDUCED = [
    "epochs: 6 of MEDIUM's 200, so that exactly one Alg. 3 sweep runs (reorder_warmup = "
    "reorder_every = 5)",
    "entries_per_epoch: 2^21 (256 steps of 8192) of the tensor's 61,015,680",
]
# the fit.parity phase: fitness histories of the "ref" and "auto" routes
FIT_PARITY_TOL = 1e-3
# the stream phase: the reference's fig5 FULL streaming run
# (benchmarks/fig5_compress_scaling.py:104-113), 2^26 entries in 256 slabs
# of 2^18, two steps of 8192 a slab; d' 14, so the kernels run at T 14, K
# 12.  The learning rate is the reference's end-to-end stream test's
# (tests/test_stream.py:400-420): at fig5's default 5e-3 the fit learns no
# signal at this shape (scripts/torch_stream_signal.py)
STREAM_SHAPE = (16384, 64, 64)
STREAM_SLAB = 1 << 18
STREAM_OPTS = dict(rank=6, hidden=12, steps_per_slab=2, batch_size=8192, lr=2e-2, seed=0)
STREAM_CHANGED = ["lr 2e-2, the reference's end-to-end stream test's, where fig5 keeps the "
                  "default 5e-3, at which the fit learns no signal at this shape "
                  "(scripts/torch_stream_signal.py)"]
STREAM_SOURCE_SEED = 1
STREAM_CHUNK_BYTES = 2048
STREAM_HELDOUT = ((0, 64, 128, 192, 255), 64)  # slabs sampled, entries a slab
STREAM_CORR_ENTRIES = 1 << 20
STREAM_CORR_MIN = 0.5  # the reference's bar, tests/test_stream.py:400-420
STREAM_PARITY_SLABS = 16
STREAM_PARITY_RTOL, STREAM_PARITY_ATOL = 1e-4, 1e-6  # tests/test_torch_fit.py:9-10
STREAM_PARITY_ENTRIES = 1 << 18
STREAM_DELTA_SHAPE = (256, 64, 64)
STREAM_DELTA_OPTS = dict(rank=3, hidden=6, steps_per_slab=2, batch_size=8192, seed=0)
STREAM_DELTA_SCALE, STREAM_DELTA_SEEDS = 0.05, (2, 3)
# a training step of the stream (B, T, H, R): the kernel cases at its shapes
STREAM_STEP = (8192, 14, 12, 6)
# phase service: CodecService on the card over phase main's PEMS-SF payload
# (a chunked v3 file with a held-out block of the plain route's decode),
# phase stream's fig5 file, phase stream.delta's v4 file and a
# VersionedStore at fig10's NTTD settings (benchmarks/fig10_temporal.py:120-131)
SERVICE_CACHE_BYTES = 64 << 20
SERVICE_TILE = 65_536               # entries a decode tile: 932 tiles of 256 KiB
SERVICE_CANARY = dict(canary_fraction=0.25, canary_seed=0, canary_min_fitness=0.999)
SERVICE_HELDOUT = 4096              # held-out entries in the PEMS-SF file
SERVICE_CHUNKS = 8                  # the PEMS-SF body in this many chunks
SERVICE_DIRECT = 32                 # direct requests of REQUEST entries
SERVICE_WINDOW = (100, 64, 64)      # first tile, tiles, requests of REQUEST entries
SERVICE_SWEEP_TILES = 512           # one request over this many tiles: must evict
SERVICE_SUBMITS = (64, 1024)        # submits of this many entries, one flush
SERVICE_FIG5_REQUESTS = 8           # requests of the fig5 file (canaries at calls 0, 4)
SERVICE_MEM_SLACK = 1 << 20         # device bytes beyond the payloads' own tensors
SERVICE_TOL = 1e-5                  # rtol = atol against the plain route
FLEET_INSTANCES = 4                 # in-process members of fleet.local
FLEET_WORKERS = 3                   # repro_torch.fleet.worker processes of fleet.procs
FLEET_REPLICATION = 2
FLEET_DRAIN_SUBMITS = 8             # submits queued before each rebalance
STORE_SHAPE, STORE_VERSIONS, STORE_KEYFRAME_INTERVAL = (24, 16, 16), 8, 8
STORE_DRIFT = dict(drift=0.04, noise=0.03, seed=11)
STORE_KEYFRAME_OPTS = dict(rank=8, hidden=16, epochs=30, batch_size=2048, eval_batch=2048,
                           init_reorder=False, update_reorder=False, seed=0)
STORE_DELTA_OPTS = dict(rank=2, hidden=8, d_prime=2, lr=1e-2, batch_size=1024,
                        steps_per_slab=150, seed=0)
STORE_CHUNK_BYTES = 4096


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def cuda_tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return path if os.path.exists(path) else None


def demangle(names: list[str]) -> list[str]:
    tool = cuda_tool("cu++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def ptxas_resources(log: str) -> list[dict]:
    """Per kernel from ``-Xptxas -v``: registers, shared memory, stack, spills."""
    rows = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            rows.append({"kernel": line.split("'")[1]})
        elif rows and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            rows[-1].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                            spill_load_bytes=nums[2])
        elif rows and "Used" in line and "registers" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def sass_hgmma(path) -> dict:
    """Tensor-core (HGMMA) instructions per kernel in the built library."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        return {"tool": None, "note": "cuobjdump not found: no SASS count"}
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         timeout=300)
    require(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\bHGMMA\b", line):
            counts[name] += 1
    names = sorted(counts)
    return {"tool": "cuobjdump -sass",
            "hgmma": {pretty: counts[raw] for raw, pretty in zip(names, demangle(names))}}


def phase_device(torch):
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    path, seconds, log = _build.build()
    _build.library()
    resources = ptxas_resources(log)
    emit({"phase": "device", "name_power_limit": smi,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": seconds,
          "nvcc_seconds": {m.group(1): float(m.group(2))
                           for m in re.finditer(r"^== (\S+) \(([\d.]+) s\)$", log, re.M)},
          "library": os.path.relpath(path, ROOT),
          "ptxas": resources})
    h16 = [r for r in resources if "lstm_scan_register_kernel" in r["kernel"]
           and "(int)16>" in r["kernel"]]
    require(len(h16) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                  and r["registers"] <= LSTM_H16_REGISTERS for r in h16),
            f"lstm_scan's H 16 register body spills or exceeds {LSTM_H16_REGISTERS} "
            f"registers: {h16}")
    # the simt decode body: its ptxas resources, and the tile of entries a
    # block owns at each wide shape; it must not spill
    simt = [r for r in resources if "decode_tile_simt_kernel" in r["kernel"]]
    emit({"phase": "device.decode_simt", "ptxas": simt,
          "tiles": [simt_tile(h, r) for h, r in sorted({(h, r) for h, r, _, _ in WIDE_DECODE}
                                                        | set(WIDE_TIMING))]})
    require(len(simt) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                   for r in simt),
            f"the simt decode body spills: {simt}")
    # the simt lstm_scan body likewise, with its tile of sequences
    simt = [r for r in resources if "lstm_scan_simt_kernel" in r["kernel"]]
    emit({"phase": "device.lstm_simt", "ptxas": simt,
          "tiles": [lstm_simt_tile(h) for h, _ in LSTM_EXTRA if h > 64]})
    require(len(simt) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                   for r in simt),
            f"the simt lstm_scan body spills: {simt}")
    # the backward kernels: their resources, one kernel a plan, and each
    # backward's plan at the shapes it is held at (lstm: where the weights
    # are read from, tile of sequences, threads, shared memory; tt: slab or
    # wide, entries a slab or block, threads, blocks, shared memory); the
    # lstm backward and the tt slab plan must not spill
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import tt_contract as _tt

    bwd = [r for r in resources if "_bwd_" in r["kernel"] and "_kernel" in r["kernel"]]
    emit({"phase": "device.bwd", "ptxas": bwd,
          "lstm_bwd_plans": [dataclasses.asdict(_lstm.bwd_plan(h, b))
                             for b, _, h in BWD_LSTM_CASES],
          "tt_bwd_plans": [{"B": b, "K": k, "R": r, **dataclasses.asdict(_tt.bwd_plan(r, k, b))}
                           for b, k, r in BWD_TT_CASES]})
    require(len(bwd) == 5,
            f"ptxas reports {len(bwd)} backward kernels, expected 5 (the lstm_scan backward's "
            f"three plans, tt_contract's slab and wide plans): {bwd}")
    require(all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0 for r in bwd
                if "lstm_scan_bwd_kernel" in r["kernel"]
                or "tt_contract_bwd_slab_kernel" in r["kernel"]),
            f"a backward kernel spills: {bwd}")
    sass = sass_hgmma(path)
    if sass["tool"]:
        wgmma = {k: n for k, n in sass["hgmma"].items() if "flash_attention_wgmma" in k}
        require(len(wgmma) == 2 and all(wgmma.values()),
                f"the wgmma flash body has no HGMMA in its SASS: {wgmma}")
    emit({"phase": "sass", **sass})
    return smi


def phase_kernels(torch, device):
    """Every kernel against its plain version on the card."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    gen = torch.Generator().manual_seed(SEED)
    flash_cases, decode_cases, lstm_cases, tt_cases = [], [], [], []
    errs = {name: {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ulps": 0.0}
            for name in SOURCES}
    cases = 0

    def record(name, dt_name, got, want):
        nonlocal cases
        err, ulps = compare(torch, got, want, dt_name)
        errs[name][dt_name] = max(errs[name][dt_name], err)
        errs[name]["bfloat16_ulps"] = max(errs[name]["bfloat16_ulps"], ulps)
        cases += 1
        return err, ulps

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # the reference's decode grid (tests/test_kernels.py), B = 33 and 0
        for rank in (4, 8, 32):
            for t in (2, 3, 8):
                for b in (33, 0):
                    idx, ws = decode_inputs(torch, gen, b, t, 10, 16, rank, dtype, device)
                    got = ops.nttd_decode_tile(idx, *ws, impl="cuda")
                    want = ops.nttd_decode_tile(idx, *ws, impl="ref")
                    record("decode_tile", dn, got, want)
                    x = (torch.randn((b, t, 16), generator=gen)).to(device, dtype)
                    record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                           ref.lstm_scan(x, *ws[1:4]))
                    k = max(t - 2, 1)
                    first = torch.randn((b, rank), generator=gen).to(device, dtype)
                    mid = (torch.randn((b, k, rank, rank), generator=gen)
                           * (0.5 / rank**0.5)).to(device, dtype)
                    last = torch.randn((b, rank), generator=gen).to(device, dtype)
                    record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                           ref.tt_contract(first, mid, last))
        # the reference's lstm and tt grids
        for b, t, h in ((16, 6, 8), (50, 9, 16), (33, 12, 32), (8, 3, 64)):
            _, ws = decode_inputs(torch, gen, 1, 2, 2, h, 4, dtype, device)
            x = torch.randn((b, t, h), generator=gen).to(device, dtype)
            record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                   ref.lstm_scan(x, *ws[1:4]))
        for b, k, r in TT_CASES:
            first = torch.randn((b, r), generator=gen).to(device, dtype)
            mid = (torch.randn((b, k, r, r), generator=gen) * (0.5 / r**0.5)).to(device, dtype)
            last = torch.randn((b, r), generator=gen).to(device, dtype)
            err, ulps = record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                               ref.tt_contract(first, mid, last))
            tt_cases.append({"B": b, "K": k, "R": r, "dtype": dn, "body": "lane_group",
                             "lanes_per_entry": _tt.lanes_per_entry(r),
                             "max_abs_err": err, "ulps": ulps})
        # main-path shapes (T = 10, M = 8, H = 16, R = 8), H = 64, R = 32, and
        # a step of the stream phase (B 8192, T 14, M 8, H 12, R 6: K 12)
        sb, st, sh, sr = STREAM_STEP
        for b, t, m, h, r in ((REQUEST, 10, 8, HIDDEN, RANK), (4096, 10, 8, 64, 32),
                              (sb, st, 8, sh, sr)):
            idx, ws = decode_inputs(torch, gen, b, t, m, h, r, dtype, device)
            record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                   ops.nttd_decode_tile(idx, *ws, impl="ref"))
            x = torch.randn((b, t, h), generator=gen).to(device, dtype)
            record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                   ref.lstm_scan(x, *ws[1:4]))
            first = torch.randn((b, r), generator=gen).to(device, dtype)
            mid = (torch.randn((b, t - 2, r, r), generator=gen) * (0.5 / r**0.5)).to(
                device, dtype)
            last = torch.randn((b, r), generator=gen).to(device, dtype)
            record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                   ref.tt_contract(first, mid, last))
        # every instantiated (H, R) bucket, and a shape padded to one
        for h, r in _decode_tile.BUCKETS + PADDED_DECODE:
            idx, ws = decode_inputs(torch, gen, 1000, 5, 9, h, r, dtype, device)
            err, ulps = record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                               ops.nttd_decode_tile(idx, *ws, impl="ref"))
            decode_cases.append({"H": h, "R": r, "dtype": dn, "body": _decode_tile.decode_body(h, r),
                                 "bucket": list(_decode_tile.bucket_for(h, r)),
                                 "max_abs_err": err, "ulps": ulps})
        # the simt body above the largest bucket, inputs scaled to the width
        for h, r, b, t in WIDE_DECODE:
            idx, ws = decode_inputs(torch, gen, b, t, 9, h, r, dtype, device, width_scaled=True)
            simt_before = _decode_tile.simt_launches
            err, ulps = record("decode_tile_simt", dn,
                               ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                               ops.nttd_decode_tile(idx, *ws, impl="ref"))
            require(_decode_tile.simt_launches == simt_before + 1,
                    f"decode_tile ({h}, {r}) did not run the simt body")
            decode_cases.append({"H": h, "R": r, "B": b, "T": t, "dtype": dn,
                                 "body": _decode_tile.decode_body(h, r), "bucket": None,
                                 "tile": simt_tile(h, r)["tile"],
                                 "max_abs_err": err, "ulps": ulps})
        # lstm_scan's register body at every bucket, padded widths, both
        # load routes, and its simt body above the largest bucket
        for h, offset in [(h, 0) for h in _lstm.BUCKETS] + list(LSTM_EXTRA):
            x, lw = lstm_inputs(torch, gen, LSTM_B, LSTM_T, h, dtype, device, offset)
            body = _lstm.lstm_body(h)
            simt_before = _lstm.simt_launches
            got = ops.lstm_scan(x, *lw, impl="cuda")
            require(_lstm.simt_launches == simt_before + (body == "simt"),
                    f"lstm_scan at H {h} did not run the {body} body")
            err, ulps = record("lstm_scan" if body == "register" else "lstm_scan_simt", dn, got,
                               ref.lstm_scan(x, *lw))
            lstm_cases.append({
                "H": h, "dtype": dn, "body": body,
                "bucket": _lstm.bucket_for(h) if body == "register" else None,
                "tile": _lstm.simt_tile(h) if body == "simt" else None,
                "loads": "vector" if body == "register" and _lstm.vector_rows(x, got)
                else "scalar", "x_offset_bytes": x.data_ptr() % 16,
                "max_abs_err": err, "ulps": ulps})
        routes = {(c["body"], c["loads"]) for c in lstm_cases if c["dtype"] == dn}
        require(routes == {("register", "vector"), ("register", "scalar"), ("simt", "scalar")},
                f"lstm_scan cases in {dn} ran the routes {sorted(routes)}")
        # an index outside [0, M) gathers a zero row in both versions
        idx, ws = decode_inputs(torch, gen, 33, 3, 10, 16, 8, dtype, device)
        idx[0, 1] = 10
        idx[1, 2] = -1
        record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
               ops.nttd_decode_tile(idx, *ws, impl="ref"))
        for b, sq, skv, hq, hkv, d, q_offset, causal in FLASH_CASES:
            q, k, v, kv_valid = flash_inputs(torch, gen, b, sq, skv, hq, hkv, d, dtype, device)
            kw = dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid)
            got = _attention.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            err, ulps = record("flash_attention", dn, got, want)
            row = {"case": [b, sq, skv, hq, hkv, d, q_offset, causal], "dtype": dn,
                   "body": _attention.flash_body(dtype, d), "max_abs_err": err, "ulps": ulps}
            if dtype == torch.bfloat16:
                row["elementwise"] = flash_elementwise(torch, got, want)
                require(row["elementwise"]["beyond"] == 0,
                        f"flash case {row['case']}: {row['elementwise']} beyond 1 ulp of "
                        f"each value plus {FLASH_ROW_FLOOR} of its row's largest")
            flash_cases.append(row)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "tolerance": TOL, "bf16_ulps": BF16_ULPS,
          "flash_row_floor": FLASH_ROW_FLOOR, "max_abs_err": errs})
    emit({"phase": "kernels.decode_buckets", "cases": decode_cases})
    emit({"phase": "kernels.lstm_buckets", "cases": lstm_cases})
    emit({"phase": "kernels.tt_cases", "cases": tt_cases})
    emit({"phase": "kernels.flash", "cases": flash_cases})
    return errs


# the golden files and their keys in expected.npz (the v4 file at its
# latest version)
GOLDEN_FILES = (("v2_nttd.bin", "v2_nttd"), ("v3_mono.tcdc", "v3"), ("v3_chunked.tcdc", "v3"),
                ("v4_delta.tcdc", "v4_version2"))


def phase_golden(torch, device):
    import numpy as np

    from repro_torch.codecs import load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded

    npz = np.load(os.path.join(ROOT, "tests", "golden", "expected.npz"))
    golden = {}
    for name, key in GOLDEN_FILES:
        with open(os.path.join(ROOT, "tests", "golden", name), "rb") as f:
            enc = load_bytes(f.read(), device=device)
        got = np.asarray(enc.decode_at(npz["indices"]), np.float64)
        np.testing.assert_allclose(got, npz[key], rtol=1e-5, atol=1e-6)
        golden[name] = {"key": key, "payload": type(enc).__name__,
                        "max_abs_err": float(np.abs(got - npz[key]).max())}

    with open(os.path.join(ROOT, "benchmarks", "results", "fig5_stream_payload.tcdc"),
              "rb") as f:
        enc5 = load_bytes(f.read(), device=device)
    dense = enc5.to_dense()
    plain = _with_impl(enc5, "ref", NTTDEncoded).to_dense()
    require(dense.shape == (64, 32, 32) and bool(np.isfinite(dense).all()),
            "fig5 payload decode shape or values")
    np.testing.assert_allclose(dense, plain, rtol=1e-5, atol=1e-5)
    emit({"phase": "golden", "tolerance": {"rtol": 1e-5, "atol": 1e-6}, "files": golden,
          "fig5_entries": int(dense.size),
          "fig5_max_abs_err_vs_plain": float(np.abs(dense - plain).max())})


def _with_impl(enc, impl, cls):
    ct = enc.ct
    return cls(dataclasses.replace(ct, cfg=dataclasses.replace(ct.cfg, kernel_impl=impl)))


def phase_main(torch, device):
    import numpy as np

    from repro_torch.codecs import container, load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.core import nttd
    from repro_torch.core.codec import CompressedTensor
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    spec = make_folding_spec(PEMS_SHAPE)
    cfg = nttd.NTTDConfig(rank=RANK, hidden=HIDDEN)
    params = nttd.init_params(torch.Generator().manual_seed(SEED), spec, cfg, device)
    rng = np.random.default_rng(SEED)
    pi = [rng.permutation(n) for n in PEMS_SHAPE]
    ct = CompressedTensor(params, pi, spec, cfg, norm_mean=0.25, norm_std=2.0)
    blob = container.save_bytes(NTTDEncoded(ct))
    enc = load_bytes(blob)  # default device: the card
    require(enc.ct.device.type == "cuda", "load_bytes did not load onto the card")
    requests = [np.stack([rng.integers(0, n, REQUEST) for n in PEMS_SHAPE], axis=1)
                for _ in range(10)]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    enc_cuda = _with_impl(enc, "cuda", NTTDEncoded)
    ops.reset_launch_counts()
    answers, req_ms = [], []
    for i, idx in enumerate(requests):
        t = time.perf_counter()
        answers.append((enc if i < 8 else enc_cuda).decode_at(idx))
        req_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = enc.to_dense()
    dense_s = time.perf_counter() - t
    launches = ops.launch_counts()
    for name in NTTD_KERNELS:
        require(launches[name] >= 1, f"{name} was not launched on the main path")

    plain = _with_impl(enc, "ref", NTTDEncoded)
    req_err = 0.0
    for idx, got in zip(requests, answers):
        require(got.shape == (REQUEST,) and bool(np.isfinite(got).all()), "request output")
        want = plain.decode_at(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        req_err = max(req_err, float(np.abs(got - want).max()))
    t = time.perf_counter()
    dense_plain = plain.to_dense()
    plain_dense_s = time.perf_counter() - t
    require(dense.shape == PEMS_SHAPE and bool(np.isfinite(dense).all()), "to_dense output")
    np.testing.assert_allclose(dense, dense_plain, rtol=1e-5, atol=1e-5)
    dense_err = float(np.abs(dense - dense_plain).max())
    # a dense read-back agrees with point queries at the same entries
    idx = requests[0][:1024]
    np.testing.assert_allclose(dense[tuple(idx.T)], answers[0][:1024], rtol=1e-5, atol=1e-5)
    n = int(np.prod(PEMS_SHAPE))
    emit({"phase": "main", "shape": list(PEMS_SHAPE), "folded_shape": list(spec.folded_shape),
          "rank": RANK, "hidden": HIDDEN, "payload_bytes": len(blob),
          "setup_s": setup_s, "request_entries": REQUEST,
          "request_ms_fused": req_ms[:8], "request_ms_cuda_unfused": req_ms[8:],
          "to_dense_entries": n, "to_dense_s": dense_s,
          "to_dense_entries_per_s": n / dense_s,
          "plain_to_dense_s": plain_dense_s,
          "max_abs_err_requests": req_err, "max_abs_err_to_dense": dense_err,
          "launches": launches})
    return enc, requests[0], launches


def phase_wide(torch, device):
    """The wide payloads the reference's budget rule makes, decoded on the
    card through the default impl ("auto"): at (hidden 68, rank 34), the
    1 MB rule's pick for PEMS-SF and Uber, the fused decode runs its simt
    body.  A PEMS-SF-shaped payload goes through ``save_bytes`` and
    ``load_bytes`` and answers ``WIDE_REQUESTS`` ``decode_at`` requests; an
    Uber-shaped one is reconstructed whole with ``to_dense``.  Both are held
    against the plain route on the card (rtol = atol = 1e-5), and every
    fused launch of this phase must have been the simt body's.  The
    PEMS-SF payload answers ``WIDE_REQUESTS`` more requests through the
    unfused route (``kernel_impl="cuda"``), each one ``lstm_scan`` launch on
    its simt body and one ``tt_contract`` launch, held to the plain route
    likewise.  Returns the launches of the two simt bodies."""
    import numpy as np

    from repro_torch.codecs import container, load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.core import nttd
    from repro_torch.core.codec import CompressedTensor
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops

    require(_decode_tile.decode_body(WIDE_HIDDEN, WIDE_RANK) == "simt",
            "the wide architecture does not take the simt decode body")
    require(_lstm.lstm_body(WIDE_HIDDEN) == "simt",
            "the wide architecture does not take the simt lstm_scan body")
    rng = np.random.default_rng(SEED)
    cfg = nttd.NTTDConfig(rank=WIDE_RANK, hidden=WIDE_HIDDEN)
    require(cfg.kernel_impl == "auto", f"the default impl is {cfg.kernel_impl!r}")
    payloads = {}
    for name, shape in (("pems", PEMS_SHAPE), ("uber", UBER_SHAPE)):
        spec = make_folding_spec(shape)
        params = nttd.init_params(torch.Generator().manual_seed(SEED), spec, cfg, device)
        pi = [rng.permutation(n) for n in shape]
        ct = CompressedTensor(params, pi, spec, cfg, norm_mean=0.25, norm_std=2.0)
        payloads[name] = (spec, NTTDEncoded(ct))
    blob = container.save_bytes(payloads["pems"][1])
    enc = load_bytes(blob)  # default device: the card
    require(enc.ct.device.type == "cuda", "load_bytes did not load onto the card")
    uber = payloads["uber"][1]
    requests = [np.stack([rng.integers(0, n, REQUEST) for n in PEMS_SHAPE], axis=1)
                for _ in range(2 * WIDE_REQUESTS)]
    enc_cuda = _with_impl(enc, "cuda", NTTDEncoded)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    answers, req_ms = [], []
    for i, idx in enumerate(requests):
        t = time.perf_counter()
        answers.append((enc if i < WIDE_REQUESTS else enc_cuda).decode_at(idx))
        req_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = uber.to_dense()
    dense_s = time.perf_counter() - t
    launches, simt = ops.launch_counts(), _decode_tile.simt_launches
    lstm_simt = _lstm.simt_launches
    n_uber = int(np.prod(UBER_SHAPE))
    batches = -(-n_uber // DENSE_BATCH)
    require(simt == launches["decode_tile"] == WIDE_REQUESTS + batches,
            f"the wide phase launched decode_tile {launches['decode_tile']} times, "
            f"{simt} of them the simt body; expected {WIDE_REQUESTS + batches}")
    require(lstm_simt == launches["lstm_scan"] == launches["tt_contract"] == WIDE_REQUESTS,
            f"the wide phase's unfused requests launched lstm_scan {launches['lstm_scan']} "
            f"times, {lstm_simt} of them the simt body, and tt_contract "
            f"{launches['tt_contract']} times; expected {WIDE_REQUESTS} each")

    req_err = 0.0
    plain = _with_impl(enc, "ref", NTTDEncoded)
    for idx, got in zip(requests, answers):
        require(got.shape == (REQUEST,) and bool(np.isfinite(got).all()), "wide request output")
        want = plain.decode_at(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        req_err = max(req_err, float(np.abs(got - want).max()))
    t = time.perf_counter()
    dense_plain = _with_impl(uber, "ref", NTTDEncoded).to_dense()
    plain_dense_s = time.perf_counter() - t
    require(dense.shape == UBER_SHAPE and bool(np.isfinite(dense).all()), "wide to_dense output")
    np.testing.assert_allclose(dense, dense_plain, rtol=1e-5, atol=1e-5)
    dense_err = float(np.abs(dense - dense_plain).max())
    emit({"phase": "wide", "rank": WIDE_RANK, "hidden": WIDE_HIDDEN, "impl": cfg.kernel_impl,
          "body": _decode_tile.decode_body(WIDE_HIDDEN, WIDE_RANK),
          **simt_tile(WIDE_HIDDEN, WIDE_RANK),
          "lstm_body": _lstm.lstm_body(WIDE_HIDDEN), "lstm_tile": _lstm.simt_tile(WIDE_HIDDEN),
          "pems_shape": list(PEMS_SHAPE), "pems_folded": list(payloads["pems"][0].folded_shape),
          "payload_bytes": len(blob), "request_entries": REQUEST,
          "request_ms": req_ms[:WIDE_REQUESTS], "request_ms_cuda_unfused": req_ms[WIDE_REQUESTS:],
          "uber_shape": list(UBER_SHAPE), "uber_folded": list(payloads["uber"][0].folded_shape),
          "to_dense_entries": n_uber, "to_dense_s": dense_s,
          "to_dense_entries_per_s": n_uber / dense_s, "plain_to_dense_s": plain_dense_s,
          "max_abs_err_requests": req_err, "max_abs_err_to_dense": dense_err,
          "max_abs_value_to_dense": float(np.abs(dense_plain).max()),
          "launches": launches, "simt_launches": simt, "lstm_simt_launches": lstm_simt})
    return simt, lstm_simt


def phase_serve(torch, device):
    """The LM serving path at qwen1.5-4b's full width, through the flash
    kernel, held against the same requests served through the oracle."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.dist.sharding import leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    rng = np.random.default_rng(SEED)
    lens = [128, 2048] + [int(n) for n in rng.integers(1, 2048, size=SERVE_REQUESTS - 2)]
    rng.shuffle(lens)
    require(any(n % 128 for n in lens), "no prompt length off the 128 tile")
    argv = ["--arch", SERVE_ARCH, "--requests", str(SERVE_REQUESTS),
            "--slots", str(SERVE_SLOTS), "--prompt-len", ",".join(map(str, lens)),
            "--max-new", str(SERVE_NEW), "--max-len", str(SERVE_MAX_LEN), "--keep-logits"]
    cfg = configs.get(SERVE_ARCH)
    weights = model.abstract_params(
        dataclasses.replace(cfg, param_dtype=cfg.compute_dtype))
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(weights))

    runs = {}
    for route in ("kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = serve.main(argv + (["--attn-impl", "ref"] if route == "plain" else []))
        torch.cuda.synchronize()
        runs[route] = (sorted(results, key=lambda r: r.uid), time.perf_counter() - t0,
                       ops.launch_counts(), torch.cuda.max_memory_allocated())
    (got, wall, launches, peak), (want, plain_wall, plain_launches, _) = (
        runs["kernel"], runs["plain"])
    require(launches["flash_attention"] == cfg.n_layers * SERVE_REQUESTS,
            f"flash_attention launched {launches['flash_attention']} times, expected "
            f"{cfg.n_layers} per prefill x {SERVE_REQUESTS}")
    require(plain_launches["flash_attention"] == 0, "the oracle route launched the kernel")

    diff = rel = 0.0
    for a, b in zip(got, want):
        require(len(a.tokens) == SERVE_NEW and a.prefill_logits.shape == (cfg.vocab,)
                and bool(torch.isfinite(a.prefill_logits).all()), f"request {a.uid} output")
        d = float((a.prefill_logits - b.prefill_logits).abs().max())
        diff = max(diff, d)
        rel = max(rel, d / float(b.prefill_logits.abs().max()))
    require(rel <= LOGIT_REL_TOL,
            f"prefill logits differ by {rel} of max|logit| (limit {LOGIT_REL_TOL})")
    # greedy tokens: equal wherever the oracle run's margin exceeds twice the
    # largest logit difference; after the first allowed divergence the two
    # runs continue from different prefixes and are not compared further
    agree = compared = 0
    for a, b in zip(got, want):
        for ta, tb, margin in zip(a.tokens, b.tokens, b.margins):
            if ta != tb:
                require(margin <= 2 * diff,
                        f"request {a.uid}: tokens {ta} != {tb} at margin {margin}")
                break
            agree += 1
        compared += len(a.tokens)
    decode = [ms for r in got for ms in r.decode_ms]
    plain_decode = [ms for r in want for ms in r.decode_ms]
    n_new = sum(len(r.tokens) for r in got)
    emit({"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.compute_dtype,
          "requests": SERVE_REQUESTS, "slots": SERVE_SLOTS, "new_tokens": SERVE_NEW,
          "max_len": SERVE_MAX_LEN, "prompt_lens": lens, "weight_bytes": weight_bytes,
          "peak_bytes": peak, "seconds": wall, "plain_seconds": plain_wall,
          "prefill_len_ms": [[lens[r.uid], r.prefill_ms] for r in got],
          "plain_prefill_len_ms": [[lens[r.uid], r.prefill_ms] for r in want],
          "decode_ms_per_token": sum(decode) / len(decode),
          "plain_decode_ms_per_token": sum(plain_decode) / len(plain_decode),
          "tokens_per_s": n_new / wall, "launches": launches,
          "prefill_logits_max_abs_diff": diff, "prefill_logits_rel_diff": rel,
          "logit_rel_tol": LOGIT_REL_TOL, "greedy_tokens_agree": agree,
          "greedy_tokens": compared,
          "tokens_uid0": got[0].tokens, "plain_tokens_uid0": want[0].tokens})
    return launches


def flash_timing_row(torch, device, launches, errs):
    """flash_attention at one full-width prefill: kernel, plain and SDPA."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import ref

    b, s, h, d = FLASH_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(device, torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # [B, H, S, D]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    plain = ref.flash_attention(q, k, v, causal=True)
    outs = {"kernel": _attention.flash_attention(q, k, v, causal=True),
            "library": library().transpose(1, 2),
            "bf16_p_control": flash_bf16p_control(torch, q, k, v)}
    errs_at = {key: float((o.float() - plain.float()).abs().max()) for key, o in outs.items()}
    readings = {key: {"max_abs_err": errs_at[key], **flash_elementwise(torch, o, plain)}
                for key, o in outs.items()}
    kernel_err, lib_err = errs_at["kernel"], errs_at["library"]
    require(readings["kernel"]["beyond"] == 0, f"flash at the serve shape: {readings}")
    require(kernel_err < lib_err,
            f"flash error {kernel_err} not below SDPA's {lib_err}: p is not kept in f32")
    require(readings["bf16_p_control"]["beyond"] > 0,
            f"the per-element check passes a bf16-p control: {readings['bf16_p_control']}")
    visible = s * (s + 1) // 2  # causal: query i sees keys 0..i
    n_ops = 4 * b * h * d * visible
    n_bytes = 4 * b * s * h * d * 2  # q, k, v read once, out written once, bf16
    return {
        "name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"][0],
        "replaces": SOURCES["flash_attention"][1], "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"]["float32"],
        "max_abs_err_bf16": errs["flash_attention"]["bfloat16"],
        "body": _attention.flash_body(q.dtype, d), "max_abs_err_at_shape": kernel_err,
        "ms": time_ms(torch, lambda: _attention.flash_attention(q, k, v, causal=True), 20),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True), 5),
        **bound(n_ops, n_bytes, PEAK_BF16),
        "library_ms": time_ms(torch, library, 20),
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) "
                   "on [B, H, S, D] bf16", "library_max_abs_err": lib_err,
        "elementwise_at_shape": readings,
        "shape": {"B": b, "S": s, "H": h, "D": d, "dtype": "bfloat16", "causal": True},
        "ops": n_ops, "bytes": n_bytes,
    }


def phase_timing(torch, device, enc, idx_np, launches, errs, simt_lstm, bwd_calls):
    """Kernel, plain and library times at the main path's shapes.
    ``simt_lstm`` is (the ``lstm_scan_simt`` row, a call of that kernel at
    the wide shape): the call is profiled with the main path's, and the row
    gains the device kernels it ran.  ``bwd_calls`` are one
    ``lstm_scan_bwd`` and one ``tt_contract_bwd`` call at the fit shape,
    profiled in the same session.  Returns the rows and the device
    operations of the two backward calls, (name, device microseconds)
    pairs."""
    from repro_torch.core import nttd
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    ct = enc.ct
    spec, cfg, params = ct.spec, ct.cfg, ct.params
    pos = torch.stack([torch.as_tensor(inv[idx_np[:, j]], device=device)
                       for j, inv in enumerate(ct.inv_pi)], dim=1)
    folded = spec.fold_indices(pos).to(torch.int32).contiguous()
    ws = ct.decode_operands  # as the main path hands them to the kernel
    b, t = folded.shape
    m, h, r = ws[0].shape[1], HIDDEN, RANK
    lstm = params["lstm"]
    x = torch.stack([params[f"embed_{mm}"][folded[:, j].long()]
                     for j, mm in enumerate(spec.folded_shape)], dim=1).contiguous()
    hs = ops.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"], impl="ref")
    first = (hs[:, 0] @ params["head_first"]["w"] + params["head_first"]["b"]).contiguous()
    last = (hs[:, -1] @ params["head_last"]["w"] + params["head_last"]["b"]).contiguous()
    mids = (hs[:, 1:-1] @ params["head_mid"]["w"] + params["head_mid"]["b"]).reshape(
        b, t - 2, r, r).contiguous()

    weight_elems = sum(int(w.numel()) for w in ws)
    rows = []

    # decode_tile: LSTM gates, head projections and the chain, per entry
    ops_dt = decode_cost(b, t, h, r)
    bytes_dt = b * t * 4 + b * 4 + weight_elems * 4
    rows.append(("decode_tile", ops_dt, bytes_dt,
                 lambda: ops.nttd_decode_tile(folded, *ws, impl="cuda"),
                 lambda: ref.nttd_decode_tile(folded, *ws), None, None))

    ops_l, bytes_l = lstm_cost(b, t, h)
    library_lstm = cudnn_lstm(torch, lstm["wi"], lstm["wh"], lstm["b"])
    rows.append(("lstm_scan", ops_l, bytes_l,
                 lambda: ops.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"], impl="cuda"),
                 lambda: ref.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"]),
                 lambda: library_lstm(x), "cuDNN torch.nn.LSTM, gates (i, f, g, o)"))

    ops_t = b * ((t - 2) * 2 * r * r + 2 * r)
    bytes_t = tt_bytes(b, t - 2, r, 4)
    equation = chain_equation(t - 2)
    mid_list = mids.unbind(1)
    opt = torch.backends.opt_einsum
    path = "opt_einsum path" if opt.enabled and opt.is_available() else "left to right"
    rows.append(("tt_contract", ops_t, bytes_t,
                 lambda: ops.tt_contract(first, mids, last, impl="cuda"),
                 lambda: ref.tt_contract(first, mids, last),
                 lambda: torch.einsum(equation, first, *mid_list, last),
                 f"torch.einsum('{equation}'), {path}"))

    kernels = []
    for name, n_ops, n_bytes, kern, plain, library, library_name in rows:
        lib_err = float((library() - plain()).abs().max()) if library else None
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 5),
            **bound(n_ops, n_bytes, PEAK_FP32),
            "library_ms": time_ms(torch, library, 20) if library else None,
            "library": library_name, "library_max_abs_err": lib_err,
            "shape": {"B": b, "T": t, "M": m, "H": h, "R": r},
            "ops": n_ops, "bytes": n_bytes,
        })
    kernels[0].update(body=_decode_tile.decode_body(h, r),
                      bucket=list(_decode_tile.bucket_for(h, r)))
    # every device kernel or copy that one lstm_scan call, then one
    # tt_contract call, then one wide lstm_scan call runs: the register
    # kernel, the tt_contract kernel and the simt lstm_scan kernel, each
    # alone; and lstm_scan's body, bucket and load route
    lstm_call, tt_call = rows[1][3], rows[2][3]
    simt_row, simt_call = simt_lstm
    timed = device_kernels(torch, (lstm_call, tt_call, simt_call, *bwd_calls), times=True)
    seen = [[name for name, _ in call] for call in timed]
    require(all(len(call) == 1 for call in seen[:3])
            and "lstm_scan_register_kernel" in seen[0][0] and "tt_contract_kernel" in seen[1][0]
            and "lstm_scan_simt_kernel" in seen[2][0],
            f"an lstm_scan call, a tt_contract call and a wide lstm_scan call ran {seen[:3]}, "
            "not the register kernel, the tt_contract kernel and the simt kernel alone")
    require(sum("lstm_scan_bwd_kernel" in name for name in seen[3]) == 1,
            f"an lstm_scan_bwd call ran {seen[3]}, not the backward kernel once")
    require(len(seen[4]) == 1 and "tt_contract_bwd_" in seen[4][0],
            f"a tt_contract_bwd call ran {seen[4]}, not the backward kernel alone")
    simt_row["device_ops_per_call"] = seen[2]
    kernels[1].update(body=_lstm.lstm_body(h), bucket=_lstm.bucket_for(h),
                      loads="vector" if _lstm.vector_rows(x, lstm_call()) else "scalar",
                      device_ops_per_call=seen[0])
    # tt_contract: its body and the same shape in bf16 against its own
    # byte bound
    bf = [a.to(torch.bfloat16) for a in (first, mids, last)]
    kernels[2].update(body="lane_group", lanes_per_entry=_tt.lanes_per_entry(r),
                      device_ops_per_call=seen[1],
                      ms_bf16=time_ms(torch, lambda: ops.tt_contract(*bf, impl="cuda"), 20),
                      bound_ms_bf16=bound(ops_t, tt_bytes(b, t - 2, r, 2), PEAK_FP32)["bound_ms"])
    return kernels, timed[3:]


def decode_simt_timing(torch, device, launches, errs):
    """The simt decode body at B ``REQUEST``, T 10, M 8 (f32, inputs scaled
    to the width) for each shape of ``WIDE_TIMING``: kernel (mean of 20
    launches after 2 warm-ups, as every row), plain version (5) and bound,
    with the tile of entries, on a ``timing.decode_simt`` line; returns the
    kernels-table row of the first shape, the wide phase's."""
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for h, r in WIDE_TIMING:
        b, t, m = REQUEST, 10, 8
        idx, ws = decode_inputs(torch, gen, b, t, m, h, r, torch.float32, device,
                                width_scaled=True)
        kern = functools.partial(ops.nttd_decode_tile, idx, *ws, impl="cuda")
        plain = functools.partial(ref.nttd_decode_tile, idx, *ws)
        n_bytes = b * t * 4 + b * 4 + sum(int(w.numel()) for w in ws) * 4
        cases.append({"H": h, "R": r, "B": b, "T": t, "M": m,
                      "body": _decode_tile.decode_body(h, r),
                      **simt_tile(h, r),
                      "max_abs_err_at_shape": float((kern() - plain()).abs().max()),
                      "ms": time_ms(torch, kern, 20),
                      "plain_ms": time_ms(torch, plain, 5),
                      **bound(decode_cost(b, t, h, r), n_bytes, PEAK_FP32),
                      "ops": decode_cost(b, t, h, r), "bytes": n_bytes})
        require(cases[-1]["max_abs_err_at_shape"] <= TOL["float32"],
                f"simt decode at ({h}, {r}): {cases[-1]['max_abs_err_at_shape']} from the plain "
                "version")
    emit({"phase": "timing.decode_simt", "cases": cases})
    first = cases[0]
    return {
        "name": "decode_tile_simt", "route": "cuda", "source": SOURCES["decode_tile_simt"][0],
        "replaces": SOURCES["decode_tile_simt"][1], "launches": launches,
        "max_abs_err": errs["decode_tile_simt"]["float32"],
        "max_abs_err_bf16": errs["decode_tile_simt"]["bfloat16"],
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": None, "library": None,
        "library_max_abs_err": None, "body": first["body"], "tile": first["tile"],
        "shape": {k: first[k] for k in ("B", "T", "M", "H", "R")},
        "ops": first["ops"], "bytes": first["bytes"],
    }


def lstm_simt_timing(torch, device, launches, errs):
    """The simt lstm_scan body at B ``REQUEST``, T 10 (f32) for each width of
    ``LSTM_SIMT_TIMING``: kernel (mean of 20 launches after 2 warm-ups, as
    every row), plain version (5), cuDNN ``nn.LSTM`` (20) and the bound, with
    the tile of sequences and the bound's share of the kernel's time, on a
    ``timing.lstm_simt`` line.  Returns the kernels-table row of the first
    width, the wide phase's, and a call of the kernel at that width."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(SEED)
    cases, first_call = [], None
    for h in LSTM_SIMT_TIMING:
        b, t = REQUEST, 10
        x, lw = lstm_inputs(torch, gen, b, t, h, torch.float32, device)
        kern = functools.partial(ops.lstm_scan, x, *lw, impl="cuda")
        plain = functools.partial(ref.lstm_scan, x, *lw)
        library = cudnn_lstm(torch, *lw)
        n_ops, n_bytes = lstm_cost(b, t, h)
        case = {"H": h, "B": b, "T": t, "body": _lstm.lstm_body(h), **lstm_simt_tile(h),
                "max_abs_err_at_shape": float((kern() - plain()).abs().max()),
                "library_max_abs_err": float((library(x) - plain()).abs().max()),
                "ms": time_ms(torch, kern, 20), "plain_ms": time_ms(torch, plain, 5),
                "library_ms": time_ms(torch, lambda: library(x), 20),
                **bound(n_ops, n_bytes, PEAK_FP32), "ops": n_ops, "bytes": n_bytes}
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        require(case["max_abs_err_at_shape"] <= TOL["float32"],
                f"simt lstm_scan at H {h}: {case['max_abs_err_at_shape']} from the plain "
                "version")
        cases.append(case)
        first_call = first_call or kern
    emit({"phase": "timing.lstm_simt", "cases": cases})
    first = cases[0]
    return {
        "name": "lstm_scan_simt", "route": "cuda", "source": SOURCES["lstm_scan_simt"][0],
        "replaces": SOURCES["lstm_scan_simt"][1], "launches": launches,
        "max_abs_err": errs["lstm_scan_simt"]["float32"],
        "max_abs_err_bf16": errs["lstm_scan_simt"]["bfloat16"],
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "library": "cuDNN torch.nn.LSTM, gates (i, f, g, o)",
        "library_max_abs_err": first["library_max_abs_err"], "body": first["body"],
        "tile": first["tile"], "shape": {k: first[k] for k in ("B", "T", "H")},
        "ops": first["ops"], "bytes": first["bytes"],
    }, first_call


def compare_grads(torch, got, want) -> list[float]:
    """Max abs error of each gradient; fails unless it is within
    ``BWD_ATOL`` + ``BWD_RTOL`` x the gradient's largest |value| (the
    tolerance a gradient as a whole, not element by element: a weight's
    gradient sums B T rows, and where such a sum cancels to near 0 any two
    f32 orders of summation differ by more than the atol, though both sit
    as close to an f64 evaluation: ``lstm_f64_bwd``)."""
    errs = []
    require(len(got) == len(want), f"{len(got)} gradients, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"gradient {i}: {tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
        require(bool(torch.isfinite(g).all()), f"gradient {i} is not finite")
        worst = float((g - w).abs().max()) if g.numel() else 0.0
        largest = float(w.abs().max()) if w.numel() else 0.0
        require(worst <= BWD_ATOL + BWD_RTOL * largest,
                f"gradient {i}: max abs err {worst} beyond atol {BWD_ATOL} + rtol {BWD_RTOL} "
                f"x its largest value {largest}")
        errs.append(worst)
    return errs


def beyond_elementwise(torch, got, want) -> list[int]:
    """Elements of each gradient beyond ``BWD_ATOL`` + ``BWD_RTOL`` x their
    own |value| (printed beside the check)."""
    return [int(((g - w).abs() > BWD_ATOL + BWD_RTOL * w.abs()).sum())
            for g, w in zip(got, want)]


def training_inputs(torch, gen, b, t, hid, rank, device):
    """The operands a training step hands the backward kernels: an NTTD at
    (hid, rank) from the codec's own init (its biases drawn N(0, 0.1), as
    after some training, so the bias paths carry values), B random entries
    of the PEMS-SF index space folded to d' = T, normalized targets drawn
    N(0, 1), the summed squared error's gradient taken through the plain
    route.  Returns the lstm_scan backward's (x, (wi, wh, b), dhs) and the
    tt_contract backward's (first, mid, last, dout)."""
    from repro_torch.core import nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import ref

    spec = make_folding_spec(PEMS_SHAPE, t)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hid)
    params = nttd.init_params(gen, spec, cfg, device)
    for head in ("lstm", "head_first", "head_mid", "head_last"):
        params[head]["b"] = params[head]["b"] + 0.1 * torch.randn(
            params[head]["b"].shape, generator=gen).to(device)
    pos = torch.stack([torch.randint(0, n, (b,), generator=gen) for n in PEMS_SHAPE], 1)
    folded = spec.fold_indices(pos.to(device))
    x = torch.stack([params[f"embed_{m}"][folded[:, j]]
                     for j, m in enumerate(spec.folded_shape)], dim=1).contiguous()
    lstm = params["lstm"]
    vals = torch.randn((b,), generator=gen).to(device)
    with torch.enable_grad():
        hs = ref.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"]).requires_grad_()
        first = hs[:, 0] @ params["head_first"]["w"] + params["head_first"]["b"]
        last = hs[:, -1] @ params["head_last"]["w"] + params["head_last"]["b"]
        mid = (hs[:, 1:-1] @ params["head_mid"]["w"] + params["head_mid"]["b"]).reshape(
            b, t - 2, rank, rank)
        cores = [a.detach().contiguous().requires_grad_() for a in (first, mid, last)]
        pred = ref.tt_contract(*cores)
        dout = 2 * (pred - vals).detach()
        dhs = torch.autograd.grad((first, mid, last), hs, torch.autograd.grad(
            pred, cores, dout))[0]
    return ((x, (lstm["wi"], lstm["wh"], lstm["b"]), dhs.contiguous()),
            tuple(a.detach() for a in cores) + (dout,))


def lstm_bwd_inputs(torch, gen, b, t, h, device):
    """``training_inputs``' lstm_scan operands at hidden ``h`` (rank h / 2,
    the budget rule's ratio)."""
    return training_inputs(torch, gen, b, t, h, max(1, h // 2), device)[0]


def tt_bwd_inputs(torch, gen, b, k, r, device):
    """``training_inputs``' tt_contract operands at rank ``r`` and K mid
    cores (hidden 2 r, d' = K + 2)."""
    return training_inputs(torch, gen, b, k + 2, 2 * r, r, device)[1]


def lstm_f64_bwd(torch, x, wi, wh, b, dhs):
    """The lstm_scan gradients evaluated in f64 (autograd of the plain
    forward's math without its f32 casts): the yardstick of the unit-scale
    reading."""
    with torch.enable_grad():
        leaves = [a.double().requires_grad_() for a in (x, wi, wh, b)]
        xd, wid, whd, bd = leaves
        bsz, t_steps, hid = x.shape
        h = c = torch.zeros((bsz, hid), dtype=torch.float64, device=x.device)
        outs = []
        for t in range(t_steps):
            i, f, g, o = (xd[:, t] @ wid + h @ whd + bd).split(hid, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.autograd.grad(torch.stack(outs, 1), leaves, dhs.double())


def lstm_bwd_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of the whole ``lstm_scan`` backward: per entry and step
    16 H^2 to recompute the gates, 16 H^2 for [dx | dh] = dG [wi; wh]^T and
    16 H^2 for dwi and dwh; x, hs, dhs and the weights read once, dx and
    the weights' gradients written once."""
    return b * t * 48 * h * h, (4 * b * t * h + 16 * h * h + 8 * h) * 4


def lstm_bwd_kernel_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of the backward kernel alone: per entry and step the
    gates once (16 H^2) and [dx | dh] = dG [wi; wh]^T (16 H^2), the least
    work (the narrow plan recomputes the gates in its reverse sweep,
    which this does not count); x, hs, dhs and the weights read, dx [B, T,
    H] and G [B T, 4H] written.  The kernel also writes A [B T, 2H + 1],
    a copy of x and hs for the weight gradients' one product: the design's
    overhead, which the function does not need and the bound does not
    count."""
    return b * t * 32 * h * h, (b * t * 8 * h + 8 * h * h + 4 * h) * 4


def tt_bwd_cost(b: int, k: int, r: int) -> tuple[int, int]:
    """(FLOP, bytes) of the ``tt_contract`` backward: per entry 2 R^2 a mid
    core for the prefix, 2 R^2 for the suffix and 2 R^2 for dmid; first,
    mid, last and dout read once, dfirst, dmid and dlast written once."""
    return b * (6 * k * r * r + 4 * r), (4 * b * r + 2 * b * k * r * r + b) * 4


def cudnn_lstm_backward(torch, x, wi, wh, bias, dhs):
    """cuDNN ``torch.nn.LSTM`` holding wi, wh, b as ``cudnn_lstm`` does, run
    forward once with its graph kept: a function that runs its backward
    (dx and every weight's gradient) against ``dhs``, ``lstm_scan_bwd``'s
    library yardstick.  Returns (run, a function giving dx, dwi, dwh, db in
    ``lstm_scan``'s layout)."""
    h = wi.shape[0]
    net = torch.nn.LSTM(h, h, batch_first=True).to(wi.device)
    with torch.no_grad():
        net.weight_ih_l0.copy_(wi.T)
        net.weight_hh_l0.copy_(wh.T)
        net.bias_ih_l0.copy_(bias)
        net.bias_hh_l0.zero_()
    xg = x.detach().clone().requires_grad_()
    out = net(xg)[0]
    inputs = (xg, net.weight_ih_l0, net.weight_hh_l0, net.bias_ih_l0, net.bias_hh_l0)

    def run():
        return torch.autograd.grad(out, inputs, dhs, retain_graph=True)

    def grads():
        dx, dwi, dwh, db, _ = run()
        return dx, dwi.T, dwh.T, db
    return run, grads


def phase_kernels_bwd(torch, device):
    """Each backward kernel against its plain version (autograd of the plain
    forward) on the card, every gradient within ``BWD_RTOL`` / ``BWD_ATOL``;
    each call must launch its kernel once."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    gen = torch.Generator().manual_seed(SEED)
    errs = {"lstm_scan_bwd": 0.0, "tt_contract_bwd": 0.0}
    lstm_cases, tt_cases = [], []
    for b, t, h in BWD_LSTM_CASES:
        x, lw, dhs = lstm_bwd_inputs(torch, gen, b, t, h, device)
        hs = ops.lstm_scan(x, *lw, impl="cuda")  # the forward kernel's, as training saves it
        before = _lstm.bwd_launches
        got = _lstm.lstm_scan_bwd(x, *lw, hs, dhs)
        require(_lstm.bwd_launches == before + 1, f"lstm_scan_bwd at H {h} launched no kernel")
        plain = ref.lstm_scan_bwd(x, *lw, dhs)
        err = compare_grads(torch, got, plain)
        errs["lstm_scan_bwd"] = max(errs["lstm_scan_bwd"], *err)
        # both against an f64 evaluation: the kernel's route may be no less
        # accurate than the plain version's, within a factor of 4
        exact = lstm_f64_bwd(torch, x, *lw, dhs)
        vs_f64 = [(float((g.double() - e).abs().max()), float((p.double() - e).abs().max()))
                  for g, p, e in zip(got, plain, exact)]
        require(all(k <= 4 * p + BWD_ATOL for k, p in vs_f64),
                f"lstm_scan_bwd at H {h}: (kernel, plain) errors against f64 {vs_f64}")
        names = ("dx", "dwi", "dwh", "db")
        plan = _lstm.bwd_plan(h, b)
        lstm_cases.append({"B": b, "T": t, "H": h, "tile": plan.tile, "kind": plan.kind,
                           "max_abs_err": dict(zip(names, err)),
                           "largest": dict(zip(names, (float(p.abs().max()) for p in plain))),
                           "kernel_plain_vs_f64": dict(zip(names, vs_f64)),
                           "beyond_elementwise": dict(zip(names, beyond_elementwise(
                               torch, got, plain)))})
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for b, k, r in BWD_TT_CASES:
        first, mid, last, dout = tt_bwd_inputs(torch, gen, b, k, r, device)
        before = _tt.bwd_launches
        got = _tt.tt_contract_bwd(first, mid, last, dout)
        require(_tt.bwd_launches == before + 1, f"tt_contract_bwd at R {r} launched no kernel")
        plain = ref.tt_contract_bwd(first, mid, last, dout)
        err = compare_grads(torch, got, plain)
        errs["tt_contract_bwd"] = max(errs["tt_contract_bwd"], *err)
        names = ("dfirst", "dmid", "dlast")
        plan = _tt.bwd_plan(r, k, b, sms)
        tt_cases.append({"B": b, "K": k, "R": r, "plan": plan.kind, "entries": plan.entries,
                         "blocks": plan.blocks, "threads": plan.threads,
                         "max_abs_err": dict(zip(names, err)),
                         "largest": dict(zip(names, (float(p.abs().max()) for p in plain))),
                         "beyond_elementwise": dict(zip(names, beyond_elementwise(
                             torch, got, plain)))})
    # mid one float off the 16-byte grid (a view one float into a larger
    # buffer): the slab plan copies each entry's ragged head and tail by
    # plain loads and allocates dmid at the same offset from the grid
    b, k, r = 1001, 8, 10
    first, mid, last, dout = tt_bwd_inputs(torch, gen, b, k, r, device)
    mid_off = torch.empty(mid.numel() + 1, device=device)[1:].view(mid.shape).copy_(mid)
    got = _tt.tt_contract_bwd(first, mid_off, last, dout)
    require(mid_off.data_ptr() % 16 == got[1].data_ptr() % 16 == 4,
            "the off-grid case's mid or dmid lies on the 16-byte grid")
    off_grid_err = compare_grads(torch, got, ref.tt_contract_bwd(first, mid, last, dout))
    errs["tt_contract_bwd"] = max(errs["tt_contract_bwd"], *off_grid_err)
    off_grid = {"B": b, "K": k, "R": r,
                "max_abs_err": dict(zip(("dfirst", "dmid", "dlast"), off_grid_err))}
    # a reading at unit scale (x, dhs ~ N(0, 1), weights 0.3): there the
    # weight gradients' f32 sums over B T = 81,920 rows differ between any two
    # summation orders by more than the atol near 0, so both versions are
    # held against an f64 evaluation instead, and printed
    b, t, h = BWD_LSTM_CASES[0]
    x, lw = lstm_inputs(torch, gen, b, t, h, torch.float32, device)
    dhs = torch.randn((b, t, h), generator=gen).to(device)
    exact = lstm_f64_bwd(torch, x, *lw, dhs)
    got = _lstm.lstm_scan_bwd(x, *lw, ops.lstm_scan(x, *lw, impl="cuda"), dhs)
    plain = ref.lstm_scan_bwd(x, *lw, dhs)
    unit = {"B": b, "T": t, "H": h, **{
        name: {"kernel_vs_f64": float((g.double() - e).abs().max()),
               "plain_vs_f64": float((p.double() - e).abs().max()),
               "kernel_vs_plain": float((g - p).abs().max()), "largest": float(e.abs().max())}
        for name, g, p, e in zip(("dx", "dwi", "dwh", "db"), got, plain, exact)}}
    # through autograd: the Functions' backward passes are the kernels
    x, lw, dhs = lstm_bwd_inputs(torch, gen, 64, 10, 18, device)
    leaves = [a.clone().requires_grad_() for a in (x, *lw)]
    before = (_lstm.bwd_launches, _tt.bwd_launches)
    torch.autograd.backward(ops.lstm_scan(*leaves, impl="cuda"), dhs)
    first, mid, last, dout = tt_bwd_inputs(torch, gen, 64, 8, 10, device)
    tt_leaves = [a.clone().requires_grad_() for a in (first, mid, last)]
    torch.autograd.backward(ops.tt_contract(*tt_leaves, impl="cuda"), dout)
    require((_lstm.bwd_launches, _tt.bwd_launches) == (before[0] + 1, before[1] + 1),
            "autograd through lstm_scan and tt_contract did not run the backward kernels")
    compare_grads(torch, [a.grad for a in leaves], ref.lstm_scan_bwd(x, *lw, dhs))
    compare_grads(torch, [a.grad for a in tt_leaves], ref.tt_contract_bwd(first, mid, last, dout))
    torch.cuda.synchronize()
    emit({"phase": "kernels.bwd", "rtol": BWD_RTOL, "atol": BWD_ATOL,
          "inputs": "training_inputs: an NTTD at its init scales on PEMS-SF's index space",
          "lstm_scan_bwd": lstm_cases, "tt_contract_bwd": tt_cases,
          "tt_contract_bwd_off_grid": off_grid, "max_abs_err": errs,
          "lstm_scan_bwd_unit_scale": unit})
    return errs


@contextlib.contextmanager
def plain_calls_counted(ref):
    """Count the calls of every plain kernel version in ``ref`` while the
    block runs (the wrappers and ``ops`` call them through the module)."""
    names = ("nttd_decode_tile", "lstm_scan", "tt_contract", "lstm_scan_bwd", "tt_contract_bwd")
    counts = dict.fromkeys(names, 0)
    saved = {name: getattr(ref, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ref, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def fit_options(**extra) -> dict:
    """The paper's MEDIUM (rank 10, hidden 18, batch 8192, lr 1e-2) as
    ``NTTDCodec.fit`` options, cut to ``FIT_EPOCHS`` epochs with one Alg. 3
    sweep."""
    from repro_torch.configs import tensorcodec_paper

    return {**dataclasses.asdict(tensorcodec_paper.MEDIUM), "epochs": FIT_EPOCHS,
            "reorder_warmup": FIT_REORDER, "reorder_every": FIT_REORDER, **extra}


def phase_fit(torch, device):
    """Alg. 1 at full width: the paper's MEDIUM on the PEMS-SF replica at
    its Table II shape, through ``get_codec("nttd").fit`` on its default
    device (the card).  Every training step must launch the forward and
    backward ``lstm_scan`` and ``tt_contract`` kernels once, every epoch's
    fitness the fused decode, and no plain version may run.  The payload's
    whole-tensor fitness must match the best sampled fitness of the fit,
    and the payload must load and answer as fitted.  Returns the phase's
    launches and its seconds per training step."""
    import numpy as np

    from repro_torch.codecs import get_codec, load_bytes
    from repro_torch.data import synthetic_tensors
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    x = synthetic_tensors.load(FIT_DATASET, mini=False, seed=SEED)
    tensor_s = time.perf_counter() - t0
    require(x.shape == PEMS_SHAPE, f"the {FIT_DATASET} replica has shape {x.shape}")
    opts = fit_options(entries_per_epoch=FIT_ENTRIES)
    require(opts["kernel_impl"] == "auto", f"the default impl is {opts['kernel_impl']!r}")
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        enc = get_codec("nttd").fit(x, **opts)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = ops.launch_counts()
    require(enc.ct.device.type == "cuda", "the fit did not run on the card")
    require(sum(plain.values()) == 0, f"plain versions ran on the fit path: {plain}")
    log = enc.log
    steps = FIT_ENTRIES // opts["batch_size"] * log.epochs_run
    train = {k: launches[k] for k in ("lstm_scan", "lstm_scan_bwd", "tt_contract",
                                      "tt_contract_bwd")}
    require(set(train.values()) == {steps},
            f"{steps} training steps launched {train}; expected one of each a step")
    require(launches["decode_tile"] >= log.epochs_run,
            f"decode_tile launched {launches['decode_tile']} times in {log.epochs_run} epochs")
    require(len(log.reorder_stats) == (log.epochs_run > FIT_REORDER),
            f"{len(log.reorder_stats)} Alg. 3 sweeps in {log.epochs_run} epochs")
    require(all(math.isfinite(v) for v in log.fitness_history + log.loss_history),
            "non-finite fitness or loss")
    # what comes out: the returned payload's exact fitness over all entries
    # is the best epoch's sampled one (4M entries), and it reloads intact
    t = time.perf_counter()
    full = enc.fitness(x)
    full_s = time.perf_counter() - t
    best = max(log.fitness_history)
    require(abs(full - best) < 1e-2, f"payload fitness {full} vs the fit's best {best}")
    blob = enc.save()
    idx = np.stack([np.random.default_rng(SEED).integers(0, n, REQUEST) for n in PEMS_SHAPE],
                   axis=1)
    got = load_bytes(blob).decode_at(idx)
    require(bool(np.isfinite(got).all()), "non-finite decode of the fitted payload")
    np.testing.assert_allclose(got, enc.decode_at(idx), rtol=1e-5, atol=1e-6)
    steps_per_s = steps / log.seconds_train
    emit({"phase": "fit", "dataset": FIT_DATASET, "shape": list(x.shape),
          "folded_shape": list(enc.ct.spec.folded_shape), "config": {
              k: opts[k] for k in ("rank", "hidden", "batch_size", "lr", "epochs",
                                   "reorder_warmup", "reorder_every", "reorder_samples",
                                   "entries_per_epoch", "kernel_impl")},
          "reduced": FIT_REDUCED, "tensor_seconds": tensor_s, "seconds": fit_s,
          "seconds_init_order": log.seconds_init_order, "seconds_train": log.seconds_train,
          "seconds_reorder": log.seconds_reorder,
          "seconds_fitness": fit_s - log.seconds_init_order - log.seconds_train
          - log.seconds_reorder,
          "epochs_run": log.epochs_run, "steps": steps, "steps_per_s": steps_per_s,
          "train_entries_per_s": steps_per_s * opts["batch_size"],
          "fitness_history": log.fitness_history, "loss_history": log.loss_history,
          "swaps": [[s.mode, s.pairs, s.accepted] for s in log.reorder_stats[0]]
          if log.reorder_stats else [],
          "fitness_full": full, "fitness_full_seconds": full_s, "launches": launches,
          "plain_calls": plain, "payload_bytes": len(blob),
          "payload_bytes_v_a": enc.payload_bytes()})
    return launches, log.seconds_train / steps


def phase_fit_parity(torch, device):
    """``compress`` twice on the card from the same seed (so the same
    initial params) on the mini PEMS-SF replica: the plain versions ("ref")
    and the kernels ("auto").  The fitness histories must agree within
    ``FIT_PARITY_TOL`` at every epoch; where the accepted swaps of a mode
    differ, the mode is printed."""
    from repro_torch.core import codec
    from repro_torch.data import synthetic_tensors
    from repro_torch.kernels import ops

    x = synthetic_tensors.load(FIT_DATASET, mini=True, seed=SEED)
    runs = {}
    for impl in ("ref", "auto"):
        ops.reset_launch_counts()
        t = time.perf_counter()
        _, log = codec.compress(x, codec.CodecConfig(**fit_options(kernel_impl=impl)))
        torch.cuda.synchronize()
        runs[impl] = (log, time.perf_counter() - t, ops.launch_counts())
    (plain, plain_s, plain_launches), (kern, kern_s, launches) = runs["ref"], runs["auto"]
    require(not any(plain_launches.values()), f"the ref route launched {plain_launches}")
    require(all(launches[k] > 0 for k in ("decode_tile", "lstm_scan", "lstm_scan_bwd",
                                          "tt_contract", "tt_contract_bwd")),
            f"the auto route launched {launches}")
    require(len(kern.fitness_history) == len(plain.fitness_history),
            f"{kern.epochs_run} epochs against the ref route's {plain.epochs_run}")
    diffs = [abs(a - b) for a, b in zip(kern.fitness_history, plain.fitness_history)]
    require(max(diffs) <= FIT_PARITY_TOL,
            f"fitness histories differ by {max(diffs)} (limit {FIT_PARITY_TOL}): "
            f"{kern.fitness_history} vs {plain.fitness_history}")
    swaps = [[[s.mode, s.pairs, s.accepted] for s in stats] for stats in kern.reorder_stats]
    plain_swaps = [[[s.mode, s.pairs, s.accepted] for s in stats]
                   for stats in plain.reorder_stats]
    differ = [a[0] for sweep, psweep in zip(swaps, plain_swaps) for a, b in zip(sweep, psweep)
              if a != b]
    emit({"phase": "fit.parity", "dataset": FIT_DATASET, "shape": list(x.shape),
          "tolerance": FIT_PARITY_TOL, "fitness_auto": kern.fitness_history,
          "fitness_ref": plain.fitness_history, "max_fitness_diff": max(diffs),
          "loss_auto": kern.loss_history, "loss_ref": plain.loss_history,
          "swaps_auto": swaps, "swaps_ref": plain_swaps, "modes_whose_swaps_differ": differ,
          "seconds_auto": kern_s, "seconds_ref": plain_s, "launches_auto": launches})


class TimedSource:
    """A slab source whose ``slab_at`` adds its host seconds to ``seconds``
    (the source values' share of a streaming run)."""

    def __init__(self, source):
        self.source, self.seconds = source, 0.0
        self.shape, self.n_slabs = source.shape, source.n_slabs

    def slab_at(self, cursor):
        t = time.perf_counter()
        slab = self.source.slab_at(cursor)
        self.seconds += time.perf_counter() - t
        return slab


def stream_heldout(source):
    """``sample_heldout`` of a few whole slabs (the tensor is never
    materialised): flat indices into the tensor and their exact values."""
    import numpy as np

    from repro_torch.stream import sample_heldout

    cursors, n = STREAM_HELDOUT
    parts = [sample_heldout(source.slab_at(c).values, n=n, seed=c) for c in cursors]
    return (np.concatenate([idx + c * source.slab_entries for c, (idx, _) in zip(cursors, parts)]),
            np.concatenate([vals for _, vals in parts]))


def sampled_fitness(source, enc, n, seed) -> float:
    """1 - ||x - x_hat|| / ||x|| over ``n`` entries drawn from ``seed``,
    the truth from the source's ``values_at``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, n) for s in source.shape], axis=1)
    truth = source.values_at(idx).astype(np.float64)
    err = np.asarray(enc.decode_at(idx), np.float64) - truth
    return 1.0 - float(np.linalg.norm(err)) / max(float(np.linalg.norm(truth)), 1e-30)


def phase_stream(torch, device, smi, workdir):
    """The reference's fig5 FULL streaming run at full size on the card:
    ``fit_stream("nttd", ...)`` over 2^26 synthetic entries in 256 slabs,
    the tensor never materialised.  Every step must launch the forward and
    backward ``lstm_scan`` and ``tt_contract`` kernels once and no plain
    version may run.  The payload is written by ``write_chunked`` with a
    held-out sample, read back onto the card, and must answer as fitted
    through the fused decode; its decode must correlate with the truth
    above ``STREAM_CORR_MIN``.  A second fitter, resumed at slab 128, must
    give the same bytes.  Returns the phase's launches (fit, write and
    read), its seconds a step and the written file's path (in ``workdir``,
    which phase ``service`` serves)."""
    import numpy as np

    from repro_torch.codecs import get_codec, load_file, save_bytes
    from repro_torch.codecs.container import open_container
    from repro_torch.kernels import ops, ref
    from repro_torch.stream import SyntheticTensorSource, fit_stream, write_chunked

    source = SyntheticTensorSource(STREAM_SHAPE, slab_entries=STREAM_SLAB,
                                   seed=STREAM_SOURCE_SEED)
    timed = TimedSource(source)
    fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS)
    require(fitter.device.type == "cuda" and fitter.cfg.kernel_impl == "auto",
            f"the stream fitter runs {fitter.cfg.kernel_impl!r} on {fitter.device}")
    steps = source.n_slabs * STREAM_OPTS["steps_per_slab"]
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, n, REQUEST) for n in STREAM_SHAPE], axis=1)
    corr_idx = np.stack([rng.integers(0, n, STREAM_CORR_ENTRIES) for n in STREAM_SHAPE], axis=1)
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        enc = fit_stream("nttd", timed, fitter=fitter)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        drain_s = time.perf_counter() - t1
        fit_launches = ops.launch_counts()
        # write and read back: a chunked v3 file with held-out truth
        t = time.perf_counter()
        heldout = stream_heldout(source)
        heldout_s = time.perf_counter() - t
        path = os.path.join(workdir, "stream.tcdc")
        t = time.perf_counter()
        file_bytes = write_chunked(path, enc, chunk_bytes=STREAM_CHUNK_BYTES, heldout=heldout)
        write_s = time.perf_counter() - t
        oc = open_container(path)
        try:
            n_chunks, got_heldout = len(oc.chunks), oc.heldout
        finally:
            oc.close()
        t = time.perf_counter()
        back = load_file(path, device=device)
        served = back.decode_at(idx)
        read_s = time.perf_counter() - t
        direct = enc.decode_at(idx)
        heldout_pos = np.stack(np.unravel_index(heldout[0], STREAM_SHAPE), axis=1)
        heldout_corr = float(np.corrcoef(back.decode_at(heldout_pos), heldout[1])[0, 1])
        t = time.perf_counter()
        truth = source.values_at(corr_idx)
        corr = float(np.corrcoef(truth, back.decode_at(corr_idx))[0, 1])
        corr_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran on the stream path: {plain}")
    train = {k: fit_launches[k] for k in ("lstm_scan", "lstm_scan_bwd", "tt_contract",
                                          "tt_contract_bwd")}
    require(set(train.values()) == {steps} and fit_launches["decode_tile"] == 0,
            f"{steps} stream steps launched {fit_launches}; expected one of each a step")
    # four fused requests: the read-back, the fitted payload, the held-out
    # entries and the correlation sample; no training kernel after the fit
    require(launches["decode_tile"] == 4 and {k: launches[k] for k in train} == train,
            f"the write and read-back launched {launches} after the fit's {fit_launches}")
    require(bool(torch.isfinite(fitter.loss)), "non-finite loss in the last slab")
    require(back.ct.device.type == "cuda", "the stream payload did not load onto the card")
    np.testing.assert_array_equal(got_heldout.indices, heldout[0])
    np.testing.assert_array_equal(got_heldout.values, heldout[1])
    np.testing.assert_array_equal(source.values_at(heldout_pos), heldout[1])  # the truth
    require(bool(np.isfinite(served).all()), "non-finite decode of the stream payload")
    np.testing.assert_array_equal(served, direct)
    require(corr > STREAM_CORR_MIN, f"stream payload correlation {corr} <= {STREAM_CORR_MIN}")

    # resume: slabs [0, 128) and then [128, 256) on a second fitter
    half = source.n_slabs // 2
    t = time.perf_counter()
    resumed_fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS)
    fit_stream("nttd", source, stop=half, fitter=resumed_fitter)
    resumed = fit_stream("nttd", source, start=half, fitter=resumed_fitter)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    blob = save_bytes(enc)
    require(save_bytes(resumed) == blob, "the resumed stream fit's bytes differ from the "
            "uninterrupted run's")
    n = source.n_entries
    emit({"phase": "stream", "shape": list(STREAM_SHAPE), "entries": n,
          "slab_entries": STREAM_SLAB, "slabs": source.n_slabs, "steps": steps,
          "folded_shape": list(enc.ct.spec.folded_shape), "config": STREAM_OPTS,
          "source": f"SyntheticTensorSource seed {STREAM_SOURCE_SEED}",
          "reduced": [], "changed": STREAM_CHANGED, "seconds": fit_s,
          "seconds_by_part": {"source_values": timed.seconds,
                              "host_sampling": fitter.seconds["sampling"],
                              "training_dispatch": fitter.seconds["training"],
                              "device_drain": drain_s,
                              "reservoir": fitter.seconds["reservoir"],
                              "heldout_sample": heldout_s, "write": write_s,
                              "read_and_request": read_s, "correlation": corr_s},
          "slabs_per_s": source.n_slabs / fit_s, "steps_per_s": steps / fit_s,
          "entries_per_s": n / fit_s, "correlation": corr,
          "correlation_entries": STREAM_CORR_ENTRIES, "heldout_entries": len(heldout[0]),
          "heldout_correlation": heldout_corr, "payload_bytes": len(blob),
          "payload_bytes_v_a": enc.payload_bytes(), "file_bytes": file_bytes,
          "chunks": n_chunks, "request_entries": REQUEST,
          "resumed_at_slab": half, "resume_identical": True, "resume_seconds": resume_s,
          "launches_fit": fit_launches, "launches": launches, "plain_calls": plain,
          "name_power_limit": smi})
    return launches, fit_s / steps, path


def stream_step_timing(torch, device, step_s):
    """The four training kernels at a step of the stream (``STREAM_STEP``:
    B 8192, T 14, H 12, R 6, K 12) on ``training_inputs``' operands, with
    CUDA events like every row, each beside its bound, and the stream
    phase's seconds a step (its whole fit over its steps)."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops
    from repro_torch.kernels import tt_contract as _tt

    b, t, h, r = STREAM_STEP
    k = t - 2
    gen = torch.Generator().manual_seed(SEED)
    (x, lw, dhs), (first, mid, last, dout) = training_inputs(torch, gen, b, t, h, r, device)
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    ms = {"lstm_scan": time_ms(torch, lambda: ops.lstm_scan(x, *lw, impl="cuda"), 20),
          "lstm_scan_bwd": time_ms(torch, lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs), 20),
          "tt_contract": time_ms(torch, lambda: ops.tt_contract(first, mid, last, impl="cuda"),
                                 20),
          "tt_contract_bwd": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout),
                                     20)}
    bounds = {"lstm_scan": bound(*lstm_cost(b, t, h), PEAK_FP32),
              "lstm_scan_bwd": bound(*lstm_bwd_cost(b, t, h), PEAK_FP32),
              "tt_contract": bound(b * (k * 2 * r * r + 2 * r), tt_bytes(b, k, r, 4), PEAK_FP32),
              "tt_contract_bwd": bound(*tt_bwd_cost(b, k, r), PEAK_FP32)}
    kernel_ms = sum(ms.values())
    emit({"phase": "timing.stream_step", "shape": {"B": b, "T": t, "H": h, "R": r, "K": k},
          "ms": ms, "bounds": bounds, "kernels_ms": kernel_ms, "step_ms": step_s * 1e3,
          "kernels_share_of_step": kernel_ms / (step_s * 1e3)})


def phase_stream_parity(torch, device):
    """Both routes, "ref" (the plain versions) and "auto" (the kernels),
    from the same seed over the first ``STREAM_PARITY_SLABS`` slabs of the
    stream's source: every param within ``STREAM_PARITY_RTOL`` /
    ``STREAM_PARITY_ATOL``, and their sampled fitness within
    ``FIT_PARITY_TOL``."""
    from repro_torch.codecs import get_codec
    from repro_torch.kernels import ops
    from repro_torch.stream import SyntheticTensorSource, fit_stream

    source = SyntheticTensorSource(STREAM_SHAPE, slab_entries=STREAM_SLAB,
                                   seed=STREAM_SOURCE_SEED)
    runs = {}
    for impl in ("ref", "auto"):
        fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS, kernel_impl=impl)
        ops.reset_launch_counts()
        t = time.perf_counter()
        enc = fit_stream("nttd", source, stop=STREAM_PARITY_SLABS, fitter=fitter)
        torch.cuda.synchronize()
        runs[impl] = (fitter, enc, time.perf_counter() - t, ops.launch_counts())
    (plain, plain_enc, plain_s, plain_launches) = runs["ref"]
    (kern, kern_enc, kern_s, launches) = runs["auto"]
    require(not any(plain_launches.values()), f"the ref route launched {plain_launches}")
    steps = STREAM_PARITY_SLABS * STREAM_OPTS["steps_per_slab"]
    require(launches["lstm_scan_bwd"] == launches["tt_contract_bwd"] == steps,
            f"the auto route launched {launches} in {steps} steps")
    diffs = {}
    worst = 0.0
    for (key, got), (_, want) in zip(_param_leaves(kern.params), _param_leaves(plain.params)):
        excess = ((got - want).abs() - STREAM_PARITY_ATOL
                  - STREAM_PARITY_RTOL * want.abs()).max().item()
        diffs[key] = float((got - want).abs().max())
        worst = max(worst, excess)
    fit_auto = sampled_fitness(source, kern_enc, STREAM_PARITY_ENTRIES, SEED)
    fit_ref = sampled_fitness(source, plain_enc, STREAM_PARITY_ENTRIES, SEED)
    emit({"phase": "stream.parity", "slabs": STREAM_PARITY_SLABS, "steps": steps,
          "rtol": STREAM_PARITY_RTOL, "atol": STREAM_PARITY_ATOL,
          "max_abs_param_diff": diffs, "worst_excess_over_tolerance": worst,
          "fitness_auto": fit_auto, "fitness_ref": fit_ref,
          "fitness_entries": STREAM_PARITY_ENTRIES, "fitness_tolerance": FIT_PARITY_TOL,
          "seconds_auto": kern_s, "seconds_ref": plain_s, "launches_auto": launches})
    require(worst <= 0, f"stream params differ beyond rtol {STREAM_PARITY_RTOL} / atol "
            f"{STREAM_PARITY_ATOL}: {diffs}")
    require(abs(fit_auto - fit_ref) <= FIT_PARITY_TOL,
            f"sampled fitness {fit_auto} (auto) against {fit_ref} (ref)")


def _param_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _param_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def phase_stream_delta(torch, device, workdir):
    """A delta chain on the card: a keyframe from ``fit_stream`` at
    ``STREAM_DELTA_SHAPE``, two residuals (``STREAM_DELTA_SCALE`` times the
    sources of ``STREAM_DELTA_SEEDS``) fitted by one ``DeltaFitter``, written
    by the delta-mode ``ChunkedWriter`` with a ``sync`` after each version.
    Read back on the card the file is a ``ChainEncoded`` whose answers are
    the f64 sum of its components', each decoded by one fused launch.
    Returns the file's path (in ``workdir``)."""
    import numpy as np

    from repro_torch.codecs import load_file
    from repro_torch.kernels import ops, ref
    from repro_torch.stream import ChunkedWriter, SyntheticTensorSource, fit_stream
    from repro_torch.temporal import ChainEncoded, DeltaFitter

    t0 = time.perf_counter()
    key_source = SyntheticTensorSource(STREAM_DELTA_SHAPE, slab_entries=STREAM_SLAB,
                                       seed=STREAM_SOURCE_SEED)
    keyframe = fit_stream("nttd", key_source, **STREAM_OPTS)
    fitter = DeltaFitter(STREAM_DELTA_SHAPE, "nttd", slab_entries=1 << 16,
                         opts=STREAM_DELTA_OPTS)
    parts = [keyframe]
    for seed in STREAM_DELTA_SEEDS:
        src = SyntheticTensorSource(STREAM_DELTA_SHAPE, slab_entries=STREAM_SLAB, seed=seed)
        dense = np.concatenate([s.values for s in src.iter_slabs()]).reshape(STREAM_DELTA_SHAPE)
        parts.append(fitter.fit_residual(STREAM_DELTA_SCALE * dense))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, n, REQUEST) for n in STREAM_DELTA_SHAPE], axis=1)
    path = os.path.join(workdir, "delta.tcdc")
    synced = []
    with ChunkedWriter(path, "nttd", delta=True) as w:
        for v, enc in enumerate(parts):
            w.begin_version(v - 1)
            body = enc.to_bytes()
            for at in range(0, len(body), STREAM_CHUNK_BYTES):
                w.append(body[at:at + STREAM_CHUNK_BYTES])
            synced.append(w.sync())
    chain = load_file(path, device=device)
    require(isinstance(chain, ChainEncoded) and len(chain.components) == len(parts),
            f"the delta file read back as {type(chain).__name__}")
    require(all(c.ct.device.type == "cuda" and c.ct.cfg.kernel_impl == "auto"
                for c in chain.components), "a chain component is not on the card's decode")
    with plain_calls_counted(ref) as plain:
        ops.reset_launch_counts()
        got = chain.decode_at(idx)
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0 and launches["decode_tile"] == len(parts),
            f"the chain's request launched {launches}, plain {plain}")
    want = np.zeros(REQUEST)
    for c in chain.components:
        want += np.asarray(c.decode_at(idx), np.float64)
    np.testing.assert_array_equal(got, want)
    fitted = sum(np.asarray(p.decode_at(idx), np.float64) for p in parts)
    np.testing.assert_allclose(got, fitted, rtol=1e-6, atol=1e-7)
    emit({"phase": "stream.delta", "shape": list(STREAM_DELTA_SHAPE),
          "keyframe": STREAM_OPTS, "delta": STREAM_DELTA_OPTS,
          "residuals": [f"{STREAM_DELTA_SCALE} x SyntheticTensorSource seed {s}"
                        for s in STREAM_DELTA_SEEDS],
          "versions": len(parts), "bytes_after_each_sync": synced,
          "component_bytes": [len(p.to_bytes()) for p in parts], "fit_seconds": fit_s,
          "max_abs_vs_fitted": float(np.abs(got - fitted).max()),
          "request_entries": REQUEST, "launches": launches})
    return path


def service_pems_file(enc, workdir):
    """Phase main's PEMS-SF payload as a chunked v3 file of
    ``SERVICE_CHUNKS`` chunks, with a held-out block of ``SERVICE_HELDOUT``
    entries whose values are the plain route's decode."""
    import numpy as np

    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.stream import write_chunked

    rng = np.random.default_rng(SEED + 7)
    flat = np.sort(rng.choice(int(np.prod(PEMS_SHAPE)), SERVICE_HELDOUT, replace=False))
    pos = np.stack(np.unravel_index(flat, PEMS_SHAPE), axis=1)
    truth = _with_impl(enc, "ref", NTTDEncoded).decode_at(pos).astype(np.float64)
    path = os.path.join(workdir, "pems.tcdc")
    chunk = -(-len(enc.to_bytes()) // SERVICE_CHUNKS)
    return path, write_chunked(path, enc, chunk_bytes=chunk, heldout=(flat.astype(np.int64),
                                                                        truth))


def service_store(torch, smi, workdir):
    """A ``VersionedStore`` written on the card at fig10's NTTD settings:
    the keyframe fitted by ``compress`` and seven residuals by one
    ``DeltaFitter``, both on the default device through the training
    kernels, forward and backward; no plain version may run.  Returns the
    file's path and the launches of the writing."""
    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.temporal import VersionedStore, drifting_versions

    data = drifting_versions(STORE_SHAPE, STORE_VERSIONS, **STORE_DRIFT)
    path = os.path.join(workdir, "store.tcdc")
    appends = []
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with VersionedStore.create(path, "nttd", keyframe_interval=STORE_KEYFRAME_INTERVAL,
                                   chunk_bytes=STORE_CHUNK_BYTES,
                                   keyframe_opts=STORE_KEYFRAME_OPTS,
                                   delta_opts=STORE_DELTA_OPTS, delta_passes=2) as store:
            for x in data:
                t = time.perf_counter()
                stats = store.append(x)  # ends in a host read: the fitness
                appends.append({**stats, "seconds": time.perf_counter() - t})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran writing the store: {plain}")
    for name in ("decode_tile", "lstm_scan", "lstm_scan_bwd", "tt_contract", "tt_contract_bwd"):
        require(launches[name] > 0, f"{name} was not launched writing the store: {launches}")
    require(all(np.isfinite(a["fitness"]) for a in appends), f"store appends {appends}")
    emit({"phase": "service.store", "shape": list(STORE_SHAPE), "versions": STORE_VERSIONS,
          "keyframe_interval": STORE_KEYFRAME_INTERVAL, "drift": STORE_DRIFT,
          "keyframe": STORE_KEYFRAME_OPTS, "delta": STORE_DELTA_OPTS,
          "source": "benchmarks/fig10_temporal.py:120-131 (the NTTD cell, default mode)",
          "appends": appends, "seconds": seconds, "file_bytes": os.path.getsize(path),
          "launches": launches, "plain_calls": plain, "name_power_limit": smi})
    return path, launches


def service_traffic():
    """The requests of one pass, drawn once from a seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)

    def uniform(shape, n):
        return np.stack([rng.integers(0, s, n) for s in shape], axis=1)

    def flat_range(lo, hi, n):
        return np.stack(np.unravel_index(rng.integers(lo, hi, n), PEMS_SHAPE), axis=1)

    first, tiles, n_window = SERVICE_WINDOW
    t = SERVICE_TILE
    sweep_lo = (first + tiles) * t
    return {
        "direct": [uniform(PEMS_SHAPE, REQUEST) for _ in range(SERVICE_DIRECT)],
        "window": [flat_range(first * t, (first + tiles) * t, REQUEST) for _ in range(n_window)],
        "sweep": flat_range(sweep_lo, sweep_lo + SERVICE_SWEEP_TILES * t, REQUEST),
        "submits": [uniform(PEMS_SHAPE, SERVICE_SUBMITS[1]) for _ in range(SERVICE_SUBMITS[0])],
        "delta": uniform(STREAM_DELTA_SHAPE, REQUEST),
        "store": uniform(STORE_SHAPE, REQUEST),
        "fig5": [uniform(STREAM_SHAPE, REQUEST) for _ in range(SERVICE_FIG5_REQUESTS)],
    }


def payload_device_bytes(svc) -> int:
    """Device bytes the service's materialized NTTD payloads hold: their
    params and, once built, the fused decode's operands (each storage once:
    an operand already in its layout is the param itself)."""
    storages = {}
    encs = [sp.enc for sp in svc._streams.values() if sp.enc is not None]
    encs += [e for sp in svc._streams.values() for e in sp.vencs.values()]
    for enc in encs:
        tensors = [t for _, t in _param_leaves(enc.ct.params)]
        tensors += list(enc.ct.__dict__.get("decode_operands", ()))
        for t in tensors:
            if t.is_cuda:
                storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(storages.values())


def service_pass(torch, paths, traffic, prefetch):
    """One pass of the traffic through a fresh ``CodecService`` on the
    card.  Returns the answers, the request ms, the stats, the device memory
    checks and the predicted ``decode_tile`` launches."""
    import gc

    import numpy as np

    from repro_torch.serve.codec_service import CodecService

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    svc = CodecService(cache_bytes=SERVICE_CACHE_BYTES, prefetch=prefetch, **SERVICE_CANARY)
    require(svc.device.type == "cuda", f"the service runs on {svc.device}")
    answers, ms, resident, memory = {}, {}, [], {}

    def ask(label, name, idx, version=None):
        t = time.perf_counter()
        answers[label] = svc.decode_at(name, idx, version=version)
        ms[label] = (time.perf_counter() - t) * 1e3
        resident.append(svc.cache_stats.resident_bytes)

    def held(label):  # device memory is what the materialized payloads hold
        gc.collect()
        memory[label] = (torch.cuda.memory_allocated() - base, payload_device_bytes(svc))

    svc.load_stream("pems", paths["pems"])
    svc.load_stream("pems_tiled", paths["pems"], tile_entries=SERVICE_TILE)
    for name in ("delta", "store", "fig5"):
        svc.load_stream(name, paths[name])
    for i, idx in enumerate(traffic["direct"]):
        ask(f"direct{i}", "pems", idx)
    for i, idx in enumerate(traffic["window"]):
        ask(f"window{i}", "pems_tiled", idx)
    held("before_sweep")
    ask("sweep", "pems_tiled", traffic["sweep"])
    held("after_sweep")
    t = time.perf_counter()
    tickets = [svc.submit("pems", idx) for idx in traffic["submits"]]
    out = svc.flush()
    ms["flush"] = (time.perf_counter() - t) * 1e3
    require(not svc.failed, f"flush failed: {svc.failed}")
    answers["flush"] = np.concatenate([out[k] for k in tickets])
    for name in ("delta", "store"):
        for v in range(svc.info(name).n_versions):
            ask(f"{name}_v{v}", name, traffic[name], v)
    for i, idx in enumerate(traffic["fig5"]):
        ask(f"fig5_{i}", "fig5", idx)
    held("after_queries")
    on_card = [sp.enc.ct.device.type for sp in svc._streams.values() if sp.enc is not None]
    on_card += [e.ct.device.type for sp in svc._streams.values() for e in sp.vencs.values()]
    stats = {"cache": svc.cache_stats.as_dict(),
             "info": {n: dataclasses.asdict(svc.info(n)) for n in svc.payloads()},
             "canary": svc.canary_stats(), "metrics": svc.metrics.as_dict()}
    checks = sum(c["value"] for c in stats["metrics"]["counters"] if c["name"] == "canary_checks")
    predicted = sum(i["decode_calls"] for i in stats["info"].values()) + checks
    for name in svc.payloads():
        svc.unload(name)
        held(f"unload_{name}")
    torch.cuda.synchronize()
    return {"answers": answers, "ms": ms, "stats": stats, "resident": resident,
            "memory": memory, "on_card": on_card, "predicted_decode_tile": predicted,
            "canary_checks": checks}


def service_summary(run) -> dict:
    """The timing and cache numbers of a pass, for the phase's line."""
    import numpy as np

    ms, cache = run["ms"], run["stats"]["cache"]
    n_window = SERVICE_WINDOW[2]
    return {
        "direct_ms": [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)],
        "direct_ms_median": float(np.median([ms[f"direct{i}"] for i in range(SERVICE_DIRECT)])),
        "tiled_miss_ms": ms["window0"],
        "tiled_hit_ms_median": float(np.median([ms[f"window{i}"] for i in range(1, n_window)])),
        "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
        "versioned_ms": {k: v for k, v in ms.items() if k.startswith(("delta", "store"))},
        "fig5_ms": [ms[f"fig5_{i}"] for i in range(SERVICE_FIG5_REQUESTS)],
        "hits": cache["hits"], "misses": cache["misses"], "evictions": cache["evictions"],
        "hit_ratio": cache["hits"] / max(cache["hits"] + cache["misses"], 1),
        "resident_bytes_max": max(run["resident"]), "resident_bytes_end": run["resident"][-1],
        "device_bytes": run["memory"],
    }


def phase_service(torch, device, smi, enc, workdir, stream_path, delta_path):
    """``CodecService`` on the card (ROADMAP A.5): phase main's PEMS-SF
    payload as a lazily loaded chunked v3 file, direct and through 256 KiB
    decode tiles under a 64 MiB budget, coalesced submits, every version of
    phase stream.delta's v4 file and of a ``VersionedStore`` written here,
    and canaries on phase stream's fig5 file.  The traffic runs with
    prefetch off, on, with tracing on, and once through the plain route
    (``REPRO_DECODE_IMPL=ref``): the first three bitwise equal in answers
    and stats, the plain pass within ``SERVICE_TOL``.  The first pass must
    launch ``decode_tile`` exactly once per counted decode call and canary
    check and run no plain version; every materialized payload is on the
    card; evictions happen and resident bytes stay within the budget; device
    memory is at every check what the materialized payloads hold, within
    ``SERVICE_MEM_SLACK``, and back to the baseline after the last unload.
    Returns the first pass's launches and the store's."""
    import json

    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops, ref
    from repro_torch.temporal import VersionedReader

    t0 = time.perf_counter()
    pems_path, pems_bytes = service_pems_file(enc, workdir)
    store_path, store_launches = service_store(torch, smi, workdir)
    paths = {"pems": pems_path, "fig5": stream_path, "delta": delta_path, "store": store_path}
    traffic = service_traffic()
    setup_s = time.perf_counter() - t0

    obs.clear_events()
    with plain_calls_counted(ref) as plain:
        ops.reset_launch_counts()
        runs = {"prefetch_off": service_pass(torch, paths, traffic, prefetch=False)}
        launches = ops.launch_counts()
    breaches = obs.events("quality_breach")
    require(sum(plain.values()) == 0, f"plain versions ran in the service pass: {plain}")
    first = runs["prefetch_off"]
    require(launches["decode_tile"] == first["predicted_decode_tile"],
            f"decode_tile launched {launches['decode_tile']} times; the rule "
            f"(decode calls + canary checks) predicts {first['predicted_decode_tile']}")
    runs["prefetch_on"] = service_pass(torch, paths, traffic, prefetch=True)
    rec = obs.enable_tracing(capacity=1 << 17)
    rec.clear()
    try:
        runs["tracing_on"] = service_pass(torch, paths, traffic, prefetch=False)
        spans = rec.snapshot()
        trace_path = os.path.join(workdir, "service_trace.json")
        n_spans = obs.export_chrome_trace(trace_path)
    finally:
        obs.disable_tracing()
        rec.clear()
    os.environ["REPRO_DECODE_IMPL"] = "ref"
    try:
        plain_run = service_pass(torch, paths, traffic, prefetch=False)
    finally:
        os.environ.pop("REPRO_DECODE_IMPL")

    for key, run in runs.items():
        require(all(d == "cuda" for d in run["on_card"]) and run["on_card"],
                f"{key}: materialized payloads on {run['on_card']}")
        cache = run["stats"]["cache"]
        require(cache["evictions"] > 0, f"{key}: no eviction under the budget")
        require(max(run["resident"]) <= SERVICE_CACHE_BYTES, f"{key}: resident bytes "
                f"{max(run['resident'])} above the budget")
        for label, (allocated, payloads) in run["memory"].items():
            require(abs(allocated - payloads) <= SERVICE_MEM_SLACK,
                    f"{key} {label}: {allocated} device bytes allocated, payloads hold "
                    f"{payloads}")
        last = [v for k, v in run["memory"].items() if k.startswith("unload_")][-1]
        require(last[0] <= SERVICE_MEM_SLACK, f"{key}: {last[0]} bytes left after unloads")
        if key != "prefetch_off":  # observational: bitwise the first pass
            require(run["answers"].keys() == first["answers"].keys(), key)
            for label, got in run["answers"].items():
                np.testing.assert_array_equal(got, first["answers"][label], err_msg=label)
            require(run["stats"] == first["stats"], f"{key}: stats differ from prefetch off")
    for label, got in first["answers"].items():
        require(got.shape[0] > 0 and bool(np.isfinite(got).all()), f"answer {label}")
        np.testing.assert_allclose(got, plain_run["answers"][label], rtol=SERVICE_TOL,
                                   atol=SERVICE_TOL, err_msg=label)
    err = max(float(np.abs(got - plain_run["answers"][label]).max())
              for label, got in first["answers"].items())
    for name in ("delta", "store"):  # the eager reader's chain sums, bitwise
        with VersionedReader(paths[name]) as reader:
            for v in range(reader.n_versions):
                np.testing.assert_array_equal(first["answers"][f"{name}_v{v}"],
                                              reader.decode_at(traffic[name], v))
    names = {s.name for s in spans}
    want = {"decode_at", "materialize", "chunk_read", "tile_decode", "canary", "kernel_decode"}
    require(want <= names, f"the trace lacks {want - names}")
    with open(trace_path) as f:
        doc = json.load(f)
    require(len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == n_spans == len(spans),
            "the exported trace does not hold the recorded spans")
    materialize_ms = {}
    for s in spans:
        if s.name == "materialize":
            materialize_ms.setdefault(s.attrs["payload"], []).append(s.duration * 1e3)
    emit({"phase": "service", "payloads": {
              "pems": {"shape": list(PEMS_SHAPE), "file_bytes": pems_bytes,
                       "chunks": SERVICE_CHUNKS, "heldout": SERVICE_HELDOUT,
                       "tile_entries": SERVICE_TILE,
                       "tiles": -(-int(np.prod(PEMS_SHAPE)) // SERVICE_TILE)},
              "fig5": {"shape": list(STREAM_SHAPE)}, "delta": {"shape": list(STREAM_DELTA_SHAPE)},
              "store": {"shape": list(STORE_SHAPE), "versions": STORE_VERSIONS}},
          "cache_bytes": SERVICE_CACHE_BYTES, "canary": SERVICE_CANARY,
          "request_entries": REQUEST, "setup_s": setup_s,
          "passes": {k: service_summary(r) for k, r in runs.items()},
          "plain_pass": service_summary(plain_run),
          "identical_across_passes": True, "max_abs_err_vs_plain": err,
          "tol_vs_plain": SERVICE_TOL, "launches": launches,
          "predicted_decode_tile": first["predicted_decode_tile"],
          "canary_checks": first["canary_checks"], "canary_stats": first["stats"]["canary"],
          "quality_breach_events": [{k: v for k, v in e.items() if k != "t"} for e in breaches],
          "spans": len(spans), "span_names": sorted(names),
          "materialize_ms_traced": materialize_ms,
          "mem_slack_bytes": SERVICE_MEM_SLACK, "plain_calls": plain,
          "seconds": time.perf_counter() - t0, "name_power_limit": smi})
    return launches, store_launches, pems_path, traffic, first["answers"]


def fleet_member_decodes(svc) -> int:
    """The ``decode_tile`` launches a member's service accounts for, by
    phase service's rule: its NTTD payloads' decode calls plus its canary
    checks."""
    calls = sum(svc.info(name).decode_calls for name in svc.payloads())
    return calls + sum(c["value"] for c in svc.metrics.as_dict()["counters"]
                       if c["name"] == "canary_checks")


def fleet_serve(fleet, traffic, want, after_request=None) -> dict:
    """Phase service's PEMS-SF traffic through a fleet: the direct requests
    (untiled), the window requests and the sweep (tiled), the submits and
    one flush.  Every answer must be bitwise phase service's single
    ``CodecService``'s.  Returns the request ms by label."""
    import numpy as np

    ms = {}

    def same(label, got):
        require(got.dtype == want[label].dtype, f"{label}: {got.dtype} != {want[label].dtype}")
        np.testing.assert_array_equal(got, want[label], err_msg=label)

    def ask(label, name, idx):
        t = time.perf_counter()
        got = fleet.decode_at(name, idx)
        ms[label] = (time.perf_counter() - t) * 1e3
        same(label, got)
        if after_request is not None:
            after_request()

    for i, idx in enumerate(traffic["direct"]):
        ask(f"direct{i}", "pems", idx)
    for i, idx in enumerate(traffic["window"]):
        ask(f"window{i}", "pems_tiled", idx)
    ask("sweep", "pems_tiled", traffic["sweep"])
    t = time.perf_counter()
    tickets = [fleet.submit("pems", idx) for idx in traffic["submits"]]
    out = fleet.flush()
    ms["flush"] = (time.perf_counter() - t) * 1e3
    require(not fleet.failed, f"the fleet failed tickets: {fleet.failed}")
    same("flush", np.concatenate([out[k] for k in tickets]))
    return ms


def fleet_rebalance(flt, fleet, traffic, want, after_request=None, **change) -> dict:
    """A membership change behind the drain barrier: submits queued before
    it must all be answered after it, bitwise; then the direct requests
    again."""
    import numpy as np

    n = FLEET_DRAIN_SUBMITS
    tickets = [fleet.submit("pems", idx) for idx in traffic["submits"][:n]]
    t = time.perf_counter()
    report = flt.rebalance(fleet, **change)
    seconds = time.perf_counter() - t
    out = fleet.flush()
    require(all(k in out for k in tickets) and not fleet.failed,
            f"rebalance {change}: queued tickets lost ({sorted(set(tickets) - set(out))}, "
            f"failed {fleet.failed})")
    np.testing.assert_array_equal(np.concatenate([out[k] for k in tickets]),
                                  want["flush"][:n * SERVICE_SUBMITS[1]])
    ms = []
    for i, idx in enumerate(traffic["direct"]):
        t = time.perf_counter()
        got = fleet.decode_at("pems", idx)
        ms.append((time.perf_counter() - t) * 1e3)
        np.testing.assert_array_equal(got, want[f"direct{i}"], err_msg=f"direct{i} {change}")
        if after_request is not None:
            after_request()
    return {"change": change, "seconds": seconds, "chunks_moved": report.chunks_moved,
            "tiles_moved": report.tiles_moved, "tiles_warmed": report.tiles_warmed,
            "bytes_dropped": report.bytes_dropped, "drained_tickets": len(tickets),
            "direct_ms_median": float(np.median(ms))}


def gpu_pids() -> dict:
    """pid -> used memory of every process holding a context on the card,
    as ``nvidia-smi`` sees them (in a container, pids of its namespace)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    rows = [line.split(",") for line in res.stdout.splitlines() if line.strip()]
    return {int(r[0]): r[1].strip() for r in rows if r[0].strip().isdigit()}


def gpu_memory_used_mib() -> int:
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return int(res.stdout.split()[0])


def device_files(pid: int) -> list[str]:
    """The card's device nodes a process holds open (``/dev/nvidia<N>`` is
    opened by a process with a context on card N)."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def worker_contexts(procs, used_before_mib: int) -> dict:
    """Each worker must hold a CUDA context on the card.  Where
    ``nvidia-smi`` lists the workers' pids, that is the evidence; where it
    does not (a container whose processes it reports under another pid
    namespace), each worker must hold the card's device node open and the
    card's used memory must have grown by at least 100 MiB a worker since
    before they started."""
    listed = gpu_pids()
    used = gpu_memory_used_mib()
    rows = {iid: {"pid": p.pid, "in_nvidia_smi": p.pid in listed,
                  "device_files": device_files(p.pid)} for iid, p in procs.items()}
    by_smi = all(r["in_nvidia_smi"] for r in rows.values())
    by_node = all(any(re.fullmatch(r"/dev/nvidia\d+", f) for f in r["device_files"])
                  for r in rows.values())
    grown = used - used_before_mib
    require(by_smi or (by_node and grown >= 100 * len(procs)),
            f"workers without a CUDA context: {rows}; nvidia-smi lists {listed}, the card's "
            f"used memory grew {grown} MiB")
    return {"workers": rows, "nvidia_smi_pids": listed, "evidence":
            "nvidia-smi pids" if by_smi else "device node open + used memory",
            "used_mib_before": used_before_mib, "used_mib_after": used}


def traced_split(obs, fleet, idx) -> tuple:
    """One traced direct request -> (answer, spans, the frontend's ms
    outside its members' ``transport.flush`` spans, the members' ms)."""
    rec = obs.enable_tracing(capacity=1 << 16)
    rec.clear()
    try:
        got = fleet.decode_at("pems", idx)
        spans = rec.snapshot()
    finally:
        obs.disable_tracing()
        rec.clear()
    total = sum(s.duration for s in spans if s.name == "fleet.decode_at")
    members = {s.attrs["instance"]: s.duration * 1e3 for s in spans
               if s.name == "transport.flush"}
    return got, spans, {"request_ms": total * 1e3,
                        "frontend_ms": total * 1e3 - sum(members.values()),
                        "member_flush_ms": members}


def fleet_local(torch, device, flt, traffic, want):
    """fleet.local: ``FLEET_INSTANCES`` in-process members on the card."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops

    class Fleet(flt.FleetFrontend):
        """Keeps the decode count of a member as it retires (its service's
        payload stats go with it)."""
        retired_decodes = 0

        def retire_instance(self, iid):
            self.retired_decodes += fleet_member_decodes(self.transports[iid].service)
            return super().retire_instance(iid)

    resident = []

    def within_budget():
        resident.append(max(s.cache_stats.resident_bytes for s in fleet.services.values()))
        require(resident[-1] <= SERVICE_CACHE_BYTES,
                f"a member holds {resident[-1]} resident bytes, above {SERVICE_CACHE_BYTES}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fleet = Fleet(FLEET_INSTANCES, replication=FLEET_REPLICATION,
                  cache_bytes=SERVICE_CACHE_BYTES, device=device, **SERVICE_CANARY)
    try:
        require(all(s.device.type == device.type for s in fleet.services.values()),
                f"fleet members off {device}")
        fleet.load_stream("pems", want["path"])
        fleet.load_stream("pems_tiled", want["path"], tile_entries=SERVICE_TILE)
        ms = fleet_serve(fleet, traffic, want, within_budget)
        removed = fleet_rebalance(flt, fleet, traffic, want, within_budget,
                                  remove=[f"i{FLEET_INSTANCES - 1}"])
        added = fleet_rebalance(flt, fleet, traffic, want, within_budget,
                                add=[f"i{FLEET_INSTANCES}"])
        require(added["tiles_warmed"]["pems_tiled"] > 0,
                f"no tile warmed into the joining member: {added}")
        require(not fleet.failed, f"failed tickets {fleet.failed}")
        traced, _, split = traced_split(obs, fleet, traffic["direct"][1])
        np.testing.assert_array_equal(traced, want["direct1"])
        torch.cuda.synchronize()
        predicted = fleet.retired_decodes + sum(fleet_member_decodes(s)
                                                for s in fleet.services.values())
        metrics = flt.collect(fleet).as_dict()
    finally:
        fleet.close()
    launches = ops.launch_counts()
    require(launches["decode_tile"] == predicted,
            f"fleet.local launched decode_tile {launches['decode_tile']} times; the members "
            f"report {predicted} decode calls and canary checks")
    direct = [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)]
    return launches, {
        "instances": FLEET_INSTANCES, "replication": FLEET_REPLICATION,
        "direct_ms": direct, "direct_ms_median": float(np.median(direct)),
        "tiled_hit_ms_median": float(np.median([ms[f"window{i}"]
                                                for i in range(1, SERVICE_WINDOW[2])])),
        "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
        "rebalance_remove": removed, "rebalance_add": added,
        "resident_bytes_max": max(resident), "traced_request": split, "launches": launches,
        "predicted_decode_tile": predicted, "fleet_cache": metrics["fleet"],
        "canary": metrics["canary"], "seconds": time.perf_counter() - t0}


def fleet_procs(torch, device, flt, obs, traffic, want):
    """fleet.procs: ``FLEET_WORKERS`` worker processes on the same card,
    started together."""
    import numpy as np
    from torch_slo_smoke import start_workers

    from repro_torch.kernels import ops

    spawn_s = {}

    def spawn(iid):
        t = time.perf_counter()
        transport = flt.SocketTransport.spawn(iid, cache_bytes=SERVICE_CACHE_BYTES,
                                              device=str(device), timeout=120.0,
                                              **SERVICE_CANARY)
        transport.ping()
        spawn_s[iid] = time.perf_counter() - t
        return transport

    ops.reset_launch_counts()
    used_before = gpu_memory_used_mib()
    t0 = time.perf_counter()
    fleet = flt.FleetFrontend(start_workers(spawn, [f"w{k}" for k in range(FLEET_WORKERS)]),
                              replication=FLEET_REPLICATION, transport_factory=spawn,
                              device=device)
    spawn_wall = time.perf_counter() - t0
    procs = {iid: t._proc for iid, t in fleet.transports.items()}
    try:
        fleet.load_stream("pems", want["path"])
        fleet.load_stream("pems_tiled", want["path"], tile_entries=SERVICE_TILE)
        ms = fleet_serve(fleet, traffic, want)
        contexts = worker_contexts(procs, used_before)
        traced, spans, split = traced_split(obs, fleet, traffic["direct"][1])
        np.testing.assert_array_equal(traced, want["direct1"])
        metrics = flt.collect(fleet).as_dict()
    finally:
        fleet.close()
    for iid, p in procs.items():
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            require(False, f"worker {iid} outlived close()")
    launches = ops.launch_counts()
    require(sum(launches.values()) == 0, f"the frontend launched kernels itself: {launches}")
    flushes = {s.span_id: s.attrs.get("instance") for s in spans if s.name == "transport.flush"}
    remote = [s for s in spans if s.instance in procs]
    ids = {s.span_id for s in remote}
    roots = [s for s in remote if s.parent_id not in ids]
    require(len({s.trace_id for s in spans}) == 1, "the traced request is not one trace")
    require(any(s.name == "kernel_decode" for s in remote),
            f"no worker kernel_decode span: {sorted({s.name for s in remote})}")
    require(roots and all(flushes.get(s.parent_id) == s.instance for s in roots),
            "worker spans not under the frontend's transport.flush")
    direct = [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)]
    return {"workers": FLEET_WORKERS, "replication": FLEET_REPLICATION,
            "spawn_s": spawn_s, "spawn_wall_s": spawn_wall, "cuda_contexts": contexts,
            "direct_ms": direct, "direct_ms_median": float(np.median(direct)),
            "tiled_hit_ms_median": float(np.median([ms[f"window{i}"]
                                                    for i in range(1, SERVICE_WINDOW[2])])),
            "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
            "traced_request": split, "traced_spans": len(spans), "worker_spans": len(remote),
            "worker_kernel_decode_spans": sum(s.name == "kernel_decode" for s in remote),
            "fleet_cache": metrics["fleet"], "canary": metrics["canary"],
            "exited": {iid: p.returncode for iid, p in procs.items()},
            "seconds": time.perf_counter() - t0}


def phase_fleet(torch, device, smi, workdir, pems_path, traffic, answers):
    """The serving fleet on the card (ROADMAP A.6): phase service's PEMS-SF
    file and traffic through ``FLEET_INSTANCES`` in-process members
    (``fleet.local``: bitwise phase service's answers, rebalances behind
    the drain barrier with a warm handoff, resident bytes within each
    member's budget, ``decode_tile`` launched once per decode call and
    canary check the members report), through ``FLEET_WORKERS`` worker
    processes (``fleet.procs``: bitwise the same, each worker holding a
    CUDA context, one stitched trace), then the SLO and repair drills of
    ``scripts/torch_slo_smoke.py`` and ``scripts/torch_repair_drill.py``
    (the repair's NTTD refit launching the training kernels, no plain
    version).  Returns this process's launches over the phase."""
    from repro_torch import fleet as flt
    from repro_torch import obs
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_repair_drill
    import torch_slo_smoke

    t0 = time.perf_counter()
    want = {**answers, "path": pems_path}
    with plain_calls_counted(ref) as plain:
        local_launches, local = fleet_local(torch, device, flt, traffic, want)
        emit({"phase": "fleet.local", **local, "name_power_limit": smi})
        procs = fleet_procs(torch, device, flt, obs, traffic, want)
        emit({"phase": "fleet.procs", **procs, "name_power_limit": smi})
        ops.reset_launch_counts()
        slo = torch_slo_smoke.run(str(device))
        slo_launches = ops.launch_counts()
        emit({"phase": "fleet.slo", **slo, "launches": slo_launches, "name_power_limit": smi})
        ops.reset_launch_counts()
        repair = torch_repair_drill.run(str(device), out=os.path.join(workdir, "repair_drill"))
        torch.cuda.synchronize()
        repair_launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran in phase fleet: {plain}")
    require(slo["decisions"].count("scale_up") == 1 and slo["decisions"].count("scale_down") == 1,
            f"slo drill {slo['decisions']}")
    quality = repair["runs"][1]
    training = ["lstm_scan", "lstm_scan_bwd"]
    if quality["middle_cores"] >= 1:
        training += ["tt_contract", "tt_contract_bwd"]
    require(quality["device"].startswith(device.type), f"the refit ran on {quality['device']}")
    for name in training + ["decode_tile"]:
        require(repair_launches[name] > 0,
                f"the repair's refit did not launch {name}: {repair_launches}")
    emit({"phase": "fleet.repair", **repair, "launches": repair_launches,
          "kernels_of_the_refit": training,
          "time_to_repair_s": {r["kind"]: r["time_to_repair_s"] for r in repair["runs"]},
          "refit_entries_per_sec": quality["refit_entries_per_sec"],
          "name_power_limit": smi})
    total = {k: local_launches[k] + slo_launches[k] + repair_launches[k]
             for k in local_launches}
    emit({"phase": "fleet", "seconds": time.perf_counter() - t0, "launches": total,
          "plain_calls": plain, "name_power_limit": smi})
    return total


FIT_STEP_SHAPE = (8192, 10, 18, 10)  # B, T (PEMS-SF's d'), H, R of the MEDIUM fit


def fit_step_operands(torch, device):
    """The backward kernels' operands at the MEDIUM fit shape: the
    lstm_scan backward's (x, (wi, wh, b), hs, dhs), hs from the forward
    kernel as training saves it, and the tt_contract backward's (first,
    mid, last, dout) at K = T - 2."""
    from repro_torch.kernels import ops

    b, t, h, r = FIT_STEP_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    x, lw, dhs = lstm_bwd_inputs(torch, gen, b, t, h, device)
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    return (x, lw, hs, dhs), tt_bwd_inputs(torch, gen, b, t - 2, r, device)


def bwd_timing(torch, device, fit_launches, errs, step_s, operands, bwd_ops):
    """The two backward kernels at the MEDIUM fit shape (B 8192, T 10 (PEMS-
    SF's d'), H 18, R 10, K 8; ``operands`` from ``fit_step_operands``): the
    whole backward call a training step makes, the kernel alone where the
    call adds products, the plain version and, for ``lstm_scan``, cuDNN's
    backward, with CUDA events like every row; each row also names its plan
    and the device operations of one call with their device microseconds
    (``bwd_ops``, from ``phase_timing``'s profiler session), and the
    ``tt_contract`` row its share of the bound by both times.  A
    ``timing.fit_step`` line sets the four kernels of a step beside the fit
    phase's seconds a step.  Returns the two rows."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    b, t, h, r = FIT_STEP_SHAPE
    k = t - 2
    (x, lw, hs, dhs), (first, mid, last, dout) = operands
    lib_run, lib_grads = cudnn_lstm_backward(torch, x, *lw, dhs)
    plain_grads = ref.lstm_scan_bwd(x, *lw, dhs)
    lib_err = max(float((g - w).abs().max()) for g, w in zip(lib_grads(), plain_grads))
    rows = []
    n_ops, n_bytes = lstm_bwd_cost(b, t, h)
    k_ops, k_bytes = lstm_bwd_kernel_cost(b, t, h)
    kernel_bound = bound(k_ops, k_bytes, PEAK_FP32)
    rows.append({
        "name": "lstm_scan_bwd", "route": "cuda", "source": SOURCES["lstm_scan_bwd"][0],
        "replaces": SOURCES["lstm_scan_bwd"][1], "launches": fit_launches["lstm_scan_bwd"],
        "max_abs_err": errs["lstm_scan_bwd"],
        "ms": time_ms(torch, lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs), 20),
        "plain_ms": time_ms(torch, lambda: ref.lstm_scan_bwd(x, *lw, dhs), 5),
        **bound(n_ops, n_bytes, PEAK_FP32),
        "library_ms": time_ms(torch, lib_run, 20),
        "library": "cuDNN torch.nn.LSTM backward: autograd.grad of a kept forward graph, "
                   "dx and every weight", "library_max_abs_err": lib_err,
        "kernel_ms": time_ms(torch, lambda: _lstm.bwd_gates(x, *lw, hs, dhs), 20),
        "kernel_bound_ms": kernel_bound["bound_ms"], "kernel_bound_by": kernel_bound["bound_by"],
        "kernel_ops": k_ops, "kernel_bytes": k_bytes,
        "plan": dataclasses.asdict(_lstm.bwd_plan(h, b)), "device_ops_per_call": bwd_ops[0],
        "shape": {"B": b, "T": t, "H": h}, "ops": n_ops, "bytes": n_bytes,
        "note": "ms: the wrapper (the kernel: dx, G and A; then [dwi; dwh; db] = A^T G, one "
                "matmul); kernel_ms: the kernel alone; plain_ms: autograd of the plain forward, "
                "forward included",
    })
    n_ops, n_bytes = tt_bwd_cost(b, k, r)
    plan = _tt.bwd_plan(r, k, b, torch.cuda.get_device_properties(device).multi_processor_count)
    rows.append({
        "name": "tt_contract_bwd", "route": "cuda", "source": SOURCES["tt_contract_bwd"][0],
        "replaces": SOURCES["tt_contract_bwd"][1], "launches": fit_launches["tt_contract_bwd"],
        "max_abs_err": errs["tt_contract_bwd"],
        "ms": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout), 20),
        "plain_ms": time_ms(torch, lambda: ref.tt_contract_bwd(first, mid, last, dout), 5),
        **bound(n_ops, n_bytes, PEAK_FP32), "library_ms": None,
        "library": None, "library_max_abs_err": None,
        "plan": plan.kind, "entries": plan.entries, "blocks": plan.blocks,
        "threads": plan.threads, "device_ops_per_call": bwd_ops[1],
        "kernel_ms": bwd_ops[1][0][1] / 1e3, "shape": {"B": b, "K": k, "R": r},
        "ops": n_ops, "bytes": n_bytes,
        "note": "ms: back-to-back calls (CUDA events), host work included where it outlasts "
                "the kernel; kernel_ms: the kernel's device time in one profiled call",
    })
    rows[1].update(bound_share=rows[1]["bound_ms"] / rows[1]["ms"],
                   kernel_bound_share=rows[1]["bound_ms"] / rows[1]["kernel_ms"])
    step = {"lstm_scan": time_ms(torch, lambda: ops.lstm_scan(x, *lw, impl="cuda"), 20),
            "lstm_scan_bwd": rows[0]["ms"],
            "tt_contract": time_ms(torch, lambda: ops.tt_contract(first, mid, last,
                                                                  impl="cuda"), 20),
            "tt_contract_bwd": rows[1]["ms"]}
    # each kernel's bound at this shape (the forward rows of the kernel
    # table are at a decode request's shape)
    bounds = {"lstm_scan": bound(*lstm_cost(b, t, h), PEAK_FP32),
              "lstm_scan_bwd": {"bound_ms": rows[0]["bound_ms"],
                                "bound_by": rows[0]["bound_by"]},
              "tt_contract": bound(b * (k * 2 * r * r + 2 * r), tt_bytes(b, k, r, 4), PEAK_FP32),
              "tt_contract_bwd": {"bound_ms": rows[1]["bound_ms"],
                                  "bound_by": rows[1]["bound_by"]}}
    kernel_ms = sum(step.values())
    emit({"phase": "timing.fit_step", "shape": {"B": b, "T": t, "H": h, "R": r},
          "ms": step, "bounds": bounds, "kernels_ms": kernel_ms, "step_ms": step_s * 1e3,
          "kernels_share_of_step": kernel_ms / (step_s * 1e3)})
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # full f32 everywhere: no TF32 in matmuls (the unfused heads, the plain
    # versions) or in cuDNN (the nn.LSTM yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")  # files phase service serves
    try:
        smi = phase_device(torch)
        errs = phase_kernels(torch, device)
        errs.update(phase_kernels_bwd(torch, device))
        phase_golden(torch, device)
        enc, idx, launches = phase_main(torch, device)
        simt_launches, lstm_simt_launches = phase_wide(torch, device)
        fit_launches, step_s = phase_fit(torch, device)
        phase_fit_parity(torch, device)
        stream_launches, stream_step_s, stream_path = phase_stream(torch, device, smi, workdir)
        phase_stream_parity(torch, device)
        delta_path = phase_stream_delta(torch, device, workdir)
        service_launches, store_launches, *served = phase_service(
            torch, device, smi, enc, workdir, stream_path, delta_path)
        fleet_launches = phase_fleet(torch, device, smi, workdir, *served)
        serve_launches = phase_serve(torch, device)
        simt_lstm = lstm_simt_timing(torch, device, lstm_simt_launches, errs)
        from repro_torch.kernels import lstm as _lstm
        from repro_torch.kernels import tt_contract as _tt

        fit_ops = fit_step_operands(torch, device)
        (x, lw, hs, dhs), tt_ops = fit_ops
        kernels, bwd_ops = phase_timing(torch, device, enc, idx, launches, errs, simt_lstm,
                                        (lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs),
                                         lambda: _tt.tt_contract_bwd(*tt_ops)))
        for row in kernels:  # the forward kernels' launches on the fit path too
            row["launches_fit"] = fit_launches[row["name"]]
        kernels.append(decode_simt_timing(torch, device, simt_launches, errs))
        kernels.append(simt_lstm[0])
        kernels.append(flash_timing_row(torch, device, serve_launches, errs))
        kernels.extend(bwd_timing(torch, device, fit_launches, errs, step_s, fit_ops, bwd_ops))
        stream_step_timing(torch, device, stream_step_s)
        for row in kernels:  # and on the stream path (phase stream)
            if row["name"] in stream_launches:
                row["launches_stream"] = stream_launches[row["name"]]
        for row in kernels:  # and on the service path: its first pass, the store's fits
            if row["name"] in service_launches:
                row["launches_service"] = (service_launches[row["name"]]
                                           + store_launches[row["name"]])
        for row in kernels:  # and in phase fleet, this process's launches (the simt
            # bodies never run there: hidden 16 and 24 are register buckets)
            row["launches_fleet"] = fleet_launches.get(row["name"], 0)
        torch.cuda.synchronize()
        emit({"kernels": kernels})
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
