#!/usr/bin/env python3
"""The port's dry-run cost pass over every (arch x shape x mesh) cell, in
parallel processes, with each cell's peak broken down by where its live
storages were made.

    python3 scripts/torch_dryrun_sweep.py [--procs 8] [--rules auto] \
        [--mesh both] [--arch A[,B...]] [--shape S] [--out FILE.jsonl]

Each cell runs ``launch.dryrun.run_cell`` (fake process groups of 256 or
512 ranks, ``FakeTensor`` shards: no device and little memory) in one of
``--procs`` worker processes, and prints one JSON line: ``run_cell``'s
result plus ``peak_terms``, the live bytes at the cell's peak grouped by
the source line of the port (``repro_torch``, the dry-run itself left
out) whose operation made each storage, largest first (``arguments`` for
the step's arguments), and ``collective_bytes_by_dtype``, the collective
bytes a device by kind and dtype ("all-gather:bfloat16").  The snapshot
is taken whenever the live bytes pass the last snapshot's by more than
1 %, so its total is within 1 % of the peak.  ``--out`` also writes the
lines to a file.  Cells that raise print ``status: error`` and the run
exits 1.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback
from collections import Counter

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)  # spawned workers re-run this
TERMS = 6                 # groups kept at the peak
SNAPSHOT_GROWTH = 1.01    # a new snapshot once the live bytes pass the last by 1 %


def counter_class():
    """A ``CostCounter`` that notes where each storage it tracks was made
    and groups the live ones at its peak."""
    from repro_torch.launch import dryrun

    port = os.path.dirname(os.path.dirname(dryrun.__file__))

    def site() -> str:
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename
            if name.startswith(port) and name != dryrun.__file__:
                return f"{os.path.relpath(name, port)}:{f.f_lineno} ({f.f_code.co_name})"
            if name == dryrun.__file__ and f.f_code.co_name == "measure":
                return "arguments"
            f = f.f_back
        return "other"

    class PeakTerms(dryrun.CostCounter):
        last = None

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.where: dict[int, tuple[str, int, str]] = {}
            self.terms: list = []
            self._snap = 0
            PeakTerms.last = self

        def track(self, tree) -> None:
            here = None
            for t in dryrun._tensors(tree):
                st = t.untyped_storage()
                if id(st) not in self._storages:
                    here = here or site()
                    self.where[id(st)] = (here, st.nbytes(),
                                          f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}")
            super().track(tree)
            if self.live == self.peak and self.live > self._snap * SNAPSHOT_GROWTH:
                self._snap = self.live
                groups, shapes = Counter(), {}
                for key in self._storages:
                    where, n, shape = self.where[key]
                    groups[where] += n
                    shapes.setdefault(where, Counter())[shape] += n
                self.terms = [{"where": w, "bytes": n,
                               "largest": shapes[w].most_common(1)[0][0]}
                              for w, n in groups.most_common(TERMS)]

    return PeakTerms


def _cell(job) -> dict:
    arch, shape, mesh, rules = job
    from repro_torch.launch import dryrun

    dryrun.CostCounter = counter_class()  # a process runs one cell
    t0 = time.perf_counter()
    try:
        res = dryrun.run_cell(arch, shape, mesh, rules, verbose=False)
        if res["status"] == "ok":
            last = dryrun.CostCounter.last
            res["peak_terms"] = last.terms
            res["collective_bytes_by_dtype"] = {
                k: v for k, v in dryrun.collective_bytes_per_device(
                    last.collectives, by_dtype=True).items() if ":" in k}
    except Exception as e:  # noqa: BLE001 - record the cell and go on with the sweep
        traceback.print_exc()
        res = {"arch": arch, "shape": shape, "mesh": mesh, "rules": rules, "status": "error",
               "error": f"{type(e).__name__}: {e}"}
    res["seconds"] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--rules", default="auto", choices=["auto", "base", "fsdp"])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun

    jobs = [(a, s, m, args.rules) for arch in (args.arch.split(",") if args.arch else [None])
            for a, s, m in dryrun.cells(args.mesh, arch, args.shape)]
    # the longest cells (train, prefill) first, so no worker ends on one alone
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    jobs.sort(key=lambda j: order.get(j[1], 4))
    out = open(args.out, "w") if args.out else None
    failures = 0
    t0 = time.perf_counter()
    # a process a cell: a cell that raises can leave its fake group unusable
    with multiprocessing.get_context("spawn").Pool(args.procs, maxtasksperchild=1) as pool:
        for res in pool.imap_unordered(_cell, jobs):
            failures += res["status"] == "error"
            line = json.dumps(res)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    print(json.dumps({"cells": len(jobs), "errors": failures, "procs": args.procs,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
