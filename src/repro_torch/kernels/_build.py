"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per compile unit, all started together, and
linked into one shared library with a plain C interface that is loaded
with ``ctypes``.  A unit is a source, except ``decode_tile.cu`` and
``lstm.cu``, which are built once per bucket ((hidden, rank) and hidden)
and dtype (``units``) so that their unrolled instantiations compile in
parallel.  The library lands in ``build/repro_torch_kernels/`` at the root
of the checkout, under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when the module is imported: ``library()`` builds on
first use and raises when the build is impossible (no ``nvcc``) or fails.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_tile.cu", "decode_tile_dispatch.cu", "decode_tile_simt.cu", "lstm.cu",
           "lstm_dispatch.cu", "lstm_bwd.cu", "tt_contract.cu", "tt_contract_bwd.cu",
           "flash_attention.cu")
HEADERS = ("common.cuh", "decode_tile.cuh", "hopper.cuh", "lstm.cuh", "lstm_cell.cuh",
           "simt_tile.cuh")
PER_BUCKET = ("decode_tile.cu", "lstm.cu")  # compiled once per bucket and dtype
DTYPES = ("float", "__nv_bfloat16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl, out, B, T, M, H, R, dtype, stream
    "repro_decode_tile": [_P] * 12 + [_L, _I, _I, _I, _I, _I, _P],
    # idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl, out, B, T, M, H, R, tile, dtype, stream
    "repro_decode_tile_simt": [_P] * 12 + [_L, _I, _I, _I, _I, _I, _I, _P],
    # x, wi, wh, b, out, B, T, H, tile, dtype, stream
    "repro_lstm_scan": [_P] * 5 + [_L, _I, _I, _I, _I, _P],
    # x, wi, wh, b, out, B, T, H, bucket, vec, dtype, stream
    "repro_lstm_scan_register": [_P] * 5 + [_L, _I, _I, _I, _I, _I, _P],
    # x, wi, wh, b, hs, dhs, wh^T, dG, c scratch, B, T, H, tile, stream (f32)
    "repro_lstm_scan_bwd": [_P] * 9 + [_L, _I, _I, _I, _P],
    # first, mid, last, out, B, K, R, lanes per entry, dtype, stream
    "repro_tt_contract": [_P] * 4 + [_L, _I, _I, _I, _I, _P],
    # first, mid, last, dout, dfirst, dmid, dlast, B, K, R, lanes per entry, stream (f32)
    "repro_tt_contract_bwd": [_P] * 7 + [_L, _I, _I, _I, _P],
    # q, k, v, out, B, Sq, Skv, Hq, Hkv, D, q_offset, kv_valid, causal, scale, dtype, stream
    "repro_flash_attention": [_P] * 4 + [_I] * 9 + [ctypes.c_float, _I, _P],
    # the same arguments as repro_flash_attention
    "repro_flash_attention_wgmma": [_P] * 4 + [_I] * 9 + [ctypes.c_float, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if home.exists():
        return str(home)
    raise RuntimeError(
        "cannot build the repro_torch CUDA kernels: nvcc not found on PATH "
        "or under CUDA_HOME"
    )


def decode_buckets() -> tuple[tuple[int, int], ...]:
    """The (hidden, rank) buckets of ``REPRO_DECODE_BUCKETS`` in
    ``csrc/decode_tile.cuh``."""
    text = (CSRC / "decode_tile.cuh").read_text()
    line = re.search(r"#define REPRO_DECODE_BUCKETS\(X\)(.*)", text).group(1)
    return tuple((int(h), int(r)) for h, r in re.findall(r"X\((\d+), (\d+)\)", line))


def lstm_buckets() -> tuple[int, ...]:
    """The hidden widths of ``REPRO_LSTM_BUCKETS`` in ``csrc/lstm.cuh``."""
    text = (CSRC / "lstm.cuh").read_text()
    line = re.search(r"#define REPRO_LSTM_BUCKETS\(X\)(.*)", text).group(1)
    return tuple(int(h) for h in re.findall(r"X\((\d+)\)", line))


def units() -> list[tuple[str, str, tuple[str, ...]]]:
    """(name, source, extra nvcc flags) of each compile unit."""
    out = [(name, name, ()) for name in SOURCES if name not in PER_BUCKET]
    for hid, rank in decode_buckets():
        for dtype in DTYPES:
            out.append((f"decode_tile.cu:{dtype.strip('_')}:{hid}x{rank}", "decode_tile.cu",
                        (f"-DREPRO_DECODE_T={dtype}", f"-DREPRO_DECODE_H={hid}",
                         f"-DREPRO_DECODE_R={rank}")))
    for hid in lstm_buckets():
        for dtype in DTYPES:
            out.append((f"lstm.cu:{dtype.strip('_')}:{hid}", "lstm.cu",
                        (f"-DREPRO_LSTM_T={dtype}", f"-DREPRO_LSTM_H={hid}")))
    return out


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def _timed_run(cmd: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return res, time.perf_counter() - t0


def build() -> tuple[Path, float, str]:
    """Compile the sources if needed -> (library path, seconds, ptxas log).

    The log holds, per compile unit, its ``nvcc`` seconds (on the ``==`` line)
    and ``-Xptxas -v``'s registers, shared memory and spills per kernel; it
    is also written beside the library as ``<lib>.log``.
    """
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        todo = units()
        objs = [Path(tmp) / f"{i:02d}_{Path(src).stem}.o" for i, (_, src, _) in enumerate(todo)]
        cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / src), "-o", str(obj)]
                for (_, src, flags), obj in zip(todo, objs)]
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            results = list(pool.map(_timed_run, cmds))
        logs = []
        for (name, _, _), (res, seconds) in zip(todo, results):
            logs.append(f"== {name} ({seconds:.2f} s)\n{res.stdout}")
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}")
        tmp_lib = Path(tmp) / lib.name
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; raises if it cannot be."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
