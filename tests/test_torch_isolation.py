"""The port stands alone: it never imports JAX or the JAX package, and it
never carries on quietly on the CPU or in a plain version when the card or
the kernel library is missing."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_files():
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_jax_or_reference_imports_in_source():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not offenders


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert len(mods) >= 20, mods\n"
        "assert {'repro_torch.stream.fit', 'repro_torch.stream.writer',\n"
        "        'repro_torch.temporal.delta', 'repro_torch.serve.codec_service',\n"
        "        'repro_torch.obs', 'repro_torch.temporal.store',\n"
        "        'repro_torch.fleet', 'repro_torch.fleet.controller',\n"
        "        'repro_torch.fleet.frontend',\n"
        "        'repro_torch.fleet.metrics', 'repro_torch.fleet.rebalance',\n"
        "        'repro_torch.fleet.repair', 'repro_torch.fleet.router',\n"
        "        'repro_torch.fleet.transport', 'repro_torch.fleet.worker',\n"
        "        'repro_torch.obs.slo', 'repro_torch.obs.exposition', 'repro_torch.obs.report',\n"
        "        'repro_torch.obs.serve_metrics'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": SRC}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from repro_torch import codecs, convert
    from repro_torch.devices import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(os.path.join(ROOT, "tests", "golden", "v2_nttd.bin"), "rb") as f:
        blob = f.read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.load_bytes(blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.get_codec("nttd").fit(np.zeros((4, 4, 4), np.float32), epochs=1)
    assert codecs.load_bytes(blob, device="cpu").ct.device.type == "cpu"
    # streaming and the v4 delta read
    from repro_torch import stream

    source = stream.SyntheticTensorSource((4, 4, 4), slab_entries=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.NTTDStreamFitter((4, 4, 4), rank=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.get_codec("nttd").stream_fitter((4, 4, 4), budget=4000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.fit_stream("nttd", source, rank=2)
    with open(os.path.join(ROOT, "tests", "golden", "v4_delta.tcdc"), "rb") as f:
        v4 = f.read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.load_bytes(v4)
    assert stream.fit_stream("nttd", source, rank=2, device="cpu").ct.device.type == "cpu"
    # the fleet: its frontend, and a worker started without --device
    from repro_torch import fleet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.FleetFrontend()
    assert fleet.FleetFrontend(1, device="cpu").device.type == "cpu"
    env = {**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""}
    sock = os.path.join(str(tmp_path), "w.sock")
    res = subprocess.run([sys.executable, "-m", "repro_torch.fleet.worker", "--listen",
                          f"unix:{sock}"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "READY" not in res.stdout and not os.path.exists(sock)


def test_wrappers_raise_when_the_library_cannot_be_built(monkeypatch):
    """A non-CPU request goes to the kernel or raises; it never runs the
    plain version instead."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import tt_contract as _tt

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-cuda"))
    _build.library.cache_clear()
    try:
        meta = dict(device="meta")
        idx = torch.zeros((4, 3), dtype=torch.int32, **meta)
        ws = [torch.zeros(s, **meta) for s in
              [(3, 5, 8), (8, 32), (8, 32), (32,), (8, 4), (4,), (8, 16), (16,), (8, 4), (4,)]]
        calls = [
            lambda: ops.nttd_decode_tile(idx, *ws, impl="auto"),
            lambda: ops.lstm_scan(torch.zeros((4, 3, 8), **meta), *ws[1:4], impl="cuda"),
            lambda: ops.tt_contract(torch.zeros((4, 4), **meta),
                                    torch.zeros((4, 2, 4, 4), **meta),
                                    torch.zeros((4, 4), **meta), impl="cuda"),
            lambda: ops.attention(*(torch.zeros((1, 130, 2, 8), **meta) for _ in range(3)),
                                  impl="auto"),
            lambda: _lstm.lstm_scan_bwd(*(torch.zeros(s, **meta) for s in
                                          [(4, 3, 8), (8, 32), (8, 32), (32,), (4, 3, 8),
                                           (4, 3, 8)])),
            lambda: _tt.tt_contract_bwd(torch.zeros((4, 4), **meta),
                                        torch.zeros((4, 2, 4, 4), **meta),
                                        torch.zeros((4, 4), **meta), torch.zeros((4,), **meta)),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="cannot build"):
                call()
        assert ops.launch_counts() == {"decode_tile": 0, "lstm_scan": 0, "tt_contract": 0,
                                       "flash_attention": 0, "lstm_scan_bwd": 0,
                                       "tt_contract_bwd": 0}
    finally:
        _build.library.cache_clear()


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the checkout (and here without CUDA) the smoke
    script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
