"""The port stands alone: it never imports JAX or the JAX package, and it
never carries on quietly on the CPU or in a plain version when the card or
the kernel library is missing.  Every module of the reference has its
counterpart, with each of its public names."""
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
REFERENCE = os.path.join(SRC, "repro")
# the reference's public names that the port leaves out, by module: the
# Pallas kernels' tile constants, the ICI bandwidth of a TPU, JAX names
# imported into a module, and two module handles, ``models.model``'s
# ``shard`` function and ``models.nttd_embed``'s ``nttd`` module (the port
# imports the modules it uses under other names)
JAX_IMPORTS = {"Mesh", "P", "NamedSharding", "shard_map", "pl", "pltpu"}
NAMES_LEFT_OUT = {
    "kernels/attention.py": {"DEFAULT_TILE_Q", "DEFAULT_TILE_KV", "NEG_INF"},
    "kernels/decode_tile.py": {"DEFAULT_TILE_B"},
    "kernels/lstm.py": {"DEFAULT_TILE_B"},
    "kernels/tt_contract.py": {"DEFAULT_TILE_B"},
    "launch/mesh.py": {"ICI_BW"},
    "models/model.py": {"shard"},
    "models/nttd_embed.py": {"nttd"},
}


def _port_files():
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield from _port_examples()


def _port_examples():
    examples = os.path.join(ROOT, "examples")
    return [os.path.join(examples, n) for n in sorted(os.listdir(examples))
            if n.startswith("torch_") and n.endswith(".py")]


def _public_names(path: str) -> set[str]:
    """The public names a module binds at its top level: its functions,
    classes and assignments, and the names of its ``from ... import``
    statements (``import x`` binds a module handle, not an API name)."""
    with open(path) as f:
        body = ast.parse(f.read(), path).body
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:  # a name or a tuple of names; not x[k] = or x.a =
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _reference_modules() -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, n), REFERENCE)
                  for d, _, names in os.walk(REFERENCE) for n in names if n.endswith(".py"))


@pytest.mark.parametrize("module", _reference_modules())
def test_module_has_every_public_name_of_the_reference(module):
    """Parsed with ``ast`` on both sides: each public top-level name of the
    reference's module is bound in the port's, but NAMES_LEFT_OUT and the
    JAX imports."""
    port = os.path.join(PORT, module)
    assert os.path.exists(port), f"no counterpart of {module}"
    missing = _public_names(os.path.join(REFERENCE, module)) - _public_names(port)
    assert missing <= NAMES_LEFT_OUT.get(module, set()) | JAX_IMPORTS, sorted(missing)


def test_names_left_out_are_all_missing():
    """Each name NAMES_LEFT_OUT allows is still in the reference and still
    not in the port: the list holds no stale entry."""
    for module, names in NAMES_LEFT_OUT.items():
        assert names <= _public_names(os.path.join(REFERENCE, module)), module
        assert not names & _public_names(os.path.join(PORT, module)), module


def test_package_names_resolve():
    from repro_torch import core, dist
    from repro_torch.codecs.indexing import flat_to_multi
    from repro_torch.core import codec, nttd

    assert (core.CodecConfig, core.CompressionLog, core.compress) == (
        codec.CodecConfig, codec.CompressionLog, codec.compress)
    assert nttd.flat_to_multi is flat_to_multi
    assert dist.sharding.Shards is not None


def test_port_examples_are_scanned():
    assert [os.path.basename(p) for p in _port_examples()] == [
        "torch_compressed_checkpoint.py", "torch_quickstart.py", "torch_serve_llm.py",
        "torch_train_lm.py"]


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
        "        'repro_torch.obs.serve_metrics', 'repro_torch.optim.schedules',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.dist.grad_compress',\n"
        "        'repro_torch.train.step', 'repro_torch.train.checkpoint',\n"
        "        'repro_torch.launch.train', 'repro_torch.compress.checkpoint_codec',\n"
        "        'repro_torch.models.nttd_embed', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.dryrun_codec',\n"
        "        'repro_torch.dist.pipeline_parallel'} <= set(mods), mods\n"
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
    # training, compressed checkpoints and the compressed embedding
    from repro_torch.compress import checkpoint_codec
    from repro_torch.launch import train
    from repro_torch.models.nttd_embed import NTTDEmbedding

    leaf = {"w": torch.zeros((64, 32))}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint_codec.compress_tree(leaf, checkpoint_codec.CodecCheckpointConfig(
            min_elements=16, epochs=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint_codec.VersionedCheckpointer(
            str(tmp_path / "v"), checkpoint_codec.VersionedCheckpointConfig(min_elements=16)
        ).save_step(leaf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NTTDEmbedding.fit(np.zeros((8, 4), np.float32), epochs=1)


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
