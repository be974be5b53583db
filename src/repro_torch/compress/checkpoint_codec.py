"""Compressed checkpoints over the codec registry, as in
``repro.compress.checkpoint_codec``.

Large weight tensors are lossily compressed before they reach disk or the
network: embedding tables and any matrix of at least ``min_elements``
entries.  Any codec of ``repro_torch.codecs`` can back the compression
(``CodecCheckpointConfig.codec``); the default is the paper's NTTD.  Each
compressed leaf is fitness-gated: if the fit cannot reach ``min_fitness``
within its budget, the leaf is stored raw instead.  Payloads are the
container format, so a compressed checkpoint written by either package
restores in the other.

On the card an NTTD leaf is fitted through the hand-written training
kernels (``lstm_scan`` and ``tt_contract``, forward and backward) and its
gate and every restore decode through the fused decode kernel.  Where the
fits run is ``device`` (CUDA unless given); a restored leaf goes to the
device of the template's leaf.

Exact-restore training checkpoints should keep using
``train.checkpoint.Checkpointer``; the codec path is for weight
distribution (serving fleets, cross-DC sync, archival).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import codecs
from repro_torch.train.checkpoint import (
    _flatten,
    _unflatten_into,
    dtype_name,
    from_host,
    leaf_device,
    to_host,
)


@dataclasses.dataclass
class CodecCheckpointConfig:
    codec: str = "nttd"              # any name in repro_torch.codecs.available()
    min_elements: int = 1 << 16      # only compress leaves at least this big
    min_fitness: float = 0.95        # fitness gate; below -> store raw
    # NTTD fit knobs (ignored by budget-driven codecs)
    rank: int = 8
    hidden: int = 16
    epochs: int = 15
    batch_size: int = 65536
    lr: float = 1e-2
    reorder: bool = False            # reordering off for speed by default
    seed: int = 0
    # budget for non-NTTD codecs: target payload as a fraction of raw bytes
    budget_ratio: float = 0.125
    fit_opts: dict[str, Any] | None = None  # explicit overrides, passed to fit


def _fit_leaf(arr32: np.ndarray, cfg: CodecCheckpointConfig, device=None) -> codecs.Encoded:
    codec = codecs.get_codec(cfg.codec)
    on = {"device": device} if cfg.codec == "nttd" else {}
    if cfg.fit_opts is not None:
        return codec.fit(arr32, **cfg.fit_opts, **on)
    if cfg.codec == "nttd":
        return codec.fit(
            arr32,
            rank=cfg.rank,
            hidden=cfg.hidden,
            epochs=cfg.epochs,
            batch_size=cfg.batch_size,
            lr=cfg.lr,
            init_reorder=cfg.reorder,
            update_reorder=cfg.reorder,
            seed=cfg.seed,
            entries_per_epoch=min(arr32.size, 2_000_000),
            **on,
        )
    budget = max(int(arr32.nbytes * cfg.budget_ratio), 1024)
    return codec.fit(arr32, budget)


def _as_f32(leaf, arr: np.ndarray) -> np.ndarray:
    """A leaf's values as an f32 host array (bf16 widened exactly); ``arr``
    is its ``to_host``."""
    if dtype_name(leaf) == "bfloat16":
        return leaf.detach().float().cpu().numpy()
    return arr if arr.dtype == np.float32 else arr.astype(np.float32)


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def compress_tree(tree, cfg: CodecCheckpointConfig | None = None, device=None):
    """Returns ({key: payload}, stats); keys follow ``checkpoint._flatten``.
    A payload is ``{"kind": "raw", "data": npy bytes}`` or ``{"kind":
    codec, "data": container bytes, "fitness", "dtype", "shape"}``.  Besides
    the reference's stats, ``stats["leaves"]`` lists each leaf's key,
    elements, kind, fitness (None where no fit ran) and seconds."""
    cfg = cfg or CodecCheckpointConfig()
    out: dict[str, dict[str, Any]] = {}
    stats = {"raw_bytes": 0, "compressed_bytes": 0, "leaves_codec": 0, "leaves_raw": 0}
    per_leaf = []
    for key, leaf in _flatten(tree):
        t0 = time.perf_counter()
        arr = to_host(leaf)
        stats["raw_bytes"] += arr.nbytes
        fit = None
        if arr.size >= cfg.min_elements and arr.ndim >= 2:
            arr32 = _as_f32(leaf, arr)
            try:
                enc = _fit_leaf(arr32, cfg, device)
            except ValueError:
                enc = None  # budget infeasible for this codec -> store raw
            fit = enc.fitness(arr32) if enc is not None else -np.inf
            if fit >= cfg.min_fitness:
                blob = codecs.save_bytes(enc)
                out[key] = {
                    "kind": cfg.codec,
                    "data": blob,
                    "fitness": fit,
                    "dtype": dtype_name(leaf),
                    "shape": list(arr.shape),
                }
                stats["compressed_bytes"] += len(blob)
                stats["leaves_codec"] += 1
        if key not in out:
            out[key] = {"kind": "raw", "data": _npy(arr)}
            stats["compressed_bytes"] += len(out[key]["data"])
            stats["leaves_raw"] += 1
        per_leaf.append({"key": key, "elements": int(arr.size), "kind": out[key]["kind"],
                         "fitness": fit, "seconds": time.perf_counter() - t0})
    stats["ratio"] = stats["raw_bytes"] / max(stats["compressed_bytes"], 1)
    stats["leaves"] = per_leaf
    return out, stats


def decompress_tree(payload: dict, template, device=None):
    """Inverse of ``compress_tree`` (lossy for codec leaves): each leaf on
    the device of the template's leaf.  The container's codec-id header
    drives decoding, so ``kind`` is informational only; codec leaves decode
    on ``device`` (CUDA unless given)."""
    devices = {k: leaf_device(v) for k, v in _flatten(template)}
    values = {}
    for key, item in payload.items():
        if item["kind"] == "raw":
            arr = np.load(io.BytesIO(item["data"]))
            dtype = "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)
            values[key] = from_host(arr, dtype, devices[key])
        else:
            dense = codecs.load_bytes(item["data"], device=device).to_dense()
            values[key] = _from_f32(dense, item["dtype"], devices[key])
    return _unflatten_into(template, values)


def _from_f32(dense: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A decoded leaf in its checkpoint dtype on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(dense, dtype=np.float32))
    return t.to(getattr(torch, dtype)).to(device)


@dataclasses.dataclass
class VersionedCheckpointConfig:
    """Knobs for :class:`VersionedCheckpointer` (delta-coded v4 stores)."""

    codec: str = "nttd"              # any name in repro_torch.codecs.available()
    min_elements: int = 1 << 16      # only delta-code leaves at least this big
    min_fitness: float = 0.95        # chain gate; below -> fresh keyframe
    keyframe_interval: int = 8       # bound on decode-chain depth
    chunk_bytes: int = 1 << 20
    delta_passes: int = 2
    keyframe_opts: dict[str, Any] | None = None  # passed to Codec.fit
    delta_opts: dict[str, Any] | None = None     # passed to the stream fitter


class VersionedCheckpointer:
    """Checkpoint steps as versions of per-leaf delta stores, as in the
    reference.

    Step ``N+1`` of every large weight tensor is fitted as a residual
    against the reconstruction of step ``N`` (``repro_torch.temporal``).
    Leaves below ``min_elements`` (or below the fitness gate on their very
    first step) are demoted to raw ``.npz`` per step, permanently.

    Layout under ``directory`` (the reference's, file for file)::

        manifest.json          key -> {kind, file, dtype, shape}; n_steps
        leaf<i>.tcdc           one v4 delta container per codec leaf
        raw_step<k>.npz        all raw leaves of step k

    Every ``save_step`` ends with the stores synced and the manifest
    rewritten.  A reopened checkpointer is restore-only.  The NTTD fits run
    on ``device`` (CUDA unless given).
    """

    def __init__(self, directory: str, cfg: VersionedCheckpointConfig | None = None,
                 device=None):
        from repro_torch.temporal import VersionedStore

        self.directory = directory
        self.cfg = cfg or VersionedCheckpointConfig()
        self.device = device
        self._store_cls = VersionedStore
        os.makedirs(directory, exist_ok=True)
        self._stores: dict[str, Any] = {}   # key -> VersionedStore
        self._leaves: dict[str, dict] = {}  # key -> manifest entry
        self._n_steps = 0
        manifest = os.path.join(directory, "manifest.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                m = json.load(f)
            self._n_steps = m["n_steps"]
            self._leaves = m["leaves"]

    @property
    def n_steps(self) -> int:
        return self._n_steps

    def _open_store(self, key: str, fname: str):
        cfg = self.cfg
        self._stores[key] = self._store_cls(
            os.path.join(self.directory, fname),
            cfg.codec,
            keyframe_interval=cfg.keyframe_interval,
            chunk_bytes=cfg.chunk_bytes,
            keyframe_opts=cfg.keyframe_opts,
            delta_opts=cfg.delta_opts,
            delta_passes=cfg.delta_passes,
            rekey_below=cfg.min_fitness,
            device=self.device,
        )

    def save_step(self, tree) -> dict:
        """Append one checkpoint step; returns per-step stats."""
        cfg = self.cfg
        step = self._n_steps
        stats = {"step": step, "bytes": 0, "leaves_store": 0, "leaves_raw": 0,
                 "keyframes": 0, "fitness_min": 1.0}
        raw: dict[str, np.ndarray] = {}
        for i, (key, leaf) in enumerate(_flatten(tree)):
            arr = to_host(leaf)
            entry = self._leaves.get(key)
            if entry is None:
                if step != 0:
                    raise ValueError(f"leaf {key!r} appeared after step 0")
                eligible = arr.size >= cfg.min_elements and arr.ndim >= 2
                entry = {
                    "kind": "store" if eligible else "raw",
                    "file": f"leaf{i}.tcdc" if eligible else None,
                    "dtype": dtype_name(leaf),
                    "shape": list(arr.shape),
                }
                self._leaves[key] = entry
            if entry["kind"] == "store":
                if key not in self._stores:
                    if step > 0:
                        raise ValueError(
                            "reopened VersionedCheckpointer is restore-only; "
                            "start a new directory to keep appending"
                        )
                    self._open_store(key, entry["file"])
                st = self._stores[key].append(_as_f32(leaf, arr))
                if step == 0 and st["fitness"] < cfg.min_fitness:
                    # below the gate on its FIRST step: the codec cannot
                    # represent this leaf — demote it to raw permanently
                    self._stores.pop(key).close()
                    os.remove(os.path.join(self.directory, entry["file"]))
                    entry.update(kind="raw", file=None)
                else:
                    stats["bytes"] += st["bytes"]
                    stats["leaves_store"] += 1
                    stats["keyframes"] += int(st["keyframe"])
                    stats["fitness_min"] = min(stats["fitness_min"], st["fitness"])
            if entry["kind"] == "raw":
                raw[key.replace("/", "__")] = arr
        if raw:
            path = os.path.join(self.directory, f"raw_step{step}.npz")
            np.savez(path, **raw)
            stats["bytes"] += os.path.getsize(path)
            stats["leaves_raw"] = len(raw)
        self._n_steps = step + 1
        self._write_manifest()
        return stats

    def _write_manifest(self) -> None:
        tmp = os.path.join(self.directory, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"n_steps": self._n_steps, "leaves": self._leaves}, f, indent=1)
        os.replace(tmp, os.path.join(self.directory, "manifest.json"))

    def restore_step(self, step: int, template):
        """Rebuild the tree at ``step`` (lossy for store-backed leaves), each
        leaf on the device of the template's leaf."""
        from repro_torch.temporal import VersionedStore

        if not 0 <= step < self._n_steps:
            raise ValueError(f"step {step} out of range [0, {self._n_steps})")
        devices = {k: leaf_device(v) for k, v in _flatten(template)}
        values = {}
        raw_path = os.path.join(self.directory, f"raw_step{step}.npz")
        raw = np.load(raw_path) if os.path.exists(raw_path) else {}
        for key, entry in self._leaves.items():
            if entry["kind"] == "raw":
                values[key] = from_host(np.asarray(raw[key.replace("/", "__")]),
                                        entry["dtype"], devices[key])
            else:
                with VersionedStore.open(os.path.join(self.directory, entry["file"]),
                                         device=self.device) as reader:
                    values[key] = _from_f32(reader.decode(version=step), entry["dtype"],
                                            devices[key])
        return _unflatten_into(template, values)

    def close(self) -> None:
        for store in self._stores.values():
            store.close()
        self._stores.clear()

    def __enter__(self) -> "VersionedCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
