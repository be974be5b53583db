"""Fault-tolerant checkpointing, as in ``repro.train.checkpoint``.

  * atomic: write to ``<dir>/tmp.<step>.<pid>`` then rename to
    ``<dir>/step_<n>``
  * async: the write runs on a background thread; ``wait()`` joins before
    the next save (a queue of one)
  * the layout is the reference's: one ``.npy`` per leaf and a
    ``manifest.json`` of logical metadata (paths, shapes, dtypes), so a
    checkpoint written by either package restores in the other
  * ``restore`` puts each leaf on the device of the template's leaf, or,
    given ``shardings`` (``dist.sharding.NamedSharding`` leaves on a
    ``DeviceMesh``), lays it out on their placements: elastic, a
    checkpoint written on mesh A restores onto mesh B.  Each rank reads
    the leaf whole and keeps its own chunk (``distribute_tensor`` with
    ``src_data_rank=None``): no scatter, no collective.
  * a tree of ``DTensor``s saves whole leaves (``full_tensor``, so every
    rank calls ``save``), the same bytes as a one-device save, written by
    rank 0 alone; the caller waits (``wait()``) and holds the ranks at a
    barrier before another rank reads them.

Leaf keys are the reference's ``_flatten`` strings, which JAX's path keys
give: dict keys in sorted order, a NamedTuple field as ``.<field>`` in
field order, a sequence index as its number, joined by ``/``
(``{"params": p, "opt": AdamState}`` -> ``opt/.step``,
``opt/.mu/blocks/attn/wk``, ... ``params/tok/embed``).  The order also
names the files of ``compress.checkpoint_codec.VersionedCheckpointer``.

numpy has no bf16 of its own: a bf16 leaf is written as the reference's
``ml_dtypes`` array is (two-byte void elements, manifest dtype
"bfloat16") and read back from its bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.dist import sharding

#: numpy's view of a bf16 leaf: what ``np.save`` writes for ml_dtypes' bfloat16
_BF16_NP = np.dtype("V2")


def _items(tree, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), prefix + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _flatten(tree) -> list[tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in _items(tree)]


def _unflatten_into(template, values: dict):
    """``template``'s structure with ``values[key]`` at each leaf."""

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], prefix + (str(k),)) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f), prefix + (f".{f}",))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),)) for i, v in enumerate(node))
        if node is None:
            return None
        return values["/".join(prefix)]

    return build(template, ())


def to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference would save (bf16: its bits
    as two-byte void elements), in memory of its own: a tensor on the CPU
    is copied too, so the caller may update it in place at once.  A
    ``DTensor`` is gathered whole first (a collective)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if sharding.is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(_BF16_NP)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def dtype_name(leaf) -> str:
    """The reference's ``str(arr.dtype)`` of a leaf."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """Inverse of :func:`to_host`: a tensor on ``device`` (on the CPU it
    shares ``arr``'s memory, a freshly loaded array)."""
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        arr = arr.copy(order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def leaf_device(leaf) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        # snapshot to host memory synchronously: the caller may update the
        # tree in place as soon as this returns
        flat = _flatten(tree)
        host = [(k, to_host(v), dtype_name(v)) for k, v in flat]
        if any(sharding.is_dtensor(v) for _, v in flat) and torch.distributed.get_rank() != 0:
            return  # rank 0 writes the gathered leaves
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, extra or {}), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write_async(self, step: int, host: list, extra: dict) -> None:
        try:
            self._write(step, host, extra)
        except BaseException as e:  # noqa: BLE001 — raised again by wait()
            self._error = e

    def _write(self, step: int, host: list, extra: dict) -> None:
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "extra": extra, "leaves": {}}
        for key, arr, dtype in host:
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, template, shardings=None):
        """Load a checkpoint into ``template``'s structure; reshard onto the
        current mesh (elastic).  Returns (tree, manifest).

        A leaf whose key has a ``NamedSharding`` in ``shardings`` (same
        structure, ``None`` leaves allowed) becomes a ``DTensor`` on its
        mesh and placements, whatever mesh wrote the checkpoint; every
        other leaf goes to the device of the template's leaf."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        devices = {k: leaf_device(v) for k, v in _flatten(template)}
        targets = dict(_flatten(shardings)) if shardings is not None else {}
        values = {}
        for key, meta in manifest["leaves"].items():
            if key not in devices:  # the template's leaves only (e.g. params without opt)
                continue
            arr = np.load(os.path.join(d, meta["file"]))
            target = targets.get(key)
            if target is None:
                values[key] = from_host(arr, meta["dtype"], devices[key])
            else:
                values[key] = sharding.distribute(from_host(arr, meta["dtype"], "cpu"), target)
        return _unflatten_into(template, values), manifest


def auto_resume(ckpt: Checkpointer, template, shardings=None):
    """Resume from the latest checkpoint if one exists (crash recovery).
    Returns (tree or None, step)."""
    step = ckpt.latest_step()
    if step is None:
        return None, 0
    tree, manifest = ckpt.restore(step, template, shardings)
    return tree, manifest["step"]
