"""Parameter specs and their materialization: the init half of
``repro.dist.sharding``.

Weights are declared once as ``ParamSpec(shape, logical_axes, init)``
trees.  ``materialize`` turns a spec tree into tensors on one device,
each leaf drawn from its own ``torch.Generator`` seeded from ``(seed,
crc32(path))``, so adding a leaf never reshuffles the others.  The draws
cannot equal JAX's; the shapes, dtypes and standard deviations do.  The
logical axes are kept for the sharding rules of ROADMAP A.8; on one
device ``shard`` is the identity and is left out.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative leaf: shape + logical axis names + init kind.

    init: 'fan_in' (scaled normal), 'embed', 'ones', 'zeros'.
    dtype: overrides the tree-level default (KV caches).
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"
    dtype: Any = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec rank mismatch: shape {self.shape} vs axes {self.axes}"
            )


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """Apply ``fn(path, leaf)`` over a nested dict; ``path`` is JAX's
    ``keystr`` of the leaf (``"['blocks']['attn']['wq']"``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def tree_abstract(specs, dtype: torch.dtype):
    """ParamSpec tree -> tree of meta tensors (shape and dtype, no storage)."""
    return map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"), specs
    )


def _stacked_fan_in(spec: ParamSpec) -> int:
    # fan-in = every non-output dim that is not a stacked-layer or a
    # vmapped expert dim; the last dim is the output by convention.
    # q/k/v projections fuse two output dims (heads, head_dim): a heads
    # dim right before a final head_dim is output, not fan-in — while in
    # wo-style (heads, head_dim, d) weights the heads dim IS fan-in.
    fan = 1
    n = len(spec.axes)
    for i, (dim, ax) in enumerate(zip(spec.shape[:-1], spec.axes[:-1])):
        if ax in ("layers", "experts"):
            continue
        if ax in ("heads", "kv_heads") and i == n - 2 and spec.axes[-1] == "head_dim":
            continue
        fan *= dim
    return fan


def init_std(spec: ParamSpec) -> float | None:
    """Standard deviation of a random leaf; None for 'zeros'/'ones'."""
    if spec.init in ("zeros", "ones"):
        return None
    if spec.init == "embed":
        # unit-variance logits under tied unembedding (x is rmsnormed)
        return spec.shape[-1] ** -0.5
    if spec.init == "fan_in":
        return _stacked_fan_in(spec) ** -0.5
    raise ValueError(f"unknown init kind: {spec.init!r}")


def _init_leaf(gen: torch.Generator | None, spec: ParamSpec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = init_std(spec)
    # drawn in f32 and cast once, as the reference does
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def _leaf_seed(seed: int, path: str) -> int:
    """The generator seed of the leaf at ``path``."""
    return ((seed & 0xFFFFFFFF) << 32) | zlib.crc32(path.encode())


def materialize(seed: int, specs, dtype: torch.dtype, device: torch.device):
    """ParamSpec tree -> real weights on ``device``, each leaf built in its
    final dtype there (no host copy of the tree)."""
    device = torch.device(device)

    def init_at(path: str, spec: ParamSpec):
        gen = None
        if spec.init not in ("zeros", "ones"):
            gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
        return _init_leaf(gen, spec, spec.dtype or dtype, device)

    return map_with_path(init_at, specs)
