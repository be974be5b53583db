"""Synthetic replicas of the paper's 8 real-world tensors (Table II), a
NumPy copy of ``repro.data.synthetic_tensors`` (which imports no JAX
either; the port keeps its own copy so that it imports nothing of the JAX
package).  One change: ``load`` seeds each dataset with a stable offset
(``zlib.crc32`` of its name), where the reference adds ``hash(name)``,
which Python salts per process, so its tensors differ from run to run.

The container is offline, so the actual datasets (Uber, Air Quality, ...)
are unavailable.  Each generator below produces a tensor with the same
order and comparable density/smoothness profile; a ``mini`` variant scales
mode lengths down (~1/4 per mode) so CPU-budget experiments finish in
minutes.  ``stats`` computes the paper's density and smoothness metrics so
EXPERIMENTS.md can report how close the replicas are.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    shape: tuple[int, ...]        # paper's Table II shape
    mini_shape: tuple[int, ...]   # CPU-budget shape
    generator: Callable[[tuple[int, ...], np.random.Generator], np.ndarray]
    target_density: float
    target_smoothness: float


def _grid(shape, rng):
    axes = [np.linspace(0, 1, n) for n in shape]
    return np.meshgrid(*axes, indexing="ij")


def _match_density(x: np.ndarray, target: float) -> np.ndarray:
    """Zero the smallest-|value| entries so nnz/size == target."""
    if target >= 1.0:
        return x
    k = int(x.size * (1 - target))
    if k <= 0:
        return x
    thresh = np.partition(np.abs(x).reshape(-1), k)[k]
    out = x.copy()
    out[np.abs(out) < thresh] = 0.0
    return out


def _uber_like(shape, rng):
    """Sparse-ish counts with daily/hourly periodic structure (density .138)."""
    g = _grid(shape, rng)
    base = (
        np.sin(2 * np.pi * 3 * g[0])
        * np.exp(np.sin(2 * np.pi * g[1]) * 2)
        * (0.3 + np.cos(2 * np.pi * 2 * g[2]) ** 2)
    )
    intensity = np.exp(base * 1.5) * 0.08
    x = rng.poisson(intensity).astype(np.float64)
    return x


def _airquality_like(shape, rng):
    """Dense slow-varying sensor series + station offsets (density .917)."""
    g = _grid(shape, rng)
    x = (
        10
        + 6 * np.sin(2 * np.pi * 4 * g[0])
        + 4 * np.cos(2 * np.pi * 2 * g[1] + 1.0)
        + 2 * g[2]
        + rng.normal(size=shape) * 1.2
    )
    drop = rng.random(shape) > 0.92
    x[drop] = 0.0
    return x


def _action_like(shape, rng):
    """Motion-feature style: piecewise-smooth rows, moderate density."""
    x = rng.normal(size=shape) * 0.2
    t = np.linspace(0, 1, shape[-1])
    for _ in range(max(shape[0] * 2, 8)):
        i = rng.integers(0, shape[0])
        j = rng.integers(0, shape[1])
        f = rng.integers(1, 6)
        x[i, j:] += np.sin(2 * np.pi * f * t) * rng.normal() * 2
    return _match_density(x, 0.393)


def _pems_like(shape, rng):
    """Dense traffic occupancy: strong daily pattern per (station, lane)."""
    g = _grid(shape, rng)
    station = rng.normal(size=(shape[0], 1, 1))
    x = (
        0.1
        + 0.08 * np.exp(np.sin(2 * np.pi * g[1] - 1.2) * 1.5)
        + 0.03 * station
        + rng.normal(size=shape) * 0.01
    )
    return np.clip(x, 0, None)


def _activity_like(shape, rng):
    x = rng.normal(size=shape) * 0.2
    t = np.linspace(0, 1, shape[-1])
    for _ in range(max(shape[0] * 2, 8)):
        i = rng.integers(0, shape[0])
        j = rng.integers(0, shape[1])
        x[i, j:] += np.sin(2 * np.pi * rng.integers(1, 6) * t) * rng.normal() * 2
    return _match_density(x * 1.4 + 0.05, 0.569)


def _stock_like(shape, rng):
    """Random-walk price series per (ticker, feature): very smooth (.976).
    Neighboring tickers/features correlate (sector structure), so the 3^d
    window std stays far below the global std."""
    steps = rng.normal(size=shape) * 0.004
    common = rng.normal(size=(1, 1, shape[2])) * 0.01
    x = np.cumsum(steps + common, axis=-1) + 1.0
    # sorted per-ticker scales -> adjacent tickers have similar magnitude
    scale = np.sort(np.exp(rng.normal(size=shape[0]) * 0.8))[:, None, None]
    feat = np.sort(np.exp(rng.normal(size=shape[1]) * 0.3))[None, :, None]
    return _match_density(x * scale * feat, 0.816)


def _nyc_like(shape, rng):
    """4-order origin x dest x time x day taxi counts, sparse (.118)."""
    g = _grid(shape, rng)
    hub = np.exp(-((g[0] - 0.4) ** 2 + (g[1] - 0.4) ** 2) * 8)
    daily = np.exp(np.sin(2 * np.pi * g[2]) * 1.5)
    x = rng.poisson(hub * daily * 0.35).astype(np.float64)
    return x


def _absorb_like(shape, rng):
    """Climate-simulation style: fully dense, very smooth (.935)."""
    g = _grid(shape, rng)
    x = (
        np.sin(2 * np.pi * g[0])
        + np.cos(2 * np.pi * g[1] * 2)
        + 0.5 * g[2] ** 2
        + 0.3 * np.sin(2 * np.pi * g[3] * 3)
    )
    return x + rng.normal(size=shape) * 0.02


DATASETS: dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        DatasetSpec("uber", (183, 24, 1140), (48, 24, 72), _uber_like, 0.138, 0.861),
        DatasetSpec("air_quality", (5600, 362, 6), (256, 92, 6), _airquality_like, 0.917, 0.513),
        DatasetSpec("action", (100, 570, 567), (50, 72, 72), _action_like, 0.393, 0.484),
        DatasetSpec("pems_sf", (963, 144, 440), (96, 48, 56), _pems_like, 0.999, 0.461),
        DatasetSpec("activity", (337, 570, 320), (64, 72, 48), _activity_like, 0.569, 0.553),
        DatasetSpec("stock", (1317, 88, 916), (128, 24, 96), _stock_like, 0.816, 0.976),
        DatasetSpec("nyc", (265, 265, 28, 35), (48, 48, 24, 12), _nyc_like, 0.118, 0.788),
        DatasetSpec("absorb", (192, 288, 30, 120), (48, 36, 12, 30), _absorb_like, 1.000, 0.935),
    ]
}


def load(name: str, mini: bool = True, seed: int = 0) -> np.ndarray:
    spec = DATASETS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**31)
    shape = spec.mini_shape if mini else spec.shape
    return spec.generator(shape, rng).astype(np.float32)


def density(x: np.ndarray) -> float:
    return float(np.count_nonzero(x)) / x.size


def smoothness(x: np.ndarray, sample: int = 2000, seed: int = 0) -> float:
    """Paper's metric: 1 - E_i[sigma_3(i)] / sigma, where sigma_3(i) is the
    std of the 3^d window centered at i (sampled for speed)."""
    rng = np.random.default_rng(seed)
    d = x.ndim
    sigma = float(x.std())
    if sigma == 0:
        return 1.0
    centers = np.stack(
        [rng.integers(1, max(n - 1, 2), size=sample) for n in x.shape], axis=1
    )
    stds = np.empty(sample)
    for t in range(sample):
        sl = tuple(
            slice(max(c - 1, 0), min(c + 2, n))
            for c, n in zip(centers[t], x.shape)
        )
        stds[t] = x[sl].std()
    return 1.0 - float(stds.mean()) / sigma
