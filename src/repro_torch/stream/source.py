"""Slab sources: deterministic, resumable suppliers of tensor entries, as
in ``repro.stream.source`` (host NumPy; the slabs are the same arrays).

A *slab* is a contiguous row-major block of the tensor delivered as
``(indices, values)`` — original multi-indices ``[B, d]`` plus the entry
values ``[B]``.  Sources follow the batch-at-step contract of
``repro.data.pipeline``: ``slab_at(cursor)`` is a pure function of ``(source config,
cursor)``, so a restarted fit resumes mid-stream by just asking for the
right cursor, and two fits over the same cursor range see bit-identical
data.

Three sources:
  * ``DenseSource``      — wraps an in-memory array (tests, parity checks);
  * ``MMapTensorSource`` — flat binary file via ``np.memmap`` (out-of-core
    production path; ``write_tensor_file`` builds one);
  * ``SyntheticTensorSource`` — seeded separable-harmonic generator that
    computes values entrywise from indices, so a 2^24-entry tensor can be
    streamed without EVER materializing it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.codecs.indexing import flat_to_multi


@dataclasses.dataclass(frozen=True)
class Slab:
    cursor: int
    indices: np.ndarray  # [B, d] int64, ORIGINAL multi-indices
    values: np.ndarray   # [B] float32


@runtime_checkable
class SlabSource(Protocol):
    """The protocol ``fit_stream`` consumes.  Implementations must make
    ``slab_at`` deterministic and side-effect free (resumable cursor)."""

    shape: tuple[int, ...]
    slab_entries: int

    @property
    def n_slabs(self) -> int: ...

    def slab_at(self, cursor: int) -> Slab: ...


class _FlatSlabSource:
    """Shared base: row-major flat ranges ``[c * slab_entries, ...)``.

    Subclasses implement ``_values_flat(start, stop)``; everything else —
    cursor arithmetic, index synthesis, iteration — lives here so all
    sources agree on which entries slab ``c`` contains.
    """

    def __init__(self, shape: tuple[int, ...], slab_entries: int):
        self.shape = tuple(int(s) for s in shape)
        if slab_entries <= 0:
            raise ValueError(f"slab_entries must be positive, got {slab_entries}")
        self.slab_entries = int(slab_entries)
        self.n_entries = int(np.prod(self.shape))
        #: peak bytes one slab occupies resident (indices int64 + values f32)
        self.slab_nbytes = self.slab_entries * (8 * len(self.shape) + 4)

    @property
    def n_slabs(self) -> int:
        return -(-self.n_entries // self.slab_entries)

    def slab_at(self, cursor: int) -> Slab:
        if not 0 <= cursor < self.n_slabs:
            raise IndexError(f"cursor {cursor} out of range [0, {self.n_slabs})")
        start = cursor * self.slab_entries
        stop = min(start + self.slab_entries, self.n_entries)
        flat = np.arange(start, stop, dtype=np.int64)
        indices = flat_to_multi(flat, self.shape)
        values = np.asarray(
            self._values_slab(start, stop, indices), np.float32
        ).ravel()
        return Slab(cursor, indices, values)

    def _values_slab(
        self, start: int, stop: int, indices: np.ndarray
    ) -> np.ndarray:
        """Values for the flat range [start, stop); ``indices`` is its
        already-computed multi-index block for sources that synthesize
        values from coordinates."""
        raise NotImplementedError

    def iter_slabs(self, start: int = 0, stop: int | None = None) -> Iterator[Slab]:
        for c in range(start, self.n_slabs if stop is None else stop):
            yield self.slab_at(c)


class DenseSource(_FlatSlabSource):
    """Slabs over an in-memory array (control path for parity tests)."""

    def __init__(self, x: np.ndarray, slab_entries: int = 1 << 16):
        super().__init__(x.shape, slab_entries)
        self._flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)

    def _values_slab(self, start, stop, indices) -> np.ndarray:
        return self._flat[start:stop]


class MMapTensorSource(_FlatSlabSource):
    """Flat binary file of row-major entries, read slab-by-slab via mmap —
    the resident set is one slab, never the tensor."""

    def __init__(
        self,
        path: str,
        shape: tuple[int, ...],
        dtype: str | np.dtype = np.float32,
        slab_entries: int = 1 << 16,
    ):
        super().__init__(shape, slab_entries)
        self._data = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        if len(self._data) < self.n_entries:
            raise ValueError(
                f"{path}: {len(self._data)} entries on disk < shape "
                f"{self.shape} ({self.n_entries} entries)"
            )

    def _values_slab(self, start, stop, indices) -> np.ndarray:
        return np.asarray(self._data[start:stop], dtype=np.float32)


def write_tensor_file(path: str, x: np.ndarray) -> None:
    """Row-major flat dump, the on-disk layout MMapTensorSource reads."""
    np.ascontiguousarray(x).tofile(path)


class SyntheticTensorSource(_FlatSlabSource):
    """Seeded separable-harmonic tensor, computed entrywise from indices.

    value(i) = A * prod_k sin(2 pi f_k i_k / N_k + phi_k) + bias + noise-free
    second harmonic — smooth, learnable structure (NTTD reaches high
    fitness on it) that a generator can emit for ANY flat range without
    materializing the tensor.  Frequencies/phases are drawn once from
    ``seed``, so slab c is a pure function of (shape, slab_entries, seed, c).
    """

    def __init__(
        self,
        shape: tuple[int, ...],
        slab_entries: int = 1 << 16,
        seed: int = 0,
    ):
        super().__init__(shape, slab_entries)
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        d = len(self.shape)
        self._freq = rng.integers(1, 4, size=(2, d)).astype(np.float64)
        self._phase = rng.uniform(0.0, 2 * np.pi, size=(2, d))
        self._amp = np.array([1.0, 0.35])
        self._bias = float(rng.normal() * 0.1)

    def _values_slab(self, start, stop, indices) -> np.ndarray:
        return self.values_at(indices)

    def values_at(self, indices: np.ndarray) -> np.ndarray:
        """Ground truth at arbitrary multi-indices [B, d] — the whole point
        of this source: any entry is computable without the tensor."""
        dims = np.asarray(self.shape, dtype=np.float64)
        out = np.full(indices.shape[0], self._bias)
        for h in range(2):
            theta = 2 * np.pi * self._freq[h] * indices / dims + self._phase[h]
            out += self._amp[h] * np.prod(np.sin(theta), axis=1)
        return out.astype(np.float32)
