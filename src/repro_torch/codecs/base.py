"""The `Codec` protocol and string-keyed registry (framework-free), as in
``repro.codecs.base``.

Every compressor in the repo — the paper's NTTD-based TensorCodec and the
five §V competitors (TT, Tucker, CP, TR, SZ-lite) — is exposed behind one
interface so benchmarks, checkpoint compression, and the serve layer can
treat them as interchangeable fit/query backends:

    from repro_torch.codecs import get_codec, available

    enc = get_codec("nttd").fit(x, budget_bytes)   # or codec-specific opts
    enc.fitness(x)                 # 1 - ||x - x_hat|| / ||x||
    enc.decode_at(indices)         # entries at ORIGINAL indices, [B, d] -> [B]
    enc.to_dense()                 # full reconstruction
    enc.payload_bytes()            # paper §V-A accounting (one convention)
    blob = enc.save()              # self-describing container (container.py)

`budget` is a payload budget in BYTES under the shared accounting
convention (`Codec.bytes_per_param` = 8, the paper's fp64 convention);
each adapter translates it into its native knob (TT/TR/CP rank, Tucker
rank vector, SZ error bound, NTTD rank/hidden).  Codec-specific keyword
options bypass the budget translation when given explicitly.
"""
from __future__ import annotations

import abc
from typing import Any, ClassVar

import numpy as np


class Encoded(abc.ABC):
    """A fitted compressed payload: query, account, and serialize.

    ``codec_name`` is stamped by ``@register`` and is the id written into
    the container header, so a payload loaded from disk knows which codec
    decodes it.
    """

    codec_name: ClassVar[str] = "?"

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, ...]:
        """Shape of the original tensor this payload encodes — the index
        space ``decode_at`` addresses."""

    # -- querying ------------------------------------------------------------
    @abc.abstractmethod
    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        """Approximate entries at ORIGINAL indices: [B, d] int -> [B]."""

    @abc.abstractmethod
    def to_dense(self) -> np.ndarray:
        """Full reconstruction in original index order."""

    def fitness(self, x: np.ndarray) -> float:
        """Paper Eq. 1: 1 - ||x - x_hat||_F / ||x||_F on the raw tensor."""
        x64 = np.asarray(x, dtype=np.float64)
        err = float(np.linalg.norm(x64 - np.asarray(self.to_dense(), np.float64)))
        return 1.0 - err / max(float(np.linalg.norm(x64)), 1e-30)

    # -- accounting ----------------------------------------------------------
    @abc.abstractmethod
    def payload_bytes(self) -> int:
        """Compressed size under the shared §V-A accounting convention."""

    # -- serialization (container body; header added by container.py) --------
    @abc.abstractmethod
    def to_bytes(self) -> bytes:
        """Codec-specific body bytes.  Bit-exact round-trip contract:
        ``from_bytes(to_bytes())`` decodes identically."""

    @classmethod
    @abc.abstractmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "Encoded":
        """Inverse of ``to_bytes``.  ``device`` is where the payload
        decodes (CUDA unless given)."""

    def save(self) -> bytes:
        """Full self-describing container (header + body)."""
        from repro_torch.codecs import container

        return container.save_bytes(self)

    # -- serve-layer cache hooks ---------------------------------------------
    def cache_nbytes(self) -> int:
        """Bytes of droppable decode acceleration state this payload holds
        (e.g. SZ-lite's cached dense reconstruction).  The serve layer's
        byte-budgeted LRU accounts and evicts through these two hooks."""
        return 0

    def drop_caches(self) -> None:
        """Release droppable decode state; decoding stays correct, the next
        query just pays the rebuild."""


class StreamFitter(abc.ABC):
    """Incremental fit state: feed slabs with ``update``, then ``finalize``.

    The streaming analogue of ``Codec.fit`` — a fitter is handed
    ``(indices, values)`` slabs one at a time (a slab source)
    and must be deterministic in the slab sequence, so a fit resumed from a
    source cursor produces a bit-identical payload to an uninterrupted run.
    """

    @abc.abstractmethod
    def update(self, indices: np.ndarray, values: np.ndarray) -> None:
        """Incorporate one slab: original multi-indices [B, d] + values [B]."""

    @abc.abstractmethod
    def finalize(self) -> Encoded:
        """Produce the payload for everything seen so far."""


class AccumulatingFitter(StreamFitter):
    """Fallback for codecs without native streaming: scatter arriving slabs
    into a dense buffer, then run the one-shot ``fit``.  Correct for any
    codec but NOT out-of-core — the buffer is the full tensor."""

    def __init__(self, codec: "Codec", shape: tuple[int, ...],
                 budget: int | None, opts: dict[str, Any]):
        self._codec = codec
        self._budget = budget
        self._opts = opts
        self._x = np.zeros(shape, dtype=np.float32)

    def update(self, indices: np.ndarray, values: np.ndarray) -> None:
        idx = np.asarray(indices)
        self._x[tuple(idx[:, k] for k in range(idx.shape[1]))] = np.asarray(
            values, np.float32
        )

    def finalize(self) -> Encoded:
        return self._codec.fit(self._x, self._budget, **self._opts)


class Codec(abc.ABC):
    """A fit backend producing :class:`Encoded` payloads."""

    name: ClassVar[str] = "?"
    encoded_cls: ClassVar[type[Encoded]]
    #: the paper's §V-A size convention: every parameter is accounted as
    #: fp64 regardless of the dtype it is *stored* at.  All registered
    #: codecs share this value so budget-matched comparisons are fair;
    #: tests assert the conventions agree.
    bytes_per_param: ClassVar[int] = 8

    @abc.abstractmethod
    def fit(self, x: np.ndarray, budget: int | None = None, **opts: Any) -> Encoded:
        """Compress ``x`` to at most ``budget`` payload bytes (accounting
        convention), or per ``opts`` when codec-native knobs are given."""

    # -- streaming (optional hook) -------------------------------------------
    def stream_fitter(
        self, shape: tuple[int, ...], budget: int | None = None, **opts: Any
    ) -> StreamFitter:
        """Return an incremental fitter for a tensor of ``shape``.  Codecs
        with native streaming override this; the default accumulates then
        fits."""
        return AccumulatingFitter(self, tuple(int(s) for s in shape), budget, opts)

    def fit_stream(
        self,
        source: Any,
        budget: int | None = None,
        *,
        start: int = 0,
        stop: int | None = None,
        passes: int = 1,
        fitter: StreamFitter | None = None,
        **opts: Any,
    ) -> Encoded:
        """Fit over a slab source cursor range (``source.n_slabs``,
        ``source.slab_at``).

        ``passes`` re-reads the cursor range that many times (the resumable
        source makes multi-epoch out-of-core training a re-read, not a
        materialization) — iterative fitters (NTTD) keep improving, one-shot
        fitters just see repeated data.  Pass a ``fitter`` (from
        ``stream_fitter``) to resume: processing slabs ``[0, k)`` then
        ``[k, n)`` on one fitter yields a payload bit-identical to
        processing ``[0, n)`` in one call.
        """
        if fitter is None:
            fitter = self.stream_fitter(tuple(source.shape), budget, **opts)
        elif opts or budget is not None:
            raise ValueError("budget/opts belong to stream_fitter, not resume")
        stop = source.n_slabs if stop is None else stop
        for _ in range(passes):
            for cursor in range(start, stop):
                slab = source.slab_at(cursor)
                fitter.update(slab.indices, slab.values)
        return fitter.finalize()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Codec] = {}


def register(name: str):
    """Class decorator: instantiate the codec and register it under ``name``."""

    def deco(cls: type[Codec]) -> type[Codec]:
        cls.name = name
        cls.encoded_cls.codec_name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; available: {', '.join(available())}"
        ) from None


def available() -> list[str]:
    """Sorted names of all registered codecs."""
    return sorted(_REGISTRY)
