"""Delta chains: residual-coded versions of one logical tensor, as in
``repro.temporal.delta``.

A v4 container stores per-version codec bodies plus a version index
(``repro_torch.codecs.container.VersionEntry``): keyframes decode
stand-alone, deltas decode to a residual that is ADDED to their base
version's decode.

* :func:`resolve_chain` — walk base pointers down to a keyframe;
* :class:`ChainEncoded` — an :class:`~repro_torch.codecs.base.Encoded`
  whose decode is the float64 SUM of its component decodes on the host,
  keyframe first — the ONE summation convention every reader shares, so
  answers stay bit-identical across readers;
* :class:`DeltaFitter` — fits residual tensors, warm-starting NTTD from
  the previous delta's parameters via the ``fit_stream`` resume contract.
"""
from __future__ import annotations

import numpy as np

from repro_torch.codecs.base import Codec, Encoded, get_codec
from repro_torch.codecs.container import VersionEntry
from repro_torch.stream.source import DenseSource


def resolve_chain(versions: list[VersionEntry], version: int) -> list[int]:
    """Version ids whose decodes sum to ``version``, KEYFRAME FIRST."""
    if not 0 <= version < len(versions):
        raise ValueError(f"version {version} out of range [0, {len(versions)})")
    chain = []
    v = int(version)
    while True:
        chain.append(v)
        ve = versions[v]
        if ve.is_keyframe:
            break
        v = ve.base  # validated strictly decreasing, so this terminates
    chain.reverse()
    return chain


class ChainEncoded(Encoded):
    """A resolved keyframe→delta chain behaving like one payload.

    Components are in decode order (keyframe first); every query is the
    float64 sum of the component answers, taken on the host.  Each
    component decodes where its own ``from_bytes`` placed it (an NTTD
    component through the card's fused decode).  Chains are assembled from
    a v4 container rather than serialized themselves, so the byte
    round-trip hooks refuse.
    """

    codec_name = "chain"  # not in the registry: v4 files name the INNER codec

    def __init__(self, components: list[Encoded]):
        if not components:
            raise ValueError("empty chain")
        self.components = list(components)
        shape = tuple(self.components[0].shape)
        for c in self.components[1:]:
            if tuple(c.shape) != shape:
                raise ValueError(
                    f"chain components disagree on shape: {tuple(c.shape)} vs {shape}"
                )

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.components[0].shape)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices)
        out = np.zeros((idx.shape[0],), dtype=np.float64)
        for c in self.components:
            out += np.asarray(c.decode_at(idx), np.float64)
        return out

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        for c in self.components:
            out += np.asarray(c.to_dense(), np.float64)
        return out

    def payload_bytes(self) -> int:
        return sum(c.payload_bytes() for c in self.components)

    def to_bytes(self) -> bytes:
        raise ValueError(
            "chain payloads are written by the delta-mode ChunkedWriter, "
            "not to_bytes"
        )

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "ChainEncoded":
        raise ValueError(
            "chain payloads are read from v4 containers "
            "(container.load_bytes), not from_bytes"
        )

    def cache_nbytes(self) -> int:
        return sum(c.cache_nbytes() for c in self.components)

    def drop_caches(self) -> None:
        for c in self.components:
            c.drop_caches()


def load_chain(
    codec: Codec,
    bodies: list[bytes],
    versions: list[VersionEntry],
    version: int | None = None,
    device=None,
) -> ChainEncoded:
    """Assemble the chain for ``version`` (default: latest) from per-version
    codec bodies; every component's ``from_bytes`` gets ``device``."""
    if len(bodies) != len(versions):
        raise ValueError(f"{len(bodies)} bodies for {len(versions)} versions")
    v = len(versions) - 1 if version is None else int(version)
    chain = resolve_chain(versions, v)
    return ChainEncoded(
        [codec.encoded_cls.from_bytes(bodies[c], device=device) for c in chain]
    )


class DeltaFitter:
    """Fit residual tensors, reusing fit state across consecutive deltas.

    For NTTD the fitter keeps ONE persistent ``NTTDStreamFitter`` (on
    ``device``, CUDA unless given) and resumes it through
    ``Codec.fit_stream(..., fitter=)`` for every residual: delta k+1's SGD
    warm-starts from delta k's parameters.  Normalization is off by
    default — the stream fitter freezes first-slab statistics, which would
    mis-scale every later residual.  Codecs without a native stream fitter
    (TT/Tucker/CP/TR/SZ) refit per residual via plain ``fit`` on the host.
    """

    def __init__(
        self,
        shape: tuple[int, ...],
        codec: str = "nttd",
        *,
        slab_entries: int = 1 << 14,
        passes: int = 2,
        opts: dict | None = None,
        device=None,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.codec = get_codec(codec)
        self.slab_entries = int(slab_entries)
        self.passes = int(passes)
        self.opts = dict(opts or {})
        self._fitter = None
        if codec == "nttd":
            self.opts.setdefault("normalize", False)
            self._fitter = self.codec.stream_fitter(
                self.shape, None, device=device, **self.opts
            )

    def fit_residual(self, residual: np.ndarray) -> Encoded:
        residual = np.asarray(residual, np.float32)
        if residual.shape != self.shape:
            raise ValueError(f"residual shape {residual.shape} != {self.shape}")
        if self._fitter is not None:
            source = DenseSource(residual, slab_entries=self.slab_entries)
            return self.codec.fit_stream(source, passes=self.passes, fitter=self._fitter)
        opts = dict(self.opts)
        budget = opts.pop("budget", None)
        return self.codec.fit(residual, budget, **opts)
