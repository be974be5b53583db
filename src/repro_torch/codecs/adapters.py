"""Codec adapters of the port, as in ``repro.codecs.adapters``.

Only ``nttd`` (the paper's TensorCodec) is ported: ``NTTDEncoded``
decodes on the device its params live on.  ``NTTDCodec.fit`` raises until
the fitting path is ported; the five competitor codecs (ttd, tucker, cpd,
tensor_ring, szlite) are not registered yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.codecs.base import Codec, Encoded, register
from repro_torch.core import codec as codec_lib
from repro_torch.core import serialization


def _as_index_batch(indices: np.ndarray, d: int) -> np.ndarray:
    idx = np.asarray(indices)
    if idx.ndim != 2 or idx.shape[1] != d:
        raise ValueError(f"indices must be [B, {d}], got {idx.shape}")
    return idx


@dataclasses.dataclass
class NTTDEncoded(Encoded):
    ct: codec_lib.CompressedTensor

    @property
    def pi(self) -> list[np.ndarray]:
        """Learned mode orderings (paper pi)."""
        return self.ct.pi

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.ct.spec.shape)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = _as_index_batch(indices, len(self.ct.spec.shape))
        return self.ct.decode(idx)

    def to_dense(self) -> np.ndarray:
        return self.ct.to_dense()

    def fitness(self, x: np.ndarray) -> float:
        return self.ct.fitness(np.asarray(x, np.float32))

    def payload_bytes(self) -> int:
        return self.ct.payload_bytes(NTTDCodec.bytes_per_param)

    def to_bytes(self) -> bytes:
        # params are stored as fp32, so the fp32 body round-trips bit-exactly
        return serialization.save_bytes(self.ct, np.float32)

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "NTTDEncoded":
        return cls(serialization.load_bytes(data, device=device))


@register("nttd")
class NTTDCodec(Codec):
    encoded_cls = NTTDEncoded

    def fit(self, x: np.ndarray, budget: int | None = None, **opts: Any) -> NTTDEncoded:
        raise NotImplementedError(
            "repro_torch decodes NTTD payloads; fitting (Alg. 1) is not ported yet"
        )

    def stream_fitter(self, shape, budget=None, **opts):
        raise NotImplementedError(
            "repro_torch decodes NTTD payloads; streaming fits are not ported yet"
        )
