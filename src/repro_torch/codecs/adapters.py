"""Codec adapters of the port, as in ``repro.codecs.adapters``.

Only ``nttd`` (the paper's TensorCodec) is ported: ``NTTDCodec.fit``
compresses (Alg. 1, ``core.codec.compress``) on the card unless given
``device``, and ``NTTDEncoded`` decodes on the device its params live on.
Streaming fits (``stream_fitter``) and the five competitor codecs (ttd,
tucker, cpd, tensor_ring, szlite) are not ported yet.

    from repro_torch.codecs import get_codec

    enc = get_codec("nttd").fit(x, rank=8, hidden=16, epochs=30)   # on CUDA
    enc = get_codec("nttd").fit(x, budget=1 << 20, device="cpu")   # budget rule
    blob = enc.save()           # loads in repro.codecs.load_bytes too
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.codecs.base import Codec, Encoded, register
from repro_torch.core import codec as codec_lib
from repro_torch.core import nttd, serialization
from repro_torch.core.folding import make_folding_spec


def _as_index_batch(indices: np.ndarray, d: int) -> np.ndarray:
    idx = np.asarray(indices)
    if idx.ndim != 2 or idx.shape[1] != d:
        raise ValueError(f"indices must be [B, {d}], got {idx.shape}")
    return idx


@dataclasses.dataclass
class NTTDEncoded(Encoded):
    ct: codec_lib.CompressedTensor
    log: codec_lib.CompressionLog | None = None

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

    def fit(self, x: np.ndarray, budget: int | None = None, device: Any = None,
            **opts: Any) -> NTTDEncoded:
        """Options are :class:`repro_torch.core.codec.CodecConfig` fields.
        When a byte ``budget`` is given without an explicit ``rank``, the
        largest (rank, hidden=2*rank) architecture whose §V-A payload fits is
        used.  Runs on ``device``, CUDA unless given."""
        if budget is not None and "rank" not in opts:
            rank = self._rank_for_budget(x.shape, int(budget), opts)
            opts = {**opts, "rank": rank, "hidden": opts.get("hidden", 2 * rank)}
        ct, log = codec_lib.compress(np.asarray(x, np.float32),
                                     codec_lib.CodecConfig(**opts), device=device)
        return NTTDEncoded(ct, log)

    def _rank_for_budget(self, shape: tuple[int, ...], budget: int, opts: dict) -> int:
        """The reference's rule (ranks 1 to 128, hidden 2 rank unless given),
        its params counted from ``nttd.param_shapes``
        (``count_param_shapes``)."""
        spec = make_folding_spec(shape, opts.get("d_prime"))
        best = 0
        floor = None
        for rank in range(1, 129):
            cfg = nttd.NTTDConfig(rank=rank, hidden=opts.get("hidden", 2 * rank))
            bits = codec_lib.nttd_payload_bits(nttd.count_param_shapes(spec, cfg), shape,
                                               self.bytes_per_param)
            nbytes = (bits + 7) // 8
            floor = nbytes if floor is None else floor
            if nbytes > budget:
                break
            best = rank
        if best == 0:
            raise ValueError(
                f"nttd cannot meet budget={budget}B: rank-1 payload is {floor}B"
            )
        return best

    def stream_fitter(self, shape, budget=None, **opts):
        raise NotImplementedError(
            "repro_torch fits NTTD payloads whole; streaming fits are not ported yet"
        )
