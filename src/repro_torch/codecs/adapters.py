"""Codec adapters of the port, as in ``repro.codecs.adapters``.

Registered names, the reference's: ``nttd`` (the paper's TensorCodec),
``ttd``, ``tucker``, ``cpd``, ``tensor_ring`` (decomposition competitors),
and ``szlite`` (error-bounded entropy coder).  ``NTTDCodec.fit``
compresses (Alg. 1, ``core.codec.compress``) and ``NTTDCodec.stream_fitter``
streams (``stream.fit.NTTDStreamFitter``) on the card unless given
``device``, and ``NTTDEncoded`` decodes on the device its params live on.
The five competitors are NumPy on the host, as in the reference: they
reach no kernel, their ``from_bytes(data, device=None)`` takes the common
signature and keeps its arrays on the host, and their ``to_bytes`` is
byte-identical to the reference's.

    from repro_torch.codecs import get_codec

    enc = get_codec("nttd").fit(x, rank=8, hidden=16, epochs=30)   # on CUDA
    enc = get_codec("nttd").fit(x, budget=1 << 20, device="cpu")   # budget rule
    blob = enc.save()           # loads in repro.codecs.load_bytes too
    tt = get_codec("ttd").fit(x, budget=1 << 16)                   # host NumPy
"""
from __future__ import annotations

import dataclasses
import string
from typing import Any

import numpy as np

from repro_torch.codecs import container
from repro_torch.codecs.base import Codec, Encoded, register
from repro_torch.core import codec as codec_lib
from repro_torch.core import cpd, nttd, serialization, szlite, tensor_ring, ttd, tucker
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

    def stream_fitter(
        self, shape: tuple[int, ...], budget: int | None = None, **opts: Any
    ):
        """Native streaming: warm-started minibatch SGD with reservoir
        replay (``repro_torch.stream.fit.NTTDStreamFitter``), on ``device``
        (an option; CUDA unless given).  Budget translates to (rank, hidden)
        exactly as in ``fit``."""
        from repro_torch.stream.fit import NTTDStreamFitter

        if budget is not None and "rank" not in opts:
            rank = self._rank_for_budget(tuple(shape), int(budget), opts)
            opts = {**opts, "rank": rank, "hidden": opts.get("hidden", 2 * rank)}
        return NTTDStreamFitter(tuple(shape), **opts)


# ---------------------------------------------------------------------------
# TT-SVD
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TTEncoded(Encoded):
    tt: ttd.TTDecomposition

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(c.shape[1] for c in self.tt.cores)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = _as_index_batch(indices, len(self.tt.cores))
        v = np.ones((idx.shape[0], 1))
        for k, core in enumerate(self.tt.cores):
            v = np.einsum("br,rbs->bs", v, core[:, idx[:, k], :])
        return v[:, 0]

    def to_dense(self) -> np.ndarray:
        return self.tt.to_dense()

    def payload_bytes(self) -> int:
        return self.tt.payload_bytes(TTDCodec.bytes_per_param)

    def to_bytes(self) -> bytes:
        return container.pack_arrays(*self.tt.cores)

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "TTEncoded":
        """Host NumPy arrays, as in the reference; ``device`` is taken for
        the common signature and not used."""
        return cls(ttd.TTDecomposition(container.unpack_arrays(data)))


@register("ttd")
class TTDCodec(Codec):
    encoded_cls = TTEncoded

    def stream_fitter(
        self,
        shape: tuple[int, ...],
        budget: int | None = None,
        *,
        max_rank: int | None = None,
        rel_eps: float = 0.02,
    ):
        """Native streaming: TT-ICE-style incremental basis expansion over
        mode-0 slices (repro_torch.stream.fit.TTICEStreamFitter)."""
        from repro_torch.stream.fit import TTICEStreamFitter

        if max_rank is None:
            if budget is None:
                raise ValueError("ttd.stream_fitter needs a budget or max_rank")
            max_rank = max(
                ttd.tt_rank_for_budget(
                    tuple(shape), int(budget) // self.bytes_per_param
                ),
                1,
            )
        return TTICEStreamFitter(tuple(shape), max_rank=max_rank, rel_eps=rel_eps)

    def fit(
        self,
        x: np.ndarray,
        budget: int | None = None,
        *,
        max_rank: int | None = None,
        eps: float | None = None,
    ) -> TTEncoded:
        if max_rank is None and eps is None:
            if budget is None:
                raise ValueError("ttd.fit needs a budget, max_rank, or eps")
            max_rank = max(
                ttd.tt_rank_for_budget(x.shape, int(budget) // self.bytes_per_param), 1
            )
        return TTEncoded(ttd.tt_svd(x, max_rank=max_rank, eps=eps))


# ---------------------------------------------------------------------------
# Tucker (HOSVD + HOOI)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TuckerEncoded(Encoded):
    tk: tucker.TuckerDecomposition

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(f.shape[0] for f in self.tk.factors)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        d = self.tk.core.ndim
        idx = _as_index_batch(indices, d)
        letters = [c for c in string.ascii_letters if c != "i"]  # 'i' = batch
        if d > len(letters):
            raise ValueError(f"tucker decode_at supports up to {len(letters)} modes")
        subs = letters[:d]
        eq = "".join(subs) + "," + ",".join("i" + s for s in subs) + "->i"
        rows = [f[idx[:, k]] for k, f in enumerate(self.tk.factors)]
        return np.einsum(eq, self.tk.core, *rows, optimize=True)

    def to_dense(self) -> np.ndarray:
        return self.tk.to_dense()

    def payload_bytes(self) -> int:
        return self.tk.payload_bytes(TuckerCodec.bytes_per_param)

    def to_bytes(self) -> bytes:
        return container.pack_arrays(self.tk.core, *self.tk.factors)

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "TuckerEncoded":
        """Host NumPy arrays, as in the reference; ``device`` is taken for
        the common signature and not used."""
        core, *factors = container.unpack_arrays(data)
        return cls(tucker.TuckerDecomposition(core, factors))


@register("tucker")
class TuckerCodec(Codec):
    encoded_cls = TuckerEncoded

    def fit(
        self,
        x: np.ndarray,
        budget: int | None = None,
        *,
        ranks: list[int] | None = None,
        iters: int = 5,
    ) -> TuckerEncoded:
        if ranks is None:
            if budget is None:
                raise ValueError("tucker.fit needs a budget or ranks")
            ranks = tucker.tucker_ranks_for_budget(
                x.shape, int(budget) // self.bytes_per_param
            )
        return TuckerEncoded(tucker.tucker_hooi(x, ranks, iters=iters))


# ---------------------------------------------------------------------------
# CP (ALS)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CPEncoded(Encoded):
    cp: cpd.CPDecomposition

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(f.shape[0] for f in self.cp.factors)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = _as_index_batch(indices, len(self.cp.factors))
        prod = np.broadcast_to(
            self.cp.weights, (idx.shape[0], self.cp.weights.shape[0])
        ).copy()
        for k, f in enumerate(self.cp.factors):
            prod *= f[idx[:, k]]
        return prod.sum(axis=1)

    def to_dense(self) -> np.ndarray:
        return self.cp.to_dense()

    def payload_bytes(self) -> int:
        return self.cp.payload_bytes(CPDCodec.bytes_per_param)

    def to_bytes(self) -> bytes:
        return container.pack_arrays(self.cp.weights, *self.cp.factors)

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "CPEncoded":
        """Host NumPy arrays, as in the reference; ``device`` is taken for
        the common signature and not used."""
        weights, *factors = container.unpack_arrays(data)
        return cls(cpd.CPDecomposition(weights, factors))


@register("cpd")
class CPDCodec(Codec):
    encoded_cls = CPEncoded

    def fit(
        self,
        x: np.ndarray,
        budget: int | None = None,
        *,
        rank: int | None = None,
        iters: int = 25,
        seed: int = 0,
    ) -> CPEncoded:
        if rank is None:
            if budget is None:
                raise ValueError("cpd.fit needs a budget or rank")
            rank = cpd.cp_rank_for_budget(x.shape, int(budget) // self.bytes_per_param)
        return CPEncoded(cpd.cp_als(x, rank, iters=iters, seed=seed))


# ---------------------------------------------------------------------------
# Tensor-Ring (TR-SVD)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TREncoded(Encoded):
    tr: tensor_ring.TRDecomposition

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(c.shape[1] for c in self.tr.cores)

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = _as_index_batch(indices, len(self.tr.cores))
        v: np.ndarray | None = None
        for k, core in enumerate(self.tr.cores):
            slab = core[:, idx[:, k], :]  # [r_prev, B, r_next]
            if v is None:
                v = np.moveaxis(slab, 1, 0)  # [B, r0, r1]
            else:
                v = np.einsum("bpr,rbs->bps", v, slab)
        return np.trace(v, axis1=1, axis2=2)

    def to_dense(self) -> np.ndarray:
        return self.tr.to_dense()

    def payload_bytes(self) -> int:
        return self.tr.payload_bytes(TRCodec.bytes_per_param)

    def to_bytes(self) -> bytes:
        return container.pack_arrays(*self.tr.cores)

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "TREncoded":
        """Host NumPy arrays, as in the reference; ``device`` is taken for
        the common signature and not used."""
        return cls(tensor_ring.TRDecomposition(container.unpack_arrays(data)))


@register("tensor_ring")
class TRCodec(Codec):
    encoded_cls = TREncoded

    def fit(
        self,
        x: np.ndarray,
        budget: int | None = None,
        *,
        max_rank: int | None = None,
    ) -> TREncoded:
        if max_rank is None:
            if budget is None:
                raise ValueError("tensor_ring.fit needs a budget or max_rank")
            # a ring needs r >= 2 to be distinct from TT
            max_rank = max(
                tensor_ring.tr_rank_for_budget(
                    x.shape, int(budget) // self.bytes_per_param
                ),
                2,
            )
        return TREncoded(tensor_ring.tr_svd(x, max_rank))


# ---------------------------------------------------------------------------
# SZ-lite (error-bounded, entropy-coded)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SZEncoded(Encoded):
    sz: szlite.SZCompressed
    #: rebuilds vs reuses of the dense reconstruction cache; the serve
    #: layer's byte-budgeted LRU reads these and evicts via drop_caches()
    cache_hits: int = dataclasses.field(default=0, compare=False)
    cache_misses: int = dataclasses.field(default=0, compare=False)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.sz.shape)

    @property
    def _dense(self) -> np.ndarray:
        # stream codec: one cached full decompression backs decode_at;
        # droppable (and re-buildable) under a serve-side byte budget
        cached = getattr(self, "_dense_cache", None)
        if cached is None:
            self.cache_misses += 1
            cached = szlite.decompress(self.sz)
            self._dense_cache = cached
        else:
            self.cache_hits += 1
        return cached

    def cache_nbytes(self) -> int:
        cached = getattr(self, "_dense_cache", None)
        return int(cached.nbytes) if cached is not None else 0

    def drop_caches(self) -> None:
        self._dense_cache = None

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        idx = _as_index_batch(indices, len(self.sz.shape))
        return self._dense[tuple(idx[:, k] for k in range(idx.shape[1]))]

    def to_dense(self) -> np.ndarray:
        # copy: the cache also backs decode_at, so callers must not alias it
        return self._dense.copy()

    def payload_bytes(self) -> int:
        # entropy-coded: the payload IS the stored bytes, no fp convention
        return self.sz.payload_bytes()

    def to_bytes(self) -> bytes:
        # same shared framing as the decomposition codecs: shape, error
        # bound, and the entropy-coded stream as three arrays
        return container.pack_arrays(
            np.asarray(self.sz.shape, dtype=np.int64),
            np.asarray([self.sz.error_bound], dtype=np.float64),
            np.frombuffer(self.sz.data, dtype=np.uint8),
        )

    @classmethod
    def from_bytes(cls, data: bytes, device: Any = None) -> "SZEncoded":
        """Host NumPy arrays, as in the reference; ``device`` is taken for
        the common signature and not used."""
        shape, error_bound, stream = container.unpack_arrays(data)
        return cls(
            szlite.SZCompressed(
                stream.tobytes(), tuple(int(n) for n in shape), float(error_bound[0])
            )
        )


@register("szlite")
class SZLiteCodec(Codec):
    encoded_cls = SZEncoded

    def fit(
        self,
        x: np.ndarray,
        budget: int | None = None,
        *,
        error_bound: float | None = None,
        search_iters: int = 24,
    ) -> SZEncoded:
        """With an explicit ``error_bound``, compress directly.  With a byte
        ``budget``, bisect (on log error bound) for the tightest bound whose
        payload fits.  Raises if even the loosest bound overshoots the
        budget (the entropy-coded stream has a size floor that grows with
        the tensor) — a silently oversized payload would make
        budget-matched comparisons unfair."""
        if error_bound is not None:
            return SZEncoded(szlite.compress(x, error_bound))
        if budget is None:
            raise ValueError("szlite.fit needs a budget or error_bound")
        spread = float(np.ptp(x)) or 1.0
        lo, hi = np.log(spread * 1e-9), np.log(spread * 4.0)
        best = szlite.compress(x, float(np.exp(hi)))
        if best.payload_bytes() > budget:
            raise ValueError(
                f"szlite cannot meet budget={budget}B: stream floor is "
                f"{best.payload_bytes()}B for {x.size} entries"
            )
        for _ in range(search_iters):
            mid = (lo + hi) / 2
            cand = szlite.compress(x, float(np.exp(mid)))
            if cand.payload_bytes() <= budget:
                best, hi = cand, mid
            else:
                lo = mid
        return SZEncoded(best)
