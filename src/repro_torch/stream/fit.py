"""Incremental fitters behind the ``Codec.fit_stream`` hook, as in
``repro.stream.fit``.

``fit_stream(name, source, budget)`` is the one entry point; it
dispatches to the named codec's ``stream_fitter``:

  * NTTD — warm-started minibatch SGD (paper §IV-B Alg. 2) over arriving
    slabs, on the card unless ``device`` says otherwise.  Each slab trains
    a few Adam steps whose batches mix fresh slab entries with a seeded
    reservoir replay buffer, so early slabs are not forgotten once they
    leave memory.  The batches are drawn on the host with the reference's
    seeds, so both packages train on the same entries; they reach the
    device in one copy a slab, and nothing is read back in a slab (fit
    telemetry, when on, reads the loss).  Mode
    orderings start identity (the TSP init needs the full tensor);
    ``refine_orders`` optionally recomputes them mid-stream from the
    reservoir sample (or a caller-provided dense estimate).  Normalization
    constants are frozen from the first slab.
  * TT — a TT-ICE-style update (Aksoy et al., *An Incremental Tensor
    Train Decomposition Algorithm*) on the host: an orthonormal row-space
    basis is expanded by each slab's residual directions (rank-capped),
    and ``finalize`` TT-SVDs the small basis tensor back into cores.
  * everything else — the default accumulate-then-``fit`` fallback in
    ``codecs/base.py``.

Every fitter is deterministic in the slab sequence: per-slab RNG is
seeded from ``(seed, slab_index)``, so resuming from a source cursor
reproduces an uninterrupted run bit-for-bit, on the card too.  Both
fitters emit the reference's ``fit_slab`` events (``obs.fit_event``) while
fit telemetry is on (``REPRO_FIT_LOG`` or ``obs.set_fit_log``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.codecs.base import Encoded, StreamFitter, get_codec
from repro_torch.core import codec as codec_lib
from repro_torch.core import nttd, reorder, ttd
from repro_torch.core.folding import make_folding_spec
from repro_torch.devices import resolve_device
from repro_torch.optim import optimizers


def fit_stream(codec_name: str, source, budget: int | None = None, **opts) -> Encoded:
    """Fit the named codec over a :class:`repro_torch.stream.SlabSource`."""
    return get_codec(codec_name).fit_stream(source, budget, **opts)


# ---------------------------------------------------------------------------
# NTTD: warm-started minibatch SGD + reservoir replay
# ---------------------------------------------------------------------------
class NTTDStreamFitter(StreamFitter):
    """The reference's fitter, training on ``device`` (CUDA unless given).

    ``kernel_impl`` defaults to "auto", as ``CodecConfig``'s does: on the
    card every step runs the ``lstm_scan`` and ``tt_contract`` kernels
    forward and backward (``core.codec.training_impl``), and the payload
    decodes through the fused kernel; "ref" is the plain route on any
    device.  A fit wider than the backward kernels is refused before
    anything is allocated (``core.codec.check_training_widths``).  The
    params' initial draws come from a ``torch.Generator`` seeded with
    ``seed`` and differ from JAX's.  ``seconds`` sums the host clock spent
    sampling, dispatching the training steps and updating the reservoir.
    """

    def __init__(
        self,
        shape: tuple[int, ...],
        rank: int = 8,
        hidden: int | None = None,
        d_prime: int | None = None,
        *,
        lr: float = 5e-3,
        batch_size: int = 8192,
        steps_per_slab: int = 4,
        replay_capacity: int = 1 << 16,
        replay_fraction: float = 0.5,
        seed: int = 0,
        kernel_impl: str = "auto",
        normalize: bool = True,
        device=None,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.device = resolve_device(device)
        self.spec = make_folding_spec(self.shape, d_prime)
        self.cfg = nttd.NTTDConfig(
            rank=rank, hidden=hidden or 2 * rank, kernel_impl=kernel_impl
        )
        codec_lib.check_training_widths(
            codec_lib.CodecConfig(rank=self.cfg.rank, hidden=self.cfg.hidden,
                                  kernel_impl=kernel_impl),
            self.spec, self.device,
        )
        self.seed = int(seed)
        self.batch_size = int(batch_size)
        self.steps_per_slab = int(steps_per_slab)
        self.replay_fraction = float(replay_fraction)
        self.normalize = normalize
        self.params = nttd.init_params(
            torch.Generator().manual_seed(self.seed), self.spec, self.cfg, self.device
        )
        self._opt = optimizers.adam(lr)
        self._opt_state = self._opt.init(self.params)
        train_cfg = dataclasses.replace(
            self.cfg, kernel_impl=codec_lib.training_impl(kernel_impl)
        )
        self._epoch = codec_lib._make_train_epoch(self.spec, train_cfg, self._opt)
        d = len(self.shape)
        cap = int(replay_capacity)
        self._rpos = np.zeros((cap, d), dtype=np.int64)
        self._rval = np.zeros((cap,), dtype=np.float32)
        self._rfill = 0
        self.entries_seen = 0
        self.slabs_seen = 0
        self._mean: float | None = None
        self._std = 1.0
        #: per-mode orders (pi[k][pos] = original index); identity until a
        #: refine_orders call installs TSP-derived ones.  _inv is the lazy
        #: original->position map, None while orders are still identity so
        #: the common path pays no gather.
        self.orders = reorder.identity_orders(self.shape)
        self._inv: list[np.ndarray] | None = None
        #: the last slab's summed loss, a device scalar (read only by the
        #: fit_slab event while fit telemetry is on)
        self.loss: torch.Tensor | None = None
        self.seconds = {"sampling": 0.0, "training": 0.0, "reservoir": 0.0}

    def update(self, indices: np.ndarray, values: np.ndarray) -> None:
        t0 = time.perf_counter()
        idx = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(values, dtype=np.float32).ravel()
        if idx.ndim != 2 or idx.shape[1] != len(self.shape) or idx.shape[0] != len(vals):
            raise ValueError(
                f"slab must be indices [B, {len(self.shape)}] + values [B], "
                f"got {idx.shape} / {vals.shape}"
            )
        if self._inv is not None:
            # train in POSITION space (X_pi(pos) = X(pi(pos)), the same
            # convention core/codec.py uses); decode maps back via inv_pi
            pos_idx = np.empty_like(idx)
            for j in range(idx.shape[1]):
                pos_idx[:, j] = self._inv[j][idx[:, j]]
            idx = pos_idx
        if self._mean is None:
            # frozen first-slab estimate: a streaming fit cannot see global
            # stats up front, and re-normalizing mid-stream would shift the
            # regression targets under the optimizer
            self._mean = float(vals.mean()) if self.normalize else 0.0
            self._std = (float(vals.std()) or 1.0) if self.normalize else 1.0
        vn = np.asarray((vals - self._mean) / self._std, np.float32)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.slabs_seen) * 131 + 29
        )

        # ---- train: fixed-shape [steps, bsz] batches mixing fresh + replay
        steps, bsz = self.steps_per_slab, self.batch_size
        d = idx.shape[1]
        n_replay = int(bsz * self.replay_fraction) if self._rfill else 0
        n_fresh = bsz - n_replay
        fresh = rng.integers(0, len(vn), size=(steps, n_fresh))
        # positions (int32) and values (their f32 bits) side by side: one
        # host-to-device copy a slab
        batch = np.empty((steps, bsz, d + 1), dtype=np.int32)
        batch[:, :n_fresh, :d] = idx[fresh]
        batch[:, :n_fresh, d] = vn[fresh].view(np.int32)
        if n_replay:
            rep = rng.integers(0, self._rfill, size=(steps, n_replay))
            batch[:, n_fresh:, :d] = self._rpos[rep]
            batch[:, n_fresh:, d] = self._rval[rep].view(np.int32)
        t1 = time.perf_counter()
        on_device = torch.from_numpy(batch).to(self.device)
        with codec_lib.full_f32():
            self.params, self._opt_state, self.loss = self._epoch(
                self.params, self._opt_state, on_device[..., :d],
                on_device[..., d].view(torch.float32),
            )
        t2 = time.perf_counter()

        # ---- reservoir insert (Algorithm R, vectorized per slab) ----------
        cap = self._rval.shape[0]
        take = min(cap - self._rfill, len(vn))
        if take:
            self._rpos[self._rfill : self._rfill + take] = idx[:take]
            self._rval[self._rfill : self._rfill + take] = vn[:take]
            self._rfill += take
        if take < len(vn):
            t = self.entries_seen + 1 + np.arange(take, len(vn), dtype=np.int64)
            slots = (rng.random(len(t)) * t).astype(np.int64)
            keep = slots < cap
            self._rpos[slots[keep]] = idx[take:][keep]
            self._rval[slots[keep]] = vn[take:][keep]

        self.entries_seen += len(vn)
        self.slabs_seen += 1
        t3 = time.perf_counter()
        self.seconds["sampling"] += t1 - t0
        self.seconds["training"] += t2 - t1
        self.seconds["reservoir"] += t3 - t2
        if obs.fit_telemetry_enabled():
            # float(loss) synchronises the device: only while logging, so a
            # fit without telemetry reads nothing back.  entries_per_sec is
            # over the steps' dispatch, as the reference's is over theirs.
            obs.fit_event(
                "fit_slab",
                codec="nttd",
                step=self.slabs_seen - 1,
                loss=float(self.loss),
                entries=len(vn),
                entries_per_sec=len(vn) / (t2 - t1) if t2 > t1 else None,
                reservoir_fill=self._rfill,
                reservoir_capacity=int(self._rval.shape[0]),
            )

    def _reservoir_orig(self) -> np.ndarray:
        """Reservoir positions mapped back to ORIGINAL indices [fill, d]."""
        rpos = self._rpos[: self._rfill]
        if self._inv is None:
            return rpos
        return np.stack(
            [self.orders[j][rpos[:, j]] for j in range(len(self.shape))], axis=1
        )

    def refine_orders(self, x: np.ndarray | None = None) -> list[np.ndarray]:
        """Mid-stream TSP mode-order refinement (paper §IV-D, made
        streaming-feasible): recompute per-mode orders from a dense
        estimate — the caller's tensor when given, else a zero-filled
        densification of the reservoir sample — remap the reservoir into
        the new position space, and reinitialize the optimizer (the paper
        reinits Adam after every reorder).  Parameters are KEPT: training
        continues warm against the re-permuted targets."""
        if x is None:
            if not self._rfill:
                raise ValueError("empty reservoir: nothing to refine orders from")
            est = np.zeros(self.shape, dtype=np.float32)
            est[tuple(self._reservoir_orig().T)] = self._rval[: self._rfill]
        else:
            est = np.asarray(x, dtype=np.float32)
            if est.shape != self.shape:
                raise ValueError(
                    f"order-refinement tensor shape {est.shape} != {self.shape}"
                )
            # normalization is affine: slice distances (hence TSP orders)
            # are unchanged, but stay consistent with the reservoir path
            est = (est - (self._mean or 0.0)) / self._std
        orig = self._reservoir_orig() if self._rfill else None
        new = [reorder.tsp_order_mode(est, k) for k in range(est.ndim)]
        new_inv = [np.argsort(p) for p in new]
        if orig is not None:
            for j in range(len(self.shape)):
                self._rpos[: self._rfill, j] = new_inv[j][orig[:, j]]
        self.orders, self._inv = new, new_inv
        self._opt_state = self._opt.init(self.params)
        return new

    def finalize(self) -> Encoded:
        """The payload so far: a copy of the params on their device, which
        decodes with this fitter's ``kernel_impl``."""
        from repro_torch.codecs.adapters import NTTDEncoded

        ct = codec_lib.CompressedTensor(
            optimizers.tree_map(torch.clone, self.params),
            [np.asarray(p) for p in self.orders],
            self.spec,
            self.cfg,
            self._mean or 0.0,
            self._std,
        )
        return NTTDEncoded(ct)


# ---------------------------------------------------------------------------
# TT: TT-ICE-style incremental row-space basis expansion
# ---------------------------------------------------------------------------
class TTICEStreamFitter(StreamFitter):
    """Incremental TT over slices arriving along mode 0, on the host as in
    the reference.

    State is an orthonormal basis ``U`` [M, r] for the row space of the
    mode-0 unfolding (M = prod of trailing mode lengths) plus per-slice
    coefficients.  A new block of slices is projected onto ``U``; if the
    residual energy exceeds ``rel_eps`` and the rank cap allows, the
    residual's leading singular directions join the basis — existing
    coefficients are untouched (zero on new directions), which is exactly
    TT-ICE's update.  ``finalize`` TT-SVDs the [r, N_2, ..., N_d] basis
    tensor into trailing cores and absorbs the coefficients into core 1.

    Requires row-major slab delivery (the ``_FlatSlabSource`` layout);
    partial rows are buffered until the next slab completes them.
    """

    def __init__(
        self,
        shape: tuple[int, ...],
        max_rank: int,
        *,
        rel_eps: float = 0.02,
    ):
        if len(shape) < 2:
            raise ValueError("TT streaming needs an order >= 2 tensor")
        self.shape = tuple(int(s) for s in shape)
        self.max_rank = int(max_rank)
        self.rel_eps = float(rel_eps)
        self.row = int(np.prod(self.shape[1:]))
        self._U: np.ndarray | None = None       # [M, r] orthonormal columns
        self._coeffs: list[np.ndarray] = []     # blocks [b_i, r_at_block_i]
        self._pending = np.zeros((0,), dtype=np.float64)
        self.entries_seen = 0
        self.rows_seen = 0

    def update(self, indices: np.ndarray, values: np.ndarray) -> None:
        idx = np.asarray(indices)
        strides = np.cumprod((self.shape[1:] + (1,))[::-1])[::-1]
        flat0 = int((idx[0] * strides).sum())
        if flat0 < self.entries_seen:
            return  # re-read of an already-consumed prefix (extra pass): no-op
        if flat0 != self.entries_seen:
            raise ValueError(
                f"TT streaming needs contiguous row-major slabs: expected "
                f"flat offset {self.entries_seen}, got {flat0}"
            )
        vals = np.asarray(values, dtype=np.float64).ravel()
        self.entries_seen += len(vals)
        buf = np.concatenate([self._pending, vals])
        n_rows = len(buf) // self.row
        self._pending = buf[n_rows * self.row :]
        if not n_rows:
            return
        v = buf[: n_rows * self.row].reshape(n_rows, self.row)
        self.rows_seen += n_rows
        vnorm = float(np.linalg.norm(v))
        if self._U is None:
            u, s, _ = np.linalg.svd(v.T, full_matrices=False)
            r = max(int((s > self.rel_eps * max(vnorm, 1e-30)).sum()), 1)
            self._U = u[:, : min(r, self.max_rank)]
            self._coeffs.append(v @ self._U)
            self._slab_event(n_rows)
            return
        c = v @ self._U
        res = v - c @ self._U.T
        headroom = self.max_rank - self._U.shape[1]
        if headroom > 0 and np.linalg.norm(res) > self.rel_eps * max(vnorm, 1e-30):
            u, s, _ = np.linalg.svd(res.T, full_matrices=False)
            k = max(int((s > self.rel_eps * max(vnorm, 1e-30)).sum()), 1)
            u_new = u[:, : min(k, headroom)]
            # re-orthogonalize against U (rounding leaves tiny overlaps)
            u_new -= self._U @ (self._U.T @ u_new)
            u_new /= np.maximum(np.linalg.norm(u_new, axis=0, keepdims=True), 1e-30)
            self._U = np.concatenate([self._U, u_new], axis=1)
            c = np.concatenate([c, v @ u_new], axis=1)
        self._coeffs.append(c)
        self._slab_event(n_rows)

    def _slab_event(self, n_rows: int) -> None:
        """The reference's ``fit_slab`` event for a block of whole rows."""
        if obs.fit_telemetry_enabled():
            obs.fit_event(
                "fit_slab",
                codec="tt_ice",
                step=len(self._coeffs),
                entries=n_rows * self.row,
                rank=int(self._U.shape[1]),
                rows_seen=self.rows_seen,
            )

    def finalize(self) -> Encoded:
        from repro_torch.codecs.adapters import TTEncoded

        if self._U is None:
            raise ValueError("no complete mode-0 rows seen yet")
        r = self._U.shape[1]
        n1 = self.shape[0]
        a = np.zeros((n1, r))
        off = 0
        for block in self._coeffs:      # older blocks are zero on newer dirs
            a[off : off + block.shape[0], : block.shape[1]] = block
            off += block.shape[0]
        tail = ttd.tt_svd(
            self._U.T.reshape((r,) + self.shape[1:]), max_rank=self.max_rank
        )
        first = a @ tail.cores[0][0]    # absorb basis coefficients into core 1
        cores = [first.reshape(1, n1, first.shape[1])] + tail.cores[1:]
        return TTEncoded(ttd.TTDecomposition(cores))
