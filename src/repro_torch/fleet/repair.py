"""Replica-aware read repair: detect -> refit/restore -> swap, zero
downtime, as in ``repro.fleet.repair``.

The serving stack already CONTAINS damage — a chunk whose CRC fails is
quarantined on the instance that read it (``ChunkCorruptError``) and the
frontend fails the sub-batch over to surviving replicas; a fitness
canary that dips below its SLO records a ``last_breach``.  This module
closes the loop: a :class:`RepairController` polls every member's
``stats()`` for those two signals and REPAIRS the payload file while the
fleet keeps serving it.

Two repair kinds, both swap through an epoch switch (drain barrier ->
file mutation -> ``fleet.refresh``), so answers for untouched entry
ranges stay bit-identical before, during, and after:

* **corruption** — a quarantined chunk is restored byte-exactly from a
  donor replica: ``export_chunk`` re-serializes the donor's materialized
  payload, CRC-verifies the slice against the footer, and
  ``rewrite_chunks`` writes it back in place (same length -> the footer
  is untouched, the repaired file is byte-identical to the original).
* **quality** — the breached entry range is re-compressed ONLINE: the
  range is densified from the payload's own served decode (the degraded
  model is still the best available estimate everywhere we lack truth),
  the container's held-out ground-truth entries (``TCDQ``) overwrite
  their positions, and an NTTD stream fitter warm-fits the range —
  optionally refining TSP mode orders mid-stream from its reservoir
  sample.  The refit is gated on the held-out sample (repaired fitness
  must be >= the degraded fitness) and lands as a ``TCDP`` patch overlay
  (``append_patch``), which REPLACES decode only inside the range —
  untouched entries keep decoding from the byte-identical base chunks.

For v4 delta files a chunk restore re-validates every dependent version
chain (``repro_torch.temporal.revalidate_chains``) before the repair is
declared complete — repairing a keyframe must not leave a residual
decoding against bytes its fitter never saw.

On the card: the quality refit trains ``NTTDStreamFitter`` on the
fleet's ``device`` (a ``device`` in ``refit_opts`` wins), through the
training kernels (``lstm_scan`` and ``tt_contract``, forward and
backward), and the fitness gate decodes the refit through
``decode_tile`` there.

    ctl = RepairController(fleet)
    tickets = ctl.poll()          # corruption + quality findings
    reports = ctl.run()           # poll + repair everything found

Observability: spans ``repair.corruption`` / ``repair.quality``, events
``repair_started`` / ``repair_completed`` / ``repair_failed`` (joining
``chunk_quarantined``, ``decode_failover``, ``quality_breach`` and
``payload_refreshed`` from the detection side), and fleet metrics
``repairs_total`` / ``repair_seconds`` / ``repair_refit_entries_per_sec``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.codecs import container
from repro_torch.codecs.base import get_codec
from repro_torch.codecs.indexing import flat_to_multi
from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.transport import TransportError
from repro_torch.stream.writer import append_patch, rewrite_chunks
from repro_torch.temporal.store import _fitness, revalidate_chains


@dataclasses.dataclass
class RepairConfig:
    """Knobs for the online re-compression (quality) path."""

    #: codec refitted over the breached range (must support stream_fitter)
    codec: str = "nttd"
    #: stream_fitter options — defaults sized to INTERPOLATE a breached
    #: chunk range (the target carries exact truth at the held-out
    #: positions, so driving train error to ~0 is what clears the SLO)
    refit_opts: dict = dataclasses.field(
        default_factory=lambda: {
            "rank": 12, "steps_per_slab": 32, "batch_size": 512, "lr": 1e-2,
        }
    )
    #: entries per slab fed to the fitter
    slab_entries: int = 1 << 14
    #: passes over the densified range (SGD needs revisits to converge)
    passes: int = 10
    #: refine TSP mode orders mid-stream (after ``reorder_after`` passes)
    reorder: bool = False
    reorder_after: int = 1
    #: fitness gate: held-out fitness of the refit must be at least the
    #: degraded payload's held-out fitness plus this margin
    min_fitness_gain: float = 0.0
    #: chunking of the appended patch body
    chunk_bytes: int = 1 << 20
    #: refuse to densify a breached range larger than this
    max_patch_entries: int = 1 << 22


@dataclasses.dataclass(frozen=True)
class RepairTicket:
    """One repairable finding from :meth:`RepairController.poll`."""

    payload: str
    kind: str  # "corruption" | "quality"
    instance: str
    chunk: int | None
    entry_start: int | None
    entry_stop: int | None
    detail: str

    @property
    def key(self) -> tuple:
        """Dedup key: the same damage seen from N replicas is one repair."""
        return (self.payload, self.kind, self.chunk,
                self.entry_start, self.entry_stop)


@dataclasses.dataclass
class RepairReport:
    payload: str
    kind: str
    ok: bool = False
    #: chunk ids restored byte-exactly (corruption path)
    chunks_restored: list[int] = dataclasses.field(default_factory=list)
    #: chunk id -> donor instance that vouched for the bytes
    donors: dict[int, str] = dataclasses.field(default_factory=dict)
    entry_start: int | None = None
    entry_stop: int | None = None
    #: held-out fitness before/after the refit (quality path)
    fitness_before: float | None = None
    fitness_after: float | None = None
    refit_entries: int = 0
    elapsed_s: float = 0.0
    refit_entries_per_sec: float | None = None
    #: v4 only: dependent version chains re-validated after the restore
    chains_revalidated: int = 0
    error: str | None = None


class RepairController:
    """Polls fleet members for damage and repairs payload files in place
    while surviving replicas keep serving (see module docstring)."""

    def __init__(self, fleet: FleetFrontend, config: RepairConfig | None = None):
        self.fleet = fleet
        self.config = config or RepairConfig()
        #: where quality refits train: the fleet's device
        self.device = fleet.device
        self.reports: list[RepairReport] = []

    # ------------------------------------------------------------- detection
    def poll(self) -> list[RepairTicket]:
        """One stats sweep over live members: quarantined chunks become
        corruption tickets, canary ``last_breach`` records become quality
        tickets.  Deduplicated — R replicas reporting the same damage is
        one repair."""
        tickets: list[RepairTicket] = []
        seen: set[tuple] = set()
        for iid, t in self.fleet.transports.items():
            if iid in self.fleet.excluded:
                continue
            try:
                st = t.stats()
            except TransportError as e:
                self.fleet.exclude(iid, e)
                continue
            for name, chunks in (st.get("quarantine") or {}).items():
                for cid, err in chunks.items():
                    cid = int(cid)  # JSON transports stringify dict keys
                    lo, hi = self._chunk_entry_range(name, cid)
                    tk = RepairTicket(name, "corruption", iid, cid, lo, hi, str(err))
                    if tk.key not in seen:
                        seen.add(tk.key)
                        tickets.append(tk)
            for name, cst in (st.get("canary") or {}).items():
                lb = cst.get("last_breach")
                if not lb or lb.get("entry_start") is None:
                    continue
                tk = RepairTicket(
                    name, "quality", iid,
                    lb.get("chunk"),
                    int(lb["entry_start"]), int(lb["entry_stop"]),
                    f"canary fitness {lb['fitness']:.6f} < {lb['threshold']}",
                )
                if tk.key not in seen:
                    seen.add(tk.key)
                    tickets.append(tk)
        return tickets

    def run(self) -> list[RepairReport]:
        """Poll once and repair every finding; corruption first (a refit
        should not train on values decoded through a corrupt chunk)."""
        tickets = sorted(self.poll(), key=lambda t: t.kind != "corruption")
        return [self.repair(t) for t in tickets]

    def repair(self, ticket: RepairTicket) -> RepairReport:
        if ticket.kind == "corruption":
            report = self.repair_corruption(ticket.payload, ticket.chunk)
        elif ticket.kind == "quality":
            report = self.repair_quality(
                ticket.payload, ticket.entry_start, ticket.entry_stop
            )
        else:
            raise ValueError(f"unknown repair kind {ticket.kind!r}")
        return report

    # ------------------------------------------------------------ corruption
    def repair_corruption(self, name: str, chunk: int) -> RepairReport:
        """Restore one chunk byte-exactly from a donor replica and swap
        the repaired file in through an epoch switch."""
        t0 = time.perf_counter()
        path, _tile_entries = self.fleet.path_of(name)
        report = RepairReport(name, "corruption")
        obs.emit_event(
            "repair_started", payload=name, repair_kind="corruption",
            chunk=int(chunk), path=path,
        )
        with obs.span("repair.corruption", payload=name, chunk=int(chunk)):
            raw, donor = self._export_from_donor(name, chunk)
            if raw is None:
                return self._fail(
                    report, t0,
                    f"chunk {chunk}: no live replica could vouch for the bytes",
                )
            # epoch switch: resolve in-flight tickets under the old epoch,
            # rewrite in place (same length -> footer byte-identical),
            # then fan the re-open to every member
            self.fleet.drain()
            try:
                rewrite_chunks(path, {int(chunk): raw})
            except (OSError, ValueError) as e:
                return self._fail(report, t0, f"rewrite failed: {e}")
            self.fleet.refresh(name)
            report.chunks_restored = [int(chunk)]
            report.donors = {int(chunk): donor}
            route = self.fleet.routes.get(name)
            if route is not None and route.versioned:
                health = revalidate_chains(path)
                report.chains_revalidated = len(health)
                bad = [h for h in health if not h.ok]
                if bad:
                    return self._fail(
                        report, t0,
                        f"post-restore chain validation failed: {bad[0].error}",
                    )
        return self._complete(report, t0)

    def _export_from_donor(self, name: str, chunk: int) -> tuple[bytes | None, str]:
        """First live member that can CRC-vouch for the chunk's bytes wins
        (export_chunk returns None when an instance cannot: quarantined
        there too, unowned, or its re-serialization fails the footer CRC)."""
        for iid, t in self.fleet.transports.items():
            if iid in self.fleet.excluded:
                continue
            try:
                raw = t.export_chunk(name, int(chunk))
            except TransportError as e:
                self.fleet.exclude(iid, e)
                continue
            if raw is not None:
                return raw, iid
        return None, ""

    # --------------------------------------------------------------- quality
    def repair_quality(self, name: str, entry_start: int, entry_stop: int) -> RepairReport:
        """Re-compress the breached flat-entry range online and land it as
        a patch overlay; see the module docstring for the data flow."""
        t0 = time.perf_counter()
        cfg = self.config
        path, _tile_entries = self.fleet.path_of(name)
        route = self.fleet.routes[name]
        lo, hi = int(entry_start), int(entry_stop)
        n_entries = int(np.prod(route.shape))
        hi = min(hi, n_entries)
        report = RepairReport(name, "quality", ok=False, entry_start=lo, entry_stop=hi)
        if route.versioned:
            return self._fail(
                report, t0, "quality repair of versioned payloads not supported"
            )
        if not 0 <= lo < hi:
            return self._fail(report, t0, f"bad entry range [{lo}, {hi})")
        if hi - lo > cfg.max_patch_entries:
            return self._fail(
                report, t0,
                f"range of {hi - lo} entries exceeds max_patch_entries="
                f"{cfg.max_patch_entries}",
            )
        obs.emit_event(
            "repair_started", payload=name, repair_kind="quality",
            entry_start=lo, entry_stop=hi, path=path,
        )
        with obs.span("repair.quality", payload=name, entries=hi - lo):
            # 1. densify the range from the payload's own served decode —
            # the fleet keeps serving; this is just a (big) query
            idx = flat_to_multi(np.arange(lo, hi, dtype=np.int64), route.shape)
            try:
                target = np.asarray(
                    self.fleet.decode_at(name, idx), dtype=np.float64
                ).copy()
            except (KeyError, ValueError, TransportError) as e:
                return self._fail(report, t0, f"densify failed: {e}")

            # 2. overlay held-out ground truth (TCDQ) inside the range,
            # and measure the degraded payload's fitness on that sample
            h_idx, h_vals = self._heldout_in_range(path, lo, hi)
            if len(h_idx):
                report.fitness_before = _fitness(h_vals, target[h_idx - lo])
                target[h_idx - lo] = h_vals

            # 3. warm refit: NTTD stream fitter over the densified range
            sub_shape = _range_shape(hi - lo)
            enc, entries_seen = self._refit(target.reshape(sub_shape))
            report.refit_entries = entries_seen

            # 4. fitness gate on the held-out sample
            if len(h_idx):
                local = flat_to_multi(h_idx - lo, sub_shape)
                report.fitness_after = _fitness(
                    h_vals, np.asarray(enc.decode_at(local), dtype=np.float64)
                )
                if report.fitness_after < report.fitness_before + cfg.min_fitness_gain:
                    return self._fail(
                        report, t0,
                        f"refit fitness {report.fitness_after:.6f} did not beat "
                        f"degraded fitness {report.fitness_before:.6f} "
                        f"(min_fitness_gain={cfg.min_fitness_gain})",
                    )

            # 5. epoch switch: append the patch overlay, fan the re-open
            self.fleet.drain()
            try:
                append_patch(
                    path, enc.to_bytes(), (lo, hi), cfg.codec,
                    chunk_bytes=cfg.chunk_bytes,
                )
            except (OSError, ValueError) as e:
                return self._fail(report, t0, f"append_patch failed: {e}")
            self.fleet.refresh(name)
        return self._complete(report, t0)

    def _heldout_in_range(self, path: str, lo: int, hi: int):
        """(flat indices, float64 truth) of the container's held-out
        sample falling inside [lo, hi) — empty arrays when the file was
        written without a TCDQ block."""
        oc = container.open_container(path)
        try:
            if oc.heldout is None or not len(oc.heldout):
                return np.empty(0, np.int64), np.empty(0, np.float64)
            sel = (oc.heldout.indices >= lo) & (oc.heldout.indices < hi)
            return oc.heldout.indices[sel].copy(), oc.heldout.values[sel].copy()
        finally:
            oc.close()

    def _refit(self, sub: np.ndarray):
        """Drive the codec's stream fitter over the densified range for
        ``passes`` epochs, optionally refining TSP mode orders mid-stream
        from the fitter's reservoir sample."""
        cfg = self.config
        opts = {"device": self.device, **cfg.refit_opts}
        fitter = get_codec(cfg.codec).stream_fitter(sub.shape, None, **opts)
        flat = sub.astype(np.float32).ravel()
        n = len(flat)
        for p in range(max(cfg.passes, 1)):
            for s in range(0, n, cfg.slab_entries):
                stop = min(s + cfg.slab_entries, n)
                fitter.update(
                    flat_to_multi(np.arange(s, stop, dtype=np.int64), sub.shape),
                    flat[s:stop],
                )
            if (
                cfg.reorder
                and p + 1 == cfg.reorder_after
                and hasattr(fitter, "refine_orders")
            ):
                fitter.refine_orders()
        return fitter.finalize(), int(getattr(fitter, "entries_seen", 0))

    # ------------------------------------------------------------- reporting
    def _complete(self, report: RepairReport, t0: float) -> RepairReport:
        report.ok = True
        report.elapsed_s = time.perf_counter() - t0
        if report.refit_entries and report.elapsed_s > 0:
            report.refit_entries_per_sec = report.refit_entries / report.elapsed_s
        self._record(report, "repair_completed")
        return report

    def _fail(self, report: RepairReport, t0: float, error: str) -> RepairReport:
        report.ok = False
        report.error = error
        report.elapsed_s = time.perf_counter() - t0
        self._record(report, "repair_failed")
        return report

    def _record(self, report: RepairReport, event: str) -> None:
        self.reports.append(report)
        m = self.fleet.metrics
        m.counter(
            "repairs_total", payload=report.payload, kind=report.kind,
            outcome="ok" if report.ok else "failed",
        ).inc()
        m.histogram("repair_seconds", kind=report.kind).observe(report.elapsed_s)
        if report.refit_entries_per_sec is not None:
            m.gauge("repair_refit_entries_per_sec", payload=report.payload).set(
                report.refit_entries_per_sec
            )
        obs.emit_event(
            event,
            payload=report.payload,
            repair_kind=report.kind,
            chunks_restored=list(report.chunks_restored),
            entry_start=report.entry_start,
            entry_stop=report.entry_stop,
            fitness_before=report.fitness_before,
            fitness_after=report.fitness_after,
            time_to_repair_s=report.elapsed_s,
            refit_entries_per_sec=report.refit_entries_per_sec,
            error=report.error,
        )

    # ---------------------------------------------------------------- lookup
    def _chunk_entry_range(self, name: str, chunk: int):
        """Flat-entry range the footer records for a chunk (None, None when
        unrecorded — monolithic v3 files, version component chunks)."""
        try:
            path, _ = self.fleet.path_of(name)
            _codec, chunks, _versions = container.container_index(path)
        except (KeyError, OSError, ValueError):
            return None, None
        if not 0 <= chunk < len(chunks):
            return None, None
        c = chunks[chunk]
        return c.entry_start, c.entry_stop


def _range_shape(n: int) -> tuple[int, ...]:
    """Factor an entry count into <= 3 roughly balanced modes — the refit
    tensor's shape.  A low-TT-rank structure in the flat range survives
    any row-major reshape of the same flat order; balance keeps the NTTD
    folding well-conditioned.  Falls back to fewer modes (worst case 1-D,
    n prime) when n has no nearby divisors."""
    if n <= 1:
        return (max(n, 1),)
    a = _nearest_divisor(n, round(n ** (1 / 3)))
    m = n // a
    b = _nearest_divisor(m, round(m ** 0.5))
    dims = tuple(sorted((a, b, m // b), reverse=True))
    return tuple(d for d in dims if d > 1) or (n,)


def _nearest_divisor(n: int, target: int) -> int:
    target = max(min(int(target), n), 1)
    for delta in range(n):
        for cand in (target - delta, target + delta):
            if 1 <= cand <= n and n % cand == 0:
                return cand
    return 1
