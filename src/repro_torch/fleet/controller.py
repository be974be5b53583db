"""Metrics-driven elastic scaling, as in ``repro.fleet.controller``.

The fleet metrics registry serves the signal; this module closes the loop.
A :class:`ScalingPolicy` is PURE decision logic over flat metric samples
(the ``repro_torch.obs.slo.fleet_slo_sample`` key space) — an
:class:`~repro_torch.obs.slo.SLOEngine` holds the latency objective (and an
optional per-payload canary-fitness objective), and the policy layers the
scaling-specific state on top:

- **scale up** when the p99 latency breach is SUSTAINED (``breach_evals``
  consecutive evaluations over target) and traffic is live;
- **scale down** when the fleet is idle (fewer than
  ``idle_flushes_per_eval`` new flushes per evaluation, ``idle_evals``
  times in a row) and above ``min_instances``;
- **hold** otherwise — including a ``cooldown_evals``-long cooldown after
  every action (the flap guard: a noisy signal can never oscillate
  add/remove faster than one action per cooldown), and whenever the
  latency sample is STALE (zero new flushes since the last evaluation
  repeat the same window percentile forever, so the policy blanks the
  latency key rather than let a frozen breach pin the engine — which is
  also what lets an idle fleet scale down while a breach is nominally
  open).

Being pure, the policy is testable over recorded fixtures — no sleeps,
no sockets (``tests/test_torch_controller.py``).

:class:`FleetController` binds a policy to a live
:class:`~repro_torch.fleet.frontend.FleetFrontend`: each ``step()`` polls
``collect()``, asks the policy, and applies the decision through the
existing :func:`~repro_torch.fleet.rebalance.rebalance` — the drain barrier and
warm tile handoff are what make both directions zero-downtime.  Every
decision is emitted as a span (``controller.step`` /
``controller.scale_up`` / ``controller.scale_down``) and an
``obs.emit_event`` record, so drills show up in ``obs.report`` output.

    ctl = FleetController(fleet, ControllerConfig(p99_target_ms=5.0))
    ctl.run(steps=30, interval_s=1.0)     # or ctl.step() in your own loop
"""
from __future__ import annotations

import dataclasses
import itertools
import time

from repro_torch import obs
from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.metrics import collect
from repro_torch.fleet.rebalance import rebalance
from repro_torch.obs.slo import SLOEngine, SLOEvent, SLOSpec, fleet_slo_sample


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    #: fleet decode_p99_ms objective (window-exact, pooled across members)
    p99_target_ms: float
    #: hysteresis clear threshold; default 0.8 x target
    p99_clear_ms: float | None = None
    breach_evals: int = 3
    clear_evals: int = 2
    #: traffic floor: fewer NEW flushes than this per evaluation = idle
    idle_flushes_per_eval: float = 1.0
    idle_evals: int = 5
    #: evaluations to hold after any action (flap guard)
    cooldown_evals: int = 3
    min_instances: int = 1
    max_instances: int = 8
    #: optional per-payload canary-fitness objective (breaches are
    #: surfaced as events; quality is a repair trigger, not a scale axis)
    min_fitness: float | None = None

    def __post_init__(self):
        if self.p99_target_ms <= 0:
            raise ValueError(f"p99_target_ms must be > 0, got {self.p99_target_ms}")
        if not 1 <= self.min_instances <= self.max_instances:
            raise ValueError(
                f"need 1 <= min_instances <= max_instances, got "
                f"[{self.min_instances}, {self.max_instances}]"
            )

    @property
    def clear_ms(self) -> float:
        return (
            self.p99_clear_ms
            if self.p99_clear_ms is not None
            else 0.8 * self.p99_target_ms
        )


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str  # "scale_up" | "scale_down" | "hold"
    reason: str
    #: SLO edge events from this evaluation (breach_start / breach_end)
    events: tuple[SLOEvent, ...] = ()


class ScalingPolicy:
    """Pure scaling decisions over metric samples; see module docstring."""

    def __init__(self, config: ControllerConfig):
        self.config = config
        specs = [
            SLOSpec(
                "latency", "decode_p99_ms",
                target=config.p99_target_ms, clear=config.clear_ms,
                breach_for=config.breach_evals, clear_for=config.clear_evals,
            ),
        ]
        if config.min_fitness is not None:
            specs.append(SLOSpec(
                "quality", "canary_fitness.*",
                target=config.min_fitness, op=">=",
                breach_for=config.breach_evals, clear_for=config.clear_evals,
            ))
        self.engine = SLOEngine(specs)
        self._last_flushes: int | None = None
        self._idle_streak = 0
        self._cooldown = 0

    def observe(self, sample: dict, now: float = 0.0) -> Decision:
        """Feed one metric sample; returns the decision for this tick."""
        cfg = self.config
        n = int(sample.get("instances") or 0)
        flushes = int(sample.get("flushes_total") or 0)
        first = self._last_flushes is None
        delta = 0 if first else max(flushes - self._last_flushes, 0)
        self._last_flushes = flushes
        idle = not first and delta < cfg.idle_flushes_per_eval
        if idle:
            self._idle_streak += 1
            # zero new flushes = the latency window is STALE; blank it so
            # a frozen percentile can neither open nor sustain a breach
            sample = dict(sample, decode_p99_ms=None)
        else:
            self._idle_streak = 0
        events = tuple(self.engine.evaluate(sample, now))
        if self._cooldown > 0:
            self._cooldown -= 1
            return Decision("hold", f"cooldown ({self._cooldown + 1} left)", events)
        if self.engine.is_breached("latency") and not idle:
            if n >= cfg.max_instances:
                return Decision(
                    "hold",
                    f"p99 breach but at max_instances={cfg.max_instances}",
                    events,
                )
            self._cooldown = cfg.cooldown_evals
            self._idle_streak = 0
            return Decision(
                "scale_up",
                f"decode_p99_ms over {cfg.p99_target_ms}ms for "
                f">={cfg.breach_evals} evals",
                events,
            )
        if self._idle_streak >= cfg.idle_evals:
            if n <= cfg.min_instances:
                return Decision(
                    "hold",
                    f"idle but at min_instances={cfg.min_instances}",
                    events,
                )
            self._cooldown = cfg.cooldown_evals
            self._idle_streak = 0
            return Decision(
                "scale_down",
                f"<{cfg.idle_flushes_per_eval} flushes/eval for "
                f">={cfg.idle_evals} evals",
                events,
            )
        return Decision("hold", "within slo", events)


class FleetController:
    """Bind a :class:`ScalingPolicy` to a live fleet.  ``step()`` =
    poll ``collect()`` -> decide -> apply via ``rebalance``."""

    def __init__(
        self,
        fleet: FleetFrontend,
        config: ControllerConfig,
        *,
        standby_prefix: str = "s",
    ):
        self.fleet = fleet
        self.config = config
        self.policy = ScalingPolicy(config)
        self.standby_prefix = standby_prefix
        #: instances THIS controller admitted, newest last — preferred
        #: scale-down victims (LIFO), after dead members
        self.admitted: list[str] = []
        self.decisions: list[Decision] = []

    def sample(self) -> dict:
        return fleet_slo_sample(collect(self.fleet))

    def _next_standby(self) -> str:
        for k in itertools.count():
            iid = f"{self.standby_prefix}{k}"
            if iid not in self.fleet.transports:
                return iid
        raise AssertionError("unreachable")

    def _victim(self) -> str:
        # a dead member is always the best thing to retire
        for iid in sorted(self.fleet.excluded):
            if iid in self.fleet.transports:
                return iid
        for iid in reversed(self.admitted):
            if iid in self.fleet.transports:
                return iid
        return sorted(self.fleet.transports)[-1]

    def step(self, sample: dict | None = None) -> Decision:
        """One control tick; returns (and records) the decision made."""
        with obs.span("controller.step"):
            if sample is None:
                sample = self.sample()
            decision = self.policy.observe(sample, now=time.monotonic())
            if decision.action == "scale_up":
                iid = self._next_standby()
                with obs.span("controller.scale_up", instance=iid):
                    rebalance(self.fleet, add=[iid])
                self.admitted.append(iid)
            elif decision.action == "scale_down":
                iid = self._victim()
                with obs.span("controller.scale_down", instance=iid):
                    rebalance(self.fleet, remove=[iid])
                if iid in self.admitted:
                    self.admitted.remove(iid)
            else:
                iid = None
            for ev in decision.events:
                fields = ev.as_dict()
                obs.emit_event(f"slo_{fields.pop('kind')}", **fields)
            obs.emit_event(
                "controller_decision",
                action=decision.action,
                reason=decision.reason,
                instance=iid,
                instances=len(self.fleet.transports),
            )
        self.decisions.append(decision)
        return decision

    def run(self, steps: int, interval_s: float = 0.0) -> list[Decision]:
        """Run ``steps`` ticks (sleeping ``interval_s`` between them);
        returns their decisions."""
        out = []
        for k in range(steps):
            out.append(self.step())
            if interval_s and k + 1 < steps:
                time.sleep(interval_s)
        return out
