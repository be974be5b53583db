"""``repro_torch.fleet.controller`` against the JAX package's
``repro.fleet.controller``, on the CPU.

The reference's recorded-fixture drills (``tests/test_controller.py``:
sustained breach, a spike resetting the streak, the hysteresis band, idle
scale-down and the floor, a stale latency window, the flap guard, the
ceiling, the quality objective) run through both packages'
``ScalingPolicy``; every decision (action, reason and SLO edge events)
must be equal.  A ``FleetController`` then drives real ``rebalance`` calls
on a port fleet and a reference fleet from the same samples: the same
decisions, the same members, the same ``controller_decision`` events,
and answers bitwise equal to the fleet's first.
"""
import numpy as np
import pytest

from repro import fleet as jfleet
from repro import obs as jobs
from repro.codecs import get_codec
from repro_torch import fleet as tfleet
from repro_torch import obs as tobs
from repro_torch.stream import write_chunked

PKGS = {"port": (tfleet, tobs), "reference": (jfleet, jobs)}
CFG = dict(p99_target_ms=5.0, p99_clear_ms=4.0, breach_evals=3, clear_evals=2,
           idle_flushes_per_eval=1.0, idle_evals=3, cooldown_evals=2,
           min_instances=1, max_instances=4)


def _sample(p99, flushes, instances=2, **extra):
    return {"decode_p99_ms": p99, "flushes_total": flushes, "instances": instances, **extra}


def _noisy(seed=0, n=60):
    rng = np.random.default_rng(seed)
    flushes, rows = 0, []
    for _ in range(n):
        flushes += int(rng.integers(1, 5))
        rows.append(_sample(float(rng.choice([3.0, 4.5, 6.0])), flushes))
    return rows


FIXTURES = {
    "sustained_breach": (CFG, [_sample(9.0, 10 * (t + 1)) for t in range(5)]),
    "spike_resets": (CFG, [_sample(9.0, 10), _sample(9.0, 20), _sample(3.0, 30),
                           _sample(9.0, 40), _sample(9.0, 50), _sample(9.0, 60)]),
    "hysteresis_band": (CFG, [_sample(v, 10 * (t + 1)) for t, v in
                              enumerate([4.5, 4.9, 4.2, 4.8, 4.6, 4.9, 4.4, 4.7])]),
    "idle_scale_down": (CFG, [_sample(2.0, 100)] * 4),
    "idle_at_floor": (CFG, [_sample(2.0, 100, instances=1)] * 8),
    "stale_latency": (CFG, [_sample(9.0, 10 * (t + 1)) for t in range(3)]
                      + [_sample(9.0, 30)] * 6),
    "flap_guard": (CFG, _noisy()),
    "max_instances": (CFG, [_sample(9.0, 10 * (t + 1), instances=4) for t in range(6)]
                      + [_sample(9.0, 999, instances=4)]),
    "quality": (dict(p99_target_ms=5.0, min_fitness=0.9, breach_evals=1, clear_evals=1),
                [_sample(1.0, 10, **{"canary_fitness.e": 0.5}),
                 _sample(1.0, 20, **{"canary_fitness.e": 0.95}),
                 _sample(1.0, 30, **{"canary_fitness.e": 0.2, "canary_fitness.f": 0.1})]),
}


def _decisions(mod, cfg, rows):
    policy = mod.ScalingPolicy(mod.ControllerConfig(**cfg))
    out = []
    for t, s in enumerate(rows):
        d = policy.observe(s, now=float(t))
        out.append((d.action, d.reason, [e.as_dict() for e in d.events]))
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_recorded_fixture_gives_the_reference_decisions(name):
    cfg, rows = FIXTURES[name]
    port = _decisions(tfleet, cfg, rows)
    assert port == _decisions(jfleet, cfg, rows)
    actions = [a for a, _, _ in port]
    # the reference's own assertions on the same drills
    if name == "sustained_breach":
        assert actions == ["hold", "hold", "scale_up", "hold", "hold"]
    elif name == "spike_resets":
        assert actions == ["hold"] * 5 + ["scale_up"]
    elif name == "idle_scale_down":
        assert actions == ["hold", "hold", "hold", "scale_down"]
    elif name == "stale_latency":
        assert "scale_up" not in actions[3:] and "scale_down" in actions[3:]
    elif name == "max_instances":
        assert "scale_up" not in actions and "max_instances" in port[-1][1]
    elif name == "quality":
        assert port[0][2][0]["slo"] == "quality" and set(actions) == {"hold"}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_config_validation(pkg):
    mod = PKGS[pkg][0]
    with pytest.raises(ValueError, match="p99_target_ms"):
        mod.ControllerConfig(p99_target_ms=0.0)
    with pytest.raises(ValueError, match="min_instances"):
        mod.ControllerConfig(p99_target_ms=1.0, min_instances=5, max_instances=2)
    assert mod.ControllerConfig(p99_target_ms=10.0).clear_ms == pytest.approx(8.0)


# ---------------------------------------------------------------------------
# FleetController on live fleets of both packages
# ---------------------------------------------------------------------------
SHAPE = (16, 16, 8)


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    path = str(tmp_path_factory.mktemp("controller") / "p.tcdc")
    write_chunked(path, get_codec("ttd").fit(x, max_rank=4), chunk_bytes=1024)
    return path


def _query(n=50, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in SHAPE], axis=1)


def _fleet(pkg, n, **kw):
    mod = PKGS[pkg][0]
    if pkg == "port":
        kw["device"] = "cpu"
    return mod.FleetFrontend(n, cache_bytes=1 << 22, **kw)


def _drive(pkg, path):
    """The reference's integration drill: breach -> admit s0 -> idle ->
    retire s0, answers held against the fleet's first."""
    mod, ob = PKGS[pkg]
    fleet = _fleet(pkg, 2)
    ctl = mod.FleetController(fleet, mod.ControllerConfig(
        p99_target_ms=5.0, breach_evals=2, clear_evals=1, idle_evals=2, cooldown_evals=1,
        min_instances=2, max_instances=3))
    trail = []
    try:
        fleet.load_stream("e", path, tile_entries=256)
        answers = [fleet.decode_at("e", _query())]
        ob.clear_events()
        for s in [_sample(9.0, 10), _sample(9.0, 20), _sample(3.0, 30, instances=3),
                  _sample(3.0, 40, instances=3), _sample(3.0, 40, instances=3),
                  _sample(3.0, 40, instances=3)]:
            d = ctl.step(s)
            trail.append((d.action, d.reason, sorted(fleet.transports), list(ctl.admitted)))
            answers.append(fleet.decode_at("e", _query()))
        assert not fleet.failed
        events = [{k: v for k, v in e.items() if k != "t"}
                  for e in ob.events("controller_decision")]
        sample = ctl.sample()
        return trail, answers, events, sample
    finally:
        fleet.close()


def test_controller_drives_real_rebalance_as_the_reference(payload):
    port = _drive("port", payload)
    ref = _drive("reference", payload)
    trail, answers, events, sample = port
    assert trail == ref[0] and events == ref[2]
    assert [t[0] for t in trail].count("scale_up") == 1
    assert [t[0] for t in trail].count("scale_down") == 1
    assert "s0" not in trail[-1][2] and trail[-1][3] == []
    for got, want in zip(answers, ref[1]):
        assert np.array_equal(got, answers[0]) and np.array_equal(got, want)
    keys = ("instances", "flushes_total", "excluded_total", "backpressure_flushes")
    assert {k: sample[k] for k in keys} == {k: ref[3][k] for k in keys}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_collect_excluded_total_and_victim(payload, pkg):
    mod = PKGS[pkg][0]
    fleet = _fleet(pkg, 3)
    try:
        fleet.load_stream("e", payload, tile_entries=256)
        fleet.decode_at("e", _query())
        m1 = mod.collect(fleet)
        victim = sorted(fleet.transports)[-1]

        def boom(*a, **kw):
            raise mod.TransportError("stats down")

        fleet.transports[victim].stats = boom
        m2 = mod.collect(fleet)
        assert victim in m2.excluded and m2.excluded_total == 1
        assert m2.collected_at > m1.collected_at
        ctl = mod.FleetController(fleet, mod.ControllerConfig(p99_target_ms=5.0))
        assert ctl._victim() == victim  # a dead member outranks LIFO
        mod.rebalance(fleet, remove=[victim], warm=False)
        m3 = mod.collect(fleet)
        assert m3.excluded == [] and m3.excluded_total == 1
    finally:
        fleet.close()
