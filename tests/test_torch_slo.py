"""``repro_torch.obs.slo`` against the JAX package's ``repro.obs.slo``.

The engine is pure (no clock, no I/O, no device): the reference's SLO
cases (``tests/test_slo.py``: streaks, hysteresis, ``None`` skips,
wildcards, burn rate, spec validation, the fleet-snapshot flattening) run
through both packages on the same samples, and the edge events, open
breaches and burn rates must be equal.
"""
import numpy as np
import pytest

from repro.obs import slo as jslo
from repro_torch.obs import slo as tslo

PKGS = {"port": tslo, "reference": jslo}


def _run(mod, specs, samples):
    """Feed every sample to a fresh engine -> (events per sample as dicts,
    open breaches, burn rate per (spec, key) seen)."""
    eng = mod.SLOEngine([mod.SLOSpec(**s) for s in specs])
    events = [[e.as_dict() for e in eng.evaluate(s, now=float(t))]
              for t, s in enumerate(samples)]
    keys = sorted({(s["name"], k) for s in specs for smp in samples for k in smp})
    burn = {f"{n}/{k}": eng.burn_rate(n, k) for n, k in keys}
    return events, eng.breached(), burn, {s["name"]: eng.is_breached(s["name"]) for s in specs}


def _seq(key, values):
    return [{key: v} for v in values]


CASES = {
    # the 4.0 resets the streak; the breach opens on the 3rd of the new run
    "streak": ([dict(name="lat", metric="p99", target=5.0, breach_for=3)],
               _seq("p99", [6.0, 6.0, 4.0, 6.0, 6.0, 6.0, 6.0])),
    # in-band values hold the breach; a band value resets the good streak
    "hysteresis": ([dict(name="lat", metric="p99", target=5.0, clear=4.0, breach_for=2,
                         clear_for=2)],
                   _seq("p99", [6.0, 6.0, 4.5, 4.8, 4.2, 4.9, 3.0, 4.5, 3.0, 3.0])),
    "none_skipped": ([dict(name="lat", metric="p99", target=5.0, breach_for=2)],
                     _seq("p99", [6.0, None, 6.0])),
    "wildcard": ([dict(name="fit", metric="canary_fitness.*", target=0.9, op=">=")],
                 [{"canary_fitness.a": 0.5, "canary_fitness.b": 0.95},
                  {"canary_fitness.a": 0.97, "canary_fitness.b": 0.2},
                  {"canary_fitness.a": 0.99, "other": 1.0}]),
    "burn_rate": ([dict(name="lat", metric="p99", target=5.0, window=4)],
                  _seq("p99", [6.0, 3.0, 6.0, 6.0])),
    "two_specs": ([dict(name="lat", metric="decode_p99_ms", target=5.0, clear=4.0,
                        breach_for=2, clear_for=1),
                   dict(name="q", metric="canary_fitness.*", target=0.9, op=">=",
                        breach_for=1, clear_for=2)],
                  [{"decode_p99_ms": v, "canary_fitness.e": f}
                   for v, f in [(6, 0.5), (7, 0.95), (3, 0.95), (9, 0.4), (9, None)]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_cases_give_the_reference_events(case):
    specs, samples = CASES[case]
    assert _run(tslo, specs, samples) == _run(jslo, specs, samples)


def test_random_walks_give_the_reference_events():
    rng = np.random.default_rng(0)
    specs = [dict(name="lat", metric="p99", target=5.0, clear=4.0, breach_for=3, clear_for=2),
             dict(name="fit", metric="fit.*", target=0.9, clear=0.95, op=">=", breach_for=2)]
    samples = [{"p99": float(rng.choice([3.0, 4.5, 6.0])),
                "fit.a": float(rng.uniform(0.8, 1.0)),
                "fit.b": None if rng.random() < 0.2 else float(rng.uniform(0.85, 1.0))}
               for _ in range(200)]
    port = _run(tslo, specs, samples)
    assert port == _run(jslo, specs, samples)
    assert any(port[0])  # the walk opened and closed breaches


def test_the_reference_assertions_hold_on_the_port():
    events, breached, burn, _ = _run(tslo, *CASES["streak"])
    assert [len(e) for e in events] == [0, 0, 0, 0, 0, 1, 0]
    assert events[5][0]["kind"] == "breach_start" and events[5][0]["at"] == 5.0
    assert breached == [("lat", "p99")]
    events, _, _, state = _run(tslo, *CASES["hysteresis"])
    assert [len(e) for e in events[6:]] == [0, 0, 0, 1] and not state["lat"]
    assert _run(tslo, *CASES["burn_rate"])[2]["lat/p99"] == pytest.approx(0.75)


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("kwargs,match", [
    (dict(target=1.0, op="=="), "op"),
    (dict(target=5.0, clear=6.0), "looser"),
    (dict(target=0.9, clear=0.8, op=">="), "looser"),
    (dict(target=1.0, breach_for=0), "breach_for"),
])
def test_spec_validation(pkg, kwargs, match):
    with pytest.raises(ValueError, match=match):
        PKGS[pkg].SLOSpec("x", "m", **kwargs)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_duplicate_names_rejected(pkg):
    mod = PKGS[pkg]
    with pytest.raises(ValueError, match="duplicate"):
        mod.SLOEngine([mod.SLOSpec("a", "m", target=1.0), mod.SLOSpec("a", "n", target=1.0)])


def test_fleet_slo_sample_matches_the_reference():
    snap = {
        "decode_p50_ms": 1.0, "decode_p99_ms": 4.0,
        "excluded": ["i1"], "excluded_total": 2, "backpressure_flushes": 3,
        "instances": {"i0": {"cache": {"hit_rate": 0.5}, "flushes": 7},
                      "i1": {"cache": {}, "flushes": 0}},
        "canary": {"embed": {"rolling_fitness": 0.97}},
    }

    class AsDict:
        def as_dict(self):
            return snap

    for src in (snap, AsDict()):
        for extra in (None, {"q": 1}):
            got = tslo.fleet_slo_sample(src, extra=extra)
            assert got == jslo.fleet_slo_sample(src, extra=extra)
    s = tslo.fleet_slo_sample(snap)
    assert s["instances"] == 2 and s["flushes_total"] == 7
    assert s["hit_rate.i1"] is None and s["canary_fitness.embed"] == 0.97
    # the excluded count falls back to the list's length
    bare = {k: v for k, v in snap.items() if k != "excluded_total"}
    assert tslo.fleet_slo_sample(bare)["excluded_total"] == 1
