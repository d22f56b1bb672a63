"""The port's SLO engine (knn_tpu_torch.obs.slo) against the JAX package's
(knn_tpu.obs.slo) on the same scripted counter and histogram sequences,
under one injected clock.

What is held equal: every ``evaluate()`` report (burn rates, actual spans,
confirmability, breached lists, the grouped ``<name>:<tenant>`` keys) but
``evaluated_at`` and a quantile's ``window_span_s`` (the wall span of the
histogram's own monotonic stamps, a real clock in each package); the
``slo.alert`` events (exactly one firing and one resolved a transition);
the gauges and transition counters; the files ``load_objectives`` refuses
and the objectives it loads; ``evaluate_fleet`` and ``FleetSLOEngine``.
Plus the port's counterparts of tests/test_admission.py:374 (a grouped
ratio fires per tenant) and :419 (a grouped quantile), and its own knobs:
windows as arguments.
"""

import json

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.obs import slo as jslo
from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.obs import slo

PKGS = {"port": (obs, slo), "jax": (jobs, jslo)}


def _reset_all():
    for pkg, _ in PKGS.values():
        pkg.reset(enabled=True)
        pkg.reset_event_log(None)
        pkg.reset_slo_engine()
        pkg.health.reset()


@pytest.fixture(autouse=True)
def _fresh():
    _reset_all()
    yield
    obs.reset()
    obs.reset_event_log()
    obs.reset_slo_engine()
    obs.health.reset()
    jobs.reset()
    jobs.reset_event_log(from_env=True)
    jobs.reset_slo_engine()
    jobs.health.reset()


def _strip(report):
    """A report without its wall-clock fields."""
    if isinstance(report, dict):
        return {k: _strip(v) for k, v in report.items()
                if k not in ("evaluated_at", "window_span_s")}
    return report


def _alerts(pkg):
    return [(e["objective"], e["state"], e.get("tenant"))
            for e in pkg.get_event_log().recent()
            if e.get("name") == "slo.alert"]


def _script(rng):
    """(now, {(kind, name, labels-tuple): amount or [observations]}) steps
    drawn once from ``rng``: serving traffic with an error burst, certified
    queries with fallbacks, per-tenant requests / errors / latencies and
    audited queries with deficient ones."""
    steps = []
    t = 0.0
    for j in range(14):
        t += float(rng.choice([7.5, 20.0, 45.0, 90.0, 240.0]))
        ops = {}
        req = int(rng.integers(50, 400))
        burst = 4 <= j <= 7
        ops[("counter", mn.SERVING_REQUESTS, (("op", "search"),))] = req
        ops[("counter", mn.SERVING_ERRORS, (("op", "search"),))] = (
            int(req * 0.2) if burst else int(rng.integers(0, 2)))
        cq = int(rng.integers(100, 1000))
        ops[("counter", mn.CERTIFIED_QUERIES, (("selector", "pallas"),))] = cq
        ops[("counter", mn.CERTIFIED_FALLBACKS, (("selector", "pallas"),))] = (
            int(cq * rng.uniform(0.0, 0.6)))
        for tenant in ("acme", "zeta"):
            n = int(rng.integers(10, 80))
            ops[("counter", mn.TENANT_REQUESTS, (("tenant", tenant),))] = n
            bad = burst and tenant == "acme"
            ops[("counter", mn.TENANT_ERRORS, (("tenant", tenant),))] = (
                n // 2 if bad else 0)
            ops[("counter", mn.AUDIT_REPLAYED, (("tenant", tenant),))] = n
            if tenant == "zeta" and 6 <= j <= 9:
                ops[("counter", mn.AUDIT_DEFICIENT, (("tenant", tenant),))] = n
            ops[("histogram", mn.TENANT_REQUEST_LATENCY,
                 (("tenant", tenant),))] = (
                rng.uniform(0.5, 3.0, 5) if bad else
                rng.uniform(0.001, 0.05, 5)).tolist()
        ops[("histogram", mn.SERVING_REQUEST_LATENCY, (("op", "search"),))] = (
            rng.uniform(0.001, 0.02, 8).tolist())
        ops[("histogram", mn.QUEUE_WAIT, ())] = (
            rng.uniform(0.0, 0.3 if burst else 0.01, 6).tolist())
        steps.append((t, ops))
    return steps


def _apply(pkg, ops):
    for (kind, name, labels), value in ops.items():
        if kind == "counter":
            if value:
                pkg.counter(name, **dict(labels)).inc(value)
        else:
            pkg.histogram(name, **dict(labels)).observe_many(value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_reports_equal_jax(seed):
    steps = _script(np.random.default_rng(seed))
    reports = {}
    for side, (pkg, mod) in PKGS.items():
        eng = mod.SLOEngine(windows=(("fast", 60.0), ("slow", 600.0)),
                            clock=lambda: 0.0)
        out = [_strip(eng.evaluate(now=0.0))]
        for now, ops in steps:
            _apply(pkg, ops)
            out.append(_strip(eng.evaluate(now=now)))
        reports[side] = {"reports": out, "alerts": _alerts(pkg),
                         "breaches": eng.active_breaches(),
                         "snap": pkg.snapshot()}
    port, jax_ = reports["port"], reports["jax"]
    assert port["reports"] == jax_["reports"]
    assert port["alerts"] == jax_["alerts"]
    assert port["breaches"] == jax_["breaches"]
    for name in (mn.SLO_BURN_RATE, mn.SLO_BREACHED,
                 mn.SLO_BREACH_TRANSITIONS, mn.SLO_EVALUATIONS):
        assert port["snap"][name] == jax_["snap"][name], name
    # the script breaches: each transition alerts exactly once
    fired = [a for a in port["alerts"] if a[1] == "firing"]
    assert fired
    for objective, _, _ in fired:
        states = [a[1] for a in port["alerts"] if a[0] == objective]
        assert all(x != y for x, y in zip(states, states[1:])), states
    keys = {k for r in port["reports"] for k in r["breached"]}
    assert any(":" in k for k in keys)  # a grouped <name>:<tenant> key


def test_grouped_ratio_fires_per_tenant_not_globally():
    """tests/test_admission.py:374 on the port."""
    eng = slo.SLOEngine()
    eng.evaluate(now=0.0)  # the baseline sample before the burst
    obs.counter(mn.TENANT_REQUESTS, tenant="a").inc(100)
    obs.counter(mn.TENANT_ERRORS, tenant="a").inc(50)
    obs.counter(mn.TENANT_REQUESTS, tenant="b").inc(100)
    rep = eng.evaluate(now=300.0)
    entry = rep["objectives"]["tenant_availability"]
    assert entry["group_by"] == "tenant"
    assert entry["breached"] == ["a"]
    assert rep["breached"] == ["tenant_availability:a"]
    assert entry["groups"]["a"]["windows"]["slow"]["burn_rate"] > 6
    assert entry["groups"]["b"]["breached"] is False
    alerts = [e for e in obs.get_event_log().recent()
              if e.get("name") == "slo.alert"]
    assert [(a["objective"], a["state"], a.get("tenant"))
            for a in alerts] == [("tenant_availability:a", "firing", "a")]
    assert obs.gauge(mn.SLO_BREACHED,
                     objective="tenant_availability:a").get() == 1.0
    assert obs.gauge(mn.SLO_BREACHED,
                     objective="tenant_availability:b").get() == 0.0
    obs.counter(mn.TENANT_REQUESTS, tenant="a").inc(5000)
    rep = eng.evaluate(now=900.0)
    assert rep["breached"] == []
    states = [(a["objective"], a["state"]) for a in
              obs.get_event_log().recent() if a.get("name") == "slo.alert"]
    assert states == [("tenant_availability:a", "firing"),
                      ("tenant_availability:a", "resolved")]


def test_grouped_quantile_per_tenant_and_its_doctor_lines():
    """tests/test_admission.py:419 on the port: the text renders a grouped
    objective per tenant, the same lines as the JAX package's."""
    eng = slo.SLOEngine()
    h = obs.histogram(mn.TENANT_REQUEST_LATENCY, tenant="slowpoke")
    for _ in range(20):
        h.observe(3.0)
    obs.histogram(mn.TENANT_REQUEST_LATENCY, tenant="quick").observe(0.01)
    rep = eng.evaluate(now=0.0)
    entry = rep["objectives"]["tenant_request_p99"]
    assert entry["breached"] == ["slowpoke"]
    assert entry["groups"]["slowpoke"]["value_s"] == pytest.approx(3.0)
    assert entry["groups"]["quick"]["breached"] is False
    text = obs.health.render_text({"slo": rep})
    assert text == jobs.health.render_text({"slo": rep})
    assert "tenant_request_p99 (per tenant): 1/2 breached" in text
    assert "tenant_request_p99:slowpoke: BREACHED" in text
    assert "tenant_request_p99:quick: ok" in text
    idle = {"slo": {"objectives": {"tenant_availability": {
        "kind": "ratio", "group_by": "tenant", "groups": {},
        "breached": []}}}}
    assert "tenant_availability: no tenant traffic" in \
        obs.health.render_text(idle)


def test_errors_without_request_growth_breach():
    eng = slo.SLOEngine()
    eng.evaluate(now=0.0)
    obs.counter(mn.TENANT_ERRORS, tenant="broken").inc(50)
    rep = eng.evaluate(now=300.0)
    assert rep["breached"] == ["tenant_availability:broken"]


def test_cold_history_never_confirms_and_the_ring_is_thinned():
    eng = slo.SLOEngine(windows=(("fast", 1.0), ("slow", 4.0)))
    eng.evaluate(now=10.0)
    obs.counter(mn.SERVING_REQUESTS, op="search").inc(10)
    obs.counter(mn.SERVING_ERRORS, op="search").inc(10)
    # 1.9 s of history: the 4 s window needs 2 s before it may confirm
    rep = eng.evaluate(now=11.9)
    w = rep["objectives"]["serving_availability"]["windows"]
    assert w["fast"]["confirmable"] and not w["slow"]["confirmable"]
    assert rep["breached"] == []
    rep = eng.evaluate(now=12.5)
    assert rep["breached"] == ["serving_availability"]
    for j in range(400):  # 0.4 s of fast polling: one sample per 4/128 s
        eng.evaluate(now=12.5 + j * 0.001)
    assert len(eng._samples) <= 3 + int(0.4 / (4.0 / 128)) + 1 < 400


def test_windows_and_objectives_are_arguments():
    only = [o for o in slo.DEFAULT_OBJECTIVES if o.name == "audit_recall"]
    eng = obs.reset_slo_engine(objectives=only,
                               windows=(("fast", 1.0), ("slow", 4.0)))
    assert obs.get_slo_engine() is eng
    assert eng.windows == (("fast", 1.0), ("slow", 4.0))
    assert slo.windows_in_force() == (("fast", 1.0), ("slow", 4.0))
    assert list(obs.slo_report()["objectives"]) == ["audit_recall"]
    # a disabled registry hands out the inert engine; re-enabled, the
    # configured objectives and windows come back
    obs.reset(enabled=False)
    assert obs.slo_report() == {}
    assert obs.get_slo_engine().active_breaches() == []
    obs.reset(enabled=True)
    assert obs.get_slo_engine().windows == (("fast", 1.0), ("slow", 4.0))
    for bad in ((), (("fast", 0.0),), (("a", 1.0), ("a", 2.0))):
        with pytest.raises(ValueError, match="window"):
            slo.SLOEngine(windows=bad)
    src = (slo.__file__ and open(slo.__file__).read())
    assert "os.environ" not in src and "getenv" not in src


_BAD_FILES = {
    "not_a_list": {"name": "x"},
    "empty": [],
    "bad_kind": [{"name": "x", "kind": "rate"}],
    "unknown_metric": [{"name": "x", "kind": "ratio",
                        "num": "knn_tpu_nope_total",
                        "den": mn.SERVING_REQUESTS, "target": 0.9}],
    "counter_is_not_a_histogram": [{"name": "x", "kind": "quantile",
                                    "hist": mn.SERVING_REQUESTS,
                                    "threshold": 1.0}],
    "histogram_is_not_a_counter": [{"name": "x", "kind": "ratio",
                                    "num": mn.QUEUE_WAIT,
                                    "den": mn.SERVING_REQUESTS,
                                    "target": 0.9}],
    "target_out_of_range": [{"name": "x", "kind": "ratio",
                             "num": mn.SERVING_ERRORS,
                             "den": mn.SERVING_REQUESTS, "target": 1.0}],
    "bad_quantile": [{"name": "x", "kind": "quantile",
                      "hist": mn.QUEUE_WAIT, "quantile": "p90",
                      "threshold": 1.0}],
    "zero_threshold": [{"name": "x", "kind": "quantile",
                        "hist": mn.QUEUE_WAIT, "threshold": 0.0}],
    "bad_burn": [{"name": "x", "kind": "quantile", "hist": mn.QUEUE_WAIT,
                  "threshold": 1.0, "burn_threshold": -1.0}],
    "group_by_not_a_label": [{"name": "x", "kind": "ratio",
                              "num": mn.SERVING_ERRORS,
                              "den": mn.SERVING_REQUESTS, "target": 0.9,
                              "group_by": "tenant"}],
    "duplicate_names": [{"name": "x", "kind": "quantile",
                         "hist": mn.QUEUE_WAIT, "threshold": 1.0}] * 2,
    "unknown_field": [{"name": "x", "kind": "quantile",
                       "hist": mn.QUEUE_WAIT, "threshold": 1.0,
                       "colour": "red"}],
}


@pytest.mark.parametrize("case", sorted(_BAD_FILES))
def test_load_objectives_refuses_what_jax_refuses(tmp_path, case):
    path = tmp_path / f"{case}.json"
    path.write_text(json.dumps(_BAD_FILES[case]))
    errors = []
    for mod in (slo, jslo):
        with pytest.raises((ValueError, TypeError)) as exc:
            mod.load_objectives(str(path))
        errors.append((exc.type, str(exc.value)))
    assert errors[0] == errors[1]


def test_load_objectives_loads_what_jax_loads(tmp_path):
    entries = [{"name": "fast_p95", "kind": "quantile",
                "hist": mn.SERVING_REQUEST_LATENCY, "quantile": "p95",
                "threshold": 0.05},
               {"name": "tenant_errs", "kind": "ratio",
                "num": mn.TENANT_ERRORS, "den": mn.TENANT_REQUESTS,
                "target": 0.99, "group_by": "tenant",
                "burn_threshold": 2.0}]
    path = tmp_path / "objectives.json"
    path.write_text(json.dumps(entries))
    port = [vars(o) for o in slo.load_objectives(str(path))]
    ref = [vars(o) for o in jslo.load_objectives(str(path))]
    assert port == ref
    assert [vars(o) for o in slo.load_objectives()] == \
        [vars(o) for o in jslo.DEFAULT_OBJECTIVES]


def _fleet_surface(rng):
    from knn_tpu_torch.obs.registry import BUCKET_BOUNDS

    counters, hists = {}, {}
    for tenant in ("a", "b", "c"):
        for name, hi in ((mn.TENANT_REQUESTS, 500), (mn.TENANT_ERRORS, 40),
                         (mn.AUDIT_REPLAYED, 300), (mn.AUDIT_DEFICIENT, 3)):
            counters.setdefault(name, []).append(
                {"labels": {"tenant": tenant},
                 "value": float(rng.integers(0, hi))})
        counts = rng.integers(0, 5, len(BUCKET_BOUNDS) + 1)
        hists.setdefault(mn.TENANT_REQUEST_LATENCY, []).append(
            {"labels": {"tenant": tenant},
             "buckets": np.cumsum(counts).tolist(),
             "count": int(counts.sum())})
    for name, hi in ((mn.SERVING_REQUESTS, 1000), (mn.SERVING_ERRORS, 30),
                     (mn.CERTIFIED_QUERIES, 1000),
                     (mn.CERTIFIED_FALLBACKS, 400)):
        counters[name] = [{"labels": {"host": str(h)},
                           "value": float(rng.integers(1, hi))}
                          for h in range(2)]
    counts = rng.integers(0, 9, len(BUCKET_BOUNDS) + 1)
    hists[mn.SERVING_REQUEST_LATENCY] = [
        {"labels": {"op": "search"}, "buckets": np.cumsum(counts).tolist(),
         "count": int(counts.sum())}]
    return counters, hists


@pytest.mark.parametrize("seed", [3, 4])
def test_evaluate_fleet_and_fleet_engine_equal_jax(seed):
    from knn_tpu.obs import registry as jreg
    from knn_tpu_torch.obs import registry as preg

    assert list(preg.BUCKET_BOUNDS) == list(jreg.BUCKET_BOUNDS)
    rng = np.random.default_rng(seed)
    engines = (slo.FleetSLOEngine(), jslo.FleetSLOEngine())
    for _ in range(3):
        counters, hists = _fleet_surface(rng)
        port = slo.evaluate_fleet(counters, hists)
        ref = jslo.evaluate_fleet(counters, hists)
        assert port == ref
        assert engines[0].observe(port) == engines[1].observe(ref)
        assert port == ref  # observe() stamps each entry's state alike
    assert engines[0].active_breaches() == engines[1].active_breaches()
