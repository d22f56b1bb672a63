"""The port's load generator (knn_tpu_torch.loadgen) against the JAX
package's (knn_tpu.loadgen) on the same specs and seeds.

Tolerances: schedules are EQUAL to the reference's, request for request
(the same numpy draws in the same order); knee blocks, their validation
messages and rate ladders are equal too.  The driver runs against the
synthetic target; no test asserts a wall time: outcome counts,
record fields and orderings only (the synthetic target's clock is its
own).
"""

import numpy as np
import pytest

from knn_tpu import loadgen as jax_loadgen
from knn_tpu_torch import loadgen
from knn_tpu_torch.loadgen import (Request, SyntheticTarget, TenantSpec,
                                   WorkloadSpec, generate, knee_block,
                                   knee_sweep, load_trace, parse_tenants,
                                   rates_around, run_workload, save_trace,
                                   validate_knee_block)

POOL = np.zeros((64, 8), np.float32)


def _jax_spec(spec: WorkloadSpec):
    """The same spec in the JAX package's classes."""
    tenants = tuple(jax_loadgen.TenantSpec(**vars(t)) for t in spec.tenants)
    kw = dict(vars(spec))
    kw["tenants"] = tenants
    return jax_loadgen.WorkloadSpec(**kw)


def _as_dicts(reqs):
    return [dict(vars(r)) for r in reqs]


SPECS = {
    "poisson": WorkloadSpec(rate_qps=300, duration_s=0.5, seed=11,
                            tenants=(TenantSpec("a", weight=2),
                                     TenantSpec("b", weight=1))),
    "onoff": WorkloadSpec(rate_qps=80, duration_s=2.0, seed=3,
                          arrival="onoff", on_s=0.2, off_s=0.3, burst=5.0),
    "tenants": WorkloadSpec(
        rate_qps=500, duration_s=0.6, seed=21,
        tenants=(TenantSpec("gold", weight=3, batch_sizes=(1, 4),
                            deadline_ms=50.0, priority=0, k=10,
                            metric="l2", precision="int8"),
                 TenantSpec("free", weight=1, batch_sizes=(8, 16, 32),
                            priority=5))),
    "writes": WorkloadSpec(
        rate_qps=400, duration_s=0.5, seed=13,
        tenants=(TenantSpec("readers", weight=0.8, batch_sizes=(1, 2, 4)),
                 TenantSpec("writers", weight=0.2, batch_sizes=(1,),
                            insert_fraction=0.6, delete_fraction=0.3,
                            write_rows=3))),
    "bulk": WorkloadSpec(
        rate_qps=300, duration_s=0.5, seed=17,
        tenants=(TenantSpec("mixed", batch_sizes=(1, 2),
                            bulk_fraction=0.25, bulk_rows=256,
                            insert_fraction=0.1),)),
    "low_rate": WorkloadSpec(rate_qps=0.5, duration_s=1.0, seed=0),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_equals_the_reference_draw_for_draw(name):
    spec = SPECS[name]
    got = generate(spec)
    assert _as_dicts(got) == _as_dicts(generate(_jax_spec(spec)))
    assert got == generate(spec)  # deterministic
    assert _as_dicts(generate(spec.at_rate(2 * spec.rate_qps))) == \
        _as_dicts(generate(_jax_spec(spec).at_rate(2 * spec.rate_qps)))


def test_schedule_shapes():
    reqs = generate(SPECS["tenants"])
    ts = [r.t for r in reqs]
    assert ts == sorted(ts) and all(0 < t < 0.6 for t in ts)
    gold = [r for r in reqs if r.tenant == "gold"]
    assert {r.rows for r in gold} <= {1, 4}
    assert all(r.deadline_ms == 50.0 and r.precision == "int8" for r in gold)
    assert len(gold) > len(reqs) - len(gold)
    on = generate(SPECS["onoff"])
    assert all((r.t % 0.5) <= 0.2 + 1e-9 for r in on)
    kinds = {r.kind for r in generate(SPECS["writes"])}
    assert kinds == {"query", "insert", "delete"}
    assert all(r.rows == 3 for r in generate(SPECS["writes"])
               if r.kind == "insert")
    assert {r.rows for r in generate(SPECS["bulk"])
            if r.kind == "bulk"} == {256}


@pytest.mark.parametrize("bad", [
    dict(arrival="nope"), dict(rate_qps=0), dict(duration_s=0),
    dict(tenants=()), dict(arrival="replay"),
    dict(tenants=(TenantSpec("a"), TenantSpec("a"))),
    dict(tenants=(TenantSpec("a", weight=0),)),
    dict(tenants=(TenantSpec("a", batch_sizes=(0,)),)),
    dict(tenants=(TenantSpec("a", deadline_ms=-1),)),
    dict(tenants=(TenantSpec("a", insert_fraction=0.7,
                             delete_fraction=0.5),)),
    dict(tenants=(TenantSpec("a", write_rows=0),)),
    dict(tenants=(TenantSpec("a", bulk_rows=0),)),
    dict(arrival="onoff", on_s=0), dict(arrival="onoff", burst=0)])
def test_validation_equals_the_reference(bad):
    spec = WorkloadSpec(**bad)
    with pytest.raises(ValueError) as port_err:
        generate(spec)
    with pytest.raises(ValueError) as jax_err:
        jax_loadgen.generate(_jax_spec(spec))
    assert str(port_err.value) == str(jax_err.value)


def test_parse_tenants_equals_the_reference():
    for text in ("gold:3:0,free:1:2", "a", " a:2 , b ", "x:1.5:3"):
        got = parse_tenants(text)
        assert [vars(t) for t in got] == [
            vars(t) for t in jax_loadgen.parse_tenants(text)]
    for text in ("", "a:1:2:3"):
        with pytest.raises(ValueError):
            parse_tenants(text)
        with pytest.raises(ValueError):
            jax_loadgen.parse_tenants(text)


def test_trace_file_round_trip_and_cross_reads(tmp_path):
    reqs = generate(SPECS["writes"])
    path = tmp_path / "trace.jsonl"
    save_trace(reqs, str(path))
    assert load_trace(str(path)) == reqs
    # the JAX package reads the port's file, and the other way round
    assert _as_dicts(jax_loadgen.load_trace(str(path))) == _as_dicts(reqs)
    jpath = tmp_path / "jax.jsonl"
    jax_loadgen.save_trace(jax_loadgen.generate(_jax_spec(SPECS["bulk"])),
                           str(jpath))
    assert path.read_text().count("\n") == len(reqs)
    assert load_trace(str(jpath)) == generate(SPECS["bulk"])
    replay = WorkloadSpec(arrival="replay", trace_path=str(path))
    assert generate(replay) == reqs
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"tenant": "a"}\n')
    with pytest.raises(ValueError, match="not a request record"):
        load_trace(str(bad))
    bad.write_text("not json\n")
    with pytest.raises(ValueError, match="not JSON"):
        load_trace(str(bad))


# -- knee blocks --------------------------------------------------------------
def _step(rate, ok, achieved, within):
    return {"rate_qps": rate, "offered": ok, "ok": ok,
            "achieved_qps": achieved, "shed_fraction": 0.0,
            "within_slo": within}


def test_knee_block_and_rates_equal_the_reference():
    steps = [_step(10.0, 5, 9.0, True), _step(20.0, 9, 18.5, True),
             _step(40.0, 12, 30.0, False), _step(5.0, 0, None, False)]
    for s in (steps, steps[2:], []):
        assert knee_block(s, slo_p99_ms=50) == jax_loadgen.knee_block(
            s, slo_p99_ms=50)
    assert knee_block(steps, slo_p99_ms=50)["knee_qps"] == 18.5
    for anchor in (100.0, 3.3, 12345.0):
        assert rates_around(anchor) == jax_loadgen.rates_around(anchor)
        assert rates_around(anchor, (0.1, 0.4, 1.0)) == \
            jax_loadgen.rates_around(anchor, (0.1, 0.4, 1.0))
    for anchor in (0, -1):
        with pytest.raises(ValueError):
            rates_around(anchor)


def test_validate_knee_block_equals_the_reference():
    ok = knee_block([_step(10.0, 5, 9.0, True)], slo_p99_ms=50.0)
    blocks = [
        "nope", None, {"version": 99}, {}, ok, {"error": "boom"},
        dict(ok, rate_steps=[{"rate_qps": 10.0}]),
        dict(ok, rate_steps=["x", _step(1.0, 1, 1.0, True)]),
        dict(ok, slo_p99_ms=-1), dict(ok, slo_p99_ms=None),
        dict(ok, slo_p99_ms="5"), dict(ok, rate_steps=[]),
        dict(ok, knee_qps="fast"), dict(ok, knee_qps=None),
        dict(ok, rate_steps=[_step(10.0, 5, 9.0, False)]),
        dict(ok, version=None)]
    for block in blocks:
        assert validate_knee_block(block) == \
            jax_loadgen.validate_knee_block(block), block
    assert validate_knee_block(ok) == []
    assert validate_knee_block(blocks[6])[0] == \
        "rate_steps[0] missing 'offered'"


# -- the driver against the synthetic target ----------------------------------
def test_driver_outcomes_against_a_bounded_synthetic_target():
    reqs = generate(WorkloadSpec(
        rate_qps=500, duration_s=0.3, seed=7,
        tenants=(TenantSpec("a", batch_sizes=(1,)),
                 TenantSpec("b", batch_sizes=(1,)))))
    with SyntheticTarget(50.0, max_depth=4) as target:
        rep = run_workload(target, reqs, queries=POOL,
                           include_records=True)
    assert rep["offered"] == len(reqs)
    assert rep["rejected"] > 0
    assert rep["outcomes"].get("rejected:queue_full", 0) == rep["rejected"]
    assert rep["ok"] + rep["rejected"] + rep["shed"] + rep["errors"] \
        == rep["offered"]
    for tenant in ("a", "b"):
        t = rep["per_tenant"][tenant]
        assert t["offered"] == sum(t["outcomes"].values())
    for r in rep["records"]:
        if r["outcome"] == "ok":
            assert r["arrival_s"] <= r["dispatch_s"] <= r["completion_s"]
        else:
            assert r["latency_s"] is None
    assert set(rep) == set(jax_loadgen.report(
        jax_loadgen.ResultLog(), offered=0, wall_s=1.0)) | {"records"}


def test_driver_sheds_expired_deadlines_and_bounds_the_log():
    reqs = generate(WorkloadSpec(
        rate_qps=400, duration_s=0.25, seed=6,
        tenants=(TenantSpec("a", batch_sizes=(1,), deadline_ms=1.0),)))
    with SyntheticTarget(100.0, shed_deadlines=True) as target:
        rep = run_workload(target, reqs, queries=POOL, log_cap=8)
    assert rep["offered"] == len(reqs)
    assert rep["records_kept"] == 8
    assert rep["records_dropped"] == len(reqs) - 8
    assert rep["ok"] + rep["shed"] == len(reqs)
    assert rep["outcomes"].get("shed:expired", 0) == rep["shed"]


def test_driver_write_and_bulk_lanes():
    spec = WorkloadSpec(
        rate_qps=400, duration_s=0.3, seed=5,
        tenants=(TenantSpec("r", batch_sizes=(1,), bulk_fraction=0.2,
                            bulk_rows=32),
                 TenantSpec("w", batch_sizes=(1,), insert_fraction=0.5,
                            delete_fraction=0.5)))
    reqs = generate(spec)
    with SyntheticTarget(5000.0) as target:
        rep = run_workload(target, reqs, queries=POOL)
        writes = dict(target.writes)
    n_bulk = sum(r.kind == "bulk" for r in reqs)
    n_write = sum(r.kind in ("insert", "delete") for r in reqs)
    assert rep["offered"] == len(reqs) - n_bulk - n_write
    assert rep["bulk"]["total"] == n_bulk and rep["bulk"]["ok"] == n_bulk
    assert rep["writes"]["total"] == n_write
    assert writes.get("insert", 0) == rep["writes"]["insert"]["ok"]
    deletes = rep["writes"].get("delete", {})
    assert deletes.get("ok", 0) == writes.get("delete", 0)
    assert deletes.get("ok", 0) + deletes.get("skipped:no_live_id", 0) == \
        sum(r.kind == "delete" for r in reqs)


def test_driver_refuses_writes_against_a_writeless_target():
    class _Reads:
        def submit(self, *a, **kw):
            raise AssertionError("never reached")

    with pytest.raises(ValueError, match="submit_write"):
        run_workload(_Reads(), generate(SPECS["writes"]), queries=POOL)
    with pytest.raises(ValueError, match="empty"):
        run_workload(_Reads(), [], queries=POOL)
    with pytest.raises(ValueError, match="pool"):
        run_workload(_Reads(), [Request("a", 0.0, 100)], queries=POOL)


def test_knee_sweep_on_the_synthetic_target_and_empty_steps():
    """A sweep over a target far above the offered rates: every step
    completes, the block validates, and a zero-arrival step is recorded
    empty instead of aborting the sweep (the reference's knee detection
    on the latency model is a wall-clock test; this one is not)."""
    base = WorkloadSpec(rate_qps=1.0, duration_s=0.2, seed=0,
                        tenants=(TenantSpec("a", batch_sizes=(1,)),))
    assert generate(base.at_rate(0.1)) == []
    block = knee_sweep(lambda: SyntheticTarget(5000.0), base,
                       [0.1, 50.0, 100.0], queries=POOL,
                       slo_p99_ms=10_000.0)
    assert validate_knee_block(block) == []
    first, second, third = block["rate_steps"]
    assert first["empty_schedule"] is True and first["offered"] == 0
    assert second["ok"] == second["offered"] == len(
        generate(base.at_rate(50.0)))
    assert third["ok"] == len(generate(base.at_rate(100.0)))
    assert block["knee_qps"] in (second["achieved_qps"],
                                 third["achieved_qps"])
    jblock = jax_loadgen.knee_sweep(
        lambda: jax_loadgen.SyntheticTarget(5000.0), _jax_spec(base),
        [0.1, 50.0], queries=POOL, slo_p99_ms=10_000.0)
    assert set(block) == set(jblock)
    for got, want in zip(block["rate_steps"], jblock["rate_steps"]):
        assert set(got) == set(want)
        assert (got["offered"], got["ok"]) == (want["offered"], want["ok"])
    with pytest.raises(ValueError):
        knee_sweep(lambda: None, base, [], queries=POOL, slo_p99_ms=1.0)
    with pytest.raises(ValueError):
        knee_sweep(lambda: None, base, [1.0], queries=POOL, slo_p99_ms=0)


def test_closed_loop_anchor_and_the_package_surface():
    with SyntheticTarget(1000.0) as target:
        assert loadgen.closed_loop_anchor(target, POOL, requests=8) > 0
    assert sorted(loadgen.__all__) == sorted(jax_loadgen.__all__)
    assert loadgen.ARRIVALS == jax_loadgen.ARRIVALS
    assert loadgen.DEFAULT_LOG_CAP == jax_loadgen.DEFAULT_LOG_CAP
