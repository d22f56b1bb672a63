"""The port's shadow audit sampler, drift sketches and flight recorder
(knn_tpu_torch.obs.{audit, drift, blackbox}) against the JAX package's
(knn_tpu.obs.{audit, drift, blackbox}), and the cases of
tests/test_audit.py on the port.

What is held equal: ``sampled()``'s decision for 10,000 trace ids at rates
0, 0.01, 0.3 and 1 (one hash rule); the summary and the AUDIT_* histogram
snapshots (count, sum, p50 / p95 / p99, min, max) of one set of audit
records scored by each package; which rates and budgets each refuses;
``psi``, a drift monitor's gauges and status, and ``index_health``;
``cli audit``'s lines and exit code for a snapshot and for a postmortem
bundle written by either package.  On the port alone (CPU, small shapes):
budget, backlog and oracle-error drops are loud and the worker survives;
the fault seam counts per tenant; a clean ServingEngine run audits recall
1.0; a seeded fault fires exactly one ``audit_recall`` alert and writes one
bundle with the failing records, while the served results stay bitwise;
with obs off the layer is dark and results bitwise those with it on; the
IVF frontend audits recall 1.0 and builds no drift monitor with obs off.
"""

import json
import os
import threading

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.obs import audit as jaudit
from knn_tpu.obs import blackbox as jblackbox
from knn_tpu_torch import obs
from knn_tpu_torch.obs import audit, blackbox
from knn_tpu_torch.obs import names as mn

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from test_torch_obs import port_wording

WAIT = 60.0


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(jaudit.AUDIT_RATE_ENV, raising=False)
    monkeypatch.delenv(jaudit.AUDIT_BUDGET_ENV, raising=False)
    monkeypatch.delenv(jblackbox.DIR_ENV, raising=False)
    for pkg, mod in ((obs, audit), (jobs, jaudit)):
        pkg.reset(enabled=True)
        pkg.reset_event_log(None)
        pkg.reset_slo_engine()
        pkg.health.reset()
        mod.clear_fault()
        mod.reset_auditor()
    blackbox.configure()
    yield
    for name in (jaudit.AUDIT_RATE_ENV, jaudit.AUDIT_BUDGET_ENV,
                 jblackbox.DIR_ENV):
        monkeypatch.delenv(name, raising=False)
    for pkg, mod in ((obs, audit), (jobs, jaudit)):
        mod.clear_fault()
        mod.reset_auditor()
        pkg.reset()
        pkg.reset_slo_engine()
        pkg.health.reset()
    obs.reset_event_log()
    jobs.reset_event_log(from_env=True)
    blackbox.configure()


def _alerts(pkg=obs):
    return [e for e in pkg.get_event_log().recent()
            if e.get("name") == "slo.alert" and e.get("state") == "firing"]


def _record(mod=audit, k=3, n=64, d=8, cost_rows=None, tenant=None,
            oracle=None, trace_id="t0", seed=0):
    """A self-consistent record over a synthetic corpus: the served
    answer is the exact answer (recall 1.0 unless faulted)."""
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d))
    q = rng.standard_normal((2, d))
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    ids = order[:, :k]
    dk = np.take_along_axis(d2, ids, axis=1)

    def exact_oracle(queries, served_ids):
        sd = np.take_along_axis(d2, np.asarray(served_ids)[:, :k], axis=1)
        return dk, ids, sd

    return mod.AuditRecord(
        trace_id=trace_id, tenant=tenant, k=k, queries=q,
        served_d=dk.copy(), served_ids=ids.copy(), epoch=None,
        cost_rows=cost_rows if cost_rows is not None else 2 * n,
        oracle=oracle or exact_oracle)


def _roll(rec):
    """The seeded index-perturbation fault: each query is served another
    query's (valid, wrong) neighbours."""
    rec.served_ids = np.roll(rec.served_ids, 1, axis=0)
    return rec


# -- parity with the JAX package -------------------------------------------
@pytest.mark.parametrize("rate", [0.0, 0.01, 0.3, 1.0])
def test_sampling_decisions_equal_jax(monkeypatch, rate):
    monkeypatch.setenv(jaudit.AUDIT_RATE_ENV, repr(rate))
    ref = jaudit.reset_auditor()
    port = audit.reset_auditor(rate=rate)
    rng = np.random.default_rng(int(rate * 1000))
    ids = [f"{int(x):016x}" for x in rng.integers(0, 2**62, 10_000)]
    got = [port.sampled(t) for t in ids]
    assert got == [ref.sampled(t) for t in ids]
    assert sum(got) == {0.0: 0, 1.0: 10_000}.get(rate, sum(got))
    if 0.0 < rate < 1.0:
        assert abs(sum(got) / 1e4 - rate) < 0.03
    assert not port.sampled(None)


def _scored_records():
    """Records with ties, out-of-range served ids and a perturbed one."""
    rng = np.random.default_rng(8)
    db = np.round(rng.standard_normal((40, 6)), 1)
    db[20:25] = db[0]  # exact ties with row 0
    recs = []
    for j, (k, fault) in enumerate(((4, False), (5, True), (3, False),
                                    (6, True))):
        q = np.round(rng.standard_normal((3, 6)), 1)
        q[0] = db[0]
        d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
        order = np.lexsort((np.broadcast_to(np.arange(40), d2.shape), d2),
                           axis=-1)
        ids = order[:, :k].copy()
        served_d = np.take_along_axis(d2, ids, axis=1).astype(np.float32)
        if fault:
            ids = np.roll(ids, 1, axis=0)
            ids[0, -1] = 99  # no such row: scored as an infinite distance
        recs.append(dict(trace_id=f"r{j}", tenant=("acme" if j % 2 else
                                                    None), k=k, queries=q,
                         served_d=served_d, served_ids=ids, epoch=j,
                         cost_rows=3 * 40, d2=d2, order=order))
    return recs


def _oracle_for(r):
    def oracle(queries, served_ids):
        k = r["k"]
        sid = np.asarray(served_ids)[:, :k]
        valid = sid < r["d2"].shape[1]
        se = np.take_along_axis(r["d2"], np.where(valid, sid, 0), axis=1)
        od = np.take_along_axis(r["d2"], r["order"][:, :k], axis=1)
        return od, r["order"][:, :k], np.where(valid, se, np.inf)
    return oracle


def _hist_values(snap):
    return {(name, tuple(sorted(s["labels"].items()))):
            {k: v for k, v in s["value"].items()
             if k not in ("window_span_s", "exemplars")}
            for name, m in snap.items() if name.startswith("knn_tpu_audit")
            and m["type"] == "histogram" for s in m["series"]}


def test_scoring_equals_jax_summary_and_histograms():
    out = {}
    for side, (pkg, mod) in (("port", (obs, audit)),
                             ("jax", (jobs, jaudit))):
        a = mod.Auditor() if side == "jax" else mod.Auditor(rate=1.0)
        for r in _scored_records():
            fields = {f: r[f] for f in ("trace_id", "tenant", "k", "queries",
                                        "served_d", "served_ids", "epoch",
                                        "cost_rows")}
            a._score(mod.AuditRecord(oracle=_oracle_for(r), **fields))
        summ = a.summary()
        snap = pkg.snapshot()
        out[side] = {
            "summary": {k: v for k, v in summ.items()
                        if k not in ("rate", "worker_alive")},
            "hists": _hist_values(snap),
            "counters": {(n, tuple(sorted(s["labels"].items()))): s["value"]
                         for n, m in snap.items()
                         if n.startswith("knn_tpu_audit")
                         and m["type"] == "counter" for s in m["series"]},
            "failures": a.evidence()["failures"]}
    assert out["port"] == out["jax"]
    assert out["port"]["summary"]["deficient_queries"] > 0
    assert len(out["port"]["hists"]) == 6  # 3 histograms x 2 tenants


@pytest.mark.parametrize("rate, budget", [
    ("nope", None), ("1.5", None), ("-0.25", None), ("nan", None),
    (None, "-3"), (None, "0"), (None, "lots"),
    ("0.25", None), (None, "1e3")])
def test_knob_refusals_match_jax(monkeypatch, rate, budget):
    """tests/test_audit.py:97: the port's arguments refuse what the JAX
    package's environment knobs refuse."""
    for name, raw in ((jaudit.AUDIT_RATE_ENV, rate),
                      (jaudit.AUDIT_BUDGET_ENV, budget)):
        if raw is not None:
            monkeypatch.setenv(name, raw)
    kw = {}
    if rate is not None:
        kw["rate"] = rate
    if budget is not None:
        kw["budget_rows_s"] = budget
    outcomes = []
    for make in (lambda: jaudit.reset_auditor(),
                 lambda: audit.reset_auditor(**kw)):
        try:
            a = make()
            outcomes.append(("ok", a.rate, a.summary()["budget_rows_s"]))
        except ValueError:
            outcomes.append(("refused",))
    assert outcomes[0] == outcomes[1]


def test_drift_functions_equal_jax():
    from knn_tpu.obs import drift as jdrift
    from knn_tpu_torch.obs import drift

    rng = np.random.default_rng(3)
    for a, b in ((np.array([100., 200, 300, 400]),
                  np.array([400., 300, 200, 100])),
                 (rng.integers(0, 9, 16), rng.integers(0, 9, 16))):
        assert drift.psi(a, b) == jdrift.psi(a, b)
    base = np.array([100., 200, 300, 400])
    assert drift.psi(base, base * 7) == pytest.approx(0.0, abs=1e-9)
    train = rng.normal(10.0, 1.0, 2048)
    base = rng.integers(100, 600, 12)
    mons = [m.QueryDriftMonitor(train_norms=train, assign_baseline=base)
            for m in (drift, jdrift)]
    for shift in (0.0, 0.0, 4.0):
        norms = rng.normal(10.0 + shift, 1.0, 300)
        asg = rng.integers(0, 12, 300)
        for m in mons:
            m.observe(norms=norms, assignments=asg)
        assert mons[0].status() == mons[1].status()
        for name in (mn.DRIFT_NORM_PSI, mn.DRIFT_ASSIGN_PSI):
            assert obs.gauge(name).get() == jobs.gauge(name).get()
    assert obs.counter(mn.DRIFT_QUERIES).get() == 900.0
    assert mons[0].status()["norm_psi"] > 0.5
    for args in ((np.array([10, 10, 40]), 20, 100, 80),
                 (None, 0, 0, 0), (np.array([0, 0]), 3, 10, 10)):
        assert drift.index_health(*args) == jdrift.index_health(*args)
    for name in (mn.INDEX_LIST_IMBALANCE, mn.INDEX_TAIL_FRACTION,
                 mn.INDEX_TOMBSTONE_DENSITY):
        assert obs.gauge(name).get() == jobs.gauge(name).get()


# -- the replay worker (tests/test_audit.py:110-190) -----------------------
def test_unset_rate_arms_nothing():
    a = audit.get_auditor()
    assert a.rate == 0.0 and not a.enabled()
    assert not a.sampled("deadbeef")
    assert not a.submit(_record())
    assert a.summary()["sampled_requests"] == 0
    assert not a.worker_alive()


def test_replay_runs_on_the_audit_thread():
    a = audit.reset_auditor(rate=1.0)
    seen = {}
    rec = _record()
    inner = rec.oracle

    def spying(queries, served_ids):
        seen["thread"] = threading.current_thread().name
        return inner(queries, served_ids)

    rec.oracle = spying
    assert a.submit(rec)
    assert a.drain(timeout=WAIT)
    assert seen["thread"] == "knn-audit" != threading.current_thread().name
    s = a.summary()
    assert s["replayed_queries"] == 2 and s["deficient_queries"] == 0
    assert s["last_recall_at_k"] == 1.0


def test_budget_and_backlog_drops_are_loud():
    """tests/test_audit.py:133, and the backlog: a worker held inside one
    oracle leaves QUEUE_CAP records queued; the next is dropped."""
    a = audit.reset_auditor(rate=1.0, budget_rows_s=10)

    def never(queries, served_ids):  # pragma: no cover - must not run
        raise AssertionError("an over-budget record must never replay")

    assert not a.submit(_record(cost_rows=10_000, oracle=never))
    s = a.summary()
    assert s["sampled_requests"] == 1 and s["dropped"] == {"budget": 1}
    assert s["replayed_queries"] == 0
    assert obs.counter(mn.AUDIT_DROPPED, reason="budget").get() == 1.0
    assert obs.counter(mn.AUDIT_SAMPLED, tenant="-").get() == 1.0

    a = audit.reset_auditor(rate=1.0, budget_rows_s=1e12)
    entered, release = threading.Event(), threading.Event()
    first = _record(trace_id="held")
    inner = first.oracle

    def held(queries, served_ids):
        entered.set()
        assert release.wait(WAIT)
        return inner(queries, served_ids)

    first.oracle = held
    assert a.submit(first)
    assert entered.wait(WAIT)
    assert all(a.submit(_record(trace_id=f"q{j}"))
               for j in range(audit.QUEUE_CAP))
    assert not a.submit(_record(trace_id="over"))
    assert a.summary()["dropped"] == {"queue_full": 1}
    assert obs.counter(mn.AUDIT_DROPPED, reason="queue_full").get() == 1.0
    release.set()
    assert a.drain(timeout=WAIT)
    s = a.summary()
    assert s["replayed_queries"] == 2 * (audit.QUEUE_CAP + 1)
    assert s["sampled_requests"] == audit.QUEUE_CAP + 2
    assert s["pending"] == 0


def test_oracle_error_is_dropped_and_the_worker_survives():
    """tests/test_audit.py:150."""
    a = audit.reset_auditor(rate=1.0)

    def boom(queries, served_ids):
        raise RuntimeError("oracle exploded")

    assert a.submit(_record(oracle=boom, trace_id="bad"))
    assert a.drain(timeout=WAIT)
    assert a.summary()["dropped"] == {"error": 1}
    assert a.evidence()["failures"][-1]["error"].startswith("RuntimeError")
    assert a.submit(_record(trace_id="good"))
    assert a.drain(timeout=WAIT)
    assert a.summary()["replayed_queries"] == 2
    assert a.worker_alive()


def test_fault_seam_counts_per_tenant():
    """tests/test_audit.py:167."""
    a = audit.reset_auditor(rate=1.0)
    audit.set_fault(_roll)
    try:
        assert a.submit(_record(tenant="acme", trace_id="f1"))
        assert a.drain(timeout=WAIT)
    finally:
        audit.clear_fault()
    s = a.summary()
    assert s["deficient_queries"] > 0 and s["last_recall_at_k"] < 1.0
    assert obs.counter(mn.AUDIT_DEFICIENT, tenant="acme").get() > 0
    f = a.evidence()["failures"][-1]
    assert f["trace_id"] == "f1" and f["tenant"] == "acme"
    assert f["worst_served_ids"] != f["worst_oracle_ids"]


# -- the serving engine (tests/test_audit.py:263-404) ------------------------
@pytest.fixture(scope="module")
def placed():
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(11)
    db = rng.standard_normal((192, 12)).astype(np.float32)
    return ShardedKNN(db, k=4, device="cpu"), db


def _replay(prog, rng, n_req=6, tenant=None):
    from knn_tpu_torch.serving import ServingEngine

    eng = ServingEngine(prog, buckets=(8, 16))
    eng.warmup()
    out = []
    for j in range(n_req):
        q = rng.standard_normal((5, 12)).astype(np.float32)
        out.append(eng.submit(q, tenant=tenant,
                              trace_id=f"req{j:04d}").result())
    return eng, out


def test_engine_clean_run_audits_recall_one(placed):
    """tests/test_audit.py:287."""
    prog, _ = placed
    audit.reset_auditor(rate=1.0)
    slo_eng = obs.get_slo_engine()
    slo_eng.evaluate(now=0.0)
    eng, _ = _replay(prog, np.random.default_rng(21))
    a = audit.get_auditor()
    assert a.drain(timeout=WAIT)
    s = a.summary()
    assert s["sampled_requests"] == 6 and s["replayed_queries"] == 30
    assert s["deficient_queries"] == 0 and s["dropped"] == {}
    assert s["last_recall_at_k"] == 1.0
    assert obs.counter(mn.AUDIT_ROWS_SCORED).get() == 6 * 5 * 192
    st = eng.stats()
    assert st["quality"]["replayed_queries"] == 30
    assert {"slo", "slowest_requests"} <= set(st)
    rep = slo_eng.evaluate(now=300.0)
    assert rep["breached"] == [] and _alerts() == []


def test_engine_seeded_fault_alerts_once_with_one_bundle(placed, tmp_path):
    """tests/test_audit.py:313: one firing ``audit_recall:-`` alert and one
    bundle holding the failing records; the fault touched only the audit
    copy, so the served results equal a fault-free rerun bitwise."""
    prog, _ = placed
    audit.reset_auditor(rate=1.0)
    blackbox.configure(postmortem_dir=str(tmp_path), keep=8)
    audit.set_fault(_roll)
    try:
        slo_eng = obs.get_slo_engine()
        slo_eng.evaluate(now=0.0)
        _, faulted = _replay(prog, np.random.default_rng(21))
        a = audit.get_auditor()
        assert a.drain(timeout=WAIT)
        assert a.summary()["deficient_queries"] > 0
        rep = slo_eng.evaluate(now=300.0)
        assert rep["breached"] == ["audit_recall:-"]
        assert [(e["objective"], e["state"]) for e in _alerts()] == [
            ("audit_recall:-", "firing")]
        slo_eng.evaluate(now=310.0)  # still breached: not re-alerted
        assert len(_alerts()) == 1
    finally:
        audit.clear_fault()
    bundles = sorted(p for p in os.listdir(tmp_path) if p.endswith(".json"))
    assert len(bundles) == 1
    payload = blackbox.read_bundle(str(tmp_path / bundles[0]))
    ev = payload["audit"]
    assert ev["summary"]["deficient_queries"] > 0
    assert ev["failures"][-1]["max_rank_displacement"] >= 1
    assert payload["env"] == {
        "audit_rate": 1.0, "audit_budget_rows_s": 5_000_000.0,
        "postmortem_dir": str(tmp_path), "postmortem_keep": 8,
        "slo_windows": [["fast", 60.0], ["slow", 600.0]]}
    assert obs.counter(mn.POSTMORTEMS_WRITTEN,
                       objective="audit_recall:-").get() == 1.0
    audit.reset_auditor()
    _, clean = _replay(prog, np.random.default_rng(21))
    for (df, i_f), (dc, ic) in zip(faulted, clean):
        np.testing.assert_array_equal(df, dc)
        np.testing.assert_array_equal(i_f, ic)


def test_obs_off_pins_the_audit_dark(placed):
    """tests/test_audit.py:371."""
    prog, _ = placed
    obs.reset(enabled=False)
    a = audit.reset_auditor(rate=1.0)
    assert not a.enabled() and not a.sampled("deadbeefdeadbeef")
    eng, res_off = _replay(prog, np.random.default_rng(33), n_req=3)
    assert not a.worker_alive()
    assert a.summary()["sampled_requests"] == 0
    assert not {"quality", "slo", "slowest_requests"} & set(eng.stats())
    assert not any(t.name == "knn-audit" for t in threading.enumerate())
    obs.reset(enabled=True)
    audit.reset_auditor(rate=1.0)
    _, res_on = _replay(prog, np.random.default_rng(33), n_req=3)
    assert audit.get_auditor().drain(timeout=WAIT)
    assert audit.get_auditor().summary()["replayed_queries"] == 15
    for (d0, i0), (d1, i1) in zip(res_off, res_on):
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(i0, i1)


def test_quality_section_absent_while_the_sampler_is_off(placed):
    eng, _ = _replay(placed[0], np.random.default_rng(5), n_req=1)
    assert "quality" not in eng.stats()


# -- the IVF tier (tests/test_audit.py:417, :438) ----------------------------
def _ivf(rows, **kw):
    from knn_tpu_torch.ivf import IVFIndex

    return IVFIndex(rows, k=4, ncentroids=16, seed=0, device="cpu", **kw)


def test_ivf_quality_gauges_drift_and_frontend_audit():
    rng = np.random.default_rng(17)
    db = rng.standard_normal((512, 8)).astype(np.float32)
    idx = _ivf(db)
    q = rng.standard_normal((16, 8)).astype(np.float32)
    idx.search_certified(q, nprobe=4)
    st = idx.stats()["drift"]
    assert st["queries_observed"] == 16 and "centroid_assign_psi" in st
    assert obs.gauge(mn.INDEX_LIST_IMBALANCE).get() >= 1.0
    assert obs.counter(mn.DRIFT_QUERIES).get() == 16.0
    audit.reset_auditor(rate=1.0)
    eng = idx.serving_engine(buckets=(8, 16), selector="pallas",
                             precision="bf16x3")
    for j in range(3):
        eng.submit(q[4 * j:4 * j + 4], tenant="acme",
                   trace_id=f"ivf-audit-{j}").result()
    a = audit.get_auditor()
    assert a.drain(timeout=WAIT)
    s = a.summary()
    assert s["replayed_queries"] == 12 and s["deficient_queries"] == 0
    assert s["last_recall_at_k"] == 1.0 and s["dropped"] == {}
    rep = obs.health.report()
    assert rep["quality"]["drift"][0]["queries_observed"] == 28


def test_ivf_epoch_moved_between_pin_and_search_is_dropped():
    rng = np.random.default_rng(18)
    idx = _ivf(rng.standard_normal((256, 8)).astype(np.float32))
    audit.reset_auditor(rate=1.0)
    eng = idx.serving_engine(buckets=(8,))
    q = rng.standard_normal((4, 8)).astype(np.float32)
    d, ids, st = idx.search_certified(q)
    eng._submit_audit("moved", None, q, d, ids, idx._snapshot(),
                      st["epoch"] + 1)
    assert obs.counter(mn.AUDIT_DROPPED, reason="epoch_moved").get() == 1.0
    assert audit.get_auditor().summary()["sampled_requests"] == 0


def test_ivf_obs_off_builds_no_drift_monitor():
    obs.reset(enabled=False)
    rng = np.random.default_rng(17)
    idx = _ivf(rng.standard_normal((256, 8)).astype(np.float32))
    assert idx._drift is None
    idx.search_certified(rng.standard_normal((4, 8)).astype(np.float32),
                         nprobe=2)
    assert "drift" not in idx.stats()


# -- health, doctor and cli audit (tests/test_audit.py:453-525) --------------
def test_health_quality_section_and_doctor_text_equal_jax(tmp_path, capsys):
    from knn_tpu.cli import main as jmain
    from knn_tpu_torch.cli import main as pmain

    a = audit.reset_auditor(rate=1.0)
    assert a.submit(_record(trace_id="rep1"))
    assert a.drain(timeout=WAIT)
    rng = np.random.default_rng(2)
    idx = _ivf(rng.standard_normal((256, 8)).astype(np.float32))
    idx.search_certified(rng.standard_normal((4, 8)).astype(np.float32))
    rep = obs.health.report()
    assert rep["quality"]["enabled"] and rep["quality"]["replayed_queries"]
    text = obs.health.render_text(rep)
    assert text == port_wording(jobs.health.render_text(rep))
    assert "quality: audit rate=1.0" in text and "drift[0]:" in text
    path = tmp_path / "snap.json"
    obs.write_json_snapshot(str(path))
    argv = ["doctor", "--snapshot", str(path)]
    outs = []
    for main in (pmain, jmain):
        rc = main(argv)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == (outs[1][0], port_wording(outs[1][1]))
    assert "quality: audit rate=1.0" in outs[0][1]
    audit.reset_auditor()
    assert "audit sampler off" in obs.health.render_text(obs.health.report())


def _cli_audit(main, argv, capsys):
    rc = main(["audit", *argv])
    return rc, capsys.readouterr().out


def test_cli_audit_prints_what_jax_prints(tmp_path, capsys, monkeypatch):
    """tests/test_audit.py:471 and :512 on both CLIs: a snapshot, a bundle
    written by the port and one written by the JAX package."""
    from knn_tpu.cli import main as jmain
    from knn_tpu_torch.cli import main as pmain

    a = audit.reset_auditor(rate=1.0)
    assert a.submit(_record(trace_id="snap1"))
    assert a.drain(timeout=WAIT)
    snap = tmp_path / "snap.json"
    obs.write_json_snapshot(str(snap))
    for argv in (["--snapshot", str(snap)],
                 ["--snapshot", str(snap), "--json"]):
        got = _cli_audit(pmain, argv, capsys)
        assert got == _cli_audit(jmain, argv, capsys)
    assert got[0] == 0 and json.loads(got[1])["quality"]["rate"] == 1.0
    # one faulted record on each side, one bundle each
    monkeypatch.setenv(jaudit.AUDIT_RATE_ENV, "1.0")
    ja = jaudit.reset_auditor()
    for mod, auditor in ((audit, a), (jaudit, ja)):
        mod.set_fault(_roll)
        try:
            assert auditor.submit(_record(mod, trace_id="bund1",
                                          tenant="acme"))
            assert auditor.drain(timeout=WAIT)
        finally:
            mod.clear_fault()
    blackbox.configure(postmortem_dir=str(tmp_path / "pm"))
    monkeypatch.setenv(jblackbox.DIR_ENV, str(tmp_path / "jpm"))
    assert blackbox.on_breach("audit_recall:acme", {"seed": "test"})
    assert jblackbox.on_breach("audit_recall:acme", {"seed": "test"})
    for d in ("pm", "jpm"):
        (bundle,) = os.listdir(tmp_path / d)
        for argv in (["--bundle", str(tmp_path / d / bundle)],
                     ["--bundle", str(tmp_path / d / bundle), "--json"]):
            got = _cli_audit(pmain, argv, capsys)
            assert got == _cli_audit(jmain, argv, capsys), (d, argv)
        assert got[0] == 2 and "bund1" in got[1]
    port_b = blackbox.read_bundle(str(tmp_path / "pm" /
                                      os.listdir(tmp_path / "pm")[0]))
    jax_b = jblackbox.read_bundle(str(tmp_path / "jpm" /
                                      os.listdir(tmp_path / "jpm")[0]))
    assert set(port_b) == set(jax_b)
    assert set(port_b["statusz"]) == set(jax_b["statusz"])
    # the calibration section's off shape (its token names each model)
    assert set(port_b["calibration"]) == set(jax_b["calibration"])
    assert port_b["calibration"]["store"] is jax_b["calibration"]["store"]
    missing = ["--snapshot", str(tmp_path / "missing.json")]
    assert _cli_audit(pmain, missing, capsys)[0] == \
        _cli_audit(jmain, missing, capsys)[0] == 1


def test_the_slice_writes_every_name_it_took_out_of_unwritten(tmp_path):
    """Each SLO_*, POSTMORTEMS_WRITTEN, AUDIT_*, DRIFT_* and INDEX_* gauge
    name is written by this slice's modules, and none is in UNWRITTEN."""
    from knn_tpu_torch.obs import drift

    names = {getattr(mn, a) for a in dir(mn)
             if a.startswith(("SLO_", "AUDIT_", "DRIFT_"))
             and isinstance(getattr(mn, a), str)}
    names |= {mn.POSTMORTEMS_WRITTEN, mn.INDEX_LIST_IMBALANCE,
              mn.INDEX_TAIL_FRACTION, mn.INDEX_TOMBSTONE_DENSITY}
    assert len(names) == 19 and not names & mn.UNWRITTEN
    blackbox.configure(postmortem_dir=str(tmp_path))
    a = audit.reset_auditor(rate=1.0, budget_rows_s=1000)
    eng = obs.get_slo_engine()
    eng.evaluate(now=0.0)
    assert not a.submit(_record(cost_rows=10_000, trace_id="over"))
    audit.set_fault(_roll)
    try:
        assert a.submit(_record(tenant="acme", trace_id="f"))
        assert a.drain(timeout=WAIT)
    finally:
        audit.clear_fault()
    mon = drift.QueryDriftMonitor(train_norms=np.arange(1.0, 65.0),
                                  assign_baseline=np.ones(4))
    mon.observe(norms=np.arange(1.0, 9.0), assignments=np.arange(8) % 4)
    drift.index_health(np.array([3, 5]), 1, 10, 9)
    assert eng.evaluate(now=300.0)["breached"] == ["audit_recall:acme"]
    written = set(obs.snapshot())
    assert names <= written, sorted(names - written)
