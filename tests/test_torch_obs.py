"""The port's telemetry core (knn_tpu_torch.obs) against the JAX package's
(knn_tpu.obs): the registry, spans, exporters and health on one scripted
sequence through both packages, and the cases of tests/test_obs.py.

What is held equal: the catalogs' (name, kind, labels) and version token;
``prometheus_text`` / ``compact_snapshot`` of one snapshot dict and
``quantile_from_buckets``; ``cli metrics`` / ``cli doctor`` output and exit
codes on one snapshot file; and after one scripted sequence on small
shapes — the counted ``exact`` certificate on a 2,048 x 32 placement with
fallbacks, a ServingEngine trace, a QueryQueue with admission, a
MutableIndex insert / delete / compact — every counter by (name, labels,
value), every histogram's count and the span-name multiset.  The pallas
selector's counters are held to the port's own stats (ROADMAP divergence
18 lets its fallbacks differ from the JAX package's).  Every ``(d, i)`` is
bitwise the same with obs on and off.
"""

import ast
import collections
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.obs import names as jnames
from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as mn

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PKGS = {"port": obs, "jax": jobs}


def _reset_all():
    for pkg in PKGS.values():
        pkg.reset(enabled=True)
        pkg.reset_event_log(None)
        pkg.reset_slo_engine()
        pkg.health.reset()
        pkg.roofline.reset()


@pytest.fixture(autouse=True)
def _fresh_registries():
    _reset_all()
    yield
    obs.reset()
    obs.reset_event_log()
    obs.health.reset()
    jobs.reset()
    jobs.reset_event_log(from_env=True)
    jobs.health.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- the catalog ----------------------------------------------------------
def test_catalog_is_the_jax_catalog_name_for_name():
    assert set(mn.CATALOG) == set(jnames.CATALOG)
    for name, (kind, labels, _help) in mn.CATALOG.items():
        assert jnames.CATALOG[name][:2] == (kind, labels), name
    assert mn.catalog_version() == jnames.catalog_version()
    consts = {k: v for k, v in vars(mn).items() if k.isupper()
              and isinstance(v, str) and v.startswith("knn_tpu_")}
    jconsts = {k: v for k, v in vars(jnames).items() if k.isupper()
               and isinstance(v, str) and v.startswith("knn_tpu_")}
    assert consts == jconsts


# -- registry exactness (tests/test_obs.py, both packages) ----------------
def test_counter_gauge_histogram_exactness(pkg):
    c = pkg.counter(mn.QUEUE_REQUESTS)
    c.inc()
    c.inc(4)
    assert c.get() == 5.0
    g = pkg.gauge(mn.QUEUE_DEPTH_ROWS)
    g.set(10)
    g.inc(2)
    g.dec(5)
    assert g.get() == 7.0
    h = pkg.histogram(mn.QUEUE_WAIT)
    for v in range(1, 101):
        h.observe(v / 100.0)
    s = h.summary()
    assert s["count"] == 100
    assert s["sum"] == pytest.approx(50.5)
    assert s["min"] == pytest.approx(0.01) and s["max"] == pytest.approx(1.0)
    assert s["p50"] == pytest.approx(0.505, abs=0.02)
    assert s["p99"] == pytest.approx(0.99, abs=0.02)


def test_histogram_window_is_bounded_but_lifetime_is_not(pkg):
    h = pkg.Histogram(window=16)
    h.observe_many(range(1000))
    s = h.summary()
    assert s["count"] == 1000
    assert s["window"] == 16
    assert s["p50"] >= 983


def test_labels_create_distinct_series_and_same_handle(pkg):
    a = pkg.counter(mn.SERVING_REQUESTS, op="search")
    b = pkg.counter(mn.SERVING_REQUESTS, op="predict")
    assert a is not b
    assert pkg.counter(mn.SERVING_REQUESTS, op="search") is a
    a.inc(3)
    snap = pkg.snapshot()[mn.SERVING_REQUESTS]
    by_op = {s["labels"]["op"]: s["value"] for s in snap["series"]}
    assert by_op == {"search": 3.0, "predict": 0.0}


def test_uncataloged_names_and_label_mismatches_refused(pkg):
    with pytest.raises(ValueError, match="not in the catalog"):
        pkg.counter("knn_tpu_made_up_total")
    with pytest.raises(ValueError, match="is a counter"):
        pkg.gauge(mn.QUEUE_REQUESTS)
    with pytest.raises(ValueError, match="takes labels"):
        pkg.counter(mn.SERVING_REQUESTS)
    with pytest.raises(ValueError):
        pkg.counter(mn.QUEUE_REQUESTS, op="x")
    pkg.reset(enabled=False)
    with pytest.raises(ValueError, match="not in the catalog"):
        pkg.counter("knn_tpu_made_up_total")


def test_thread_hammer_counts_exact(pkg):
    c = pkg.counter(mn.QUEUE_REQUESTS)
    h = pkg.histogram(mn.QUEUE_WAIT)
    g = pkg.gauge(mn.QUEUE_DEPTH_ROWS)
    # more threads than cores, switching every microsecond: a lost update
    # would show in the totals
    n_threads, per = min(32, (os.cpu_count() or 4) + 4), 1000

    def work():
        for i in range(per):
            c.inc()
            h.observe(i, exemplar=f"{i:016x}")
            g.inc()

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert c.get() == n_threads * per
    s = h.summary()
    assert s["count"] == n_threads * per
    assert s["buckets"][-1] == n_threads * per
    assert g.get() == n_threads * per
    assert len(h.exemplars()) == 8


def test_disabled_mode_noop_identity(pkg):
    pkg.reset(enabled=False)
    c = pkg.counter(mn.QUEUE_REQUESTS)
    assert c is pkg.counter(mn.QUEUE_DISPATCHES)
    assert c is pkg.gauge(mn.QUEUE_DEPTH_ROWS)
    assert c is pkg.histogram(mn.QUEUE_WAIT)
    assert c is pkg.NOOP
    c.inc()
    c.observe(3.0)
    assert c.get() == 0.0
    assert pkg.snapshot() == {}
    assert pkg.new_trace_id() is None
    with pkg.span("serving.dispatch") as sp:
        sp.set("k", 1)
    assert sp.trace_id is None
    assert pkg.get_event_log().recent() == []
    assert not pkg.enabled()


def test_obs_knobs_are_arguments_not_environment(monkeypatch):
    """The port reads no KNN_TPU_OBS* variable: the switch and the
    exemplar knobs are reset()'s arguments, with the JAX defaults."""
    monkeypatch.setenv("KNN_TPU_OBS", "0")
    monkeypatch.setenv("KNN_TPU_OBS_EXEMPLAR_CAP", "1")
    obs.reset()
    assert obs.enabled()
    h = obs.histogram(mn.QUEUE_WAIT)
    for i in range(20):
        h.observe(float(i), exemplar=f"{i:016x}")
    assert len(h.exemplars()) == obs.registry.EXEMPLAR_CAP == \
        jobs.registry.EXEMPLAR_CAP
    assert obs.registry.EXEMPLAR_MAX_AGE_S == jobs.registry.EXEMPLAR_MAX_AGE_S
    obs.reset(exemplar_cap=2)
    h = obs.histogram(mn.QUEUE_WAIT)
    for i in range(20):
        h.observe(float(i), exemplar=f"{i:016x}")
    assert [e["value"] for e in h.exemplars()] == [19.0, 18.0]
    with pytest.raises(ValueError, match="exemplar_cap"):
        obs.reset(exemplar_cap=-1)
    with pytest.raises(ValueError, match="exemplar_age_s"):
        obs.reset(exemplar_age_s=0)
    obs.reset(enabled=False)
    assert not obs.enabled()


def test_quantile_from_buckets_equals_jax():
    rng = np.random.default_rng(0)
    from knn_tpu.obs.registry import quantile_from_buckets as jq
    from knn_tpu_torch.obs.registry import BUCKET_BOUNDS, quantile_from_buckets

    assert BUCKET_BOUNDS == jobs.registry.BUCKET_BOUNDS
    for _ in range(50):
        counts = rng.integers(0, 5, len(BUCKET_BOUNDS) + 1)
        cum = np.cumsum(counts).tolist()
        for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
            assert quantile_from_buckets(cum, q) == jq(cum, q)
    assert quantile_from_buckets([], 0.5) is None
    assert quantile_from_buckets([0] * 42, 0.5) is None


# -- exporters --------------------------------------------------------------
def _sample_snapshot():
    obs.counter(mn.SERVING_REQUESTS, op="search").inc(7)
    obs.counter(mn.SERVING_DISPATCHES, op="search", bucket=8).inc(2)
    obs.gauge(mn.QUEUE_DEPTH_REQUESTS).set(3)
    obs.histogram(mn.QUEUE_WAIT).observe_many([0.1, 0.2, 0.3])
    obs.histogram(mn.SERVING_REQUEST_LATENCY, op="search").observe(
        0.05, exemplar="feed000000000001")
    obs.histogram(mn.SPAN_SECONDS, span='we"ird\nname').observe(2e-7)
    return obs.snapshot()


def test_prometheus_text_and_compact_snapshot_equal_jax():
    snap = _sample_snapshot()
    text = obs.prometheus_text(snap)
    assert text == jobs.prometheus_text(snap)
    assert obs.compact_snapshot(snap) == jobs.compact_snapshot(snap)
    assert obs.prometheus_text() == text
    assert 'knn_tpu_serving_requests_total{op="search"} 7.0' in text
    assert "# EXEMPLAR knn_tpu_serving_request_latency_seconds" in text
    assert 'knn_tpu_queue_wait_seconds{quantile="0.5"} 0.2' in text


def test_prometheus_text_and_json_snapshot_round_trip(tmp_path):
    _sample_snapshot()
    text = obs.prometheus_text()
    path = tmp_path / "snap.json"
    obs.write_json_snapshot(str(path))
    payload = json.loads(path.read_text())
    assert payload["enabled"] is True
    assert payload["identity"]["catalog_version"] == mn.catalog_version()
    assert obs.prometheus_text(payload["metrics"]) == text
    assert payload["health"]["obs_enabled"] is True
    assert not list(tmp_path.glob("*.tmp"))


def test_jsonl_event_log_sink(tmp_path, pkg):
    path = tmp_path / "events.jsonl"
    pkg.reset_event_log(str(path))
    tid = pkg.new_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0
    with pkg.span("serving.dispatch", trace_id=tid, op="search", rows=4):
        pass
    with pkg.span("serving.compile", op="search"):
        pass
    pkg.emit_event("queue.dispatch", rows=4)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["type"] for ln in lines] == ["span", "span", "event"]
    assert lines[0]["span"] == "serving.dispatch"
    assert lines[0]["trace_id"] == tid
    assert "trace_id" not in lines[1]
    assert all("identity" in ln for ln in lines)
    ident = lines[2].pop("identity")
    assert ident["process_index"] == 0 and "host" in ident
    assert lines[2] == {"ts": lines[2]["ts"], "type": "event",
                        "name": "queue.dispatch", "rows": 4}
    pkg.reset_event_log(None)


def test_jsonl_sink_rotates_preserving_valid_jsonl(tmp_path, pkg):
    path = tmp_path / "events.jsonl"
    pkg.reset_event_log(str(path), max_bytes=1024)
    n = 200
    for i in range(n):
        pkg.emit_event("queue.dispatch", rows=i, pad="x" * 16)
    live = [json.loads(ln) for ln in path.read_text().splitlines()]
    rotated = [json.loads(ln) for ln in
               (tmp_path / "events.jsonl.1").read_text().splitlines()]
    assert path.stat().st_size <= 1024
    assert (tmp_path / "events.jsonl.1").stat().st_size <= 1024
    assert [e["rows"] for e in rotated + live] == list(
        range(n - len(rotated) - len(live), n))
    assert len(pkg.get_event_log().recent()) == n
    pkg.reset_event_log(None)


def test_jsonl_rotation_keeps_exactly_two_generations(tmp_path, pkg):
    path = tmp_path / "e.jsonl"
    pkg.reset_event_log(str(path), max_bytes=256)
    for i in range(300):
        pkg.emit_event("queue.dispatch", rows=i)
    pkg.reset_event_log(None)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "e.jsonl", "e.jsonl.1"]


def test_a_failing_sink_counts_dropped_events(tmp_path):
    obs.reset_event_log(str(tmp_path / "missing-dir" / "e.jsonl"))
    obs.emit_event("queue.dispatch", rows=1)
    assert obs.counter(mn.EVENTS_DROPPED).get() == 1.0
    assert len(obs.get_event_log().recent()) == 1


def test_http_metrics_endpoint():
    obs.counter(mn.QUEUE_REQUESTS).inc(11)
    server = obs.start_metrics_server(0)
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        assert "knn_tpu_queue_requests_total 11.0" in text
        js = json.loads(urllib.request.urlopen(f"{base}/metrics.json",
                                               timeout=10).read())
        assert js["metrics"][mn.QUEUE_REQUESTS]["series"][0]["value"] == 11.0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/healthz", timeout=10)
        assert e.value.code == 503  # no engine registered
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/fleetz", timeout=10)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


# -- the scripted sequence through both packages --------------------------
D = 32


def _tie_data():
    """2,048 x 32 rows, each of 512 integer rows four times: the counted
    certificate's windows close on ties, so some queries fall back."""
    rng = np.random.default_rng(3)
    base = rng.integers(-3, 4, size=(512, D)).astype(np.float32)
    return np.concatenate([base] * 4), base[:16]


def _sequence(side, db, q):
    """One scripted run through ``side`` ("port" or "jax"); returns its
    results (every (d, i) it produced)."""
    if side == "port":
        from knn_tpu_torch import MutableIndex, ShardedKNN
        from knn_tpu_torch.serving import QueryQueue, ServingEngine
        from knn_tpu_torch.serving.admission import (AdmissionConfig,
                                                     AdmissionError)

        def make(rows, k):
            return ShardedKNN(rows, k=k, device="cpu")

        def mutable(rows):
            return MutableIndex(rows, k=5, reserve=4, device="cpu")
    else:
        from knn_tpu.index import MutableIndex
        from knn_tpu.parallel import ShardedKNN, make_mesh
        from knn_tpu.serving import QueryQueue, ServingEngine
        from knn_tpu.serving.admission import AdmissionConfig, AdmissionError

        def make(rows, k):
            return ShardedKNN(rows, mesh=make_mesh(1, 1), k=k)

        def mutable(rows):
            return MutableIndex(rows, mesh=make_mesh(1, 1), k=5, reserve=4)

    out = []
    prog = make(db, 6)
    d, i, st = prog.search_certified(q, selector="exact", margin=2)
    assert st["fallback_queries"] > 0
    out.append((np.asarray(d), np.asarray(i)))

    rng = np.random.default_rng(5)
    small = rng.normal(size=(400, 12)).astype(np.float32)
    eng = ServingEngine(make(small, 7), buckets=(8, 16, 32))
    eng.warmup()
    reqs = [rng.normal(size=(s, 12)).astype(np.float32)
            for s in (3, 8, 17, 1, 40)]
    res, _ = eng.replay(reqs, depth=2)
    out += [tuple(np.asarray(a) for a in r) for r in res]

    # four accepted 8-row requests fill max_rows (32) exactly: one
    # dispatch, whatever the timing; the third t1 request is over quota
    adm = AdmissionConfig(quotas={"t1": (0.001, 2.0)})
    with QueryQueue(eng, max_wait_ms=5000.0, admission=adm) as qq:
        futs = []
        for tenant in ("t0", "t1", "t1", "t0"):
            futs.append(qq.submit(
                rng.normal(size=(8, 12)).astype(np.float32), tenant=tenant))
            if tenant == "t1" and len(futs) == 3:
                with pytest.raises(AdmissionError):
                    qq.submit(rng.normal(size=(8, 12)).astype(np.float32),
                              tenant="t1")
        out += [tuple(np.asarray(a) for a in f.result(timeout=60))
                for f in futs]
        ids = [f.trace_id for f in futs]

    rows = rng.normal(size=(600, 12)).astype(np.float32) * 10
    idx = mutable(rows)
    idx.insert(rng.normal(size=(6, 12)).astype(np.float32) * 10,
               np.arange(1000, 1006))
    idx.delete([3, 11, 40])
    qm = rng.normal(size=(8, 12)).astype(np.float32) * 10
    d, i, _ = idx.search_certified(qm, selector="exact")
    out.append((np.asarray(d), np.asarray(i)))
    idx.compact()
    d, i, _ = idx.search_certified(qm, selector="exact")
    out.append((np.asarray(d), np.asarray(i)))
    return out, ids


def _counters(snap):
    """(name, labels, value) of every counter but those only the JAX
    package writes (names.UNWRITTEN: its XLA compile events, its merge
    strategy, the SLO engine's passes)."""
    return {(name, tuple(sorted(s["labels"].items())), s["value"])
            for name, m in snap.items()
            if m["type"] == "counter" and name not in mn.UNWRITTEN
            for s in m["series"]}


def _hist_counts(snap):
    return {(name, tuple(sorted(s["labels"].items()))): s["value"]["count"]
            for name, m in snap.items()
            if m["type"] == "histogram" and name not in mn.UNWRITTEN
            for s in m["series"]}


def _span_names(pkg):
    return collections.Counter(e["span"] for e in pkg.get_event_log().recent()
                               if e.get("type") == "span")


@pytest.fixture(scope="module")
def scripted():
    db, q = _tie_data()
    runs = {}
    for side in ("port", "jax"):
        _reset_all()
        res, ids = _sequence(side, db, q)
        snap = PKGS[side].snapshot()
        runs[side] = {"res": res, "ids": ids, "snap": snap,
                      "spans": _span_names(PKGS[side])}
    _reset_all()
    obs.reset(enabled=False)
    runs["port_off"] = {"res": _sequence("port", db, q)[0]}
    return runs


def test_scripted_sequence_counters_equal_jax(scripted):
    port, jax_ = scripted["port"]["snap"], scripted["jax"]["snap"]
    assert not set(port) & mn.UNWRITTEN
    assert _counters(port) == _counters(jax_)
    names = {c[0] for c in _counters(port)}
    for name in (mn.CERTIFIED_QUERIES, mn.CERTIFIED_FALLBACKS,
                 mn.SERVING_COMPILES, mn.SERVING_DISPATCHES,
                 mn.QUEUE_COALESCED_ROWS, mn.ADMISSION_REJECTED,
                 mn.ADMISSION_ADMITTED, mn.INDEX_COMPACTIONS,
                 mn.TENANT_REQUESTS):
        assert name in names, name


def test_scripted_sequence_histogram_counts_and_spans_equal_jax(scripted):
    assert _hist_counts(scripted["port"]["snap"]) == \
        _hist_counts(scripted["jax"]["snap"])
    assert scripted["port"]["spans"] == scripted["jax"]["spans"]
    assert scripted["port"]["spans"]["serving.queued_request"] == 4
    assert _hist_counts(scripted["port"]["snap"])[
        (mn.CERTIFIED_MARGIN, (("path", "sharded"),))] > 0


def test_scripted_sequence_results_bitwise_obs_on_off(scripted):
    on, off = scripted["port"]["res"], scripted["port_off"]["res"]
    assert len(on) == len(off)
    for a, b in zip(on, off):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ids = scripted["port"]["ids"]
    assert len(set(ids)) == len(ids) and None not in ids


def test_certified_counters_equal_the_ports_own_stats():
    """The pallas selector, held to its own stats (divergence 18), and the
    margin histogram, which counts the counted certificate's certified
    queries."""
    from knn_tpu_torch import ShardedKNN

    db, q = _tie_data()
    prog = ShardedKNN(db, k=6, device="cpu")
    _, _, st = prog.search_certified(q, margin=8, selector="pallas")
    c = lambda name, **kw: obs.counter(name, **kw).get()  # noqa: E731
    assert c(mn.CERTIFIED_QUERIES, selector="pallas") == q.shape[0]
    assert c(mn.CERTIFIED_FALLBACKS, selector="pallas") == \
        st["fallback_queries"]
    assert c(mn.CERTIFIED_RANK_CORRECTED) == st["rank_corrected_queries"]
    assert c(mn.CERTIFIED_GENUINE_MISSES, selector="pallas") == \
        st["fallback_genuine_misses"]
    _, _, st = prog.search_certified(q, margin=2, selector="exact")
    margins = obs.histogram(mn.CERTIFIED_MARGIN, path="sharded").summary()
    assert margins["count"] == st["certified"]


def test_quant_bound_recorded_per_query():
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.ops.quantize import score_error_bound

    rng = np.random.default_rng(2)
    db = rng.normal(size=(900, 16)).astype(np.float32)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    prog = ShardedKNN(db, k=4, device="cpu")
    prog.search_certified(q, selector="pallas", margin=8, tile_n=256,
                          precision="int8")
    s = obs.histogram(mn.CERTIFIED_QUANT_BOUND).summary()
    assert s["count"] == q.shape[0]
    pl = prog._quant_placement("int8")
    eps = score_error_bound(q, pl["stats"], offset=pl["offset"])
    assert s["max"] == pytest.approx(float(np.max(eps)))
    assert s["min"] == pytest.approx(float(np.min(eps)))


def test_pipeline_overlap_gauge_and_span():
    from knn_tpu_torch import ShardedKNN

    db, q = _tie_data()
    prog = ShardedKNN(db, k=6, device="cpu")
    _, _, st = prog.search_certified(q, margin=8, overlap=True,
                                     batch_size=4)
    assert obs.gauge(mn.PIPELINE_OVERLAP_RATIO).get() == pytest.approx(
        st["pipeline"]["overlap_ratio"], abs=1e-4)
    spans = [e for e in obs.get_event_log().recent()
             if e.get("span") == "certified.pipeline"]
    assert len(spans) == 1 and spans[0]["batches"] == 4


def test_phase_timer_feeds_registry_and_rejects_nesting():
    from knn_tpu_torch.utils.timing import PhaseTimer

    t = PhaseTimer()
    with t.phase("ingest"):
        pass
    with t.phase("ingest"):
        pass
    h = obs.snapshot()[mn.PHASE_SECONDS]["series"]
    assert [s["value"]["count"] for s in h
            if s["labels"] == {"phase": "ingest"}] == [2]
    with pytest.raises(RuntimeError, match="nested"):
        with t.phase("outer"):
            with t.phase("inner"):
                pass
    with t.phase("after"):
        pass
    assert "after" in t.phases


def test_job_metrics_carry_the_obs_snapshot_only_when_on():
    from knn_tpu_torch.pipeline import JobResult
    from knn_tpu_torch.utils.config import JobConfig

    res = JobResult(test_labels=np.zeros(1, np.int32), val_labels=None,
                    val_accuracy=None, phase_times={}, total_time=1.0,
                    n_train=1, n_test=1, n_val=0,
                    config=JobConfig(train_file="t", test_file="q"))
    obs.counter(mn.QUEUE_REQUESTS).inc()
    assert res.metrics()["obs"][mn.QUEUE_REQUESTS] == 1.0
    obs.reset(enabled=False)
    assert "obs" not in res.metrics()


# -- health, the metrics server and the CLI -------------------------------
@pytest.fixture(scope="module")
def small_prog():
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(7)
    db = rng.standard_normal((256, 16)).astype(np.float32)
    return ShardedKNN(db, k=5, device="cpu"), rng


def test_health_ready_after_warmup_and_index_section(small_prog):
    from knn_tpu_torch import MutableIndex
    from knn_tpu_torch.serving import QueryQueue, ServingEngine

    prog, rng = small_prog
    eng = ServingEngine(prog, buckets=(8,))
    assert not obs.health.probe()["ready"]
    eng.warmup()
    idx = MutableIndex(rng.standard_normal((64, 16)).astype(np.float32),
                       k=3, reserve=2, device="cpu")
    with QueryQueue(eng) as qq:
        assert obs.health.probe() == {"live": True, "ready": True,
                                      "reasons": []}
        rep = obs.health.report()
        assert rep["queues"][0]["batcher_alive"]
    assert rep["engines"][0]["warmed_ops"] == ["search"]
    assert rep["index"][0]["epoch"] == 0 and idx is not None
    assert rep["devices"]["available"] is False  # no card here
    for section in ("calibration", "quality", "postmortems", "slo",
                    "slowest_requests"):
        assert section in rep
    assert "multihost" not in rep
    assert obs.gauge(mn.HEALTH_READY).get() == 1.0
    text = obs.health.render_text(rep)
    assert text.startswith("health: READY")
    assert text == jobs.health.render_text(rep)


def test_http_server_concurrent_load_never_tears(small_prog):
    from knn_tpu_torch.serving import ServingEngine

    prog, _ = small_prog
    eng = ServingEngine(prog, buckets=(8,))
    eng.warmup()
    server = obs.start_metrics_server(0)
    errors = []
    stop = threading.Event()
    try:
        port = server.server_address[1]

        def mutate():
            i = 0
            while not stop.is_set():
                obs.counter(mn.QUEUE_REQUESTS).inc()
                obs.histogram(mn.QUEUE_WAIT).observe(i * 1e-4)
                obs.gauge(mn.QUEUE_DEPTH_ROWS).set(i % 7)
                i += 1

        def fetch(path, check):
            try:
                for _ in range(20):
                    try:
                        body = urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=10).read().decode()
                    except urllib.error.HTTPError as e:
                        body = e.read().decode()
                    check(body)
            except Exception as e:  # noqa: BLE001 — the assertion surface
                errors.append((path, repr(e)))

        def check_prom(body):
            assert "# TYPE knn_tpu_queue_requests_total counter" in body
            for ln in body.splitlines():
                assert ln.startswith("#") or " " in ln

        mut = threading.Thread(target=mutate, daemon=True)
        mut.start()
        ts = [threading.Thread(target=fetch, args=(path, check))
              for _ in range(2)
              for path, check in (("/metrics", check_prom),
                                  ("/metrics.json", json.loads),
                                  ("/healthz", json.loads),
                                  ("/statusz", json.loads))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        stop.set()
        mut.join(10)
        assert not errors, errors
    finally:
        stop.set()
        server.shutdown()
        server.server_close()


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("ready", [False, True])
def test_cli_metrics_and_doctor_print_what_jax_prints(tmp_path, capsys,
                                                      small_prog, ready):
    from knn_tpu.cli import main as jmain
    from knn_tpu_torch.cli import main as pmain
    from knn_tpu_torch.serving import ServingEngine

    eng = ServingEngine(small_prog[0], buckets=(8,))
    if ready:
        eng.warmup()
        eng.search(np.zeros((3, 16), np.float32))
    path = tmp_path / "snap.json"
    obs.write_json_snapshot(str(path))
    for argv in (["metrics", "--snapshot", str(path)],
                 ["metrics", "--snapshot", str(path), "--format", "json"],
                 ["doctor", "--snapshot", str(path)],
                 ["doctor", "--snapshot", str(path), "--json"]):
        assert _cli(pmain, argv, capsys) == _cli(jmain, argv, capsys), argv
    rc, out = _cli(pmain, ["doctor", "--snapshot", str(path)], capsys)
    assert rc == (0 if ready else 2)
    assert ("engine[0]: warmed=['search']" in out) == ready
    missing = ["doctor", "--snapshot", str(tmp_path / "none.json")]
    assert pmain(missing) == jmain(missing) == 1


def test_cli_index_status_render(tmp_path, capsys):
    from knn_tpu_torch import MutableIndex
    from knn_tpu_torch.cli import main

    path = tmp_path / "snap.json"
    obs.write_json_snapshot(str(path))
    rc, out = _cli(main, ["index", "--snapshot", str(path)], capsys)
    assert rc == 2 and "no mutable index" in out
    idx = MutableIndex(np.eye(16, dtype=np.float32), k=2, reserve=2,
                       device="cpu")
    idx.delete([3])
    obs.write_json_snapshot(str(path))
    rc, out = _cli(main, ["index", "--snapshot", str(path)], capsys)
    assert rc == 0 and out.startswith("index[0]: epoch=0 rows=16")
    assert "tombstones=1/" in out


# -- the package rules ------------------------------------------------------
def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    mods = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


def test_no_obs_module_imports_torch_jax_or_knn_tpu_at_top_level():
    files = sorted((REPO / "knn_tpu_torch" / "obs").glob("*.py"))
    assert {f.stem for f in files} >= {
        "__init__", "names", "ident", "registry", "trace", "export",
        "profiler", "roofline", "health", "slo", "audit", "drift",
        "waterfall", "blackbox"}
    for f in files:
        for mod in _top_level_imports(f):
            root = mod.split(".")[0]
            assert root not in ("torch", "jax", "knn_tpu", "triton"), (
                f.name, mod)
            if root == "knn_tpu_torch":
                assert mod.startswith("knn_tpu_torch.obs"), (f.name, mod)
