"""The port's request waterfalls and flight recorder
(knn_tpu_torch.obs.{waterfall, blackbox}, ``/waterfallz``, ``cli
waterfall``) against the JAX package's (knn_tpu.obs.{waterfall,
blackbox}).

What is held equal, on the same event lists: ``reconstruct``,
``attribute``, ``device_vs_roofline`` (one explicit ``ceiling_qps`` in
both), ``stitch_multihost``, ``live_report``'s sections, the renderings,
and ``slowest_table`` over the same exemplars (but each exemplar's wall
``ts``).  The event lists are the JAX package's own fixtures
(tests/test_waterfall.py ``_emit_queued``, tests/test_fleet.py's
``multihost.merge`` spans), a JAX serving trace and a port serving trace.
``read_jsonl_events`` merges a rotated log alike.  ``cli waterfall`` prints
the JAX package's lines and exit codes for a bundle written by either
package and for a JSONL log.  On the port alone: a live CPU ``QueryQueue``
and ``ServingEngine`` trace rebuilds with every request tiling within its
tolerance; the flight recorder writes exactly one bundle per breach
transition, prunes to ``keep`` and degrades to an event; obs off leaves no
forensics; ``/waterfallz`` serves the live report.
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from knn_tpu import obs as jobs
from knn_tpu.obs import blackbox as jblackbox
from knn_tpu.obs import trace as jtrace
from knn_tpu.obs import waterfall as jwf
from knn_tpu_torch import obs
from knn_tpu_torch.obs import blackbox, slo, trace
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.obs import waterfall

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from test_torch_obs import port_wording

K = 5
DIM = 12
BUCKETS = (8, 16)
WAIT = 60.0


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(jblackbox.DIR_ENV, raising=False)
    for pkg in (obs, jobs):
        pkg.reset(enabled=True)
        pkg.reset_event_log(None)
        pkg.reset_slo_engine()
        pkg.health.reset()
        pkg.roofline.reset()  # device_vs_roofline's default ceiling
    blackbox.configure()
    yield
    monkeypatch.delenv(jblackbox.DIR_ENV, raising=False)
    for pkg in (obs, jobs):
        pkg.reset()
        pkg.reset_slo_engine()
        pkg.health.reset()
    obs.reset_event_log()
    jobs.reset_event_log(from_env=True)
    blackbox.configure()


def _tile_error(w):
    return abs(w["total_s"] - sum(s["dur_s"] for s in w["segments"])
               + w["overlap_s"])


def _views(mod, events, ceiling=50_000.0):
    wfs = mod.reconstruct(events)
    return {"waterfalls": wfs, "attribution": mod.attribute(wfs),
            "dvr": mod.device_vs_roofline(wfs, ceiling_qps=ceiling),
            "dvr_none": mod.device_vs_roofline(wfs),
            "stitched": mod.stitch_multihost(events),
            "text": ([mod.render_waterfall(w) for w in wfs.values()]
                     + [mod.render_attribution(
                         mod.attribute(wfs),
                         mod.device_vs_roofline(wfs, ceiling_qps=ceiling))])}


def _fixture_events():
    """The JAX package's event fixtures, emitted through its trace."""
    from test_waterfall import _emit_queued

    _emit_queued("aaaa000000000001", "bbbb000000000001", total=0.5,
                 batch_spans=False)
    _emit_queued("cccc000000000001", "dddd000000000001", queue_wait=0.4,
                 request=0.4, total=0.05)
    for j in range(12):
        _emit_queued(f"ee{j:014d}", f"ff{j:014d}",
                     queue_wait=0.002 * (j + 1), request=0.004 + 0.001 * j,
                     join=0.001 * (j % 3 + 1))
    tid = "cafe000000000001"
    jtrace.record_span("serving.dispatch", tid, 0.002, rows=4, buckets=[8],
                       op="search")
    jtrace.record_span("serving.join", tid, 0.001, op="search")
    jtrace.record_span("serving.request", tid, 0.4, rows=4, op="search")
    events = jobs.get_event_log().recent()
    for host in (0, 1):  # tests/test_fleet.py:275
        events.append({"type": "span", "span": "multihost.merge",
                       "trace_id": "tid-1", "ts": 100.0, "dur_s": 0.0355,
                       "host": host, "hosts": 2,
                       "walls_s": [0.010, 0.030], "straggler_host": 1,
                       "straggler_gap_s": 0.020})
    events.append({"type": "span", "span": "multihost.merge",
                   "trace_id": "tid-2", "ts": 101.0, "dur_s": 0.2,
                   "host": 0, "hosts": 3, "walls_s": [0.01, 0.02, 0.05]})
    return events


def test_reconstruction_of_the_jax_fixtures_equals_jax():
    events = _fixture_events()
    port, ref = _views(waterfall, events), _views(jwf, events)
    assert port == ref
    wfs = port["waterfalls"]
    assert not wfs["aaaa000000000001"]["complete"]
    assert wfs["aaaa000000000001"]["segments"][-1]["name"] == "unattributed"
    assert wfs["cccc000000000001"]["overlap_s"] > \
        wfs["cccc000000000001"]["tolerance_s"]
    assert port["stitched"]["tid-1"]["complete"]
    assert [s["name"] for s in port["stitched"]["tid-1"]["segments"]] == [
        "host0.local", "host0.wait", "host1.local", "dcn_merge"]
    assert port["dvr"]["verdict"] is not None


def _serve(mods, qdata, tenant_of):
    """Queued and direct traffic through one package's engine."""
    queue_cls, eng = mods
    with queue_cls(eng, max_wait_ms=10.0) as qq:
        futs = [qq.submit(qdata[:s], tenant=tenant_of(i))
                for i, s in enumerate((2, 3, 4, 1, 5, 2, 3, 4))]
        for f in futs:
            f.result(timeout=WAIT)
    h = eng.submit(qdata[:3], tenant="direct-t")
    h.result()
    return [f.trace_id for f in futs], h.trace_id


@pytest.fixture(scope="module")
def engines():
    from knn_tpu.parallel import ShardedKNN as JaxShardedKNN
    from knn_tpu.parallel import make_mesh
    from knn_tpu.serving import QueryQueue as JaxQueue
    from knn_tpu.serving import ServingEngine as JaxServingEngine
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import QueryQueue, ServingEngine

    rng = np.random.default_rng(3)
    db = rng.standard_normal((400, DIM)).astype(np.float32)
    eng = ServingEngine(ShardedKNN(db, k=K, device="cpu"), buckets=BUCKETS)
    eng.warmup()
    jeng = JaxServingEngine(JaxShardedKNN(db, mesh=make_mesh(1, 1), k=K),
                            buckets=BUCKETS)
    jeng.warmup()
    qdata = rng.standard_normal((64, DIM)).astype(np.float32)
    return {"port": (QueryQueue, eng), "jax": (JaxQueue, jeng),
            "q": qdata}


def _tenant(i):
    return "gold" if i % 2 else "free"


@pytest.mark.parametrize("side", ["port", "jax"])
def test_a_serving_trace_reconstructs_alike_in_both_packages(engines,
                                                             side):
    pkg = obs if side == "port" else jobs
    tids, direct = _serve(engines[side], engines["q"], _tenant)
    events = pkg.get_event_log().recent()
    port, ref = _views(waterfall, events), _views(jwf, events)
    assert port == ref
    wfs = port["waterfalls"]
    for i, tid in enumerate(tids):
        w = wfs[tid]
        assert w["kind"] == "queued" and w["tenant"] == _tenant(i)
        assert w["bucket"] in BUCKETS
        assert _tile_error(w) < 1e-4 and w["complete"], w
        assert [s["name"] for s in w["segments"]][:7] == list(
            waterfall.SEGMENTS)
        assert wfs[w["batch_trace_id"]]["kind"] == "batch"
    w = wfs[direct]
    assert w["kind"] == "direct" and w["tenant"] == "direct-t"
    assert w["complete"] and _tile_error(w) < 1e-4
    assert [s["name"] for s in w["segments"]][:4] == list(
        waterfall.DIRECT_SEGMENTS)
    assert port["attribution"]["requests"] == len(tids) + 1
    assert set(port["attribution"]["by_tenant"]) == {
        "gold", "free", "direct-t"}


def test_slowest_table_over_the_same_exemplars_equals_jax():
    events = _fixture_events()
    for pkg in (obs, jobs):
        for j in range(12):
            tid = f"ee{j:014d}"
            pkg.histogram(mn.QUEUE_REQUEST_LATENCY).observe(
                0.01 + 0.001 * j, exemplar=tid)
            pkg.histogram(mn.TENANT_REQUEST_LATENCY, tenant="t").observe(
                0.02 + 0.001 * j, exemplar=tid)
        pkg.histogram(mn.SERVING_REQUEST_LATENCY, op="search").observe(
            0.4, exemplar="cafe000000000001")

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    for kw in ({}, {"top": 3}, {"with_waterfalls": False}):
        port = waterfall.slowest_table(events=events, **kw)
        ref = jwf.slowest_table(events=events, **kw)
        assert strip(port) == strip(ref)
    assert port[0]["trace_id"] == "cafe000000000001"
    rep, jrep = waterfall.live_report(events), jwf.live_report(events)
    for key in ("requests", "waterfalls", "attribution", "multihost"):
        assert rep[key] == jrep[key], key
    assert strip(rep["slowest"]) == strip(jrep["slowest"])


def test_device_vs_roofline_reads_the_ports_published_ceiling():
    from knn_tpu_torch.obs import roofline

    events = _fixture_events()
    wfs = waterfall.reconstruct(events)
    assert waterfall.device_vs_roofline(wfs)["ceiling_qps"] is None
    block = roofline.attribute(roofline.pallas_cost_model(
        n=100_000, d=128, k=10, nq=1024,
        device_kind="NVIDIA H100 80GB HBM3"), 1000.0)
    roofline.publish("h100-test", block)
    try:
        got = waterfall.device_vs_roofline(wfs)
        assert got["ceiling_qps"] == block["ceiling_qps"] > 0
        assert got == waterfall.device_vs_roofline(
            wfs, ceiling_qps=block["ceiling_qps"])
    finally:
        roofline.reset()


def test_rotated_log_merges_like_jax(tmp_path):
    path = str(tmp_path / "events.jsonl")
    obs.reset_event_log(path, max_bytes=2000)
    tid, bid = "eeee000000000001", "ffff000000000001"
    trace.record_span("serving.admission", tid, 0.001, rows=1)
    trace.record_span("serving.queue_wait", tid, 0.030, rows=1)
    i = 0
    while not os.path.exists(path + ".1"):
        trace.emit_event("filler", i=i)
        i += 1
        assert i < 100, "rotation never triggered"
    trace.record_span("serving.dispatch", bid, 0.002, rows=1, buckets=[8],
                      op="search")
    trace.record_span("serving.join", bid, 0.003, op="search")
    trace.record_span("serving.request", bid, 0.006, rows=1, op="search")
    trace.record_span("serving.deliver", tid, 0.0005)
    trace.record_span("serving.queued_request", tid, 0.0375, rows=1,
                      op="search", batch_trace_id=bid)
    obs.get_event_log().close()
    cur = open(path).read()
    assert "serving.queue_wait" not in cur
    cur_events = [json.loads(ln) for ln in cur.splitlines()]
    assert not waterfall.reconstruct(cur_events)[tid]["complete"]
    events = waterfall.read_jsonl_events(path)
    assert events == jwf.read_jsonl_events(path)
    w = waterfall.reconstruct(events)[tid]
    assert w["complete"] and _tile_error(w) < 1e-4
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"a": 1}\nnot json\n')
    for mod in (waterfall, jwf):
        with pytest.raises(ValueError, match="not JSON"):
            mod.read_jsonl_events(str(bad))
        with pytest.raises(FileNotFoundError):
            mod.read_jsonl_events(str(tmp_path / "none.jsonl"))


def test_live_queue_trace_tiles_and_stats_carry_slowest(engines):
    """A live CPU QueryQueue + ServingEngine trace on the port: every
    request rebuilds within its tolerance; ``stats()`` carries the
    slowest table (no inline waterfalls), ``/statusz`` and doctor carry
    it with them."""
    queue_cls, eng = engines["port"]
    obs.health.register_engine(eng)
    with queue_cls(eng, max_wait_ms=5.0) as qq:
        futs = [qq.submit(engines["q"][j:j + 1 + j % 4],
                          tenant=_tenant(j)) for j in range(32)]
        for f in futs:
            f.result(timeout=WAIT)
    wfs = waterfall.reconstruct(obs.get_event_log().recent())
    for f in futs:
        w = wfs[f.trace_id]
        assert w["complete"] and w["unattributed_s"] <= w["tolerance_s"]
        assert w["overlap_s"] <= w["tolerance_s"]
    rows = eng.stats()["slowest_requests"]
    assert rows and "waterfall" not in rows[0]
    lats = [r["latency_s"] for r in rows]
    assert lats == sorted(lats, reverse=True)
    rep = obs.health.report()
    deep = [r for r in rep["slowest_requests"] if r.get("waterfall")]
    assert deep
    text = obs.health.render_text(rep)
    assert text == port_wording(jobs.health.render_text(rep))
    assert "slowest recent request" in text and deep[0]["trace_id"] in text


def test_obs_off_leaves_no_forensics(engines):
    queue_cls, eng = engines["port"]
    obs.reset(enabled=False)
    obs.reset_event_log(None)
    with queue_cls(eng, max_wait_ms=1.0) as qq:
        fut = qq.submit(engines["q"][:3])
        fut.result(timeout=WAIT)
    assert fut.trace_id is None
    assert obs.get_event_log().recent() == []
    st = eng.stats()
    assert not {"slowest_requests", "slo"} & set(st)
    assert waterfall.slowest_table() == []
    assert waterfall.reconstruct([]) == {}


# -- the flight recorder ---------------------------------------------------
def _force_breach(eng, *, now0=0.0, now1=300.0):
    eng.evaluate(now=now0)
    obs.counter(mn.SERVING_REQUESTS, op="search").inc(100)
    obs.counter(mn.SERVING_ERRORS, op="search").inc(50)
    return eng.evaluate(now=now1)


def test_exactly_one_bundle_per_breach_transition(tmp_path):
    """tests/test_waterfall.py:340 on the port."""
    d = tmp_path / "pm"
    blackbox.configure(postmortem_dir=str(d))
    tid = "cafe000000000001"
    trace.record_span("serving.dispatch", tid, 0.002, rows=4, buckets=[8],
                      op="search")
    trace.record_span("serving.join", tid, 0.001, op="search")
    trace.record_span("serving.request", tid, 0.4, rows=4, op="search")
    obs.histogram(mn.SERVING_REQUEST_LATENCY, op="search").observe(
        0.4, exemplar=tid)
    eng = slo.SLOEngine()
    rep = _force_breach(eng)
    assert "serving_availability" in rep["breached"]
    bundles = sorted(os.listdir(d))
    assert len(bundles) == 1
    eng.evaluate(now=310.0)
    assert len(os.listdir(d)) == 1
    assert obs.counter(mn.POSTMORTEMS_WRITTEN,
                       objective="serving_availability").get() == 1.0
    b = blackbox.read_bundle(str(d / bundles[0]))
    assert b["version"] == blackbox.BUNDLE_VERSION
    assert (b["objective"], b["state"]) == ("serving_availability",
                                            "firing")
    assert set(b) == {"version", "written_at", "pid", "objective", "state",
                      "breach_detail", "slo", "statusz", "metrics",
                      "events", "slowest", "attribution",
                      "device_vs_roofline", "env", "audit", "calibration"}
    ex = [r for r in b["slowest"] if r["trace_id"] == tid]
    assert ex and ex[0]["waterfall"]["kind"] == "direct"
    assert b["slo"]["breached"] == rep["breached"]
    assert b["statusz"]["slo"]["breached"] == rep["breached"]
    pm = obs.health.report()["postmortems"]
    assert pm["dir"] == str(d)
    assert [x["file"] for x in pm["bundles"]] == bundles
    obs.counter(mn.SERVING_REQUESTS, op="search").inc(100000)
    eng.evaluate(now=700.0)
    obs.counter(mn.SERVING_ERRORS, op="search").inc(60000)
    assert "serving_availability" in eng.evaluate(now=1400.0)["breached"]
    assert len(os.listdir(d)) == 2


def test_retention_cap_and_disabled_modes(tmp_path):
    """tests/test_waterfall.py:399 on the port: ``keep`` and the directory
    are arguments."""
    d = tmp_path / "pm"
    blackbox.configure(postmortem_dir=str(d), keep=2)
    for i in range(4):
        assert blackbox.on_breach(f"obj_{i}", {"i": i}) is not None
    files = sorted(os.listdir(d))
    assert len(files) == 2
    assert files[0].endswith("obj_2.json") and files[1].endswith(
        "obj_3.json")
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    blackbox.configure(postmortem_dir=str(blocker / "sub"), keep=2)
    assert blackbox.on_breach("obj_x", {}) is None
    assert [e for e in obs.get_event_log().recent()
            if e.get("name") == "postmortem.error"]
    blackbox.configure(keep=2)
    assert not blackbox.enabled()
    assert blackbox.on_breach("obj_y", {}) is None
    assert blackbox.status() == {"dir": None, "keep": 2, "bundles": []}
    blackbox.configure(postmortem_dir=str(d), keep=2)
    obs.reset(enabled=False)
    assert not blackbox.enabled()
    assert blackbox.on_breach("obj_z", {}) is None
    assert len(os.listdir(d)) == 2
    for bad in (0, -1):
        with pytest.raises(ValueError, match="keep"):
            blackbox.configure(postmortem_dir=str(d), keep=bad)


# -- cli waterfall and /waterfallz -------------------------------------------
def _cli(main, argv, capsys):
    rc = main(["waterfall", *argv])
    captured = capsys.readouterr()
    return rc, captured.out


def test_cli_waterfall_prints_what_jax_prints(tmp_path, capsys,
                                              monkeypatch):
    """tests/test_waterfall.py:455 on both CLIs: a bundle written by the
    port, one written by the JAX package, and a JSONL log."""
    from knn_tpu.cli import main as jmain
    from knn_tpu_torch.cli import main as pmain

    tid = "beef000000000001"
    log_path = str(tmp_path / "events.jsonl")
    blackbox.configure(postmortem_dir=str(tmp_path / "pm"))
    monkeypatch.setenv(jblackbox.DIR_ENV, str(tmp_path / "jpm"))
    bundles = {}
    for side, pkg, tr, bb in (("port", obs, trace, blackbox),
                              ("jax", jobs, jtrace, jblackbox)):
        pkg.reset_event_log(log_path + "." + side)
        tr.record_span("serving.dispatch", tid, 0.002, rows=2, buckets=[8],
                       op="search")
        tr.record_span("serving.join", tid, 0.001, op="search")
        tr.record_span("serving.request", tid, 0.02, rows=2, op="search")
        pkg.histogram(mn.SERVING_REQUEST_LATENCY, op="search").observe(
            0.02, exemplar=tid)
        bundles[side] = bb.on_breach("serving_availability", {"w": 1})
        assert bundles[side]
        pkg.get_event_log().close()
    for side in ("port", "jax"):
        for argv in (["--bundle", bundles[side]],
                     ["--bundle", bundles[side], "--json"],
                     ["--log", log_path + "." + side],
                     ["--log", log_path + "." + side, "--trace-id", tid],
                     ["--log", log_path + "." + side, "--top", "0"]):
            got = _cli(pmain, argv, capsys)
            assert got == _cli(jmain, argv, capsys), (side, argv)
            assert got[0] == 0
        assert tid in _cli(pmain, ["--bundle", bundles[side]], capsys)[1]
    assert set(json.load(open(bundles["port"]))) == set(
        json.load(open(bundles["jax"])))
    for argv in (["--bundle", str(tmp_path / "missing.json")],
                 ["--log", str(tmp_path / "missing.jsonl")]):
        assert _cli(pmain, argv, capsys)[0] == \
            _cli(jmain, argv, capsys)[0] == 1


def test_waterfallz_endpoint_serves_the_live_report(engines, capsys):
    from knn_tpu_torch.cli import main as pmain

    _, eng = engines["port"]
    h = eng.submit(engines["q"][:2])
    h.result()
    server = obs.start_metrics_server(0)
    try:
        port = server.server_address[1]
        payload = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/waterfallz", timeout=30).read())
        rc = pmain(["waterfall", "--port", str(port)])
        out = capsys.readouterr().out
    finally:
        server.shutdown()
        server.server_close()
    assert h.trace_id in payload["waterfalls"]
    assert set(payload) == {"generated_at", "requests", "waterfalls",
                            "attribution", "device_vs_roofline", "slowest",
                            "multihost"}
    assert rc == 0 and h.trace_id in out
