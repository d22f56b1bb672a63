"""The port's fleet plane (knn_tpu_torch.obs.fleet, ident.set_identity,
/fleetz, ``cli fleet``) against the JAX package's (knn_tpu.obs.fleet) on
the same member snapshots, made by either package.

What is held equal: on one snapshot directory, the port's merge and the
JAX package's — counters bitwise, gauges per host, histogram buckets and
the quantiles taken from their sum, the member keys, the unreachable /
stale / skewed lists, the ``fleet`` artifact block (valid under the JAX
package's schema) and the text rendering.  The port counterparts of
tests/test_fleet.py's 14 tests follow, with the port's own knobs (members
and staleness as arguments, the fleet SLO through the configured
objectives) and ``/fleetz`` over a live member beside a snapshot one.
"""

import json
import os
import urllib.request

import pytest

from knn_tpu import obs as jobs
from knn_tpu.analysis import artifacts
from knn_tpu.obs import fleet as jfleet
from knn_tpu_torch import obs
from knn_tpu_torch.cli import main as cli_main
from knn_tpu_torch.obs import fleet
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.obs import registry

PKGS = {"port": obs, "jax": jobs}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(jfleet.MEMBERS_ENV, raising=False)
    for pkg in PKGS.values():
        pkg.reset(enabled=True)
        pkg.reset_event_log(None)
        pkg.ident.reset_identity()
    fleet.reset_fleet_engine()
    jfleet.reset_fleet_engine()
    fleet.configure()
    yield
    obs.reset()
    obs.reset_event_log()
    obs.ident.reset_identity()
    obs.reset_slo_engine()
    obs.blackbox.configure(None)
    fleet.reset_fleet_engine()
    fleet.configure()
    jobs.reset()
    jobs.reset_event_log(from_env=True)
    jobs.ident.reset_identity()
    jfleet.reset_fleet_engine()


def _write_member(pkg, d, fname, pindex, fill, *, host=None):
    """One member snapshot written by package ``pkg``: a fresh registry
    stamped as process ``pindex`` with ``fill(pkg)``'s metrics."""
    pkg.reset(enabled=True)
    pkg.ident.set_identity(host=host or f"h{pindex}", process_index=pindex,
                           process_count=2, device_kind="cpu")
    fill(pkg)
    payload = pkg.write_json_snapshot(os.path.join(d, fname))
    pkg.ident.reset_identity()
    pkg.reset(enabled=True)
    return payload


def _two_member_dir(tmp_path, maker="port",
                    latencies=((0.004,) * 30, (2.5,) * 10)):
    """Member 0 serves 5 requests (fast), member 1 serves 7 (slow)."""
    pkg = PKGS[maker]
    d = str(tmp_path / f"snaps_{maker}")
    os.makedirs(d, exist_ok=True)

    def filler(requests, depth, lat):
        def fill(p):
            p.counter(mn.SERVING_REQUESTS, op="search").inc(requests)
            p.gauge(mn.QUEUE_DEPTH_REQUESTS).set(depth)
            h = p.histogram(mn.SERVING_REQUEST_LATENCY, op="search")
            for v in lat:
                h.observe(v)
        return fill

    p0 = _write_member(pkg, d, "m0.json", 0, filler(5, 3, latencies[0]))
    p1 = _write_member(pkg, d, "m1.json", 1, filler(7, 9, latencies[1]))
    return d, p0, p1


def _reports(d, **kw):
    """The port's and the JAX package's report on one directory."""
    return (fleet.fleet_report(snapshot_dir=d, **kw),
            jfleet.fleet_report(snapshot_dir=d, **kw))


_MERGED = ("counters", "gauges", "histograms", "members", "unreachable",
           "skewed", "staleness_s", "partial", "member_count", "expected",
           "catalog_version", "multihost", "waterfalls", "fleet_version")


# -- merge semantics, held against the JAX package ------------------------------
@pytest.mark.parametrize("maker", ["port", "jax"])
def test_counters_sum_bitwise_and_gauges_keep_host(tmp_path, maker):
    d, _, _ = _two_member_dir(tmp_path, maker)
    rep, ref = _reports(d)
    for key in _MERGED:
        assert rep[key] == ref[key], key
    assert rep["enabled"] and not rep["partial"]
    assert rep["member_count"] == 2 and rep["expected"] == 2
    [c] = rep["counters"][mn.SERVING_REQUESTS]
    assert c["labels"] == {"op": "search"} and c["value"] == 12.0
    assert c["per_host"] == {"h0/0": 5.0, "h1/1": 7.0}
    [c2] = fleet.fleet_report(snapshot_dir=d)["counters"][
        mn.SERVING_REQUESTS]
    assert c2["value"] == c["value"]
    [g] = rep["gauges"][mn.QUEUE_DEPTH_REQUESTS]
    assert g["per_host"] == {"h0/0": 3.0, "h1/1": 9.0}
    assert g["min"] == 3.0 and g["max"] == 9.0 and g["argmax"] == "h1/1"


def test_snapshots_of_both_packages_merge_alike(tmp_path):
    """The port writes the snapshot the JAX package writes: the merges of
    the two directories agree but for the identities' host pids."""
    dp, _, _ = _two_member_dir(tmp_path, "port")
    dj, _, _ = _two_member_dir(tmp_path, "jax")
    rp = fleet.fleet_report(snapshot_dir=dp)
    rj = fleet.fleet_report(snapshot_dir=dj)
    for key in ("counters", "histograms", "gauges"):
        assert rp[key] == rj[key], key


def test_fleet_quantiles_from_merged_buckets_never_averaged(tmp_path):
    d, p0, p1 = _two_member_dir(tmp_path)
    rep, ref = _reports(d)
    [h] = rep["histograms"][mn.SERVING_REQUEST_LATENCY]
    assert h == ref["histograms"][mn.SERVING_REQUEST_LATENCY][0]
    assert h["count"] == 40.0
    fq = h["fleet_quantiles"]
    assert fq["source"] == "merged_buckets"
    assert fq["p50"] < 0.1 and fq["p99"] >= 2.5
    w0 = h["window_quantiles_per_host"]["h0/0"]
    w1 = h["window_quantiles_per_host"]["h1/1"]
    assert abs(fq["p50"] - (w0["p50"] + w1["p50"]) / 2) > 0.5

    def _buckets(payload):
        [s] = payload["metrics"][mn.SERVING_REQUEST_LATENCY]["series"]
        return s["value"]["buckets"]

    assert h["buckets"] == [a + b for a, b in
                            zip(_buckets(p0), _buckets(p1))]
    assert fq["p99"] >= max(w0["p99"], w1["p99"]) * 0.99


def test_identity_stamps_every_payload_and_keys_the_merge(tmp_path):
    d, p0, _ = _two_member_dir(tmp_path)
    ident = p0["identity"]
    assert ident["host"] == "h0" and ident["process_index"] == 0
    assert ident["process_count"] == 2 and "pid" in ident
    assert ident["catalog_version"] == mn.catalog_version() == \
        jobs.names.catalog_version()
    rep = fleet.fleet_report(snapshot_dir=d)
    assert [m["key"] for m in rep["members"]] == ["h0/0", "h1/1"]
    for m in rep["members"]:
        assert m["identity"]["catalog_version"] == mn.catalog_version()
        assert m["written_at_unix"] is not None
    # the stamp rides the event log too, and a mistyped field is refused
    obs.ident.set_identity(process_index=3)
    assert obs.ident.identity()["process_index"] == 3
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unknown identity field"):
            pkg.ident.set_identity(proces_index=1)
    obs.ident.reset_identity()
    assert obs.ident.identity()["process_index"] == 0


def test_fleet_gauges_published_and_artifact_block_validates(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    rep, ref = _reports(d)
    snap = registry.snapshot()
    assert snap[mn.FLEET_MEMBERS]["series"][0]["value"] == 2.0
    assert snap[mn.FLEET_UNREACHABLE]["series"][0]["value"] == 0.0
    assert snap[mn.FLEET_MERGE_STALENESS]["series"][0]["value"] == \
        rep["staleness_s"]
    assert not {mn.FLEET_MEMBERS, mn.FLEET_UNREACHABLE,
                mn.FLEET_MERGE_STALENESS, mn.FLEET_STRAGGLER_HOST} & \
        mn.UNWRITTEN
    block = fleet.artifact_block(rep)
    assert block == jfleet.artifact_block(ref)
    assert artifacts.validate("fleet", block) == []
    assert block["member_count"] == 2 and block["partial"] is False
    assert block["fleet_version"] == fleet.FLEET_VERSION


# -- degraded modes -------------------------------------------------------------
def test_torn_snapshot_listed_unreachable_and_cli_exits_2(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    with open(os.path.join(d, "m0.json")) as f:
        good = f.read()
    with open(os.path.join(d, "torn.json"), "w") as f:
        f.write(good[: len(good) // 2])
    rep, ref = _reports(d)
    assert rep["unreachable"] == ref["unreachable"]
    assert rep["partial"] is True and rep["member_count"] == 2
    [u] = rep["unreachable"]
    assert u["member"] == "torn.json" and "JSONDecodeError" in u["reason"]
    [c] = rep["counters"][mn.SERVING_REQUESTS]
    assert c["value"] == 12.0 and rep["expected"] == 3
    block = fleet.artifact_block(rep)
    assert block["unreachable_count"] == 1 and block["partial"] is True
    assert artifacts.validate("fleet", block) == []
    assert cli_main(["fleet", "--snapshot-dir", d]) == 2


def test_unreachable_live_member_degrades_loudly():
    recs = fleet.collect_live(["127.0.0.1:9"], timeout_s=0.3)
    assert recs[0]["error"] is not None
    rep = fleet.fleet_report(["127.0.0.1:9"], timeout_s=0.3)
    assert rep["partial"] is True and rep["member_count"] == 0
    [u] = rep["unreachable"]
    assert u["member"] == "127.0.0.1:9"
    assert cli_main(["fleet", "--members", "127.0.0.1:9",
                     "--timeout", "0.3"]) == 2


def test_stale_snapshot_refused(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    p = os.path.join(d, "m0.json")
    with open(p) as f:
        payload = json.load(f)
    payload["written_at_unix"] -= 1000.0
    with open(p, "w") as f:
        json.dump(payload, f)
    rep, ref = _reports(d, stale_s=120.0)
    for key in _MERGED:
        assert rep[key] == ref[key], key
    assert rep["partial"] is True and rep["member_count"] == 1
    [u] = rep["unreachable"]
    assert u["member"] == "m0.json" and "stale snapshot" in u["reason"]
    [c] = rep["counters"][mn.SERVING_REQUESTS]
    assert c["value"] == 7.0 and list(c["per_host"]) == ["h1/1"]
    assert cli_main(["fleet", "--snapshot-dir", d, "--stale-s", "120"]) == 2
    # the configured threshold is the default of a report
    fleet.configure(stale_s=5000.0)
    assert fleet.fleet_report(snapshot_dir=d)["partial"] is False


def test_catalog_version_skew_refused(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    p = os.path.join(d, "m1.json")
    with open(p) as f:
        payload = json.load(f)
    payload["identity"]["catalog_version"] = "deadbeefcafe"
    with open(p, "w") as f:
        json.dump(payload, f)
    rep, ref = _reports(d)
    assert rep["skewed"] == ref["skewed"]
    assert rep["partial"] is True and rep["member_count"] == 1
    [s] = rep["skewed"]
    assert s["member"] == "m1.json" and s["catalog_version"] == "deadbeefcafe"
    assert s["expected"] == mn.catalog_version()
    [c] = rep["counters"][mn.SERVING_REQUESTS]
    assert c["value"] == 5.0
    assert fleet.artifact_block(rep)["skewed_count"] == 1
    assert registry.snapshot()[mn.FLEET_UNREACHABLE]["series"][0][
        "value"] == 1.0
    assert cli_main(["fleet", "--snapshot-dir", d]) == 2


def test_cli_fleet_healthy_exit_0_json_and_jax_s_rendering(tmp_path, capsys):
    d, _, _ = _two_member_dir(
        tmp_path, latencies=((0.004,) * 30, (0.008,) * 10))
    assert cli_main(["fleet", "--snapshot-dir", d]) == 0
    out = capsys.readouterr().out
    assert "members merged: 2/2" in out and "PARTIAL" not in out
    assert "merged buckets" in out
    assert cli_main(["fleet", "--snapshot-dir", d, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["member_count"] == 2
    assert fleet.render_text(rep) == jfleet.render_text(rep)
    assert cli_main(["fleet", "--snapshot",
                     os.path.join(d, "m0.json")]) == 0
    # no source at all, or a missing directory: a loud usage error
    assert cli_main(["fleet"]) == 1
    assert cli_main(["fleet", "--snapshot-dir",
                     str(tmp_path / "absent")]) == 1
    assert "no fleet source" in capsys.readouterr().err


# -- multihost section and offline stitching ------------------------------------
def test_straggler_host_named_and_waterfalls_stitched(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    p = os.path.join(d, "m1.json")
    with open(p) as f:
        payload = json.load(f)
    payload["health"] = dict(payload.get("health") or {})
    payload["health"]["multihost"] = {
        "host_walls_s": [0.010, 0.030], "straggler_host": 1,
        "straggler_gap_s": 0.020}
    with open(p, "w") as f:
        json.dump(payload, f)
    with open(os.path.join(d, "events.jsonl"), "w") as f:
        for host in (0, 1):
            f.write(json.dumps({
                "type": "span", "span": "multihost.merge",
                "trace_id": "tid-1", "ts": 100.0, "dur_s": 0.0355,
                "host": host, "hosts": 2, "walls_s": [0.010, 0.030],
                "straggler_host": 1, "straggler_gap_s": 0.020}) + "\n")
    rep, ref = _reports(d)
    assert rep["multihost"] == ref["multihost"]
    assert rep["waterfalls"] == ref["waterfalls"]
    mh = rep["multihost"]
    assert mh["straggler_host"] == 1 and mh["straggler_member"] == "h1/1"
    assert mh["host_walls_s"] == [0.010, 0.030]
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in registry.snapshot()[mn.FLEET_STRAGGLER_HOST]["series"]}
    assert series[(("host", "h1/1"),)] == 1.0
    assert series[(("host", "h0/0"),)] == 0.0
    wf = rep["waterfalls"]["tid-1"]
    assert wf["kind"] == "multihost" and wf["complete"] is True
    assert [s["name"] for s in wf["segments"]] == [
        "host0.local", "host0.wait", "host1.local", "dcn_merge"]
    assert fleet.artifact_block(rep)["stitched_requests"] == 1
    txt = fleet.render_text(rep)
    assert "straggler host1 (h1/1)" in txt
    assert "stitched cross-host waterfalls: 1" in txt
    assert txt == jfleet.render_text(rep)


# -- the fleet SLO edge and its bundles -----------------------------------------
def test_fleet_slo_edge_fires_once_and_bundle_embeds_members(tmp_path):
    pm = str(tmp_path / "pm")
    obs.blackbox.configure(pm)
    d, _, _ = _two_member_dir(tmp_path)
    rep = fleet.fleet_report(snapshot_dir=d)
    o = rep["slo"]["objectives"]["serving_request_p99"]
    assert o["source"] == "merged_buckets" and o["breached"] is True
    assert "serving_request_p99" in rep["slo"]["breached"]

    def alerts():
        return [e for e in obs.get_event_log().recent()
                if e.get("name") == "fleet.alert"]

    assert [a["objective"] for a in alerts()] == ["serving_request_p99"]
    fleet.fleet_report(snapshot_dir=d)
    assert len(alerts()) == 1
    bundles = [f for f in os.listdir(pm) if "fleet_serving_request_p99" in f]
    assert len(bundles) == 1
    with open(os.path.join(pm, bundles[0])) as f:
        bundle = json.load(f)
    assert bundle["kind"] == "fleet"
    assert bundle["objective"] == "serving_request_p99"
    assert set(bundle["members"]) == {"m0.json", "m1.json"}
    for rec in bundle["members"].values():
        assert rec["metrics"] and rec["identity"]
    assert bundle["fleet"]["member_count"] == 2
    assert obs.blackbox._FNAME_RE.match(bundles[0])
    # the same snapshots through the JAX package breach the same objectives
    assert jfleet.fleet_report(snapshot_dir=d)["slo"]["breached"] == \
        rep["slo"]["breached"]


def test_fleet_ratio_objectives_use_lifetime_sums(tmp_path):
    d = str(tmp_path / "snaps")
    os.makedirs(d, exist_ok=True)

    def mk(pindex, errors, requests):
        def fill(p):
            p.counter(mn.SERVING_REQUESTS, op="search").inc(requests)
            if errors:
                p.counter(mn.SERVING_ERRORS, op="search").inc(errors)
        _write_member(obs, d, f"m{pindex}.json", pindex, fill)

    mk(0, 0, 100)
    mk(1, 2, 100)
    rep, ref = _reports(d)
    o = rep["slo"]["objectives"]["serving_availability"]
    assert o == {k: v for k, v in ref["slo"]["objectives"][
        "serving_availability"].items()}
    assert o["source"] == "fleet_lifetime"
    assert o["num"] == 2.0 and o["den"] == 200.0 and o["breached"] is True


def test_fleet_slo_takes_the_configured_objectives(tmp_path):
    d, _, _ = _two_member_dir(tmp_path)
    only = obs.Objective(name="p50_only", kind="quantile",
                         hist=mn.SERVING_REQUEST_LATENCY, quantile="p50",
                         threshold=10.0)
    obs.reset_slo_engine(objectives=[only])
    rep = fleet.fleet_report(snapshot_dir=d)
    assert set(rep["slo"]["objectives"]) == {"p50_only"}
    assert rep["slo"]["breached"] == []


# -- obs off, unconfigured, the settings ----------------------------------------
def test_obs_disabled_turns_fleet_plane_off():
    fleet.configure(members=["127.0.0.1:9"])
    obs.reset(enabled=False)
    rep = fleet.live_fleet_report()
    assert rep["enabled"] is False and "telemetry disabled" in rep["reason"]
    block = fleet.artifact_block(rep)
    assert block["member_count"] == 0 and "error" in block
    assert artifacts.validate("fleet", block) == []
    assert registry.snapshot() == {}


def test_unconfigured_live_report_is_loud():
    rep = fleet.live_fleet_report()
    assert rep["enabled"] is False
    assert "fleet.configure(members=...)" in rep["reason"]
    assert fleet.fleet_report()["enabled"] is False


def test_members_and_staleness_are_arguments():
    fleet.configure(members="a:1, b:2 c:3", stale_s=30)
    assert fleet.fleet_members() == ["a:1", "b:2", "c:3"]
    assert fleet.stale_threshold_s() == 30.0
    with pytest.raises(ValueError, match="stale_s"):
        fleet.configure(stale_s=-1)
    fleet.configure()
    assert fleet.fleet_members() == [] and \
        fleet.stale_threshold_s() == fleet.DEFAULT_STALE_S == \
        jfleet.DEFAULT_STALE_S


# -- /fleetz and a live member beside a snapshot one ----------------------------
def test_fleetz_and_a_live_member_beside_a_snapshot(tmp_path):
    """A running process's /metrics.json and /statusz collected live, a
    second member's snapshot under set_identity(process_index=1): the
    merged counters are the two members' sum; /fleetz serves the merge over
    the configured members."""
    obs.counter(mn.SERVING_REQUESTS, op="search").inc(4)
    server = obs.start_metrics_server(0)
    try:
        ep = f"127.0.0.1:{server.server_address[1]}"
        live = fleet.collect_live([ep])
        assert live[0]["error"] is None and live[0]["health"]
        obs.ident.set_identity(process_index=1, process_count=2)
        snap = str(tmp_path / "member1.json")
        obs.write_json_snapshot(snap)
        obs.ident.reset_identity()
        rep = fleet.merge(live + fleet.collect_snapshot_files([snap]))
        assert rep["member_count"] == 2 and not rep["partial"]
        [c] = rep["counters"][mn.SERVING_REQUESTS]
        assert c["value"] == 8.0 and sorted(c["per_host"].values()) == \
            [4.0, 4.0]
        assert sorted(m["identity"]["process_index"]
                      for m in rep["members"]) == [0, 1]
        fleet.configure(members=[ep])
        body = json.loads(urllib.request.urlopen(
            f"http://{ep}/fleetz", timeout=10).read())
        assert body["enabled"] and body["member_count"] == 1
        [c] = body["counters"][mn.SERVING_REQUESTS]
        assert c["value"] == 4.0
    finally:
        server.shutdown()
        server.server_close()
