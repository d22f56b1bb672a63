"""The port's measured-ceiling loop (knn_tpu_torch.obs.{traceread,
calibrate}, the roofline's calibration overlay, knn_tpu_torch.campaign)
against the JAX package's (knn_tpu.obs.{traceread, calibrate},
knn_tpu.campaign) on the CPU.

What is held equal: the summary of the checked-in trace fixture, the
refusals of malformed artifacts, the host-phase sample, and ``reconcile``
on blocks whose three term times match term for term (the select
overlapped, so both ceilings are the largest term): factors, method and
residuals.  What is the port's own: the body-marker rule on a trace that
holds warm-up kernels (its busy time equals ``profiler.summarize``'s), a
port CPU trace read back from disk, the store's key format (the JAX
package's, with the port's model token), the overlay's refusals, the
published gauges, ``health`` and bundles carrying the live section, the
rehearse campaign end to end, and the settings as arguments (no
environment switch).
"""

import glob
import gzip
import json
import os
import shutil
import types

import numpy as np
import pytest

from knn_tpu.obs import calibrate as jcal
from knn_tpu.obs import roofline as jrl
from knn_tpu.obs import traceread as jtr
from knn_tpu_torch import obs
from knn_tpu_torch.obs import calibrate, health, profiler
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.obs import roofline as rl
from knn_tpu_torch.obs import traceread

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "minimal.trace.json.gz")
H100 = rl.H100


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(jcal.CAL_ENV, raising=False)
    obs.reset(enabled=True)
    obs.reset_event_log()
    calibrate.configure(None)
    calibrate.reset()
    jcal.reset()
    rl.reset()
    yield
    calibrate.configure(None)
    calibrate.reset()
    jcal.reset()
    rl.reset()
    obs.reset()
    health.reset()
    obs.blackbox.configure(None)


def _model(**kw):
    base = dict(n=1_000_000, d=128, k=100, nq=4096, device_kind=H100)
    base.update(kw)
    return rl.pallas_cost_model(**base)


def _slow_sample(block, factor=2.0, nq=4096):
    return {"source": "host_phase", "nq": nq,
            "device_s": factor * nq / block["ceiling_qps_analytic"]}


# -- traceread ------------------------------------------------------------------
def test_fixture_trace_summary_equals_jax():
    """Two overlapping device kernels (union 700 us) and one apart (100
    us) on the TPU track; the host event does not bill."""
    port = traceread.summarize_events(traceread.read_trace_events(FIXTURE))
    ref = jtr.summarize_events(jtr.read_trace_events(FIXTURE))
    assert port == ref
    assert port["device_busy_s"] == pytest.approx(800e-6)
    assert port["kernel_events"] == 3 and port["device_tracks_matched"]


def test_read_section_in_the_jax_layout_equals_jax(tmp_path):
    run = tmp_path / "traces" / "m_ode_x" / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    shutil.copy(FIXTURE, run / "host.trace.json.gz")
    port = traceread.read_section(str(tmp_path / "traces"), "m|ode x")
    ref = jtr.read_section(str(tmp_path / "traces"), "m|ode x")
    assert port == ref and port["section"] == "m_ode_x"
    ps = traceread.sample_from_trace(str(tmp_path / "traces"), "m|ode x",
                                     nq=64)
    js = jtr.sample_from_trace(str(tmp_path / "traces"), "m|ode x", nq=64)
    assert {k: ps[k] for k in js} == js
    for mod in (traceread, jtr):
        with pytest.raises(mod.TraceReadError, match="does not exist"):
            mod.read_section(str(tmp_path / "traces"), "other_config")


def test_read_section_takes_the_newest_run_only(tmp_path):
    base = tmp_path / "traces" / "m" / "plugins" / "profile"
    old_run, new_run = base / "r_old", base / "r_new"
    for run in (old_run, new_run):
        run.mkdir(parents=True)
        shutil.copy(FIXTURE, run / "host.trace.json.gz")
    past = os.path.getmtime(new_run) - 60
    os.utime(old_run, (past, past))
    s = traceread.read_section(str(tmp_path / "traces"), "m")
    assert s == jtr.read_section(str(tmp_path / "traces"), "m")
    assert s["runs_found"] == 2
    assert s["trace_files"] == [str(new_run / "host.trace.json.gz")]
    assert s["device_busy_s"] == pytest.approx(800e-6)


def _malformed(tmp_path, case):
    if case == "not_gzip":
        p = tmp_path / "junk.trace.json.gz"
        p.write_bytes(b"this is not gzip")
        return "read", str(p), None
    if case == "not_json":
        p = tmp_path / "notjson.trace.json.gz"
        with gzip.open(p, "wt") as f:
            f.write("not json {{{")
        return "read", str(p), "not trace"
    if case == "no_events":
        p = tmp_path / "noevents.trace.json.gz"
        with gzip.open(p, "wt") as f:
            json.dump({"metadata": {}}, f)
        return "read", str(p), "no traceEvents"
    if case == "no_complete_events":
        return "summarize", [{"ph": "M", "pid": 1, "name": "process_name",
                              "args": {"name": "/device:TPU:0"}}], \
            "no complete"
    if case == "absent":
        return "find", str(tmp_path / "absent"), "does not exist"
    if case == "empty_capture":
        (tmp_path / "t" / "s").mkdir(parents=True)
        return "section", (str(tmp_path / "t"), "s"), None
    if case == "phases_without_device_s":
        return "phases", {"note": "no probe"}, "device_s"
    if case == "phases_not_dict":
        return "phases", ["device_s", 1.0], "not dict"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "not_gzip", "not_json", "no_events", "no_complete_events", "absent",
    "empty_capture", "phases_without_device_s", "phases_not_dict"])
def test_malformed_artifacts_are_refused_as_jax_refuses_them(tmp_path, case):
    """A silently empty parse would calibrate against nothing: both
    packages raise their TraceReadError on every malformed shape."""
    kind, arg, match = _malformed(tmp_path, case)
    for mod in (traceread, jtr):
        call = {"read": lambda: mod.read_trace_events(arg),
                "summarize": lambda: mod.summarize_events(arg),
                "find": lambda: mod.find_trace_files(arg),
                "section": lambda: mod.read_section(*arg),
                "phases": lambda: mod.sample_from_phases(arg, nq=8)}[kind]
        with pytest.raises(mod.TraceReadError, match=match):
            call()


def test_host_phase_sample_equals_jax():
    pb = {"device_s": 0.5, "device_qps": 8192.0, "h2d_queries_s": 1.2,
          "d2h_transfer_s": 2.4,
          "transport": {"kind": "dev_relay", "latency_corrected": False}}
    for breakdown in (pb, dict(pb, transport={"kind": "pcie",
                                              "latency_corrected": True})):
        assert traceread.sample_from_phases(breakdown, nq=4096) == \
            jtr.sample_from_phases(breakdown, nq=4096)
    assert traceread.sample_from_phases(pb, nq=4096)[
        "relay_phases_excluded_s"] == {"h2d_queries_s": 1.2,
                                       "d2h_transfer_s": 2.4}


def test_port_cpu_trace_reads_back_from_disk(tmp_path):
    """obs.profiler.device_trace on the CPU writes <out>/<section>/
    trace.json; traceread reads it back: a host-only trace (every track
    counted, flagged), whose sample a device fit refuses."""
    import torch

    with profiler.device_trace("cpu|run", out_dir=str(tmp_path)) as cap:
        a = torch.ones(128, 128)
        (a @ a).sum()
    assert os.path.isfile(tmp_path / "cpu_run" / "trace.json")
    s = traceread.read_section(str(tmp_path), "cpu|run")
    assert s["section"] == "cpu_run" and s["runs_found"] == 1
    assert s["trace_files"] == [str(tmp_path / "cpu_run" / "trace.json")]
    assert s["device_tracks_matched"] is False
    assert s["kernel_events"] > 0 and s["device_busy_s"] > 0
    # profiler.summarize saw no device event either
    assert cap.summary()["kernel_events"] == 0
    with pytest.raises(traceread.TraceReadError, match="no device track"):
        traceread.sample_from_trace(str(tmp_path), "cpu|run", nq=8)


def _gpu_trace(n_warm=64, seed=0):
    """A Chrome trace as Kineto writes one for a traced block on the card:
    a host track, a GPU track holding ``n_warm`` warm-up kernels, the
    body marker's device range and, inside it, kernels (two overlapping)
    and a copy; one kernel after the range."""
    rng = np.random.default_rng(seed)
    ev = [{"ph": "M", "name": "process_name", "pid": 4242,
           "args": {"name": "python3"}},
          {"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "GPU 0"}}]
    t = 1000.0
    for _ in range(n_warm):
        ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                   "name": "vectorized_elementwise_kernel", "ts": t,
                   "dur": 1.5})
        t += 2.0
    lo = t + 50.0
    ev.append({"ph": "X", "cat": "user_annotation", "pid": 4242, "tid": 1,
               "name": profiler.BODY_MARKER, "ts": lo - 40.0,
               "dur": 2000.0})
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
               "name": profiler.BODY_MARKER, "ts": lo, "dur": 900.0})
    body = [("binned_select_bf16x3", lo + 10.0, 300.0),
            ("topk_kernel", lo + 200.0, 250.0),  # overlaps the first
            ("Memcpy DtoH (Device -> Pageable)", lo + 600.0, 40.0)]
    body += [(f"refine_{j}", lo + 700.0 + 20.0 * j,
              float(rng.integers(3, 15))) for j in range(5)]
    for name, ts, dur in body:
        ev.append({"ph": "X", "cat": "gpu_memcpy" if name.startswith(
            "Memcpy") else "kernel", "pid": 0, "tid": 7, "name": name,
            "ts": ts, "dur": dur})
    ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
               "name": "after_the_block", "ts": lo + 1500.0, "dur": 100.0})
    ev.append({"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1,
               "name": "aten::mm", "ts": lo, "dur": 5000.0})
    return ev


def _function_events(chrome):
    """The same trace as profiler FunctionEvents (name, device_type,
    time_range), the input of profiler.summarize."""
    out = []
    for e in chrome:
        if e.get("ph") != "X":
            continue
        dev = "CUDA" if e["pid"] == 0 else "CPU"
        out.append(types.SimpleNamespace(
            name=e["name"], device_type=types.SimpleNamespace(name=dev),
            time_range=types.SimpleNamespace(start=e["ts"],
                                             end=e["ts"] + e["dur"])))
    return out


@pytest.mark.parametrize("n_warm", [0, 1, 64])
def test_body_marker_range_drops_the_warm_up_kernels(n_warm):
    """Device events count only inside the body marker's device range (the
    range itself not), as profiler.summarize counts them: the busy times
    agree, the warm-up kernels are counted before the body, and the
    kernel after the block is left out."""
    ev = _gpu_trace(n_warm)
    s = traceread.summarize_events(ev)
    ref = profiler.summarize(_function_events(ev))
    assert s["device_tracks_matched"] and s["busiest_track"] == "GPU 0"
    assert s["device_busy_s"] == pytest.approx(
        ref["device_busy_ms"] / 1e3, abs=1e-6)
    assert s["kernel_events"] == ref["kernel_events"] == 8
    assert s["events_before_body"] == ref["device_events_before"] == n_warm
    names = traceread.body_event_names(ev)
    assert "binned_select_bf16x3" in names
    assert "after_the_block" not in names
    assert "vectorized_elementwise_kernel" not in names
    # [10, 310) and [200, 450) overlap (440 us of union), 40, the refines
    refines = sum(e["dur"] for e in ev if e["name"].startswith("refine_"))
    assert s["device_busy_s"] == pytest.approx((440 + 40 + refines) / 1e6)


def test_device_tracks_found_by_category_without_a_name():
    """A GPU track whose process is not named like one is still found by
    its events' categories; a trace with no device event is host-only."""
    ev = [e for e in _gpu_trace(4)
          if not (e.get("ph") == "M" and e.get("pid") == 0)]
    assert traceread.device_pids(ev) == {0: "pid 0"}
    assert traceread.summarize_events(ev)["events_before_body"] == 4
    host = [e for e in ev if e.get("pid") != 0]
    assert traceread.device_pids(host) == {}


# -- reconcile against the JAX package ------------------------------------------
def _matched_blocks(t_hbm, t_tc, t_cc, nq=4096):
    """A JAX block and a port block with the same three term times (mxu ->
    tensor_core, vpu_select -> cuda_core) and the select overlapped, so
    both ceilings are the largest term."""
    times = {"hbm": t_hbm, "tensor_core": t_tc, "cuda_core": t_cc}
    jtimes = {"hbm": t_hbm, "mxu": t_tc, "vpu_select": t_cc}
    jb = max(jtimes, key=jtimes.get)
    pb = max(times, key=times.get)
    cfg = {"n": 1_000_000, "d": 128, "k": 100, "nq": nq,
           "precision": "bf16x3", "kernel": "fused"}
    ceiling = round(nq / max(times.values()), 1)
    jax_block = {"terms": {t: {"time_s": v} for t, v in jtimes.items()},
                 "bound_class": f"{jb}_bound", "select_overlapped": True,
                 "config": cfg, "selector": "pallas", "device_kind": H100,
                 "ceiling_qps_analytic": ceiling, "model_version": 7}
    port_block = {"terms": {t: {"time_s": v} for t, v in times.items()},
                  "bound_class": rl._TERM_CLASS[pb], "config": cfg,
                  "selector": "pallas", "device_kind": H100,
                  "ceiling_qps_analytic": ceiling, "model_version": 1}
    return jax_block, port_block


_JAX_TERM = {"hbm": "hbm", "tensor_core": "mxu", "cuda_core": "vpu_select"}


@pytest.mark.parametrize("seed,measured_over_bound", [
    (0, 2.0), (1, 0.8), (2, 0.3), (3, 17.0), (4, 1.0), (5, 0.05)])
def test_reconcile_equals_jax_on_matched_blocks(seed, measured_over_bound):
    """Bound-term fits (the measurement covers every hidden term) and
    uniform ones (it sits under one) alike."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.2e-3, 4e-3, size=3)
    jb, pb = _matched_blocks(*t)
    measured = {"source": "device_trace", "nq": 1024,
                "device_s": measured_over_bound * t.max() / 4}
    je = jcal.reconcile(jb, measured)
    pe = calibrate.reconcile(pb, measured)
    assert pe["method"] == je["method"]
    for term, jterm in _JAX_TERM.items():
        assert pe["factors"][term] == je["factors"][jterm]
        assert pe["term_residual_pct"][term] == \
            je["term_residual_pct"][jterm]
    for key in ("model_residual_pct", "calibrated_ceiling_qps",
                "measured_qps", "analytic_ceiling_qps", "source"):
        assert pe[key] == je[key], key
    assert pe["bound_class"] == rl._TERM_CLASS[
        {v: k for k, v in _JAX_TERM.items()}[je["bound_class"][:-6]]]
    # the calibrated time reproduces the measurement
    times = {k: v["time_s"] for k, v in pb["terms"].items()}
    assert calibrate._combined_time(
        calibrate.apply_to_times(times, pe["factors"])) == pytest.approx(
            measured["device_s"] * 4096 / 1024, rel=1e-6)


def test_reconcile_falls_back_to_uniform_under_a_hidden_term():
    m = _model()  # tensor_core bound; hbm the largest hidden term
    t = {k: v["time_s"] for k, v in m["terms"].items()}
    assert m["bound_class"] == "tensor_core_bound"
    fast = 0.5 * t["hbm"]
    e = calibrate.reconcile(m, {"source": "host_phase", "device_s": fast,
                                "nq": 4096})
    assert e["method"] == "uniform" and len(set(e["factors"].values())) == 1
    assert calibrate._combined_time(calibrate.apply_to_times(
        t, e["factors"])) == pytest.approx(fast, rel=1e-6)
    e2 = calibrate.reconcile(m, _slow_sample(m))
    assert e2["method"] == "bound_term"
    assert e2["factors"]["tensor_core"] == pytest.approx(2.0, rel=1e-6)
    assert e2["factors"]["hbm"] == 1.0 and e2["bound_class"] == \
        "tensor_core_bound"


@pytest.mark.parametrize("measured,match", [
    ({"source": "vibes", "device_s": 1, "nq": 4}, "source"),
    ({"source": "host_phase", "device_s": 0, "nq": 4}, "device_s"),
    ({"source": "host_phase", "device_s": 1.0, "nq": 0}, "nq"),
    ({"source": "host_phase", "device_s": 1e9, "nq": 4096}, "sane clamp"),
])
def test_reconcile_refuses_what_jax_refuses(measured, match):
    pm = _model()
    jm = jrl.pallas_cost_model(n=1_000_000, d=128, k=100, nq=4096,
                               device_kind="TPU v5 lite", backend="tpu")
    for mod, m in ((calibrate, pm), (jcal, jm)):
        with pytest.raises(ValueError, match=match):
            mod.reconcile(m, measured)
        with pytest.raises(ValueError, match="roofline model"):
            mod.reconcile({"nope": 1}, {"source": "host_phase",
                                        "device_s": 1, "nq": 4})


def test_wrong_by_2x_is_corrected_by_the_overlay(tmp_path):
    """A measurement twice the modeled time on the main shape: the bound
    term absorbs it, and under the store the re-rendered block's
    calibrated ceiling reproduces the measured q/s (the analytic ceiling
    stays beside it, 2x off)."""
    m = _model()
    assert m["calibration"] == {"applied": False}
    sample = _slow_sample(m)
    entry = calibrate.reconcile(m, sample, provenance={"round": 18})
    assert entry["model_residual_pct"] == pytest.approx(100.0, abs=0.1)
    store = str(tmp_path / "cal.json")
    calibrate.put(calibrate.key_for_block(m), entry, path=store)
    calibrate.configure(store)
    m2 = _model()
    cal = m2["calibration"]
    assert cal["applied"] and cal["method"] == "bound_term"
    assert cal["provenance"]["round"] == 18 and cal["age_s"] < 3600
    qps = 4096 / sample["device_s"]
    assert abs(m2["ceiling_qps"] - qps) / qps * 100 <= \
        calibrate.RESIDUAL_TOLERANCE_PCT
    assert m2["ceiling_qps_analytic"] == m["ceiling_qps_analytic"]
    assert m2["ceiling_qps_analytic"] / m2["ceiling_qps"] == \
        pytest.approx(2.0, rel=0.01)
    assert m2["term_times_calibrated_s"]["tensor_core_bound"] == \
        pytest.approx(2 * m2["term_times_s"]["tensor_core_bound"], abs=2e-6)
    att = rl.attribute(m2, qps)
    assert att["roofline_pct"] == pytest.approx(1.0, abs=0.02)
    assert rl.validate_block(att) == []
    txt = rl.render_text(att)
    assert "CALIBRATED" in txt and "analytic" in txt and "bound_term" in txt


# -- the store --------------------------------------------------------------------
@pytest.mark.parametrize("args", [
    (H100, 1_000_000, 128, 100, "pallas", "bf16x3", "tiled"),
    (H100, 1_000_000, 128, 100, "pallas", "int8", "streaming"),
    (None, 2048, 32, 5, "pallas", None, None),
    ("cpu", 10, 4, 3, "exact", "float32", None),
])
def test_key_format_is_jax_s_with_the_port_token(args):
    jkey = jcal.calibration_key(*args)
    want = jkey.replace(f"|cal{jrl.MODEL_VERSION}",
                        f"|cal{rl.MODEL_VERSION}")
    assert calibrate.calibration_key(*args) == want
    assert want.endswith(f"|cal{rl.MODEL_VERSION}")


def test_key_separates_kernel_arms(tmp_path):
    keys = {kern: calibrate.key_for_block(_model(kernel=kern))
            for kern in ("tiled", "streaming", "fused")}
    assert len(set(keys.values())) == 3
    store = str(tmp_path / "cal.json")
    m = _model(kernel="streaming")
    calibrate.put(keys["streaming"], calibrate.reconcile(
        m, _slow_sample(m)), path=store)
    calibrate.configure(store)
    assert _model(kernel="streaming")["calibration"]["applied"] is True
    assert _model(kernel="tiled")["calibration"] == {"applied": False}
    assert _model(kernel="fused")["calibration"] == {"applied": False}
    # the counted selectors key by dtype, never on a pallas entry
    assert rl.counted_cost_model(n=1_000_000, d=128, k=100, nq=4096,
                                 device_kind=H100)["calibration"] == \
        {"applied": False}


def test_store_version_token_self_invalidates(tmp_path):
    store = str(tmp_path / "cal.json")
    calibrate.configure(store)
    m = _model()
    key = calibrate.key_for_block(m)
    assert key.endswith(f"|cal{rl.MODEL_VERSION}")
    entry = calibrate.reconcile(m, _slow_sample(m))
    calibrate.put(key.replace(f"|cal{rl.MODEL_VERSION}",
                              f"|cal{rl.MODEL_VERSION + 1}"), entry)
    calibrate.put(calibrate.calibration_key(H100, 999, 128, 100, "pallas",
                                            "bf16x3", "tiled"), entry)
    m2 = _model()
    assert m2["calibration"] == {"applied": False}
    assert m2["ceiling_qps"] == m2["ceiling_qps_analytic"]
    assert calibrate.status()["entries"] == 1  # the current-token entry
    calibrate.put(key, entry)
    assert _model()["calibration"]["applied"] is True
    calibrate.put(key, entry)
    assert calibrate.get(key, store)["samples"] == 2
    assert key in calibrate.status()["keys"]


def test_corrupt_store_degrades_to_analytic(tmp_path):
    store = tmp_path / "cal.json"
    store.write_text("{ torn json")
    calibrate.configure(str(store))
    m = _model()
    assert m["calibration"] == {"applied": False}
    assert m["ceiling_qps"] == m["ceiling_qps_analytic"]
    assert calibrate.status()["entries"] == 0


def test_put_without_a_store_raises():
    for put in (calibrate.put, jcal.put):
        with pytest.raises(ValueError, match="no calibration store"):
            put("k", {"factors": {}})


def test_foreign_factors_and_broken_lookups_degrade(tmp_path, monkeypatch):
    """An entry fit against other terms (the TPU's mxu) is not applied; a
    lookup that raises leaves the analytic verdict with the error."""
    store = str(tmp_path / "cal.json")
    calibrate.configure(store)
    m = _model()
    calibrate.put(calibrate.key_for_block(m), {
        "factors": {"hbm": 1.0, "mxu": 2.0, "vpu_select": 1.0},
        "source": "host_phase", "model_residual_pct": 100.0})
    cal = _model()["calibration"]
    assert cal["applied"] is False and "terms" in cal["error"]

    def boom(block, path=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(calibrate, "lookup_for_block", boom)
    cal = _model()["calibration"]
    assert cal == {"applied": False, "error": "OSError: disk on fire"}
    assert "overlay error: OSError" in rl.render_text(_model())


def test_probed_and_join_blocks_stay_analytic(tmp_path):
    store = str(tmp_path / "cal.json")
    calibrate.configure(store)
    m = _model()
    calibrate.put(calibrate.key_for_block(m),
                  calibrate.reconcile(m, _slow_sample(m)))
    assert _model()["calibration"]["applied"] is True
    ivf = _model(nprobe=8, ncentroids=1024)
    assert ivf["calibration"]["applied"] is False
    assert "IVF" in ivf["calibration"]["note"]
    join = rl.join_cost_model(n_a=100_000, n_b=1_000_000, d=128, k=100,
                              superblock_rows=4096, device_kind=H100)
    assert join["calibration"] == {
        "applied": False, "note": "join blocks use the analytic h2d model"}
    assert "term_times_calibrated_s" not in join
    assert join["ceiling_qps"] == join["ceiling_qps_analytic"]


def test_estimated_block_under_an_applied_calibration(tmp_path):
    """``estimated`` names the peak table's provenance: a generic-peaks
    block stays estimated under an applied calibration."""
    calibrate.configure(str(tmp_path / "cal.json"))
    m = rl.pallas_cost_model(n=2048, d=32, k=5, nq=64, backend="cpu")
    assert m["estimated"] is True and m["calibration"]["applied"] is False
    calibrate.put(calibrate.key_for_block(m), calibrate.reconcile(
        m, {"source": "host_phase", "device_s": 0.05, "nq": 64}))
    m2 = rl.pallas_cost_model(n=2048, d=32, k=5, nq=64, backend="cpu")
    assert m2["calibration"]["applied"] is True and m2["estimated"] is True


def test_validate_block_rejects_malformed_calibration():
    good = rl.attribute(rl.pallas_cost_model(n=1000, d=16, k=5, nq=8), 50.0)
    assert rl.validate_block(good) == []
    ok_cal = {"applied": True, "factors": dict.fromkeys(calibrate.TERMS, 1.0),
              "source": "host_phase", "model_residual_pct": 5.0}
    assert rl.validate_block(dict(good, calibration=ok_cal)) == []
    for bad, word in (({"applied": "yes"}, "applied"),
                      ({**ok_cal, "factors": {**ok_cal["factors"],
                                              "hbm": -1}}, "factor"),
                      ({**ok_cal, "factors": "lol"}, "factors"),
                      ({**ok_cal, "source": "vibes"}, "source"),
                      ({**ok_cal, "model_residual_pct": "much"},
                       "model_residual_pct"),
                      ("nope", "not dict")):
        errs = rl.validate_block(dict(good, calibration=bad))
        assert any(word in e for e in errs), (bad, errs)
    assert calibrate.validate_campaign_block({
        "campaign_version": 1, "arm": "a", "rehearse": True,
        "stages": [{"stage": "tune", "status": "ok"}]}) == []
    for bad in ({"arm": "a"},
                {"campaign_version": 1, "arm": "a", "rehearse": True,
                 "stages": [{"stage": "tune", "status": "partied"}]},
                {"campaign_version": 1, "arm": "", "rehearse": True,
                 "stages": [{"stage": "tune", "status": "ok"}]}, []):
        assert calibrate.validate_campaign_block(bad)
        assert jcal.validate_campaign_block(bad)


# -- publishing, health, bundles ---------------------------------------------
def test_gauges_publish_with_the_roofline_and_health_names_the_entries(
        tmp_path):
    store = str(tmp_path / "cal.json")
    calibrate.configure(store)
    m = _model()
    key = calibrate.key_for_block(m)
    calibrate.put(key, calibrate.reconcile(m, _slow_sample(m)))
    rl.publish("lbl", rl.attribute(_model(), 1000.0))
    snap = obs.snapshot()
    [applied] = snap[mn.CALIBRATION_APPLIED]["series"]
    assert applied["labels"] == {"config": "lbl"} and applied["value"] == 1.0
    assert snap[mn.CALIBRATION_RESIDUAL]["series"][0]["value"] == \
        pytest.approx(100.0, abs=0.1)
    assert mn.CALIBRATION_AGE in snap
    assert not {mn.CALIBRATION_APPLIED, mn.CALIBRATION_AGE,
                mn.CALIBRATION_RESIDUAL} & mn.UNWRITTEN
    assert rl.last_reports()["lbl"]["calibration_applied"] is True
    rep = health.report()
    assert rep["calibration"]["entries"] == 1
    assert rep["calibration"]["keys"] == [key]
    assert rep["calibration"]["store"] == store
    text = health.render_text(rep)
    assert "calibration: 1 entry at" in text and "[calibrated]" in text
    # an unapplied block publishes 0
    rl.publish("other", rl.attribute(_model(n=5000), 10.0))
    vals = {s["labels"]["config"]: s["value"]
            for s in obs.snapshot()[mn.CALIBRATION_APPLIED]["series"]}
    assert vals == {"lbl": 1.0, "other": 0.0}


def test_nothing_publishes_while_obs_is_off(tmp_path):
    calibrate.configure(str(tmp_path / "cal.json"))
    obs.reset(enabled=False)
    rl.publish("lbl", rl.attribute(_model(), 10.0))
    calibrate.publish("lbl", {"applied": True, "age_s": 1.0,
                              "model_residual_pct": 3.0})
    assert "knn_tpu_calibration" not in obs.prometheus_text()
    assert obs.snapshot() == {}


def test_health_off_store_shape_equals_jax_s():
    port = calibrate.status()
    ref = jcal.status()
    assert set(port) == set(ref)
    assert port["store"] is ref["store"] is None
    assert port["model_token"] == f"cal{rl.MODEL_VERSION}"
    assert health.report()["calibration"] == port


def test_a_bundle_carries_the_live_calibration_section(tmp_path):
    store = str(tmp_path / "cal.json")
    calibrate.configure(store)
    m = _model()
    calibrate.put(calibrate.key_for_block(m),
                  calibrate.reconcile(m, _slow_sample(m)))
    obs.blackbox.configure(str(tmp_path / "pm"))
    path = obs.blackbox.on_breach("serving_request_p99", {"value": 2.0})
    bundle = obs.blackbox.read_bundle(path)
    assert bundle["calibration"]["store"] == store
    assert bundle["calibration"]["entries"] == 1
    assert bundle["calibration"] == bundle["statusz"]["calibration"]


# -- the campaign ------------------------------------------------------------
def test_campaign_rehearse_full_loop_through_the_cli(tmp_path, capsys):
    """``cli campaign --rehearse --device cpu``: all seven stages, a
    roofline block with an applied calibration whose calibrated ceiling
    reproduces the measured q/s, the artifact valid under the port's
    validators and the campaign block under the JAX package's, the stage
    and arm counters, the store under the campaign's directory."""
    from knn_tpu_torch import campaign
    from knn_tpu_torch.cli import main

    out = str(tmp_path / "camp")
    assert main(["campaign", "--rehearse", "--device", "cpu", "--out", out,
                 "--round", "6"]) == 0
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tail["ok"] is True and tail["rehearse"] is True
    [path] = glob.glob(os.path.join(out, "campaign_r06_*.jsonl"))
    line = json.loads(open(path).read())
    att, cal = line["roofline"], line["roofline"]["calibration"]
    assert cal["applied"] is True and cal["source"] == "host_phase"
    measured = line["value"]
    assert measured == pytest.approx(line["device_phase_qps"], rel=1e-4)
    assert abs(att["ceiling_qps"] - measured) / measured * 100 <= \
        calibrate.RESIDUAL_TOLERANCE_PCT
    assert att["ceiling_qps_analytic"] != att["ceiling_qps"]
    stages = line["campaign"]["stages"]
    assert [s["stage"] for s in stages] == list(campaign.STAGES)
    assert all(s["status"] == "ok" for s in stages)
    # the capture stage's status is its own: a CPU trace is read back,
    # holds no device track and gives no sample
    cap = stages[3]
    assert "fixture" not in cap and "live_capture_error" not in cap
    assert cap["live_capture"]["device_tracks_matched"] is False
    assert cap["live_capture"]["kernel_events"] > 0
    # the JAX package's two tiles and the port's default, tuned on the
    # whole batch
    tune = stages[1]
    assert tune["tiles"] == [256, 512, 16384] and tune["candidates"] == 3
    assert tune["n_queries"] == campaign.REHEARSE_SHAPE["nq"]
    bench = stages[2]
    assert bench["tile_n"] in tune["tiles"] and bench["place_s"] > 0
    assert bench["certified"] + bench["fallback_queries"] >= \
        campaign.REHEARSE_SHAPE["nq"]
    assert stages[5]["ceiling_below"] == []
    assert rl.validate_block(att) == []
    assert calibrate.validate_calibration(cal) == []
    assert calibrate.validate_campaign_block(line["campaign"]) == []
    assert jcal.validate_campaign_block(line["campaign"]) == []
    assert line["sentinel"] == campaign.SENTINEL_ABSENT
    snap = obs.snapshot()
    assert {s["labels"]["stage"] for s in snap[mn.CAMPAIGN_STAGES]["series"]} \
        == set(campaign.STAGES)
    assert {s["labels"]["status"]: s["value"]
            for s in snap[mn.CAMPAIGN_ARMS]["series"]} == {"ok": 1.0}
    assert os.path.exists(os.path.join(out, "calibration.json"))
    assert os.path.exists(os.path.join(out, "tune_cache.json"))
    # the process store is left as it was
    assert calibrate.store_path() is None


def test_campaign_arm_times_searches_on_one_placement(tmp_path,
                                                     monkeypatch):
    """The tune stage places the rows once and the arm once more: the
    bench stage's four searches and the traced one share one placement
    (the JAX arm places the rows in every timed call)."""
    from knn_tpu_torch import campaign
    from knn_tpu_torch.parallel import sharded

    made, searched = [], []

    class Counted(sharded.ShardedKNN):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def search_certified(self, *a, **kw):
            searched.append(self)
            return super().search_certified(*a, **kw)

    monkeypatch.setattr(sharded, "ShardedKNN", Counted)
    s = campaign.run_campaign(rehearse=True, out_dir=str(tmp_path),
                              device="cpu")
    assert s["ok"], s["arms"]
    assert len(made) == 2
    assert sum(x is made[1] for x in searched) == 5


@pytest.mark.parametrize("ceiling,want", [
    (100.0, []),
    (99.0, []),                                   # within the tolerance
    (97.0, ["device_trace"]),
    (30.0, ["device_trace", "host_phase"]),
    (None, ["device_trace", "host_phase"]),
])
def test_calibrated_ceiling_below_a_measured_rate_is_refused(ceiling, want):
    from knn_tpu_torch import campaign

    samples = {"device_trace": {"qps": 100.0}, "host_phase": {"qps": 40.0}}
    assert campaign.ceiling_below(ceiling, samples, 2.0) == want


def test_campaign_has_no_grid_level_or_trace_fixture():
    """The hardware arm's grid level and the checked-in trace fixture
    are not the rehearse arm's: neither is a setting."""
    import inspect

    from knn_tpu_torch import campaign
    from knn_tpu_torch.cli import build_campaign_parser

    params = inspect.signature(campaign.run_campaign).parameters
    assert "grid_level" not in params and "trace_fixture" not in params
    for flag in ("--grid", "--trace-fixture"):
        with pytest.raises(SystemExit):
            build_campaign_parser().parse_args(["--rehearse", flag, "x"])


def test_campaign_stores_two_arms_under_distinct_keys(tmp_path):
    from knn_tpu_torch import campaign

    store = str(tmp_path / "store.json")
    calibrate.configure(store)
    # the rehearse shape: a smaller one's modeled time is so short that a
    # loaded host's measurement can pass the factor clamp
    s = campaign.run_campaign(
        rehearse=True, arms=("bf16x3_tiled", "bf16x3_streaming"),
        out_dir=str(tmp_path / "camp"), device="cpu")
    assert s["ok"], s["arms"]
    keys = [a["entry_key"] for a in s["arms"]]
    assert len(set(keys)) == 2
    assert keys[0].endswith(":tiled|cal1") and keys[1].endswith(
        ":streaming|cal1")
    assert sorted(calibrate.load(store)) == sorted(keys)
    assert calibrate.status()["keys"] == sorted(keys)
    # re-rendered under the configured store, each arm's block applies
    for kern in ("tiled", "streaming"):
        b = rl.pallas_cost_model(**campaign.REHEARSE_SHAPE, backend="cpu",
                                 kernel=kern)
        assert b["calibration"]["applied"] is True


@pytest.mark.parametrize("argv,match", [
    (["campaign", "--rehearse", "--device", "cpu", "--arms", "warp_drive"],
     "unknown arm"),
    (["campaign", "--device", "cpu"], "no benchmark"),
    (["campaign", "--rehearse", "--device", "cpu", "--arms", "join_bq512"],
     "block_q"),
    (["campaign", "--rehearse", "--device", "cpu", "--cpu-devices", "8"],
     "--cpu-devices"),
])
def test_campaign_refusals_exit_2(argv, match, capsys, tmp_path):
    from knn_tpu_torch.cli import main

    assert main(argv + ["--out", str(tmp_path)]) == 2
    assert match in capsys.readouterr().err


def test_campaign_refusals_by_name():
    from knn_tpu_torch import campaign

    with pytest.raises(ValueError, match="no benchmark"):
        campaign.run_campaign(rehearse=False, device="cpu")
    with pytest.raises(ValueError, match="divergence 20"):
        campaign.run_campaign(rehearse=True, arms=["join_bq512"],
                              device="cpu")
    assert set(campaign.ARM_KNOBS) == set(
        __import__("knn_tpu.campaign", fromlist=["x"]).ARM_KNOBS)


def test_settings_are_arguments_not_environment():
    """No new module reads the environment or names a KNN_TPU_* switch;
    the store, the fleet and the campaign settings are arguments."""
    import inspect

    from knn_tpu_torch import campaign
    from knn_tpu_torch.obs import fleet

    for mod in (traceread, calibrate, fleet, campaign):
        src = inspect.getsource(mod)
        assert "os.environ" not in src and "getenv" not in src, mod
        # the docstring names the JAX package's switches it replaces
        assert "KNN_TPU_" not in src.replace(mod.__doc__, ""), mod
    assert list(inspect.signature(calibrate.configure).parameters) == \
        ["store"]
    assert list(inspect.signature(fleet.configure).parameters) == \
        ["members", "stale_s"]
    params = inspect.signature(campaign.run_campaign).parameters
    for name in ("out_dir", "arms", "round_no", "device"):
        assert name in params
