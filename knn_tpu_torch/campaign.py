"""The measured-ceiling campaign — the port of knn_tpu/campaign.py
(``python -m knn_tpu_torch.cli campaign --rehearse``).

One campaign arm is one kernel configuration (precision x db-streaming
strategy, :data:`ARM_KNOBS`).  Per arm the harness runs seven stages in
order, each recorded in the arm's artifact:

1. **gates** — records the arm's settings: the device, the calibration
   store, the trace directory;
2. **tune** — autotunes the arm's pinned knobs over three tiles (the JAX
   package's ``n // 8`` and twice that, and the port's default
   ``TILE_N``) on the arm's whole query batch, so each candidate's time
   holds the repair of the queries its tile leaves uncertified
   (``tuning.autotune``: the bitwise gate, fenced timing, roofline pruning
   and, on the card, the Hopper resource gate) into
   ``<out_dir>/tune_cache.json``, re-tuning each arm (the cache key holds
   the shape, not the kernel);
3. **bench** — places the database once (``ShardedKNN``, off the clock:
   ``place_s``), then ``search_certified(selector="pallas")`` at the
   winner's knobs, once to warm, then the best of three host-timed calls:
   the host-phase ``device_s`` sample, with the batch's fallback count;
4. **capture** — one more search under ``obs.profiler.device_trace``, read
   back from disk by ``obs.traceread`` (on the card: the arm's kernel must
   be in the trace's body, and the trace's busy time is held beside
   ``profiler.summarize``'s);
5. **reconcile** — ``obs.calibrate.reconcile`` of each sample against the
   arm's roofline block, built for the device the arm ran on (the H100's
   row on the card); the device-trace fit is the one stored where the
   trace holds device tracks, else the host-phase fit;
6. **calibrate** — stores the fit, re-renders the block under the store and
   requires ``calibration.applied`` with the calibrated ceiling within
   ``RESIDUAL_TOLERANCE_PCT`` of the measured q/s, and at least every
   sample's q/s less that tolerance (a ceiling the arm's own search beats
   is refused);
7. **curate** — validates the roofline block, its calibration and the
   campaign block, and writes one JSONL artifact per arm (atomically).

Where the port differs (ROADMAP queue C): the JAX package's
``KNN_TPU_CAMPAIGN_DIR`` / ``_ARMS`` / ``_ROUND`` are :func:`run_campaign`'s
``out_dir``, ``arms`` and ``round_no``; the arm runs on ``device``
(``"cuda"`` unless asked otherwise); it times a search on a placement
made once, where the JAX arm's ``knn_search_pallas`` places the database
in every timed call (a store key names no placement, so a fit that held
one would lower the ceiling of every resident search of the shape); the
hardware arm (``rehearse=False``, which shells out to a benchmark) is
refused until the port has its benchmark, and with it its grid level;
the ``join_bq512`` arm is refused (the port has no ``block_q``); the
capture stage parses no checked-in fixture; and a line's ``sentinel`` is
:data:`SENTINEL_ABSENT` (the sentinel is not ported).  ``torch`` is
imported inside the arm only.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from knn_tpu_torch.obs import calibrate, ident, names, profiler, registry
from knn_tpu_torch.obs import roofline as _rl
from knn_tpu_torch.obs import traceread

#: campaign artifact schema version (calibrate.validate_campaign_block)
CAMPAIGN_VERSION = 1

#: stage names, in execution order (the stage counter's label values)
STAGES = ("gates", "tune", "bench", "capture", "reconcile", "calibrate",
          "curate")

#: named arms: the knob pins a campaign sweeps (the JAX package's table)
ARM_KNOBS: Dict[str, Dict[str, object]] = {
    "bf16x3_tiled": {"precision": "bf16x3", "kernel": "tiled"},
    "bf16x3_streaming": {"precision": "bf16x3", "kernel": "streaming"},
    "int8_streaming": {"precision": "int8", "kernel": "streaming"},
    "int8_fused": {"precision": "int8", "kernel": "fused"},
    "join_bq512": {"precision": "bf16x3", "kernel": "tiled",
                   "block_q": 512},
}
DEFAULT_ARMS = ("bf16x3_tiled", "bf16x3_streaming", "int8_streaming",
                "int8_fused", "join_bq512")
DEFAULT_REHEARSE_ARMS = ("bf16x3_tiled",)

#: arms the port refuses, with the reason
REFUSED_ARMS = {
    "join_bq512": "the port has no block_q: every CUDA kernel takes "
                  "32-row query blocks (ROADMAP divergence 20)",
}

#: the rehearse problem shape (the JAX package's)
REHEARSE_SHAPE = dict(n=2048, d=32, k=5, nq=64)

#: the coarse kernel's name in a trace, by the arm's kernel knob
KERNEL_TRACE_NAMES = {"tiled": "binned_select_", "streaming": "stream_select_",
                      "fused": "fused_select_"}

#: a line's ``sentinel`` field while the sentinel is not ported
SENTINEL_ABSENT = {
    "verdict": "absent",
    "note": "obs.sentinel is not ported: it judges a bench history, and "
            "the port's waits for its benchmark",
}

def _stage(log: List[dict], name: str, status: str, **detail) -> dict:
    """Record one stage outcome (and count it)."""
    rec = {"stage": name, "status": status, **detail}
    log.append(rec)
    if registry.enabled():
        registry.counter(names.CAMPAIGN_STAGES, stage=name).inc()
    return rec


def _knobs_for_model(knobs: Dict[str, object]) -> Dict[str, object]:
    """The cost-model-relevant subset of a resolved knob dict (the port's
    model takes no ``block_q``)."""
    return {k: knobs.get(k) for k in ("precision", "kernel", "grid_order",
                                      "binning", "tile_n", "survivors")}


def _write_artifact(out_dir: str, fname: str, line: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def ceiling_below(ceiling: Optional[float], samples: Dict[str, dict],
                  tol_pct: float) -> List[str]:
    """The samples whose measured q/s beats ``ceiling`` by more than
    ``tol_pct`` (sorted by source; every one of them when there is no
    ceiling): a calibrated ceiling is never below a rate the arm's own
    search reached."""
    return sorted(src for src, smp in samples.items()
                  if not ceiling or ceiling < smp["qps"] * (1 - tol_pct / 100))


def _rehearse_arm(arm: str, *, out_dir: str, shape: Dict[str, int],
                  seed: int, round_no: Optional[int], verbose: bool,
                  device="cuda") -> dict:
    """One arm: the seven stages on ``device`` (module docstring)."""
    import numpy as np
    import torch

    from knn_tpu_torch import tuning
    from knn_tpu_torch.device import resolve_device
    from knn_tpu_torch.ops.coarse_knn import TILE_N
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    kind = tuning.device_kind_of(dev) if on_card else None
    backend = dev.type
    n, d, k, nq = (int(shape[f]) for f in ("n", "d", "k", "nq"))
    stages: List[dict] = []
    log = (lambda msg: print(f"[{arm}] {msg}", file=sys.stderr)) \
        if verbose else (lambda msg: None)

    def fence():
        if on_card:
            torch.cuda.synchronize(dev)

    store = calibrate.store_path() or os.path.join(out_dir,
                                                   "calibration.json")
    traces = os.path.join(out_dir, "traces")
    _stage(stages, "gates", "ok", device=str(dev), device_kind=kind,
           calibration_store=store, trace_dir=traces,
           rehearse_note="the arm runs search_certified on a placement on "
                         "the device; tune pruning, trace capture and the "
                         "calibration store are live (the port has no "
                         "benchmark gates)")

    # 2. tune, on the whole batch: a tile's time holds its fallbacks' repair
    log("tune ...")
    rng = np.random.default_rng(seed)
    db = (rng.random((n, d)) * 128.0).astype(np.float32)
    q = (rng.random((nq, d)) * 128.0).astype(np.float32)
    arm_knobs = dict(ARM_KNOBS[arm])
    tile = max(128, (n // 8) // 128 * 128)
    tiles = [tile, tile * 2] + ([TILE_N] if TILE_N not in (tile, tile * 2)
                                else [])
    grid = [dict(arm_knobs, tile_n=t) for t in tiles]
    tune_cache = os.path.join(out_dir, "tune_cache.json")
    try:
        # force: the cache key holds the shape, not the kernel, so another
        # arm's cached winner would stand in for this arm's grid; the
        # arm's pins win over the winner's knobs
        entry = tuning.autotune(db, q, k, grid=grid, runs=1,
                                cache_path=tune_cache, prune=0.25,
                                device=dev, force=True)
        knobs = {**tuning.DEFAULT_KNOBS,
                 **{kk: v for kk, v in entry["knobs"].items()
                    if kk in tuning.DEFAULT_KNOBS}, **arm_knobs}
        errors = entry.get("errors") or {}
        _stage(stages, "tune", "ok", winner=entry.get("winner"),
               winner_ms=entry.get("winner_ms"),
               candidates=len(entry.get("timings_ms") or {}),
               pruned=len((entry.get("pruning") or {}).get("pruned") or {}),
               resource_gate=(entry.get("smem") or {}).get(
                   "candidates_refused"),
               refused=sorted(lbl for lbl, e in errors.items()
                              if str(e).startswith("smem-refused")),
               tiles=tiles, n_queries=nq, cache_path=tune_cache)
    except Exception as e:  # noqa: BLE001 — recorded, the arm runs its pins
        knobs = {**tuning.DEFAULT_KNOBS, **arm_knobs, "tile_n": tile}
        _stage(stages, "tune", "error", error=f"{type(e).__name__}: {e}")

    # 3. bench: the host-phase sample of a search on a placement made once
    log("bench ...")
    kw = {kk: knobs[kk] for kk in ("precision", "kernel", "bin_w",
                                   "survivors", "final_select", "binning",
                                   "final_recall_target", "grid_order")}
    kw["tile_n"] = knobs["tile_n"] or tile
    fence()
    t0 = time.perf_counter()
    placed = ShardedKNN(db, k=k, device=dev)
    fence()
    place_s = time.perf_counter() - t0

    def call():
        return placed.search_certified(q, margin=28, selector="pallas", **kw)

    _, _, st = call()  # warm: builds and allocations off the clock
    best = None
    for _ in range(3):
        fence()
        t0 = time.perf_counter()
        call()
        fence()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    phase = {"device_s": round(best, 6), "device_qps": round(nq / best, 2)}
    _stage(stages, "bench", "ok", **phase, place_s=round(place_s, 6),
           tile_n=kw["tile_n"], certified=st["certified"],
           fallback_queries=st["fallback_queries"])

    # 4. capture: one traced search read back from disk
    log("capture ...")
    section = f"campaign_{arm}"
    capture: Dict[str, object] = {}
    trace_sample = None
    cap_status = "ok"
    want = KERNEL_TRACE_NAMES[knobs["kernel"]]
    try:
        fence()
        with profiler.device_trace(section, out_dir=traces) as cap:
            call()
            fence()
        parsed = traceread.read_section(traces, section)
        summ = cap.summary()
        held = any(want in nm for nm in traceread.body_event_names(
            traceread.read_trace_events(parsed["trace_files"][0])))
        capture["live_capture"] = {
            "kernel_events": parsed["kernel_events"],
            "device_busy_s": parsed["device_busy_s"],
            "device_tracks_matched": parsed["device_tracks_matched"],
            "events_before_body": parsed.get("events_before_body"),
            "summarize_busy_s": summ["device_busy_ms"] / 1e3,
            "summarize_kernel_events": summ["kernel_events"],
            "kernel": want, "kernel_held": held,
        }
        if parsed["device_tracks_matched"]:
            if not held:
                raise traceread.TraceReadError(
                    f"the {section} trace does not hold {want!r}")
            if on_card and not parsed.get("events_before_body"):
                # every warm-up kernel lost: the loss may have reached
                # the block's first kernels
                raise traceread.TraceReadError(
                    f"the {section} trace kept none of its "
                    f"{profiler.WARMUP_KERNELS} warm-up kernels")
            trace_sample = traceread.sample_from_trace(traces, section,
                                                       nq=nq)
        elif on_card:
            raise traceread.TraceReadError(
                f"the {section} trace holds no device track")
    except Exception as e:  # noqa: BLE001 — recorded, host phases stand
        capture["live_capture_error"] = f"{type(e).__name__}: {e}"
        cap_status = "error"
    _stage(stages, "capture", cap_status, **capture)

    # 5. reconcile each sample against the arm's block
    log("reconcile ...")
    model_kw = _knobs_for_model(knobs)
    model_kw["tile_n"] = model_kw["tile_n"] or tile

    def model():
        return _rl.pallas_cost_model(n=n, d=d, k=k, nq=nq, device_kind=kind,
                                     backend=backend, **model_kw)

    block = model()
    prov = {"config_label": _rl.config_label(n, d, k, device_kind=kind),
            "commit": ident.identity()["commit"], "round": round_no,
            "arm": arm, "rehearse": True, "device": str(dev)}
    samples = {"host_phase": traceread.sample_from_phases(phase, nq=nq)}
    if trace_sample is not None:
        samples["device_trace"] = trace_sample
    used = "device_trace" if "device_trace" in samples else "host_phase"
    # the stored fit must succeed (a refusal fails the arm); the other is
    # recorded, with its refusal where the clamp refuses it
    entry = calibrate.reconcile(block, samples[used], provenance=prov)
    fits = {}
    for src, s in samples.items():
        rec = {"qps": s["qps"], "device_s": s["device_s"]}
        try:
            f = entry if src == used else calibrate.reconcile(
                block, s, provenance=prov)
            rec.update(factors=f["factors"], method=f["method"],
                       model_residual_pct=f["model_residual_pct"])
        except ValueError as e:
            rec["error"] = str(e)
        fits[src] = rec
    _stage(stages, "reconcile", "ok", factors=entry["factors"],
           method=entry["method"],
           model_residual_pct=entry["model_residual_pct"],
           source=entry["source"], fits=fits)

    # 6. calibrate: store, re-render under the store, hold the reproduction
    log("calibrate ...")
    key = calibrate.key_for_block(block)
    calibrate.put(key, entry, path=store)
    prev = calibrate.store_path()
    calibrate.configure(store)
    try:
        att = _rl.attribute(model(), samples[used]["qps"])
    finally:
        calibrate.configure(prev)
    measured_qps = samples[used]["qps"]
    applied = bool(att.get("calibration", {}).get("applied"))
    tol = calibrate.RESIDUAL_TOLERANCE_PCT
    ceiling = att.get("ceiling_qps")
    resid = (abs(ceiling - measured_qps) / measured_qps * 100.0
             if ceiling else None)
    beaten = ceiling_below(ceiling, samples, tol)
    within = (applied and resid is not None and resid <= tol
              and not beaten)
    _stage(stages, "calibrate", "ok" if within else "error",
           store=store, key=key, applied=applied,
           ceiling_qps=ceiling, measured_qps=measured_qps,
           reconstruction_residual_pct=(round(resid, 3)
                                        if resid is not None else None),
           ceiling_below=beaten, tolerance_pct=tol)

    # 7. curate
    log("curate ...")
    campaign_block = {"campaign_version": CAMPAIGN_VERSION, "arm": arm,
                      "round": round_no, "rehearse": True,
                      "stages": stages}
    line = {
        "metric": f"knn_qps_rehearse_n{n}_d{d}_k{k}",
        "value": measured_qps,
        "unit": "queries/s",
        "mode": "campaign_rehearse",
        "backend": backend,
        "device_kind": kind,
        "device_phase_qps": phase["device_qps"],
        "device_trace_qps": (trace_sample or {}).get("qps"),
        "pallas_knobs": knobs,
        "roofline": att,
        "roofline_pct": att.get("roofline_pct"),
        "bound_class": att.get("bound_class"),
        "model_residual_pct": entry["model_residual_pct"],
        "campaign": campaign_block,
        "measured_round": round_no if round_no is not None else 0,
        "measured_at_commit": prov["commit"],
        "sentinel": dict(SENTINEL_ABSENT),
    }
    errors = (_rl.validate_block(att)
              + calibrate.validate_calibration(att.get("calibration"))
              + calibrate.validate_campaign_block(campaign_block))
    fname = (f"campaign_r{round_no:02d}_{arm}.jsonl"
             if round_no is not None else f"campaign_{arm}.jsonl")
    path = os.path.join(out_dir, fname)
    ok = not errors and within and all(
        s["status"] == "ok" for s in stages
        if s["stage"] in ("tune", "capture"))
    # the curate record rides inside the artifact: it lands before the write
    _stage(stages, "curate", "ok" if ok else "error", artifact=path,
           validation_errors=errors)
    _write_artifact(out_dir, fname, line)
    if registry.enabled():
        registry.counter(names.CAMPAIGN_ARMS,
                         status="ok" if ok else "error").inc()
    return {"arm": arm, "ok": ok, "artifact": path, "line": line,
            "errors": errors, "entry_key": key}


def run_campaign(
    *, rehearse: bool = False, arms: Optional[Sequence[str]] = None,
    out_dir: Optional[str] = None, round_no: Optional[int] = None,
    seed: int = 0, shape: Optional[Dict[str, int]] = None,
    verbose: bool = False, device="cuda",
) -> dict:
    """Run the campaign over ``arms`` (default: :data:`DEFAULT_REHEARSE_ARMS`)
    at ``shape`` (default :data:`REHEARSE_SHAPE`) on ``device`` and return
    the summary (per-arm outcomes and artifacts); artifacts, traces, the
    tune cache and (unless ``calibrate.configure`` set one) the calibration
    store go under ``out_dir`` (default ``artifacts/campaign``).  Refuses
    an unknown arm, a refused arm (:data:`REFUSED_ARMS`) and the hardware
    arm (``rehearse=False``) with ValueError."""
    if not rehearse:
        raise ValueError(
            "the hardware campaign arm runs the benchmark with its gates "
            "armed, and the port has no benchmark yet: run the campaign "
            "with rehearse=True (cli campaign --rehearse)")
    arms = list(arms or DEFAULT_REHEARSE_ARMS)
    for a in arms:
        if a not in ARM_KNOBS:
            raise ValueError(f"unknown arm {a!r}; expected one of "
                             f"{sorted(ARM_KNOBS)}")
        if a in REFUSED_ARMS:
            raise ValueError(f"arm {a!r} is refused: {REFUSED_ARMS[a]}")
    out_dir = out_dir or os.path.join("artifacts", "campaign")
    os.makedirs(out_dir, exist_ok=True)
    results = [_rehearse_arm(
        arm, out_dir=out_dir, shape=dict(REHEARSE_SHAPE, **(shape or {})),
        seed=seed, round_no=round_no, verbose=verbose, device=device)
        for arm in arms]
    return {
        "campaign_version": CAMPAIGN_VERSION,
        "rehearse": True,
        "round": round_no,
        "out_dir": out_dir,
        "device": str(device),
        "arms": [{"arm": r["arm"], "ok": r["ok"], "errors": r.get("errors"),
                  "artifact": r.get("artifact"),
                  "entry_key": r.get("entry_key")} for r in results],
        "ok": all(r["ok"] for r in results),
        "results": results,
    }
