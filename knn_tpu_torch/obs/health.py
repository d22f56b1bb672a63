"""Live health introspection: the liveness / readiness probe and the
self-diagnosis report behind ``/healthz``, ``/statusz`` and ``cli doctor``
— the port of knn_tpu/obs/health.py.

Serving components register here, weakly (a collected engine drops out of
the report): ``ServingEngine`` at construction (its ``warmed_ops`` fill in
``warmup()``), ``QueryQueue`` with its worker threads, ``MutableIndex`` and
``IVFIndex``.  **Ready** means at least one registered engine has finished
``warmup()`` (no live request pays a CUDA graph capture) and every open
queue's batcher and completer threads are alive.

:func:`report` adds the device inventory (``torch.cuda``: name, count,
memory, and the power limit where ``nvidia-smi`` gives it — only when
``torch`` is already imported, so a status probe never starts a backend),
per-engine / per-queue / per-index state, the tune cache, the published
roofline attributions, one SLO evaluation (``slo``, ``active_breaches``,
the last alert events), the slowest recent requests with their waterfalls,
the flight recorder's bundles (``postmortems``) and ``quality``: the audit
sampler's state and the drift sketch of every registered IVF index.
``export.write_json_snapshot`` embeds the same report, so ``doctor
--snapshot`` renders it offline.

``calibration`` is the calibration store's state
(:func:`knn_tpu_torch.obs.calibrate.status`: the store, the keys of its
entries under the current model token, the worst per-term residual).
``multihost`` is the last cross-process merge's report
(knn_tpu_torch.parallel.multihost.last_report), None until one ran.  The
text renderer keeps the JAX package's wording, so the two
``doctor`` commands print the same lines for the same snapshot, except
where that wording names an environment switch the port does not read: an
absent calibration store and an audit sampler that is off name the
arguments that arm them (:data:`CALIBRATION_ARGUMENT`,
:data:`AUDIT_ARGUMENT`), as ``fleet`` names its own.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import weakref
from typing import List, Optional

from knn_tpu_torch.obs import ident, names, registry, roofline, slo, trace

#: alert events included in the report (newest last)
REPORT_ALERTS = 20

#: the arguments that arm the calibration overlay and the audit sampler
#: (ROADMAP divergences 43 and 39), named where the JAX package's text
#: names its environment switches
CALIBRATION_ARGUMENT = "calibrate.configure(store=...)"
AUDIT_ARGUMENT = "audit.reset_auditor(rate=...)"

_lock = threading.Lock()
_engines: List[weakref.ref] = []
_queues: List[weakref.ref] = []
_indexes: List[weakref.ref] = []


def _register(refs: List[weakref.ref], obj) -> None:
    if not registry.enabled():
        return
    with _lock:
        refs[:] = [r for r in refs if r() is not None]
        if not any(r() is obj for r in refs):
            refs.append(weakref.ref(obj))


def register_engine(engine) -> None:
    """Called by ServingEngine.__init__ (no-op when obs is off)."""
    _register(_engines, engine)


def register_queue(queue) -> None:
    """Called by QueryQueue.__init__ (no-op when obs is off)."""
    _register(_queues, queue)


def register_index(index) -> None:
    """Called by MutableIndex / IVFIndex construction (no-op when obs is
    off)."""
    _register(_indexes, index)


def reset() -> None:
    """Drop every registration (test isolation)."""
    with _lock:
        _engines.clear()
        _queues.clear()
        _indexes.clear()


def _live(refs: List[weakref.ref]) -> list:
    with _lock:
        return [o for o in (r() for r in refs) if o is not None]


def _live_components():
    return _live(_engines), _live(_queues)


def probe() -> dict:
    """The /healthz payload: ``ready`` is the 200-vs-503 verdict, the
    reasons say why not."""
    engines, queues = _live_components()
    reasons = []
    if not registry.enabled():
        reasons.append("telemetry disabled (obs.reset(enabled=False)): "
                       "health introspection is part of the obs opt-in")
    if not engines:
        reasons.append("no ServingEngine registered")
    warmed = [e for e in engines if getattr(e, "warmed_ops", ())]
    if engines and not warmed:
        reasons.append("no registered engine has completed warmup()")
    for q in queues:
        if getattr(q, "_closed", False):
            continue  # a deliberately closed queue is not a failure
        for tname in ("_batcher_t", "_completer_t"):
            t = getattr(q, tname, None)
            if t is not None and not t.is_alive():
                reasons.append(
                    f"queue worker thread {tname.strip('_')} is dead")
    ready = not reasons
    if registry.enabled():
        registry.gauge(names.HEALTH_READY).set(1.0 if ready else 0.0)
    return {"live": True, "ready": ready, "reasons": reasons}


def _power_limits() -> Optional[List[str]]:
    """``nvidia-smi``'s power limit of each card, None where it cannot
    say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def _device_inventory() -> dict:
    """The cards ``torch.cuda`` sees — only when torch is already
    imported (a status probe must never start a backend)."""
    if "torch" not in sys.modules:
        return {"available": False,
                "reason": "torch not imported in this process"}
    try:
        import torch

        if not torch.cuda.is_available():
            return {"available": False,
                    "reason": "torch.cuda.is_available() is false"}
        count = torch.cuda.device_count()
        devs = []
        for i in range(count):
            p = torch.cuda.get_device_properties(i)
            devs.append({"index": i, "name": p.name,
                         "total_memory_bytes": int(p.total_memory)})
        limits = _power_limits()
        if limits is not None and len(limits) == count:
            for d, lim in zip(devs, limits):
                d["power_limit"] = lim
        return {
            "available": True,
            "backend": "cuda",
            "count": count,
            "kinds": sorted({d["name"] for d in devs}),
            "devices": devs,
        }
    except Exception as e:  # noqa: BLE001 - introspection must not raise
        return {"available": False,
                "reason": f"{type(e).__name__}: {e}"}


def _engine_status(e) -> dict:
    try:
        try:
            st = e.stats(include_slo=False)
        except TypeError:  # an engine-like object without the keyword
            st = e.stats()
    except Exception as ex:  # noqa: BLE001
        return {"error": f"{type(ex).__name__}: {ex}"}
    tun = st.get("tuning") or {}
    rl = {fld: tun.get(fld)
          for fld in ("roofline_pct", "bound_class", "roofline_ceiling_qps")
          if tun.get(fld) is not None}
    return {
        "warmed_ops": sorted(getattr(e, "warmed_ops", ())),
        "buckets": st.get("buckets"),
        "executables": st.get("executables"),
        "compile_count": st.get("compile_count"),
        "requests_total": st.get("requests_total"),
        "queries_total": st.get("queries_total"),
        "errors_total": st.get("errors_total"),
        "latency_ms": st.get("latency_ms"),
        "roofline": rl or None,
    }


def _queue_status(q) -> dict:
    # racy-but-safe reads of the queue's backlog: a status probe must
    # never contend for the dispatch condition
    depth_req = len(getattr(q, "_pending", ()))
    depth_rows = int(getattr(q, "_pending_rows", 0))
    ctrl = getattr(q, "_ctrl", None)
    out = {
        "op": getattr(q, "op", None),
        "closed": bool(getattr(q, "_closed", False)),
        "max_wait_ms": round(getattr(q, "max_wait_s", 0.0) * 1e3, 3),
        "capacity_rows": getattr(q, "max_rows", None),
        "depth_requests": depth_req,
        "depth_rows": depth_rows,
        "rows_utilization": (round(depth_rows / q.max_rows, 4)
                             if getattr(q, "max_rows", 0) else None),
        "outstanding_requests": int(getattr(q, "_out_req", 0)),
        "batcher_alive": q._batcher_t.is_alive(),
        "completer_alive": q._completer_t.is_alive(),
    }
    if ctrl is not None:
        try:
            out["admission"] = ctrl.stats()
        except Exception as ex:  # noqa: BLE001
            out["admission"] = {"error": f"{type(ex).__name__}: {ex}"}
    return out


def _tune_cache_status() -> dict:
    try:
        import json

        from knn_tpu_torch.tuning.cache import default_cache_path

        path = default_cache_path()
        out = {"path": path, "exists": os.path.exists(path)}
        if out["exists"]:
            with open(path) as f:
                data = json.load(f)
            out["entries"] = len(data.get("entries", {}))
            out["version"] = data.get("version")
        return out
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}


def _index_status() -> list:
    out = []
    for idx in _live(_indexes):
        try:
            out.append(idx.stats())
        except Exception as e:  # noqa: BLE001 - probe must not die on it
            out.append({"error": f"{type(e).__name__}: {e}"})
    return out


def _slowest_requests() -> list:
    """The slowest-requests exemplar table with inline waterfalls — never
    fatal: a status probe must render even when the forensics layer
    cannot."""
    try:
        from knn_tpu_torch.obs import waterfall

        return waterfall.slowest_table()
    except Exception as e:  # noqa: BLE001 - introspection must not raise
        return [{"error": f"{type(e).__name__}: {e}"}]


def _postmortems() -> dict:
    try:
        from knn_tpu_torch.obs import blackbox

        return blackbox.status()
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}


def _quality_status() -> dict:
    """The audit sampler's quality section plus the drift sketch of every
    registered IVF index — never fatal, and never arms anything: a
    sampler at rate 0 reports itself off without starting a worker."""
    try:
        from knn_tpu_torch.obs import audit

        out = audit.status()
        drifts = []
        for idx in _live(_indexes):
            mon = getattr(idx, "_drift", None)
            if mon is not None:
                try:
                    drifts.append(mon.status())
                except Exception as e:  # noqa: BLE001
                    drifts.append({"error": f"{type(e).__name__}: {e}"})
        if drifts:
            out["drift"] = drifts
        return out
    except Exception as e:  # noqa: BLE001 - introspection must not raise
        return {"error": f"{type(e).__name__}: {e}"}


def _calibration_status() -> dict:
    """The calibration store's state — never fatal: a broken store must
    not take the status probe down with it."""
    try:
        from knn_tpu_torch.obs import calibrate

        return calibrate.status()
    except Exception as e:  # noqa: BLE001 - introspection must not raise
        return {"error": f"{type(e).__name__}: {e}"}


def report(slo_section: Optional[dict] = None,
           slowest: Optional[list] = None) -> dict:
    """The full /statusz payload (see the module docstring); everything
    in it serializes to JSON.

    ``slo_section`` injects an already-computed SLO report instead of
    evaluating a fresh pass — the flight recorder passes the evaluation
    that fired it, so building a bundle never observes (and re-fires on)
    a second transition mid-dump.  ``slowest`` likewise injects a prebuilt
    slowest-requests table, so the bundle path rebuilds the event ring
    once."""
    pr = probe()
    if slo_section is None:
        slo_section = slo.slo_report()
    alerts = [e for e in trace.get_event_log().recent()
              if e.get("name") == "slo.alert"][-REPORT_ALERTS:]
    engines, queues = _live_components()
    return {
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "pid": os.getpid(),
        "identity": ident.identity(),
        "obs_enabled": registry.enabled(),
        "liveness": {"live": pr["live"]},
        "readiness": {"ready": pr["ready"], "reasons": pr["reasons"]},
        "devices": _device_inventory(),
        # each engine contributes raw stats only: the one SLO evaluation
        # above stands for all of them
        "engines": [_engine_status(e) for e in engines],
        "queues": [_queue_status(q) for q in queues],
        "tune_cache": _tune_cache_status(),
        "roofline": roofline.last_reports(),
        "calibration": _calibration_status(),
        "slo": slo_section,
        "active_breaches": (slo_section.get("breached", [])
                            if slo_section else []),
        "alerts": alerts,
        "slowest_requests": (_slowest_requests() if slowest is None
                             else slowest),
        "postmortems": _postmortems(),
        # the last cross-process merge: per-process walls, the straggler
        # gap, the merge volume and strategy — None until a MultiHostKNN
        # merge ran in this process
        "multihost": _multihost_status(),
        "index": _index_status(),
        "quality": _quality_status(),
    }


def _multihost_status() -> Optional[dict]:
    """parallel.multihost's last report; None when the module was never
    imported (no merge ran), so a report never pays its torch import."""
    mod = sys.modules.get("knn_tpu_torch.parallel.multihost")
    if mod is None:
        return None
    try:
        return mod.last_report()
    except Exception:  # noqa: BLE001 - introspection must not kill /statusz
        return None


def report_from_snapshot(payload: dict) -> dict:
    """A report from an atomic JSON snapshot (``health`` is embedded;
    older snapshots degrade to what the metrics alone say)."""
    if "health" in payload:
        return payload["health"]
    metrics = payload.get("metrics", {})
    ready_series = metrics.get(names.HEALTH_READY, {}).get("series", [])
    ready = bool(ready_series and ready_series[0]["value"] == 1.0)
    return {
        "generated_at": payload.get("written_at"),
        "pid": payload.get("pid"),
        "obs_enabled": payload.get("enabled"),
        "liveness": {"live": None},
        "readiness": {
            "ready": ready if ready_series else None,
            "reasons": ["snapshot predates the health section — "
                        "readiness derived from the "
                        + names.HEALTH_READY + " gauge only"],
        },
        "devices": {"available": False,
                    "reason": "not recorded in this snapshot"},
        "engines": [], "queues": [],
        "tune_cache": {}, "roofline": {}, "calibration": {}, "slo": {},
        "multihost": None, "index": [], "quality": {},
        "active_breaches": [], "alerts": [],
        "slowest_requests": [], "postmortems": {},
    }


def render_text(rep: dict) -> str:
    """Human-readable rendering of a report (``doctor``, live or from a
    snapshot), line for line the JAX package's, in its words except where
    those name a switch: there the port names its argument."""
    lines = []
    ready = rep.get("readiness", {}).get("ready")
    verdict = {True: "READY", False: "NOT READY", None: "UNKNOWN"}[ready]
    lines.append(f"health: {verdict}   (pid {rep.get('pid')}, "
                 f"generated {rep.get('generated_at')}, "
                 f"obs_enabled={rep.get('obs_enabled')})")
    for r in rep.get("readiness", {}).get("reasons", []):
        lines.append(f"  reason: {r}")
    dev = rep.get("devices", {})
    if dev.get("available"):
        lines.append(f"devices: {dev['count']}x {','.join(dev['kinds'])} "
                     f"({dev['backend']})")
    else:
        lines.append(f"devices: unavailable ({dev.get('reason')})")
    for i, e in enumerate(rep.get("engines", [])):
        lat = e.get("latency_ms") or {}
        lines.append(
            f"engine[{i}]: warmed={e.get('warmed_ops')} "
            f"buckets={e.get('buckets')} "
            f"executables={e.get('executables')} "
            f"compiles={e.get('compile_count')} "
            f"requests={e.get('requests_total')} "
            f"errors={e.get('errors_total')} "
            f"p99_ms={lat.get('p99')} "
            f"(window {lat.get('window_samples')} samples / "
            f"{lat.get('window_span_s')}s)")
    for i, q in enumerate(rep.get("queues", [])):
        lines.append(
            f"queue[{i}]: op={q.get('op')} closed={q.get('closed')} "
            f"depth={q.get('depth_requests')}req/"
            f"{q.get('depth_rows')}rows of {q.get('capacity_rows')} "
            f"(util {q.get('rows_utilization')}) "
            f"batcher={'up' if q.get('batcher_alive') else 'DOWN'} "
            f"completer={'up' if q.get('completer_alive') else 'DOWN'}")
    tc = rep.get("tune_cache", {})
    if tc:
        lines.append(f"tune_cache: {tc.get('path')} "
                     f"exists={tc.get('exists')} "
                     f"entries={tc.get('entries')}")
    for cfg, r in (rep.get("roofline") or {}).items():
        pct = r.get("roofline_pct")
        pct_s = f"{pct * 100:.1f}% of " if pct is not None else ""
        est = " [estimated peaks]" if r.get("estimated") else ""
        cal_s = (" [calibrated]" if r.get("calibration_applied")
                 else "")
        lines.append(f"roofline {cfg}: {pct_s}"
                     f"{r.get('ceiling_qps')} q/s ceiling "
                     f"({r.get('bound_class')}){est}{cal_s}")
    cal = rep.get("calibration") or {}
    if cal.get("store"):
        worst = cal.get("worst_residual_pct")
        worst_s = (f", worst term residual {worst}% "
                   f"({cal.get('worst_residual_key')})"
                   if worst is not None else "")
        lines.append(f"calibration: {cal.get('entries')} entr"
                     f"{'y' if cal.get('entries') == 1 else 'ies'} at "
                     f"{cal['store']} [{cal.get('model_token')}]"
                     f"{worst_s}")
    elif cal.get("error"):
        # a store that cannot report is not the same as no store: the
        # operator configured one and deserves the failure
        lines.append(f"calibration: status unavailable "
                     f"({cal['error']})")
    elif cal:
        lines.append("calibration: no store configured "
                     f"({CALIBRATION_ARGUMENT}) — roofline verdicts "
                     "are analytic only")
    for i, ix in enumerate(rep.get("index") or []):
        if "error" in ix:
            lines.append(f"index[{i}]: status unavailable "
                         f"({ix['error']})")
            continue
        lc = ix.get("last_compaction") or {}
        lines.append(
            f"index[{i}]: epoch={ix.get('epoch')} "
            f"rows={ix.get('rows')} tail={ix.get('tail_rows')}"
            f"/{ix.get('tail_capacity')} "
            f"tombstones={ix.get('tombstones')}/{ix.get('budget')} "
            f"live={ix.get('live_rows')} "
            f"compactions={ix.get('compactions')}"
            + (f" (last swap {lc.get('swap_s')}s)" if lc else "")
            + (" compactor=up" if ix.get("compactor_alive") else ""))
    qual = rep.get("quality") or {}
    if qual.get("enabled"):
        dropped = qual.get("dropped") or {}
        drop_s = (f" dropped={dropped}" if dropped else "")
        lines.append(
            f"quality: audit rate={qual.get('rate')} "
            f"sampled={qual.get('sampled_requests')} "
            f"replayed={qual.get('replayed_queries')}q "
            f"deficient={qual.get('deficient_queries')} "
            f"last_recall@k={qual.get('last_recall_at_k')}{drop_s}")
    elif qual and "error" not in qual:
        lines.append(f"quality: audit sampler off ({AUDIT_ARGUMENT})")
    for i, dr in enumerate(qual.get("drift") or []):
        lines.append(
            f"drift[{i}]: queries={dr.get('queries_observed')} "
            f"norm_psi={dr.get('norm_psi')} "
            f"assign_psi={dr.get('centroid_assign_psi')}")
    mh = rep.get("multihost")
    if mh:
        walls = mh.get("host_walls_s") or []
        sh = mh.get("straggler_host")
        # the named slow host: per-host walls (not just max-min) are in
        # the report, so the argmax renders here and the fleet view can
        # attribute the gap to a member
        sh_s = f" straggler=host{sh}" if sh is not None else ""
        lines.append(
            f"multihost: {mh.get('hosts')} host(s) "
            f"[{mh.get('transport')}] dcn_merge={mh.get('dcn_merge')} "
            f"bytes={mh.get('dcn_merge_bytes')} "
            f"straggler_gap={mh.get('straggler_gap_s')}s{sh_s} "
            f"(walls {', '.join(str(w) for w in walls)})")
    breaches = rep.get("active_breaches", [])
    lines.append(f"slo breaches: {', '.join(breaches) if breaches else 'none'}")
    def _slo_line(name, o, indent="  "):
        state = "BREACHED" if o.get("breached") else "ok"
        if o.get("kind") == "quantile":
            return (f"{indent}slo {name}: {state} {o.get('quantile')}="
                    f"{o.get('value_s')}s (threshold "
                    f"{o.get('threshold_s')}s, window "
                    f"{o.get('window_samples')} samples / "
                    f"{o.get('window_span_s')}s)")
        burns = {w: d.get("burn_rate")
                 for w, d in (o.get("windows") or {}).items()}
        return (f"{indent}slo {name}: {state} burn={burns} "
                f"(target {o.get('target')})")

    for o_name, o in (rep.get("slo", {}).get("objectives", {}) or {}).items():
        if o.get("group_by") is not None:
            # grouped objective: one line per label value (the
            # per-tenant drill-down), a summary line when idle
            groups = o.get("groups") or {}
            if not groups:
                lines.append(f"  slo {o_name}: no {o.get('group_by')} "
                             f"traffic")
                continue
            breached = o.get("breached") or []
            lines.append(f"  slo {o_name} (per {o.get('group_by')}): "
                         f"{len(breached)}/{len(groups)} breached")
            for gval, gentry in sorted(groups.items()):
                lines.append(_slo_line(f"{o_name}:{gval}", gentry,
                                       indent="    "))
            continue
        lines.append(_slo_line(o_name, o))
    alerts = rep.get("alerts", [])
    if alerts:
        lines.append(f"last {len(alerts)} alert event(s):")
        for a in alerts:
            lines.append(f"  [{a.get('ts')}] {a.get('objective')} "
                         f"{a.get('state')}")
    slowest = [r for r in rep.get("slowest_requests") or []
               if "trace_id" in r]
    if slowest:
        lines.append(f"slowest recent request(s) ({len(slowest)}):")
        from knn_tpu_torch.obs import waterfall as _wf

        for r in slowest:
            tag = f"  {r.get('latency_ms')} ms  {r.get('trace_id')}"
            if r.get("tenant") is not None:
                tag += f"  tenant={r['tenant']}"
            lines.append(tag)
            if r.get("waterfall"):
                for ln in _wf.render_waterfall(r["waterfall"]).splitlines():
                    lines.append("    " + ln)
    pm = rep.get("postmortems") or {}
    if pm.get("dir"):
        lines.append(f"postmortems: {pm['dir']} "
                     f"({len(pm.get('bundles') or [])} bundle(s), "
                     f"keep {pm.get('keep')})")
        for b in pm.get("bundles") or []:
            lines.append(f"  {b.get('file')} ({b.get('bytes')} B, "
                         f"{b.get('modified_at')})")
    return "\n".join(lines) + "\n"
