"""The fleet plane: N processes' telemetry merged into one report — the
port of knn_tpu/obs/fleet.py.

Every other obs surface is per process.  "What is the fleet's p99" is not
answerable from N per-process p99s (percentiles do not average); this
module is the sound merge:

- **counters sum**, the members in sorted key order, so the same member
  set always gives the bitwise-identical total;
- **gauges keep their host**: every gauge per member, with min / max /
  argmax, never averaged;
- **quantiles come from buckets**: every histogram exports cumulative
  counts over the one ``registry.BUCKET_BOUNDS`` grid, so the vectors add
  element-wise and the fleet quantile is taken from the sum
  (``registry.quantile_from_buckets``); the per-host window quantiles ride
  along, never combined.

Collection reads live ``/metrics.json`` and ``/statusz`` (and, best
effort, ``/waterfallz`` for stitched cross-host waterfalls) from member
endpoints, or offline snapshot files written by
``export.write_json_snapshot`` (``cli fleet --snapshot-dir``).  Every
payload is keyed by its identity stamp (:mod:`knn_tpu_torch.obs.ident`).

Degraded modes are loud: an unreachable endpoint or an unreadable or torn
snapshot is listed under ``unreachable`` with its reason; a snapshot older
than the newest by more than ``stale_s`` seconds is refused as stale
(summed in, it would understate every counter); a member of another
``catalog_version`` is refused under ``skewed``.  Any of these makes the
report ``partial``, and ``cli fleet`` exits 2.

The fleet SLO: the merged counters and buckets go through
``slo.evaluate_fleet`` (the objectives of ``obs.reset_slo_engine``) and an
edge-triggered ``slo.FleetSLOEngine``; each firing transition emits one
``fleet.alert`` event and writes one fleet postmortem bundle, beside the
per-process bundles of :mod:`knn_tpu_torch.obs.blackbox`, embedding every
member's snapshot and the stitched waterfalls.  The engine hands its
transitions over after releasing its lock, so writing a bundle never runs
under it.  Served by ``/fleetz`` and ``python -m knn_tpu_torch.cli fleet``.

Where the port differs (ROADMAP queue C): the members and the staleness
threshold are arguments — :func:`configure` sets the process's, where the
JAX package reads ``KNN_TPU_FLEET_MEMBERS`` and ``KNN_TPU_FLEET_STALE_S``;
with no member configured, ``/fleetz`` says so, naming the argument.  No
torch import.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from knn_tpu_torch.obs import names, registry, trace

DEFAULT_STALE_S = 120.0

#: per-member HTTP timeout for live collection
DEFAULT_TIMEOUT_S = 3.0

#: fleet report schema version
FLEET_VERSION = 1

_QS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

#: the process's fleet settings (configure())
_config: dict = {"members": (), "stale_s": DEFAULT_STALE_S}
_config_lock = threading.Lock()


def parse_members(spec: str) -> List[str]:
    """A comma- or space-separated ``host:port`` list."""
    return [m for m in re.split(r"[,\s]+", spec or "") if m]


def configure(members: Sequence[str] = (),
              stale_s: float = DEFAULT_STALE_S) -> None:
    """Set the process's member endpoints (``host:port`` each; a string is
    split on commas and spaces) and staleness threshold in seconds."""
    if isinstance(members, str):
        members = parse_members(members)
    stale = float(stale_s)
    if not stale >= 0:
        raise ValueError(f"stale_s must be >= 0, got {stale_s}")
    with _config_lock:
        _config["members"] = tuple(members)
        _config["stale_s"] = stale


def fleet_members() -> List[str]:
    """The configured member endpoints."""
    return list(_config["members"])


def stale_threshold_s() -> float:
    return _config["stale_s"]


# -- collection ---------------------------------------------------------------
def _http_json(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read().decode())


def _member_record(member: str, *, identity=None, metrics=None,
                   health=None, written_at_unix=None, stitched=None,
                   error: Optional[str] = None) -> dict:
    return {"member": member, "identity": identity or {},
            "metrics": metrics or {}, "health": health,
            "written_at_unix": written_at_unix, "stitched": stitched,
            "error": error}


def collect_live(members: Sequence[str],
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> List[dict]:
    """One record per endpoint: ``/metrics.json`` (identity and metrics),
    ``/statusz`` (health) and, best effort, ``/waterfallz``.  A failing
    member degrades to an ``error`` record; collection never raises."""
    out = []
    for m in members:
        base = m if "://" in m else f"http://{m}"
        try:
            snap = _http_json(base + "/metrics.json", timeout_s)
            if not isinstance(snap, dict) or "metrics" not in snap:
                raise ValueError("no metrics section in /metrics.json")
        except Exception as e:  # noqa: BLE001 — degrade, never raise
            out.append(_member_record(m, error=f"{type(e).__name__}: {e}"))
            continue
        health = stitched = None
        try:
            health = _http_json(base + "/statusz", timeout_s)
        except Exception:  # noqa: BLE001 — statusz is best effort
            pass
        try:
            wf = _http_json(base + "/waterfallz", timeout_s)
            stitched = (wf.get("multihost") or {}).get("waterfalls")
        except Exception:  # noqa: BLE001 — waterfalls are best effort
            pass
        out.append(_member_record(
            m, identity=snap.get("identity"), metrics=snap["metrics"],
            health=health, written_at_unix=snap.get("written_at_unix"),
            stitched=stitched))
    return out


def collect_snapshot_files(paths: Sequence[str]) -> List[dict]:
    """One record per snapshot file; unreadable, torn or shapeless files
    degrade to ``error`` records."""
    out = []
    for p in paths:
        try:
            with open(p) as f:
                payload = json.load(f)
            if not isinstance(payload, dict) or "metrics" not in payload:
                raise ValueError("not a metrics snapshot (no metrics)")
        except Exception as e:  # noqa: BLE001 — degrade, never raise
            out.append(_member_record(
                os.path.basename(p), error=f"{type(e).__name__}: {e}"))
            continue
        out.append(_member_record(
            os.path.basename(p), identity=payload.get("identity"),
            metrics=payload["metrics"], health=payload.get("health"),
            written_at_unix=payload.get("written_at_unix")))
    return out


def collect_snapshot_dir(d: str) -> Tuple[List[dict], Dict[str, dict]]:
    """Offline collection from a directory: every ``*.json`` is a member
    snapshot; every ``*.jsonl`` event log's ``multihost.merge`` spans are
    stitched into cross-host waterfalls (waterfall.stitch_multihost)."""
    from knn_tpu_torch.obs import waterfall

    snaps = sorted(f for f in os.listdir(d) if f.endswith(".json"))
    members = collect_snapshot_files([os.path.join(d, f) for f in snaps])
    events: List[dict] = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".jsonl"):
            try:
                events.extend(waterfall.read_jsonl_events(
                    os.path.join(d, f)))
            except Exception:  # noqa: BLE001 — logs are best effort
                pass
    return members, waterfall.stitch_multihost(events)


# -- the merge ----------------------------------------------------------------
def _member_key(rec: dict) -> str:
    ident = rec.get("identity") or {}
    host = ident.get("host")
    if host is not None:
        return f"{host}/{ident.get('process_index', 0)}"
    return str(rec["member"])


def merge(collected: Sequence[dict], *, stale_s: Optional[float] = None,
          stitched: Optional[Dict[str, dict]] = None) -> dict:
    """The fleet report over collected member records (module docstring).
    Publishes the ``FLEET_*`` gauges while obs is on."""
    stale_s = stale_threshold_s() if stale_s is None else float(stale_s)
    ours = names.catalog_version()
    unreachable: List[dict] = []
    skewed: List[dict] = []
    ok: List[Tuple[str, dict]] = []
    for rec in collected:
        if rec.get("error"):
            unreachable.append({"member": rec["member"],
                                "reason": rec["error"]})
            continue
        cv = (rec.get("identity") or {}).get("catalog_version")
        if cv is not None and cv != ours:
            skewed.append({"member": rec["member"], "catalog_version": cv,
                           "expected": ours})
            continue
        ok.append((_member_key(rec), rec))
    # two snapshots of one process: the newest stays
    by_key: Dict[str, dict] = {}
    for key, rec in ok:
        prev = by_key.get(key)
        if prev is None or ((rec.get("written_at_unix") or 0)
                            >= (prev.get("written_at_unix") or 0)):
            by_key[key] = rec
    stamps = {k: r["written_at_unix"] for k, r in by_key.items()
              if r.get("written_at_unix") is not None}
    if stamps:
        newest = max(stamps.values())
        for k in sorted(by_key):
            ts = stamps.get(k)
            if ts is not None and newest - ts > stale_s:
                unreachable.append({
                    "member": by_key[k]["member"],
                    "reason": (f"stale snapshot: {round(newest - ts, 3)}s "
                               f"older than the newest member "
                               f"(threshold {stale_s}s)")})
                del by_key[k]
        stamps = {k: v for k, v in stamps.items() if k in by_key}
    staleness = (round(max(stamps.values()) - min(stamps.values()), 3)
                 if stamps else 0.0)
    keys = sorted(by_key)
    counters, gauges, hists = _merge_metrics(keys, by_key)
    wfs = dict(stitched or {})
    for k in keys:
        for tid, w in (by_key[k].get("stitched") or {}).items():
            prev = wfs.get(tid)
            if prev is None or ((w.get("total_s") or 0)
                                > (prev.get("total_s") or 0)):
                wfs[tid] = w
    report = {
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "enabled": True,
        "catalog_version": ours,
        "partial": bool(unreachable or skewed),
        "member_count": len(keys),
        "expected": len(collected),
        "members": [{
            "key": k,
            "member": by_key[k]["member"],
            "identity": by_key[k].get("identity") or {},
            "written_at_unix": by_key[k].get("written_at_unix"),
        } for k in keys],
        "unreachable": unreachable,
        "skewed": skewed,
        "staleness_s": staleness,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "multihost": _merge_multihost(keys, by_key),
        "waterfalls": wfs or None,
    }
    report["fleet_version"] = FLEET_VERSION
    from knn_tpu_torch.obs import slo

    report["slo"] = slo.evaluate_fleet(counters, hists,
                                       slo.objectives_in_force())
    _publish_gauges(report)
    return report


def _merge_metrics(keys, by_key):
    """Counters sum, gauges stay per host, histograms merge their
    buckets."""
    counters: Dict[str, list] = {}
    gauges: Dict[str, list] = {}
    hists: Dict[str, list] = {}
    series: Dict[Tuple[str, tuple], Dict[str, dict]] = {}
    kinds: Dict[str, str] = {}
    for k in keys:
        for name, m in (by_key[k].get("metrics") or {}).items():
            kinds[name] = m.get("type", "gauge")
            for s in m.get("series", ()):
                lk = (name, tuple(sorted(s["labels"].items())))
                series.setdefault(lk, {})[k] = s
    for (name, litems) in sorted(series):
        labels = dict(litems)
        per = series[(name, litems)]
        kind = kinds[name]
        if kind == "counter":
            per_host = {k: float(per[k]["value"]) for k in sorted(per)}
            counters.setdefault(name, []).append({
                "labels": labels,
                # sorted-key order: the same member set always sums to
                # the bitwise-identical total
                "value": sum(per_host[k] for k in sorted(per_host)),
                "per_host": per_host,
            })
        elif kind == "gauge":
            per_host = {k: float(per[k]["value"]) for k in sorted(per)}
            argmax = max(sorted(per_host), key=lambda k: per_host[k])
            gauges.setdefault(name, []).append({
                "labels": labels,
                "per_host": per_host,
                "min": min(per_host.values()),
                "max": per_host[argmax],
                "argmax": argmax,
            })
        else:
            hists.setdefault(name, []).append(
                _merge_hist_series(labels, per))
    return counters, gauges, hists


def _merge_hist_series(labels: dict, per: Dict[str, dict]) -> dict:
    """One histogram label series across members: lifetime count and sum
    add, the cumulative bucket vectors add element-wise, the fleet
    quantiles come from the sum only; the per-host window quantiles ride
    along, labeled by host."""
    merged_cum: Optional[List[float]] = None
    window: Dict[str, dict] = {}
    count = 0.0
    total = 0.0
    for k in sorted(per):
        v = per[k]["value"]
        count += float(v.get("count", 0))
        total += float(v.get("sum", 0.0))
        cum = v.get("buckets")
        if cum:
            merged_cum = (list(cum) if merged_cum is None
                          else [a + b for a, b in zip(merged_cum, cum)])
        window[k] = {q: v[q] for q, _ in _QS if q in v}
        if "count" in v:
            window[k]["count"] = v["count"]
    fleet_q = None
    if merged_cum is not None:
        fleet_q = {q: registry.quantile_from_buckets(merged_cum, frac)
                   for q, frac in _QS}
        fleet_q["source"] = "merged_buckets"
    return {"labels": labels, "count": count, "sum": round(total, 9),
            "buckets": merged_cum, "fleet_quantiles": fleet_q,
            "window_quantiles_per_host": window}


def _merge_multihost(keys, by_key) -> Optional[dict]:
    """The straggler verdict from the members' /statusz ``multihost``
    sections: the argmax host by its last merge wall, named by member key
    where one of the merged members is that process."""
    sections = {}
    for k in keys:
        mh = (by_key[k].get("health") or {}).get("multihost")
        if mh:
            sections[k] = mh
    if not sections:
        return None
    auth_key = max(sorted(sections),
                   key=lambda k: by_key[k].get("written_at_unix") or 0)
    auth = dict(sections[auth_key])
    walls = auth.get("host_walls_s") or []
    straggler = auth.get("straggler_host")
    if straggler is None and walls:
        straggler = max(range(len(walls)), key=lambda i: walls[i])
    straggler_key = None
    for k in keys:
        if (by_key[k].get("identity") or {}).get("process_index") \
                == straggler:
            straggler_key = k
            break
    return {
        "reported_by": auth_key,
        "host_walls_s": walls,
        "straggler_host": straggler,
        "straggler_member": straggler_key,
        "straggler_gap_s": auth.get("straggler_gap_s"),
        "per_member": sections,
    }


def _publish_gauges(report: dict) -> None:
    if not registry.enabled():
        return
    registry.gauge(names.FLEET_MEMBERS).set(float(report["member_count"]))
    registry.gauge(names.FLEET_UNREACHABLE).set(
        float(len(report["unreachable"]) + len(report["skewed"])))
    registry.gauge(names.FLEET_MERGE_STALENESS).set(
        float(report["staleness_s"]))
    straggler_key = (report.get("multihost") or {}).get("straggler_member")
    if straggler_key is not None:
        for m in report["members"]:
            registry.gauge(names.FLEET_STRAGGLER_HOST, host=m["key"]).set(
                1.0 if m["key"] == straggler_key else 0.0)


# -- the fleet SLO edge and its bundles ---------------------------------------
_engine_lock = threading.Lock()
_engine = None


def _get_fleet_engine():
    global _engine
    with _engine_lock:
        if _engine is None:
            from knn_tpu_torch.obs import slo

            _engine = slo.FleetSLOEngine()
        return _engine


def reset_fleet_engine() -> None:
    """Drop the edge state."""
    global _engine
    with _engine_lock:
        _engine = None


def observe(report: dict, collected: Sequence[dict]) -> List[str]:
    """Feed one merged report through the edge-triggered fleet SLO engine;
    each healthy -> breached transition emits one ``fleet.alert`` event and
    writes one fleet bundle.  Returns the bundle paths written."""
    fired = _get_fleet_engine().observe(report.get("slo") or {})
    paths = []
    for key, detail in fired:
        trace.emit_event("fleet.alert", objective=key, state="firing",
                         **{k: v for k, v in detail.items()
                            if k != "state"
                            and isinstance(v, (int, float, str, bool))})
        path = _write_fleet_bundle(key, detail, report, collected)
        if path is not None:
            paths.append(path)
    return paths


def _write_fleet_bundle(objective: str, detail: dict, report: dict,
                        collected: Sequence[dict]) -> Optional[str]:
    """One fleet postmortem bundle per firing transition, in the flight
    recorder's directory under its retention (``fleet_`` before the
    objective in the name) — atomic, failure-proof."""
    from knn_tpu_torch.obs import blackbox

    d = blackbox.postmortem_dir()
    if d is None or not registry.enabled():
        return None
    try:
        payload = {
            "version": blackbox.BUNDLE_VERSION,
            "kind": "fleet",
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime()),
            "pid": os.getpid(),
            "objective": objective,
            "state": "firing",
            "breach_detail": detail,
            "fleet": report,
            # every member's raw record: the per-host truth behind the
            # merged numbers
            "members": {str(rec["member"]): {
                "identity": rec.get("identity"),
                "metrics": rec.get("metrics"),
                "health": rec.get("health"),
                "written_at_unix": rec.get("written_at_unix"),
                "error": rec.get("error"),
            } for rec in collected},
            "waterfalls": report.get("waterfalls"),
        }
        os.makedirs(d, exist_ok=True)
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", objective)[:56]
        fname = (f"postmortem-"
                 f"{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
                 f"-0000-fleet_{safe}.json")
        path = os.path.join(d, fname)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, sort_keys=True, default=str)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        blackbox._prune(d)
        return path
    except Exception as e:  # noqa: BLE001 — the recorder must never raise
        try:
            trace.emit_event("postmortem.error", objective=objective,
                             error=f"{type(e).__name__}: {e}")
        except Exception:  # pragma: no cover - double fault
            pass
        return None


# -- entry points -------------------------------------------------------------
def fleet_report(members: Optional[Sequence[str]] = None, *,
                 snapshot_dir: Optional[str] = None,
                 snapshot_files: Optional[Sequence[str]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 stale_s: Optional[float] = None) -> dict:
    """Collect, merge and edge-evaluate in one call: live endpoints
    (``members``, default the configured ones) or offline snapshots
    (``snapshot_dir`` / ``snapshot_files``)."""
    stitched: Dict[str, dict] = {}
    if snapshot_dir is not None:
        collected, stitched = collect_snapshot_dir(snapshot_dir)
    elif snapshot_files is not None:
        collected = collect_snapshot_files(snapshot_files)
    else:
        members = fleet_members() if members is None else list(members)
        if not members:
            return {"enabled": False, "fleet_version": FLEET_VERSION,
                    "reason": "no fleet members configured "
                              "(fleet.configure(members=...)) and no "
                              "snapshot source given"}
        collected = collect_live(members, timeout_s)
    report = merge(collected, stale_s=stale_s, stitched=stitched)
    observe(report, collected)
    return report


def live_fleet_report() -> dict:
    """What ``/fleetz`` serves: the merged report over the configured
    members, or a loud disabled / unconfigured stub.  With obs off the
    plane is off: no collection, no merge, no gauges."""
    if not registry.enabled():
        return {"enabled": False, "fleet_version": FLEET_VERSION,
                "reason": "telemetry disabled (obs.reset(enabled=False))"}
    if not fleet_members():
        return {"enabled": False, "fleet_version": FLEET_VERSION,
                "reason": "no fleet members configured "
                          "(fleet.configure(members=...))"}
    return fleet_report()


def artifact_block(report: dict) -> dict:
    """The merged report's flat, bounded headline (the JAX package's
    ``fleet`` artifact block): what ``cli fleet --json`` consumers and
    artifacts carry instead of the full report."""
    if not report.get("enabled", True):
        return {"fleet_version": FLEET_VERSION, "member_count": 0,
                "error": report.get("reason")}
    mh = report.get("multihost") or {}
    return {
        "fleet_version": FLEET_VERSION,
        "catalog_version": report["catalog_version"],
        "member_count": report["member_count"],
        "expected_members": report["expected"],
        "unreachable_count": len(report["unreachable"]),
        "skewed_count": len(report["skewed"]),
        "partial": report["partial"],
        "staleness_s": report["staleness_s"],
        "straggler_host": mh.get("straggler_host"),
        "straggler_gap_s": mh.get("straggler_gap_s"),
        "stitched_requests": len(report.get("waterfalls") or {}),
        "slo_breached": len((report.get("slo") or {}).get("breached")
                            or ()),
    }


def render_text(report: dict) -> str:
    """The ``cli fleet`` text rendering (the JAX package's wording)."""
    if not report.get("enabled", True):
        return f"fleet: disabled ({report.get('reason')})"
    lines = [
        f"fleet report v{report['fleet_version']} "
        f"@ {report['generated_at']}  catalog {report['catalog_version']}",
        f"  members merged: {report['member_count']}/{report['expected']}"
        + ("  PARTIAL" if report["partial"] else "")
        + f"  staleness {report['staleness_s']}s",
    ]
    for m in report["members"]:
        ident = m["identity"]
        lines.append(
            f"    {m['key']}  ({m['member']}, "
            f"process {ident.get('process_index')}/"
            f"{ident.get('process_count')}, "
            f"device {ident.get('device_kind')})")
    for u in report["unreachable"]:
        lines.append(f"  UNREACHABLE {u['member']}: {u['reason']}")
    for s in report["skewed"]:
        lines.append(
            f"  SKEWED {s['member']}: catalog {s['catalog_version']} "
            f"!= expected {s['expected']}")
    mh = report.get("multihost")
    if mh:
        lines.append(
            f"  multihost: straggler host{mh.get('straggler_host')}"
            f" ({mh.get('straggler_member')})"
            f" gap {mh.get('straggler_gap_s')}s"
            f" walls {mh.get('host_walls_s')}")
    slo_rep = report.get("slo") or {}
    for key in sorted(slo_rep.get("objectives", {})):
        o = slo_rep["objectives"][key]
        lines.append(
            f"  slo {key}: {o.get('state', '?')}"
            f"  value={o.get('value')}"
            + (f"  fleet_{o.get('quantile')}={o.get('value')}"
               f" (merged buckets)" if o.get("kind") == "quantile"
               else ""))
    counters = report.get("counters", {})
    for name in sorted(counters):
        for s in counters[name]:
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted(s["labels"].items()))
            lines.append(
                f"  {name}{{{lbl}}} = {s['value']}  "
                f"(sum of {len(s['per_host'])} member(s))")
    hists = report.get("histograms", {})
    for name in sorted(hists):
        for s in hists[name]:
            fq = s.get("fleet_quantiles")
            if not fq:
                continue
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted(s["labels"].items()))
            lines.append(
                f"  {name}{{{lbl}}} fleet p50/p95/p99 = "
                f"{fq['p50']}/{fq['p95']}/{fq['p99']} "
                f"(merged buckets, n={int(s['count'])})")
    wfs = report.get("waterfalls")
    if wfs:
        from knn_tpu_torch.obs import waterfall

        lines.append(f"  stitched cross-host waterfalls: {len(wfs)}")
        worst = max(wfs.values(), key=lambda w: w.get("total_s") or 0.0)
        lines.extend("  " + ln for ln in
                     waterfall.render_waterfall(worst).splitlines())
    return "\n".join(lines)
