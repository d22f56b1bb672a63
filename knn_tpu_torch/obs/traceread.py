"""Reading captured traces back from disk — the port of
knn_tpu/obs/traceread.py, the parsing half of the measured-ceiling loop.

:func:`knn_tpu_torch.obs.profiler.device_trace` writes a torch.profiler
Chrome trace under ``<out_dir>/<section>/trace.json``; this module reads
such an artifact (or the JAX package's ``**/*.trace.json.gz`` layout)
into the measured sample the calibration layer
(:mod:`knn_tpu_torch.obs.calibrate`) reconciles against the roofline:

- **device traces** — Chrome trace JSON (gzipped or plain) whose
  ``ph == "M"`` ``process_name`` events name each pid's track and whose
  ``ph == "X"`` complete events carry ``ts`` / ``dur`` in microseconds.
  Device busy time is the interval union of a device track's complete
  events, so two kernels overlapping on the card bill once.
- **host-side phase records** — a ``phase_breakdown`` dict whose
  ``device_s`` was timed between two synchronizations around the call
  (:func:`sample_from_phases`).

A device track is a pid whose metadata name carries a
:data:`DEVICE_TRACK_MARKERS` token (``/device:TPU:0``, ``GPU 0``) or that
holds events of a :data:`DEVICE_EVENT_CATS` category (Kineto's kernel,
memcpy, memset and device-side annotation events), so the reader does not
depend on how a torch build names its GPU track.

Where the port differs: a port trace holds the profiler's
:data:`~knn_tpu_torch.obs.profiler.WARMUP_KERNELS` warm-up kernels before
the traced block.  Device events are read only inside the
:data:`~knn_tpu_torch.obs.profiler.BODY_MARKER` range on the device
timeline, as :func:`knn_tpu_torch.obs.profiler.summarize` reads them
(events starting inside it, the range itself not counted), so a trace's
``device_busy_s`` equals that summary's ``device_busy_ms / 1e3``.  A
trace with no such range (the JAX fixture, a CPU trace) counts every
device event.  :func:`sample_from_trace` refuses a trace with no device
track: a host-only capture measured nothing on the card.

Malformed artifacts raise :class:`TraceReadError`; a silently empty trace
would calibrate the model against nothing.  Stdlib only (gzip, json,
glob); no torch import.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

from knn_tpu_torch.obs.profiler import BODY_MARKER, sanitize_section

#: trace artifact globs under a capture directory: the port's
#: ``<section>/trace.json`` and the JAX layout
#: ``plugins/profile/<run>/<host>.trace.json.gz``
TRACE_GLOBS = ("trace.json", os.path.join("**", "*.trace.json.gz"))

#: substrings that mark a metadata-named pid track as a device track
DEVICE_TRACK_MARKERS = ("/device:", "TPU", "GPU")

#: Chrome-trace categories of events the card runs (Kineto)
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset",
                     "gpu_user_annotation")

#: the two measured-time sources the reconciler accepts
SOURCES = ("device_trace", "host_phase")


class TraceReadError(ValueError):
    """A profiler artifact that cannot be parsed into a measured sample."""


def find_trace_files(root: str) -> List[str]:
    """Every trace artifact under ``root`` (sorted), or ``root`` itself
    when it names one; an empty list when the directory holds none;
    :class:`TraceReadError` when ``root`` does not exist."""
    if os.path.isfile(root):
        return [root]
    if not os.path.isdir(root):
        raise TraceReadError(f"trace location {root!r} does not exist")
    found = set()
    for pattern in TRACE_GLOBS:
        found.update(glob.glob(os.path.join(root, pattern), recursive=True))
    return sorted(found)


def read_trace_events(path: str) -> List[dict]:
    """The ``traceEvents`` list of one artifact (gzipped or plain JSON);
    everything malformed raises :class:`TraceReadError` with the reason."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            doc = json.load(f)
    except OSError as e:
        raise TraceReadError(f"{path}: unreadable: {e}") from e
    except (json.JSONDecodeError, UnicodeDecodeError, EOFError) as e:
        raise TraceReadError(f"{path}: not trace-viewer JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise TraceReadError(
            f"{path}: no traceEvents list — not a trace-viewer artifact")
    return doc["traceEvents"]


def process_names(events: List[dict]) -> Dict[int, str]:
    """pid -> track name from the ``ph == "M"`` ``process_name`` events."""
    out: Dict[int, str] = {}
    for e in events:
        if not isinstance(e, dict):
            continue
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = (e.get("args") or {}).get("name")
            pid = e.get("pid")
            if isinstance(pid, int) and isinstance(name, str):
                out[pid] = name
    return out


def device_pids(events: List[dict]) -> Dict[int, str]:
    """The device tracks: pids named like one (:data:`DEVICE_TRACK_MARKERS`)
    or holding device-category events (:data:`DEVICE_EVENT_CATS`), with
    their names.  Empty on a host-only trace."""
    named = process_names(events)
    out = {pid: name for pid, name in named.items()
           if any(m in name for m in DEVICE_TRACK_MARKERS)}
    for e in events:
        if (isinstance(e, dict) and e.get("cat") in DEVICE_EVENT_CATS
                and isinstance(e.get("pid"), int)):
            out.setdefault(e["pid"], named.get(e["pid"], f"pid {e['pid']}"))
    return out


def complete_events(events: List[dict],
                    pids: Optional[set] = None) -> List[dict]:
    """The ``ph == "X"`` complete events with numeric ``ts`` / ``dur``,
    optionally restricted to ``pids``."""
    out = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        if not isinstance(e.get("ts"), (int, float)) or \
                not isinstance(e.get("dur"), (int, float)):
            continue
        if pids is not None and e.get("pid") not in pids:
            continue
        out.append(e)
    return out


def _interval_union_s(evts: List[dict]) -> float:
    """Seconds covered by the union of the events' [ts, ts + dur)
    microsecond intervals."""
    iv: List[Tuple[float, float]] = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in evts)
    total = 0.0
    cur_a = cur_b = None
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total / 1e6


def _body_filter(evts: List[dict]) -> Tuple[List[dict], Optional[int]]:
    """A device track's events inside its :data:`BODY_MARKER` range (the
    range itself left out) and the count of those before it; all of them
    and None when the track has no such range."""
    marks = [e for e in evts if e.get("name") == BODY_MARKER]
    rest = [e for e in evts if e.get("name") != BODY_MARKER]
    if not marks:
        return rest, None
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    return ([e for e in rest if lo <= float(e["ts"]) <= hi],
            sum(1 for e in rest if float(e["ts"]) < lo))


def summarize_events(events: List[dict]) -> dict:
    """One artifact's measured-time summary: the busiest device track's
    busy seconds (its interval union, inside the body marker's range where
    the track has one), its event count, and whether real device tracks
    were matched (a host-only trace falls back to every track, flagged
    ``device_tracks_matched: false``).  Where the busiest track has a body
    range, ``events_before_body`` counts its events before it (a port
    trace's warm-up kernels)."""
    dev = device_pids(events)
    matched = bool(dev)
    tracks = dev or process_names(events)
    per_track = {}
    for pid in tracks or {e.get("pid") for e in events
                          if isinstance(e, dict)}:
        evts = complete_events(events, pids={pid})
        before = None
        if matched:
            evts, before = _body_filter(evts)
        if evts:
            per_track[pid] = {
                "name": tracks.get(pid, str(pid)),
                "events": len(evts),
                "busy_s": round(_interval_union_s(evts), 6),
            }
            if before is not None:
                per_track[pid]["events_before_body"] = before
    if not per_track:
        raise TraceReadError(
            "trace holds no complete (ph=X) events on any track — "
            "nothing measured to reconcile against")
    busiest = max(per_track.values(), key=lambda t: t["busy_s"])
    out = {
        "device_tracks_matched": matched,
        "tracks": per_track,
        "kernel_events": sum(t["events"] for t in per_track.values()),
        "device_busy_s": busiest["busy_s"],
        "busiest_track": busiest["name"],
    }
    if "events_before_body" in busiest:
        out["events_before_body"] = busiest["events_before_body"]
    return out


def body_event_names(events: List[dict]) -> List[str]:
    """The sorted distinct names of the device events
    :func:`summarize_events` counts (inside each device track's body range
    where it has one); empty on a host-only trace."""
    out = set()
    for pid in device_pids(events):
        evts, _ = _body_filter(complete_events(events, pids={pid}))
        out.update(str(e.get("name")) for e in evts)
    return sorted(out)


def read_section(base_dir: str, section: str) -> dict:
    """Parse the capture the profiler wrote for ``section`` under
    ``base_dir`` (``<base_dir>/<sanitized section>``): a section that
    never captured raises instead of matching another configuration's
    kernels.  Where the directory holds several runs (the JAX layout's
    timestamped run directories), only the newest run's files enter.
    Returns the :func:`summarize_events` summary plus the artifact
    paths."""
    sect = sanitize_section(section)
    root = os.path.join(base_dir, sect)
    files = find_trace_files(root)
    if not files:
        raise TraceReadError(
            f"capture dir {root!r} holds no trace artifact (trace.json "
            f"or *.trace.json.gz)")
    by_run: Dict[str, List[str]] = {}
    for p in files:
        by_run.setdefault(os.path.dirname(p), []).append(p)
    runs_found = len(by_run)
    if runs_found > 1:
        newest = max(by_run, key=lambda r: (os.path.getmtime(r), r))
        files = sorted(by_run[newest])
    merged: List[dict] = []
    for path in files:
        merged.extend(read_trace_events(path))
    summary = summarize_events(merged)
    summary["section"] = sect
    summary["trace_files"] = files
    summary["runs_found"] = runs_found
    return summary


def sample_from_trace(base_dir: str, section: str, *, nq: int) -> dict:
    """A measured sample (the reconciler's input) from a captured device
    trace: ``device_s`` is the busiest device track's busy time over the
    traced block of ``nq`` queries.  A trace without a device track, or
    with no busy time, raises."""
    summary = read_section(base_dir, section)
    if not summary["device_tracks_matched"]:
        raise TraceReadError(
            f"section {section!r}: the trace holds no device track — a "
            f"host-only capture measured nothing on the card")
    dev_s = summary["device_busy_s"]
    if dev_s <= 0:
        raise TraceReadError(
            f"section {section!r}: zero device busy time in the trace")
    return {
        "source": "device_trace",
        "device_s": dev_s,
        "nq": int(nq),
        "qps": round(nq / dev_s, 2),
        "section": summary["section"],
        "trace_files": summary["trace_files"],
        "kernel_events": summary["kernel_events"],
        "device_tracks_matched": summary["device_tracks_matched"],
        "events_before_body": summary.get("events_before_body"),
    }


def sample_from_phases(phase_breakdown: dict, *, nq: int) -> dict:
    """A measured sample from a host-side ``phase_breakdown``: only its
    ``device_s`` enters; with a ``transport`` of kind ``dev_relay`` (not
    latency-corrected) the line's transfer phases are recorded as excluded,
    never added to the device sample."""
    if not isinstance(phase_breakdown, dict):
        raise TraceReadError(
            f"phase_breakdown is {type(phase_breakdown).__name__}, not dict")
    dev_s = phase_breakdown.get("device_s")
    if not isinstance(dev_s, (int, float)) or dev_s <= 0:
        raise TraceReadError(
            f"phase_breakdown carries no positive device_s ({dev_s!r}) — "
            f"nothing measured to reconcile against")
    transport = phase_breakdown.get("transport")
    excluded = None
    if isinstance(transport, dict) and \
            transport.get("kind") == "dev_relay" and \
            not transport.get("latency_corrected"):
        excluded = {
            k: phase_breakdown.get(k)
            for k in ("h2d_queries_s", "d2h_transfer_s")
            if isinstance(phase_breakdown.get(k), (int, float))
        } or None
    return {
        "source": "host_phase",
        "device_s": float(dev_s),
        "nq": int(nq),
        "qps": round(nq / float(dev_s), 2),
        "transport": transport,
        "relay_phases_excluded_s": excluded,
    }
