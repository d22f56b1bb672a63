"""Flight recorder — the port of knn_tpu/obs/blackbox.py: on every
edge-triggered SLO breach, one postmortem bundle holding the state an
operator would have wanted logged, written at the moment the breach fires.

The SLO engine (knn_tpu_torch.obs.slo) is edge-triggered: each healthy ->
breached transition emits exactly one firing alert.  :func:`on_breach`
rides that edge — it is called once per firing transition, after the
engine's evaluation lock is released — and writes one bundle to the
postmortem directory:

- the structured event ring (every span and event still held in memory,
  the raw material of the waterfalls),
- the full metrics snapshot and the /statusz report (built from the same
  evaluation pass that fired: no re-evaluation, no second transition),
- the slowest-requests table with inline waterfalls, the critical-path
  attribution and the device-vs-roofline verdict,
- the SLO report and the breach detail that fired,
- ``env``: the obs arguments in force (audit rate and budget, postmortem
  directory and keep, SLO windows), the pid, and a schema version,
- ``audit``: the shadow audit sampler's summary and failing records.

Disciplines: at most one bundle per breach transition; atomic (temporary
file and ``os.replace``), so a reader never sees a torn bundle;
retention-capped (the newest ``keep`` bundles survive, older ones are
pruned after each write); failure-proof (a full disk or an unwritable
directory becomes a ``postmortem.error`` event, never an exception into
the stats() / scrape path that ran the evaluation); off by default (no
directory, or telemetry off, means no work).

Bundles are plain JSON, read offline by ``python -m knn_tpu_torch.cli
waterfall --bundle <path>`` and ``cli audit --bundle <path>``, and listed
in ``/statusz`` (``postmortems``).

Where the port differs (ROADMAP queue C): the directory and ``keep`` are
arguments of :func:`configure` where the JAX package reads environment
variables, and a bundle's ``env`` holds those arguments (and the audit
rate, budget and SLO windows) in place of the environment.  A bundle's
``calibration`` is the live store section of its ``statusz`` report.  The
fleet plane (knn_tpu_torch.obs.fleet) writes its own bundles into the same
directory under the same retention.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from typing import List, Optional

from knn_tpu_torch.obs import names, registry, trace

#: how many bundles survive pruning (newest kept)
DEFAULT_KEEP = 8

#: bundle schema version (bump on shape changes so offline readers can
#: tell a malformed bundle from an old one)
BUNDLE_VERSION = 1

_FNAME_RE = re.compile(r"^postmortem-\d{8}T\d{6}-\d{4}-.*\.json$")

_seq_lock = threading.Lock()
_seq = 0
#: reentrancy guard: building a bundle reads health/waterfall state
#: that may itself evaluate metrics — a nested transition during the
#: dump must not recurse into a second dump on the same thread
_busy = threading.local()


#: the recorder's arguments (configure()): where bundles land (None = off)
#: and how many survive pruning
_config: dict = {"dir": None, "keep": DEFAULT_KEEP}
_config_lock = threading.Lock()


def configure(postmortem_dir: Optional[str] = None,
              keep: int = DEFAULT_KEEP) -> None:
    """Arm the recorder at ``postmortem_dir`` (None disarms it), keeping
    the newest ``keep`` (>= 1) bundles."""
    keep_n = int(keep)
    if keep_n < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    with _config_lock:
        _config["dir"] = (os.fspath(postmortem_dir)
                          if postmortem_dir else None)
        _config["keep"] = keep_n


def postmortem_dir() -> Optional[str]:
    return _config["dir"]


def keep_count() -> int:
    return _config["keep"]


def enabled() -> bool:
    """Recorder armed: a directory is configured and telemetry is on (the
    bundle is nothing but telemetry; obs off disarms it like every other
    obs surface)."""
    return postmortem_dir() is not None and registry.enabled()


def on_breach(objective: str, detail: dict,
              slo_report: Optional[dict] = None) -> Optional[str]:
    """The SLO engine's edge hook: write one bundle for this firing
    transition.  Returns the bundle path (None when disabled, busy, or
    the write failed — failures degrade to a ``postmortem.error``
    event, never an exception into the evaluating caller)."""
    if not enabled():
        return None
    if getattr(_busy, "v", False):
        return None
    _busy.v = True
    try:
        path = _write_bundle(objective, detail, slo_report)
        registry.counter(names.POSTMORTEMS_WRITTEN,
                         objective=objective).inc()
        trace.emit_event("postmortem.write", objective=objective,
                         path=path)
        return path
    except Exception as e:  # noqa: BLE001 — recorder must never raise
        try:
            trace.emit_event("postmortem.error", objective=objective,
                             error=f"{type(e).__name__}: {e}")
        except Exception:  # pragma: no cover - double fault
            pass
        return None
    finally:
        _busy.v = False


def _audit_evidence() -> Optional[dict]:
    """The audit sampler's evidence section, failure-proof: a broken
    audit layer must not take the flight recorder down with it."""
    try:
        from knn_tpu_torch.obs import audit

        return audit.get_auditor().evidence()
    except Exception as e:  # noqa: BLE001 — recorder must never raise
        return {"error": f"{type(e).__name__}: {e}"}


def _obs_arguments() -> dict:
    """The obs arguments in force: what a bundle's ``env`` records in
    place of the JAX package's environment knobs."""
    from knn_tpu_torch.obs import audit, slo

    a = audit.get_auditor()
    return {"audit_rate": a.rate,
            "audit_budget_rows_s": a.summary()["budget_rows_s"],
            "postmortem_dir": postmortem_dir(),
            "postmortem_keep": keep_count(),
            "slo_windows": [[label, span]
                            for label, span in slo.windows_in_force()]}


def _write_bundle(objective: str, detail: dict,
                  slo_report: Optional[dict]) -> str:
    global _seq
    from knn_tpu_torch.obs import health, waterfall

    d = postmortem_dir()
    os.makedirs(d, exist_ok=True)
    events = trace.get_event_log().recent()
    wfs = waterfall.reconstruct(events)
    slowest = waterfall.slowest_table(events=events, waterfalls=wfs)
    payload = {
        "version": BUNDLE_VERSION,
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "pid": os.getpid(),
        "objective": objective,
        "state": "firing",
        "breach_detail": detail,
        "slo": slo_report,
        # the statusz report REUSES the evaluation pass that fired
        # (slo_section=...) — a re-evaluation here could observe and
        # fire a second transition mid-dump — and the slowest table
        # built above, so the ring is reconstructed once, not twice
        "statusz": health.report(slo_section=slo_report,
                                 slowest=slowest),
        "metrics": registry.snapshot(),
        "events": events,
        "slowest": slowest,
        "attribution": waterfall.attribute(wfs),
        "device_vs_roofline": waterfall.device_vs_roofline(wfs),
        "env": _obs_arguments(),
        # the shadow audit sampler's evidence: summary + the bounded
        # ring of failing audit records — for a quality-SLO breach
        # this IS the postmortem (which requests served wrong answers,
        # vs what the oracle says)
        "audit": _audit_evidence(),
    }
    # measured-term calibration state: the statusz report already
    # carries the section (health's failure-proof probe) — hoist it
    # top-level so postmortem readers judging "device bound vs model
    # wrong" find it beside device_vs_roofline, without a second
    # store read
    payload["calibration"] = (payload["statusz"] or {}).get(
        "calibration")
    with _seq_lock:
        _seq += 1
        seq = _seq
    safe_obj = re.sub(r"[^A-Za-z0-9_.-]", "_", objective)[:64]
    fname = (f"postmortem-{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
             f"-{seq:04d}-{safe_obj}.json")
    path = os.path.join(d, fname)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, sort_keys=True, default=str)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _prune(d)
    return path


def _bundles_in(d: str) -> List[str]:
    try:
        entries = os.listdir(d)
    except OSError:
        return []
    # timestamp-then-sequence filenames sort chronologically
    return sorted(f for f in entries if _FNAME_RE.match(f))


def _prune(d: str) -> None:
    keep = keep_count()
    bundles = _bundles_in(d)
    for f in bundles[:-keep] if len(bundles) > keep else []:
        try:
            os.unlink(os.path.join(d, f))
        except OSError:  # pragma: no cover - racing reader/cleaner
            pass


def status() -> dict:
    """The ``/statusz`` ``postmortems`` section: where bundles go, how
    many survive pruning, and what is on disk right now."""
    d = postmortem_dir()
    out: dict = {"dir": d, "keep": keep_count(), "bundles": []}
    if d is None:
        return out
    for f in _bundles_in(d):
        p = os.path.join(d, f)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out["bundles"].append({
            "file": f,
            "bytes": int(st.st_size),
            "modified_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(st.st_mtime)),
        })
    return out


def read_bundle(path: str) -> dict:
    """Load + structurally sanity-check a bundle (offline readers)."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "version" not in payload:
        raise ValueError(f"{path}: not a postmortem bundle (no version)")
    return payload
