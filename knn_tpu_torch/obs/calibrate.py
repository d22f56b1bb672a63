"""Measured-term calibration: reconcile a measured device time against the
roofline's terms and keep per-term scale factors the model consults — the
port of knn_tpu/obs/calibrate.py.

The analytic model (:mod:`knn_tpu_torch.obs.roofline`) predicts each
configuration's term times from the H100's data-sheet peaks.  This module
holds those terms against measurement:

- :func:`reconcile` takes one modeled block and one measured sample
  (:mod:`knn_tpu_torch.obs.traceread`: a device trace's busy time or a
  host-phase ``device_s``) and solves for per-term factors.  The binding
  term absorbs the residual: the other terms are hidden under it in the
  ceiling's formula, so the measurement says nothing about them.  Where no
  bound-term factor can reproduce the measurement (it sits under a hidden
  term), every term scales by one factor and the entry says so
  (``method: "uniform"``).  Either way the calibrated time reproduces the
  measured one, so the calibrated ceiling equals the measured q/s up to
  rounding; ``model_residual_pct`` records how far the analytic model was
  off.
- Factors persist in a calibration store (JSON, written to a temporary
  file and renamed into place, reads memoised on the file's mtime and
  size), keyed ``device_kind|n|d|k|selector:precision[:kernel]|cal<MODEL_
  VERSION>``: an entry fit under another model version misses on lookup.
- :mod:`knn_tpu_torch.obs.roofline` consults the store on every block
  (:func:`lookup_for_block`): blocks carry ``calibration: {applied,
  factors, source, age_s, ...}`` and a calibrated ``ceiling_qps`` beside
  ``ceiling_qps_analytic``.

Where the port differs (ROADMAP queue C): the store is a process setting,
:func:`configure` (``store=None``: no overlay), where the JAX package reads
``KNN_TPU_CALIBRATION``; :data:`TERMS` are the H100 roofline's five terms,
and the formula solved against is the port's ceiling, the largest term
(:func:`knn_tpu_torch.obs.roofline._combined`), where the JAX package's
three TPU terms add the select to the stream.  Under the largest term the
bound term's factor is ``measured / t_bound``; it is taken when the result
covers every hidden term, else the fit is uniform.  The validators are
this module's own (the JAX package's artifact catalog is not ported).
No torch import.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from knn_tpu_torch.obs import names, registry, trace
from knn_tpu_torch.obs import roofline as _rl

#: store file schema version
STORE_VERSION = 1

#: the model terms a factor can scale, in roofline term order
TERMS = ("hbm", "tensor_core", "cuda_core", "smem", "h2d")

#: sane clamp on a single term's factor: outside it the measurement says
#: something no per-term rate error explains (wrong shape key, torn trace)
FACTOR_MIN, FACTOR_MAX = 1e-3, 1e4

#: stated tolerance (percent) between a calibrated ceiling and the measured
#: q/s it was fit from — the campaign's acceptance gate
RESIDUAL_TOLERANCE_PCT = 2.0

#: measured-sample sources (traceread vocabulary)
SOURCES = ("device_trace", "host_phase")

_lock = threading.Lock()
#: path -> ((mtime_ns, size), entries) read memo
_read_memo: dict = {}
#: the process's store (configure())
_config: dict = {"store": None}


def configure(store: Optional[str] = None) -> None:
    """Set the process's calibration store file (None: no overlay, every
    roofline block renders ``calibration: {applied: false}``)."""
    with _lock:
        _config["store"] = os.fspath(store) if store else None


def store_path() -> Optional[str]:
    """The configured calibration store, or None."""
    return _config["store"]


def model_token() -> str:
    """``cal<MODEL_VERSION>``, the version token in every store key."""
    return f"cal{_rl.MODEL_VERSION}"


def calibration_key(device_kind: Optional[str], n: int, d: int, k: int,
                    selector: str, precision: Optional[str],
                    kernel: Optional[str] = None) -> str:
    """The shape key one calibration is valid for; any field mismatch
    misses (a campaign's tiled and streaming arms at one shape measure
    different kernels and never share an entry)."""
    kind = device_kind or "generic-cpu"
    kern = f":{kernel}" if kernel else ""
    return (f"{kind}|n{int(n)}|d{int(d)}|k{int(k)}|"
            f"{selector}:{precision or 'default'}{kern}|{model_token()}")


def key_for_block(block: dict) -> Optional[str]:
    """The store key of a roofline block (from its ``config`` and
    ``selector``), or None when it carries too little shape to key on."""
    cfg = block.get("config")
    sel = block.get("selector")
    if not isinstance(cfg, dict) or not sel:
        return None
    try:
        precision = (cfg.get("precision") if sel == "pallas"
                     else cfg.get("dtype"))
        return calibration_key(block.get("device_kind"), cfg["n"], cfg["d"],
                               cfg["k"], sel, precision,
                               kernel=(cfg.get("kernel")
                                       if sel == "pallas" else None))
    except (KeyError, TypeError, ValueError):
        return None


def load(path: Optional[str] = None) -> dict:
    """Every store entry; empty when the file is absent or corrupt (a
    broken overlay degrades to the analytic model, never to an error)."""
    path = path or store_path()
    if not path:
        return {}
    try:
        st = os.stat(path)
    except OSError:
        return {}
    sig = (st.st_mtime_ns, st.st_size)
    with _lock:
        memo = _read_memo.get(path)
        if memo and memo[0] == sig:
            return memo[1]
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or \
                data.get("version") != STORE_VERSION:
            return {}
        entries = data.get("entries", {})
        if not isinstance(entries, dict):
            return {}
    except (OSError, json.JSONDecodeError):
        return {}
    with _lock:
        _read_memo[path] = (sig, entries)
    return entries


def get(key: str, path: Optional[str] = None) -> Optional[dict]:
    entry = load(path).get(key)
    return entry if isinstance(entry, dict) else None


def put(key: str, entry: dict, path: Optional[str] = None) -> str:
    """Insert or replace one entry (a repeat counts ``samples``), written
    atomically; returns the path.  Raises ValueError when no store is
    configured or given."""
    path = path or store_path()
    if not path:
        raise ValueError(
            "no calibration store configured (calibrate.configure("
            "store=...) or pass an explicit path)")
    with _lock:
        entries = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if (isinstance(data, dict)
                    and data.get("version") == STORE_VERSION
                    and isinstance(data.get("entries"), dict)):
                entries = data["entries"]
        except (OSError, json.JSONDecodeError):
            pass
        prev = entries.get(key)
        if isinstance(prev, dict):
            entry = dict(entry, samples=int(prev.get("samples", 1)) + 1)
        entries[key] = entry
        payload = {"version": STORE_VERSION, "entries": entries}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _read_memo.pop(path, None)
    return path


def _combined_time(times: Dict[str, float]) -> float:
    """The roofline's ceiling formula over per-term times (term-name
    keys), through the one formula the ceiling uses."""
    return _rl._combined({_rl._TERM_CLASS[t]: v for t, v in times.items()})


def reconcile(block: dict, measured: dict, *,
              provenance: Optional[dict] = None) -> dict:
    """Decompose one measured device time against one modeled block's
    terms (module docstring).  Returns the store entry: per-term
    ``factors`` and ``term_residual_pct``, the signed
    ``model_residual_pct`` of the analytic model, the sample's provenance
    and the fit ``method``."""
    src = measured.get("source")
    if src not in SOURCES:
        raise ValueError(f"measured source {src!r} not in {SOURCES}")
    dev_s = measured.get("device_s")
    m_nq = measured.get("nq")
    if not isinstance(dev_s, (int, float)) or dev_s <= 0:
        raise ValueError(f"measured device_s {dev_s!r} must be > 0")
    if not isinstance(m_nq, int) or m_nq <= 0:
        raise ValueError(f"measured nq {m_nq!r} must be a positive int")
    terms = block.get("terms")
    cfg = block.get("config") or {}
    if not isinstance(terms, dict) or \
            block.get("bound_class") not in _rl.BOUND_CLASSES:
        raise ValueError("block is not a roofline model "
                         "(missing terms/bound_class)")
    try:
        times = {t: float(terms[t]["time_s"]) for t in TERMS if t in terms}
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"block term without a time: {e}") from e
    if any(v < 0 for v in times.values()) or not times \
            or max(times.values()) <= 0:
        raise ValueError(f"modeled term times {times} hold no positive "
                         f"bound")
    # the ANALYTIC binding term, re-derived from the raw term times (a
    # block that consulted an earlier overlay carries the calibrated
    # bound_class; fitting against it would compound factors)
    tc = _rl._TERM_CLASS
    bterm = max(times, key=lambda t: (times[t],
                                      -_rl.BOUND_CLASSES.index(tc[t])))
    nq_model = int(cfg.get("nq") or m_nq)
    measured_t = float(dev_s) * (nq_model / m_nq)
    modeled_t = _combined_time(times)
    scale = measured_t / modeled_t
    if not (FACTOR_MIN <= scale <= FACTOR_MAX):
        raise ValueError(
            f"measured/modeled ratio {scale:.4g} outside the sane clamp "
            f"[{FACTOR_MIN}, {FACTOR_MAX}] — wrong shape key or torn "
            f"measurement, refusing to calibrate")
    factors = {t: 1.0 for t in TERMS}
    # the largest term: the bound term's factor alone reproduces the
    # measurement when the result still covers every hidden term
    f_b = measured_t / times[bterm]
    solvable = f_b * times[bterm] >= max(
        (v for t, v in times.items() if t != bterm), default=0.0)
    if solvable and FACTOR_MIN <= f_b <= FACTOR_MAX:
        factors[bterm] = f_b
        method = "bound_term"
    else:
        factors = {t: scale for t in TERMS}
        method = "uniform"
    cal_t = _combined_time(apply_to_times(times, factors))
    return {
        "factors": {t: round(f, 9) for t, f in factors.items()},
        "method": method,
        "bound_class": tc[bterm],
        "model_residual_pct": round((scale - 1.0) * 100.0, 2),
        "term_residual_pct": {
            t: round((factors[t] - 1.0) * 100.0, 2) for t in TERMS},
        "measured_qps": round(nq_model / measured_t, 2),
        "analytic_ceiling_qps": block.get("ceiling_qps_analytic")
        or block.get("ceiling_qps"),
        "calibrated_ceiling_qps": round(nq_model / cal_t, 1),
        "source": src,
        "model_version": block.get("model_version"),
        "samples": 1,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "measured_at_unix": round(time.time(), 3),
        "provenance": {
            "device_kind": block.get("device_kind"),
            "shape_key": key_for_block(block),
            "nq_model": nq_model, "nq_measured": m_nq,
            "device_s": round(float(dev_s), 6),
            **(provenance or {}),
        },
    }


def apply_to_times(times: Dict[str, float],
                   factors: Dict[str, float]) -> Dict[str, float]:
    """Calibrated per-term times (missing factors default to 1.0)."""
    return {t: float(times[t]) * float(factors.get(t, 1.0)) for t in times}


def entry_age_s(entry: dict) -> Optional[float]:
    ts = entry.get("measured_at_unix")
    if not isinstance(ts, (int, float)):
        return None
    return max(0.0, round(time.time() - float(ts), 1))


def lookup_for_block(block: dict,
                     path: Optional[str] = None) -> Optional[dict]:
    """The store entry covering this block's key, or None (no store, no
    entry, a stale model token)."""
    key = key_for_block(block)
    if key is None:
        return None
    return get(key, path)


def publish(label: str, cal: dict) -> None:
    """Export one block's calibration verdict (obs-gated): the applied
    flag, the entry's age and the analytic model's residual."""
    if not registry.enabled():
        return
    applied = bool(cal.get("applied"))
    registry.gauge(names.CALIBRATION_APPLIED, config=label).set(
        1.0 if applied else 0.0)
    if not applied:
        return
    age = cal.get("age_s")
    if isinstance(age, (int, float)):
        registry.gauge(names.CALIBRATION_AGE, config=label).set(float(age))
    res = cal.get("model_residual_pct")
    if isinstance(res, (int, float)):
        registry.gauge(names.CALIBRATION_RESIDUAL, config=label).set(
            float(res))
    trace.emit_event("calibration.publish", config=label,
                     source=cal.get("source"), model_residual_pct=res)


def status() -> dict:
    """The /statusz ``calibration`` section: the store, its entries under
    the current model token, and the worst per-term residual on file."""
    path = store_path()
    out: dict = {"store": path, "exists": False, "entries": 0,
                 "model_token": model_token(),
                 "worst_residual_pct": None}
    if not path:
        return out
    out["exists"] = os.path.exists(path)
    live = {k: v for k, v in load(path).items()
            if k.endswith(f"|{model_token()}") and isinstance(v, dict)}
    out["entries"] = len(live)
    out["keys"] = sorted(live)
    worst = worst_key = None
    for key, e in live.items():
        for t, pct in (e.get("term_residual_pct") or {}).items():
            if isinstance(pct, (int, float)) and (
                    worst is None or abs(pct) > abs(worst)):
                worst, worst_key = pct, f"{key}:{t}"
    out["worst_residual_pct"] = worst
    out["worst_residual_key"] = worst_key
    return out


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_calibration(cal) -> List[str]:
    """Structural check of a block's ``calibration`` field; a list of
    errors, empty when well formed.  An absent overlay is explicit: a dict
    with ``applied: false``.  An applied one has a positive factor for
    every term of :data:`TERMS`, a ``source`` of :data:`SOURCES` and a
    numeric ``model_residual_pct``."""
    if not isinstance(cal, dict):
        return [f"calibration is {type(cal).__name__}, not dict"]
    if not isinstance(cal.get("applied"), bool):
        return [f"calibration.applied {cal.get('applied')!r} is not a bool"]
    if not cal["applied"]:
        return []
    errs = []
    factors = cal.get("factors")
    if not isinstance(factors, dict):
        errs.append("applied calibration missing factors dict")
    else:
        for t in TERMS:
            f = factors.get(t)
            if not _number(f) or f <= 0:
                errs.append(f"calibration factor {t} {f!r} is not a "
                            f"positive number")
    if cal.get("source") not in SOURCES:
        errs.append(f"calibration source {cal.get('source')!r} not in "
                    f"{SOURCES}")
    if not _number(cal.get("model_residual_pct")):
        errs.append(f"calibration.model_residual_pct "
                    f"{cal.get('model_residual_pct')!r} is not a number")
    return errs


def validate_campaign_block(block) -> List[str]:
    """Structural check of an artifact's ``campaign`` block: an int
    ``campaign_version``, an ``arm``, a non-empty ``stages`` list whose
    every record has a ``stage`` and a ``status`` of ok / error / skipped,
    and a bool ``rehearse``."""
    if not isinstance(block, dict):
        return [f"campaign block is {type(block).__name__}, not dict"]
    errs = []
    v = block.get("campaign_version")
    if not isinstance(v, int) or isinstance(v, bool):
        errs.append("missing/non-int campaign_version")
    if not block.get("arm"):
        errs.append("missing arm name")
    stages = block.get("stages")
    if not isinstance(stages, list) or not stages:
        errs.append("missing stages list")
    else:
        for s in stages:
            if not isinstance(s, dict) or not s.get("stage") or \
                    s.get("status") not in ("ok", "error", "skipped"):
                errs.append(f"malformed stage record {s!r}")
                break
    if not isinstance(block.get("rehearse"), bool):
        errs.append("missing/non-bool rehearse flag")
    return errs


def reset() -> None:
    """Drop the read memo (test isolation); the configured store stays."""
    with _lock:
        _read_memo.clear()
