"""Noise-aware perf-regression sentinel over the bench history — the
port of knn_tpu/obs/sentinel.py.

The repo accumulates measured lines per config per round: the JAX
package's curated ``TPU_BENCH_r*.jsonl`` artifacts and ``BENCH_r*.json``
driver records, and the port's own curated ``GPU_BENCH_r*.jsonl``
(``knn_tpu_torch/scripts/refresh_bench_artifacts.py``, ROADMAP
divergence 67).  This module turns that history into a ROBUST baseline
per curated metric — median + MAD (median absolute deviation), the
estimator pair that one outlier round cannot drag — and classifies a
fresh measurement against it:

- ``ok``       within historical jitter (<= max(2·σ_rel, 2%) below the
               median, where σ = 1.4826·MAD, the normal-consistent
               robust sigma), or faster than baseline;
- ``warn``     between the jitter band and the regression bar;
- ``regress``  >= max(4·σ_rel, 10%) below the median;
- ``no_baseline``  fewer than MIN_SAMPLES comparable historical points.

Both bars are CAPPED (OK_CEIL / REGRESS_CEIL): however scattered the
history, a 40% drop is always a regression.

Baseline hygiene:

- **stale guard**: lines the refresher marked ``stale`` (a republished
  earlier-round number) NEVER enter a baseline;
- **commit dedupe**: two lines carrying the same ``measured_at_commit``
  and the same value are one measurement republished, and count once;
- **like-for-like keys**: baselines key on (metric, backend, precision
  family) — an H100 (``cuda``) line never enters, or is judged against,
  a TPU baseline, a CPU line never a card's, and an int8 line never the
  f32-family one.

Everything here is stdlib-only and file-format tolerant: a malformed
line is skipped, never fatal.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

#: minimum comparable history points before a verdict is rendered
MIN_SAMPLES = 3

#: relative drop always inside jitter (measurement floor)
OK_FLOOR = 0.02

#: relative drop always a regression, however noisy the history
REGRESS_FLOOR = 0.10

#: jitter band: ok while drop <= OK_SIGMAS * sigma_rel
OK_SIGMAS = 2.0

#: regression bar: regress once drop >= REGRESS_SIGMAS * sigma_rel
REGRESS_SIGMAS = 4.0

#: noise ceilings: past REGRESS_CEIL always a regression, past OK_CEIL
#: never plain ok
OK_CEIL = 0.25
REGRESS_CEIL = 0.40

#: normal-consistency constant: sigma = MAD_SCALE * MAD
MAD_SCALE = 1.4826


def _curated_fields() -> Tuple[Tuple[str, str], ...]:
    # imported here: an obs module imports nothing of the port outside
    # obs at import time
    from knn_tpu_torch.analysis.artifacts import curated_fields

    return curated_fields()


#: the curated fields a baseline tracks, with their good direction —
#: DERIVED from the artifact-schema catalog (each block's schema declares
#: its curated contribution; the ``artifact-lockstep`` checker fails the
#: lint if this derivation is ever removed)
CURATED_FIELDS: Tuple[Tuple[str, str], ...] = _curated_fields()

#: the curated line families the history holds, in reading order: the JAX
#: package's TPU rounds, then the port's own (the refresher writes
#: ``GPU_BENCH_r{N}.jsonl``)
CURATED_GLOBS = ("TPU_BENCH_r*.jsonl", "GPU_BENCH_r*.jsonl")

#: the port's curated family: the rounds ``perf_sentinel --check-latest``
#: judges
PORT_CURATED_GLOB = "GPU_BENCH_r*.jsonl"


def curated_value(rec: dict, fname: str):
    """One curated field off a history line: top-level first, falling
    back into the line's ``roofline`` / ``loadgen_knee`` / ``mutation``
    block — or, for ``device_phase_qps``, the winning selector's
    ``phase_breakdown.device_qps`` — for lines curated before the hoist.
    ``model_residual_pct`` is judged by its magnitude."""
    v = rec.get(fname)
    if v is None and fname == "roofline_pct":
        block = rec.get("roofline")
        if isinstance(block, dict):
            v = block.get("roofline_pct")
    if v is None and fname == "knee_qps":
        block = rec.get("loadgen_knee")
        if isinstance(block, dict):
            v = block.get("knee_qps")
    if v is None and fname == "mutation_admitted_p99_ms":
        block = rec.get("mutation")
        if isinstance(block, dict):
            v = block.get("admitted_p99_ms")
    if v is None and fname == "device_phase_qps":
        sel = rec.get("selectors")
        if isinstance(sel, dict):
            entry = sel.get(rec.get("mode"))
            if isinstance(entry, dict):
                pb = entry.get("phase_breakdown")
                if isinstance(pb, dict):
                    v = pb.get("device_qps")
    if fname == "model_residual_pct":
        if v is None:
            block = rec.get("roofline")
            if isinstance(block, dict):
                cal = block.get("calibration")
                if isinstance(cal, dict):
                    v = cal.get("model_residual_pct")
        # drift magnitude: the residual is signed, the baseline judges
        # how FAR from zero the model sits either way
        if isinstance(v, (int, float)):
            v = abs(v)
    return v


#: verdict severity order (worst wins the overall verdict)
_SEVERITY = {"regress": 3, "warn": 2, "ok": 1, "no_baseline": 0}

_ROUND_RE = re.compile(r"_r(\d+)\.(?:jsonl|json)$")


def _file_round(path: str) -> Optional[int]:
    m = _ROUND_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def baseline_key(rec: dict) -> Optional[str]:
    """(metric, backend, precision family) — like-for-like
    comparability.  Precision collapses to int8-vs-everything-else (int8
    is different arithmetic and curates under its own key)."""
    metric = rec.get("metric")
    if not metric:
        return None
    backend = rec.get("backend") or "unknown"
    precision = "int8" if rec.get("precision") == "int8" else "default"
    return f"{metric}|{backend}|{precision}"


def _curated_paths(repo_dir: str) -> List[str]:
    return [path for pattern in CURATED_GLOBS
            for path in sorted(glob.glob(os.path.join(repo_dir, pattern)))]


def iter_history_lines(repo_dir: str,
                       max_round: Optional[int] = None) -> Iterable[dict]:
    """Every parseable measurement record in the repo's bench history:
    the curated lines of :data:`CURATED_GLOBS` plus the ``BENCH_r*.json``
    driver records' parsed/tail line.  ``max_round`` bounds the history
    to rounds STRICTLY BELOW it (so a round's own lines never seed the
    baseline they are judged against)."""
    for path in _curated_paths(repo_dir):
        rnd = _file_round(path)
        if max_round is not None and (rnd is None or rnd >= max_round):
            continue
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                rec.setdefault("_source", os.path.basename(path))
                if rnd is not None:
                    rec.setdefault("measured_round", rnd)
                yield rec
    for path in sorted(glob.glob(os.path.join(repo_dir, "BENCH_r*.json"))):
        rnd = _file_round(path)
        if max_round is not None and (rnd is None or rnd >= max_round):
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        rec = doc.get("parsed")
        if not isinstance(rec, dict) or rec.get("value") is None:
            # fall back to the last JSON line embedded in the tail
            rec = None
            for line in str(doc.get("tail", "")).splitlines():
                line = line.strip()
                if line.startswith("{"):
                    try:
                        cand = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(cand, dict) and cand.get("metric"):
                        rec = cand
        if isinstance(rec, dict):
            rec.setdefault("_source", os.path.basename(path))
            if rnd is not None:
                rec.setdefault("measured_round", rnd)
            yield rec


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def build_baselines(records: Iterable[dict],
                    min_samples: int = MIN_SAMPLES) -> dict:
    """``{baseline_key: {field: {median, mad, sigma, n, values}}}`` from
    the history, applying the stale guard and commit dedupe."""
    acc: Dict[str, Dict[str, dict]] = {}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("stale") is True:
            continue  # republished number: never a fresh observation
        key = baseline_key(rec)
        if key is None or rec.get("value") is None:
            continue
        commit = rec.get("measured_at_commit")
        for fname, _direction in CURATED_FIELDS:
            v = curated_value(rec, fname)
            if not isinstance(v, (int, float)):
                continue
            slot = acc.setdefault(key, {}).setdefault(
                fname, {"values": [], "seen": set()})
            if commit and commit != "unknown(pre-provenance)":
                dedupe = (commit, float(v))
                if dedupe in slot["seen"]:
                    continue  # same measurement republished
                slot["seen"].add(dedupe)
            slot["values"].append(float(v))
    out: Dict[str, Dict[str, dict]] = {}
    for key, fields in acc.items():
        for fname, slot in fields.items():
            vals = slot["values"]
            if len(vals) < min_samples:
                continue
            med = _median(vals)
            mad = _median([abs(v - med) for v in vals])
            out.setdefault(key, {})[fname] = {
                "median": round(med, 4),
                "mad": round(mad, 4),
                "sigma": round(MAD_SCALE * mad, 4),
                "n": len(vals),
                "values": [round(v, 4) for v in sorted(vals)],
            }
    return out


def classify(value: float, base: dict, direction: str = "higher") -> dict:
    """One field's verdict against its baseline stats (see the module
    docstring for the thresholds)."""
    med = base["median"]
    sigma = base["sigma"]
    if med == 0:
        return {"verdict": "no_baseline",
                "reason": "degenerate baseline (median 0)"}
    if direction == "higher":
        drop = (med - value) / abs(med)
    else:
        drop = (value - med) / abs(med)
    sigma_rel = sigma / abs(med)
    ok_bar = min(max(OK_SIGMAS * sigma_rel, OK_FLOOR), OK_CEIL)
    regress_bar = min(max(REGRESS_SIGMAS * sigma_rel, REGRESS_FLOOR),
                      REGRESS_CEIL)
    if drop <= ok_bar:
        verdict = "ok"
    elif drop >= regress_bar:
        verdict = "regress"
    else:
        verdict = "warn"
    return {
        "verdict": verdict,
        "value": round(float(value), 4),
        "baseline_median": med,
        "baseline_sigma": sigma,
        "baseline_n": base["n"],
        "drop_rel": round(drop, 4),
        # effect size in robust sigmas (None when the history was
        # perfectly tight: the relative floors carry the judgment alone)
        "effect_sigmas": (round(drop / sigma_rel, 2)
                          if sigma_rel > 0 else None),
        "ok_bar": round(ok_bar, 4),
        "regress_bar": round(regress_bar, 4),
    }


def verdict_for_line(rec: dict, repo_dir: Optional[str] = None,
                     baselines: Optional[dict] = None) -> dict:
    """The ``sentinel`` block a bench line carries: per curated field a
    classification, plus the overall (worst) verdict.  Either pass
    prebuilt ``baselines`` or a ``repo_dir`` to read history from."""
    if baselines is None:
        if repo_dir is None:
            raise ValueError("need repo_dir or baselines")
        baselines = build_baselines(iter_history_lines(repo_dir))
    key = baseline_key(rec)
    fields: Dict[str, dict] = {}
    overall = "no_baseline"
    base_fields = baselines.get(key, {}) if key else {}
    for fname, direction in CURATED_FIELDS:
        v = curated_value(rec, fname)
        if not isinstance(v, (int, float)):
            continue
        base = base_fields.get(fname)
        if base is None:
            fields[fname] = {"verdict": "no_baseline",
                             "reason": f"< {MIN_SAMPLES} comparable "
                                       f"history points"}
        else:
            fields[fname] = classify(float(v), base, direction)
        if _SEVERITY[fields[fname]["verdict"]] > _SEVERITY[overall]:
            overall = fields[fname]["verdict"]
    return {"verdict": overall, "baseline_key": key, "fields": fields}
