"""The latency-vs-throughput knee: a stepped-rate sweep that locates the
highest sustained rate where admitted-request tail latency still meets
the SLO, emitted as one block — the port of knn_tpu/loadgen/knee.py.

Below the knee, added load is free; above it, every extra offered
request is paid in tail latency (or, with admission control on, in
explicit sheds).  :func:`knee_block` is the block's shape and
:func:`validate_knee_block` its structural check, with the JAX package's
error strings (its artifact-schema catalog's ``loadgen_knee`` entry,
written out here: the port imports nothing of the JAX package).

The sweep is target-agnostic: a factory returns a fresh
``QueryQueue``-shaped target per step, so one step's saturated backlog
never pollutes the next step's latency.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

from knn_tpu_torch.loadgen import driver
from knn_tpu_torch.loadgen.workload import WorkloadSpec, generate

#: block schema version
BLOCK_VERSION = 1

#: fields every rate step must carry
STEP_FIELDS = ("rate_qps", "offered", "ok", "achieved_qps",
               "shed_fraction", "within_slo")


def run_step(target, spec: WorkloadSpec, *, queries,
             submitters: int = 2, waiters: int = 2) -> dict:
    """One rate step: drive the spec open-loop, return the driver report
    plus the step's offered-rate label."""
    reqs = generate(spec)
    rep = driver.run_workload(target, reqs, queries=queries,
                              submitters=submitters, waiters=waiters)
    rep["rate_qps"] = spec.rate_qps
    return rep


def knee_sweep(target_factory: Callable[[], object],
               base: WorkloadSpec, rates: Sequence[float], *,
               queries, slo_p99_ms: float,
               submitters: int = 2, waiters: int = 2) -> dict:
    """Stepped-rate sweep -> knee block.  ``target_factory`` builds a
    fresh target per step (closed afterwards when it has a ``close``);
    ``rates`` are the offered request rates (q/s), ascending; the knee is
    the highest achieved rate among steps whose admitted p99 meets
    ``slo_p99_ms``."""
    if not rates:
        raise ValueError("need at least one rate step")
    if slo_p99_ms <= 0:
        raise ValueError(f"slo_p99_ms must be > 0, got {slo_p99_ms}")
    steps: List[dict] = []
    for rate in rates:
        spec = base.at_rate(rate)
        if not generate(spec):
            # a low step's Poisson draw can produce zero arrivals: record
            # the empty step instead of aborting the sweep
            steps.append({
                "rate_qps": float(rate), "offered": 0, "ok": 0,
                "rejected": 0, "shed": 0, "errors": 0,
                "offered_qps": None, "achieved_qps": None,
                "shed_fraction": None, "admitted_p50_ms": None,
                "admitted_p95_ms": None, "admitted_p99_ms": None,
                "within_slo": False, "empty_schedule": True,
                "per_tenant": {}})
            continue
        target = target_factory()
        try:
            rep = run_step(target, spec, queries=queries,
                           submitters=submitters, waiters=waiters)
        finally:
            close = getattr(target, "close", None)
            if callable(close):
                close()
        lat = rep.get("latency_ms") or {}
        p99 = lat.get("p99")
        within = p99 is not None and p99 <= slo_p99_ms
        steps.append({
            "rate_qps": float(rate),
            "offered": rep["offered"],
            "ok": rep["ok"],
            "rejected": rep["rejected"],
            "shed": rep["shed"],
            "errors": rep["errors"],
            "offered_qps": rep["offered_qps"],
            "achieved_qps": rep["achieved_qps"],
            "shed_fraction": rep["shed_fraction"],
            "admitted_p50_ms": lat.get("p50"),
            "admitted_p95_ms": lat.get("p95"),
            "admitted_p99_ms": lat.get("p99"),
            "within_slo": bool(within),
            "per_tenant": rep.get("per_tenant"),
            "slowest": rep.get("slowest"),
        })
    return knee_block(steps, slo_p99_ms=slo_p99_ms)


def knee_block(steps: Sequence[dict], *, slo_p99_ms: float) -> dict:
    """The block: the step table plus the detected knee — the highest
    achieved q/s among SLO-meeting steps (None when no step met the SLO:
    'knee below the lowest step' rather than a made-up number)."""
    best = None
    best_rate = None
    for s in steps:
        if s.get("within_slo") and s.get("achieved_qps") is not None:
            if best is None or s["achieved_qps"] > best:
                best = s["achieved_qps"]
                best_rate = s["rate_qps"]
    return {
        "version": BLOCK_VERSION,
        "slo_p99_ms": float(slo_p99_ms),
        "rate_steps": list(steps),
        "knee_qps": best,
        "knee_rate_qps": best_rate,
    }


def validate_knee_block(block) -> List[str]:
    """Structural validation of a knee block: the list of violations
    (empty = valid), in the JAX package's words.  A block that recorded
    its own failure (an ``error`` key) is exempt."""
    if not isinstance(block, dict):
        return [f"knee block must be a dict, got {type(block).__name__}"]
    if "error" in block:
        return []
    errors: List[str] = []
    version = block.get("version")
    if version != BLOCK_VERSION:
        errors.append(f"version must be {BLOCK_VERSION}, got {version!r}")
    slo = block.get("slo_p99_ms")
    if not (isinstance(slo, (int, float)) and slo > 0):
        errors.append(
            f"slo_p99_ms must be a positive number, got {slo!r}")
    steps = block.get("rate_steps")
    if not (isinstance(steps, list) and steps):
        errors.append("rate_steps must be a non-empty list")
    else:
        for i, s in enumerate(steps):
            if not isinstance(s, dict):
                errors.append(f"rate_steps[{i}] must be a dict")
                continue
            for fld in STEP_FIELDS:
                if fld not in s:
                    errors.append(f"rate_steps[{i}] missing {fld!r}")
    knee = block.get("knee_qps")
    if knee is not None and not isinstance(knee, (int, float)):
        errors.append(f"knee_qps must be a number or null, got {knee!r}")
    if knee is not None and isinstance(steps, list) and steps:
        if not [s for s in steps
                if isinstance(s, dict) and s.get("within_slo")]:
            errors.append("knee_qps set but no step is within_slo")
    return errors


def closed_loop_anchor(queue, pool, *, requests: int = 32,
                       rows: int = 4) -> float:
    """A quick closed-loop capacity probe: burst ``requests`` small
    submissions through ``queue`` and measure completions/s.  Bursts
    coalesce maximally, so this over-estimates open-loop capacity — pair
    it with :func:`rates_around`.  Drive an admission-free queue."""
    rows = min(rows, pool.shape[0])
    t0 = time.monotonic()
    futs = [queue.submit(pool[:rows]) for _ in range(requests)]
    for f in futs:
        f.result()
    return requests / max(time.monotonic() - t0, 1e-9)


def rates_around(anchor_qps: float,
                 fractions: Sequence[float] = (0.05, 0.1, 0.2, 0.4,
                                               0.7, 1.0, 1.5),
                 ) -> List[float]:
    """Default step ladder around an anchor rate, reaching more than a
    decade below it (a closed-loop anchor over-estimates open-loop
    capacity) and modestly above."""
    if anchor_qps <= 0:
        raise ValueError(f"anchor_qps must be > 0, got {anchor_qps}")
    return [round(anchor_qps * f, 3) for f in fractions]
