"""Declarative SLOs evaluated with multi-window burn rates over the
registry — the port of knn_tpu/obs/slo.py, the judgement layer the raw
counters and histograms feed.

An **objective** is either

- a ``ratio`` (bad-event counter / total counter, e.g. serving errors per
  request) with an availability ``target``: the error budget is
  ``1 - target``, and the **burn rate** over a window is the window's error
  ratio divided by that budget (burn 1.0 = spending the budget exactly as
  fast as the SLO allows; burn 6.0 = six times too fast); or
- a ``quantile`` (a bounded-window histogram percentile, e.g. request p99
  latency) against an absolute ``threshold``; its "burn rate" is
  value / threshold, reported under the pseudo-window ``hist``.

Counters are cumulative, so windowed ratios need history: each
:meth:`SLOEngine.evaluate` appends one timestamped sample of every
referenced counter to a bounded ring and takes deltas against the sample
nearest each window's far edge (the span actually used is reported beside
the requested one).  An objective **breaches** when every configured
window is confirmable (its actual span has reached ``MIN_SPAN_FRACTION``
of its requested span) and burns at or above the objective's
``burn_threshold`` (ratio default 6x budget; quantile default 1x
threshold).  The ring is thinned to one sample per ``slow_span /
(SAMPLE_RING/2)`` seconds, so fast polling never starves the slow window
of history; one lock serializes each evaluation, so concurrent callers
never double-emit a transition.

Breach state is edge-triggered: the healthy -> breached transition emits
exactly one ``slo.alert`` event (``state="firing"``), increments
``knn_tpu_slo_breach_transitions_total`` and sets
``knn_tpu_slo_breached{objective}``; recovery emits one ``state="resolved"``
event and clears the gauge.  The firing transitions are collected under
the lock and handed to the flight recorder (:mod:`knn_tpu_torch.obs.
blackbox`) only after it is released: the recorder re-enters
``health.report()``, whose own paths evaluate SLOs.

Disabled mode (``obs.reset(enabled=False)``): :func:`get_slo_engine`
returns one shared inert engine whose ``evaluate()`` returns ``{}``.

Where the port differs (ROADMAP queue C): the objectives and the windows
are arguments — :func:`load_objectives` reads a JSON file only when given
its path, and :func:`reset_slo_engine` takes ``objectives=`` and
``windows=`` — where the JAX package reads an environment variable; a chip
run passes windows of seconds, which the defaults' 60 s / 600 s would
never confirm within it.  The fleet helpers :func:`evaluate_fleet` and
:class:`FleetSLOEngine` are pure functions over the merged report's dicts,
called by the fleet plane (knn_tpu_torch.obs.fleet) with the objectives in
force (:func:`objectives_in_force`).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from knn_tpu_torch.obs import names, registry, trace

#: (label, span seconds) — the fast window confirms a breach is live,
#: the slow one that it is sustained
DEFAULT_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("fast", 60.0), ("slow", 600.0))

#: counter-sample ring bound: at one evaluate per scrape (~15 s) this
#: holds over an hour of history, enough for the slow window
SAMPLE_RING = 256

#: a window may only CONFIRM a breach once its actual span reaches this
#: fraction of the requested span — a cold-start engine whose whole
#: history is one second old must not page the 600 s window off that
#: second (the exact failure multi-window burn rates exist to prevent)
MIN_SPAN_FRACTION = 0.5


@dataclass(frozen=True)
class Objective:
    """One declarative SLO.  ``kind="ratio"``: ``num``/``den`` are
    catalog counter names (all label series summed) and ``target`` is
    the availability goal (budget = 1 - target).  ``kind="quantile"``:
    ``hist`` is a catalog histogram name and ``threshold`` the absolute
    bound (seconds for the latency objectives) on ``quantile``.

    ``group_by`` names a label (e.g. ``"tenant"``) to evaluate the
    objective PER LABEL VALUE instead of over the summed surface: each
    value gets its own burn rates, breach state, and edge-triggered
    alert (reported as ``<name>:<value>``), so one tenant's burn pages
    that tenant, not the fleet."""

    name: str
    kind: str  # "ratio" | "quantile"
    num: Optional[str] = None
    den: Optional[str] = None
    target: Optional[float] = None
    hist: Optional[str] = None
    quantile: str = "p99"
    threshold: Optional[float] = None
    #: breach when every window burns at >= this multiple of budget
    #: (ratio default 6.0); for quantile objectives, value/threshold at
    #: >= this multiple (default 1.0 — the threshold IS the line).
    #: None = the kind's default.
    burn_threshold: Optional[float] = None
    #: evaluate per value of this label instead of summed (see above)
    group_by: Optional[str] = None

    @property
    def effective_burn_threshold(self) -> float:
        if self.burn_threshold is not None:
            return self.burn_threshold
        return 6.0 if self.kind == "ratio" else 1.0

    def validate(self) -> None:
        from knn_tpu_torch.obs.names import CATALOG

        if self.kind == "ratio":
            for role, metric in (("num", self.num), ("den", self.den)):
                if metric not in CATALOG:
                    raise ValueError(
                        f"SLO {self.name!r}: {role}={metric!r} is not a "
                        f"catalog metric")
                if CATALOG[metric][0] != "counter":
                    raise ValueError(
                        f"SLO {self.name!r}: {role}={metric!r} must be a "
                        f"counter, is a {CATALOG[metric][0]}")
            if not (self.target is not None and 0.0 < self.target < 1.0):
                raise ValueError(
                    f"SLO {self.name!r}: ratio target must be in (0, 1), "
                    f"got {self.target}")
        elif self.kind == "quantile":
            if self.hist not in CATALOG:
                raise ValueError(
                    f"SLO {self.name!r}: hist={self.hist!r} is not a "
                    f"catalog metric")
            if CATALOG[self.hist][0] != "histogram":
                raise ValueError(
                    f"SLO {self.name!r}: hist={self.hist!r} must be a "
                    f"histogram, is a {CATALOG[self.hist][0]}")
            if self.quantile not in ("p50", "p95", "p99"):
                raise ValueError(
                    f"SLO {self.name!r}: quantile must be p50/p95/p99, "
                    f"got {self.quantile!r}")
            if not (self.threshold is not None and self.threshold > 0):
                raise ValueError(
                    f"SLO {self.name!r}: quantile threshold must be > 0, "
                    f"got {self.threshold}")
        else:
            raise ValueError(
                f"SLO {self.name!r}: kind must be 'ratio' or 'quantile', "
                f"got {self.kind!r}")
        if self.burn_threshold is not None and self.burn_threshold <= 0:
            raise ValueError(
                f"SLO {self.name!r}: burn_threshold must be > 0")
        if self.group_by is not None:
            from knn_tpu_torch.obs.names import CATALOG

            metrics = ((self.num, self.den) if self.kind == "ratio"
                       else (self.hist,))
            for metric in metrics:
                if self.group_by not in CATALOG[metric][1]:
                    raise ValueError(
                        f"SLO {self.name!r}: group_by={self.group_by!r} "
                        f"is not a label of {metric!r} "
                        f"(labels: {sorted(CATALOG[metric][1])})")


#: the serving-stack defaults: availability, tail
#: latency, queue wait, and the certified path's quality rates
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(name="serving_availability", kind="ratio",
              num=names.SERVING_ERRORS, den=names.SERVING_REQUESTS,
              target=0.999),
    Objective(name="serving_request_p99", kind="quantile",
              hist=names.SERVING_REQUEST_LATENCY, quantile="p99",
              threshold=1.0),
    Objective(name="queue_wait_p95", kind="quantile",
              hist=names.QUEUE_WAIT, quantile="p95",
              threshold=0.1),
    Objective(name="certified_fallback_rate", kind="ratio",
              num=names.CERTIFIED_FALLBACKS, den=names.CERTIFIED_QUERIES,
              target=0.95),
    Objective(name="certified_false_alarm_rate", kind="ratio",
              num=names.CERTIFIED_FALSE_ALARMS, den=names.CERTIFIED_QUERIES,
              target=0.99),
    # per-tenant attribution: the grouped objectives evaluate one burn
    # rate PER TENANT over the tenant-labeled serving metrics, so a
    # single tenant's burst pages as <name>:<tenant>, not globally.
    # Tenant-free processes produce no tenant series -> empty groups,
    # zero cost.
    Objective(name="tenant_availability", kind="ratio",
              num=names.TENANT_ERRORS, den=names.TENANT_REQUESTS,
              target=0.999, group_by="tenant"),
    Objective(name="tenant_request_p99", kind="quantile",
              hist=names.TENANT_REQUEST_LATENCY, quantile="p99",
              threshold=1.0, group_by="tenant"),
    # audited quality: deficient (recall@k < 1) audited queries per
    # replayed query, per tenant — the shadow audit sampler
    # (knn_tpu_torch.obs.audit) feeds both counters; audit-free processes
    # produce no series -> empty groups, zero cost.  A breach writes
    # a postmortem bundle embedding the failing audit records.
    Objective(name="audit_recall", kind="ratio",
              num=names.AUDIT_DEFICIENT, den=names.AUDIT_REPLAYED,
              target=0.999, group_by="tenant"),
)


def load_objectives(path: Optional[str] = None) -> Tuple[Objective, ...]:
    """The objectives: the JSON list at ``path`` replacing the defaults,
    or :data:`DEFAULT_OBJECTIVES` when no path is given; every entry is
    validated against the catalog.  Raises ``ValueError`` on any bad
    entry, so a broken file fails where it is loaded, not at serve
    time."""
    if not path:
        objs = DEFAULT_OBJECTIVES
    else:
        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, list) or not raw:
            raise ValueError(
                f"SLO config {path}: expected a non-empty JSON list")
        objs = tuple(Objective(**entry) for entry in raw)
    seen = set()
    for o in objs:
        if o.name in seen:
            raise ValueError(f"duplicate SLO objective name {o.name!r}")
        seen.add(o.name)
        o.validate()
    return objs


def _summed(snapshot: dict, name: str) -> float:
    """Sum of every label series of a counter (SLOs judge the whole
    surface; per-label drill-down is what the raw metric is for)."""
    m = snapshot.get(name)
    if not m:
        return 0.0
    return float(sum(s["value"] for s in m["series"]))


def _summed_by(snapshot: dict, name: str, label: str) -> Dict[str, float]:
    """Per-label-value sums of a counter — the grouped objectives'
    read: {label value: sum over the series carrying it}."""
    m = snapshot.get(name)
    out: Dict[str, float] = {}
    if not m:
        return out
    for s in m["series"]:
        val = s["labels"].get(label)
        if val is None:
            continue
        out[val] = out.get(val, 0.0) + float(s["value"])
    return out


def _group_key(name: str, label: str, value: str) -> str:
    """Composite sample-ring key for one label value of a grouped
    counter (the ring stores flat {key: float} samples either way)."""
    return f"{name}|{label}={value}"


def _hist_summary(snapshot: dict, name: str,
                  only: Optional[Tuple[str, str]] = None) -> Optional[dict]:
    """Merged summary across a histogram's label series (max of the
    quantiles — the conservative read for a threshold objective —
    plus combined window metadata).  ``only=(label, value)`` restricts
    the merge to series carrying that label value (grouped
    objectives)."""
    m = snapshot.get(name)
    if not m:
        return None
    merged: Optional[dict] = None
    for s in m["series"]:
        if only is not None and s["labels"].get(only[0]) != only[1]:
            continue
        v = s["value"]
        if "p50" not in v:
            continue
        if merged is None:
            merged = dict(v)
        else:
            for q in ("p50", "p95", "p99"):
                merged[q] = max(merged[q], v[q])
            merged["window"] = merged.get("window", 0) + v.get("window", 0)
            spans = [x for x in (merged.get("window_span_s"),
                                 v.get("window_span_s")) if x is not None]
            if spans:
                merged["window_span_s"] = max(spans)
    return merged


class SLOEngine:
    """Evaluates the objectives against the live registry; owns the
    counter-sample ring the burn-rate windows delta against.

    ``windows`` are ``(label, span seconds)`` pairs, each span > 0;
    ``clock`` is the monotonic clock ``evaluate()`` reads when it is not
    given ``now``.

    Thread-safety: guarded by ``self._lock`` (one lock over the whole
    read-evaluate-transition-append pass, see :meth:`evaluate`)."""

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 windows: Sequence[Tuple[str, float]] = DEFAULT_WINDOWS,
                 clock=time.monotonic):
        self.objectives = tuple(
            load_objectives() if objectives is None else objectives)
        self.windows = tuple((str(label), float(span))
                             for label, span in windows)
        if not self.windows or any(span <= 0 for _, span in self.windows):
            raise ValueError(
                f"SLO windows must be (label, span > 0) pairs, got "
                f"{windows!r}")
        if len({label for label, _ in self.windows}) != len(self.windows):
            raise ValueError(f"SLO window labels repeat: {windows!r}")
        self._clock = clock
        self._lock = threading.Lock()
        #: (monotonic t, {counter name: summed value})
        self._samples: deque = deque(maxlen=SAMPLE_RING)
        #: thin the ring so it always spans the slowest window even
        #: under fast polling (a 10 Hz stats() dashboard must not cap
        #: the stored history at ring/10 seconds): keep at most one
        #: sample per interval, sized so half the ring covers the
        #: slowest window
        max_span = max((s for _, s in self.windows), default=600.0)
        self._min_sample_gap = max_span / (SAMPLE_RING // 2)
        self._breached: Dict[str, bool] = {}
        #: firing transitions collected DURING an evaluation pass (under
        #: the lock) and handed to the flight recorder AFTER it: the
        #: recorder re-reads health/metrics state whose own code paths
        #: evaluate SLOs, so invoking it lock-held would deadlock
        self._fired: list = []

    # -- window machinery --------------------------------------------------
    def _ratio_counters(self):
        """(counter name, group_by label or None) pairs the sample ring
        must track — grouped objectives store one composite key per
        label value instead of one summed key."""
        out = set()
        for o in self.objectives:
            if o.kind == "ratio":
                out.add((o.num, o.group_by))
                out.add((o.den, o.group_by))
        return out

    @staticmethod
    def _window_base(samples, now: float, span: float):
        """The sample the window deltas against: the NEWEST one at least
        ``span`` old (effective span >= requested — a stale-history
        evaluation dilutes toward lifetime truth instead of inventing a
        window it has no data for), else the OLDEST available."""
        base = None
        for t, vals in samples:
            if now - t >= span:
                base = (t, vals)
            else:
                break
        return base if base is not None else (
            samples[0] if samples else None)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: returns the ``slo`` report section and,
        on breach-state transitions, emits the alert events / bumps the
        transition counter.  ``now`` is injectable for deterministic
        tests; production callers leave it None."""
        if not registry.enabled():
            return {}
        now = self._clock() if now is None else float(now)
        snap = registry.snapshot()
        registry.counter(names.SLO_EVALUATIONS).inc()
        current: Dict[str, float] = {}
        for name, group_by in self._ratio_counters():
            if group_by is None:
                current[name] = _summed(snap, name)
            else:
                for val, s in _summed_by(snap, name, group_by).items():
                    current[_group_key(name, group_by, val)] = s
        report: dict = {"objectives": {}, "breached": [],
                        "evaluated_at": round(time.time(), 3)}
        # ONE lock over read-evaluate-transition-append: concurrent
        # evaluations (serving threads' stats(), the HTTP handlers)
        # must serialize here, or two of them could both observe a
        # healthy->breached edge and double-emit the alert the
        # exactly-once contract forbids
        with self._lock:
            samples = list(self._samples)
            for o in self.objectives:
                if o.group_by is not None:
                    entry = self._eval_grouped(o, samples, current, snap,
                                               now)
                    report["objectives"][o.name] = entry
                    for gval in entry["breached"]:
                        report["breached"].append(f"{o.name}:{gval}")
                    continue
                if o.kind == "ratio":
                    entry = self._eval_ratio(o, samples, current, now)
                else:
                    entry = self._eval_quantile(o, snap)
                report["objectives"][o.name] = entry
                self._transition(o, o.name, entry)
                if entry["breached"]:
                    report["breached"].append(o.name)
            # thinned append: bound the ring's TIME span from below so
            # fast polling cannot starve the slow window of history
            if (not self._samples
                    or now - self._samples[-1][0] >= self._min_sample_gap):
                self._samples.append((now, current))
            fired, self._fired = self._fired, []
        # flight recorder outside the lock: one bundle per firing
        # transition (knn_tpu_torch.obs.blackbox; a no-op without a
        # postmortem directory).  Edge-triggering above guarantees a
        # still-breached re-evaluation never lands here again.
        if fired:
            from knn_tpu_torch.obs import blackbox

            for key, detail in fired:
                blackbox.on_breach(key, detail, slo_report=report)
        return report

    def _eval_grouped(self, o: Objective, samples, current, snap,
                      now) -> dict:
        """One evaluation per label value of ``o.group_by``: each value
        gets the full window/burn machinery under the composite
        objective key ``<name>:<value>`` (its own gauges, breach state,
        and edge-triggered alert carrying the group label).  No series
        for the label yet -> empty groups, nothing evaluated."""
        groups: Dict[str, dict] = {}
        if o.kind == "ratio":
            # discover groups from num AND den series: a tenant with
            # traffic but zero errors has no numerator series yet and
            # must still be evaluated (and read healthy)
            vals = set()
            for name in (o.num, o.den):
                prefix = _group_key(name, o.group_by, "")
                vals.update(key[len(prefix):] for key in current
                            if key.startswith(prefix))
            for val in sorted(vals):
                groups[val] = self._eval_ratio(
                    o, samples, current, now,
                    num_key=_group_key(o.num, o.group_by, val),
                    den_key=_group_key(o.den, o.group_by, val),
                    objective_label=f"{o.name}:{val}")
        else:
            m = snap.get(o.hist) or {}
            vals = sorted({s["labels"].get(o.group_by)
                           for s in m.get("series", ())} - {None})
            for val in vals:
                groups[val] = self._eval_quantile(
                    o, snap, only=(o.group_by, val),
                    objective_label=f"{o.name}:{val}")
        breached = []
        for val, entry in groups.items():
            self._transition(o, f"{o.name}:{val}", entry,
                             extra={o.group_by: val})
            if entry["breached"]:
                breached.append(val)
        return {"kind": o.kind, "group_by": o.group_by,
                "groups": groups, "breached": sorted(breached)}

    def _eval_ratio(self, o: Objective, samples, current, now, *,
                    num_key: Optional[str] = None,
                    den_key: Optional[str] = None,
                    objective_label: Optional[str] = None) -> dict:
        budget = 1.0 - o.target
        threshold = o.effective_burn_threshold
        num_key = o.num if num_key is None else num_key
        den_key = o.den if den_key is None else den_key
        objective_label = (o.name if objective_label is None
                           else objective_label)
        windows = {}
        confirms = []
        for label, span in self.windows:
            base = self._window_base(samples, now, span)
            if base is None:
                windows[label] = {"requested_s": span, "span_s": None,
                                  "ratio": None, "burn_rate": None,
                                  "confirmable": False}
                continue
            t0, vals0 = base
            actual = now - t0
            dn = current.get(num_key, 0.0) - vals0.get(num_key, 0.0)
            dd = current.get(den_key, 0.0) - vals0.get(den_key, 0.0)
            # bad events with NO denominator growth is the worst ratio,
            # not a healthy zero: a caller whose every request fails
            # before the success-side counter increments (errors grow,
            # requests don't) must breach, not hide behind div-by-zero
            ratio = (dn / dd) if dd > 0 else (1.0 if dn > 0 else 0.0)
            burn = ratio / budget if budget > 0 else 0.0
            # a window with too little history may not CONFIRM a
            # breach: one second of data must not page the 600 s
            # window (spans LONGER than requested are fine — they
            # dilute toward lifetime truth, the conservative side)
            confirmable = actual >= MIN_SPAN_FRACTION * span
            if confirmable:
                confirms.append(burn >= threshold)
            windows[label] = {
                "requested_s": span,
                "span_s": round(actual, 3),
                "confirmable": confirmable,
                "num_delta": dn, "den_delta": dd,
                "ratio": round(ratio, 6), "burn_rate": round(burn, 3),
            }
            registry.gauge(names.SLO_BURN_RATE, objective=objective_label,
                           window=label).set(burn)
        breached = (len(confirms) == len(self.windows)
                    and all(confirms))
        return {"kind": "ratio", "target": o.target, "budget": budget,
                "burn_threshold": threshold,
                "num": o.num, "den": o.den,
                "windows": windows, "breached": breached}

    def _eval_quantile(self, o: Objective, snap, *,
                       only: Optional[Tuple[str, str]] = None,
                       objective_label: Optional[str] = None) -> dict:
        s = _hist_summary(snap, o.hist, only=only)
        value = None if s is None else s.get(o.quantile)
        burn = None if value is None else value / o.threshold
        threshold = o.effective_burn_threshold  # quantile default 1.0
        if burn is not None:
            registry.gauge(
                names.SLO_BURN_RATE,
                objective=(o.name if objective_label is None
                           else objective_label),
                window="hist").set(burn)
        # which window the quantile came from rides the entry — the
        # number is meaningless without its sample count and wall span
        return {"kind": "quantile", "hist": o.hist,
                "quantile": o.quantile, "threshold_s": o.threshold,
                "burn_threshold": threshold,
                "value_s": None if value is None else round(value, 6),
                "burn_rate": None if burn is None else round(burn, 3),
                "window_samples": None if s is None else s.get("window"),
                "window_span_s": None if s is None else s.get(
                    "window_span_s"),
                "breached": bool(burn is not None
                                 and burn >= threshold)}

    def _transition(self, o: Objective, key: str, entry: dict,
                    extra: Optional[dict] = None) -> None:
        """Edge-triggered breach bookkeeping for one objective (or one
        GROUP of a grouped objective — ``key`` is ``name:value`` then,
        and ``extra`` carries the group label into the alert event).
        Caller holds ``self._lock`` (evaluate()'s single pass)."""
        was = self._breached.get(key, False)
        is_now = entry["breached"]
        registry.gauge(names.SLO_BREACHED, objective=key).set(
            1.0 if is_now else 0.0)
        if is_now == was:
            return
        self._breached[key] = is_now
        detail = {k: entry[k] for k in ("windows", "value_s", "burn_rate",
                                        "window_samples", "window_span_s")
                  if k in entry}
        if extra:
            detail.update(extra)
        if is_now:
            registry.counter(names.SLO_BREACH_TRANSITIONS,
                             objective=key).inc()
            trace.emit_event("slo.alert", objective=key,
                             state="firing", kind=o.kind, **detail)
            # queue the flight-recorder dump for after the lock drops
            self._fired.append((key, detail))
        else:
            trace.emit_event("slo.alert", objective=key,
                             state="resolved", kind=o.kind, **detail)

    def active_breaches(self):
        with self._lock:
            return sorted(n for n, b in self._breached.items() if b)


class _NoopSLOEngine:
    """Disabled-mode stand-in: ONE shared inert engine (the registry's
    no-op discipline) — evaluate allocates nothing and returns {}."""

    __slots__ = ()
    objectives: Tuple[Objective, ...] = ()

    def evaluate(self, now: Optional[float] = None) -> dict:
        return {}

    def active_breaches(self):
        return []


NOOP_SLO = _NoopSLOEngine()

_state_lock = threading.Lock()
_engine = None
#: what the next default engine is built with (reset_slo_engine sets it)
_config: dict = {"objectives": None, "windows": DEFAULT_WINDOWS}


def get_slo_engine() -> SLOEngine:
    """The process-wide SLO engine (the objectives and windows of the last
    :func:`reset_slo_engine`, else the defaults); the shared no-op when
    the subsystem is off."""
    global _engine
    if not registry.enabled():
        return NOOP_SLO
    eng = _engine
    if eng is None or isinstance(eng, _NoopSLOEngine):
        with _state_lock:
            if _engine is None or isinstance(_engine, _NoopSLOEngine):
                _engine = SLOEngine(_config["objectives"],
                                    _config["windows"])
            eng = _engine
    return eng


def reset_slo_engine(objectives: Optional[Sequence[Objective]] = None,
                     windows: Sequence[Tuple[str, float]] = DEFAULT_WINDOWS):
    """Swap in a fresh engine (clears samples and breach state) with these
    ``objectives`` (None: :data:`DEFAULT_OBJECTIVES`) and ``windows``;
    they stay the process's until the next reset."""
    global _engine
    objs = None if objectives is None else tuple(objectives)
    with _state_lock:
        new = SLOEngine(objs, windows)
        _config.update(objectives=objs, windows=new.windows)
        _engine = new if registry.enabled() else NOOP_SLO
        return _engine


def objectives_in_force() -> Optional[Tuple[Objective, ...]]:
    """The objectives of the last :func:`reset_slo_engine` (None: the
    defaults)."""
    return _config["objectives"]


def windows_in_force() -> Tuple[Tuple[str, float], ...]:
    """The windows the process-wide engine evaluates with."""
    return _config["windows"]


def slo_report(now: Optional[float] = None) -> dict:
    """Evaluate-and-report: the ``slo`` section ServingEngine.stats()
    and JobResult.metrics() embed ({} when disabled)."""
    return get_slo_engine().evaluate(now=now)


# -- fleet evaluation ---------------------------------------------------------
# The fleet plane merges N processes' telemetry into one surface
# (counters summed, histogram buckets added element-wise); these
# functions evaluate the SAME objectives over that merged surface.
# Two deliberate differences from the per-process engine:
#
# - LIFETIME ratios, not windowed burn rates: the fleet aggregator has
#   no cross-process sample ring, so a ratio objective judges the
#   merged lifetime num/den against the error budget directly.
# - quantiles come ONLY from the merged cumulative buckets
#   (registry.quantile_from_buckets over the element-wise sum) — never
#   from combining per-host percentiles.  _hist_summary's
#   max-of-quantiles is the conservative SINGLE-PROCESS read; across a
#   fleet it would overstate every host but the worst, and averaging
#   would be meaningless.

_FLEET_QFRAC = {"p50": 0.50, "p95": 0.95, "p99": 0.99}


def _fleet_counter_sum(counters: dict, name: str,
                       only: Optional[Tuple[str, str]] = None) -> float:
    total = 0.0
    for s in counters.get(name, ()):
        if only is not None and s["labels"].get(only[0]) != only[1]:
            continue
        total += float(s["value"])
    return total


def _fleet_label_values(counters: dict, name: str, label: str):
    vals = set()
    for s in counters.get(name, ()):
        v = s["labels"].get(label)
        if v is not None:
            vals.add(v)
    return vals


def _fleet_quantile(hists: dict, name: str, q: str,
                    only: Optional[Tuple[str, str]] = None
                    ) -> Tuple[Optional[float], float]:
    """(quantile, count) of the merged bucket vectors across the
    name's matching label series — sums the cumulative vectors first,
    takes the quantile of the SUM."""
    merged: Optional[list] = None
    count = 0.0
    for s in hists.get(name, ()):
        if only is not None and s["labels"].get(only[0]) != only[1]:
            continue
        cum = s.get("buckets")
        if not cum:
            continue
        count += float(s.get("count", 0))
        merged = (list(cum) if merged is None
                  else [a + b for a, b in zip(merged, cum)])
    if merged is None:
        return None, count
    return registry.quantile_from_buckets(
        merged, _FLEET_QFRAC.get(q, 0.99)), count


def _eval_fleet_one(o: Objective, counters: dict, hists: dict,
                    only: Optional[Tuple[str, str]] = None) -> dict:
    if o.kind == "ratio":
        num = _fleet_counter_sum(counters, o.num, only)
        den = _fleet_counter_sum(counters, o.den, only)
        ratio = (num / den) if den > 0 else None
        budget = 1.0 - o.target
        breached = bool(ratio is not None and budget > 0
                        and ratio > budget)
        return {"kind": "ratio", "source": "fleet_lifetime",
                "num": num, "den": den,
                "value": None if ratio is None else round(ratio, 6),
                "budget": round(budget, 6), "breached": breached}
    value, count = _fleet_quantile(hists, o.hist, o.quantile, only)
    threshold = o.effective_burn_threshold
    breached = bool(value is not None and o.threshold
                    and value / o.threshold >= threshold)
    return {"kind": "quantile", "source": "merged_buckets",
            "hist": o.hist, "quantile": o.quantile,
            "threshold_s": o.threshold,
            "value": None if value is None else round(value, 9),
            "samples": count, "breached": breached}


def evaluate_fleet(counters: dict, hists: dict,
                   objectives: Optional[Sequence[Objective]] = None
                   ) -> dict:
    """Stateless fleet SLO evaluation over the merged report's
    ``counters``/``histograms`` sections (the JAX package's
    ``obs.fleet.merge`` shape).
    Grouped objectives expand per label value, ``name:value`` keys like
    the per-process engine."""
    objs = load_objectives() if objectives is None else tuple(objectives)
    out: dict = {"source": "fleet", "objectives": {}}
    for o in objs:
        if o.group_by is None:
            out["objectives"][o.name] = _eval_fleet_one(
                o, counters, hists)
            continue
        surface = o.den if o.kind == "ratio" else None
        values = (_fleet_label_values(counters, surface, o.group_by)
                  if surface is not None else
                  {s["labels"].get(o.group_by)
                   for s in hists.get(o.hist, ())
                   if s["labels"].get(o.group_by) is not None})
        for v in sorted(values):
            out["objectives"][f"{o.name}:{v}"] = _eval_fleet_one(
                o, counters, hists, only=(o.group_by, v))
    out["breached"] = sorted(
        k for k, e in out["objectives"].items() if e["breached"])
    return out


class FleetSLOEngine:
    """Edge-triggered breach bookkeeping over successive fleet
    evaluations (the /fleetz poll loop): :meth:`observe` takes one
    ``evaluate_fleet`` report and returns the [(key, detail)] list of
    healthy->breached transitions — exactly one firing per edge, like
    the per-process engine (the JAX package's ``obs.fleet.observe``
    turns each into a ``fleet.alert`` event and a fleet bundle)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breached: Dict[str, bool] = {}

    def observe(self, fleet_slo: dict) -> list:
        fired = []
        with self._lock:
            for key in sorted(fleet_slo.get("objectives", {})):
                entry = fleet_slo["objectives"][key]
                was = self._breached.get(key, False)
                is_now = bool(entry["breached"])
                entry["state"] = "breached" if is_now else "healthy"
                if is_now == was:
                    continue
                self._breached[key] = is_now
                if is_now:
                    fired.append((key, entry))
        return fired

    def active_breaches(self):
        with self._lock:
            return sorted(n for n, b in self._breached.items() if b)
