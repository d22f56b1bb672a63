"""Process-wide, thread-safe metrics registry — the port of
knn_tpu/obs/registry.py.

Three instrument kinds:

- :class:`Counter` — monotone float (float so second-counters fit),
- :class:`Gauge` — settable level,
- :class:`Histogram` — lifetime count/sum/min/max, cumulative counts over
  the fixed :data:`BUCKET_BOUNDS`, trace-id exemplars of the worst recent
  samples, and a BOUNDED sample window feeding p50/p95/p99.

Every name must come from the catalog (knn_tpu_torch.obs.names.CATALOG)
with matching label names.  Each instrument and the registry hold their
own lock, which is what keeps the counts exact when the serving
dispatcher, completer, compactor and capture threads write at once.

Disabled mode (``reset(enabled=False)``): :func:`get_registry` returns a
no-op registry whose ``counter``/``gauge``/``histogram`` hand back ONE
shared do-nothing instrument, so instrumented paths cost a method call
and results stay bitwise the same either way.

Where the port differs: the JAX package reads its on/off switch and the
exemplar retention knobs from the environment; here they are arguments
of :func:`reset` (``enabled``, ``exemplar_cap``, ``exemplar_age_s``) with
the JAX package's defaults (on, 8 exemplars, 600 s).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from knn_tpu_torch.obs.names import CATALOG

#: the shape every registrable metric name must have
NAME_RE = re.compile(r"^knn_tpu_[a-z0-9_]+$")

#: bounded histogram window (samples per labeled series)
DEFAULT_WINDOW = 4096

#: fixed log-spaced histogram bucket upper bounds, 4 per decade over
#: 1e-6..1e4; the same bounds in every process (and in the JAX package),
#: so cumulative counts add across processes.  An observation past the
#: last bound lands in the implicit +Inf overflow slot.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    round(10.0 ** (-6 + i / 4.0), 10) for i in range(41))

#: default worst-recent exemplars retained per histogram series
EXEMPLAR_CAP = 8

#: default age (seconds) after which an exemplar leaves the store
EXEMPLAR_MAX_AGE_S = 600.0

_exemplar_cap = EXEMPLAR_CAP
_exemplar_age_s = EXEMPLAR_MAX_AGE_S


class Counter:
    """Monotone counter; ``inc`` only (negative increments refused).
    Thread-safety: guarded by ``self._lock``."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._v += amount

    def get(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Settable level; ``set``/``inc``/``dec``.
    Thread-safety: guarded by ``self._lock``."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v -= amount

    def get(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Lifetime count/sum/min/max + a bounded recent-sample window the
    percentiles are computed over (see module docstring).

    Thread-safety: guarded by ``self._lock`` .

    ``observe(value, exemplar=trace_id)`` additionally retains the
    trace ids of the WORST recent samples (at most :data:`EXEMPLAR_CAP`,
    aged out after :data:`EXEMPLAR_MAX_AGE_S`) — the histogram->trace
    join the Prometheus exporter emits as OpenMetrics-style exemplars.  Call sites without a trace id pay
    one ``is None`` check and nothing else."""

    __slots__ = ("_lock", "_count", "_sum", "_min", "_max", "_window",
                 "_wts", "_ex", "_bkt")

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        #: per-bucket observation counts over BUCKET_BOUNDS (last slot
        #: is the +Inf overflow); cumulated at export time so snapshots
        #: carry Prometheus-style ``le`` semantics while observe() pays
        #: one bisect + one increment
        self._bkt = [0] * (len(BUCKET_BOUNDS) + 1)
        self._window: deque = deque(maxlen=int(window))
        #: arrival timestamps parallel to _window, so the summary can
        #: say WHICH wall span its percentiles cover — a window
        #: quantile without its span is ambiguous between "the last
        #: second" and "since boot" (the window-vs-lifetime fix)
        self._wts: deque = deque(maxlen=int(window))
        #: worst recent exemplars, value-descending:
        #: (value, trace_id, wall ts, monotonic ts)
        self._ex: list = []

    def _note_exemplar(self, v: float, trace_id: str, mono: float) -> None:
        """Retain ``trace_id`` when ``v`` ranks among the worst recent
        samples.  Caller holds ``self._lock``."""
        cutoff = mono - _exemplar_age_s
        ex = [e for e in self._ex if e[3] >= cutoff]
        if len(ex) < _exemplar_cap or (ex and v > ex[-1][0]):
            ex.append((v, str(trace_id), time.time(), mono))
            ex.sort(key=lambda e: -e[0])
            del ex[_exemplar_cap:]
        self._ex = ex

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        v = float(value)
        t = time.monotonic()
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            self._bkt[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
            self._window.append(v)
            self._wts.append(t)
            if exemplar is not None:
                self._note_exemplar(v, exemplar, t)

    def exemplars(self) -> list:
        """Worst recent exemplars, value-descending:
        ``[{"value", "trace_id", "ts"}, ...]`` (``ts`` is wall time).
        Ages out on READ as well as on write — a series whose traffic
        stopped must not pin yesterday's spike forever."""
        cutoff = time.monotonic() - _exemplar_age_s
        with self._lock:
            if any(e[3] < cutoff for e in self._ex):
                self._ex = [e for e in self._ex if e[3] >= cutoff]
            ex = list(self._ex)
        return [{"value": v, "trace_id": tid, "ts": round(ts, 3)}
                for v, tid, ts, _ in ex]

    def observe_many(self, values) -> None:
        """Bulk observe (one lock acquisition) — the int8 quant-bound
        path records a whole query batch's epsilons at once."""
        vs = [float(v) for v in values]
        if not vs:
            return
        lo, hi = min(vs), max(vs)
        t = time.monotonic()
        with self._lock:
            self._count += len(vs)
            self._sum += sum(vs)
            if self._min is None or lo < self._min:
                self._min = lo
            if self._max is None or hi > self._max:
                self._max = hi
            for v in vs:
                self._bkt[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
            self._window.extend(vs)
            self._wts.extend([t] * len(vs))

    def get(self) -> Dict[str, float]:
        return self.summary()

    def summary(self) -> Dict[str, float]:
        """Lifetime count/sum/min/max + window p50/p95/p99/mean.  The
        window percentiles carry their provenance — ``window`` (sample
        count) and ``window_span_s`` (wall span from oldest to newest
        windowed sample) — so every consumer can label which window a
        quantile came from instead of conflating it with lifetime."""
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            bkt = list(self._bkt)
            window = list(self._window)
            wts = list(self._wts)
        out: Dict[str, float] = {"count": count, "sum": total}
        if mn is not None:
            out["min"], out["max"] = mn, mx
        if count:
            # cumulative counts over BUCKET_BOUNDS (+Inf last) — the
            # mergeable form: identical fixed bounds in every process,
            # so fleet aggregation adds these element-wise and derives
            # quantiles from the MERGED distribution (never by
            # averaging per-host percentiles)
            cum, running = [], 0
            for c in bkt:
                running += c
                cum.append(running)
            out["buckets"] = cum
        ex = self.exemplars()
        if ex:
            # only exemplar-fed series grow the key: summaries of
            # histograms nobody passes trace ids to are unchanged
            out["exemplars"] = ex
        if window:
            # numpy only when there are samples: keeps the empty-series
            # snapshot path import-light
            import numpy as np

            arr = np.asarray(window, dtype=np.float64)
            out.update({
                "p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "mean": float(arr.mean()),
                "window": int(arr.size),
                "window_span_s": round(wts[-1] - wts[0], 3) if wts else 0.0,
            })
        return out


class _Noop:
    """The shared disabled-mode instrument: every method of every kind,
    doing nothing.  ONE instance (``NOOP``) serves all call sites — the
    no-op identity the tests pin."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def exemplars(self) -> list:
        return []

    def get(self):
        return 0.0

    def summary(self) -> dict:
        return {"count": 0, "sum": 0.0}


NOOP = _Noop()


def quantile_from_buckets(cum, q: float) -> Optional[float]:
    """The ``q``-quantile (0..1) of a cumulative bucket vector over
    :data:`BUCKET_BOUNDS` — the bucket's UPPER bound, i.e. a sound
    upper estimate quantized to the bucket grid.  This is the only
    valid way to state a fleet quantile: per-host percentiles do not
    average, but cumulative counts over identical bounds add, and the
    quantile of the sum is exact to bucket resolution.  Returns None
    for an empty vector; an overflow-bucket hit returns the last
    finite bound (the estimate saturates, it never invents +Inf)."""
    if not cum:
        return None
    total = cum[-1]
    if total <= 0:
        return None
    target = q * total
    for i, c in enumerate(cum):
        if c >= target and c > 0:
            return BUCKET_BOUNDS[min(i, len(BUCKET_BOUNDS) - 1)]
    return BUCKET_BOUNDS[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Catalog-validated instrument store, keyed (name, label items).
    Thread-safety: guarded by ``self._lock``."""

    def __init__(self, *, window: int = DEFAULT_WINDOW):
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._window = int(window)

    # -- registration ------------------------------------------------------
    def _get(self, kind: str, name: str, labels: Dict[str, object]):
        spec = CATALOG.get(name)
        if spec is None or not NAME_RE.match(name):
            raise ValueError(
                f"metric {name!r} is not in the catalog "
                f"(knn_tpu_torch.obs.names.CATALOG) — declare it there, with "
                f"docs, before instrumenting")
        want_kind, want_labels, _help = spec
        if want_kind != kind:
            raise ValueError(
                f"metric {name!r} is a {want_kind}, not a {kind}")
        if tuple(sorted(labels)) != tuple(sorted(want_labels)):
            raise ValueError(
                f"metric {name!r} takes labels {sorted(want_labels)}, "
                f"got {sorted(labels)}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = (_KINDS[kind](window=self._window)
                        if kind == "histogram" else _KINDS[kind]())
                self._series[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # -- inspection --------------------------------------------------------
    def snapshot(self) -> dict:
        """Every registered series, catalog metadata included — the ONE
        structure both exporters (Prometheus text, JSON file) render."""
        with self._lock:
            keys = list(self._series.items())
        out: dict = {}
        for (name, label_items), inst in keys:
            kind, _labels, help_ = CATALOG[name]
            m = out.setdefault(
                name, {"type": kind, "help": help_, "series": []})
            value = inst.summary() if kind == "histogram" else inst.get()
            m["series"].append({"labels": dict(label_items), "value": value})
        for m in out.values():  # deterministic export order
            m["series"].sort(key=lambda s: sorted(s["labels"].items()))
        return out


class _NoopRegistry(MetricsRegistry):
    """Disabled mode: every instrument request returns the ONE shared
    no-op after the same catalog validation (so a bad name fails fast in
    dev whether or not obs is on)."""

    def _get(self, kind, name, labels):
        spec = CATALOG.get(name)
        if (spec is not None and spec[0] == kind
                and tuple(sorted(labels)) == tuple(sorted(spec[1]))):
            return NOOP
        # invalid request: delegate for the precise error message (the
        # parent raises before it would ever allocate an instrument)
        return super()._get(kind, name, labels)

    def snapshot(self) -> dict:
        return {}


_state_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None


def enabled() -> bool:
    """Whether the subsystem is live (on until :func:`reset` turns it
    off)."""
    return not isinstance(get_registry(), _NoopRegistry)


def get_registry() -> MetricsRegistry:
    global _registry
    reg = _registry
    if reg is None:
        with _state_lock:
            if _registry is None:
                _registry = MetricsRegistry()
            reg = _registry
    return reg


def reset(enabled: bool = True, *, exemplar_cap: int = EXEMPLAR_CAP,
          exemplar_age_s: float = EXEMPLAR_MAX_AGE_S) -> MetricsRegistry:
    """Swap in a fresh registry (clears every series): live when
    ``enabled``, else the no-op registry; ``exemplar_cap`` (>= 0) and
    ``exemplar_age_s`` (> 0) set the exemplar retention.  Instruments
    handed out by the old registry keep working but are no longer
    exported — re-fetch handles after a reset."""
    global _registry, _exemplar_cap, _exemplar_age_s
    cap, age = int(exemplar_cap), float(exemplar_age_s)
    if cap < 0:
        raise ValueError(f"exemplar_cap must be >= 0, got {exemplar_cap}")
    if age <= 0:
        raise ValueError(
            f"exemplar_age_s must be > 0, got {exemplar_age_s}")
    with _state_lock:
        _exemplar_cap, _exemplar_age_s = cap, age
        _registry = MetricsRegistry() if enabled else _NoopRegistry()
        return _registry


# -- convenience pass-throughs (the instrumented modules' whole API) -----
def counter(name: str, **labels) -> Counter:
    return get_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return get_registry().gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return get_registry().histogram(name, **labels)


def snapshot() -> dict:
    return get_registry().snapshot()
