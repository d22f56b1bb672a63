"""knn_tpu_torch.obs — the port's telemetry core, the counterpart of
knn_tpu/obs/ (its registry, spans, exporters, profiler, roofline and
health modules).

One registry, one event log, two exporters; the ported layers (serving,
the queue and its admission, certified search, the index tiers, the join,
the tuner, pipeline phases) write through here:

- **Metrics registry** (:mod:`~knn_tpu_torch.obs.registry`): thread-safe
  counters / gauges / bounded histograms, validated against the catalog
  (:mod:`~knn_tpu_torch.obs.names`, the JAX package's name for name).
  ``reset(enabled=False)`` hands out one shared no-op instrument; results
  are bitwise the same either way.
- **Spans and events** (:mod:`~knn_tpu_torch.obs.trace`): trace ids
  minted at submit and kept through micro-batching, a bounded event ring
  and an optional rotated JSONL sink (``reset_event_log(path=...)``).
- **Exporters** (:mod:`~knn_tpu_torch.obs.export`): Prometheus text, the
  atomic JSON snapshot, ``/metrics``, ``/metrics.json``, ``/healthz`` and
  ``/statusz`` (``start_metrics_server``; the job's ``--metrics-port``),
  read back by ``python -m knn_tpu_torch.cli metrics`` / ``doctor``.
- **Roofline** (:mod:`~knn_tpu_torch.obs.roofline`): the H100's peaks and
  the least time of each configuration's work, term by term.
- **Device trace** (:mod:`~knn_tpu_torch.obs.profiler`): torch.profiler
  capture and its host/device breakdown.
- **Health** (:mod:`~knn_tpu_torch.obs.health`): readiness and the
  self-diagnosis report.

No module here imports ``torch`` at import time (health and the profiler
import it inside the functions that need it) and none imports ``jax`` or
``knn_tpu``.  The JAX package's ``slo``, ``waterfall``, ``audit``,
``blackbox``, ``drift``, ``sentinel``, ``calibrate``, ``traceread`` and
``fleet`` wait for the second obs slice (ROADMAP queue A item 7), and its
XLA compile hook has no counterpart (a CUDA graph capture counts under
``SERVING_COMPILES``).
"""

from knn_tpu_torch.obs import (  # noqa: F401
    health,
    ident,
    names,
    profiler,
    roofline,
)
from knn_tpu_torch.obs.export import (  # noqa: F401
    compact_snapshot,
    prometheus_text,
    start_metrics_server,
    write_json_snapshot,
)
from knn_tpu_torch.obs.registry import (  # noqa: F401
    NOOP,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    enabled,
    gauge,
    get_registry,
    histogram,
    reset,
    snapshot,
)
from knn_tpu_torch.obs.trace import (  # noqa: F401
    EventLog,
    emit_event,
    get_event_log,
    new_trace_id,
    record_span,
    reset_event_log,
    span,
)

__all__ = [
    "NOOP", "Counter", "EventLog", "Gauge", "Histogram",
    "MetricsRegistry", "compact_snapshot", "counter", "emit_event",
    "enabled", "gauge", "get_event_log", "get_registry", "health",
    "histogram", "ident", "names", "new_trace_id", "profiler",
    "prometheus_text", "record_span", "reset", "reset_event_log",
    "roofline", "snapshot", "span", "start_metrics_server",
    "write_json_snapshot",
]
