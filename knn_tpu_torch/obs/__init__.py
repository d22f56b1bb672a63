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
- **SLO engine** (:mod:`~knn_tpu_torch.obs.slo`): multi-window burn rates
  over the registry, edge-triggered alerts, per tenant where asked
  (``reset_slo_engine(objectives=, windows=)``, ``load_objectives(path)``).
- **Shadow audit sampler** (:mod:`~knn_tpu_torch.obs.audit`): a
  trace-id-hashed sample of served requests replayed against the float64
  oracle off the serving path (``audit.reset_auditor(rate=,
  budget_rows_s=)``).
- **Drift** (:mod:`~knn_tpu_torch.obs.drift`): query-norm and
  centroid-assignment PSI against the IVF index's training baseline, and
  the index-health gauges.
- **Waterfalls** (:mod:`~knn_tpu_torch.obs.waterfall`): per-request
  latency rebuilt from the spans, critical-path attribution, the slowest
  requests (``/waterfallz``, ``cli waterfall``).
- **Flight recorder** (:mod:`~knn_tpu_torch.obs.blackbox`): one atomic
  postmortem bundle per SLO breach
  (``blackbox.configure(postmortem_dir=, keep=)``; ``cli audit`` /
  ``cli waterfall --bundle``).
- **Measured ceilings** (:mod:`~knn_tpu_torch.obs.traceread`,
  :mod:`~knn_tpu_torch.obs.calibrate`): captured traces read back from
  disk, measured device time reconciled against the roofline's terms, and
  the per-term factors every roofline block consults
  (``calibrate.configure(store=)``; driven by ``knn_tpu_torch.campaign``,
  ``cli campaign``).
- **Fleet plane** (:mod:`~knn_tpu_torch.obs.fleet`): N processes'
  telemetry merged into one report — counters summed, gauges per host,
  quantiles from summed buckets, fleet SLO edges with member-embedding
  bundles (``fleet.configure(members=, stale_s=)``, ``/fleetz``, ``cli
  fleet``); ``ident.set_identity`` stamps each member.
- **Regression sentinel** (:mod:`~knn_tpu_torch.obs.sentinel`): robust
  median / MAD baselines over the bench history, keyed like for like
  (metric, backend, precision family), and the ``sentinel`` verdict a
  bench line carries (``knn_tpu_torch/scripts/perf_sentinel.py``).

No module here imports ``torch`` at import time (health and the profiler
import it inside the functions that need it) and none imports ``jax`` or
``knn_tpu``.  The JAX package's XLA compile hook has no counterpart (a
CUDA graph capture counts under ``SERVING_COMPILES``).
"""

from knn_tpu_torch.obs import (  # noqa: F401
    audit,
    blackbox,
    calibrate,
    drift,
    fleet,
    health,
    ident,
    names,
    profiler,
    roofline,
    slo,
    traceread,
    waterfall,
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
from knn_tpu_torch.obs.slo import (  # noqa: F401
    Objective,
    SLOEngine,
    get_slo_engine,
    load_objectives,
    reset_slo_engine,
    slo_report,
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
    "MetricsRegistry", "Objective", "SLOEngine", "audit", "blackbox",
    "calibrate", "compact_snapshot", "counter", "drift", "emit_event",
    "enabled", "fleet", "gauge", "get_event_log", "get_registry", "get_slo_engine", "health",
    "histogram", "ident", "load_objectives", "names", "new_trace_id",
    "profiler", "prometheus_text", "record_span", "reset",
    "reset_event_log", "reset_slo_engine", "roofline", "slo",
    "slo_report", "snapshot", "span", "start_metrics_server", "traceread",
    "waterfall",
    "write_json_snapshot",
]
