"""knn_tpu_torch.loadgen — load generation, replay and knee measurement
for the serving stack (the port of knn_tpu/loadgen).

- :mod:`~knn_tpu_torch.loadgen.workload` — deterministic seeded arrival
  processes (Poisson, bursty on/off, JSONL trace replay) over a
  multi-tenant mix: the same spec gives the same schedule, draw for draw
  the JAX package's;
- :mod:`~knn_tpu_torch.loadgen.driver` — the open-loop driver: submitter
  threads (arrivals never gated by completions) driving a
  ``QueryQueue``-shaped target, every request recorded with an explicit
  outcome (ok / rejected:* / shed:* / error), writes and bulk reads in
  lanes of their own;
- :mod:`~knn_tpu_torch.loadgen.knee` — the stepped-rate sweep that locates
  the latency-vs-throughput knee;
- :mod:`~knn_tpu_torch.loadgen.synthetic` — a single-server target with a
  configured capacity, so the harness and the knee detector are testable
  without a device.

Entry point: ``python -m knn_tpu_torch.cli loadgen``.
"""

from knn_tpu_torch.loadgen.driver import (  # noqa: F401
    DEFAULT_LOG_CAP,
    ResultLog,
    report,
    run_workload,
)
from knn_tpu_torch.loadgen.knee import (  # noqa: F401
    closed_loop_anchor,
    knee_block,
    knee_sweep,
    rates_around,
    run_step,
    validate_knee_block,
)
from knn_tpu_torch.loadgen.synthetic import SyntheticTarget  # noqa: F401
from knn_tpu_torch.loadgen.workload import (  # noqa: F401
    ARRIVALS,
    Request,
    TenantSpec,
    WorkloadSpec,
    generate,
    load_trace,
    parse_tenants,
    save_trace,
)

__all__ = [
    "ARRIVALS",
    "DEFAULT_LOG_CAP",
    "Request",
    "ResultLog",
    "SyntheticTarget",
    "TenantSpec",
    "WorkloadSpec",
    "closed_loop_anchor",
    "generate",
    "knee_block",
    "knee_sweep",
    "load_trace",
    "parse_tenants",
    "rates_around",
    "report",
    "run_step",
    "run_workload",
    "save_trace",
    "validate_knee_block",
]
