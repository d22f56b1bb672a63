"""knn_tpu_torch.serving — the query-traffic subsystem on one GPU (the port
of knn_tpu/serving).

``ShardedKNN.search`` runs one request at a time at whatever shape it
gets.  This package turns it into a throughput engine:

- :mod:`~knn_tpu_torch.serving.buckets` — the geometric bucket ladder
  that bounds the executable cache at O(log(max/min)) entries;
- :mod:`~knn_tpu_torch.serving.engine` — :class:`ServingEngine`: one
  executable per ladder rung (on the card a CUDA graph of the exact
  search / predict program) with ``warmup()``, dispatch-ahead handles,
  trace replay, and capture / dispatch / latency accounting;
- :mod:`~knn_tpu_torch.serving.queue` — :class:`QueryQueue`: dynamic
  micro-batching of concurrent small requests under a max-wait deadline,
  with writes routed to a mutable index;
- :mod:`~knn_tpu_torch.serving.admission` — admission control, off by
  default: bounded depth, deadline-aware shedding, per-tenant token-bucket
  quotas and starvation-safe aged priorities.

Padding is arithmetic-transparent: bucketed results are bitwise a direct
``ShardedKNN.search`` of the same padded batch.

Entry points: ``ShardedKNN.search_bucketed()`` for the one-liner,
``ServingEngine`` + ``QueryQueue`` for a long-running service, the index
tiers' ``serving_engine()``, ``--serve-buckets`` on the job's command line
and ``python -m knn_tpu_torch.cli loadgen``.
"""

from knn_tpu_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionError,
    DeadlineError,
    QueueFullError,
    QuotaExceededError,
)
from knn_tpu_torch.serving.buckets import (
    DEFAULT_MAX_BUCKET,
    DEFAULT_MIN_BUCKET,
    bucket_for,
    bucket_ladder,
    parse_buckets,
    split_sizes,
)
from knn_tpu_torch.serving.engine import ServingEngine, latency_summary
from knn_tpu_torch.serving.queue import QueryQueue

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionError",
    "DeadlineError",
    "QueueFullError",
    "QuotaExceededError",
    "DEFAULT_MAX_BUCKET",
    "DEFAULT_MIN_BUCKET",
    "bucket_for",
    "bucket_ladder",
    "parse_buckets",
    "split_sizes",
    "ServingEngine",
    "latency_summary",
    "QueryQueue",
]
