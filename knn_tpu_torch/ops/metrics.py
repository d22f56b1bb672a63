"""Metric name registry — a copy of knn_tpu/ops/metrics.py, dependency-free
so the CLI and config layers can validate flags without importing torch.

The distance implementations live in knn_tpu_torch.ops.distance, which
ports the l2 family and cosine (``PORTED_METRICS``); the other names are
known but not ported yet and are refused there.
"""

#: Names the JAX package's pairwise_distance accepts.
METRICS = ("l2", "sql2", "euclidean", "l1", "manhattan", "cosine", "dot")

#: The names the port computes (l2 family + cosine).
L2_FAMILY = ("l2", "sql2", "euclidean")
PORTED_METRICS = L2_FAMILY + ("cosine",)
