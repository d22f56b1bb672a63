"""Metric name registry — a copy of knn_tpu/ops/metrics.py, dependency-free
so the CLI and config layers can validate flags without importing torch.

The distance implementations live in knn_tpu_torch.ops.distance, which
computes every name here.
"""

#: Names the JAX package's pairwise_distance accepts.
METRICS = ("l2", "sql2", "euclidean", "l1", "manhattan", "cosine", "dot")

#: The squared-L2 and L1 aliases.
L2_FAMILY = ("l2", "sql2", "euclidean")
L1_FAMILY = ("l1", "manhattan")


def canonical_metric(metric: str) -> str:
    """The one name a placement keeps for ``metric``: ``"l2"`` for the l2
    family, ``"l1"`` for l1/manhattan, the lowercase name otherwise.
    Raises for a name outside :data:`METRICS`."""
    m = metric.lower()
    if m not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if m in L2_FAMILY:
        return "l2"
    return "l1" if m in L1_FAMILY else m
