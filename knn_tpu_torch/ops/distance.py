"""Pairwise distance ops in PyTorch — the port of knn_tpu/ops/distance.py
(``pairwise_distance``, ``metric_values``) for the l2 family and cosine.

- L2 uses the expanded square ``||q||^2 + ||t||^2 - 2 q.t^T``: the
  O(Q*T*D) work is one f32 matmul (``torch.matmul``; the JAX package
  leaves it to XLA at HIGHEST precision, and the port runs with TF32 off,
  knn_tpu_torch.device).  The reference's monotone ``sqrt``
  (knn_mpi.cpp:48) is dropped, so ranking is unchanged.
- cosine distance is ``1 - q^.t^`` on rows normalized in f32.

L1 and dot are not ported yet and are refused by name.
"""

from __future__ import annotations

import numpy as np
import torch

from knn_tpu_torch.ops.metrics import L2_FAMILY, PORTED_METRICS


def pairwise_sq_l2(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix [Q, T] in f32, clamped at 0 to hide the
    small negative values the expanded square can produce."""
    q32 = queries.float()
    t32 = train.float()
    q_norm = (q32 * q32).sum(-1, keepdim=True)
    t_norm = (t32 * t32).sum(-1)[None, :]
    d = q_norm + t_norm - 2.0 * (q32 @ t32.T)
    return torch.clamp_min(d, 0.0)


def _row_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.sqrt((x32 * x32).sum(-1, keepdim=True))
    return x32 / torch.clamp_min(n, eps)


def pairwise_cosine(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """Cosine distance 1 - cos(q, t) in [0, 2]."""
    return 1.0 - _row_normalize(queries) @ _row_normalize(train).T


def pairwise_distance(queries: torch.Tensor, train: torch.Tensor,
                      metric: str = "l2") -> torch.Tensor:
    """Dispatch over the ported metric names."""
    m = metric.lower()
    if m in L2_FAMILY:
        return pairwise_sq_l2(queries, train)
    if m == "cosine":
        return pairwise_cosine(queries, train)
    raise ValueError(
        f"metric {metric!r} is not ported; expected one of {PORTED_METRICS}")


def metric_values(d, metric: str = "l2"):
    """Ranking scores -> reference/sklearn metric VALUES: the l2 family
    gets ``sqrt(max(d, 0))``, every other metric's scores already are its
    values.  Works on numpy arrays and torch tensors alike."""
    if metric.lower() in L2_FAMILY:
        if isinstance(d, torch.Tensor):
            return torch.sqrt(torch.clamp_min(d, 0))
        return np.sqrt(np.maximum(d, 0))
    return d
