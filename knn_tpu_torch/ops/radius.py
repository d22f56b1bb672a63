"""Fixed-radius neighbor search — the port of knn_tpu/ops/radius.py.

Bounded-width results, as in the JAX package:

- the result rows are the lexicographic nearest-``max_neighbors`` prefix
  (ops.topk semantics — ties to the lower index), masked to the radius:
  entries beyond it carry ``+inf`` distance and index ``SENTINEL_IDX``;
- a second tiled pass (:func:`count_within`) counts ALL rows inside the
  radius with the same f32 distance arithmetic as the selection, so
  truncation (``counts > max_neighbors``) is always visible.

Radius units follow each metric's ranking space: the l2 family takes a
Euclidean radius (thresholded against squared distances), l1 a
Manhattan radius, cosine a cosine-distance radius; ``dot`` has no radius
semantics and is refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.ops.distance import pairwise_distance
from knn_tpu_torch.ops.topk import knn_search_tiled

#: masked index value for beyond-radius slots (sklearn-style -1; the
#: int32-max sentinel of ops.topk marks *padding*, a different thing)
SENTINEL_IDX = -1


def _dispatch_metric(metric: str) -> str:
    """Canonical dispatch name for a radius-API metric: ``'cityblock'``
    (accepted by :func:`radius_threshold`) becomes ``'l1'`` before any
    dispatch, so validation and execution agree on the vocabulary."""
    m = metric.lower()
    return "l1" if m == "cityblock" else m


def radius_threshold(radius: float, metric: str) -> float:
    """The ranking-space threshold for a user-units ``radius``."""
    m = metric.lower()
    if m in ("l2", "sql2", "euclidean"):
        if radius < 0:
            raise ValueError(f"radius must be >= 0, got {radius}")
        return float(radius) ** 2  # ranking space is squared L2
    if m in ("l1", "manhattan", "cityblock", "cosine"):
        if radius < 0:
            raise ValueError(f"radius must be >= 0, got {radius}")
        return float(radius)
    raise ValueError(
        f"radius semantics undefined for metric {metric!r} "
        "(dot similarities are unbounded)"
    )


def count_within(db: torch.Tensor, queries: torch.Tensor, threshold,
                 metric: str = "l2", *, tile: int = 131072,
                 compute_dtype=None) -> torch.Tensor:
    """Per query, how many db rows lie at ranking-space distance
    ``<= threshold`` (scalar or [Q], already in ranking space) — [Q]
    int32, one tiled pass with the selection's distance arithmetic.
    Separate from ops.certified.count_below, whose strict ``<`` and
    expanded square are pinned by the certificate's error model."""
    metric = _dispatch_metric(metric)
    n = db.shape[0]
    tile = max(1, min(tile, n))
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=queries.device)
    thr_col = thr[:, None] if thr.ndim else thr
    acc = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    for lo in range(0, n, tile):
        d = pairwise_distance(queries, db[lo : lo + tile], metric,
                              compute_dtype=compute_dtype)
        acc += (d <= thr_col).sum(-1, dtype=torch.int32)
    return acc


def check_truncation(counts, max_neighbors: int, action_hint: str) -> None:
    """Raise when any query's in-radius set exceeds ``max_neighbors`` —
    the strict-mode truncation contract of the radius estimators and the
    graph exports."""
    counts = np.asarray(counts)
    over = counts > max_neighbors
    if over.any():
        raise ValueError(
            f"{int(over.sum())} queries have more than "
            f"max_neighbors={max_neighbors} in-radius neighbors "
            f"(max {int(counts.max())}); raise max_neighbors, shrink the "
            f"radius, or pass strict=False to {action_hint}"
        )


def radius_search(queries: torch.Tensor, db: torch.Tensor, radius: float, *,
                  max_neighbors: int, metric: str = "l2",
                  train_tile: Optional[int] = None, compute_dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All neighbors within ``radius``, up to ``max_neighbors`` per query.

    Returns ``(dists [Q, M], idx [Q, M], counts [Q])`` with ``M =
    min(max_neighbors, n_db)``: the nearest-M prefix masked to the radius
    (beyond-radius slots ``+inf`` / ``SENTINEL_IDX``) and the exact
    within-radius count per query (``counts > M``: truncated).  Distances
    are in ranking space (squared for the l2 family)."""
    thr = radius_threshold(radius, metric)  # eager validation (aliases ok)
    metric = _dispatch_metric(metric)  # execution vocabulary
    m = min(int(max_neighbors), db.shape[0])
    if m < 1:
        raise ValueError(f"max_neighbors must be >= 1, got {max_neighbors}")
    d, i = knn_search_tiled(queries, db, m, metric, train_tile=train_tile,
                            compute_dtype=compute_dtype)
    counts = count_within(db, queries, thr, metric,
                          tile=min(train_tile or 131072, db.shape[0]),
                          compute_dtype=compute_dtype)
    within = d <= thr
    return (torch.where(within, d, torch.inf),
            torch.where(within, i, SENTINEL_IDX), counts)
