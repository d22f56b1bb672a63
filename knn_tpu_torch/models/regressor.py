"""KNN regressor — the port of knn_tpu/models/regressor.py (``knn_regress``,
``_weighted_targets``, ``KNNRegressor``): the mean or inverse-distance
weighted target over the k nearest neighbors."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.metrics import L2_FAMILY
from knn_tpu_torch.ops.topk import knn_search_tiled

#: the inverse-distance weighting's floor, shared with
#: models.radius.RadiusNeighborsRegressor: exact duplicates do not divide
#: by zero
DIST_FLOOR = 1e-12


def _weighted_targets(dists: torch.Tensor, targets: torch.Tensor,
                      weights: str, metric: str = "l2",
                      queries: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q, k] (or [Q, k, out]) neighbor targets -> predictions:
    ``"uniform"`` the mean, ``"distance"`` 1/d weights (the l2 family's
    squared values take their sqrt first).  Given ``queries`` (l2
    family), squared distances within the expanded square's cancellation
    band ``64 eps ||q||^2`` count as 0, so exact duplicates dominate
    whatever the matmul's rounding (the sklearn zero-distance rule)."""
    targets = targets.float()
    if weights == "uniform":
        return targets.mean(dim=1)
    if weights == "distance":
        dists = dists.float()
        if metric.lower() in L2_FAMILY:
            if queries is not None:
                q32 = queries.float()
                q_norm = (q32 * q32).sum(-1, keepdim=True)
                band = 64.0 * float(np.finfo(np.float32).eps) * q_norm
                dists = torch.where(dists <= band, 0.0, dists)
            dists = torch.sqrt(torch.clamp_min(dists, 0.0))
        w = 1.0 / torch.clamp_min(dists, DIST_FLOOR)
        w = w / w.sum(dim=1, keepdim=True)
        if targets.ndim == 3:
            w = w[..., None]
        return (w * targets).sum(dim=1)
    raise ValueError(f"unknown weights {weights!r}")


def knn_regress(train: torch.Tensor, train_targets: torch.Tensor,
                queries: torch.Tensor, *, k: int, metric: str = "l2",
                weights: str = "uniform", train_tile: Optional[int] = None,
                compute_dtype=None) -> torch.Tensor:
    """Functional core: predictions [Q] (or [Q, out]) for one query batch
    on the tensors' device."""
    dists, idx = knn_search_tiled(queries, train, k, metric,
                                  train_tile=train_tile,
                                  compute_dtype=compute_dtype)
    return _weighted_targets(dists, train_targets[idx], weights, metric,
                             queries=queries)


class KNNRegressor:
    """fit/predict regressor: ``fit`` places the database once
    (parallel.ShardedKNN) and ``predict`` runs its search and the
    weighting; ``device`` None = cuda (raises without a GPU); ``mesh``
    places the database over a mesh once (the device is its first),
    ``merge`` its db-axis merge strategy."""

    def __init__(self, k: int = 5, metric: str = "l2",
                 weights: str = "uniform", train_tile: Optional[int] = None,
                 compute_dtype=None, device: DeviceLike = None, mesh=None,
                 merge: Optional[str] = "allgather"):
        if weights not in ("uniform", "distance"):
            raise ValueError(f"unknown weights {weights!r}")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self.mesh = mesh
        self.merge = merge
        self.k = k
        self.metric = metric
        self.weights = weights
        self.train_tile = train_tile
        self.compute_dtype = compute_dtype
        self._targets = None
        self._program = None

    def fit(self, X, y) -> "KNNRegressor":
        from knn_tpu_torch.parallel.sharded import ShardedKNN

        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if X.shape[0] != y.shape[0]:
            raise ValueError(f"bad shapes: X {X.shape}, y {y.shape}")
        if self.k > X.shape[0]:
            raise ValueError(f"k={self.k} > n_train={X.shape[0]}")
        placement = (dict(mesh=self.mesh, merge=self.merge)
                     if self.mesh is not None else dict(device=self.device))
        self._program = ShardedKNN(
            X, k=self.k, metric=self.metric, train_tile=self.train_tile,
            compute_dtype=self.compute_dtype, **placement)
        self._targets = torch.from_numpy(y).to(self.device)
        return self

    def predict(self, Q) -> np.ndarray:
        if self._program is None:
            raise RuntimeError("call fit() first")
        q = torch.as_tensor(np.asarray(Q, np.float32)).to(self.device)
        dists, idx = self._program.search(q)
        return _weighted_targets(dists, self._targets[idx], self.weights,
                                 self.metric, queries=q).cpu().numpy()
