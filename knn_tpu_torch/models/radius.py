"""Radius-neighbors estimators — the port of knn_tpu/models/radius.py
(``RadiusNeighborsClassifier``, ``RadiusNeighborsRegressor``): fixed-radius
voting and regression over ops.radius.radius_search.

The classifier's vote among in-radius neighbors is the reference's
first-to-reach-max rule (ops.vote): in-radius neighbors are the
ascending-distance prefix of the bounded result and masked slots carry
label -1, which the vote drops.  The regressor aggregates in-radius
targets (uniform mean or inverse-distance weights, the weighting of
KNNRegressor) in float64 on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.metrics import L2_FAMILY
from knn_tpu_torch.ops.normalize import minmax_apply, minmax_stats
from knn_tpu_torch.ops.radius import (SENTINEL_IDX, check_truncation,
                                      radius_search, radius_threshold)
from knn_tpu_torch.ops.vote import majority_vote


class _RadiusNeighborsBase:
    """Shared fit / query prep / bounded radius search / truncation guard
    of the radius estimators (see RadiusNeighborsClassifier)."""

    def __init__(self, radius: float, *, max_neighbors: int = 128,
                 metric: str = "l2", normalize: bool = False,
                 train_tile: Optional[int] = None, compute_dtype=None,
                 strict: bool = True, device: DeviceLike = None):
        radius_threshold(radius, metric)  # validate radius/metric pairing now
        self.device = resolve_device(device)
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.metric = metric
        self.normalize = normalize
        self.train_tile = train_tile
        self.compute_dtype = compute_dtype
        self.strict = strict
        self._train = None
        self._y = None
        self._mins = None
        self._maxs = None

    def _fit_targets(self, y: np.ndarray) -> np.ndarray:  # subclass
        raise NotImplementedError

    def fit(self, X, y):
        X = torch.as_tensor(np.asarray(X, np.float32)).to(self.device)
        y_raw = np.asarray(y)
        # shape compatibility before target processing: a failed fit
        # leaves no half-inferred state (e.g. num_classes) behind
        if X.ndim != 2 or X.shape[0] != y_raw.shape[0]:
            raise ValueError(f"bad shapes: X {tuple(X.shape)}, y {y_raw.shape}")
        y = self._fit_targets(y_raw)
        if self.normalize:
            self._mins, self._maxs = minmax_stats([X])
            X = minmax_apply(X, self._mins, self._maxs)
        self._train = X
        self._y = y
        return self

    def _require_fit(self):
        if self._train is None:
            raise RuntimeError("call fit() before predict()/radius_neighbors()")

    def _prep_queries(self, Q) -> torch.Tensor:
        Q = torch.as_tensor(np.asarray(Q, np.float32)).to(self.device)
        if Q.ndim != 2 or Q.shape[1] != self._train.shape[1]:
            raise ValueError(
                f"queries {tuple(Q.shape)} vs train {tuple(self._train.shape)}")
        if self.normalize:
            Q = minmax_apply(Q, self._mins, self._maxs)
        return Q

    def radius_neighbors(self, Q):
        """(dists [Q, M], idx [Q, M], counts [Q]) host arrays — see
        ops.radius."""
        self._require_fit()
        out = radius_search(
            self._prep_queries(Q), self._train, self.radius,
            max_neighbors=self.max_neighbors, metric=self.metric,
            train_tile=self.train_tile, compute_dtype=self.compute_dtype)
        return tuple(t.cpu().numpy() for t in out)

    def _checked_neighbors(self, Q):
        """radius_neighbors and the strict truncation guard."""
        d, idx, counts = self.radius_neighbors(Q)
        if self.strict:
            check_truncation(counts, self.max_neighbors,
                             f"aggregate the nearest {self.max_neighbors}")
        return d, idx, counts


class RadiusNeighborsClassifier(_RadiusNeighborsBase):
    """Classify by majority vote among all training points within
    ``radius`` of the query (the nearest ``max_neighbors`` of them when
    more are inside and ``strict=False``; ``strict=True`` raises then).

    ``outlier_label``: label for queries with no in-radius neighbor; None
    raises instead.  ``num_classes`` is inferred from the labels if None.
    Other args as :class:`_RadiusNeighborsBase` (``device`` None = cuda).
    """

    def __init__(self, radius: float, *, num_classes: Optional[int] = None,
                 outlier_label: Optional[int] = None, **kwargs):
        super().__init__(radius, **kwargs)
        self.num_classes = num_classes
        self.outlier_label = outlier_label

    def _fit_targets(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, dtype=np.int32)
        if y.ndim != 1:
            raise ValueError(f"labels must be 1-D, got {y.shape}")
        if self.num_classes is None:
            self.num_classes = int(y.max()) + 1
        return y

    def predict(self, Q) -> np.ndarray:
        self._require_fit()
        _, idx, counts = self._checked_neighbors(Q)
        labels = self._y[np.clip(idx, 0, None)]
        labels = np.where(idx == SENTINEL_IDX, -1, labels)  # the vote drops -1
        pred = majority_vote(torch.from_numpy(labels), self.num_classes).numpy()
        outliers = counts == 0
        if outliers.any():
            if self.outlier_label is None:
                raise ValueError(
                    f"{int(outliers.sum())} queries have no neighbors within "
                    f"radius {self.radius}; widen the radius or set "
                    f"outlier_label")
            pred = np.where(outliers, np.int32(self.outlier_label), pred)
        return pred

    def score(self, Q, y) -> float:
        return float(np.mean(self.predict(Q) == np.asarray(y)))


class RadiusNeighborsRegressor(_RadiusNeighborsBase):
    """Regress as the (optionally inverse-distance-weighted) mean target
    over all training points within ``radius``.

    ``weights``: 'uniform' | 'distance' (1/d, KNNRegressor's convention:
    l2 distances take their sqrt first).  ``outlier_value``: prediction
    for queries with no in-radius neighbor; None raises instead.
    """

    def __init__(self, radius: float, *, weights: str = "uniform",
                 outlier_value: Optional[float] = None, **kwargs):
        if weights not in ("uniform", "distance"):
            raise ValueError(f"unknown weights {weights!r}")
        super().__init__(radius, **kwargs)
        self.weights = weights
        self.outlier_value = outlier_value

    def _fit_targets(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, dtype=np.float32)

    def predict(self, Q) -> np.ndarray:
        from knn_tpu_torch.models.regressor import DIST_FLOOR

        self._require_fit()
        d, idx, counts = self._checked_neighbors(Q)
        within = idx != SENTINEL_IDX
        targets = self._y[np.clip(idx, 0, None)].astype(np.float64)
        within_t = within[..., None] if targets.ndim == 3 else within
        n_sel = np.maximum(within.sum(axis=1), 1)
        if self.weights == "uniform":
            pred = (np.where(within_t, targets, 0.0).sum(axis=1)
                    / (n_sel[:, None] if targets.ndim == 3 else n_sel))
        else:
            # float64 weights: f32 would underflow the 1e-300 zero-sum
            # guard to 0 (0/0 on all-outlier rows)
            dv = d.astype(np.float64)
            if self.metric.lower() in L2_FAMILY:
                dv = np.sqrt(np.maximum(dv, 0.0))  # ranking space is squared
            w = np.where(within, 1.0 / np.maximum(dv, DIST_FLOOR), 0.0)
            w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
            wt = w[..., None] if targets.ndim == 3 else w
            pred = (wt * np.where(within_t, targets, 0.0)).sum(axis=1)
        outliers = counts == 0
        if outliers.any():
            if self.outlier_value is None:
                raise ValueError(
                    f"{int(outliers.sum())} queries have no neighbors within "
                    f"radius {self.radius}; widen the radius or set "
                    f"outlier_value")
            pred = np.where(outliers[:, None] if pred.ndim == 2 else outliers,
                            np.float64(self.outlier_value), pred)
        return pred.astype(np.float32)

    def score(self, Q, y) -> float:
        """R^2 (sklearn convention: a constant y scores 1.0 when predicted
        exactly, else 0.0; multi-output y averages per-output R^2)."""
        y = np.atleast_2d(np.asarray(y, dtype=np.float64).T).T
        pred = np.atleast_2d(np.asarray(self.predict(Q), dtype=np.float64).T).T
        ss_res = ((y - pred) ** 2).sum(axis=0)
        ss_tot = ((y - y.mean(axis=0)) ** 2).sum(axis=0)
        varying = ss_tot > 0
        r2 = np.where(varying, 1.0 - ss_res / np.where(varying, ss_tot, 1.0),
                      np.where(ss_res == 0, 1.0, 0.0))
        return float(r2.mean())
