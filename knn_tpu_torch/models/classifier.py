"""KNN classifier — the port of knn_tpu/models/classifier.py
(``KNNClassifier``: fit, predict, score) on one device.

``fit`` places the database once (parallel.ShardedKNN) and every predict
reuses it.  ``mode="exact"`` ranks every row in f32 (ties to the lower
index); ``mode="certified"`` runs the one-pass certificate
(``selector="pallas"``): exact neighbor sets, hence exact labels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.metrics import PORTED_METRICS
from knn_tpu_torch.ops.normalize import minmax_apply, minmax_stats
from knn_tpu_torch.parallel.sharded import SELECTORS, ShardedKNN


class KNNClassifier:
    """Brute-force KNN classifier with the reference's semantics.

    Args:
      k: neighbors (ref ``K``, knn_mpi.cpp:109).
      metric: the l2 family or 'cosine'.
      num_classes: ref ``class_cnt``; inferred from labels if None.
      normalize: min-max normalize train at fit and queries at predict with
        train-only stats (the transductive job lives in the pipeline).
      train_tile: stream the database in tiles of this many rows in the
        exact path (None = one distance block per query chunk).
      batch_size: queries per step.
      mode: 'exact' | 'certified'.
      selector: certified-mode selector ('pallas').
      device: torch device; None = 'cuda' (raises without a GPU).
    """

    def __init__(self, k: int = 5, metric: str = "l2",
                 num_classes: Optional[int] = None, normalize: bool = False,
                 train_tile: Optional[int] = None,
                 batch_size: Optional[int] = None, mode: str = "exact",
                 selector: str = "pallas", device: DeviceLike = None):
        if mode not in ("exact", "certified"):
            raise ValueError(f"unknown mode {mode!r}")
        if metric.lower() not in PORTED_METRICS:
            raise ValueError(
                f"metric {metric!r} is not ported; expected one of {PORTED_METRICS}")
        if mode == "certified" and selector not in SELECTORS:
            raise ValueError(
                f"selector {selector!r} is not ported; expected {SELECTORS}")
        self.device = resolve_device(device)
        self.k = k
        self.metric = metric
        self.num_classes = num_classes
        self.normalize = normalize
        self.train_tile = train_tile
        self.batch_size = batch_size
        self.mode = mode
        self.selector = selector
        self._mins = None
        self._maxs = None
        self._dim = None
        self._program: Optional[ShardedKNN] = None

    def fit(self, X, y) -> "KNNClassifier":
        X = torch.as_tensor(np.asarray(X, np.float32)).to(self.device)
        y = np.asarray(y, dtype=np.int32)
        if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
            raise ValueError(f"bad shapes: X {tuple(X.shape)}, y {y.shape}")
        if self.k > X.shape[0]:
            raise ValueError(f"k={self.k} > n_train={X.shape[0]}")
        if self.num_classes is None:
            self.num_classes = int(y.max()) + 1
        if self.normalize:
            self._mins, self._maxs = minmax_stats([X])
            X = minmax_apply(X, self._mins, self._maxs)
        self._dim = X.shape[1]
        self._program = ShardedKNN(
            X.cpu().numpy(), k=self.k, metric=self.metric,
            train_tile=self.train_tile, labels=y,
            num_classes=self.num_classes, device=self.device)
        return self

    def _prep_queries(self, Q) -> torch.Tensor:
        if self._program is None:
            raise RuntimeError("call fit() before predict()")
        Q = torch.as_tensor(np.asarray(Q, np.float32)).to(self.device)
        if Q.ndim != 2 or Q.shape[1] != self._dim:
            raise ValueError(f"queries {tuple(Q.shape)} vs train dim {self._dim}")
        if self.normalize:
            Q = minmax_apply(Q, self._mins, self._maxs)
        return Q

    def _batched(self, Q: torch.Tensor, fn):
        bs = self.batch_size or max(1, Q.shape[0])
        return torch.cat([fn(Q[lo : lo + bs]) for lo in range(0, Q.shape[0], bs)])

    def predict(self, Q) -> np.ndarray:
        """Predicted labels [Q] int32 — the reference's KNN phase + vote."""
        Q = self._prep_queries(Q)
        if self.mode == "certified":
            labels, _ = self._program.predict_certified(
                Q.cpu().numpy(), selector=self.selector,
                batch_size=self.batch_size)
            return labels
        return self._batched(Q, self._program.predict).cpu().numpy()

    def score(self, Q, y) -> float:
        """Accuracy — ``acc_calc`` (knn_mpi.cpp:69-84)."""
        return float(np.mean(self.predict(Q) == np.asarray(y)))
