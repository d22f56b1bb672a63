"""KNN classifier — the port of knn_tpu/models/classifier.py (the free
functions ``knn_predict`` and ``knn_kneighbors``, and ``KNNClassifier``:
fit, predict, kneighbors, score), on one device or a mesh.

``fit`` places the database once (parallel.ShardedKNN, over ``mesh`` when
one is given) and every predict reuses it.  ``mode="exact"`` ranks every row in the compute dtype (ties
to the lower index); ``mode="certified"`` runs a certificate (``selector``
"pallas", the one-pass kernel one, or the counted "exact" / "approx"):
exact neighbor sets, hence exact labels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.metrics import METRICS
from knn_tpu_torch.ops.normalize import minmax_apply, minmax_stats
from knn_tpu_torch.ops.topk import knn_search_tiled
from knn_tpu_torch.ops.vote import majority_vote
from knn_tpu_torch.parallel.sharded import SELECTORS, ShardedKNN


def knn_predict(train: torch.Tensor, train_labels: torch.Tensor,
                queries: torch.Tensor, *, k: int, num_classes: int,
                metric: str = "l2", train_tile: Optional[int] = None,
                compute_dtype=None) -> torch.Tensor:
    """Predicted labels [Q] for one query batch on the tensors' device —
    the reference's per-query loop (knn_mpi.cpp:315-338): distance fill ->
    top-k select (ties to the lower index) -> majority vote."""
    _, idx = knn_search_tiled(queries, train, k, metric,
                              train_tile=train_tile,
                              compute_dtype=compute_dtype)
    return majority_vote(train_labels[idx], num_classes)


def knn_kneighbors(train: torch.Tensor, queries: torch.Tensor, *, k: int,
                   metric: str = "l2", train_tile: Optional[int] = None,
                   compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances, indices) of the k nearest train rows per query."""
    return knn_search_tiled(queries, train, k, metric, train_tile=train_tile,
                            compute_dtype=compute_dtype)


class KNNClassifier:
    """Brute-force KNN classifier with the reference's semantics.

    Args:
      k: neighbors (ref ``K``, knn_mpi.cpp:109).
      metric: 'l2' | 'l1' | 'cosine' | 'dot' (and the aliases of
        ops.metrics.METRICS); certified mode takes the l2 family and
        cosine.
      num_classes: ref ``class_cnt``; inferred from labels if None.
      normalize: min-max normalize train at fit and queries at predict with
        train-only stats (the transductive job lives in the pipeline).
      train_tile: stream the database in tiles of this many rows in the
        exact path (None = one distance block per query chunk).
      batch_size: queries per step.
      compute_dtype: matmul input dtype of the exact path, e.g.
        'bfloat16' (f32 accumulation).
      mode: 'exact' | 'certified'.
      selector: certified-mode selector ('pallas' | 'exact' | 'approx').
      device: torch device; None = 'cuda' (raises without a GPU).
      mesh: a parallel.mesh.make_mesh / make_host_mesh mesh: fit places
        the database over it once and every predict / kneighbors runs
        the sharded programs (the device is the mesh's first).
      merge: the db-axis merge strategy on a mesh ('allgather' | 'ring';
        None: the measured crossover).
    """

    def __init__(self, k: int = 5, metric: str = "l2",
                 num_classes: Optional[int] = None, normalize: bool = False,
                 train_tile: Optional[int] = None,
                 batch_size: Optional[int] = None, compute_dtype=None,
                 mode: str = "exact", selector: str = "pallas",
                 device: DeviceLike = None, mesh=None,
                 merge: Optional[str] = "allgather"):
        if mode not in ("exact", "certified"):
            raise ValueError(f"unknown mode {mode!r}")
        if metric.lower() not in METRICS:
            raise ValueError(
                f"unknown metric {metric!r}; expected one of {METRICS}")
        if mode == "certified" and metric.lower() not in (
                "l2", "sql2", "euclidean", "cosine"):
            raise ValueError(
                "mode='certified' supports the l2 and cosine metrics only")
        if mode == "certified" and selector not in SELECTORS:
            raise ValueError(
                f"unknown selector {selector!r}; expected {SELECTORS}")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.device = (mesh.first_device if mesh is not None
                       else resolve_device(device))
        self.mesh = mesh
        self.merge = merge
        self.k = k
        self.metric = metric
        self.num_classes = num_classes
        self.normalize = normalize
        self.train_tile = train_tile
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
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
        placement = (dict(mesh=self.mesh, merge=self.merge)
                     if self.mesh is not None else dict(device=self.device))
        self._program = ShardedKNN(
            X.cpu().numpy(), k=self.k, metric=self.metric,
            train_tile=self.train_tile, compute_dtype=self.compute_dtype,
            labels=y, num_classes=self.num_classes, **placement)
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
        """``fn`` over query batches of ``batch_size``: a tensor, or a tuple
        of tensors, per batch, concatenated."""
        bs = self.batch_size or max(1, Q.shape[0])
        outs = [fn(Q[lo : lo + bs]) for lo in range(0, Q.shape[0], bs)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def predict(self, Q) -> np.ndarray:
        """Predicted labels [Q] int32 — the reference's KNN phase + vote."""
        Q = self._prep_queries(Q)
        if self.mode == "certified":
            labels, _ = self._program.predict_certified(
                Q.cpu().numpy(), selector=self.selector,
                batch_size=self.batch_size)
            return labels
        return self._batched(Q, self._program.predict).cpu().numpy()

    def kneighbors(self, Q, *, return_sqrt: bool = False):
        """(distances, indices) [Q, k] host arrays of the k nearest rows.
        l2-family distances are squared unless ``return_sqrt``; certified
        mode returns the certificate's distances (float64-exact for the
        counted selectors)."""
        Q = self._prep_queries(Q)
        if self.mode == "certified":
            d, i, _ = self._program.search_certified(
                Q.cpu().numpy(), selector=self.selector,
                batch_size=self.batch_size, return_sqrt=return_sqrt)
            return d, i
        d, i = self._batched(Q, lambda c: self._program.search(
            c, return_sqrt=return_sqrt))
        return d.cpu().numpy(), i.cpu().numpy()

    def score(self, Q, y) -> float:
        """Accuracy — ``acc_calc`` (knn_mpi.cpp:69-84)."""
        return float(np.mean(self.predict(Q) == np.asarray(y)))
