"""Unsupervised nearest-neighbor queries and sparse graph exports — the
port of knn_tpu/models/neighbors.py (``NearestNeighbors``).

``fit(X)`` places the database once (parallel.ShardedKNN); ``kneighbors``
and ``radius_neighbors`` run its search and radius search.  Graphs are
raw CSR triples ``(data, indices, indptr)`` with no scipy dependency
(``scipy.sparse.csr_matrix(triple, shape=(n_queries, n_fit_rows))``
rebuilds the standard object where scipy is around).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.radius import SENTINEL_IDX, check_truncation


class NearestNeighbors:
    """fit/query container for neighbor searches.

    Args:
      k: default neighbor count for :meth:`kneighbors`.
      radius: default radius for :meth:`radius_neighbors` (metric units,
        ops.radius.radius_threshold).
      max_neighbors: bounded width of radius results (the truncation
        contract of ops.radius).
      metric / train_tile / compute_dtype: as ShardedKNN.
      device: torch device; None = 'cuda' (raises without a GPU).
      mesh / merge: place the database over a mesh once (the device is
        its first), with this db-axis merge strategy.
    """

    def __init__(self, k: int = 5, *, radius: Optional[float] = None,
                 max_neighbors: int = 128, metric: str = "l2",
                 train_tile: Optional[int] = None, compute_dtype=None,
                 device: DeviceLike = None, mesh=None,
                 merge: Optional[str] = "allgather"):
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.device = (mesh.first_device if mesh is not None
                       else resolve_device(device))
        self.mesh = mesh
        self.merge = merge
        self.k = k
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.metric = metric
        self.train_tile = train_tile
        self.compute_dtype = compute_dtype
        self._fit_X = None
        self._program = None

    @property
    def n_samples_fit(self) -> int:
        self._require_fit()
        return int(self._fit_X.shape[0])

    def fit(self, X) -> "NearestNeighbors":
        from knn_tpu_torch.parallel.sharded import ShardedKNN

        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got {X.shape}")
        if self.k > X.shape[0]:
            raise ValueError(f"k={self.k} > n_samples={X.shape[0]}")
        self._fit_X = X
        placement = (dict(mesh=self.mesh, merge=self.merge)
                     if self.mesh is not None else dict(device=self.device))
        self._program = ShardedKNN(
            X, k=self.k, metric=self.metric, train_tile=self.train_tile,
            compute_dtype=self.compute_dtype, **placement)
        return self

    def _require_fit(self):
        if self._fit_X is None:
            raise RuntimeError("call fit() before querying")

    def _prep(self, Q) -> np.ndarray:
        Q = np.asarray(Q, np.float32)
        if Q.ndim != 2 or Q.shape[1] != self._fit_X.shape[1]:
            raise ValueError(f"queries {Q.shape} vs fit {self._fit_X.shape}")
        return Q

    # -- queries -----------------------------------------------------------
    def kneighbors(self, Q, k: Optional[int] = None, *,
                   return_sqrt: bool = False):
        """(dists [Q, k], idx [Q, k]) host arrays; squared l2 values unless
        ``return_sqrt`` (ops.topk lexicographic semantics)."""
        self._require_fit()
        d, i = self._program.search(self._prep(Q), k=self.k if k is None else k,
                                    return_sqrt=return_sqrt)
        return d.cpu().numpy(), i.cpu().numpy()

    def radius_neighbors(self, Q, radius: Optional[float] = None):
        """(dists [Q, M], idx [Q, M], counts [Q]) — ShardedKNN.radius_search;
        ``counts > max_neighbors`` flags truncation."""
        self._require_fit()
        radius = self.radius if radius is None else radius
        if radius is None:
            raise ValueError("no radius given (constructor or call)")
        return self._program.radius_search(self._prep(Q), radius,
                                           max_neighbors=self.max_neighbors)

    # -- graphs ------------------------------------------------------------
    def kneighbors_graph(self, Q=None, k: Optional[int] = None, *,
                         mode: str = "connectivity"
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR triple ``(data, indices, indptr)`` of the k-NN adjacency
        [n_queries, n_samples_fit]: ``mode='connectivity'`` 1.0 entries,
        ``'distance'`` the ranking-space distances.  ``Q=None`` builds the
        fit set's self-graph (each row's neighbors include the row)."""
        self._require_fit()
        if mode not in ("connectivity", "distance"):
            raise ValueError(f"unknown mode {mode!r}")
        Q = self._fit_X if Q is None else Q
        d, i = self.kneighbors(Q, k)
        n_q, kk = i.shape
        data = (np.ones(n_q * kk, np.float32) if mode == "connectivity"
                else d.ravel().astype(np.float32))
        return data, i.ravel().astype(np.int64), np.arange(
            0, (n_q + 1) * kk, kk, dtype=np.int64)

    def radius_neighbors_graph(self, Q=None, radius: Optional[float] = None,
                               *, mode: str = "connectivity",
                               strict: bool = True
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR triple of the within-radius adjacency (rows of varying
        width); ``strict=True`` raises when any query's in-radius set
        exceeds ``max_neighbors``, ``strict=False`` keeps the nearest
        ``max_neighbors``."""
        self._require_fit()
        if mode not in ("connectivity", "distance"):
            raise ValueError(f"unknown mode {mode!r}")
        Q = self._fit_X if Q is None else Q
        d, i, counts = self.radius_neighbors(Q, radius)
        if strict:
            check_truncation(counts, self.max_neighbors,
                             "keep the nearest edges only")
        within = i != SENTINEL_IDX
        indptr = np.zeros(i.shape[0] + 1, np.int64)
        np.cumsum(within.sum(axis=1), out=indptr[1:])
        indices = i[within].astype(np.int64)
        data = (np.ones(indices.shape[0], np.float32)
                if mode == "connectivity"
                else d[within].astype(np.float32))
        return data, indices, indptr
