"""Seeded, deterministic k-means — the port's copy of knn_tpu/ivf/kmeans.py,
which trains the codebooks of the pq coarse arm (knn_tpu_torch.ops.pq).

The numpy arithmetic is the reference's, verbatim: the farthest-point
init (:func:`_farthest_point_init`), the host float64 segment-mean update
(``np.add.at``, deterministic in index order) and the float64 residuals.
The **assign** step is the port's own exact search: a
:class:`~knn_tpu_torch.parallel.sharded.ShardedKNN` placement of the
current centroids searched with ``k=1`` on the caller's device, whose
stable top-k breaks a distance tie to the lower centroid index
(ops/topk.py), as the reference's select does.

The rest of the IVF tier (lists, probing, ``quantize_centroids``) is a
later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from knn_tpu_torch.device import DeviceLike, resolve_device


class KMeansResult(NamedTuple):
    #: [C, D] float32 centroids (row c = mean of its members, f64 math)
    centroids: np.ndarray
    #: [N] int64 list assignment of every training row
    assign: np.ndarray
    #: [C] int64 member count per list
    counts: np.ndarray
    #: [C] float64 max residual ``max ||x - c||`` per list (0 for empty
    #: lists)
    residuals: np.ndarray
    #: float64 sum of squared residuals (Lloyd objective, for tests)
    inertia: float
    #: Lloyd iterations actually run
    iters: int


def assign_lists(rows: np.ndarray, centroids: np.ndarray, *,
                 device: DeviceLike = None,
                 train_tile: Optional[int] = None) -> np.ndarray:
    """[N] nearest-centroid assignment by the port's exact k=1 search on
    ``device`` (None = cuda); a distance tie goes to the lower centroid
    index."""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    knn = ShardedKNN(np.asarray(centroids, np.float32), k=1, metric="l2",
                     train_tile=train_tile, device=device)
    _, idx = knn.search(np.asarray(rows, np.float32))
    return idx.reshape(-1).cpu().numpy().astype(np.int64)


def _residuals(rows64: np.ndarray, centroids: np.ndarray,
               assign: np.ndarray, ncentroids: int):
    """Per-list max residual radius + inertia, float64 throughout (an
    upper bound on every member's distance to its centroid)."""
    diff = rows64 - centroids.astype(np.float64)[assign]
    sq = np.einsum("nd,nd->n", diff, diff)
    res = np.zeros(ncentroids, np.float64)
    np.maximum.at(res, assign, np.sqrt(sq))
    return res, float(sq.sum())


def _farthest_point_init(rows64: np.ndarray, ncentroids: int,
                         seed: int) -> np.ndarray:
    """Deterministic farthest-point init: the seed picks the first
    centroid row, each next centroid is the row farthest from the chosen
    set (ties -> lowest index)."""
    n = rows64.shape[0]
    rng = np.random.default_rng(seed)
    picks = [int(rng.integers(n))]
    min_sq = np.einsum("nd,nd->n",
                       rows64 - rows64[picks[0]],
                       rows64 - rows64[picks[0]])
    for _ in range(1, ncentroids):
        picks.append(int(np.argmax(min_sq)))
        diff = rows64 - rows64[picks[-1]]
        np.minimum(min_sq, np.einsum("nd,nd->n", diff, diff),
                   out=min_sq)
    return np.sort(np.asarray(picks))


def train_kmeans(rows: np.ndarray, ncentroids: int, *,
                 device: DeviceLike = None, iters: int = 5, seed: int = 0,
                 train_tile: Optional[int] = None) -> KMeansResult:
    """Seeded Lloyd: deterministic farthest-point init, k=1 assign on
    ``device`` (None = cuda), host f64 segment-mean update."""
    dev = resolve_device(device)
    rows = np.ascontiguousarray(np.asarray(rows, np.float32))
    n, d = rows.shape
    ncentroids = int(min(max(1, ncentroids), n))
    rows64 = rows.astype(np.float64)
    init = _farthest_point_init(rows64, ncentroids, seed)
    centroids = rows[init].copy()
    assign = np.zeros(n, np.int64)
    it = 0
    for it in range(1, max(1, int(iters)) + 1):
        assign = assign_lists(rows, centroids, device=dev,
                              train_tile=train_tile)
        sums = np.zeros((ncentroids, d), np.float64)
        np.add.at(sums, assign, rows64)
        counts = np.bincount(assign, minlength=ncentroids)
        new = centroids.astype(np.float64)
        nz = counts > 0
        new[nz] = sums[nz] / counts[nz, None]
        centroids = new.astype(np.float32)
    assign = assign_lists(rows, centroids, device=dev, train_tile=train_tile)
    counts = np.bincount(assign, minlength=ncentroids).astype(np.int64)
    residuals, inertia = _residuals(rows64, centroids, assign, ncentroids)
    return KMeansResult(centroids, assign, counts, residuals, inertia, it)
