"""Seeded, deterministic k-means — the port's copy of knn_tpu/ivf/kmeans.py,
which trains the IVF tier's coarse quantizer (knn_tpu_torch.ivf.index) and
the codebooks of the pq coarse arm (knn_tpu_torch.ops.pq).

The numpy arithmetic is the reference's, verbatim: the farthest-point
init (:func:`_farthest_point_init`), the host float64 segment-mean update
(``np.add.at``, deterministic in index order) and the float64 residuals.
The **assign** step is the port's own exact search: a
:class:`~knn_tpu_torch.parallel.sharded.ShardedKNN` placement of the
current centroids searched with ``k=1`` on the caller's device or mesh
(the centroids sharded over its db axes), whose stable top-k and
lexicographic ``(distance, index)`` merge break a distance tie to the
lower centroid index (ops/topk.py), on one shard or across two, as the
reference's select does.  :func:`quantize_centroids` is the int8 row
quantization of the centroid table (ops.quantize).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from knn_tpu_torch.device import DeviceLike


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
                 device: DeviceLike = None, mesh=None,
                 train_tile: Optional[int] = None) -> np.ndarray:
    """[N] nearest-centroid assignment by the port's exact k=1 search on
    ``device`` (None = cuda) or ``mesh`` (not both; the JAX package's SPMD
    assign step); a distance tie goes to the lower centroid index, also
    between centroids on two db shards."""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    knn = ShardedKNN(np.asarray(centroids, np.float32), k=1, metric="l2",
                     train_tile=train_tile, device=device, mesh=mesh)
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
                 device: DeviceLike = None, mesh=None, iters: int = 5,
                 seed: int = 0,
                 train_tile: Optional[int] = None) -> KMeansResult:
    """Seeded Lloyd: deterministic farthest-point init, k=1 assign on
    ``device`` (None = cuda) or ``mesh`` (not both), host f64 segment-mean
    update."""
    from knn_tpu_torch.index.tier import tier_mesh

    mesh = tier_mesh(mesh, device)
    rows = np.ascontiguousarray(np.asarray(rows, np.float32))
    n, d = rows.shape
    ncentroids = int(min(max(1, ncentroids), n))
    rows64 = rows.astype(np.float64)
    init = _farthest_point_init(rows64, ncentroids, seed)
    centroids = rows[init].copy()
    assign = np.zeros(n, np.int64)
    it = 0
    for it in range(1, max(1, int(iters)) + 1):
        assign = assign_lists(rows, centroids, mesh=mesh,
                              train_tile=train_tile)
        sums = np.zeros((ncentroids, d), np.float64)
        np.add.at(sums, assign, rows64)
        counts = np.bincount(assign, minlength=ncentroids)
        new = centroids.astype(np.float64)
        nz = counts > 0
        new[nz] = sums[nz] / counts[nz, None]
        centroids = new.astype(np.float32)
    assign = assign_lists(rows, centroids, mesh=mesh, train_tile=train_tile)
    counts = np.bincount(assign, minlength=ncentroids).astype(np.int64)
    residuals, inertia = _residuals(rows64, centroids, assign, ncentroids)
    return KMeansResult(centroids, assign, counts, residuals, inertia, it)


def quantize_centroids(centroids: np.ndarray):
    """Int8 row quantization of the centroid table by the db's scheme
    (ops.quantize.quantize_rows_np: per-row symmetric scale, values in
    [-127, 127]) — the JAX package's ``quantize_centroids``
    (ivf/kmeans.py:121): a ``QuantizedRows`` of values int8 [C, D],
    scales f32 [C] and offset 0."""
    from knn_tpu_torch.ops.quantize import quantize_rows_np

    return quantize_rows_np(np.asarray(centroids, np.float32))
