"""knn_tpu_torch.ivf — the IVF tier on one GPU or a mesh (the port of
knn_tpu/ivf): :class:`IVFIndex` (k-means list-major placement, probed
search with a residual certificate and exact float64 repair, delta tails
and re-cluster compaction), its serving frontend :class:`IVFServingEngine`,
its seeded k-means (:func:`train_kmeans`, :func:`quantize_centroids`) and
the ``ivf`` bench-block validator (:mod:`knn_tpu_torch.ivf.artifact`)."""

from knn_tpu_torch.ivf.index import SELECTORS, IVFIndex, IVFServingEngine
from knn_tpu_torch.ivf.kmeans import (KMeansResult, quantize_centroids,
                                      train_kmeans)

__all__ = ["IVFIndex", "IVFServingEngine", "KMeansResult", "SELECTORS",
           "quantize_centroids", "train_kmeans"]
