"""knn_tpu_torch.ivf — the IVF tier on one GPU (the port of knn_tpu/ivf):
:class:`IVFIndex` (k-means list-major placement, probed search with a
residual certificate and exact float64 repair, delta tails and
re-cluster compaction), its serving frontend :class:`IVFServingEngine`
and its seeded k-means.  ``quantize_centroids`` and the ``ivf``
bench-block validator are later slices."""

from knn_tpu_torch.ivf.index import SELECTORS, IVFIndex, IVFServingEngine
from knn_tpu_torch.ivf.kmeans import KMeansResult, train_kmeans

__all__ = ["IVFIndex", "IVFServingEngine", "KMeansResult", "SELECTORS",
           "train_kmeans"]
