"""knn_tpu_torch — the PyTorch/CUDA port of knn_tpu for one NVIDIA H100.

The JAX package ``knn_tpu`` stays the reference; this package computes the
same answers on a GPU and imports neither JAX nor anything of ``knn_tpu``.
Its TPU kernels become hand-written Hopper kernels (``csrc/``), built with
``nvcc`` at first use; everything around them is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

- :class:`ShardedKNN` — a database placed once (any metric of
  ``ops.metrics.METRICS``, optionally ranking in a ``compute_dtype``; with
  ``hbm_budget_bytes`` one larger than the budget stays in host RAM and
  ``search`` streams it through the card, the host-RAM tier);
  ``search``, ``radius_search``, ``search_certified`` (certified-exact for
  l2, cosine and dot: ``selector="pallas"`` through a coarse kernel — the
  ``tiled`` (query-major or ``db_major`` grid), ``streaming`` or
  ``fused`` entry of the ``bf16x3`` (K1, K10, K11), ``bf16x3f`` (K4),
  ``highest`` (K2), ``int8`` (K5), ``int4`` (K6) or ``pq`` (K7, tiled and
  streaming) arm, in grouped or ``lane`` binning (K8), optionally through
  the two-stage ``overlap`` pipeline — or the counted ``"exact"`` /
  ``"approx"`` selectors), ``predict``, ``predict_certified``;
- :func:`knn_search_pallas` — one certified search against a database
  placed for the call;
- :func:`knn_search_certified` with :func:`pallas_candidate_fn` — the
  counted certificate over any coarse kernel (``default``, K3, included),
  :func:`count_below` its counting pass;
- :func:`radius_search` — bounded fixed-radius search on one tensor;
- :class:`KNNClassifier`, :class:`KNNRegressor`,
  :class:`NearestNeighbors`, :class:`RadiusNeighborsClassifier`,
  :class:`RadiusNeighborsRegressor` — the estimators;
- :class:`MutableIndex` (``knn_tpu_torch.index``) — inserts, deletes and
  snapshot-swap compaction over a placement, its certified search bitwise
  a fresh index of the surviving rows;
- :class:`IVFIndex` (``knn_tpu_torch.ivf``) — the probed IVF tier with its
  residual certificate and exact float64 repair;
- :func:`knn_join` (``knn_tpu_torch.join``) — the bulk join of a query
  set against a placement or an IVF index;
- ``knn_tpu_torch.serving`` (``ServingEngine``: a CUDA graph per bucket
  rung; ``QueryQueue`` with admission control), the tiers'
  ``serving_engine()``, ``knn_tpu_torch.streaming`` (resumable batch
  streams) and ``knn_tpu_torch.loadgen`` (open-loop load and the knee);
- :func:`run_job` with :class:`JobConfig` — the reference job
  (``python -m knn_tpu_torch.cli``, with the ``tune``, ``join`` and
  ``index --selftest`` subcommands; ``backend="native"`` runs it on the
  C++ CPU backend, ``knn_tpu_torch.native``); :func:`make_database` and
  ``knn_tpu_torch.data.vecs`` for benchmark data.
"""

from knn_tpu_torch.data.datasets import make_database
from knn_tpu_torch.index import MutableIndex
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.models.classifier import KNNClassifier
from knn_tpu_torch.models.neighbors import NearestNeighbors
from knn_tpu_torch.models.radius import (RadiusNeighborsClassifier,
                                         RadiusNeighborsRegressor)
from knn_tpu_torch.models.regressor import KNNRegressor
from knn_tpu_torch.ops.certified import (count_below, knn_search_certified,
                                         pallas_candidate_fn)
from knn_tpu_torch.ops.coarse_knn import knn_search_pallas
from knn_tpu_torch.ops.radius import radius_search
from knn_tpu_torch.parallel.sharded import ShardedKNN, unpack_certified
from knn_tpu_torch.pipeline import JobResult, run_job
from knn_tpu_torch.utils.config import JobConfig

__all__ = ["IVFIndex", "JobConfig", "JobResult", "KNNClassifier",
           "KNNRegressor", "MutableIndex", "NearestNeighbors",
           "RadiusNeighborsClassifier", "RadiusNeighborsRegressor",
           "ShardedKNN", "count_below", "knn_join", "knn_search_certified",
           "knn_search_pallas", "make_database", "pallas_candidate_fn",
           "radius_search", "run_job", "unpack_certified"]
