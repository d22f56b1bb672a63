"""knn_tpu_torch — the PyTorch/CUDA port of knn_tpu for one NVIDIA H100.

The JAX package ``knn_tpu`` stays the reference; this package computes the
same answers on a GPU and imports neither JAX nor anything of ``knn_tpu``.
Its TPU kernels become hand-written Hopper kernels (``csrc/``), built with
``nvcc`` at first use; everything around them is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

- :class:`ShardedKNN` — a database placed once; ``search``,
  ``search_certified`` (certified-exact through the coarse kernel),
  ``predict``, ``predict_certified``;
- :class:`KNNClassifier` — fit/predict/score;
- :func:`run_job` with :class:`JobConfig` — the reference job
  (``python -m knn_tpu_torch.cli``).
"""

from knn_tpu_torch.models.classifier import KNNClassifier
from knn_tpu_torch.parallel.sharded import ShardedKNN, unpack_certified
from knn_tpu_torch.pipeline import JobResult, run_job
from knn_tpu_torch.utils.config import JobConfig

__all__ = ["JobConfig", "JobResult", "KNNClassifier", "ShardedKNN",
           "run_job", "unpack_certified"]
