"""knn_tpu_torch.index — the mutable index on one GPU or a mesh:
delta-tail inserts, tombstone deletes and snapshot-swap compaction over a
:class:`~knn_tpu_torch.parallel.sharded.ShardedKNN` placement (the port of
knn_tpu/index).

- :mod:`~knn_tpu_torch.index.artifact` — the error vocabulary
  (:class:`MutationUnsupportedError`, :class:`MutationBudgetError`) and
  the ``mutation`` bench-block validator (``validate_mutation_block``);
- :mod:`~knn_tpu_torch.index.mutable` — :class:`MutableIndex` and its
  serving frontend :class:`MutableServingEngine`;
- :mod:`~knn_tpu_torch.index.tier` — what it shares with the IVF tier:
  the placement on a device or a mesh, the ladder of padded shapes, the
  write id rules, the compaction thresholds and the background
  compactor, whose recorded error ``close()`` re-raises.
"""

from knn_tpu_torch.index.artifact import (MutationBudgetError,
                                          MutationUnsupportedError)
from knn_tpu_torch.index.mutable import MutableIndex, MutableServingEngine

__all__ = ["MutableIndex", "MutableServingEngine", "MutationBudgetError",
           "MutationUnsupportedError"]
