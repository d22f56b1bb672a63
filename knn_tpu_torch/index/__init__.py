"""knn_tpu_torch.index — the mutable index on one GPU: delta-tail
inserts, tombstone deletes and snapshot-swap compaction over a
:class:`~knn_tpu_torch.parallel.sharded.ShardedKNN` placement (the port of
knn_tpu/index).

- :mod:`~knn_tpu_torch.index.artifact` — the error vocabulary
  (:class:`MutationUnsupportedError`, :class:`MutationBudgetError`);
- :mod:`~knn_tpu_torch.index.mutable` — :class:`MutableIndex` and its
  serving frontend :class:`MutableServingEngine`;
- :mod:`~knn_tpu_torch.index.tier` — what it shares with the IVF tier:
  the write id rules, the compaction thresholds and the background
  compactor, whose recorded error ``close()`` re-raises.

The ``mutation`` bench-block validator is not ported yet.
"""

from knn_tpu_torch.index.artifact import (MutationBudgetError,
                                          MutationUnsupportedError)
from knn_tpu_torch.index.mutable import MutableIndex, MutableServingEngine

__all__ = ["MutableIndex", "MutableServingEngine", "MutationBudgetError",
           "MutationUnsupportedError"]
