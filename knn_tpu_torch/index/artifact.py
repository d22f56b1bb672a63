"""The mutable index's error vocabulary — the port's copy of the error
classes of knn_tpu/index/artifact.py.  (``MUTATION_VERSION`` and the
``mutation`` bench-block validator wait for the port's analysis catalog.)
"""

from __future__ import annotations


class MutationUnsupportedError(ValueError):
    """Raised where a placement cannot be mutated: a metric outside the l2
    family (cosine re-normalizes rows at placement, L1 has no certified
    bound).  A loud refusal: the alternative is serving results the index
    cannot certify."""


class MutationBudgetError(RuntimeError):
    """Raised when a write exceeds the index's delta budget — the tail past
    its top ladder rung, tombstones past the certify-widening reserve, or
    fewer than k live rows.  The fix is
    :meth:`~knn_tpu_torch.index.mutable.MutableIndex.compact` (or
    compaction thresholds that fire before the budget fills)."""
