"""The mutable index's error vocabulary, the ``mutation`` block's version
token and its validator — the port's copy of knn_tpu/index/artifact.py.
The validator is a shim over the artifact-schema catalog
(:mod:`knn_tpu_torch.analysis.artifacts`, the ``mutation`` entry).
"""

from __future__ import annotations

from typing import List

#: version stamp of the ``mutation`` bench block (the JAX package's
#: value); bump on any schema change so a refresher refuses half-migrated
#: lines — the version token the catalog's ``mutation`` entry consumes
MUTATION_VERSION = 1


def _required_fields():
    from knn_tpu_torch.analysis.artifacts import required_keys

    return required_keys("mutation")


#: fields every valid mutation block must carry — DERIVED from the
#: artifact-schema catalog
MUTATION_REQUIRED = _required_fields()


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


def validate_mutation_block(block) -> List[str]:
    """Structural validation of a ``mutation`` block: the list of
    violations (empty = valid), in the JAX package's words.  Blocks that
    recorded their own failure (an ``error`` key) are exempt."""
    from knn_tpu_torch.analysis.artifacts import validate

    return validate("mutation", block, style="legacy")
