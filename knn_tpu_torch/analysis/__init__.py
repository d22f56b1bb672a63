"""knn_tpu_torch.analysis — the port's static-analysis suite and its byte
model (the port of knn_tpu/analysis/).

Five registered checkers over a small framework
(:mod:`~knn_tpu_torch.analysis.core`):

- ``switch-lockstep`` — the port reads no ``KNN_TPU_*`` / ``KNN_BENCH_*``
  environment switch: no such string in its code or its docs, and every
  JAX switch cataloged (:mod:`~knn_tpu_torch.analysis.switches`) with the
  argument that stands in for it;
- ``metric-lockstep`` — the metric catalog in lockstep with the
  registry's grammar, the docs, the source literals and
  ``names.UNWRITTEN``;
- ``locked-mutation`` — classes annotated thread-safe mutate shared
  attributes only under their declared lock (runtime complement:
  :mod:`~knn_tpu_torch.analysis.lockorder`, the instrumented-lock
  deadlock detector the hammers run on the CPU and on the card);
- ``torch-hygiene`` — wall-clock reads, host syncs inside ``@hot_path``
  functions (:mod:`~knn_tpu_torch.analysis.annotations`), imports of
  ``jax`` or ``knn_tpu``, and fallbacks from a kernel to its plain
  version;
- ``artifact-lockstep`` — the bench blocks in lockstep with their schema
  catalog (:mod:`~knn_tpu_torch.analysis.artifacts`).

The JAX package's sixth, ``vmem-budget``, has no counterpart: the TPU's
VMEM model stays unported, and the tuner's Hopper resource gate
(``tuning.autotune._resource_gate``) stands in.

Entry points: ``python -m knn_tpu_torch.cli lint`` (exit 0 green, 1
findings; no GPU, no JAX, no CUDA context), :func:`run` in-process.
Suppressions require a written justification and fail the lint when
stale (``knn_tpu_torch/analysis/suppressions.json``).

Beside the lint, the byte model the join and the IVF tier read:
:mod:`~knn_tpu_torch.analysis.widths` (what one db row streams at each
precision) and :mod:`~knn_tpu_torch.analysis.hbm` (placement and query
block bytes, the join's superblock and sweep-nesting plan).
"""

from __future__ import annotations

from knn_tpu_torch.analysis.core import (  # noqa: F401 — the public surface
    CHECKERS,
    Context,
    Finding,
    Report,
    SOURCE_ROOTS,
    SUPPRESSIONS_PATH,
    checker,
    load_suppressions,
)
from knn_tpu_torch.analysis import (  # noqa: F401 — registration imports
    check_artifacts,
    check_concurrency,
    check_metrics,
    check_switches,
    check_torch,
)
from knn_tpu_torch.analysis.core import run  # noqa: F401

__all__ = ["CHECKERS", "Context", "Finding", "Report", "SOURCE_ROOTS",
           "SUPPRESSIONS_PATH", "checker", "load_suppressions", "run"]
