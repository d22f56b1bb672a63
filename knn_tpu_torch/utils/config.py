"""Runtime job configuration — the port's copy of knn_tpu/utils/config.py
(``JobConfig``, ``CERTIFIED_PRECISIONS``), cut to the single-GPU slice.

Field ↔ reference mapping (knn_mpi.cpp:108-119):
  dim          <- ``dim``                 :108 (None = infer from file)
  k            <- ``K``                   :109
  num_classes  <- ``class_cnt``           :113 (None = infer from labels)
  metric       <- ``Euclidean_distance``  :114 ('l2', plus cosine)
  normalize    <- ``Normalize``           :115
  validation   <- ``Validation``          :116
  train_file / val_file / test_file      :117-119
  output_file  <- the hard-coded ``Test_label.csv``  :390

The JAX package's mesh, merge, serving and native-backend fields belong
to later slices of the port; ``device`` is the port's own (``None`` =
``cuda``, see knn_tpu_torch.device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from knn_tpu_torch.ops.metrics import PORTED_METRICS

#: kernel matmul precisions with a certified tolerance model (the JAX
#: package's list), all of which the port's coarse pass runs; ``default``
#: (no tolerance model) runs only under the counted certificate
#: (ops.certified).
CERTIFIED_PRECISIONS = ("bf16x3", "bf16x3f", "highest", "int8", "int4",
                        "pq")

#: certified-mode selectors the port runs (the JAX package also has the
#: counted "approx" and "exact" selectors — a later slice)
SELECTORS = ("pallas",)


@dataclass
class JobConfig:
    """One KNN classification job (the reference's ``main()``)."""

    train_file: str = "mnist_train.csv"
    test_file: str = "mnist_test.csv"
    val_file: Optional[str] = "mnist_validation.csv"
    output_file: str = "Test_label.csv"
    dim: Optional[int] = None
    k: int = 50
    num_classes: Optional[int] = None
    metric: str = "l2"
    normalize: bool = True
    validation: bool = True
    #: torch device; None = "cuda" (raises without a GPU)
    device: Optional[str] = None
    train_tile: Optional[int] = None
    batch_size: Optional[int] = None
    #: "exact" ranks every candidate in float32; "certified" runs the
    #: one-pass self-certifying coarse kernel + f64 repair — exact
    #: neighbor sets (ShardedKNN.search_certified)
    mode: str = "exact"
    selector: str = "pallas"
    #: explicit coarse-kernel precision; None = the library default
    pallas_precision: Optional[str] = None

    def __post_init__(self):
        self.metric = self.metric.lower()
        if self.metric not in PORTED_METRICS:
            raise ValueError(
                f"metric {self.metric!r} not in {PORTED_METRICS} (the port "
                f"runs the l2 family and cosine so far)")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.validation and not self.val_file:
            raise ValueError("validation=True requires val_file")
        if self.mode not in ("exact", "certified"):
            raise ValueError(f"mode {self.mode!r} not in ('exact', 'certified')")
        if self.selector not in SELECTORS:
            raise ValueError(
                f"selector {self.selector!r} is not ported; use one of "
                f"{SELECTORS}")
        if self.pallas_precision is not None and \
                self.pallas_precision not in CERTIFIED_PRECISIONS:
            raise ValueError(
                f"pallas_precision {self.pallas_precision!r} not in "
                f"{CERTIFIED_PRECISIONS}")
