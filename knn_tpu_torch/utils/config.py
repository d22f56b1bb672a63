"""Runtime job configuration — the port's copy of knn_tpu/utils/config.py
(``JobConfig``, ``BACKENDS``, ``CERTIFIED_PRECISIONS``) on one GPU.

Field ↔ reference mapping (knn_mpi.cpp:108-119):
  dim          <- ``dim``                 :108 (None = infer from file)
  k            <- ``K``                   :109
  num_classes  <- ``class_cnt``           :113 (None = infer from labels)
  metric       <- ``Euclidean_distance``  :114 ('l2' / 'l1', plus cosine
                                            and dot)
  normalize    <- ``Normalize``           :115
  validation   <- ``Validation``          :116
  train_file / val_file / test_file      :117-119
  output_file  <- the hard-coded ``Test_label.csv``  :390

The JAX package's mesh and merge fields belong to a later slice of the
port; ``device`` is the port's own (``None`` = ``cuda``, see
knn_tpu_torch.device).  The port's own backend is named ``"torch"`` where
the JAX package's is ``"jax"`` (ROADMAP divergence 36).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

from knn_tpu_torch.ops.metrics import METRICS

#: execution backends: the port's PyTorch path and the C++ CPU backend
#: (knn_tpu_torch.native)
BACKENDS = ("torch", "native")

#: kernel matmul precisions with a certified tolerance model (the JAX
#: package's list), all of which the port's coarse pass runs; ``default``
#: (no tolerance model) runs only under the counted certificate
#: (ops.certified).
CERTIFIED_PRECISIONS = ("bf16x3", "bf16x3f", "highest", "int8", "int4",
                        "pq")

#: certified-mode selectors: the counted "exact" and "approx"
#: certificates and the one-pass "pallas" one (parallel.sharded)
SELECTORS = ("exact", "approx", "pallas")


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
    backend: str = "torch"
    #: torch device; None = "cuda" (raises without a GPU)
    device: Optional[str] = None
    train_tile: Optional[int] = None
    batch_size: Optional[int] = None
    #: matmul input dtype of the exact path and the counted selectors'
    #: coarse pass ("bfloat16", "float16"; None = float32)
    compute_dtype: Optional[str] = None
    #: "exact" ranks every candidate in the compute dtype; "certified"
    #: runs a certificate + f64 repair — exact neighbor sets
    #: (ShardedKNN.search_certified; l2 family and cosine)
    mode: str = "exact"
    #: certified-mode selector: "pallas" (the one-pass kernel certificate,
    #: the port's default: ROADMAP divergence 5), "exact" or "approx"
    #: (the counted certificate)
    selector: str = "pallas"
    #: autotuner winner-cache file the pallas selector's knobs resolve
    #: from (``python -m knn_tpu_torch.cli tune --cache``); None = the
    #: user default path
    tune_cache: Optional[str] = None
    #: explicit coarse-kernel precision; None = the library default
    pallas_precision: Optional[str] = None
    #: shape-bucketed serving (knn_tpu_torch.serving): "auto" for the
    #: default geometric ladder, or a comma list like "64,128,256".  The
    #: exact job classifies through the engine's per-bucket executables
    #: (CUDA graphs on the card, built at warmup) and the job metrics gain
    #: a ``serving`` section.  None = direct dispatch.
    serve_buckets: Optional[str] = None
    #: micro-batching deadline (knn_tpu_torch.serving.QueryQueue): echoed
    #: into the serving metrics; only a concurrent-request queue reads it
    max_wait_ms: float = 2.0
    #: native backend threads (0 = hardware concurrency)
    num_threads: int = 0

    def __post_init__(self):
        self.metric = self.metric.lower()
        if self.metric not in METRICS:
            raise ValueError(f"metric {self.metric!r} not in {METRICS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.validation and not self.val_file:
            raise ValueError("validation=True requires val_file")
        if self.mode not in ("exact", "certified"):
            raise ValueError(f"mode {self.mode!r} not in ('exact', 'certified')")
        if self.selector not in SELECTORS:
            raise ValueError(f"selector {self.selector!r} unknown")
        if self.pallas_precision is not None and \
                self.pallas_precision not in CERTIFIED_PRECISIONS:
            raise ValueError(
                f"pallas_precision {self.pallas_precision!r} not in "
                f"{CERTIFIED_PRECISIONS}")
        if self.mode == "certified" and self.metric not in (
                "l2", "sql2", "euclidean", "cosine"):
            raise ValueError(
                "mode='certified' requires the l2 or cosine metric")
        if self.serve_buckets is not None:
            # the ladder module imports neither numpy nor torch
            from knn_tpu_torch.serving.buckets import parse_buckets

            if parse_buckets(self.serve_buckets) is None:
                self.serve_buckets = None  # empty spec = serving off
            if self.serve_buckets is not None and self.mode == "certified":
                raise ValueError(
                    "serve_buckets routes through the exact bucketed "
                    "programs; mode='certified' has its own batching "
                    "(batch_size) and does not compose with it")
            if self.serve_buckets is not None and self.backend != "torch":
                raise ValueError("serve_buckets requires the torch backend")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "JobConfig":
        return cls(**json.loads(s))
