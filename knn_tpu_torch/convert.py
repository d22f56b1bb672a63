"""Carry a database across from the JAX package's form to the port's.

The JAX ``ShardedKNN`` is built from host numpy arrays (train rows,
labels) and derives its device placement from them at construction.
:func:`placement_from_numpy` builds the port's placement from the same
arrays, the same way: cosine rows are normalized once in float64
(``sharded.py:612-621``), the f64 ``db_norm_max`` certificate term is
computed once (``_db_norm_max``), and the bf16x3 coarse pass's db parts
are split once at placement (the JAX package re-splits per call inside
its jitted program; the values are the same).  Tests build both sides
from one numpy array through this function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.coarse_knn import TILE_N, prepare_db
from knn_tpu_torch.ops.metrics import L2_FAMILY, PORTED_METRICS


@dataclasses.dataclass
class Placement:
    """A database placed on one device for search and certified search."""

    #: f32 rows [N, D] on the device (unit rows for cosine)
    db: torch.Tensor
    #: the same rows on host, for float64 refinement and repair
    db_host: np.ndarray
    #: bf16 hi/lo parts [Np, Dp] of the rows padded to a TILE_N multiple
    #: with PAD_VAL and to a 128-dim multiple with zeros
    th: torch.Tensor
    tl: torch.Tensor
    #: f32 row norms of the padded rows, as [8, Np] rows (row 0 is read)
    tnorm: torch.Tensor
    #: largest float64 squared row norm (the certificate's db term)
    db_norm_max: float
    metric: str
    labels: Optional[torch.Tensor] = None
    num_classes: Optional[int] = None

    @property
    def n_train(self) -> int:
        return self.db.shape[0]

    @property
    def device(self) -> torch.device:
        return self.db.device


def row_normalize_f64(x: np.ndarray) -> np.ndarray:
    """Unit rows with float64 norms, float32 result (zero rows keep
    themselves)."""
    n = np.linalg.norm(x.astype(np.float64), axis=-1, keepdims=True)
    return (x / np.maximum(n, 1e-300)).astype(np.float32)


def placement_from_numpy(train, labels=None, num_classes: Optional[int] = None,
                         *, metric: str = "l2",
                         device: DeviceLike = None) -> Placement:
    """The port's placement of ``train`` [N, D] (and optional int labels
    [N] with ``num_classes``) on ``device`` (None = cuda).  The rows must
    be finite: the certificate has no order for a NaN score."""
    dev = resolve_device(device)
    metric = metric.lower()
    if metric not in PORTED_METRICS:
        raise ValueError(
            f"metric {metric!r} is not ported; expected one of {PORTED_METRICS}")
    host = np.ascontiguousarray(np.asarray(train, dtype=np.float32))
    if host.ndim != 2 or host.shape[0] == 0:
        raise ValueError(f"train must be a non-empty [N, D] array, got {host.shape}")
    if metric == "cosine":
        host = row_normalize_f64(host)
    # a row holding a NaN or an inf has a non-finite float64 norm
    db_norm_max = float((host.astype(np.float64) ** 2).sum(-1).max())
    if not np.isfinite(db_norm_max):
        raise ValueError("train rows must be finite")
    db = torch.from_numpy(host).to(dev)
    th, tl, tnorm = prepare_db(db, TILE_N)
    lab = None
    if labels is not None:
        if num_classes is None:
            raise ValueError("labels given without num_classes")
        labels = np.asarray(labels, dtype=np.int32)
        if labels.shape != (host.shape[0],):
            raise ValueError(
                f"labels shape {labels.shape} != (n_train,) = ({host.shape[0]},)")
        lab = torch.from_numpy(labels).to(dev)
    return Placement(db=db, db_host=host, th=th, tl=tl, tnorm=tnorm,
                     db_norm_max=db_norm_max,
                     metric="l2" if metric in L2_FAMILY else metric,
                     labels=lab, num_classes=num_classes)
