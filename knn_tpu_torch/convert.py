"""Carry a database across from the JAX package's form to the port's.

The JAX ``ShardedKNN`` is built from host numpy arrays (train rows,
labels) and derives its device placement from them at construction.
:func:`placement_from_numpy` builds the port's placement from the same
arrays, the same way: cosine rows are normalized once in float64
(``sharded.py:612-621``), the f64 ``db_norm_max`` certificate term is
computed once (``_db_norm_max``), and the bf16x3 coarse pass's db parts
are split once at placement (the JAX package re-splits per call inside
its jitted program; the values are the same).  dot rows are
norm-augmented (``sharded.py:622-642``): each row gains the column
``sqrt(max(M - ||t||^2, 0))``, ``M`` the largest float64 squared row
norm (kept as ``dot_shift``), so the augmented squared L2 of a query
with a zero column is ``||q||^2 + M - 2 q.t`` and the l2 certificate
ranks inner products.  A uint8 source is marked unless the metric is
cosine or dot (``sharded.py:561-571``), so the int8 arm places its bytes
byte-exact (ops.quantize.from_uint8); the f32 rows hold them exactly, so
nothing of the caller's array is kept.
Tests build both sides from one numpy array through this function, and
carry a trained product quantizer across with :func:`pq_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.coarse_knn import TILE_N, prepare_db
from knn_tpu_torch.ops.metrics import canonical_metric


@dataclasses.dataclass
class Placement:
    """A database placed on one device for search and certified search."""

    #: f32 rows [N, D] on the device (unit rows for cosine; for dot the
    #: rows with their augmentation column, D = dim_in + 1)
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
    #: the rows came as uint8 (bvecs payloads) and the metric is neither
    #: cosine nor dot: the int8 arm places them byte-exact at unit scale
    uint8_source: bool = False
    #: dot only: M, the largest float64 squared norm of the caller's rows
    dot_shift: float = 0.0

    @property
    def n_train(self) -> int:
        return self.db.shape[0]

    @property
    def dim_in(self) -> int:
        """The caller's row width (a dot placement holds one more)."""
        return self.db.shape[1] - (1 if self.metric == "dot" else 0)

    @property
    def device(self) -> torch.device:
        return self.db.device


def row_normalize_f64(x: np.ndarray) -> np.ndarray:
    """Unit rows with float64 norms, float32 result (zero rows keep
    themselves)."""
    n = np.linalg.norm(x.astype(np.float64), axis=-1, keepdims=True)
    return (x / np.maximum(n, 1e-300)).astype(np.float32)


@dataclasses.dataclass
class HostRows:
    """A database's rows on the host as a placement would hold them: f32
    [N, D] unit rows for cosine, norm-augmented rows for dot (D = dim_in +
    1), the caller's rows otherwise."""

    rows: np.ndarray
    metric: str
    #: largest float64 squared row norm (the certificate's db term)
    db_norm_max: float
    #: the rows came as uint8 and the metric is neither cosine nor dot
    uint8_source: bool = False
    #: dot only: M, the largest float64 squared norm of the caller's rows
    dot_shift: float = 0.0

    @property
    def dim_in(self) -> int:
        return self.rows.shape[1] - (1 if self.metric == "dot" else 0)


def host_rows(train, metric: str = "l2") -> HostRows:
    """``train`` [N, D] prepared on the host for ``metric``, as the JAX
    package prepares it before placing: cosine rows normalized in float64,
    dot rows norm-augmented.  The rows must be finite: the certificate
    has no order for a NaN score."""
    metric = canonical_metric(metric)
    uint8_source = (isinstance(train, np.ndarray) and train.dtype == np.uint8
                    and metric not in ("cosine", "dot"))
    host = np.ascontiguousarray(np.asarray(train, dtype=np.float32))
    if host.ndim != 2 or host.shape[0] == 0:
        raise ValueError(f"train must be a non-empty [N, D] array, got {host.shape}")
    dot_shift = 0.0
    if metric == "cosine":
        host = row_normalize_f64(host)
    elif metric == "dot":
        host, dot_shift = dot_augment(host)
    # a row holding a NaN or an inf has a non-finite float64 norm
    db_norm_max = float((host.astype(np.float64) ** 2).sum(-1).max())
    if not np.isfinite(db_norm_max):
        raise ValueError("train rows must be finite")
    return HostRows(rows=host, metric=metric, db_norm_max=db_norm_max,
                    uint8_source=uint8_source, dot_shift=dot_shift)


def place_host_rows(rows: HostRows, labels=None,
                    num_classes: Optional[int] = None, *,
                    device: DeviceLike = None) -> Placement:
    """The placement of prepared ``rows`` (and optional int labels [N]
    with ``num_classes``) on ``device`` (None = cuda)."""
    dev = resolve_device(device)
    host = rows.rows
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
                     db_norm_max=rows.db_norm_max, metric=rows.metric,
                     labels=lab, num_classes=num_classes,
                     uint8_source=rows.uint8_source,
                     dot_shift=rows.dot_shift)


def placement_from_numpy(train, labels=None, num_classes: Optional[int] = None,
                         *, metric: str = "l2",
                         device: DeviceLike = None) -> Placement:
    """The port's placement of ``train`` [N, D] (and optional int labels
    [N] with ``num_classes``) on ``device`` (None = cuda): :func:`host_rows`
    placed by :func:`place_host_rows`."""
    resolve_device(device)  # no host work for a device that is not there
    return place_host_rows(host_rows(train, metric), labels, num_classes,
                           device=device)


def dot_augment(rows: np.ndarray):
    """``(rows with the column sqrt(max(M - ||t||^2, 0)), M)`` for f32
    ``rows`` [N, D], ``M`` the largest float64 squared row norm — the
    JAX package's arithmetic step for step (sharded.py:634-641), so the
    rows are bitwise its placement's."""
    t64 = rows.astype(np.float64)
    norm2 = np.einsum("nd,nd->n", t64, t64)
    shift = float(norm2.max())
    aug = np.sqrt(np.maximum(shift - norm2, 0.0))
    return np.concatenate([rows, aug[:, None].astype(np.float32)],
                          axis=1), shift


def pq_from_numpy(knn, codebooks: np.ndarray, codes: np.ndarray,
                  stats: dict, dsub: int, dim: int,
                  ncodes: Optional[int] = None) -> dict:
    """Carries trained pq state in numpy form — a JAX ``ops.pq.PQResult``'s
    ``codebooks`` f32 [m, C, dsub], ``codes`` uint8 [N, m], ``stats``
    (``pq_bound_stats``), ``dsub`` and ``dim`` — into the pq placement of
    the port's ``ShardedKNN`` ``knn`` (its rows must be the ones the codes
    encode), so both packages score the same codes whatever their k-means
    would train (on a mesh each db shard takes its block of the codes).
    ``ncodes`` names the placement's geometry (None: the codebooks' C).
    Returns the placement (``ShardedKNN._place_pq``)."""
    width = knn._host_train().shape[1]
    if dim != width:
        raise ValueError(
            f"the codes encode {dim}-dim rows, the placement holds "
            f"{width}-dim ones")
    return knn._place_pq(codebooks, codes, stats, dsub=dsub, ncodes=ncodes)
