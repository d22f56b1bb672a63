"""Pairwise distance ops in PyTorch — the port of knn_tpu/ops/distance.py
(``pairwise_distance`` and its metrics, ``metric_values``).

- L2 uses the expanded square ``||q||^2 + ||t||^2 - 2 q.t^T``: the
  O(Q*T*D) work is one matmul (:func:`_dot`).  The reference's monotone
  ``sqrt`` (knn_mpi.cpp:48) is dropped, so ranking is unchanged.
- L1 (``Manhattan_D``, knn_mpi.cpp:51-67) has no gram-matrix form: an
  explicit broadcast ``|q - t|`` reduce, run in blocks that bound its
  [q, t, D] temporaries.
- cosine distance is ``1 - q^.t^`` on rows normalized in f32; dot is the
  negative inner product.

``compute_dtype`` (None / "float32", "bfloat16", "float16" or the torch
dtypes) is the matmul's input dtype, as the JAX package's ``_dot``
(distance.py:29-49): the inputs are rounded to it, the products
accumulate in f32 and come out f32, and every norm stays f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from knn_tpu_torch.ops.metrics import L1_FAMILY, L2_FAMILY, METRICS

#: the compute dtypes a program may rank in, by the JAX package's names
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}

#: elements of one [q, t, D] temporary of the broadcast l1 / direct forms
_BROADCAST_BLOCK_ELEMS = 1 << 25



def dtype_name(compute_dtype) -> Optional[str]:
    """The JAX package's name of ``compute_dtype`` (``jnp.dtype(x).name``):
    None stays None (float32, the default); refuses any dtype outside
    :data:`COMPUTE_DTYPES` by name."""
    if compute_dtype is None:
        return None
    for name, dt in COMPUTE_DTYPES.items():
        if compute_dtype == name or compute_dtype is dt:
            return name
    raise ValueError(
        f"compute_dtype {compute_dtype!r} is not one of "
        f"{sorted(COMPUTE_DTYPES)} (or their torch dtypes)")


def half_matmul_form(device) -> str:
    """Which product a half-precision ``compute_dtype`` runs on ``device``:
    on the card ``"mm_out_dtype"`` — ``torch.mm(a, b, out_dtype=
    torch.float32)``, the half-input product with f32 accumulation and
    output (a torch without ``out_dtype`` raises, it never falls back) —
    elsewhere ``"f32_of_rounded"``, the f32 product of the rounded inputs
    (every product exact in f32, TF32 off: the CPU's form)."""
    return ("mm_out_dtype" if torch.device(device).type == "cuda"
            else "f32_of_rounded")


def _dot(queries: torch.Tensor, train: torch.Tensor, compute_dtype=None
         ) -> torch.Tensor:
    """``q @ t.T`` [Q, T] in f32 from ``compute_dtype`` inputs.  f32 (None)
    runs a plain f32 matmul (TF32 off, knn_tpu_torch.device).  Half inputs
    never round the scores to 8 bits (``torch.matmul`` of two bf16 tensors
    returns bf16): on an H100 the product is ``torch.mm(..., out_dtype=
    torch.float32)`` (:func:`half_matmul_form`), elsewhere the f32 product
    of the rounded inputs."""
    name = dtype_name(compute_dtype)
    if name in (None, "float32"):
        return queries.float() @ train.float().T
    dt = COMPUTE_DTYPES[name]
    q, t = queries.to(dt), train.to(dt)
    if half_matmul_form(q.device) == "mm_out_dtype":
        return torch.mm(q, t.T, out_dtype=torch.float32)
    return q.float() @ t.float().T


def _sq_norms(t32: torch.Tensor) -> torch.Tensor:
    """Each f32 row's squared norm, as a [1, T] row."""
    return (t32 * t32).sum(-1)[None, :]


def pairwise_sq_l2(queries: torch.Tensor, train: torch.Tensor, *,
                   compute_dtype=None, t_norm: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Squared L2 distance matrix [Q, T] in f32, clamped at 0 to hide the
    small negative values the expanded square can produce; the norms
    are f32 whatever ``compute_dtype``.  ``t_norm`` is the train rows'
    [1, T] squared norms where the caller already has them."""
    q32 = queries.float()
    t32 = train.float()
    q_norm = (q32 * q32).sum(-1, keepdim=True)
    if t_norm is None:
        t_norm = _sq_norms(t32)
    d = q_norm + t_norm - 2.0 * _dot(q32, t32, compute_dtype)
    return torch.clamp_min(d, 0.0)


def _broadcast_reduce(queries: torch.Tensor, train: torch.Tensor, op):
    """``op(q[:, None] - t[None]).sum(-1)`` [Q, T] in f32, in query and row
    blocks whose [q, t, D] temporaries hold at most
    ``_BROADCAST_BLOCK_ELEMS`` elements (a block changes no value)."""
    q32, t32 = queries.float(), train.float()
    n_q, n, dim = q32.shape[0], t32.shape[0], max(1, q32.shape[1])
    out = torch.empty((n_q, n), dtype=torch.float32, device=q32.device)
    cols = max(1, min(n, _BROADCAST_BLOCK_ELEMS // dim))
    rows = max(1, _BROADCAST_BLOCK_ELEMS // (cols * dim))
    for lo in range(0, n, cols):
        t = t32[lo : lo + cols]
        for r0 in range(0, n_q, rows):
            diff = q32[r0 : r0 + rows, None, :] - t[None, :, :]
            out[r0 : r0 + rows, lo : lo + cols] = op(diff).sum(-1)
    return out


def pairwise_sq_l2_direct(queries: torch.Tensor, train: torch.Tensor
                          ) -> torch.Tensor:
    """Squared L2 via explicit ``(q - t)^2`` (no cancellation at tiny
    distances) — the reference's high-precision f32 form."""
    return _broadcast_reduce(queries, train, lambda x: x * x)


def pairwise_l1(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """Manhattan distance matrix [Q, T] (``Manhattan_D``)."""
    return _broadcast_reduce(queries, train, torch.abs)


def _row_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.sqrt((x32 * x32).sum(-1, keepdim=True))
    return x32 / torch.clamp_min(n, eps)


def pairwise_cosine(queries: torch.Tensor, train: torch.Tensor, *,
                    compute_dtype=None) -> torch.Tensor:
    """Cosine distance 1 - cos(q, t) in [0, 2]."""
    return pairwise_distance(queries, train, "cosine",
                             compute_dtype=compute_dtype)


def pairwise_dot(queries: torch.Tensor, train: torch.Tensor, *,
                 compute_dtype=None) -> torch.Tensor:
    """Negative inner product as a distance (smaller = more similar)."""
    return -_dot(queries, train, compute_dtype)


def prepare_train(train: torch.Tensor, metric: str = "l2"):
    """What :func:`pairwise_distance` computes of the train rows alone:
    ``(rows, t_norm)`` — the f32 rows and their [1, T] squared norms for
    the l2 family, the f32-normalized rows for cosine, the rows as they
    are otherwise (``t_norm`` None).  Made once, it serves any number of
    query blocks against the same rows with the same values."""
    m = metric.lower()
    if m in L2_FAMILY:
        t32 = train.float()
        return t32, _sq_norms(t32)
    if m == "cosine":
        return _row_normalize(train), None
    return train, None


def pairwise_distance(queries: torch.Tensor, train: torch.Tensor,
                      metric: str = "l2", *, compute_dtype=None,
                      prepared=None) -> torch.Tensor:
    """Dispatch over the metric names of :data:`METRICS` (l1 ignores
    ``compute_dtype``, as in the JAX package).  ``prepared`` is
    :func:`prepare_train` of ``train`` where the caller made it once for
    many query blocks; the values do not change."""
    m = metric.lower()
    if m not in METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {METRICS}")
    rows, t_norm = prepare_train(train, m) if prepared is None else prepared
    if m in L2_FAMILY:
        return pairwise_sq_l2(queries, rows, compute_dtype=compute_dtype,
                              t_norm=t_norm)
    if m in L1_FAMILY:
        return pairwise_l1(queries, rows)
    if m == "cosine":
        return 1.0 - _dot(_row_normalize(queries), rows, compute_dtype)
    return pairwise_dot(queries, rows, compute_dtype=compute_dtype)


def metric_values(d, metric: str = "l2"):
    """Ranking scores -> reference/sklearn metric VALUES: the l2 family
    gets ``sqrt(max(d, 0))``, every other metric's scores already are its
    values.  Works on numpy arrays and torch tensors alike."""
    if metric.lower() in L2_FAMILY:
        if isinstance(d, torch.Tensor):
            return torch.sqrt(torch.clamp_min(d, 0))
        return np.sqrt(np.maximum(d, 0))
    return d
