"""Product quantization with a certified per-subspace error bound — the
port's copy of knn_tpu/ops/pq.py, behind the coarse kernels'
``precision="pq"`` arm (K7).

The numpy functions are copied verbatim.  Training is the seeded,
deterministic k-means of knn_tpu_torch.ivf.kmeans (farthest-point init,
exact k=1 assign on the caller's device or mesh, host float64 update), one
``seed + s`` per subspace.  A row becomes ``m = ceil(d / dsub)`` bytes,
one code per subspace; the kernel scores it through a per-query lookup
table

    LUT[q, s*C + c] = q_s . cb[s, c] - ||cb[s, c]||^2 / 2

summed over the row's codes, so that ``tn - 2 qt`` (``tn = 0``) is the
kernel score ``||t^||^2 - 2 q.t^`` against the reconstruction ``t^``.
The certificate widens its threshold by

    eps = (norm_err_max + 2 sum_s ||q_s|| r_s) (1 + 2^-10)
          + 64 eps_f32 (||q||^2 + max||t||^2)

with ``r_s`` the largest per-subspace residual and ``norm_err_max`` the
largest ``| ||t||^2 - ||t^||^2 |``, both float64 from the actual rows
(:func:`pq_bound_stats`).  :func:`score_error_bound_pq_t` is the torch
twin of the JAX package's traceable ``score_error_bound_pq_device``, plus
one term of the port's own: the worst case of K7's f32 arithmetic, the
LUT prologue and the m-term sum (:func:`k7_rounding`), which the f32
slack alone stops covering past m ~ 60 subspaces.

The JAX package reads the pq geometry's defaults from two environment
switches; the port takes ``dsub`` and ``ncodes`` as arguments with the
defaults below (ROADMAP queue C).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike
from knn_tpu_torch.ops.quantize import _BOUND_HEADROOM, _F32_SLACK, _f32_up

#: the classic 8-bit PQ point (knn_tpu/analysis/widths.py:91-92): 4 dims
#: per subspace, 256 codes (one byte) per codebook; at d=128 a row is 32
#: code bytes
PQ_DSUB_DEFAULT = 4
PQ_NCODES_DEFAULT = 256


class PQResult(NamedTuple):
    """A trained product quantizer + the encoded corpus: ``codebooks`` f32
    [m, C, dsub], ``codes`` uint8 [N, m], ``dim`` the original width
    (rows and queries zero-pad to ``m * dsub``), ``stats`` the bound's
    maxima (:func:`pq_bound_stats`)."""

    codebooks: np.ndarray
    codes: np.ndarray
    dsub: int
    dim: int
    stats: dict

    @property
    def nsub(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ncodes(self) -> int:
        return int(self.codebooks.shape[1])


def _pad_dim(x: np.ndarray, width: int) -> np.ndarray:
    if x.shape[1] == width:
        return x
    out = np.zeros((x.shape[0], width), dtype=x.dtype)
    out[:, : x.shape[1]] = x
    return out


def train_pq(rows: np.ndarray, *, device: DeviceLike = None, mesh=None,
             dsub: int = 4, ncodes: int = 256, iters: int = 5, seed: int = 0,
             train_tile: Optional[int] = None) -> PQResult:
    """Train per-subspace codebooks with the seeded deterministic k-means
    (assign on ``device``, None = cuda, or on ``mesh``: not both, as
    ivf.kmeans.train_kmeans takes them) and encode ``rows``.  ``seed + s``
    seeds subspace ``s``."""
    from knn_tpu_torch.ivf.kmeans import train_kmeans

    rows = np.ascontiguousarray(np.asarray(rows, np.float32))
    n, d = rows.shape
    dsub = int(dsub)
    if dsub < 1:
        raise ValueError(f"dsub must be >= 1, got {dsub}")
    if not 2 <= int(ncodes) <= 256:
        raise ValueError(
            f"ncodes must be in [2, 256] (one uint8 code per subspace), "
            f"got {ncodes}")
    m = -(-d // dsub)
    padded = _pad_dim(rows, m * dsub)
    books, codes = [], []
    c_eff = min(int(ncodes), n)
    for s in range(m):
        sub = padded[:, s * dsub : (s + 1) * dsub]
        km = train_kmeans(sub, c_eff, device=device, mesh=mesh, iters=iters,
                          seed=seed + s, train_tile=train_tile)
        books.append(km.centroids)
        codes.append(km.assign)
    codebooks = np.stack(books).astype(np.float32)  # [m, C, dsub]
    codes = np.stack(codes, axis=1).astype(np.uint8)  # [N, m]
    stats = pq_bound_stats(codebooks, codes, rows, dsub=dsub)
    return PQResult(codebooks, codes, dsub, d, stats)


def encode_pq(rows: np.ndarray, codebooks: np.ndarray, *,
              device: DeviceLike = None, mesh=None, dsub: int,
              train_tile: Optional[int] = None) -> np.ndarray:
    """Encode new rows against trained codebooks (the same k=1 assign as
    training, per subspace, on ``device`` or ``mesh``).  Returns uint8
    [N, m].  Freshly encoded rows can exceed the hoisted ``r_s`` maxima:
    refresh the stats (:func:`pq_bound_stats`) before certifying against
    them."""
    from knn_tpu_torch.ivf.kmeans import assign_lists

    rows = np.asarray(rows, np.float32)
    m = codebooks.shape[0]
    padded = _pad_dim(rows, m * int(dsub))
    cols = []
    for s in range(m):
        sub = padded[:, s * dsub : (s + 1) * dsub]
        cols.append(assign_lists(sub, codebooks[s], device=device,
                                 mesh=mesh, train_tile=train_tile))
    return np.stack(cols, axis=1).astype(np.uint8)


def reconstruct(codebooks: np.ndarray, codes: np.ndarray, dim: int,
                dsub: int) -> np.ndarray:
    """f32 decode [N, dim] — the t^ the kernel scores against."""
    m = codebooks.shape[0]
    parts = [codebooks[s][codes[:, s]] for s in range(m)]
    return np.concatenate(parts, axis=1)[:, :dim].astype(np.float32)


def build_luts(q: np.ndarray, codebooks: np.ndarray,
               dsub: int) -> np.ndarray:
    """Host twin of the LUT prologue: [Q, m * C] f32 with
    LUT[q, s*C + c] = q_s.cb[s,c] - ||cb[s,c]||^2/2."""
    q = np.asarray(q, np.float32)
    m, c, _ = codebooks.shape
    qp = _pad_dim(q, m * int(dsub)).reshape(q.shape[0], m, dsub)
    lut = (np.einsum("qmd,mcd->qmc", qp, codebooks)
           - 0.5 * (codebooks ** 2).sum(-1)[None])
    return lut.reshape(q.shape[0], m * c).astype(np.float32)


def pq_bound_stats(codebooks: np.ndarray, codes: np.ndarray,
                   original: np.ndarray, *, dsub: int,
                   chunk: int = 65536) -> dict:
    """The db-side maxima of the PQ error bound, float64 from the actual
    residuals: ``r_sub`` [m] max_rows ||t_s - t^_s||, ``norm_err_max``
    max_rows | ||t||^2 - ||t^||^2 |, ``db_norm_max`` max_rows ||t||^2.
    Chunked so a 1M-row corpus never makes a full f64 copy."""
    original = np.asarray(original)
    m = codebooks.shape[0]
    dim = original.shape[1]
    books64 = codebooks.astype(np.float64)
    r_sub = np.zeros(m, np.float64)
    norm_err = 0.0
    nrm = 0.0
    n = original.shape[0]
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        t = _pad_dim(original[lo:hi].astype(np.float64), m * dsub)
        t_norm = (t ** 2).sum(-1)
        that_norm = np.zeros(hi - lo, np.float64)
        for s in range(m):
            t_s = t[:, s * dsub : (s + 1) * dsub]
            that_s = books64[s][codes[lo:hi, s]]
            diff = t_s - that_s
            r_sub[s] = max(r_sub[s],
                           float(np.sqrt((diff ** 2).sum(-1)).max()))
            that_norm += (that_s ** 2).sum(-1)
        norm_err = max(norm_err, float(np.abs(t_norm - that_norm).max()))
        nrm = max(nrm, float(t_norm.max()))
    return {
        "r_sub": r_sub,
        "norm_err_max": float(norm_err),
        "db_norm_max": float(nrm),
        "dsub": int(dsub),
        "dim": int(dim),
    }


def bound_consts_pq(stats: dict) -> np.ndarray:
    """[r_0 .. r_{m-1}, norm_err_max, db_norm_max] as an f32 vector (each
    rounded up) — the vector :func:`score_error_bound_pq_t` unpacks."""
    vals = [ _f32_up(float(r)) for r in stats["r_sub"] ]
    vals += [_f32_up(stats["norm_err_max"]), _f32_up(stats["db_norm_max"])]
    return np.array(vals, dtype=np.float32)


def score_error_bound_pq(q: np.ndarray, stats: dict) -> np.ndarray:
    """Host-side per-query ε [Q] (float64): a sound upper bound on
    |exact kernel-space score - PQ reconstruction score| for every db
    row."""
    q64 = np.asarray(q, np.float64)
    m = len(stats["r_sub"])
    dsub = stats["dsub"]
    qp = _pad_dim(q64, m * dsub).reshape(q64.shape[0], m, dsub)
    qs_norm = np.sqrt((qp ** 2).sum(-1))  # [Q, m]
    q_norm = (q64 ** 2).sum(-1)
    quant = stats["norm_err_max"] + 2.0 * (qs_norm
                                           * stats["r_sub"][None, :]).sum(-1)
    return (quant * _BOUND_HEADROOM
            + _F32_SLACK * (q_norm + stats["db_norm_max"]))


def k7_rounding(m: int, dsub: int) -> float:
    """The coefficient ``g`` of K7's worst-case f32 error on a real row,
    ``|s_kernel - s_pq| <= g (||q||^2 + 2 (M + norm_err_max))`` with ``s_pq
    = ||t^||^2 - 2 q.t^`` exact (csrc/binned_pq.cuh states the proof):
    gamma_{m + dsub} = n u / (1 - n u), u = 2^-24, n = m + dsub, times the
    bound headroom for the f32 evaluation of the bound itself."""
    n = (int(m) + int(dsub)) * 2.0 ** -24
    return n / (1.0 - n) * _BOUND_HEADROOM


def score_error_bound_pq_t(q: torch.Tensor, consts: torch.Tensor, *,
                           dsub: int):
    """The certificate's per-query ε for the pq arm, in f32 on ``q``'s
    device: the torch twin of :func:`score_error_bound_pq` (the JAX
    package's ``score_error_bound_pq_device``) plus K7's own f32 error,
    :func:`k7_rounding` ``x (||q||^2 + 2 (db_norm_max + norm_err_max))``,
    which the reference leaves to its f32 slack (ROADMAP queue C,
    divergence 17).  ``q`` [Q, D] f32, ``consts`` the
    :func:`bound_consts_pq` vector ([m + 2] f32).  Returns ``(q_norm [Q],
    eps [Q])``."""
    m = consts.shape[0] - 2
    d = q.shape[1]
    if d < m * dsub:
        q_pad = torch.nn.functional.pad(q, (0, m * dsub - d))
    else:
        q_pad = q[:, : m * dsub]
    qs = q_pad.reshape(q.shape[0], m, dsub)
    qs_norm = torch.sqrt((qs * qs).sum(-1))  # [Q, m]
    q_norm = (q * q).sum(-1)
    quant = consts[m] + 2.0 * (qs_norm * consts[None, :m]).sum(-1)
    eps = quant * _BOUND_HEADROOM + _F32_SLACK * (q_norm + consts[m + 1])
    eps = eps + k7_rounding(m, dsub) * (
        q_norm + 2.0 * (consts[m + 1] + consts[m]))
    return q_norm, eps
