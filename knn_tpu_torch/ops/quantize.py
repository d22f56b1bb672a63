"""Per-row symmetric int8 / int4 quantization with a certified error bound
— the port's copy of knn_tpu/ops/quantize.py, behind the coarse kernels'
``precision="int8"`` (K5) and ``precision="int4"`` (K6) arms.

The numpy functions are copied verbatim; the traceable ``jax.numpy``
ones become torch functions on the arithmetic the JAX package's compiled
programs run (``torch.round`` rounds half to even as ``jnp.round`` does;
``x / scale`` is an f32 division; ``amax / 127`` is ``amax * f32(1/127)``,
as XLA's simplifier rewrites a division by a constant inside ``jit``,
which is where the reference quantizes its queries: the kernel prologue
and the certificate), so the quantized queries are bitwise the JAX
package's.

Scheme: per row ``scale = max|x|/127`` (1.0 for zero rows) and ``values =
clip(round(x / scale), -127, 127)`` as int8; int4 uses ``max|x|/7`` and
[-7, 7], packed two per byte (:func:`pack_nibbles`).  uint8 rows (SIFT
bvecs payloads) ride byte-exact at unit scale through :func:`from_uint8`
(shift -128), so their residuals are zero.

The certificate's ε (per query, sound for every db row): with ``q =
q̂ + eq`` and ``t = t̂ + et`` in the shifted space,

    |s - ŝ| <= 2 (||q̂|| E + ||eq|| T + ||eq|| E) (1 + 2^-10)
               + 64 eps_f32 (||q||^2 + max||t||^2),
    T = max ||t̂_j||,  E = max ||et_j||,

where T, E and max||t||^2 come from the actual residuals, once, at
placement (:func:`db_bound_stats`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: headroom on the quantization term (f32 evaluation of the bound itself)
_BOUND_HEADROOM = 1.0 + 2.0 ** -10
#: f32-arithmetic slack of the int score pipeline (rescale, norms)
_F32_SLACK = 64.0 * float(np.finfo(np.float32).eps)
#: symmetric int4 magnitude: biased nibbles (v + 8) land in [1, 15]
_INT4_RANGE = 7.0
#: the reciprocals the compiled reference multiplies by (f32, exact as
#: Python floats)
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))
_RECIP_INT4 = float(np.float32(1.0) / np.float32(_INT4_RANGE))


class QuantizedRows(NamedTuple):
    """``values`` int8 [N, D]; ``scales`` f32 [N]; ``offset`` is the common
    scalar subtracted before quantization (squared L2 is translation
    invariant).  Dequantized shifted-space rows are
    ``scales[:, None] * values``."""

    values: np.ndarray
    scales: np.ndarray
    offset: float = 0.0


def quantize_rows_np(x: np.ndarray, offset: float = 0.0) -> QuantizedRows:
    """Host-side per-row symmetric int8 quantization; ``offset`` is
    subtracted first."""
    xs = np.asarray(x, dtype=np.float32) - np.float32(offset)
    amax = np.abs(xs).max(axis=-1)
    scales = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0))
    scales = scales.astype(np.float32)
    q = np.clip(np.round(xs / scales[:, None]), -127, 127).astype(np.int8)
    return QuantizedRows(q, scales, float(offset))


def _quantize_t(x: torch.Tensor, levels: float, recip: float, eager: bool):
    x = x.float()
    amax = x.abs().amax(-1)
    scaled = amax / levels if eager else amax * recip
    scales = torch.where(amax > 0, scaled, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scales[:, None]), -levels, levels)
    return q.to(torch.int8), scales


def quantize_rows(x: torch.Tensor, *, eager: bool = False):
    """Per-row symmetric int8 quantization of f32 rows ``x`` (any offset
    already applied): ``(values int8, scales f32)``.  The scale is
    ``amax * f32(1/127)``, as the reference's compiled programs compute
    it (the queries); ``eager`` divides, as its numpy and eager functions
    do, so the result is bitwise :func:`quantize_rows_np`'s (the db
    placement)."""
    return _quantize_t(x, 127.0, _RECIP_127, eager)


def dequantize(qr: QuantizedRows) -> np.ndarray:
    """f32 reconstruction in original space (offset restored)."""
    return (qr.scales[:, None].astype(np.float32)
            * qr.values.astype(np.float32)
            + np.float32(qr.offset))


def from_uint8(x: np.ndarray) -> QuantizedRows:
    """uint8 rows (bvecs payloads) as int8 at unit scale: the bytes shifted
    by -128, residuals identically zero."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        raise ValueError(f"from_uint8 expects uint8 rows, got {x.dtype}")
    vals = (x.astype(np.int16) - 128).astype(np.int8)
    scales = np.ones(x.shape[0], dtype=np.float32)
    return QuantizedRows(vals, scales, 128.0)


def quantize_rows_int4_np(x: np.ndarray, offset: float = 0.0) -> QuantizedRows:
    """Host-side per-row symmetric 4-bit quantization: ``scale =
    max|x|/7``, values in [-7, 7] stored unpacked as int8 (the bound
    machinery never sees nibbles)."""
    xs = np.asarray(x, dtype=np.float32) - np.float32(offset)
    amax = np.abs(xs).max(axis=-1)
    scales = np.where(amax > 0, amax / np.float32(_INT4_RANGE),
                      np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(xs / scales[:, None]), -7, 7).astype(np.int8)
    return QuantizedRows(q, scales, float(offset))


def quantize_rows_int4(x: torch.Tensor, *, eager: bool = False):
    """Torch twin of :func:`quantize_rows_int4_np` (offset already
    applied): ``(values int8 in [-7, 7], scales f32)``, the scale
    multiplied or divided as :func:`quantize_rows` computes it.  Queries
    of the int4 arm stay int8 (:func:`quantize_rows`)."""
    return _quantize_t(x, _INT4_RANGE, _RECIP_INT4, eager)


def pack_nibbles(values: np.ndarray, dim_chunk: int = 128) -> np.ndarray:
    """Pack int4 row values (int8 in [-7, 7], dim a multiple of
    ``dim_chunk``) two per byte, chunk-paired: packed byte ``c*64 + j``
    holds dim ``c*128 + j`` in its low nibble and dim ``c*128 + 64 + j``
    in its high nibble, both biased +8.  Returns uint8 [N, D/2]."""
    v = np.asarray(values)
    n, d = v.shape
    if d % dim_chunk:
        raise ValueError(f"pack_nibbles needs dim % {dim_chunk} == 0, got {d}")
    half = dim_chunk // 2
    r = v.reshape(n, d // dim_chunk, 2, half).astype(np.int16)
    lo, hi = r[:, :, 0, :] + 8, r[:, :, 1, :] + 8
    return (lo | (hi << 4)).astype(np.uint8).reshape(n, d // 2)


def pack_nibbles_t(values: torch.Tensor, dim_chunk: int = 128) -> torch.Tensor:
    """Torch twin of :func:`pack_nibbles` (the quantize-on-the-fly path)."""
    n, d = values.shape
    if d % dim_chunk:
        raise ValueError(f"pack_nibbles needs dim % {dim_chunk} == 0, got {d}")
    half = dim_chunk // 2
    r = values.reshape(n, d // dim_chunk, 2, half).to(torch.int32)
    lo, hi = r[:, :, 0, :] + 8, r[:, :, 1, :] + 8
    return (lo | (hi << 4)).to(torch.uint8).reshape(n, d // 2)


def unpack_nibbles(packed: np.ndarray, dim: int,
                   dim_chunk: int = 128) -> np.ndarray:
    """Host-side inverse of :func:`pack_nibbles`.  Returns int8 [N, dim]."""
    p = np.asarray(packed)
    n = p.shape[0]
    half = dim_chunk // 2
    r = p.reshape(n, dim // dim_chunk, half)
    lo = (r & 0xF).astype(np.int16) - 8
    hi = (r >> 4).astype(np.int16) - 8
    return np.stack([lo, hi], axis=2).reshape(n, dim).astype(np.int8)


def unpack_nibbles_t(packed: torch.Tensor, dim_chunk: int = 128) -> torch.Tensor:
    """Torch inverse of :func:`pack_nibbles` — the int4 plain versions'
    unpack (``pallas_knn._unpack_nibble_chunk`` over every chunk): uint8
    [N, D/2] -> int8 [N, D]."""
    n, half_d = packed.shape
    r = packed.reshape(n, -1, dim_chunk // 2).to(torch.int16)
    lo = (r & 0xF) - 8
    hi = (r >> 4) - 8
    return torch.cat([lo, hi], dim=2).reshape(n, 2 * half_d).to(torch.int8)


def _f32_up(v: float) -> np.float32:
    """Round a float64 statistic up to f32 so the device-side bound can
    never shrink through the cast."""
    f = np.float32(v)
    if float(f) < v:
        f = np.nextafter(f, np.float32(np.inf))
    return f


def db_bound_stats(qr: QuantizedRows, original: np.ndarray, *,
                   chunk: int = 65536) -> dict:
    """The db-side maxima of the bound in float64, from the actual
    residuals: ``t2hat_max`` = max ||t̂||, ``et2_max`` = max ||t̂ - t'||
    (0.0 for :func:`from_uint8` payloads), ``db_norm_max`` = max ||t'||^2,
    with t' = original - offset.  Chunked: a 1M-row database never makes
    a full f64 copy."""
    t2hat = 0.0
    et2 = 0.0
    nrm = 0.0
    n = qr.values.shape[0]
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        t_sh = original[lo:hi].astype(np.float64) - qr.offset
        t_hat = (qr.scales[lo:hi, None].astype(np.float64)
                 * qr.values[lo:hi].astype(np.float64))
        t2hat = max(t2hat, float(np.sqrt((t_hat ** 2).sum(-1)).max()))
        et2 = max(et2, float(np.sqrt(((t_hat - t_sh) ** 2).sum(-1)).max()))
        nrm = max(nrm, float((t_sh ** 2).sum(-1).max()))
    return {
        "t2hat_max": float(t2hat),
        "et2_max": float(et2),
        "db_norm_max": float(nrm),
        "dim": int(qr.values.shape[1]),
    }


def db_bound_stats_t(values: torch.Tensor, scales: torch.Tensor,
                     original: torch.Tensor, offset: float, *,
                     chunk: int = 65536):
    """Torch twin of :func:`db_bound_stats` on the rows' device, in
    float64 and chunked as it is (``values`` int8 [N, D] unpacked,
    ``original`` the f32 rows), with the rows' f32 shifted-space squared
    norms (float64 sums cast to f32, as the reference's placements
    compute them) as a second result: ``(stats, norms [N])``."""
    n = values.shape[0]
    norms = torch.empty(n, dtype=torch.float32, device=values.device)
    maxima = torch.zeros(3, dtype=torch.float64, device=values.device)
    for lo in range(0, n, chunk):
        rows = slice(lo, lo + chunk)
        t_sh = original[rows].double() - offset
        t_hat = scales[rows, None].double() * values[rows].double()
        nrm = (t_sh * t_sh).sum(-1)
        norms[lo : lo + chunk] = nrm.float()
        maxima = torch.maximum(maxima, torch.stack([
            (t_hat * t_hat).sum(-1).sqrt().max(),
            ((t_hat - t_sh) ** 2).sum(-1).sqrt().max(), nrm.max()]))
    t2hat, et2, nrm = maxima.tolist()
    return {"t2hat_max": t2hat, "et2_max": et2, "db_norm_max": nrm,
            "dim": int(values.shape[1])}, norms


def bound_consts(stats: dict) -> np.ndarray:
    """[db_norm_max, t2hat_max, et2_max] as f32, each rounded up — the
    vector :func:`score_error_bound_device` unpacks."""
    return np.array(
        [_f32_up(stats["db_norm_max"]), _f32_up(stats["t2hat_max"]),
         _f32_up(stats["et2_max"])],
        dtype=np.float32,
    )


def score_error_bound(q: np.ndarray, stats: dict, *,
                      offset: float = 0.0) -> np.ndarray:
    """Host-side per-query ε [Q] (float64): a sound bound on |f32 kernel
    score - int8 reconstructed score| for every db row."""
    qi, sq = quantize_rows_np(q, offset=offset)[:2]
    q_sh = np.asarray(q, dtype=np.float64) - offset
    q_hat = sq[:, None].astype(np.float64) * qi.astype(np.float64)
    eq2 = np.sqrt(((q_sh - q_hat) ** 2).sum(-1))
    qhat2 = np.sqrt((q_hat ** 2).sum(-1))
    q_norm = (q_sh ** 2).sum(-1)
    quant = 2.0 * (qhat2 * stats["et2_max"]
                   + eq2 * stats["t2hat_max"]
                   + eq2 * stats["et2_max"])
    return (quant * _BOUND_HEADROOM
            + _F32_SLACK * (q_norm + stats["db_norm_max"]))


def score_error_bound_device(q_shifted: torch.Tensor, consts: torch.Tensor):
    """Torch twin of :func:`score_error_bound` for the certificate:
    ``q_shifted`` [Q, D] f32 (offset subtracted), ``consts`` the
    :func:`bound_consts` vector on the same device.  Returns ``(q_norm
    [Q], eps [Q])``: the shifted-space query norms and the per-query
    threshold widening.  The query re-quantization is the kernel
    prologue's (:func:`quantize_rows`), so the residuals are the kernel's."""
    qi, sq = quantize_rows(q_shifted)
    q_hat = sq[:, None] * qi.float()
    eq = q_shifted - q_hat
    eq2 = torch.sqrt((eq * eq).sum(-1))
    qhat2 = torch.sqrt((q_hat * q_hat).sum(-1))
    q_norm = (q_shifted * q_shifted).sum(-1)
    db_norm_max, t2hat_max, et2_max = consts[0], consts[1], consts[2]
    quant = 2.0 * (qhat2 * et2_max + eq2 * t2hat_max + eq2 * et2_max)
    eps = quant * _BOUND_HEADROOM + _F32_SLACK * (q_norm + db_norm_max)
    return q_norm, eps
