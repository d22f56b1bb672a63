"""The self-certifying coarse pass — the port of knn_tpu/ops/pallas_knn.py.

One database pass emits, per 128-wide bin, the ``SURVIVORS`` = 2 smallest
kernel scores with their row indices plus the bin's *exclusion bound*
(the third smallest score): no row outside the candidates can score below
its bin's bound.  The kernel score is squared L2 minus the
per-query constant ``||q||^2``: ``s = ||t||^2 - 2 q.t``.

What runs where:

- K1, the fused distance + per-bin select, is a hand-written CUDA C++
  kernel for Hopper (``knn_tpu_torch/csrc/binned_coarse.cu``, wrapper
  :func:`binned_select`), replacing the TPU kernel
  ``pallas_knn._bin_candidates`` (bf16x3 arm, grouped binning,
  query-major grid).  :func:`binned_select_plain` is the same function in
  plain PyTorch; the wrapper runs it only for tensors on the CPU.
- Everything else is plain PyTorch, as in the JAX package's XLA code:
  the prologue (:func:`prepare_db`: dim padding to 128, ``PAD_VAL`` row
  padding, the bf16 hi/lo split, the norm rows), the exact top-(m+2) by
  stable sort with its exclusion value, the pad-row mask, the
  direct-difference f32 rescore (:func:`local_select_rescore`).

A bin is defined by ``tile_n=16384`` and two survivors whatever the CUDA
block shape is: candidate width, ``m`` and the fallback rate depend on
them.  Grouped binning: bin b of a db tile is lane b of every 128-row
group of the tile (``tile_n // 128`` members strided 128 apart).

Ported so far: precision ``bf16x3``, binning ``grouped``, grid
``query_major``, kernel ``tiled``, final select ``exact``, two survivors
per bin and the 128-lane bin width.  The other values the JAX package
accepts are refused by name.  The JAX package's ``block_q`` only
re-blocks query rows of its TPU grid; the CUDA kernel picks its own query
block, so the port takes no such knob.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.ops import _cuda
from knn_tpu_torch.ops.topk import I32MAX, topk_pairs

#: bin width — the lane count; SURVIVORS candidates + one bound per bin
BIN_W = 128
#: database rows per tile: 128 bins of 128 members at 1M rows
TILE_N = 16384
#: dims are zero-padded to a multiple of this and reduced chunk by chunk
DIM_CHUNK = 128
#: candidates kept per bin (the JAX package's grouped-binning default)
SURVIVORS = 2
#: row-padding fill: pad rows score ~1e36, never candidates, never
#: deflating a bin bound; 1.5e17 keeps ||pad||^2 finite in f32
PAD_VAL = 1.5e17
#: relative slack of the direct-difference f32 rescore distances
RANK_SLACK = 2.0 ** -18

#: the JAX package's knob domains, and the values this port runs
PRECISIONS = ("bf16x3", "bf16x3f", "int8", "int4", "pq", "highest",
              "default")
BINNINGS = ("grouped", "lane")
GRID_ORDERS = ("query_major", "db_major")
KERNELS = ("tiled", "streaming", "fused")
PORTED = {"precision": ("bf16x3",), "binning": ("grouped",),
          "grid_order": ("query_major",), "kernel": ("tiled",),
          "final_select": ("exact",), "bin_w": (BIN_W,),
          "survivors": (SURVIVORS,)}

#: K1 launches one CTA row per 32 queries; CUDA caps the grid's y extent
_MAX_KERNEL_QUERIES = 65535 * 32


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def check_knobs(*, precision: str = "bf16x3", binning: str = "grouped",
                grid_order: str = "query_major", kernel: str = "tiled",
                final_select: str = "exact", bin_w: Optional[int] = None,
                survivors: Optional[int] = None) -> None:
    """The JAX package's knob refusals (pallas_knn.py:922-956,
    1386-1398), then the port's own: every value that is valid there but
    not ported here is refused by name.  ``bin_w`` and ``survivors``
    left at None take their one ported value."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if binning not in BINNINGS:
        raise ValueError(f"binning {binning!r} not in {BINNINGS}")
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"grid_order {grid_order!r} not in {GRID_ORDERS}")
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    if final_select not in ("exact", "approx"):
        raise ValueError(
            f"final_select {final_select!r} not in ('exact', 'approx')")
    if kernel in ("streaming", "fused") and grid_order != "query_major":
        raise ValueError(
            f"kernel={kernel!r} streams the db inside one launch; "
            f"grid_order='db_major' does not apply")
    if kernel == "fused" and binning != "grouped":
        raise ValueError(
            "kernel='fused' requires binning='grouped' (the early-out "
            "carry is per-lane)")
    if kernel == "fused" and precision == "pq":
        raise ValueError(
            "kernel='fused' is not certified for precision='pq'; use "
            "'streaming' or 'tiled'")
    if kernel == "fused" and final_select == "approx":
        raise ValueError(
            "kernel='fused' requires final_select='exact' (the "
            "early-out's bitwise contract is an exact-boundary argument)")
    given = {"precision": precision, "binning": binning,
             "grid_order": grid_order, "kernel": kernel,
             "final_select": final_select,
             "bin_w": BIN_W if bin_w is None else bin_w,
             "survivors": SURVIVORS if survivors is None else survivors}
    for knob, value in given.items():
        if value not in PORTED[knob]:
            raise ValueError(
                f"{knob}={value!r} is not ported to CUDA yet; the port "
                f"runs {knob} in {PORTED[knob]}")


def _geometry(tile_n: int) -> Tuple[int, int, int, int]:
    """(n_bins, survivors, out_w, bound_w) of a db tile in grouped binning:
    128 bins (one per lane), SURVIVORS candidates per bin, so
    ``out_w = SURVIVORS * 128`` candidate lanes and ``bound_w = 128`` bound
    lanes per tile."""
    if tile_n % BIN_W:
        raise ValueError(f"tile_n={tile_n} must be a multiple of bin_w={BIN_W}")
    return BIN_W, SURVIVORS, SURVIVORS * BIN_W, BIN_W


def effective_tile(rows: int, tile_n: int, min_width: int) -> int:
    """The db tile the kernel will run: capped to the (padded) db, then
    halved until the total candidate width ``n_tiles * out_w`` covers
    ``min_width`` (= m+2 for certified callers) or the tile bottoms out
    at ``BIN_W``."""
    _, _, out_w, _ = _geometry(tile_n)
    eff = min(tile_n, max(BIN_W, _round_up(rows, BIN_W)))
    while eff > BIN_W and -(-rows // eff) * out_w < min_width:
        eff = max(BIN_W, _round_up(eff // 2, BIN_W))
    return eff


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 parts, both rounded to nearest even:
    ``hi = bf16(x)``, ``lo = bf16(x - f32(hi))``."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def pad_queries(queries: torch.Tensor) -> torch.Tensor:
    """f32 queries with dims zero-padded to a DIM_CHUNK multiple (zero
    dims leave every score unchanged)."""
    q = queries.float()
    dpad = _round_up(q.shape[1], DIM_CHUNK) - q.shape[1]
    if dpad:
        q = torch.nn.functional.pad(q, (0, dpad))
    return q.contiguous()


def prepare_db(db: torch.Tensor, tile_n: int):
    """The bf16x3 prologue of ``_bin_candidates`` for the db side:
    ``PAD_VAL`` rows up to a ``tile_n`` multiple, zero dims up to a
    DIM_CHUNK multiple, the hi/lo split, and the f32 row norms of the
    padded rows as ``[8, Np]`` rows (row 0 is read; an expanded view, as
    the TPU kernel's sublane-broadcast block).  Returns (th, tl, tnorm)."""
    n, d = db.shape
    x = db.float()
    rpad = _round_up(max(n, 1), tile_n) - n
    if rpad:
        x = torch.cat([x, torch.full((rpad, d), PAD_VAL, dtype=torch.float32,
                                     device=x.device)])
    dpad = _round_up(d, DIM_CHUNK) - d
    if dpad:
        x = torch.nn.functional.pad(x, (0, dpad))
    th, tl = split_bf16(x)
    tnorm = (x * x).sum(-1)
    return th.contiguous(), tl.contiguous(), tnorm[None, :].expand(8, -1)


def binned_select_plain(q, th, tl, tnorm, *, tile_n: int):
    """K1 in plain PyTorch, tile by tile: an f32 matmul of the upcast bf16
    parts summed per 128-dim chunk (``qh.th + qh.tl + ql.th``), then
    ``s = tnorm[0] - 2 qt`` reshaped to [Q, G, 128], a stable sort over
    the group axis, the first SURVIVORS values and groups, and the next
    value as the bin bound — which is what the strict-`<` insertion
    network of the kernel keeps."""
    n_q, dp = q.shape
    n_tiles = th.shape[0] // tile_n
    n_groups = tile_n // BIN_W
    dev = q.device
    qh, ql = (p.float() for p in split_bf16(q))
    lane = torch.arange(BIN_W, device=dev)
    cds, cis, bds = [], [], []
    for ti in range(n_tiles):
        rows = slice(ti * tile_n, (ti + 1) * tile_n)
        qt = None
        for c in range(0, dp, DIM_CHUNK):
            cols = slice(c, c + DIM_CHUNK)
            h = th[rows, cols].float()
            lo = tl[rows, cols].float()
            part = (qh[:, cols] @ h.T + qh[:, cols] @ lo.T) + ql[:, cols] @ h.T
            qt = part if qt is None else qt + part
        s = (tnorm[0, rows][None, :] - 2.0 * qt).view(n_q, n_groups, BIN_W)
        if n_groups < SURVIVORS + 1:
            fill = torch.full((n_q, SURVIVORS + 1 - n_groups, BIN_W),
                              torch.inf, device=dev)
            s = torch.cat([s, fill], dim=1)
        vals, grp = torch.sort(s, dim=1, stable=True)
        cd = vals[:, :SURVIVORS]
        idx = ti * tile_n + grp[:, :SURVIVORS] * BIN_W + lane
        ci = torch.where(torch.isfinite(cd), idx, I32MAX).to(torch.int32)
        cds.append(cd.reshape(n_q, SURVIVORS * BIN_W))
        cis.append(ci.reshape(n_q, SURVIVORS * BIN_W))
        bds.append(vals[:, SURVIVORS])
    return torch.cat(cds, 1), torch.cat(cis, 1), torch.cat(bds, 1)


def _check_operands(q, th, tl, tnorm, tile_n: int) -> None:
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("q must be a contiguous [Q, Dp] float32 tensor")
    if th.dtype != torch.bfloat16 or tl.dtype != torch.bfloat16:
        raise ValueError("th, tl must be bfloat16")
    if th.shape != tl.shape or th.dim() != 2:
        raise ValueError(f"th {tuple(th.shape)} / tl {tuple(tl.shape)} mismatch")
    if not (th.is_contiguous() and tl.is_contiguous()):
        raise ValueError("th, tl must be contiguous")
    n_p, dp = th.shape
    if q.shape[1] != dp or dp % DIM_CHUNK:
        raise ValueError(
            f"q dims {q.shape[1]} vs db dims {dp}: both must match and be a "
            f"multiple of {DIM_CHUNK}")
    if tile_n % BIN_W or tile_n <= 0 or n_p % tile_n or n_p == 0:
        raise ValueError(
            f"db rows {n_p} must be a nonzero multiple of tile_n={tile_n}, "
            f"itself a multiple of {BIN_W}")
    if n_p >= 2 ** 31:
        raise ValueError("db rows must fit int32 indices")
    if tnorm.dtype != torch.float32 or tuple(tnorm.shape) != (8, n_p) \
            or tnorm.stride(1) != 1:
        raise ValueError("tnorm must be [8, Np] float32 with unit row stride")
    devs = {t.device for t in (q, th, tl, tnorm)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _k1_entry():
    """K1's C entry (``binned_select_bf16x3`` in csrc/binned_coarse.cu),
    built and loaded at first use, with its ctypes signature."""
    fn = _cuda.load("binned_coarse").binned_select_bf16x3
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binned_select(q, th, tl, tnorm, *, tile_n: int):
    """K1's wrapper: ``(cd [Q, T*256] f32, ci [Q, T*256] i32,
    bounds [Q, T*128] f32)`` from ``q [Q, Dp] f32``, the db parts
    ``th, tl [Np, Dp] bf16`` and ``tnorm [8, Np] f32``.

    On a CUDA tensor it launches the kernel (built from
    ``csrc/binned_coarse.cu`` at first use) on the current stream, or
    raises; on a CPU tensor it runs :func:`binned_select_plain`.
    ``binned_select.launches`` counts kernel launches."""
    _check_operands(q, th, tl, tnorm, tile_n)
    if q.device.type == "cpu":
        return binned_select_plain(q, th, tl, tnorm, tile_n=tile_n)
    if q.device.type != "cuda":
        raise ValueError(f"binned_select runs on cuda or cpu, not {q.device}")
    n_q, dp = q.shape
    if n_q > _MAX_KERNEL_QUERIES:
        raise ValueError(
            f"{n_q} queries exceed one launch's {_MAX_KERNEL_QUERIES} (the "
            f"grid's y extent); run them in batches (batch_size)")
    n_tiles = th.shape[0] // tile_n
    cd = torch.empty((n_q, n_tiles * SURVIVORS * BIN_W), dtype=torch.float32,
                     device=q.device)
    ci = torch.empty(cd.shape, dtype=torch.int32, device=q.device)
    bounds = torch.empty((n_q, n_tiles * BIN_W), dtype=torch.float32,
                         device=q.device)
    for t in (q, th, tl, tnorm):
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    fn = _k1_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), th.data_ptr(), tl.data_ptr(), tnorm.data_ptr(),
                cd.data_ptr(), ci.data_ptr(), bounds.data_ptr(),
                n_q, dp, n_tiles, tile_n, stream)
    if rc != 0:
        raise RuntimeError(
            f"binned_select_bf16x3 launch failed: cudaError {rc}")
    binned_select.launches += 1
    return cd, ci, bounds


binned_select.launches = 0


def _bin_candidates(queries: torch.Tensor, db: Optional[torch.Tensor], *,
                    tile_n: int,
                    db_parts=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel launch on padded shapes (the bf16x3 arm of the JAX
    package's ``_bin_candidates``).  ``db_parts=(th, tl, tnorm)`` plugs in
    a placement's prepared parts, padded to ``round_up(N, tile_n)`` rows;
    None prepares them from ``db`` here.  Returns cd, ci, bounds for the
    query rows given (the JAX kernel's query padding never leaves it)."""
    th, tl, tnorm = db_parts if db_parts is not None else prepare_db(db, tile_n)
    return binned_select(pad_queries(queries), th, tl, tnorm, tile_n=tile_n)


def local_coarse_candidates(q, t, m: int, *, tile_n: int = TILE_N,
                            bin_w: Optional[int] = None,
                            survivors: Optional[int] = None,
                            precision: str = "bf16x3",
                            binning: str = "grouped",
                            grid_order: str = "query_major",
                            kernel: str = "tiled",
                            final_select: str = "exact", db_parts=None):
    """Stage 1: resolve the effective tile and run the coarse pass.
    Returns ``(cd [Q, W], ci [Q, W], bounds [Q, T*128])``."""
    check_knobs(precision=precision, binning=binning, grid_order=grid_order,
                kernel=kernel, final_select=final_select, bin_w=bin_w,
                survivors=survivors)
    eff_tile = effective_tile(t.shape[0], tile_n, m + 2)
    if db_parts is not None and db_parts[0].shape[0] != _round_up(t.shape[0], eff_tile):
        raise ValueError(
            f"db_parts hold {db_parts[0].shape[0]} rows; the {eff_tile}-row "
            f"tile needs {_round_up(t.shape[0], eff_tile)}")
    return _bin_candidates(q, t, tile_n=eff_tile, db_parts=db_parts)


def local_select_rescore(q, t, cd, ci, bounds, m: int, *,
                         final_select: str = "exact"):
    """Stage 2: exact top-(m+2) over the packed candidates by kernel score
    (stable sort: ties to the lower position, ``lax.top_k``'s order), the
    exclusion value, the pad-row mask, and the direct-difference f32
    rescore ordered lexicographically by (distance, index).  Returns
    ``d32 [Q, m+1]``, ``idx [Q, m+1]`` (int64, sentinel int32 max) and
    ``lb [Q]``: every row not among the candidates has kernel score >= lb."""
    w = cd.shape[1]
    if m + 2 > w:
        raise ValueError(
            f"pallas selector: m+2={m + 2} exceeds {w} bin survivors on a "
            f"{t.shape[0]}-row shard; lower margin or tile_n")
    check_knobs(final_select=final_select)
    vals, sel = torch.sort(cd, dim=-1, stable=True)
    lidx = torch.gather(ci, -1, sel[:, : m + 1]).long()
    lb = torch.minimum(bounds.amin(-1), vals[:, m + 1])
    # kernel-padding rows carry real-looking indices in [rows, padded):
    # mask them to the sentinel BEFORE the rescore gather
    valid = lidx < t.shape[0]
    lidx = torch.where(valid, lidx, I32MAX)
    safe = torch.clamp(lidx, 0, t.shape[0] - 1)
    diff = q.float()[:, None, :] - t[safe].float()
    d32 = torch.where(valid, (diff * diff).sum(-1), torch.inf)
    d32, lidx = topk_pairs(d32, lidx, m + 1)
    return d32, lidx, lb


def local_certified_candidates(q, t, m: int, *, final_select: str = "exact",
                               db_parts=None, **knobs):
    """The whole device-side certified coarse pass against one db:
    :func:`local_coarse_candidates` then :func:`local_select_rescore`.
    Returns ``(d32 [Q, m+1], idx [Q, m+1], lb [Q])``."""
    cd, ci, bounds = local_coarse_candidates(
        q, t, m, final_select=final_select, db_parts=db_parts, **knobs)
    return local_select_rescore(q, t, cd, ci, bounds, m,
                                final_select=final_select)


def kernel_tolerance(queries_np: np.ndarray, db_np: np.ndarray, *,
                     db_norm_max: Optional[float] = None,
                     precision: str = "bf16x3",
                     q_norm: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-query bound on |kernel score - exact score|:

    - "highest": 4x certification_tolerance (= 32 eps_f32 (||q||^2 +
      max||t||^2));
    - "bf16x3": the dropped ql.tl term and the low-part rounding are each
      <= 2^-17 (||q||^2 + max||t||^2)/2; 2^-14 gives ~8x headroom."""
    from knn_tpu_torch.ops.certified import certification_tolerance

    if q_norm is None:
        q_norm = (queries_np.astype(np.float64) ** 2).sum(-1)
    if db_norm_max is None:
        db_norm_max = float((db_np.astype(np.float64) ** 2).sum(-1).max())
    base = 4.0 * certification_tolerance(
        queries_np, db_np, db_norm_max=db_norm_max, q_norm=q_norm)
    if precision == "bf16x3":
        return np.maximum(base, 2.0 ** -14 * (q_norm + db_norm_max))
    if precision == "highest":
        return base
    raise ValueError(
        f"precision {precision!r} has no tolerance model in the port yet; "
        f"use 'bf16x3' or 'highest'")
