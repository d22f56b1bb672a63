"""The self-certifying coarse pass — the port of knn_tpu/ops/pallas_knn.py.

One database pass emits, per bin, the ``survivors`` smallest kernel scores
with their row indices plus the bin's *exclusion bound* (the next smallest
score): no row outside the candidates can score below its bin's bound.
The kernel score is squared L2 minus the per-query constant ``||q||^2``:
``s = ||t||^2 - 2 q.t`` (for pq, against the row's reconstruction).

What runs where:

- The tiled kernels (``kernel="tiled"``) are entries of
  ``knn_tpu_torch/csrc/binned_coarse.cu`` (wrapper :func:`binned_select`),
  replacing the TPU kernel ``pallas_knn._bin_candidates``: K1 (bf16x3),
  K4 (bf16x3f), K2 (highest), K3 (default), K5 / K6 (int8, int4), K7 (pq),
  each in the query-major grid or the db-major one (K9,
  ``grid_order="db_major"``, bitwise the same outputs), and each in grouped
  or lane binning (K8, ``binning="lane"``).  :func:`binned_select_plain`
  is the same function in plain PyTorch; every wrapper runs it only for
  tensors on the CPU.
- The db-streaming kernels (``kernel="streaming"`` and ``"fused"``) of
  every arm are entries of ``knn_tpu_torch/csrc/binned_stream.cu``
  (wrappers :func:`stream_select`, :func:`fused_select`), replacing the
  TPU kernel ``pallas_knn._stream_call``: K10 / K11 for bf16x3.  A
  streaming entry computes its tiled entry's function bitwise, in either
  binning; a fused one (grouped binning, never pq) adds the early-out,
  which pads skipped tiles (plain version :func:`fused_select_plain`).
- The arms' arithmetic (``csrc/binned_select.cuh``): the f32 family sums
  each 128-dim chunk in its own accumulator and adds the chunks in f32,
  the TPU body's order — on the tensor cores (``csrc/binned_mma.cuh``, one
  mainloop for every entry but pq's; :func:`mma_probe` and
  :func:`dmma_probe` run one of its k-steps alone) bf16x3 ``qh.th +
  (qh.tl + ql.th)`` in two accumulators, bf16x3f the same products in
  one, default the one bf16 product ``qh.th`` in one, highest the exact
  products of the f32 values summed in f64 per chunk on the FP64 tensor
  cores; the int arms an exact int32 dot on the s8 tensor cores and one
  f32 rescale ``(f32(dot) * qsc) * ts``, held bitwise against their plain
  versions; pq
  (``csrc/binned_pq.cuh``) the sum of the row's LUT entries, one subspace
  after another in f32 (bitwise its plain version too).  Every wrapper
  takes the arm as ``arm`` and checks that the operands are that arm's
  (the f32 family's operands do not tell bf16x3 from bf16x3f).
- Everything else is plain PyTorch, as in the JAX package's XLA code:
  the prologues (:func:`prepare_db`: dim padding to 128, ``PAD_VAL`` row
  padding, the bf16 hi/lo split, the norm rows; :func:`prepare_db_f32`
  for highest; :func:`quantize_queries`, :func:`prepare_db_quant`,
  :func:`prepare_db_int` for the int arms; :func:`pq_luts` and
  :func:`prepare_db_pq` for pq), the final select with its exclusion
  value (exact top-(m+2) by stable sort, which ``final_select="approx"``
  runs too), the pad-row mask, the direct-difference f32
  rescore (:func:`local_select_rescore`).

A bin is defined by the tile, the binning, ``bin_w`` and ``survivors``
whatever the CUDA block shape is: candidate width, ``m`` and the fallback
rate depend on them (:func:`_geometry`, :func:`effective_tile`, the JAX
package's formulas).  Grouped binning: bin b of a db tile is lane b of
every 128-row group of the tile (``tile_n // 128`` members strided 128
apart), ``survivors`` of them (default 2, capped at MAX_SURVIVORS) by the
insertion network; ``bin_w`` only sets the tile's granularity there.
Lane binning: bin b is tile rows ``b*bin_w .. (b+1)*bin_w - 1``,
``survivors`` of them by repeated min / first-argmin.

Ported: every precision, binning, grid, kernel and final select of the
JAX package, at every ``survivors`` and ``bin_w`` either binning takes.
The JAX package's ``block_q`` only re-blocks query rows of its TPU grid;
the CUDA kernel picks its own query block, so the port takes no such knob.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.ops import _cuda
from knn_tpu_torch.ops.quantize import (db_bound_stats, pack_nibbles_t,
                                        quantize_rows, quantize_rows_int4,
                                        quantize_rows_int4_np,
                                        quantize_rows_np, score_error_bound,
                                        unpack_nibbles_t)
from knn_tpu_torch.ops.topk import I32MAX, topk_pairs

#: bin width — the lane count; SURVIVORS candidates + one bound per bin
BIN_W = 128
#: database rows per tile: 128 bins of 128 members at 1M rows
TILE_N = 16384
#: dims are zero-padded to a multiple of this and reduced chunk by chunk
DIM_CHUNK = 128
#: candidates kept per bin (the JAX package's grouped-binning default)
SURVIVORS = 2
#: the survivors cap of both binnings (pallas_knn.py:136)
MAX_SURVIVORS = 8
#: row-padding fill: pad rows score ~1e36, never candidates, never
#: deflating a bin bound; 1.5e17 keeps ||pad||^2 finite in f32
PAD_VAL = 1.5e17
#: relative slack of the direct-difference f32 rescore distances
RANK_SLACK = 2.0 ** -18

#: f32 unit roundoff
U32 = 2.0 ** -24
#: products of one tensor-core k-step of the bf16x3 kernels (mma m16n8k16)
MMA_K = 16
#: the header's model of one such step (csrc/binned_mma.cuh): it errs by
#: at most MMA_KAPPA u (|acc| + sum |p|) -- blocks of >= 8 exact products
#: plus the accumulator, aligned to the largest and truncated to 24 bits,
#: each block's sum normalised by truncation: 2 blocks x (2 x 9 + 2) u
MMA_KAPPA = 40
#: products of one FP64 tensor-core k-step of the highest kernels (mma
#: m16n8k8); the header's model of such a step: every f64 add rounds to
#: nearest, in any order, so it errs by at most DMMA_K 2^-53 (|acc| + sum |p|)
DMMA_K = 8
#: f64 unit roundoff
U64 = 2.0 ** -53
#: the bf16 split's error in s per unit of (||q||^2 + M): q.t - (qh.th +
#: qh.tl + ql.th) <= 3 2^-16 (1 + 2^-7) |q.t| per dim, doubled in s,
#: sum |q_i t_i| <= (||q||^2 + M) / 2
SPLIT_SCALE = 3 * 2.0 ** -16 * (1 + 2.0 ** -7)
#: the rest of the f32 arithmetic the certificate's slack covers, per unit
#: of (||q||^2 + M): the f32 row and query norms (tree sums, each <= (1 +
#: log2 Dp) u ||x||^2), the rounding of s = tn - 2 qt, the certificate's
#: own f32 adds -- the budget the highest arm keeps for the same terms
HEADROOM_SCALE = 64 * U32


def accumulation_coefficient(arm: str, nd: int) -> float:
    """``b`` such that the coarse kernel of f32-family arm ``arm`` sums
    ``qt`` over ``nd`` 128-dim chunks within ``b u P`` of the exact sum of
    its products, ``P`` = the sum of their magnitudes (proofs in
    csrc/binned_mma.cuh and csrc/binned_select.cuh):

    - bf16x3 (K1, K10, K11 on tensor cores): per chunk 8 k-steps of the
      header's model into two accumulators (qh.th; qh.tl + ql.th), 8
      MMA_KAPPA u P_c, their one f32 add and the nd - 1 chunk adds;
    - bf16x3f (K4 on tensor cores): per chunk 24 k-steps (8 of each
      product) into one accumulator, 24 MMA_KAPPA u P_c, and the nd - 1
      chunk adds;
    - default (K3 on tensor cores): per chunk 8 k-steps of qh.th into one
      accumulator, 8 MMA_KAPPA u P_c, and the nd - 1 chunk adds (P over
      the bf16 values' products: the one pass's rounding of q and t is
      the arm's definition);
    - highest (K2 on the FP64 tensor cores): exact products summed in f64
      per chunk, 16 k-steps of DMMA_K (the header's step model: <= 128
      2^-53 P_c a chunk), one rounding to f32 per chunk, the chunk adds."""
    if arm == "bf16x3":
        return (DIM_CHUNK // MMA_K * MMA_KAPPA + nd) * (1 + 2.0 ** -7)
    if arm == "bf16x3f":
        return (3 * DIM_CHUNK // MMA_K * MMA_KAPPA + nd - 1) * (1 + 2.0 ** -7)
    if arm == "default":
        return (DIM_CHUNK // MMA_K * MMA_KAPPA + nd - 1) * (1 + 2.0 ** -7)
    if arm == "highest":
        return nd * (1 + 2.0 ** -20)
    raise ValueError(f"arm {arm!r} has no accumulation bound")


def bf16_tolerance_scale(arm: str, nd: int) -> float:
    """The certificate's slack for the bf16x3 / bf16x3f arms per unit of
    ``(||q||^2 + max||t||^2)`` at ``nd`` 128-dim chunks: the bf16 split's
    proved error, the arm's kernel's summation (in s: the qt coefficient,
    doubled, over P <= (||q||^2 + M) / 2) and the f32 headroom, never
    below the reference's ``2^-14`` (pallas_knn.py:1570-1571).  Both the
    host tolerance (:func:`kernel_tolerance`) and the device certificate
    (parallel/sharded.py ``_certify_pack``) read it."""
    if arm not in ("bf16x3", "bf16x3f"):
        raise ValueError(f"arm {arm!r} is not bf16x3 or bf16x3f")
    proved = (SPLIT_SCALE + accumulation_coefficient(arm, nd) * U32
              + HEADROOM_SCALE)
    return max(2.0 ** -14, proved)


def kernel_plain_tolerance_scale(arm: str, nd: int) -> float:
    """Per unit of ``(||q||^2 + max||t||^2)``, how far a coarse kernel's
    score may lie from its plain version's at ``nd`` chunks: for the bf16
    tensor-core arms the proved sum of the kernel's summation bound
    (:func:`accumulation_coefficient`) and the plain version's, plus both
    roundings of s (|s| <= 2 (||q||^2 + M)) -- the plain bf16x3 sums three
    f32 products of 128 terms per chunk in any order, two adds and the
    chunk adds, (128 + nd)(1 + 2^-7) u P; the plain bf16x3f one f32 product
    of 384 terms per chunk and the chunk adds, (384 + nd)(1 + 2^-7) u P;
    the plain default one f32 product of 128 terms per chunk and the chunk
    adds, counted as (128 + nd)(1 + 2^-7) u P (two adds more than it
    makes: they cover the bf16 values' P <= (1 + 2^-8)^2 (||q||^2 + M) / 2,
    csrc/binned_mma.cuh) -- 456.5 u at Dp = 128; for highest ``(2 nd +
    4) u`` (the two differ only in each chunk's f64 order); ``128 u`` for
    the int and pq arms, whose kernels are bitwise their plain versions."""
    if arm in ("bf16x3", "bf16x3f", "default"):
        terms = 3 * DIM_CHUNK if arm == "bf16x3f" else DIM_CHUNK
        plain = (terms + nd) * (1 + 2.0 ** -7)
        return (accumulation_coefficient(arm, nd) + plain + 4) * U32
    if arm == "highest":
        return (2 * nd + 4) * U32
    # the int and pq kernels are held bitwise against their plain versions
    return 128 * U32

#: the JAX package's knob domains, and the values this port runs
PRECISIONS = ("bf16x3", "bf16x3f", "int8", "int4", "pq", "highest",
              "default")
BINNINGS = ("grouped", "lane")
GRID_ORDERS = ("query_major", "db_major")
KERNELS = ("tiled", "streaming", "fused")
#: the quantized arms, by the dtype of their db operand (int4 is packed)
INT_ARMS = {"int8": torch.int8, "int4": torch.uint8}
#: the f32 family, by the dtype of its db operand and its operand count:
#: (q, th, tl, tnorm) for the bf16x3 pair, (q, th, tnorm) for default,
#: (q, t, tnorm) for highest
F32_ARMS = {"bf16x3": (torch.bfloat16, 4), "bf16x3f": (torch.bfloat16, 4),
            "highest": (torch.float32, 3), "default": (torch.bfloat16, 3)}
#: the arms the coarse kernels run, and their codes in the C entries
#: (csrc/binned_select.cuh, enum Arm); every wrapper counts its launches
#: per arm
ARMS = ("bf16x3", *INT_ARMS, "bf16x3f", "highest", "default", "pq")
FINAL_SELECTS = ("exact", "approx")

#: query rows per CTA of every coarse kernel; the fused kernels' skip
#: decision is taken per block of this many rows
QUERY_BLOCK = 32
#: CUDA caps a grid's y extent: the query blocks of the query-major and
#: streaming grids, the db tiles of the db-major grid
_MAX_GRID_Y = 65535
_MAX_KERNEL_QUERIES = _MAX_GRID_Y * QUERY_BLOCK
#: K11's carry depth cap (pallas_knn.py:260): past it the early-out disarms
MAX_CARRY_DEPTH = 8
#: CTAs one SM holds of a streaming / fused kernel, by (device index,
#: kernel, arm): read from the built kernel through the occupancy API at
#: first use
_ctas_per_sm = {}


def kernel_launches_per_batch(kernel: str, rows: int, tile_n: int) -> int:
    """The port's coarse-kernel launches per query batch: one for each of
    K1, K10 and K11, whose grids cover every db tile.  (The JAX package's
    helper of this name, pallas_knn.py:263-272, counts ``ceil(rows /
    tile_n)`` for ``tiled``: its TPU grid re-dispatches the pipelined body
    once per tile.  Streaming and fused agree.)  ``rows`` and ``tile_n``
    keep that helper's signature."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    return 1


def carry_depth(keep: Optional[int]) -> int:
    """K11's carry depth ``ceil(keep / 128)``, or 0 (disarmed) when keep is
    None or the depth exceeds MAX_CARRY_DEPTH (pallas_knn.py:712-718)."""
    if keep is None:
        return 0
    depth = -(-int(keep) // BIN_W)
    return depth if 0 < depth <= MAX_CARRY_DEPTH else 0


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def check_knobs(*, precision: str = "bf16x3", binning: str = "grouped",
                grid_order: str = "query_major", kernel: str = "tiled",
                final_select: str = "exact", bin_w: Optional[int] = None,
                survivors: Optional[int] = None) -> None:
    """The JAX package's knob refusals (pallas_knn.py:286-311, 922-956,
    1386-1398).  ``bin_w`` and ``survivors`` left at None take the JAX
    package's defaults (:func:`_geometry`); a ``survivors`` above
    MAX_SURVIVORS is capped there, as in the JAX package."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if binning not in BINNINGS:
        raise ValueError(f"binning {binning!r} not in {BINNINGS}")
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"grid_order {grid_order!r} not in {GRID_ORDERS}")
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    if final_select not in FINAL_SELECTS:
        raise ValueError(
            f"final_select {final_select!r} not in {FINAL_SELECTS}")
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
    if bin_w is not None and (bin_w < BIN_W or bin_w % BIN_W):
        raise ValueError(f"bin_w={bin_w} must be a multiple of {BIN_W} lanes")
    if survivors is not None and survivors < 1:
        raise ValueError(f"survivors={survivors} must be >= 1")


def _geometry(tile_n: int, bin_w: int = BIN_W,
              survivors: Optional[int] = None,
              binning: str = "grouped") -> Tuple[int, int, int, int]:
    """(n_bins, survivors, out_w, bound_w) for a db tile — the JAX
    package's formula (pallas_knn.py:275-313).  Output blocks are
    lane-aligned: ``out_w = round_up(n_bins * survivors, 128)`` candidate
    columns per tile (padded with +inf / the sentinel), ``bound_w``
    columns of per-bin bounds.  ``survivors=None`` picks 2 in grouped
    binning and, in lane binning, ``max(2, 128 // n_bins)`` (at most
    MAX_SURVIVORS and bin_w); an explicit value is capped the same way.
    In grouped binning the bins are the 128 lanes and ``bin_w`` does not
    shape them, but the tile must still be a multiple of it."""
    if binning not in BINNINGS:
        raise ValueError(f"binning {binning!r} not in {BINNINGS}")
    if tile_n % bin_w:
        raise ValueError(f"tile_n={tile_n} must be a multiple of bin_w={bin_w}")
    if bin_w % BIN_W:
        raise ValueError(f"bin_w={bin_w} must be a multiple of {BIN_W} lanes")
    if binning == "grouped":
        if survivors is None:
            survivors = 2
        survivors = min(survivors, MAX_SURVIVORS)
        return BIN_W, survivors, survivors * BIN_W, BIN_W
    n_bins = tile_n // bin_w
    if survivors is None:
        survivors = min(max(2, 128 // n_bins), MAX_SURVIVORS, bin_w)
    survivors = min(survivors, MAX_SURVIVORS, bin_w)
    return (n_bins, survivors, _round_up(n_bins * survivors, 128),
            _round_up(n_bins, 128))


def effective_tile(rows: int, tile_n: int, bin_w: int,
                   survivors: Optional[int], binning: str,
                   min_width: int) -> int:
    """The db tile the kernel will run — the JAX package's formula
    (pallas_knn.py:316-346): capped to the (padded) db, then halved until
    the total candidate width ``n_tiles * out_w`` covers ``min_width``
    (= m+2 for certified callers) or the tile bottoms out at ``bin_w``."""
    if tile_n % bin_w:
        raise ValueError(
            f"tile_n={tile_n} must be a multiple of bin_w={bin_w}")
    eff = min(tile_n, max(bin_w, -(-rows // bin_w) * bin_w))

    def width(t: int) -> int:
        _, _, out_w, _ = _geometry(t, bin_w, survivors, binning)
        return -(-rows // t) * out_w

    while eff > bin_w and width(eff) < min_width:
        eff = max(bin_w, -(-(eff // 2) // bin_w) * bin_w)
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


def _pad_db(db: torch.Tensor, tile_n: int, offset: float = 0.0):
    """f32 db rows as the kernels take them: ``PAD_VAL`` rows up to a
    ``tile_n`` multiple, then the ``offset`` shift, then zero dims up to a
    DIM_CHUNK multiple."""
    n, d = db.shape
    x = db.float()
    rpad = _round_up(max(n, 1), tile_n) - n
    if rpad:
        x = torch.cat([x, torch.full((rpad, d), PAD_VAL, dtype=torch.float32,
                                     device=x.device)])
    if offset:
        x = x - offset
    dpad = _round_up(d, DIM_CHUNK) - d
    if dpad:
        x = torch.nn.functional.pad(x, (0, dpad))
    return x


def prepare_db(db: torch.Tensor, tile_n: int):
    """The bf16x3 prologue of ``_bin_candidates`` for the db side:
    ``PAD_VAL`` rows up to a ``tile_n`` multiple, zero dims up to a
    DIM_CHUNK multiple, the hi/lo split, and the f32 row norms of the
    padded rows as ``[8, Np]`` rows (row 0 is read; an expanded view, as
    the TPU kernel's sublane-broadcast block).  Returns (th, tl, tnorm)."""
    x = _pad_db(db, tile_n)
    th, tl = split_bf16(x)
    return th.contiguous(), tl.contiguous(), _norm_rows(x)


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    """The f32 row norms of padded rows as ``[8, Np]`` rows (an expanded
    view, as the TPU kernel's sublane-broadcast block; row 0 is read)."""
    return (x * x).sum(-1)[None, :].expand(8, -1)


def prepare_db_f32(db: torch.Tensor, tile_n: int):
    """The highest arm's db prologue (pallas_knn.py:913-915, 1079-1081,
    1100-1105): the f32 rows padded as :func:`prepare_db` pads them, kept
    in f32, and their norm rows — the same values as prepare_db's.
    Returns (t [Np, Dp] f32, tnorm [8, Np])."""
    x = _pad_db(db, tile_n).contiguous()
    return x, _norm_rows(x)


def prepare_db_arm(db: torch.Tensor, tile_n: int, precision: str):
    """The db operands of f32-family arm ``precision`` as the kernels
    take them: ``(th, tl, tnorm)`` for bf16x3 / bf16x3f, ``(th, tnorm)``
    for default (K3 reads ``th = bf16(t)``), ``(t, tnorm)`` for highest."""
    if precision == "highest":
        return prepare_db_f32(db, tile_n)
    th, tl, tnorm = prepare_db(db, tile_n)
    return (th, tnorm) if precision == "default" else (th, tl, tnorm)


def quantize_queries(queries: torch.Tensor, offset: float = 0.0):
    """The int arms' query prologue (pallas_knn.py:983-985, 1013-1015):
    ``queries - offset`` quantized per row to int8 (:func:`quantize_rows`;
    both int arms), dims zero-padded to a DIM_CHUNK multiple after the
    shift.  Returns ``(qi int8 [Q, Dp], qsc f32 [Q])``.

    The JAX package pads the dims before the shift, so its padded dims
    hold ``-offset`` and can set the query's scale, while its certificate
    quantizes the unpadded query (ROADMAP queue C, fault 8); here both
    see the same quantization.  With offset 0, or dims a multiple of
    128, the two are the same."""
    qi, qsc = quantize_rows(queries.float() - offset)
    dpad = _round_up(qi.shape[1], DIM_CHUNK) - qi.shape[1]
    if dpad:
        qi = torch.nn.functional.pad(qi, (0, dpad))
    return qi.contiguous(), qsc.contiguous()


def _int_aux(norms: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The int arms' [2, Np] aux rows: row norms (row 0) over row scales
    (row 1).  (The TPU kernel streams sublane-broadcast blocks, int8
    norms in rows 0-7 over scales in rows 8-15 and int4 norms in row 0
    over scales in row 1 of 8; a CUDA kernel reads one value of each per
    db row, so the port keeps the two rows alone.)"""
    return torch.stack([norms.float(), scales.float()]).contiguous()


def prepare_db_quant(values: torch.Tensor, scales: torch.Tensor,
                     norms: torch.Tensor, tile_n: int):
    """A pre-quantized db (the JAX package's ``db_int8`` / ``db_int4``
    triple: int8 values [N, D] or packed uint8 [N, D/2], f32 scales [N],
    f32 shifted-space norms [N]) padded as pallas_knn.py:996-1000 and
    1026-1030 pad it: zero rows at zero scale with ``PAD_VAL`` norms up to
    a ``tile_n`` multiple (they score ~PAD_VAL, never a candidate, never
    deflating a bound), and zero dims (int8) or zero packed bytes (int4)
    up to a DIM_CHUNK multiple of dims.  Returns ``(t, aux [2, Np])``."""
    n = values.shape[0]
    width = DIM_CHUNK if values.dtype == torch.int8 else DIM_CHUNK // 2
    rpad = _round_up(max(n, 1), tile_n) - n
    cpad = _round_up(values.shape[1], width) - values.shape[1]
    t = torch.nn.functional.pad(values, (0, cpad, 0, rpad))
    scales = torch.nn.functional.pad(scales.float(), (0, rpad))
    norms = torch.nn.functional.pad(norms.float(), (0, rpad), value=PAD_VAL)
    return t.contiguous(), _int_aux(norms, scales)


def prepare_db_int(db: torch.Tensor, tile_n: int, precision: str,
                   offset: float = 0.0):
    """The quantize-on-the-fly db prologue (pallas_knn.py:986-990,
    1016-1020): ``PAD_VAL`` rows up to a ``tile_n`` multiple, the shift,
    zero dims up to a DIM_CHUNK multiple, per-row int8 (or int4, then
    nibble-packed) quantization of every padded row, and the f32
    shifted-space norms.  Returns ``(t, aux [2, Np])``."""
    x = _pad_db(db, tile_n, offset)
    norms = (x * x).sum(-1)
    if precision == "int8":
        t, scales = quantize_rows(x)
    else:
        vals, scales = quantize_rows_int4(x)
        t = pack_nibbles_t(vals, DIM_CHUNK)
    return t.contiguous(), _int_aux(norms, scales)


def pq_luts(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """The pq arm's query prologue (pallas_knn.py:1056-1066): per query
    the lookup table ``LUT[q, s*C + c] = q_s . cb[s, c] - ||cb[s, c]||^2 /
    2`` in f32, the queries zero-padded (or cut) to the trained ``m *
    dsub`` dims, from ``codebooks`` f32 [m, C, dsub] on the queries'
    device.  Returns a contiguous [Q, m*C] f32 tensor (the JAX package
    also pads its columns to a multiple of 128 for the TPU's lanes; a CUDA
    kernel reads only the m*C entries)."""
    m, c, dsub = codebooks.shape
    q = queries.float()
    if q.shape[1] < m * dsub:
        q = torch.nn.functional.pad(q, (0, m * dsub - q.shape[1]))
    qv = q[:, : m * dsub].reshape(q.shape[0], m, dsub)
    books = codebooks.float()
    lut = (torch.einsum("qmd,mcd->qmc", qv, books)
           - 0.5 * (books * books).sum(-1)[None])
    return lut.reshape(q.shape[0], m * c).contiguous()


def prepare_db_pq(codes: torch.Tensor, tile_n: int):
    """The pq arm's db operands (pallas_knn.py:1067-1071, 1096-1099): the
    uint8 codes [N, m] padded with zero codes to a ``tile_n`` multiple of
    rows, and the ``[8, Np]`` norm rows that carry the pad fill alone — 0
    on real rows (the LUT holds the reconstruction's norm term), PAD_VAL
    on padding.  Returns ``(codes [Np, m] uint8, tnorm [8, Np] f32)``."""
    n = codes.shape[0]
    rpad = _round_up(max(n, 1), tile_n) - n
    codes = torch.nn.functional.pad(codes, (0, 0, 0, rpad)).contiguous()
    tn = torch.zeros(n + rpad, dtype=torch.float32, device=codes.device)
    tn[n:] = PAD_VAL
    return codes, tn[None, :].expand(8, -1)


def _select_tile(s, ti: int, tile_n: int, survivors: int = SURVIVORS):
    """The grouped emitter on the scores ``s [Q, T*tile_n]`` of the T
    consecutive db tiles from tile ``ti`` (pallas_knn.py:575-610): per
    (tile, lane), the sorted insertion network over the tile's groups in
    order, with strict `<` (the earlier group wins a tie), keeping
    ``survivors`` values with their groups and the next value as the bin
    bound — the kernels' network, step for step, so that ties resolve as
    they do there.  Returns the T tiles' blocks side by side."""
    n_q = s.shape[0]
    n_t = s.shape[1] // tile_n
    s = s.reshape(n_q, n_t, tile_n // BIN_W, BIN_W)
    shape = (n_q, n_t, BIN_W)
    vals = [torch.full(shape, torch.inf, device=s.device)] * (survivors + 1)
    gidx = [torch.zeros(shape, dtype=torch.int32,
                        device=s.device)] * survivors
    for g in range(s.shape[2]):
        cur_v = s[:, :, g]
        cur_g = torch.full(shape, g, dtype=torch.int32, device=s.device)
        for j in range(survivors):
            less = cur_v < vals[j]
            disp_v = torch.maximum(cur_v, vals[j])
            disp_g = torch.where(less, gidx[j], cur_g)
            vals[j] = torch.minimum(cur_v, vals[j])
            gidx[j] = torch.where(less, cur_g, gidx[j])
            cur_v, cur_g = disp_v, disp_g
        vals[survivors] = torch.minimum(vals[survivors], cur_v)
    base = ((ti + torch.arange(n_t, device=s.device)) * tile_n)[None, :, None]
    lane = torch.arange(BIN_W, device=s.device)
    ci = [torch.where(torch.isfinite(v), base + gi * BIN_W + lane,
                      I32MAX).to(torch.int32)
          for v, gi in zip(vals, gidx)]
    width = n_t * survivors * BIN_W
    return (torch.stack(vals[:survivors], 2).reshape(n_q, width),
            torch.stack(ci, 2).reshape(n_q, width),
            vals[survivors].reshape(n_q, n_t * BIN_W))


#: scores a plain grouped emitter call takes at once: the tiles of a batch
#: run through one network, each step on all of them
_PLAIN_BATCH_SCORES = 1 << 27


def _select_tile_lane(s, ti: int, tile_n: int, geo):
    """The lane emitter on one tile's scores ``s [Q, tile_n]``
    (pallas_knn.py:506-549), step for step: bin b = rows ``b*bin_w ..
    (b+1)*bin_w - 1``; survivor j is the bin's minimum after the j earlier
    picks were set to +inf, at its first argmin; the bound is the minimum
    of the rest; the index is I32MAX where a value is not finite; +inf /
    I32MAX fill the columns past ``n_bins * survivors`` and +inf the
    bounds past ``n_bins``.  ``geo`` is :func:`_geometry`'s tuple."""
    n_bins, survivors, out_w, bound_w = geo
    n_q = s.shape[0]
    bin_w = tile_n // n_bins
    work = s.reshape(n_q, n_bins, bin_w)
    lane = torch.arange(bin_w, device=s.device)
    base = ti * tile_n + torch.arange(n_bins, device=s.device) * bin_w
    ds, is_ = [], []
    for _ in range(survivors):
        mj = work.amin(-1)
        aj = work.argmin(-1)
        ds.append(mj)
        is_.append(torch.where(torch.isfinite(mj), base + aj, I32MAX))
        work = torch.where(lane == aj[:, :, None], torch.inf, work)
    bound = work.amin(-1)
    cd = torch.cat(ds, -1)
    ci = torch.cat(is_, -1).to(torch.int32)
    pad = out_w - survivors * n_bins
    if pad:
        cd = torch.nn.functional.pad(cd, (0, pad), value=torch.inf)
        ci = torch.nn.functional.pad(ci, (0, pad), value=I32MAX)
    if bound_w - n_bins:
        bound = torch.nn.functional.pad(bound, (0, bound_w - n_bins),
                                        value=torch.inf)
    return cd, ci, bound


def _select_tiles(score_tile, n_tiles: int, tile_n: int, geo=None,
                  survivors: int = SURVIVORS):
    """Concatenates the emitter over the db tiles, the scores of db rows
    ``rows`` (from tile ``ti``) given by ``score_tile(ti, rows)``:
    :func:`_select_tile` (grouped binning at ``survivors``, ``geo`` None;
    after the first tile on batches of tiles of up to
    ``_PLAIN_BATCH_SCORES`` scores) or :func:`_select_tile_lane` (lane
    binning at geometry ``geo``, tile by tile)."""
    outs = []
    ti, step = 0, 1
    while ti < n_tiles:
        te = min(ti + step, n_tiles)
        s = score_tile(ti, slice(ti * tile_n, te * tile_n))
        if geo is None:
            outs.append(_select_tile(s, ti, tile_n, survivors))
            per_tile = max(1, s.numel() // (te - ti))
            step = max(1, _PLAIN_BATCH_SCORES // per_tile)
        else:
            outs.append(_select_tile_lane(s, ti, tile_n, geo))
        ti = te
    return tuple(torch.cat([o[j] for o in outs], 1) for j in range(3))


def _chunked_scores(tnorm, dp: int, chunk_dot):
    """``s = tnorm[0] - 2 qt`` of a tile's db rows, ``qt`` summed in f32
    over the 128-dim chunks in order, each chunk's f32 dot from
    ``chunk_dot(rows, cols)`` — the kernels' chunk structure."""

    def scores(ti, rows):
        qt = None
        for c in range(0, dp, DIM_CHUNK):
            part = chunk_dot(rows, slice(c, c + DIM_CHUNK))
            qt = part if qt is None else qt + part
        return tnorm[0, rows][None, :] - 2.0 * qt

    return scores


def _bf16x3_scores(q, th, tl, tnorm):
    """K1's scores in plain PyTorch: per 128-dim chunk an f32 matmul of
    the upcast bf16 parts (``qh.th + qh.tl + ql.th``), the chunks summed in
    f32, then ``s = tnorm[0] - 2 qt``.  Returns ``(scores(ti, rows), Np)``,
    the scores of a tile's db rows for :func:`_select_tiles`."""
    qh, ql = (p.float() for p in split_bf16(q))

    def chunk_dot(rows, cols):
        h = th[rows, cols].float()
        lo = tl[rows, cols].float()
        return (qh[:, cols] @ h.T + qh[:, cols] @ lo.T) + ql[:, cols] @ h.T

    return _chunked_scores(tnorm, q.shape[1], chunk_dot), th.shape[0]


def _bf16x3f_scores(q, th, tl, tnorm):
    """K4's scores: per chunk one f32 matmul over the 3x contraction
    ``[qh|qh|ql] . [th|tl|th]`` (pallas_knn.py:407-414, 970-976), chunks
    summed in f32.  Returns as :func:`_bf16x3_scores`."""
    qh, ql = (p.float() for p in split_bf16(q))

    def chunk_dot(rows, cols):
        h = th[rows, cols].float()
        q3 = torch.cat([qh[:, cols], qh[:, cols], ql[:, cols]], 1)
        return q3 @ torch.cat([h, tl[rows, cols].float(), h], 1).T

    return _chunked_scores(tnorm, q.shape[1], chunk_dot), th.shape[0]


def _highest_scores(q, t, tnorm):
    """K2's scores: per chunk the f64 matmul of the f32 values (every
    product exact), rounded once to f32, chunks summed in f32.  Returns
    as :func:`_bf16x3_scores`."""
    q64 = q.double()

    def chunk_dot(rows, cols):
        return (q64[:, cols] @ t[rows, cols].double().T).float()

    return _chunked_scores(tnorm, q.shape[1], chunk_dot), t.shape[0]


def _default_scores(q, th, tnorm):
    """K3's scores: the TPU's one bf16 pass, per chunk an f32 matmul of
    ``bf16_rn(q)`` against ``th = bf16_rn(t)`` (exact products), chunks
    summed in f32.  Returns as :func:`_bf16x3_scores`."""
    qh = q.to(torch.bfloat16).float()

    def chunk_dot(rows, cols):
        return qh[:, cols] @ th[rows, cols].float().T

    return _chunked_scores(tnorm, q.shape[1], chunk_dot), th.shape[0]


def _int_scores(qi, qsc, t, aux):
    """K5's (``t`` int8 [Np, Dp]) and K6's (``t`` nibble-packed uint8
    [Np, Dp/2]) scores in plain PyTorch: the exact integer dot ``qi . ti``
    as a float64 matmul of the integer values (exact far past any real
    dim, and the same on the CPU and the card: CPU torch's int8 matmul
    wraps in int8), cast to int32 and rounded once to f32, then the JAX
    package's rescale order ``(f32(dot) * qsc) * ts``
    (pallas_knn.py:475-476) and ``s = tn - 2 qt``.  ``aux`` is [2, Np]:
    row norms over row scales.  Returns as :func:`_bf16x3_scores`."""
    tv = t if t.dtype == torch.int8 else unpack_nibbles_t(t, DIM_CHUNK)
    q64 = qi.double()

    def scores(ti, rows):
        dot = (q64 @ tv[rows].double().T).to(torch.int32).float()
        qt = (dot * qsc[:, None]) * aux[1, rows][None, :]
        return aux[0, rows][None, :] - 2.0 * qt

    return scores, t.shape[0]


def _pq_scores(lut, codes, tnorm):
    """K7's scores in plain PyTorch: ``qt[q, t] = sum_s LUT[q, s*C +
    code[t, s]]`` summed in f32 one subspace at a time, s = 0 .. m-1 from
    zero (the kernel's order: no reduction whose order torch may choose),
    then ``s = tnorm[0] - 2 qt``.  Returns as :func:`_bf16x3_scores`."""
    m = codes.shape[1]
    c = lut.shape[1] // m

    def scores(ti, rows):
        cod = codes[rows].long()
        qt = torch.zeros((lut.shape[0], cod.shape[0]), dtype=torch.float32,
                         device=lut.device)
        for s in range(m):
            qt = qt + lut[:, s * c + cod[:, s]]
        return tnorm[0, rows][None, :] - 2.0 * qt

    return scores, codes.shape[0]


_SCORES = {"bf16x3": _bf16x3_scores, "bf16x3f": _bf16x3f_scores,
           "highest": _highest_scores, "default": _default_scores,
           "int8": _int_scores, "int4": _int_scores, "pq": _pq_scores}


def emit_geometry(tile_n: int, binning: str = "grouped",
                  bin_w: Optional[int] = None,
                  survivors: Optional[int] = None):
    """The geometry a launch emits at: :func:`_geometry` of the binning
    (grouped: 1 to MAX_SURVIVORS survivors per lane bin, ``bin_w`` a
    multiple of 128 dividing the tile; lane: the same, ``bin_w`` rows a
    bin), ``survivors`` capped at MAX_SURVIVORS as the JAX package caps
    it."""
    if survivors is not None and survivors < 1:
        raise ValueError(f"survivors={survivors} must be >= 1")
    return _geometry(tile_n, BIN_W if bin_w is None else bin_w, survivors,
                     binning)


def binned_select_plain(*operands: torch.Tensor, tile_n: int, arm: str,
                        binning: str = "grouped",
                        bin_w: Optional[int] = None,
                        survivors: Optional[int] = None):
    """The coarse kernels' function in plain PyTorch, tile by tile through
    the emitter of ``binning`` (:func:`_select_tile`, or
    :func:`_select_tile_lane` at ``bin_w`` / ``survivors``), from the
    operands of arm ``arm`` as :func:`binned_select` takes them."""
    n_p = _check_operands(operands, tile_n, arm)
    geo = emit_geometry(tile_n, binning, bin_w, survivors)
    scores, _ = _SCORES[arm](*operands)
    return _select_tiles(scores, n_p // tile_n, tile_n,
                         None if binning == "grouped" else geo, geo[1])


def _check_operands(operands, tile_n: int, arm: str) -> int:
    """Checks that ``operands`` are arm ``arm``'s — an int arm's ``(qi,
    qsc, t, aux)`` or an f32-family arm's (:data:`F32_ARMS`) — and returns
    the padded db rows."""
    if arm == "pq":
        return _check_pq_operands(operands, tile_n)
    if arm in INT_ARMS:
        if len(operands) != 4:
            raise ValueError(
                f"an int arm's coarse kernel takes 4 operands, got "
                f"{len(operands)}")
        got = _check_int_operands(*operands, tile_n)
        if got != arm:
            raise ValueError(f"arm={arm!r} given {got} operands")
        return operands[2].shape[0]
    if arm not in F32_ARMS:
        raise ValueError(f"arm {arm!r} not in {ARMS}")
    db_dtype, count = F32_ARMS[arm]
    if len(operands) != count:
        raise ValueError(
            f"the {arm} coarse kernel takes {count} operands, got "
            f"{len(operands)}")
    q, dbs, tnorm = operands[0], operands[1:-1], operands[-1]
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("q must be a contiguous [Q, Dp] float32 tensor")
    names = "th, tl" if count == 4 else ("t" if arm == "highest" else "th")
    if any(t.dtype != db_dtype for t in dbs):
        raise ValueError(f"{names} must be {str(db_dtype)[6:]}")
    if dbs[0].dim() != 2 or any(t.shape != dbs[0].shape for t in dbs):
        raise ValueError(
            f"{names} mismatch: {[tuple(t.shape) for t in dbs]}")
    if not all(t.is_contiguous() for t in dbs):
        raise ValueError(f"{names} must be contiguous")
    n_p, dp = dbs[0].shape
    if q.shape[1] != dp or dp % DIM_CHUNK:
        raise ValueError(
            f"q dims {q.shape[1]} vs db dims {dp}: both must match and be a "
            f"multiple of {DIM_CHUNK}")
    if tnorm.dtype != torch.float32 or tuple(tnorm.shape) != (8, n_p) \
            or tnorm.stride(1) != 1:
        raise ValueError("tnorm must be [8, Np] float32 with unit row stride")
    _check_rows_and_device(n_p, tile_n, operands)
    return n_p


def _check_rows_and_device(n_p: int, tile_n: int, operands) -> None:
    """The checks every arm's operands share: ``n_p`` db rows a nonzero
    multiple of a valid ``tile_n`` that fits int32 indices, and every
    operand on one device."""
    if tile_n % BIN_W or tile_n <= 0 or n_p % tile_n or n_p == 0:
        raise ValueError(
            f"db rows {n_p} must be a nonzero multiple of tile_n={tile_n}, "
            f"itself a multiple of {BIN_W}")
    if n_p >= 2 ** 31:
        raise ValueError("db rows must fit int32 indices")
    devs = {t.device for t in operands}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _check_pq_operands(operands, tile_n: int) -> int:
    """Checks the pq arm's operands — ``lut [Q, m*C] f32`` (:func:`pq_luts`),
    ``codes [Np, m] uint8`` and ``tnorm [8, Np] f32`` (:func:`prepare_db_pq`)
    — and returns the padded db rows.  Every code must be below C (the
    kernel reads LUT entry ``s*C + code``)."""
    if len(operands) != 3:
        raise ValueError(
            f"the pq coarse kernel takes 3 operands (lut, codes, tnorm), got "
            f"{len(operands)}")
    lut, codes, tnorm = operands
    if lut.dtype != torch.float32 or lut.dim() != 2 or not lut.is_contiguous():
        raise ValueError("lut must be a contiguous [Q, m*C] float32 tensor")
    if codes.dtype != torch.uint8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous [Np, m] uint8 tensor")
    n_p, m = codes.shape
    if m < 1 or lut.shape[1] % m or not 2 <= lut.shape[1] // m <= 256:
        raise ValueError(
            f"lut width {lut.shape[1]} is not m*C for the codes' m={m} "
            f"subspaces and 2 <= C <= 256 codes")
    if tnorm.dtype != torch.float32 or tuple(tnorm.shape) != (8, n_p) \
            or tnorm.stride(1) != 1:
        raise ValueError("tnorm must be [8, Np] float32 with unit row stride")
    _check_rows_and_device(n_p, tile_n, operands)
    return n_p


def _check_int_operands(qi, qsc, t, aux, tile_n: int) -> str:
    """Checks the int arms' operands — ``qi [Q, Dp] int8``, ``qsc [Q]
    f32``, ``t`` int8 [Np, Dp] (int8) or nibble-packed uint8 [Np, Dp/2]
    (int4), ``aux [2, Np] f32`` — and returns the arm."""
    if qi.dtype != torch.int8 or qi.dim() != 2 or not qi.is_contiguous():
        raise ValueError("qi must be a contiguous [Q, Dp] int8 tensor")
    if qsc.dtype != torch.float32 or tuple(qsc.shape) != (qi.shape[0],) \
            or not qsc.is_contiguous():
        raise ValueError("qsc must be a contiguous [Q] float32 tensor")
    arms = {dt: arm for arm, dt in INT_ARMS.items()}
    if t.dtype not in arms or t.dim() != 2 or not t.is_contiguous():
        raise ValueError("t must be a contiguous 2-D int8 (int8 arm) or "
                         "uint8 (int4 arm, nibble-packed) tensor")
    arm = arms[t.dtype]
    n_p, width = t.shape
    dp = qi.shape[1]
    if dp % DIM_CHUNK or width != (dp if arm == "int8" else dp // 2):
        raise ValueError(
            f"qi dims {dp} vs db width {width} ({arm}): dims must be a "
            f"multiple of {DIM_CHUNK}, packed two per byte for int4")
    if aux.dtype != torch.float32 or tuple(aux.shape) != (2, n_p) \
            or not aux.is_contiguous():
        raise ValueError("aux must be a contiguous [2, Np] float32 tensor")
    _check_rows_and_device(n_p, tile_n, (qi, qsc, t, aux))
    return arm


def _entry(library: str, name: str, n_ints: int):
    """A kernel's C entry in ``csrc/<library>.cu``, built and loaded at
    first use, with its ctypes signature: seven tensor pointers, ``n_ints``
    ints, the stream."""
    fn = getattr(_cuda.load(library), name)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_grid(n_q: int, n_tiles: int,
               grid_order: str = "query_major") -> None:
    """Refuses a launch whose grid's y extent passes CUDA's cap: the
    query blocks of the query-major and streaming grids, the db tiles of
    the db-major grid."""
    if grid_order == "db_major":
        if n_tiles > _MAX_GRID_Y:
            raise ValueError(
                f"{n_tiles} db tiles exceed the db-major grid's "
                f"{_MAX_GRID_Y} (its y extent); raise tile_n or use "
                f"grid_order='query_major'")
    elif n_q > _MAX_KERNEL_QUERIES:
        raise ValueError(
            f"{n_q} queries exceed one launch's {_MAX_KERNEL_QUERIES} (the "
            f"grid's y extent); run them in batches (batch_size)")


def _pq_kernel_operands(lut: torch.Tensor, codes: torch.Tensor):
    """K7's operands in the layout its lookups read (csrc/binned_pq.cuh):
    the LUT by query block and subspace, each slice ``[C][32 queries]``
    (queries past Q zero), ``[ceil(Q/32), m, C, 32]`` f32, and the codes
    subspace-major, ``[m, Np]`` uint8."""
    n_q, m = lut.shape[0], codes.shape[1]
    n_blocks = -(-n_q // QUERY_BLOCK)
    lut = torch.nn.functional.pad(lut, (0, 0, 0, n_blocks * QUERY_BLOCK - n_q))
    lut_t = lut.view(n_blocks, QUERY_BLOCK, m, -1).permute(0, 2, 3, 1)
    return lut_t.contiguous(), codes.t().contiguous()


def _launch(library: str, arm: str, name: str, operands, n_rows: int,
            tile_n: int, geo, *extra: int, grid_order: str = "query_major"):
    """Allocates ``(cd, ci, bounds)`` on the card at the emit geometry
    ``geo`` and launches the C entry ``name`` of arm ``arm`` on the current
    stream with the ``operands`` (the query operand first; a three-operand
    arm's fills the entry's third pointer with NULL; pq's LUT and codes in
    the kernel's layout, :func:`_pq_kernel_operands`), then ``n_q, dp,
    n_tiles = n_rows // tile_n, tile_n`` and ``extra`` ints (``dp`` = the
    query operand's width; for pq, the codes' subspaces); raises if the
    launch is refused."""
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    n_q = q.shape[0]
    dp = operands[1].shape[1] if arm == "pq" else q.shape[1]
    n_tiles = n_rows // tile_n
    check_grid(n_q, n_tiles, grid_order)
    _, _, out_w, bound_w = geo
    cd = torch.empty((n_q, n_tiles * out_w), dtype=torch.float32,
                     device=q.device)
    ci = torch.empty(cd.shape, dtype=torch.int32, device=q.device)
    bounds = torch.empty((n_q, n_tiles * bound_w), dtype=torch.float32,
                         device=q.device)
    if arm == "pq":
        operands = (*_pq_kernel_operands(*operands[:2]), operands[2])
    for t in operands:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    ptrs = [t.data_ptr() for t in operands]
    if len(ptrs) == 3:
        ptrs.insert(2, None)
    fn = _entry(library, name, 4 + len(extra))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, cd.data_ptr(), ci.data_ptr(), bounds.data_ptr(),
                n_q, dp, n_tiles, tile_n, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return cd, ci, bounds


def _binning_ints(operands, arm: str, tile_n: int, binning: str, geo):
    """The C entries' binning arguments: ``bin_w`` (0 = grouped binning),
    ``survivors`` and pq's code count C (0 for the other arms)."""
    bin_w = 0 if binning == "grouped" else tile_n // geo[0]
    ncodes = operands[0].shape[1] // operands[1].shape[1] if arm == "pq" else 0
    return bin_w, geo[1], ncodes


def binned_select(*operands: torch.Tensor, tile_n: int, arm: str,
                  grid_order: str = "query_major", binning: str = "grouped",
                  bin_w: Optional[int] = None,
                  survivors: Optional[int] = None):
    """The tiled wrapper — K1 (bf16x3), K4 (bf16x3f), K2 (highest), K3
    (default), K5 (int8), K6 (int4), K7 (pq): ``(cd [Q, T*out_w] f32, ci
    [Q, T*out_w] i32, bounds [Q, T*bound_w] f32)`` (grouped binning: out_w
    256, bound_w 128) from the arm's operands:

    - bf16x3, bf16x3f: ``q [Q, Dp] f32`` (:func:`pad_queries`), the db
      parts ``th, tl [Np, Dp] bf16`` and ``tnorm [8, Np] f32``
      (:func:`prepare_db`);
    - default: ``q``, ``th`` and ``tnorm`` (K3 reads ``th = bf16(t)``);
    - highest: ``q``, ``t [Np, Dp] f32`` and ``tnorm``
      (:func:`prepare_db_f32`);
    - int8 / int4: ``qi [Q, Dp] int8`` and ``qsc [Q] f32``
      (:func:`quantize_queries`), ``t`` int8 [Np, Dp] (int8) or
      nibble-packed uint8 [Np, Dp/2] (int4) and ``aux [2, Np] f32``
      (:func:`prepare_db_quant` / :func:`prepare_db_int`);
    - pq: ``lut [Q, m*C] f32`` (:func:`pq_luts`), ``codes [Np, m] uint8``
      and ``tnorm [8, Np] f32`` (:func:`prepare_db_pq`).

    ``arm`` names the arm (:data:`ARMS`); the operands must be its own.
    ``grid_order="db_major"`` launches the db-major grid (K9), bitwise the
    same outputs.  ``binning="lane"`` emits lane bins (K8) of ``bin_w``
    rows with ``survivors`` each (:func:`emit_geometry`).  On a CUDA
    tensor it launches ``binned_select_<arm>`` (built from
    ``csrc/binned_coarse.cu`` at first use) on the current stream, or
    raises; on a CPU tensor it runs :func:`binned_select_plain`.
    ``binned_select.launches[arm]`` counts its kernel launches in grouped
    binning at two survivors, ``.deep_launches[arm]`` those at any other
    count (the deep grouped build), ``.lane_launches[arm]`` those in lane
    binning, and ``.db_major_launches[arm]`` those in the db-major grid
    among them all."""
    n_p = _check_operands(operands, tile_n, arm)
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"grid_order {grid_order!r} not in {GRID_ORDERS}")
    geo = emit_geometry(tile_n, binning, bin_w, survivors)
    if operands[0].device.type == "cpu":
        return binned_select_plain(*operands, tile_n=tile_n, arm=arm,
                                   binning=binning, bin_w=bin_w,
                                   survivors=survivors)
    db_major = grid_order == "db_major"
    out = _launch("binned_coarse", arm, f"binned_select_{arm}", operands,
                  n_p, tile_n, geo, int(db_major),
                  *_binning_ints(operands, arm, tile_n, binning, geo),
                  grid_order=grid_order)
    _launch_counts(binned_select, binning, geo)[arm] += 1
    binned_select.db_major_launches[arm] += db_major
    return out


def _launch_counts(wrapper, binning: str, geo) -> dict:
    """The launch counter of ``wrapper`` that a launch at ``binning`` and
    emit geometry ``geo`` adds to: ``.launches`` (grouped, two survivors),
    ``.deep_launches`` (grouped, any other count) or ``.lane_launches``."""
    if binning == "lane":
        return wrapper.lane_launches
    return wrapper.launches if geo[1] == SURVIVORS else wrapper.deep_launches


binned_select.launches = dict.fromkeys(ARMS, 0)
binned_select.deep_launches = dict.fromkeys(ARMS, 0)
binned_select.db_major_launches = dict.fromkeys(ARMS, 0)
binned_select.lane_launches = dict.fromkeys(ARMS, 0)


def stream_segment_tiles(n_q: int, n_tiles: int, wave_ctas: int) -> int:
    """Db tiles each CTA of K10/K11 walks.  The tile loop is split into
    contiguous segments so that the grid (segments x query blocks) fills
    about one wave of ``wave_ctas`` CTAs (SMs x CTAs per SM): at Q=4,096
    (128 query blocks) on 132 SMs that hold 1 each, that is one segment of
    the 62 SIFT1M tiles; at Q=1,024 (32 blocks), 4 segments of 16."""
    n_blocks = -(-n_q // QUERY_BLOCK)
    n_seg = max(1, min(n_tiles, wave_ctas // max(1, n_blocks)))
    return -(-n_tiles // n_seg)


def _stream_ctas_per_sm(device: torch.device, kernel: str, precision: str,
                        emit=(0, SURVIVORS), pq_shape=(0, 0)) -> int:
    """CTAs of the ``streaming`` or ``fused`` kernel of arm ``precision``
    one SM of ``device`` holds at once (:func:`kernel_resources`, kept per
    build), for the binning ``emit`` = (bin_w, survivors) as the C
    entries take them (bin_w 0: grouped) — pq's at its shared memory for
    ``pq_shape`` = (m, C).  The single-chunk build's: the multi-chunk one,
    with more shared memory, holds no more."""
    key = (device.index, kernel, precision, tuple(emit), tuple(pq_shape))
    if key not in _ctas_per_sm:
        # an arm's builds share its shared memory, so any tile its binning
        # takes gives the CTAs of every one
        ctas = kernel_resources(kernel, precision, bin_w=emit[0],
                                survivors=emit[1],
                                ncodes=pq_shape[1] or 256,
                                tile_n=emit[0] or TILE_N,
                                device=device)["ctas_per_sm"]
        if ctas < 1:
            raise RuntimeError(
                f"the {kernel} {precision} kernel fits no CTA on an SM")
        _ctas_per_sm[key] = ctas
    return _ctas_per_sm[key]


#: the fields of :func:`kernel_resources`, in the C entries' order
RESOURCE_FIELDS = ("registers", "static_shared_bytes", "local_bytes",
                   "dynamic_shared_bytes", "ctas_per_sm", "emitter",
                   "passes")


def kernel_resources(kernel: str, arm: str, *, bin_w: int = 0,
                     survivors: int = SURVIVORS, dp: int = DIM_CHUNK,
                     ncodes: int = 256, tile_n: int = TILE_N,
                     device=None) -> dict:
    """The resources of the build that a ``kernel`` ("tiled", "streaming"
    or "fused") launch of arm ``arm`` takes at the C entries' binning
    ``bin_w`` (0 = grouped) and ``survivors`` on tiles of ``tile_n`` rows
    and ``dp`` padded dims (pq: ``dp`` subspaces of ``ncodes`` codes),
    read from the built kernel on a CUDA ``device`` (default: the current
    one): registers a thread, static shared, local (spill and stack),
    dynamic shared bytes and CTAs per SM (cudaFuncGetAttributes and the
    occupancy API, after the kernel is let have its dynamic shared
    memory), then the emitter build the launch takes (0 the two-survivor
    build, 3 / 9 the lane lists, < 0 a deep build: ``csrc/binned_select.
    cuh``'s ``deep_code``, -(100 survivor slots + 10 rows of a thread's
    query quad a pass + 1 where group indices are packed)) and its passes
    over each db tile.  Raises RuntimeError with the CUDA error
    when the device refuses the build, as its launch would."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"kernel_resources reads a built kernel on cuda, "
                         f"not {device}")
    out = (ctypes.c_int * len(RESOURCE_FIELDS))()
    if kernel == "tiled":
        fn = getattr(_cuda.load("binned_coarse"),
                     f"binned_select_attrs_{arm}")
        args = (bin_w, survivors, dp, ncodes, tile_n)
    else:
        fn = getattr(_cuda.load("binned_stream"),
                     f"stream_select_attrs_{arm}")
        args = (int(kernel == "fused"), bin_w, survivors, dp, ncodes, tile_n)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(
            f"the {kernel} {arm} build (bin_w={bin_w}, survivors="
            f"{survivors}, dp={dp}, tile_n={tile_n}) cannot launch on "
            f"{device}: cudaError {rc}")
    return dict(zip(RESOURCE_FIELDS, out))


def kernel_segment_tiles(n_q: int, n_tiles: int, device, kernel: str,
                         precision: str = "bf16x3", emit=(0, SURVIVORS),
                         pq_shape=(0, 0)) -> int:
    """Db tiles per segment that the ``kernel="streaming"`` or ``"fused"``
    kernel of arm ``precision`` in the binning ``emit`` = (bin_w,
    survivors) of the C entries (pq: at ``pq_shape`` = (m, C)) runs for
    ``n_q`` queries over ``n_tiles`` tiles on ``device``:
    :func:`stream_segment_tiles` over one wave of the card, one segment
    over every tile on the CPU (where the plain versions run).  The fused
    kernels' skipped cells depend on it (and on QUERY_BLOCK); no certified
    result does."""
    if kernel not in ("streaming", "fused"):
        raise ValueError(f"kernel {kernel!r} has no tile segments")
    device = torch.device(device)
    if device.type != "cuda":
        return n_tiles
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return stream_segment_tiles(
        n_q, n_tiles, n_sm * _stream_ctas_per_sm(device, kernel, precision,
                                                 emit, pq_shape))


def _pq_shape(operands, arm: str):
    """(m, C) of the pq arm's operands, (0, 0) for the other arms."""
    if arm != "pq":
        return (0, 0)
    m = operands[1].shape[1]
    return (m, operands[0].shape[1] // m)


def stream_select(*operands: torch.Tensor, tile_n: int, arm: str,
                  binning: str = "grouped", bin_w: Optional[int] = None,
                  survivors: Optional[int] = None):
    """The streaming wrapper (``kernel="streaming"``) — K10 (bf16x3) and
    the other arms' streaming entries: the function, operands, ``arm``,
    binning knobs and outputs of :func:`binned_select`, computed by one
    launch of ``stream_select_<arm>`` whose CTAs walk a segment of db tiles
    each (``csrc/binned_stream.cu``; the f32 and int arms stream them
    through a cp.async double buffer); its outputs are bitwise the tiled
    kernel's.  Its plain version is :func:`binned_select_plain` (the
    function is the same), which it runs for CPU tensors.
    ``stream_select.launches[arm]`` counts its kernel launches in grouped
    binning at two survivors, ``.deep_launches[arm]`` those at any other
    count, ``.lane_launches[arm]`` those in lane binning."""
    n_p = _check_operands(operands, tile_n, arm)
    geo = emit_geometry(tile_n, binning, bin_w, survivors)
    q = operands[0]
    if q.device.type == "cpu":
        return binned_select_plain(*operands, tile_n=tile_n, arm=arm,
                                   binning=binning, bin_w=bin_w,
                                   survivors=survivors)
    ints = _binning_ints(operands, arm, tile_n, binning, geo)
    seg = kernel_segment_tiles(q.shape[0], n_p // tile_n, q.device,
                               "streaming", arm, ints[:2],
                               _pq_shape(operands, arm))
    out = _launch("binned_stream", arm, f"stream_select_{arm}", operands,
                  n_p, tile_n, geo, seg, *ints)
    _launch_counts(stream_select, binning, geo)[arm] += 1
    return out


stream_select.launches = dict.fromkeys(ARMS, 0)
stream_select.deep_launches = dict.fromkeys(ARMS, 0)
stream_select.lane_launches = dict.fromkeys(ARMS, 0)


def _early_out(out, n_tiles: int, keep: Optional[int], block_q: int,
               seg_tiles: Optional[int]):
    """The fused arm's early-out (pallas_knn.py:776-824) replayed tile by
    tile on a tiled kernel's output ``(cd, ci, bounds)``, in place, at
    the given geometry — query blocks of ``block_q`` rows (a ragged last
    block decides on its real rows), the tile loop cut into segments of
    ``seg_tiles`` tiles (None: one segment), each with its own carry.

    Per (query, lane) the carry holds the ``carry_depth(keep)`` smallest
    lane minima seen in the segment.  A tile is skipped for a block when
    every row's tile minimum is strictly above ``thr``, the largest
    lane's deepest carry value before this tile; a skipped block writes
    +inf / INT32_MAX / +inf.  Depth 0 (keep None or too deep) skips
    nothing."""
    cd, ci, bounds = out
    depth = carry_depth(keep)
    if depth == 0:
        return cd, ci, bounds
    n_q = cd.shape[0]
    seg = n_tiles if seg_tiles is None else seg_tiles
    n_blocks = -(-n_q // block_q)
    out_w = cd.shape[1] // n_tiles   # survivors * BIN_W
    # survivor 0 of each bin is the lane minimum of its tile
    lane_min = cd.view(n_q, n_tiles, out_w // BIN_W, BIN_W)[:, :, 0].clone()
    carry = None
    for ti in range(n_tiles):
        if ti % seg == 0:
            carry = torch.full((depth, n_q, BIN_W), torch.inf,
                               device=cd.device)
        lm = lane_min[:, ti]
        row_ok = lm.amin(-1) > carry[depth - 1].amax(-1)
        fill = torch.ones(n_blocks * block_q - n_q, dtype=torch.bool,
                          device=cd.device)
        skip = torch.cat([row_ok, fill]).view(n_blocks, block_q).all(-1)
        rows = skip.repeat_interleave(block_q)[:n_q]
        cd[rows, ti * out_w : (ti + 1) * out_w] = torch.inf
        ci[rows, ti * out_w : (ti + 1) * out_w] = I32MAX
        bounds[rows, ti * BIN_W : (ti + 1) * BIN_W] = torch.inf
        cur = lm
        for d in range(depth):
            lo = torch.minimum(carry[d], cur)
            cur = torch.maximum(carry[d], cur)
            carry[d] = lo
    return cd, ci, bounds


def fused_select_plain(*operands: torch.Tensor, tile_n: int,
                       keep: Optional[int], arm: str,
                       block_q: int = QUERY_BLOCK,
                       seg_tiles: Optional[int] = None,
                       survivors: Optional[int] = None):
    """The fused kernels (K11 and the other arms' fused entries) in plain
    PyTorch: :func:`binned_select_plain` (grouped binning at ``survivors``),
    then the early-out (:func:`_early_out`) at the given geometry.  Depth
    0 (keep None or too deep) skips nothing: the output is the streaming
    kernel's.  pq is refused, as the JAX package refuses it."""
    if arm == "pq":
        check_knobs(kernel="fused", precision="pq")
    out = binned_select_plain(*operands, tile_n=tile_n, arm=arm,
                              survivors=survivors)
    return _early_out(out, out[2].shape[1] // BIN_W, keep, block_q,
                      seg_tiles)


def fused_select(*operands: torch.Tensor, tile_n: int, keep: Optional[int],
                 arm: str, survivors: Optional[int] = None):
    """The fused wrapper (``kernel="fused"``) — K11 (bf16x3) and the other
    arms' fused entries: the streaming kernel plus the early-out that pads
    a tile's block for a query block when no row of the block can use it;
    ``keep`` (= m+2, the final select's width) sizes the carry, None
    disarms it.  Operands and ``arm`` as :func:`binned_select` takes them;
    grouped binning at ``survivors`` (default 2).  On a CUDA tensor it
    launches ``fused_select_<arm>`` (``csrc/binned_stream.cu``) at
    :func:`kernel_segment_tiles`, or raises; on a CPU tensor it runs
    :func:`fused_select_plain` at the CPU geometry.
    ``fused_select.launches[arm]`` counts its kernel launches at two
    survivors, ``.deep_launches[arm]`` those at any other count."""
    if arm == "pq":
        check_knobs(kernel="fused", precision="pq")  # refused by name
    n_p = _check_operands(operands, tile_n, arm)
    geo = emit_geometry(tile_n, survivors=survivors)
    q = operands[0]
    seg = kernel_segment_tiles(q.shape[0], n_p // tile_n, q.device, "fused",
                               arm, (0, geo[1]))
    if q.device.type == "cpu":
        return fused_select_plain(*operands, tile_n=tile_n, keep=keep,
                                  seg_tiles=seg, arm=arm,
                                  survivors=survivors)
    out = _launch("binned_stream", arm, f"fused_select_{arm}", operands,
                  n_p, tile_n, geo, seg, carry_depth(keep), geo[1])
    _launch_counts(fused_select, "grouped", geo)[arm] += 1
    return out


fused_select.launches = dict.fromkeys(ARMS, 0)
fused_select.deep_launches = dict.fromkeys(ARMS, 0)


def _truncate(x: np.ndarray, ulp: np.ndarray) -> np.ndarray:
    return np.trunc(x / ulp) * ulp


def _ulp24(x: np.ndarray) -> np.ndarray:
    """2^(e - 23) for |x| in [2^e, 2^(e+1)): the spacing of a 24-bit
    significand at x's exponent (1 where x is 0)."""
    _, e = np.frexp(np.where(x == 0, 1.0, x))
    return np.ldexp(1.0, e - 24)


def mma_step_model(c: np.ndarray, p: np.ndarray, block: int = 8) -> np.ndarray:
    """The header's model of one tensor-core k-step of the bf16x3 kernels
    (csrc/binned_mma.cuh), in float64: ``c`` [...] accumulators, ``p``
    [..., k] exact products.  The products are summed in blocks of
    ``block``, the accumulator entering the first: each block's addends
    are aligned to its largest and truncated to 24 bits, the block's sum
    normalised to 24 bits by truncation.  Returns the new accumulators."""
    acc = np.asarray(c, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    for lo in range(0, p.shape[-1], block):
        addends = np.concatenate([acc[..., None], p[..., lo:lo + block]], -1)
        ulp = _ulp24(np.abs(addends).max(-1))
        total = _truncate(addends, ulp[..., None]).sum(-1)
        acc = _truncate(total, _ulp24(np.abs(total)))
    return acc


def mma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One k-step of the bf16x3 kernels' tensor-core product on its own:
    ``d = c + a @ b.T`` for ``a`` [16, 16] bf16, ``b`` [8, 16] bf16 and
    ``c`` [16, 8] f32 — the probe of the rounding model that the bf16x3
    tolerance is proved from.  On a CUDA tensor it launches the C entry
    ``mma_probe_bf16`` (``csrc/binned_coarse.cu``: one warp, one
    ``mma.sync`` m16n8k16), or raises; on a CPU tensor it runs
    :func:`mma_step_model`.  ``mma_probe.launches`` counts launches."""
    if (a.dtype != torch.bfloat16 or tuple(a.shape) != (16, MMA_K)
            or b.dtype != torch.bfloat16 or tuple(b.shape) != (8, MMA_K)
            or c.dtype != torch.float32 or tuple(c.shape) != (16, 8)):
        raise ValueError("mma_probe takes a [16, 16] bf16, b [8, 16] bf16, "
                         "c [16, 8] f32")
    a, b, c = (t.contiguous() for t in (a, b, c))
    if a.device.type == "cpu":
        p = a.double().numpy()[:, None, :] * b.double().numpy()[None, :, :]
        return torch.from_numpy(
            mma_step_model(c.double().numpy(), p).astype(np.float32))
    if a.device.type != "cuda":
        raise ValueError(f"mma_probe runs on cuda or cpu, not {a.device}")
    d = torch.empty_like(c)
    fn = _cuda.load("binned_coarse").mma_probe_bf16
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mma_probe_bf16 launch failed: cudaError {rc}")
    mma_probe.launches += 1
    return d


mma_probe.launches = 0


def _mma_probe_cases():
    """Operands (a, b, c) of the rounding probe, by name: products below
    an accumulator of 1 that a round-to-nearest sum keeps and a truncating
    alignment drops (0.75 ulp up and down; sixteen of 0.47 ulp each), and
    random signs and magnitudes."""
    cases = {}
    ones = np.ones((16, 8), np.float32)
    for name, av in (("one_product_up_0.75ulp", 1.5 * 2.0 ** -12),
                     ("one_product_down_0.75ulp", -1.5 * 2.0 ** -12)):
        a = np.zeros((16, MMA_K), np.float32)
        a[:, 0] = av
        b = np.zeros((8, MMA_K), np.float32)
        b[:, 0] = 2.0 ** -12
        cases[name] = (a, b, ones)
    cases["sixteen_products_0.47ulp"] = (
        np.full((16, MMA_K), 0.9375 * 2.0 ** -12, np.float32),
        np.full((8, MMA_K), 2.0 ** -12, np.float32), ones)
    rng = np.random.default_rng(18)
    cases["random"] = (rng.normal(size=(16, MMA_K)).astype(np.float32),
                       rng.normal(size=(8, MMA_K)).astype(np.float32),
                       (rng.normal(size=(16, 8)) * 4).astype(np.float32))
    return cases


def mma_rounding_probe(device) -> dict:
    """Runs :func:`mma_probe` on the probe's cases on ``device`` and
    compares each output with the exact f64 sum: the largest error over
    the model's bound ``MMA_KAPPA u (|c| + sum |p|)`` (must stay <= 1 for
    the proof to hold), and which rounding each case's outputs match --
    the model's truncating sum in blocks of 8 or of 16, or one
    round-to-nearest of the exact sum."""
    out = {}
    for name, (a, b, c) in _mma_probe_cases().items():
        at = torch.from_numpy(a).to(torch.bfloat16)
        bt = torch.from_numpy(b).to(torch.bfloat16)
        d = mma_probe(at.to(device), bt.to(device),
                      torch.from_numpy(c).to(device)).cpu().double().numpy()
        p = at.double().numpy()[:, None, :] * bt.double().numpy()[None, :, :]
        c64 = c.astype(np.float64)
        exact = c64 + p.sum(-1)
        bound = MMA_KAPPA * U32 * (np.abs(c64) + np.abs(p).sum(-1))
        out[name] = {
            "max_error_over_bound": float((np.abs(d - exact) / bound).max()),
            "max_abs_err_ulps": float((np.abs(d - exact)
                                       / _ulp24(np.abs(exact))).max()),
            "truncating_blocks_of_8": bool(
                np.array_equal(d, mma_step_model(c64, p, 8))),
            "truncating_blocks_of_16": bool(
                np.array_equal(d, mma_step_model(c64, p, 16))),
            "round_to_nearest": bool(
                np.array_equal(d, exact.astype(np.float32))),
        }
    return out


def dmma_step_model(c: np.ndarray, p: np.ndarray) -> np.ndarray:
    """One realization of the header's model of an FP64 tensor-core k-step
    of the highest kernels (csrc/binned_mma.cuh): ``c`` [...]
    accumulators, ``p`` [..., k] exact products, added to the accumulator
    one by one in k order, each add rounded to nearest in f64.  Returns
    the new accumulators."""
    acc = np.array(c, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    for k in range(p.shape[-1]):
        acc = acc + p[..., k]
    return acc


def dmma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One FP64 k-step of the highest kernels' tensor-core product on its
    own: ``d = c + a @ b.T`` for ``a`` [16, 8], ``b`` [8, 8] and ``c`` [16,
    8], all float64 — the probe of the step model highest's bound rests
    on.  On a CUDA tensor it launches the C entry ``dmma_probe_f64``
    (``csrc/binned_coarse.cu``: one warp, one ``mma.sync`` m16n8k8 f64), or
    raises; on a CPU tensor it runs :func:`dmma_step_model`.
    ``dmma_probe.launches`` counts launches."""
    if (a.dtype != torch.float64 or tuple(a.shape) != (16, DMMA_K)
            or b.dtype != torch.float64 or tuple(b.shape) != (8, DMMA_K)
            or c.dtype != torch.float64 or tuple(c.shape) != (16, 8)):
        raise ValueError("dmma_probe takes a [16, 8], b [8, 8], c [16, 8] "
                         "float64")
    a, b, c = (t.contiguous() for t in (a, b, c))
    if a.device.type == "cpu":
        p = a.numpy()[:, None, :] * b.numpy()[None, :, :]
        return torch.from_numpy(dmma_step_model(c.numpy(), p))
    if a.device.type != "cuda":
        raise ValueError(f"dmma_probe runs on cuda or cpu, not {a.device}")
    d = torch.empty_like(c)
    fn = _cuda.load("binned_coarse").dmma_probe_f64
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dmma_probe_f64 launch failed: cudaError {rc}")
    dmma_probe.launches += 1
    return d


dmma_probe.launches = 0


def _dmma_probe_cases():
    """Operands (a, b, c) of highest's rounding probe, by name: every row
    of ``a`` holds the same products (``b`` is all ones, so they are
    exact), added to an accumulator of 1 — half-ulp ties (one, and eight
    that a round-to-nearest chain drops one by one), products far below
    the accumulator, cancellation after a tie and of the accumulator
    itself — and random f32 values, whose f64 products are exact as the
    kernels' are."""
    ones_b = np.ones((8, DMMA_K))
    acc1 = np.ones((16, 8))

    def rows(*vals):
        return np.tile(np.array(vals + (0.0,) * (DMMA_K - len(vals))), (16, 1))

    tie = U64                      # half an ulp of 1.0
    cases = {
        "half_ulp_tie": (rows(tie), ones_b, acc1),
        "eight_half_ulp_ties": (rows(*[tie] * DMMA_K), ones_b, acc1),
        "far_below_the_accumulator": (rows(*[2.0 ** -60] * DMMA_K), ones_b,
                                      acc1),
        "cancellation_after_a_tie": (rows(3 * tie, -1.0), ones_b, acc1),
        "cancellation_of_the_accumulator": (
            rows(-1.0, 2.0 ** -30, 2.0 ** -60, -(2.0 ** -31), 2.0 ** -80),
            ones_b, acc1),
    }
    rng = np.random.default_rng(53)
    f32 = np.float32
    cases["random"] = (rng.normal(size=(16, DMMA_K)).astype(f32).astype(float),
                       rng.normal(size=(8, DMMA_K)).astype(f32).astype(float),
                       (rng.normal(size=(16, 8)) * 4).astype(f32).astype(float))
    return cases


def dmma_rounding_probe(device) -> dict:
    """Runs :func:`dmma_probe` on the probe's cases on ``device`` and
    compares each output with the exact sum (``fractions.Fraction``): the
    largest error over the model's bound ``DMMA_K 2^-53 (|c| + sum |p|)``
    (must stay <= 1 for highest's proof to hold), the largest error in
    units of 2^-53 (|c| + sum |p|) (an ulp of the addends' magnitude, at
    most DMMA_K under the model), and whether the outputs are the exact sum
    rounded once to nearest, or the model's chain in k order
    (:func:`dmma_step_model`)."""
    from fractions import Fraction

    out = {}
    for name, (a, b, c) in _dmma_probe_cases().items():
        d = dmma_probe(*(torch.from_numpy(x).to(device) for x in (a, b, c)))
        d = d.cpu().numpy()
        p = a[:, None, :] * b[None, :, :]
        ratio = ulps = 0.0
        once = True
        for r in range(16):
            for n in range(8):
                exact = Fraction(c[r, n]) + sum(
                    Fraction(a[r, k]) * Fraction(b[n, k])
                    for k in range(DMMA_K))
                err = abs(Fraction(d[r, n]) - exact)
                bound = DMMA_K * Fraction(U64) * (
                    abs(Fraction(c[r, n]))
                    + sum(abs(Fraction(x)) for x in p[r, n]))
                ratio = max(ratio, float(err / bound))
                ulps = max(ulps, float(err / (bound / DMMA_K)))
                once = once and d[r, n] == float(exact)
        out[name] = {
            "max_error_over_bound": ratio, "max_err_units": ulps,
            "round_to_nearest_once": bool(once),
            "chain_in_k_order": bool(np.array_equal(d, dmma_step_model(c, p))),
        }
    return out


def skipped_cells(cd: torch.Tensor, n_tiles: int,
                  block_q: int = QUERY_BLOCK) -> torch.Tensor:
    """Bool ``[query blocks, n_tiles]``: the (block, tile) cells K11
    skipped, read from its ``cd`` — a cell is skipped when every
    candidate of its block is +inf, which an emitted tile never has
    (pad rows score ~1e35, or PAD_VAL for a pre-quantized db, not
    +inf)."""
    n_q = cd.shape[0]
    n_blocks = -(-n_q // block_q)
    inf = torch.isinf(cd).view(n_q, n_tiles, -1).all(-1)
    pad = torch.ones((n_blocks * block_q - n_q, n_tiles), dtype=torch.bool,
                     device=cd.device)
    return torch.cat([inf, pad]).view(n_blocks, block_q, n_tiles).all(1)


def _bin_candidates(queries: torch.Tensor, db: Optional[torch.Tensor], *,
                    tile_n: int, db_parts=None, kernel: str = "tiled",
                    keep: Optional[int] = None, precision: str = "bf16x3",
                    db_quant=None, offset: float = 0.0,
                    grid_order: str = "query_major", db_pq=None,
                    binning: str = "grouped", bin_w: Optional[int] = None,
                    survivors: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel launch on padded shapes (the JAX package's
    ``_bin_candidates`` for every arm).  ``db_parts`` plugs in a
    placement's db operands of the arm, padded to ``round_up(N, tile_n)``
    rows: ``(th, tl, tnorm)`` for bf16x3 / bf16x3f, ``(th, tnorm)`` for
    default, ``(t, tnorm)`` for highest, ``(t, aux)`` for the int arms,
    ``(codes, tnorm)`` for pq.  None prepares them here: from ``db_quant``
    (the unpadded ``(values, scales, norms)`` triple the JAX package takes
    as ``db_int8`` / ``db_int4``) when given, else from ``db``.
    ``precision="pq"`` requires ``db_pq = (codes uint8 [N, m], codebooks
    f32 [m, C, dsub])`` on the queries' device: the LUT is built from the
    codebooks, the db operands from the codes unless ``db_parts`` holds
    them.  ``offset`` is the shift both sides of an int arm subtract
    before quantizing (128.0 for uint8 payloads).  ``kernel`` picks the
    tiled, streaming or fused kernel, ``grid_order`` the tiled kernel's
    grid, ``binning`` / ``bin_w`` / ``survivors`` the emitter; ``keep``
    sizes the fused kernels' carry (ignored by the others).  Returns cd,
    ci, bounds for the query rows given (the JAX kernel's query padding
    never leaves it)."""
    if precision == "pq":
        if db_pq is None:
            raise ValueError(
                "precision='pq' requires db_pq=(codes, codebooks): PQ "
                "codebooks train on data (ops.pq.train_pq)")
        codes, books = db_pq
        if db is not None and codes.shape[0] != db.shape[0]:
            raise ValueError(
                f"db_pq codes rows ({codes.shape[0]}) do not match the db "
                f"rows ({db.shape[0]}) the rescore gathers from")
        if db_parts is None:
            db_parts = prepare_db_pq(codes, tile_n)
        operands = (pq_luts(queries, books), *db_parts)
    elif precision in INT_ARMS:
        if db_parts is None:
            db_parts = (prepare_db_quant(*db_quant, tile_n)
                        if db_quant is not None
                        else prepare_db_int(db, tile_n, precision, offset))
        t, aux = db_parts
        if t.dtype != INT_ARMS[precision]:
            raise ValueError(
                f"precision={precision!r} takes a {INT_ARMS[precision]} db "
                f"operand, got {t.dtype}")
        operands = (*quantize_queries(queries, offset), t, aux)
    else:
        if db_parts is None:
            db_parts = prepare_db_arm(db, tile_n, precision)
        operands = (pad_queries(queries), *db_parts)
    check_knobs(precision=precision, binning=binning, kernel=kernel,
                grid_order=grid_order, bin_w=bin_w, survivors=survivors)
    emit = {"binning": binning, "bin_w": bin_w, "survivors": survivors}
    if kernel == "fused":
        return fused_select(*operands, tile_n=tile_n, keep=keep,
                            arm=precision, survivors=survivors)
    if kernel == "streaming":
        return stream_select(*operands, tile_n=tile_n, arm=precision, **emit)
    return binned_select(*operands, tile_n=tile_n, arm=precision,
                         grid_order=grid_order, **emit)


def local_coarse_candidates(q, t, m: int, *, tile_n: int = TILE_N,
                            bin_w: Optional[int] = None,
                            survivors: Optional[int] = None,
                            precision: str = "bf16x3",
                            binning: str = "grouped",
                            grid_order: str = "query_major",
                            kernel: str = "tiled",
                            final_select: str = "exact", db_parts=None,
                            db_quant=None, offset: float = 0.0, db_pq=None):
    """Stage 1: resolve the effective tile and run the coarse pass
    (``kernel="fused"`` sizes its carry with ``keep = m+2``, as
    pallas_knn.py:1406 does).  ``db_parts``, ``db_quant``, ``offset`` and
    ``db_pq`` as :func:`_bin_candidates` takes them.  Returns ``(cd [Q,
    W], ci [Q, W], bounds [Q, T*bound_w])``."""
    check_knobs(precision=precision, binning=binning, grid_order=grid_order,
                kernel=kernel, final_select=final_select, bin_w=bin_w,
                survivors=survivors)
    eff_tile = effective_tile(t.shape[0], tile_n, bin_w or BIN_W, survivors,
                              binning, m + 2)
    if db_parts is not None and db_parts[0].shape[0] != _round_up(t.shape[0], eff_tile):
        raise ValueError(
            f"db_parts hold {db_parts[0].shape[0]} rows; the {eff_tile}-row "
            f"tile needs {_round_up(t.shape[0], eff_tile)}")
    return _bin_candidates(q, t, tile_n=eff_tile, db_parts=db_parts,
                           kernel=kernel,
                           keep=m + 2 if kernel == "fused" else None,
                           precision=precision, db_quant=db_quant,
                           offset=offset, grid_order=grid_order, db_pq=db_pq,
                           binning=binning, bin_w=bin_w, survivors=survivors)


def local_select_rescore(q, t, cd, ci, bounds, m: int, *,
                         final_select: str = "exact",
                         final_recall_target: Optional[float] = None):
    """Stage 2 (pallas_knn.py:1424-1478): the final select over the packed
    candidates by kernel score, the exclusion value, the pad-row mask, and
    the direct-difference f32 rescore ordered lexicographically by
    (distance, index).  ``final_select="exact"``: the top-(m+2) by stable
    sort (ties to the lower position, ``lax.top_k``'s order), the last
    value the exclusion value.  ``"approx"``: the reference's ApproxTopK
    branch selects m+1 and restores the exclusion value as the masked min
    of the rest; torch has no approximate top-k, and with an exact
    top-(m+1) that min is the exact branch's exclusion value, so "approx"
    runs the exact select and ``final_recall_target`` has no effect
    (ROADMAP divergence 19).
    Returns ``d32 [Q, m+1]``, ``idx [Q, m+1]`` (int64, sentinel int32 max)
    and ``lb [Q]``: every row not among the candidates has kernel score >=
    lb."""
    w = cd.shape[1]
    if m + 2 > w:
        raise ValueError(
            f"pallas selector: m+2={m + 2} exceeds {w} bin survivors on a "
            f"{t.shape[0]}-row shard; lower margin or tile_n")
    check_knobs(final_select=final_select)
    # "approx" runs this exact select too (divergence 19): with an exact
    # top-(m+1), the masked min of the rest is vals[:, m+1]
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
                               final_recall_target: Optional[float] = None,
                               db_parts=None, **knobs):
    """The whole device-side certified coarse pass against one db:
    :func:`local_coarse_candidates` then :func:`local_select_rescore`.
    Returns ``(d32 [Q, m+1], idx [Q, m+1], lb [Q])``."""
    cd, ci, bounds = local_coarse_candidates(
        q, t, m, final_select=final_select, db_parts=db_parts, **knobs)
    return local_select_rescore(q, t, cd, ci, bounds, m,
                                final_select=final_select,
                                final_recall_target=final_recall_target)


def knn_search_pallas(queries, db, k: int, *, margin: int = 28,
                      tile_n: int = TILE_N, precision: str = "bf16x3",
                      bin_w: Optional[int] = None,
                      survivors: Optional[int] = None,
                      final_select: str = "exact", binning: str = "grouped",
                      final_recall_target: Optional[float] = None,
                      grid_order: str = "query_major", kernel: str = "tiled",
                      device=None, pq_dsub: Optional[int] = None,
                      pq_ncodes: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Certified-exact KNN in one database pass — the port of
    pallas_knn.knn_search_pallas (pallas_knn.py:1581-1631): places ``db``
    on ``device`` (default ``cuda``) and calls
    ``ShardedKNN.search_certified(selector="pallas")``, so both share one
    certificate.  Returns ``(dists [Q, k] float64, idx [Q, k], stats)``.
    Every call places the database afresh; repeated searches should build
    a ``ShardedKNN`` once.  ``pq_dsub`` / ``pq_ncodes`` set the pq
    placement's geometry (None: 4 dims, 256 codes; the JAX package reads
    them from environment switches).  (The JAX package's ``block_q`` is not
    taken: the CUDA kernels pick their own query block.)"""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    prog = ShardedKNN(np.asarray(db, dtype=np.float32), k=k, device=device)
    return prog.search_certified(
        np.asarray(queries, dtype=np.float32), margin=margin,
        selector="pallas", tile_n=tile_n, precision=precision, bin_w=bin_w,
        survivors=survivors, final_select=final_select, binning=binning,
        final_recall_target=final_recall_target, grid_order=grid_order,
        kernel=kernel, pq_dsub=pq_dsub, pq_ncodes=pq_ncodes)


def kernel_tolerance(queries_np: np.ndarray, db_np: np.ndarray, *,
                     db_norm_max: Optional[float] = None,
                     precision: str = "bf16x3",
                     q_norm: Optional[np.ndarray] = None,
                     quant=None) -> np.ndarray:
    """Per-query bound on |kernel score - exact score|
    (pallas_knn.py:1517-1578):

    - "highest": 4x certification_tolerance (= 32 eps_f32 (||q||^2 +
      max||t||^2));
    - "bf16x3", "bf16x3f": :func:`bf16_tolerance_scale` (||q||^2 +
      max||t||^2) -- the bf16 split's proved error, the arm's kernel's
      summation bound and the f32 headroom, never below the reference's
      2^-14 (its model puts the split at 1/16 of that; ROADMAP divergence
      18);
    - "int8", "int4": the larger of "highest"'s and the provable
      quantization bound ε from the actual residuals
      (ops.quantize.score_error_bound).  ``quant`` supplies the
      placement's ``QuantizedRows``; None quantizes ``db_np`` here;
    - "pq": the larger of "highest"'s and the per-subspace bound
      (ops.pq.score_error_bound_pq); ``quant`` must be the trained
      ``ops.pq.PQResult`` (codebooks train on data)."""
    from knn_tpu_torch.ops.certified import certification_tolerance

    if q_norm is None:
        q_norm = (queries_np.astype(np.float64) ** 2).sum(-1)
    if db_norm_max is None:
        db_norm_max = float((db_np.astype(np.float64) ** 2).sum(-1).max())
    base = 4.0 * certification_tolerance(
        queries_np, db_np, db_norm_max=db_norm_max, q_norm=q_norm)
    if precision in INT_ARMS:
        if quant is None:
            quant = (quantize_rows_np(db_np) if precision == "int8"
                     else quantize_rows_int4_np(db_np))
        stats = db_bound_stats(quant, db_np)
        return np.maximum(
            base, score_error_bound(queries_np, stats, offset=quant.offset))
    if precision == "pq":
        from knn_tpu_torch.ops.pq import score_error_bound_pq

        if quant is None:
            raise ValueError(
                "precision='pq' needs quant=<ops.pq.PQResult> (codebooks "
                "train on data)")
        return np.maximum(base, score_error_bound_pq(queries_np, quant.stats))
    if precision in ("bf16x3", "bf16x3f"):
        nd = -(-queries_np.shape[1] // DIM_CHUNK)
        return np.maximum(base, bf16_tolerance_scale(precision, nd)
                          * (q_norm + db_norm_max))
    if precision == "highest":
        return base
    raise ValueError(
        f"precision {precision!r} has no certified tolerance model; use "
        f"'bf16x3', 'bf16x3f', 'int8', 'int4', 'pq' or 'highest'")


def pallas_knn_candidates(queries: torch.Tensor, db: torch.Tensor, m: int, *,
                          tile_n: int = TILE_N, precision: str = "bf16x3",
                          **knobs) -> torch.Tensor:
    """[Q, m] coarse candidate indices from the coarse kernel of arm
    ``precision`` (pallas_knn.py:1482-1514) — the ``candidate_fn`` plug of
    ops.certified.knn_search_certified.  The kernel needs one exclusion
    slot, so a whole-db request (m >= n) selects ``m_eff = min(m, n-1)``
    rows and pads the rest with the int32-max sentinel: the count
    certificate catches the one row left out.  ``knobs`` (``kernel``,
    ``grid_order``) pass on to the coarse pass; the JAX package's
    ``block_q``, ``interpret`` and ``compute_dtype`` have no counterpart
    here.  Returns int64 indices on the queries' device."""
    n_q = queries.shape[0]
    m_eff = min(m, max(db.shape[0] - 1, 1))
    _, idx, _ = local_certified_candidates(queries, db, m_eff, tile_n=tile_n,
                                           precision=precision, **knobs)
    idx = idx[:n_q, :m_eff]
    if m_eff < m:
        idx = torch.cat([idx, torch.full((n_q, m - m_eff), I32MAX,
                                         dtype=idx.dtype, device=idx.device)],
                        dim=-1)
    return idx
