"""The analytic roofline of the port's search paths on the H100 — the
counterpart of knn_tpu/obs/roofline.py, built on the card's own units.

The JAX package's table holds TPU generations and prices MXU passes and a
VPU select rate; none of that applies here.  This module holds the card's
peaks (:data:`PEAKS_BY_KIND`) and, per configuration, the least time the
card could take for the work the function needs — the larger of its terms,
each the work over the card's peak rate for it:

- ``hbm`` — bytes: every input read once, every output written once,
  counted over the REAL rows and the REAL dims (the rows that pad the last
  tile and the zero columns that pad a row to Dp are work the function
  does not need), over the HBM rate;
- ``tensor_core`` — the distance products over the dense tensor-core rate
  of their type: bf16 for bf16x3 / bf16x3f (three products of the hi / lo
  parts) and default (one), FP64 for highest, int8 for int8 / int4;
- ``smem`` — pq's table lookups over the shared-memory word rate (32 words
  a clock an SM): a lookup is a data-dependent gather no tensor core does;
- ``cuda_core`` — f32 arithmetic on the CUDA cores: pq's adds, the IVF
  centroid scan, and the counted selectors' f32 products, selection
  compares and count;
- ``h2d`` — the join's host→device query stream over the host link.

``ceiling_qps = nq / max(term times)`` and ``bound_class`` names the
largest term, so a measured ``roofline_pct = measured / ceiling`` can never
honestly read above 1.  :func:`f32_bound`, :func:`int_bound` and
:func:`pq_bound` are the per-kernel bounds ``chip_smoke.py`` writes beside
each kernel's time (K1 3.18 ms, K5 0.53 ms, K7 15.67 ms at the SIFT1M
shape); :func:`pallas_cost_model` is built from them.

Where the port differs (ROADMAP divergence 34): the bound classes are the
card's — ``hbm_bound``, ``tensor_core_bound``, ``cuda_core_bound``,
``smem_bound``, ``h2d_bound`` — in place of ``mxu_bound`` /
``vpu_select_bound``; a term counts the work the function needs (one db
read), where the JAX model counts the kernel's re-streams per query block;
the terms are a bound, not a serialized sum (:func:`_combined`); the JAX
package's ``xla_cost_model`` is :func:`counted_cost_model` here (the
counted ``exact`` / ``approx`` selectors); and the DCN term of ``db_hosts
> 1`` (:func:`_dcn_term`: parallel.crossover.merge_bytes of the
cross-host merge) is priced at a card's cross-node rate from a public
H100 system data sheet (:data:`DCN_GBPS_BY_KIND`), never the TPU's DCN
figure, and enters the bound as ``dcn_bound``.  An
unknown device kind gets :data:`GENERIC_CPU_PEAKS` with ``estimated``
set, as in the JAX package.

Every block consults the calibration overlay
(:mod:`knn_tpu_torch.obs.calibrate`, the store set by
``calibrate.configure(store=)``): where the store holds an entry for the
block's key, each term is re-timed by its measured factor, ``ceiling_qps``
and ``bound_class`` become the calibrated ones (``ceiling_qps_analytic``
keeps the data-sheet ceiling) and ``term_times_calibrated_s`` and
``calibration: {applied: true, factors, source, ...}`` go on the block;
else ``calibration: {applied: false}``, with a ``note`` on the probed (IVF)
and join blocks no entry covers, or an ``error`` when the store cannot be
read.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

from knn_tpu_torch.obs import names, registry, trace

#: bump when the model's terms, peaks or block schema change: the tuning
#: cache embeds it in its key (tuning.cache.roofline_token), so winners
#: carrying an older model's attribution miss
MODEL_VERSION = 1

#: the card's resources a configuration can exhaust, in tie-break order
BOUND_CLASSES = ("hbm_bound", "tensor_core_bound", "cuda_core_bound",
                 "smem_bound", "h2d_bound", "dcn_bound")

#: term name -> its bound class
_TERM_CLASS = {"hbm": "hbm_bound", "tensor_core": "tensor_core_bound",
               "cuda_core": "cuda_core_bound", "smem": "smem_bound",
               "h2d": "h2d_bound", "dcn": "dcn_bound"}

H100 = "NVIDIA H100 80GB HBM3"

#: per-device-kind peaks (dense rates, FLOP/s or op/s; GB/s): the H100 SXM
#: data sheet — bf16, FP64 and int8 tensor cores, f32 on the CUDA cores
#: (an FMA counts as two), HBM3, the PCIe Gen5 x16 host link, shared
#: memory's 32 four-byte words a clock an SM, 132 SMs at a 1980 MHz
#: maximum SM clock
PEAKS_BY_KIND: Dict[str, Dict[str, float]] = {
    H100: {"bf16_flops": 989e12, "fp64_tc_flops": 67e12,
           "int8_ops": 1979e12, "f32_flops": 67e12, "hbm_gbps": 3350.0,
           "h2d_gbps": 64.0, "smem_words_per_clock": 32.0,
           "sm_count": 132.0, "sm_clock_hz": 1.98e9},
}

#: the peaks of each kind that are estimates, not data-sheet rates: the
#: host link's 64 GB/s is the Gen5 x16 signalling rate, which no transfer
#: reaches
ESTIMATED_PEAKS: Dict[str, Tuple[str, ...]] = {H100: ("h2d_gbps",)}

#: the fallback for the CPU and unknown kinds: round numbers for one
#: modern core and dual-channel DRAM; a block computed from them carries
#: ``estimated: true``
GENERIC_CPU_PEAKS: Dict[str, float] = {
    "bf16_flops": 100e9, "fp64_tc_flops": 50e9, "int8_ops": 200e9,
    "f32_flops": 100e9, "hbm_gbps": 25.0, "h2d_gbps": 25.0,
    "smem_words_per_clock": 32.0, "sm_count": 1.0, "sm_clock_hz": 3e9,
}

_H = PEAKS_BY_KIND[H100]
PEAK_BF16_FLOPS = _H["bf16_flops"]
PEAK_FP64_TC_FLOPS = _H["fp64_tc_flops"]
PEAK_INT8_OPS = _H["int8_ops"]
PEAK_F32_FLOPS = _H["f32_flops"]
PEAK_HBM_BYTES = _H["hbm_gbps"] * 1e9
#: shared-memory words one SM loads per clock (32 banks of 4 bytes)
SMEM_WORDS_PER_CLOCK = int(_H["smem_words_per_clock"])

#: per f32-family arm: products of 2*Q*N*D FLOPs, the peak key of their
#: type, db bytes per row and dim.  bf16x3 / bf16x3f three bf16 products
#: of th, tl; default one of th; highest one f64 product of the f32 rows
#: on the FP64 tensor cores — the route that keeps its proof.  3xTF32 (a
#: hi / lo split on the tf32 tensor cores, 6.36 ms at the main shape) is
#: no route for this arm: its f32 accumulation errs by up to 20 u per
#: m16n8k8 step (csrc/binned_mma.cuh's step model), 320 u P over a
#: chunk's hi.hi products alone, five times highest's whole 64 u budget
F32_ARMS = {"bf16x3": (3, "bf16_flops", 4), "bf16x3f": (3, "bf16_flops", 4),
            "default": (1, "bf16_flops", 2),
            "highest": (1, "fp64_tc_flops", 4)}
#: the same at the H100's rates: (products, peak FLOP/s, db bytes)
F32_WORK = {arm: (p, _H[key], b) for arm, (p, key, b) in F32_ARMS.items()}

#: arms of the one-pass (pallas) certificate
PRECISIONS = ("bf16x3", "bf16x3f", "default", "highest", "int8", "int4",
              "pq")

#: kernel geometry defaults mirrored from ops.coarse_knn (TILE_N, BIN_W,
#: DIM_CHUNK, the grouped survivors and their cap) so this module stays
#: free of torch; tests/test_torch_roofline.py pins them
TILE_N_DEFAULT = 16384
BIN_W = 128
DIM_CHUNK = 128
SURVIVORS_GROUPED_DEFAULT = 2
MAX_SURVIVORS = 8
PQ_DSUB_DEFAULT = 4
PQ_NCODES_DEFAULT = 256

#: a bench line's metric name: its shape (the JAX package's pattern)
_METRIC_RE = re.compile(r"^knn_qps_.+_n(?P<n>\d+)_d(?P<d>\d+)_k(?P<k>\d+)$")

_lock = threading.Lock()
#: config label -> last published compact attribution (bounded)
_LAST: Dict[str, dict] = {}
_LAST_MAX = 16
#: every label ever published in this process (the publish-once dedup)
_PUBLISHED: set = set()


def peaks_for(device_kind: Optional[str] = None,
              backend: Optional[str] = None) -> Tuple[Dict[str, float], bool]:
    """``(peaks, estimated)``: the kind's peak record, or the generic CPU
    fallback with ``estimated=True`` for an unknown kind or the cpu
    backend."""
    if backend != "cpu" and device_kind in PEAKS_BY_KIND:
        return dict(PEAKS_BY_KIND[device_kind]), False
    return dict(GENERIC_CPU_PEAKS), True


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * int(b)


def geometry(tile_n: int, bin_w: int = BIN_W,
             survivors: Optional[int] = None,
             binning: str = "grouped") -> Tuple[int, int, int, int]:
    """``(n_bins, survivors, out_w, bound_w)`` of one db tile —
    ops.coarse_knn._geometry's arithmetic."""
    if binning == "grouped":
        surv = min(survivors or SURVIVORS_GROUPED_DEFAULT, MAX_SURVIVORS)
        return BIN_W, surv, surv * BIN_W, BIN_W
    n_bins = tile_n // bin_w
    if survivors is None:
        survivors = min(max(2, 128 // n_bins), MAX_SURVIVORS, bin_w)
    surv = min(survivors, MAX_SURVIVORS, bin_w)
    return (n_bins, surv, _round_up(n_bins * surv, 128),
            _round_up(n_bins, 128))


def effective_tile(rows: int, tile_n: int, bin_w: int,
                   survivors: Optional[int], binning: str,
                   min_width: int) -> int:
    """The db tile a launch runs — ops.coarse_knn.effective_tile's
    arithmetic: capped to the padded db, halved until the candidate width
    covers ``min_width`` or the tile reaches ``bin_w``."""
    eff = min(tile_n, max(bin_w, _round_up(rows, bin_w)))

    def width(t: int) -> int:
        return _ceil_div(rows, t) * geometry(t, bin_w, survivors, binning)[2]

    while eff > bin_w and width(eff) < min_width:
        eff = max(bin_w, _round_up(eff // 2, bin_w))
    return eff


def pq_nsub(d: int, dsub: int = PQ_DSUB_DEFAULT) -> int:
    """Subspaces of a pq placement of ``d`` dims."""
    return _ceil_div(d, dsub)


def db_operand_nbytes(n: int, d: int, precision: str, *,
                      dsub: Optional[int] = None,
                      tile_n: Optional[int] = None) -> Dict[str, int]:
    """Bytes of the db operands the port places for arm ``precision``
    (ShardedKNN._coarse_parts): ``db_values`` the rows as the kernel reads
    them — bf16 hi and lo parts for bf16x3 / bf16x3f (4 B a dim), the bf16
    hi part for default (2), f32 rows for highest (4), int8 rows (1),
    nibble-packed int4 rows (1/2), pq's uint8 code per subspace — and
    ``db_aux`` the f32 row norms (int arms: norms and scales).  Rows pad to
    a ``tile_n`` multiple when it is given; dims pad to DIM_CHUNK (pq: a
    code per ``dsub`` dims)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    rows = int(n) if tile_n is None else _round_up(max(int(n), 1), tile_n)
    if precision == "pq":
        return {"db_values": rows * pq_nsub(d, dsub or PQ_DSUB_DEFAULT),
                "db_aux": rows * 4}
    dp = _round_up(d, DIM_CHUNK)
    width = {"bf16x3": 4, "bf16x3f": 4, "default": 2, "highest": 4,
             "int8": 1}.get(precision)
    values = rows * dp // 2 if precision == "int4" else rows * dp * width
    aux = rows * 8 if precision in ("int8", "int4") else rows * 4
    return {"db_values": int(values), "db_aux": int(aux)}


def _f32_terms(n_q, n, dp, n_tiles, survivors, arm, d_real, peaks):
    products, key, db_bytes = F32_ARMS[arm]
    d = dp if d_real is None else d_real
    flops = products * 2 * n_q * n * d
    w = n_tiles * survivors * 128
    by = {"queries": n_q * d * 4, "db_stream": db_bytes * n * d,
          "db_aux": n * 4,
          "candidates_out": n_q * w * 8 + n_q * n_tiles * 128 * 4}
    return flops, by, peaks[key], key


def _int_terms(n_q, n, dp, n_tiles, survivors, arm):
    ops = 2 * n_q * n * dp
    w = n_tiles * survivors * 128
    row_bytes = dp if arm == "int8" else dp // 2
    by = {"queries": n_q * dp + n_q * 4, "db_stream": n * row_bytes,
          "db_aux": 2 * n * 4,
          "candidates_out": n_q * w * 8 + n_q * n_tiles * 128 * 4}
    return ops, by


def _pq_terms(n_q, n, m, ncodes, n_tiles, out_w, bound_w):
    by = {"queries": n_q * m * ncodes * 4, "db_stream": n * m,
          "db_aux": n * 4,
          "candidates_out": (n_q * n_tiles * out_w * 8
                             + n_q * n_tiles * bound_w * 4)}
    return n_q * n * m, by


def _verdict(t_ops: float, t_bytes: float) -> dict:
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def f32_bound(n_q, n, dp, n_tiles, survivors, arm="bf16x3", d_real=None,
              peaks=None):
    """Least time for an f32-family arm's work (K1, K4, K2, K3 and their
    streaming / fused entries): the larger of its bytes (each input read
    once, each output written once) over HBM bandwidth and its products
    (:data:`F32_ARMS`) over the dense tensor-core rate of their type.
    Counted over the ``n`` real db rows and the ``d_real`` real dims (None:
    all ``dp``).  ``peaks`` default to the H100's."""
    peaks = peaks or _H
    flops, by, rate, _ = _f32_terms(n_q, n, dp, n_tiles, survivors, arm,
                                    d_real, peaks)
    nbytes = sum(by.values())
    return {"flops": flops, "bytes": nbytes,
            **_verdict(flops / rate, nbytes / (peaks["hbm_gbps"] * 1e9))}


def int_bound(n_q, n, dp, n_tiles, survivors, arm, peaks=None):
    """Least time for an int arm's work (K5, K6): the larger of its bytes
    (int8 queries and their scales, the real rows' int8 or packed int4
    values, norms and scales read once; cd, ci, bounds written once) over
    HBM bandwidth and its Q*N*Dp int8 multiply-adds (two operations each)
    over the dense int8 tensor-core rate.  Counted over the ``n`` real db
    rows."""
    peaks = peaks or _H
    ops, by = _int_terms(n_q, n, dp, n_tiles, survivors, arm)
    nbytes = sum(by.values())
    return {"ops": ops, "bytes": nbytes,
            **_verdict(ops / peaks["int8_ops"],
                       nbytes / (peaks["hbm_gbps"] * 1e9))}


def pq_bound(n_q, n, m, ncodes, n_tiles, out_w, bound_w, n_sm, clock_hz,
             peaks=None):
    """Least time for K7's work: the largest of its bytes (the f32 LUT,
    the real rows' uint8 codes and norm-row floats read once; cd, ci,
    bounds written once) over HBM bandwidth, its Q*N*m table lookups over
    the shared-memory word rate (SMEM_WORDS_PER_CLOCK x ``n_sm`` SMs x
    ``clock_hz``; a lookup is a data-dependent gather, which no tensor
    core does: the TPU's one-hot matmul would be 2*Q*N*m*C FLOPs), and its
    Q*N*m f32 adds over the CUDA cores' f32 rate.  Counted over the ``n``
    real db rows."""
    peaks = peaks or _H
    lookups, by = _pq_terms(n_q, n, m, ncodes, n_tiles, out_w, bound_w)
    nbytes = sum(by.values())
    t_lookup = lookups / (peaks["smem_words_per_clock"] * n_sm * clock_hz)
    t_add = lookups / (peaks["f32_flops"] / 2)
    t_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    return {"lookups": lookups, "bytes": nbytes, "sm_clock_hz": clock_hz,
            "lookup_ms": t_lookup * 1e3, "add_ms": t_add * 1e3,
            "bytes_ms": t_bytes * 1e3,
            **_verdict(max(t_lookup, t_add), t_bytes)}


def _probe_setup(n: int, d: int, nq: int, nprobe: Optional[int],
                 ncentroids: Optional[int]):
    """IVF pruning: ``(rows probed, probe term or None)`` — the expected
    rows a probed search streams (``ceil(n * nprobe / ncentroids)``,
    balanced lists) and the centroid scan's bytes and f32 FLOPs."""
    if nprobe is None and ncentroids is None:
        return int(n), None
    if nprobe is None or ncentroids is None:
        raise ValueError("nprobe and ncentroids must be set together")
    cc = max(1, int(ncentroids))
    pp = min(max(1, int(nprobe)), cc)
    n_eff = _ceil_div(int(n) * pp, cc)
    return n_eff, {
        "nprobe": pp, "ncentroids": cc, "probe_fraction": pp / cc,
        "rows_probed": int(n_eff),
        "centroid_table_bytes": int(cc * d * 4 + nq * cc * 4),
        "assign_flops": 2.0 * nq * cc * d,
    }


#: a card's cross-node bandwidth (GB/s) for the DCN term, by device kind:
#: the NVIDIA DGX H100 data sheet lists eight single-port ConnectX-7
#: adapters at up to 400 Gb/s for its eight H100s, one 400 Gb/s (50 GB/s)
#: port a card.  A data-sheet rate, not a measurement: the port's
#: two-process lane trades through a TCP store on one machine
DCN_GBPS_BY_KIND: Dict[str, float] = {H100: 50.0}
DCN_GBPS_SOURCE = ("NVIDIA DGX H100 data sheet: 8x single-port ConnectX-7, "
                   "400 Gb/s each, one per H100")


def _dcn_term(nq: int, k: int, db_hosts: int, dcn_merge: Optional[str],
              device_kind: Optional[str],
              dcn_gbps: Optional[float]) -> Optional[dict]:
    """The cross-host merge term (the JAX package's ``_dcn_term``,
    roofline.py:506-526), None on one host: the DCN level's candidate
    volume (parallel.crossover.merge_bytes at ``dcn_merge``, None the
    measured crossover's pick) over ``dcn_gbps`` — the caller's, else the
    kind's data-sheet rate (:data:`DCN_GBPS_BY_KIND`); an unknown kind
    takes the H100's, marked ``estimated``."""
    from knn_tpu_torch.parallel import crossover

    hosts = max(1, int(db_hosts))
    if hosts <= 1:
        return None
    strategy = dcn_merge or crossover.choose_merge(k, hosts)
    nbytes = crossover.merge_bytes(nq, k, hosts, strategy)
    if dcn_gbps is not None:
        rate, source = float(dcn_gbps), "argument"
    else:
        rate = DCN_GBPS_BY_KIND.get(device_kind or "", DCN_GBPS_BY_KIND[H100])
        source = DCN_GBPS_SOURCE
    return {"bytes": int(nbytes), "strategy": strategy, "hosts": hosts,
            "rate_gbps": rate, "rate_source": source,
            "estimated": dcn_gbps is None
            and device_kind not in DCN_GBPS_BY_KIND,
            "time_s": nbytes / (rate * 1e9)}


def _add_dcn(model: dict, times: Dict[str, float], nq: int, k: int,
             db_hosts: int, dcn_merge: Optional[str],
             device_kind: Optional[str], dcn_gbps: Optional[float]) -> None:
    """A multi-host block's DCN term into its terms and times."""
    dcn = _dcn_term(nq, k, db_hosts, dcn_merge, device_kind, dcn_gbps)
    if dcn is not None:
        model["config"]["db_hosts"] = dcn["hosts"]
        model["terms"]["dcn"] = dcn
        times["dcn"] = dcn["time_s"]


def _combined(cls_times: Dict[str, float]) -> float:
    """The ceiling's time from per-bound-class term times: the largest
    term (the terms are a bound, not a serialized sum).  The one formula
    the ceiling, the calibration overlay and the reconciler
    (calibrate._combined_time) use."""
    return max(cls_times.values())


def _bound_class(cls_times: Dict[str, float]) -> str:
    """The largest term's class, ties in BOUND_CLASSES order."""
    return max(cls_times,
               key=lambda c: (cls_times[c], -BOUND_CLASSES.index(c)))


def _finish(model: dict, nq: int, times: Dict[str, float]) -> dict:
    """Fill the verdict from the term times: the bound class is the
    largest term (ties in BOUND_CLASSES order), the ceiling ``nq`` over
    it; then the calibration overlay (:func:`_consult_calibration`)."""
    for term, t in times.items():
        model["terms"].setdefault(term, {})["time_s"] = t
    cls = {_TERM_CLASS[t]: v for t, v in times.items()}
    t = _combined(cls)
    model["bound_class"] = _bound_class(cls)
    model["ceiling_qps"] = round(nq / t, 1) if t > 0 else None
    model["ceiling_qps_analytic"] = model["ceiling_qps"]
    model["term_times_s"] = {c: round(v, 6) for c, v in cls.items()}
    model.pop("term_times_calibrated_s", None)
    _consult_calibration(model, nq, cls)
    return model


def _consult_calibration(model: dict, nq: int,
                         cls: Dict[str, float]) -> None:
    """Overlay the stored measured-term factors onto this block where the
    calibration store covers its key.  Failure-proof: a broken store
    degrades to the analytic verdict with the reason on the block."""
    from knn_tpu_torch.obs import calibrate

    if "dcn_bound" in cls:
        # no calibration entry covers the DCN term (the campaign measures
        # one-host arms): scaling three of the terms would mislead
        model["calibration"] = {
            "applied": False,
            "note": "multi-host blocks use the analytic DCN model"}
        return
    if "h2d_bound" in cls:
        # a join block's device terms are one superblock's search; its
        # verdict adds the host link, which no entry measured
        model["calibration"] = {
            "applied": False,
            "note": "join blocks use the analytic h2d model"}
        return
    if "probe" in model.get("terms", {}):
        # every measured entry covers a full-db stream; its factors on a
        # pruned stream would claim a measured ceiling for an unmeasured
        # shape
        model["calibration"] = {
            "applied": False,
            "note": "probed blocks use the analytic IVF model"}
        return
    try:
        entry = calibrate.lookup_for_block(model)
    except Exception as e:  # noqa: BLE001 — the overlay must not kill the model
        model["calibration"] = {"applied": False,
                                "error": f"{type(e).__name__}: {e}"}
        return
    if entry is None:
        model["calibration"] = {"applied": False}
        return
    factors = entry.get("factors")
    if not isinstance(factors, dict) or set(factors) - set(_TERM_CLASS):
        # a hand-edited store (or one fit against other terms) degrades
        # to analytic, never mis-applies
        model["calibration"] = {
            "applied": False,
            "error": "entry factors are not the roofline's terms"}
        return
    term_of = {c: t for t, c in _TERM_CLASS.items()}
    cal = {c: v * float(factors.get(term_of[c], 1.0))
           for c, v in cls.items()}
    t = _combined(cal)
    if t <= 0:
        model["calibration"] = {"applied": False,
                                "error": "non-positive calibrated time"}
        return
    model["ceiling_qps"] = round(nq / t, 1)
    model["bound_class"] = _bound_class(cal)
    model["term_times_calibrated_s"] = {c: round(v, 6)
                                        for c, v in cal.items()}
    model["calibration"] = {
        "applied": True,
        "factors": dict(factors),
        "method": entry.get("method"),
        "source": entry.get("source"),
        "age_s": calibrate.entry_age_s(entry),
        "samples": entry.get("samples"),
        "model_residual_pct": entry.get("model_residual_pct"),
        "term_residual_pct": entry.get("term_residual_pct"),
        "measured_at": entry.get("measured_at"),
        "provenance": entry.get("provenance"),
    }


def _hbm_term(by: Dict[str, float], extra: float, peaks) -> Tuple[dict, float]:
    total = sum(by.values()) + extra
    return ({"bytes": {**{k: int(v) for k, v in by.items()},
                       "total": int(total)},
             "rate_bytes": peaks["hbm_gbps"] * 1e9},
            total / (peaks["hbm_gbps"] * 1e9))


def pallas_cost_model(
    *, n: int, d: int, k: int, nq: int,
    precision: Optional[str] = None, kernel: Optional[str] = None,
    grid_order: Optional[str] = None, binning: Optional[str] = None,
    tile_n: Optional[int] = None, survivors: Optional[int] = None,
    bin_w: Optional[int] = None, margin: int = 28,
    device_kind: Optional[str] = None, backend: Optional[str] = None,
    peaks: Optional[Dict[str, float]] = None, db_hosts: int = 1,
    dcn_merge: Optional[str] = None, dcn_gbps: Optional[float] = None,
    nprobe: Optional[int] = None, ncentroids: Optional[int] = None,
    pq_dsub: Optional[int] = None, pq_ncodes: Optional[int] = None,
) -> dict:
    """The roofline of one pallas-selector configuration: the coarse
    kernel of arm ``precision`` at the geometry its launch resolves
    (``tile_n`` capped and halved as ops.coarse_knn.effective_tile does,
    ``binning`` / ``survivors`` / ``bin_w`` setting the output width),
    through :func:`f32_bound`, :func:`int_bound` or :func:`pq_bound`.
    ``kernel`` and ``grid_order`` do not change the work (tiled, streaming
    and fused read and write the same bytes; db_major only reorders):
    they are recorded in ``config``.  ``nprobe`` / ``ncentroids`` price an
    IVF search: the probed fraction of the rows plus the centroid scan.
    ``db_hosts > 1`` adds the cross-host merge term (:func:`_dcn_term`,
    ``dcn_merge`` its strategy, ``dcn_gbps`` its rate).  The JAX model's
    ``block_q`` (every CUDA kernel takes 32-row query blocks) and
    ``num_devices`` have no counterpart."""
    precision = precision or "bf16x3"
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    kernel = kernel or "tiled"
    if kernel not in ("tiled", "streaming", "fused"):
        raise ValueError(
            f"kernel {kernel!r} not in ('tiled', 'streaming', 'fused')")
    grid_order = grid_order or "query_major"
    binning = binning or "grouped"
    bw = int(bin_w or BIN_W)
    estimated = False
    if peaks is None:
        peaks, estimated = peaks_for(device_kind, backend)
    n_total = int(n)
    n_dev, probe = _probe_setup(n_total, d, nq, nprobe, ncentroids)
    m = min(int(k) + int(margin), n_dev)
    tile = effective_tile(n_dev, int(tile_n or TILE_N_DEFAULT), bw,
                          survivors, binning, m + 2)
    _, surv, out_w, bound_w = geometry(tile, bw, survivors, binning)
    n_tiles = _ceil_div(n_dev, tile)
    dp = _round_up(d, DIM_CHUNK)
    times: Dict[str, float] = {}
    terms: Dict[str, dict] = {}
    if precision == "pq":
        dsub = int(pq_dsub or PQ_DSUB_DEFAULT)
        ncodes = int(pq_ncodes or PQ_NCODES_DEFAULT)
        msub = pq_nsub(d, dsub)
        lookups, by = _pq_terms(nq, n_dev, msub, ncodes, n_tiles, out_w,
                                bound_w)
        rate_l = (peaks["smem_words_per_clock"] * peaks["sm_count"]
                  * peaks["sm_clock_hz"])
        terms["smem"] = {"lookups": float(lookups), "rate_ops": rate_l}
        times["smem"] = lookups / rate_l
        cuda_ops = float(lookups)  # one f32 add a lookup
        cuda_rate = peaks["f32_flops"] / 2
        terms["tensor_core"] = {"ops": 0.0, "dtype": None,
                                "rate_ops": peaks["bf16_flops"]}
        times["tensor_core"] = 0.0
    else:
        if precision in ("int8", "int4"):
            ops, by = _int_terms(nq, n_dev, dp, n_tiles, out_w // 128,
                                 precision)
            key, products = "int8_ops", 1
        else:
            ops, by, _, key = _f32_terms(nq, n_dev, dp, n_tiles,
                                         out_w // 128, precision, d, peaks)
            products = F32_ARMS[precision][0]
        terms["tensor_core"] = {
            "ops": float(ops), "products": products,
            "dtype": {"bf16_flops": "bf16", "fp64_tc_flops": "fp64",
                      "int8_ops": "int8"}[key],
            "rate_ops": peaks[key]}
        times["tensor_core"] = ops / peaks[key]
        cuda_ops, cuda_rate = 0.0, peaks["f32_flops"]
    extra = 0.0
    if probe is not None:
        extra = probe["centroid_table_bytes"]
        cuda_ops += probe["assign_flops"]
        cuda_rate = peaks["f32_flops"] if precision != "pq" else cuda_rate
    terms["cuda_core"] = {"ops": cuda_ops, "rate_ops": cuda_rate}
    times["cuda_core"] = cuda_ops / cuda_rate
    terms["hbm"], times["hbm"] = _hbm_term(by, extra, peaks)
    model = {
        "model_version": MODEL_VERSION,
        "selector": "pallas",
        "device_kind": device_kind,
        "estimated": estimated,
        "peaks": {kk: peaks[kk] for kk in sorted(peaks)},
        "config": {
            "n": n_total, "d": int(d), "k": int(k), "nq": int(nq),
            "precision": precision, "kernel": kernel,
            "grid_order": grid_order, "binning": binning,
            "tile_n": tile, "n_tiles": n_tiles, "bin_w": bw,
            "survivors": surv, "out_w": out_w, "margin": int(margin),
        },
        "terms": terms,
    }
    if precision == "pq":
        model["config"].update(pq_dsub=dsub, pq_ncodes=ncodes, pq_m=msub)
    if probe is not None:
        model["config"].update(nprobe=probe["nprobe"],
                               ncentroids=probe["ncentroids"],
                               probe_fraction=probe["probe_fraction"])
        terms["probe"] = probe
    _add_dcn(model, times, nq, k, db_hosts, dcn_merge, device_kind, dcn_gbps)
    return _finish(model, nq, times)


#: f32 matmul work types of the counted selectors' coarse pass, by the
#: placement's compute dtype
_COUNTED_DTYPES = {"float32": "f32_flops", "bfloat16": "bf16_flops",
                   "float16": "bf16_flops"}


def counted_cost_model(
    *, n: int, d: int, k: int, nq: int, selector: str = "exact",
    dtype: Optional[str] = None, margin: int = 28,
    device_kind: Optional[str] = None, backend: Optional[str] = None,
    peaks: Optional[Dict[str, float]] = None, db_hosts: int = 1,
    dcn_merge: Optional[str] = None, dcn_gbps: Optional[float] = None,
    nprobe: Optional[int] = None, ncentroids: Optional[int] = None,
) -> dict:
    """The roofline of the counted certificate
    (``search_certified(selector="exact" | "approx")``,
    ShardedKNN._certify_counted) — the JAX package's ``xla_cost_model``.
    Two passes over the db whatever the selector (the count's threshold
    comes from the first pass's refine): the coarse products in the
    placement's ``dtype`` (f32 on the CUDA cores; bfloat16 / float16 on
    the bf16 tensor cores), a compare per score for the top-m selection,
    and the count pass's f32 products; bytes are the f32 db (or its
    ``dtype`` rows) read once a pass, the queries, the top-m candidates
    out and the counts.  The host's float64 refine is not device work and
    is not priced; query batching does not change the work.  ``db_hosts >
    1`` adds the cross-host merge term (:func:`_dcn_term`)."""
    if selector not in ("exact", "approx"):
        raise ValueError(f"counted selector {selector!r} not in "
                         f"('exact', 'approx')")
    dtype = dtype or "float32"
    if dtype not in _COUNTED_DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(_COUNTED_DTYPES)}")
    estimated = False
    if peaks is None:
        peaks, estimated = peaks_for(device_kind, backend)
    n_total = int(n)
    n_dev, probe = _probe_setup(n_total, d, nq, nprobe, ncentroids)
    m = min(int(k) + int(margin), n_dev)
    elem = 4 if dtype == "float32" else 2
    by = {"queries": 2 * nq * d * 4,
          "db_stream": n_dev * d * elem + n_dev * d * 4,
          "db_aux": 2 * n_dev * 4,
          "candidates_out": nq * m * 8 + nq * 4}
    products = 2.0 * nq * n_dev * d
    key = _COUNTED_DTYPES[dtype]
    tc_ops = products if key != "f32_flops" else 0.0
    # f32 products (coarse when f32, the count always) at the FMA rate;
    # the selection's compares at one per issue slot (half the FLOP rate)
    cuda_s = ((products if key == "f32_flops" else 0.0) + products) \
        / peaks["f32_flops"] + nq * float(n_dev) / (peaks["f32_flops"] / 2)
    extra = 0.0
    if probe is not None:
        extra = probe["centroid_table_bytes"]
        cuda_s += probe["assign_flops"] / peaks["f32_flops"]
    terms = {
        "tensor_core": {"ops": tc_ops, "dtype": "bf16" if tc_ops else None,
                        "rate_ops": peaks["bf16_flops"]},
        "cuda_core": {"flops": products * (2 if key == "f32_flops" else 1),
                      "compares": nq * float(n_dev),
                      "rate_ops": peaks["f32_flops"]},
    }
    times = {"tensor_core": tc_ops / peaks["bf16_flops"],
             "cuda_core": cuda_s}
    terms["hbm"], times["hbm"] = _hbm_term(by, extra, peaks)
    model = {
        "model_version": MODEL_VERSION,
        "selector": selector,
        "device_kind": device_kind,
        "estimated": estimated,
        "peaks": {kk: peaks[kk] for kk in sorted(peaks)},
        "config": {
            "n": n_total, "d": int(d), "k": int(k), "nq": int(nq),
            "dtype": dtype, "passes": 2, "margin": int(margin),
        },
        "terms": terms,
    }
    if probe is not None:
        model["config"].update(nprobe=probe["nprobe"],
                               ncentroids=probe["ncentroids"],
                               probe_fraction=probe["probe_fraction"])
        terms["probe"] = probe
    _add_dcn(model, times, nq, k, db_hosts, dcn_merge, device_kind, dcn_gbps)
    return _finish(model, nq, times)


def cost_model(*, selector: str = "pallas", **kwargs) -> dict:
    """One entry point over both families: ``"pallas"`` takes the kernel
    knobs, ``"exact"`` / ``"approx"`` the counted selectors'."""
    if selector == "pallas":
        return pallas_cost_model(**kwargs)
    return counted_cost_model(selector=selector, **kwargs)


def join_cost_model(
    *, n_a: int, n_b: int, d: int, k: int, superblock_rows: int,
    selector: str = "exact", device_kind: Optional[str] = None,
    backend: Optional[str] = None, peaks: Optional[Dict[str, float]] = None,
    db_hosts: int = 1, **selector_kwargs,
) -> dict:
    """The bulk kNN join's roofline: ``n_a`` query rows against an
    ``n_b``-row device-resident corpus in superblocks of
    ``superblock_rows``.  The device terms are one superblock's search
    (``nq = superblock_rows``); ``terms.h2d`` prices the superblock's
    host→device query rows (analysis.hbm.plan_join) over the host link
    (estimated, :data:`ESTIMATED_PEAKS`).  The engine double-buffers, so
    the bound is the larger of the device bound and the h2d time, and
    ``ceiling_qps`` is rows of A a second; the verdict stays analytic
    (``calibration`` carries the note).  A host-tiered corpus (the JAX
    model's ``db_segment_rows``) is not priced here."""
    from knn_tpu_torch.analysis import hbm as _hbm

    sb = int(superblock_rows)
    if sb < 1:
        raise ValueError(f"superblock_rows must be >= 1, got {sb}")
    model = cost_model(selector=selector, n=n_b, d=d, k=k, nq=sb,
                       device_kind=device_kind, backend=backend,
                       db_hosts=db_hosts, peaks=peaks, **selector_kwargs)
    if peaks is None:
        peaks = peaks_for(device_kind, backend)[0]
        if not model["estimated"] and device_kind in ESTIMATED_PEAKS:
            model["estimated_peaks"] = list(ESTIMATED_PEAKS[device_kind])
    plan = _hbm.plan_join(n_a, n_b, d, superblock_rows=sb)
    s = plan["superblocks"]
    h2d_total = plan["h2d_bytes"][plan["order"]]
    per_sb = h2d_total / s
    t_h2d = per_sb / (peaks["h2d_gbps"] * 1e9)
    times = {t: model["terms"][t]["time_s"]
             for t in ("hbm", "tensor_core", "cuda_core", "smem")
             if t in model["terms"]}
    t_dev = _combined({_TERM_CLASS[t]: v for t, v in times.items()})
    model["terms"]["h2d"] = {"bytes": int(per_sb),
                             "total_bytes": int(h2d_total),
                             "rate_gbps": peaks["h2d_gbps"],
                             "overlapped": True}
    times["h2d"] = t_h2d
    hbm_b = model["terms"]["hbm"]["bytes"]
    t_sb = max(t_dev, t_h2d)
    model["join"] = {
        "n_a": int(n_a), "superblock_rows": sb, "superblocks": int(s),
        "db_segments": int(plan["db_segments"]), "order": plan["order"],
        "db_bytes_per_query": (hbm_b["db_stream"] + hbm_b["db_aux"]) / sb,
        "h2d_bytes_per_query": h2d_total / max(1, int(n_a)),
        "rows_per_s_ceiling": round(sb / t_sb, 1) if t_sb > 0 else None,
    }
    return _finish(model, sb, times)


def attribute(model: dict, measured_qps: Optional[float]) -> dict:
    """The model plus the measured verdict: ``roofline_pct`` = measured /
    ceiling, not clamped (above 1 a peak or a term is wrong — a finding,
    not an error)."""
    out = dict(model)
    if measured_qps is not None and model.get("ceiling_qps"):
        out["measured_qps"] = round(float(measured_qps), 2)
        out["roofline_pct"] = round(
            float(measured_qps) / model["ceiling_qps"], 4)
    else:
        out["measured_qps"] = None
        out["roofline_pct"] = None
    return out


def validate_block(block) -> list:
    """Structural check of a roofline block; a list of errors, empty when
    well formed: a dict with an int ``model_version``, a ``bound_class`` of
    :data:`BOUND_CLASSES`, a positive (or None) ``ceiling_qps``, a
    ``terms`` dict whose every time is a non-negative number, a bool
    ``estimated``, a non-negative (or None) ``roofline_pct``, and a
    well-formed ``calibration`` where it has one.  A shim over the
    artifact-schema catalog (knn_tpu_torch.analysis.artifacts, the
    ``roofline`` entry)."""
    from knn_tpu_torch.analysis.artifacts import validate

    return validate("roofline", block, style="legacy")


def config_label(n: int, d: int, k: int, *, metric: str = "l2",
                 dtype: Optional[str] = None,
                 device_kind: Optional[str] = None) -> str:
    """The registry label one attribution publishes under — the tuning
    cache key's shape prefix."""
    kind = device_kind or "unknown"
    return (f"{kind}|n{int(n)}|d{int(d)}|k{int(k)}|{metric.lower()}|"
            f"{dtype or 'float32'}")


def publish(label: str, block: dict) -> None:
    """Export one attribution: the ``ROOFLINE_*`` gauges, the evaluation
    counter, the /statusz store and a ``roofline.publish`` event.  A no-op
    when obs is off."""
    if not registry.enabled():
        return
    pct = block.get("roofline_pct")
    if pct is not None:
        registry.gauge(names.ROOFLINE_PCT, config=label).set(float(pct))
    if block.get("ceiling_qps"):
        registry.gauge(names.ROOFLINE_CEILING_QPS, config=label).set(
            float(block["ceiling_qps"]))
    bound = block.get("bound_class")
    if bound in BOUND_CLASSES:
        for cls in BOUND_CLASSES:
            registry.gauge(
                names.ROOFLINE_BOUND, config=label,
                **{"class": cls}).set(1.0 if cls == bound else 0.0)
    registry.counter(names.ROOFLINE_EVALUATIONS).inc()
    cal = block.get("calibration")
    if isinstance(cal, dict):
        from knn_tpu_torch.obs import calibrate

        calibrate.publish(label, cal)
    compact = {
        "roofline_pct": pct,
        "ceiling_qps": block.get("ceiling_qps"),
        "ceiling_qps_analytic": block.get("ceiling_qps_analytic"),
        "bound_class": bound,
        "measured_qps": block.get("measured_qps"),
        "estimated": bool(block.get("estimated")),
        "model_version": block.get("model_version"),
        "calibration_applied": bool(
            cal.get("applied")) if isinstance(cal, dict) else False,
    }
    with _lock:
        _LAST.pop(label, None)
        _LAST[label] = compact
        while len(_LAST) > _LAST_MAX:
            _LAST.pop(next(iter(_LAST)))
        _PUBLISHED.add(label)
    trace.emit_event("roofline.publish", config=label,
                     roofline_pct=pct, bound_class=bound)


def was_published(label: str) -> bool:
    """Whether :func:`publish` ran for ``label`` in this process (the
    warm-cache resolve's publish-once dedup)."""
    with _lock:
        return label in _PUBLISHED


def last_reports() -> Dict[str, dict]:
    """The last published attributions, newest last (/statusz, doctor)."""
    with _lock:
        return {k: dict(v) for k, v in _LAST.items()}


def reset() -> None:
    """Drop the published-attribution store (test isolation)."""
    with _lock:
        _LAST.clear()
        _PUBLISHED.clear()


def block_for_bench_line(rec: dict) -> Optional[dict]:
    """The roofline share of one bench line from its own fields: the shape
    in its metric name, ``mode``, ``pallas_knobs``, ``device_kind``,
    ``backend``, ``batch`` and its rate (``device_phase_qps`` or
    ``value``) — what the refresher curates onto a line that carries no
    roofline block (``analysis.artifacts._prepare_roofline``).  A
    ``certified_pallas`` line is priced through :func:`pallas_cost_model`
    with the port's knobs (``block_q`` has no counterpart and is ignored,
    divergence 20), an ``exact`` / ``certified_approx`` line through
    :func:`counted_cost_model` (the JAX package's ``xla_cost_model``);
    the line's ``devices`` has no counterpart either (the model prices
    one card's work).  A kind this module has no peaks for — a TPU line
    of the history — gets the generic fallback with ``estimated`` set,
    never a TPU peak.  None for any other mode, a metric name without the
    shape, or a configuration the models refuse."""
    m = _METRIC_RE.match(str(rec.get("metric") or ""))
    if not m:
        return None
    n, d, k = (int(m.group(g)) for g in ("n", "d", "k"))
    mode = rec.get("mode")
    device_kind = rec.get("device_kind")
    backend = rec.get("backend")
    nq = int(rec.get("batch") or 4096)
    ivf = rec.get("ivf") if isinstance(rec.get("ivf"), dict) else {}
    probe_kw = ({"nprobe": int(ivf["nprobe"]),
                 "ncentroids": int(ivf["ncentroids"])}
                if ivf.get("nprobe") and ivf.get("ncentroids") else {})
    try:
        if mode == "certified_pallas":
            knobs = rec.get("pallas_knobs") or {}
            model = pallas_cost_model(
                n=n, d=d, k=k, nq=nq,
                precision=knobs.get("precision") or rec.get("precision"),
                kernel=knobs.get("kernel"),
                grid_order=knobs.get("grid_order"),
                binning=knobs.get("binning"), tile_n=knobs.get("tile_n"),
                survivors=knobs.get("survivors"), bin_w=knobs.get("bin_w"),
                margin=int(knobs.get("margin") or 28),
                device_kind=device_kind, backend=backend, **probe_kw)
            measured = rec.get("device_phase_qps") or rec.get("value")
        elif mode in ("exact", "certified_approx"):
            model = counted_cost_model(
                n=n, d=d, k=k, nq=nq,
                selector="exact" if mode == "exact" else "approx",
                dtype=rec.get("compute_dtype"), device_kind=device_kind,
                backend=backend, **probe_kw)
            measured = rec.get("value")
        else:
            return None
    except (ValueError, TypeError):
        return None
    return attribute(model, measured)


def render_text(block: dict) -> str:
    """Human-readable rendering of one model / attribution (``cli
    roofline``)."""
    cfg = block.get("config", {})
    lines = []
    head = (f"roofline v{block.get('model_version')} "
            f"[{block.get('selector')}] "
            f"n={cfg.get('n')} d={cfg.get('d')} k={cfg.get('k')} "
            f"nq={cfg.get('nq')}")
    if block.get("selector") == "pallas":
        head += (f" precision={cfg.get('precision')} "
                 f"kernel={cfg.get('kernel')} "
                 f"grid={cfg.get('grid_order')} "
                 f"tile_n={cfg.get('tile_n')} binning={cfg.get('binning')} "
                 f"survivors={cfg.get('survivors')}")
    else:
        head += f" dtype={cfg.get('dtype')}"
    lines.append(head)
    kind = block.get("device_kind") or "generic-cpu"
    est = " (ESTIMATED generic fallback peaks)" if block.get(
        "estimated") else ""
    lines.append(f"device: {kind}{est}")
    terms = block.get("terms", {})
    hb = terms.get("hbm", {})
    by = hb.get("bytes", {})
    lines.append(
        f"  hbm:         {by.get('total', 0) / 1e9:10.3f} GB    "
        f"-> {hb.get('time_s', 0) * 1e3:9.3f} ms   "
        f"(db {by.get('db_stream', 0) / 1e9:.3f}, aux "
        f"{by.get('db_aux', 0) / 1e9:.3f}, q "
        f"{by.get('queries', 0) / 1e9:.3f}, out "
        f"{by.get('candidates_out', 0) / 1e9:.3f})")
    tc = terms.get("tensor_core", {})
    lines.append(
        f"  tensor_core: {tc.get('ops', 0) / 1e12:10.3f} Tops  "
        f"-> {tc.get('time_s', 0) * 1e3:9.3f} ms   "
        f"({tc.get('dtype')} at {tc.get('rate_ops', 0) / 1e12:.0f} T/s)")
    cc = terms.get("cuda_core", {})
    cops = cc.get("ops", cc.get("flops", 0) + cc.get("compares", 0))
    lines.append(
        f"  cuda_core:   {cops / 1e12:10.3f} Tops  "
        f"-> {cc.get('time_s', 0) * 1e3:9.3f} ms")
    sm = terms.get("smem")
    if sm:
        lines.append(
            f"  smem:        {sm.get('lookups', 0) / 1e12:10.3f} Tlookup "
            f"-> {sm.get('time_s', 0) * 1e3:9.3f} ms   "
            f"({sm.get('rate_ops', 0) / 1e12:.2f} T words/s)")
    h2 = terms.get("h2d")
    if h2:
        lines.append(
            f"  h2d:         {h2.get('bytes', 0) / 1e6:10.3f} MB    "
            f"-> {h2.get('time_s', 0) * 1e3:9.3f} ms   "
            f"({h2.get('rate_gbps')} GB/s, estimated)")
    pr = terms.get("probe")
    if pr:
        lines.append(
            f"  probed:      {pr.get('rows_probed', 0) / 1e6:10.3f} Mrow "
            f"of {(cfg.get('n') or 0) / 1e6:.3f} M    "
            f"(nprobe {pr.get('nprobe')}/{pr.get('ncentroids')} lists)")
    cal = block.get("calibration")
    if isinstance(cal, dict) and cal.get("applied"):
        lines.append(
            f"ceiling: {block.get('ceiling_qps')} q/s CALIBRATED "
            f"({block.get('bound_class')}; analytic "
            f"{block.get('ceiling_qps_analytic')} q/s, model off by "
            f"{cal.get('model_residual_pct')}%, {cal.get('method')} fit, "
            f"source {cal.get('source')}, age {cal.get('age_s')}s)")
    else:
        why = ""
        if isinstance(cal, dict) and cal.get("error"):
            why = f", overlay error: {cal['error']}"
        elif isinstance(cal, dict) and cal.get("note"):
            why = f", {cal['note']}"
        lines.append(f"ceiling: {block.get('ceiling_qps')} q/s "
                     f"({block.get('bound_class')}) "
                     f"[calibration: absent{why}]")
    if block.get("roofline_pct") is not None:
        lines.append(f"measured: {block.get('measured_qps')} q/s = "
                     f"{block['roofline_pct'] * 100:.1f}% of roofline")
    return "\n".join(lines) + "\n"
