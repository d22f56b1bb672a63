#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (knn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (a failed check raises, so the script
exits non-zero and prints no result):

1. device  — the card's name, ``nvidia-smi`` name and power limit, versions;
2. build   — builds every CUDA kernel of the port from ``knn_tpu_torch/csrc``
             with nvcc (one process per source, all at once);
3. kernel  — K1 (the fused bf16x3 binned-select kernel) and K10 (the
             db-streaming kernel) against their plain PyTorch version on
             the card: dim 24 with ragged rows, dim 300 (three dim chunks),
             one full 16,384-row SIFT tile at Q=256; cd and bounds within
             64 eps_f32 (||q||^2 + max||t||^2), ci equal wherever a bin's
             values are separated by more than that, the exclusion bound
             sound against float64 scores, and K10's outputs bitwise equal
             to K1's; K11 (the fused early-out kernel) against its plain
             version at the kernel's own geometry on the far-tile case (a
             near 16,384-row tile, two far ones, 4,096 queries; at least
             one tile must skip) and on the full SIFT tile: the same
             skipped (block, tile) cells, the rest within the tolerance;
4. main    — certified-exact k=100 search at the SIFT1M shape (1,000,000 x
             128 f32 rows and 4,096 queries drawn as bench.py draws them,
             seed 0) through ``ShardedKNN.search_certified(selector=
             "pallas")`` with the default knobs: K1 against its plain
             version at this shape, both timed with CUDA events; the
             search's q/s (its first call, then a second one), K1
             launches in the first call and certificate stats; recall@100 =
             1.0 and index equality against a float64 direct-difference
             oracle on the first 256 queries; then ``profile`` traces one
             more certified search with torch.profiler (device time by
             kernel, device busy time, device idle share);
5. stream  — at the ``main`` shape and placement: ``search_certified``
             with ``kernel="streaming"``, ``kernel="fused"`` and
             ``kernel="fused", overlap=True, batch_size=1024,
             overlap_depth=2``; each run's d and i bitwise equal to the
             tiled run's, recall@100 = 1.0 with the oracle's indices on the
             first 256 queries, K10/K11 launched once per batch and K1
             never; q/s of each run (second call, then five rounds of
             all four configurations in turns, tiled included), K10 and
             K11 ms per launch at Q=4,096 against their plain versions and
             the bound, K11 against its plain version at Q=4,096 and at
             the pipelined run's own geometry (each 1,024-query batch),
             K11's skipped cells, the pipeline stats, pipelined calls on
             the kept CUDA streams against fresh ones (wall and the
             allocator's new segments) and the device idle share of the
             pipelined run (torch.profiler);
6. quant  — the int8 (K5) and int4 (K6) arms: each of the six int
             entries (tiled, streaming, fused x int8, int4) against its
             plain version on the card, bitwise (cd, ci, bounds), on
             integer data with exact ties at dim 24 (ragged rows), dim 300
             and one full 16,384-row tile at Q=256, the streaming outputs
             bitwise the tiled ones, the fused ones at the kernel's own
             geometry, and the far-tile case, where the fused kernels must
             skip the plain version's cells; at the SIFT1M shape each
             entry bitwise its plain version at Q=4,096, the fused ones
             also at the pipelined run's own geometry (each 1,024-query
             batch, its own tile segments); then ``search_certified(
             precision="int8")`` on the SIFT1M-shape data cast to uint8
             (byte-exact placement) and ``precision="int4"`` on the ``main``
             f32 data, each with ``kernel`` tiled, streaming, fused and
             fused through the pipeline: recall@100 = 1.0 with the oracle's
             indices, d and i bitwise equal across the four runs, each
             arm's kernels launched once per batch and no other kernel,
             fallback counts, max ε, q/s; the six entries' ms per launch
             at Q=4,096 against their plain versions and the int bound;
             the device idle share of the int8 tiled run;
7. classify — the reference job (``python -m knn_tpu_torch.cli ... --k 50
             --mode certified --selector pallas``, run in-process through
             run_job) on make_mnist_like CSVs (20,000 train, 2,000 test,
             2,000 val), then again with ``--pallas-precision int8``; labels
             must equal the port's ``--mode exact``;
8. kernels — one JSON line per the contract: each ported kernel (K1,
             K10, K11 and the six int entries) with its launches on its own
             path, its max error against its plain version, its time, its
             plain version's time and its bound (one for the bf16x3 three,
             one per int arm).

Then the ``nvidia-smi`` name/power line and, last, ``{"ok": true, ...}``.
``--phases`` runs a subset (e.g. ``--phases device,build,kernel``,
``--phases device,build,kernel,stream`` or ``--phases device,build,quant``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
EPS32 = float(np.finfo(np.float32).eps)
#: kernel scores of PAD_VAL rows are ~1e35 and above; compare them by class
PAD_SCALE = 1e30


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Check:
    """Accumulates the largest kernel-vs-plain error seen."""

    def __init__(self):
        self.max_abs_err = 0.0

    def values(self, name, kern, plain, tol_q):
        """Kernel vs plain scores: pad-scale values by class, +inf exactly,
        the rest within the per-query tolerance."""
        import torch

        pad_p = plain >= PAD_SCALE
        pad_k = kern >= PAD_SCALE
        if not torch.equal(pad_p, pad_k):
            raise AssertionError(f"{name}: pad-scale entries differ")
        if not torch.equal(torch.isinf(plain), torch.isinf(kern)):
            raise AssertionError(f"{name}: +inf entries differ")
        real = ~pad_p
        err = torch.where(real, (kern - plain).abs(), 0.0)
        worst = float(err.max())
        over = err > tol_q[:, None]
        if bool(over.any()):
            raise AssertionError(
                f"{name}: {int(over.sum())} entries over tolerance, max "
                f"error {worst:.4g}")
        self.max_abs_err = max(self.max_abs_err, worst)
        return worst


def tolerance_q(q, db=None, tmax=None):
    """Per-query kernel-vs-plain tolerance 64 eps_f32 (||q||^2 +
    max||t||^2), as f32 on q's device; ``tmax`` plugs in a precomputed
    max||t||^2 (a placement's ``db_norm_max``) in place of ``db``."""
    q64 = q.double()
    qn = (q64 * q64).sum(-1)
    if tmax is None:
        tmax = float((db.double() ** 2).sum(-1).max())
    return (64 * EPS32 * (qn + tmax)).float()


def check_ci(name, kern, plain, tol_q, n_tiles):
    """ci of the kernel equal to the plain version's wherever the slot's
    value is separated from its neighbours in the bin's sorted order
    (survivor j vs j-1, j+1, and the bound), and wherever the plain
    version padded a skipped tile (+inf).  Returns the slots checked."""
    import torch

    from knn_tpu_torch.ops.coarse_knn import BIN_W, SURVIVORS

    survivors = SURVIVORS
    n_q = kern[0].shape[0]
    cd_p = plain[0].view(n_q, n_tiles, survivors, BIN_W)
    bd_p = plain[2].view(n_q, n_tiles, 1, BIN_W)
    seq = torch.cat([cd_p, bd_p], dim=2)  # [Q, T, S+1, 128] ascending
    gap = (seq[:, :, 1:] - seq[:, :, :-1]).abs()
    tol4 = tol_q[:, None, None, None]
    sep = torch.ones_like(cd_p, dtype=torch.bool)
    sep &= gap[:, :, :survivors] > tol4  # above the next value
    sep[:, :, 1:] &= gap[:, :, : survivors - 1] > tol4  # below the previous
    sep &= torch.isfinite(cd_p)
    sep |= torch.isinf(cd_p)
    ci_k = kern[1].view(n_q, n_tiles, survivors, BIN_W)
    ci_p = plain[1].view(n_q, n_tiles, survivors, BIN_W)
    mism = int((sep & (ci_k != ci_p)).sum())
    if mism:
        raise AssertionError(f"{name} ci: {mism} separated slots differ")
    return int(sep.sum())


def compare_k1(checks, q, db, tile_n):
    """K1 and K10 against their plain version (the same function) on one
    input, K10 bitwise against K1, and K1's exclusion bound against
    float64 scores; returns a summary dict."""
    import torch

    from knn_tpu_torch.ops.coarse_knn import (BIN_W, binned_select,
                                              binned_select_plain,
                                              kernel_tolerance, pad_queries,
                                              prepare_db, stream_select)

    th, tl, tnorm = prepare_db(db, tile_n)
    qp = pad_queries(q)
    kern = binned_select(qp, th, tl, tnorm, tile_n=tile_n)
    k10 = stream_select(qp, th, tl, tnorm, tile_n=tile_n)
    plain = binned_select_plain(qp, th, tl, tnorm, tile_n=tile_n)
    torch.cuda.synchronize()
    tol_q = tolerance_q(q, db)
    n_q = q.shape[0]
    n_tiles = th.shape[0] // tile_n
    out = {"q": n_q, "rows": db.shape[0], "dim": db.shape[1],
           "tile_n": tile_n}
    for key, res in (("k1", kern), ("k10", k10)):
        out[f"{key}_max_abs_err_cd"] = checks[key].values(
            f"{key} cd", res[0], plain[0], tol_q)
        out[f"{key}_max_abs_err_bounds"] = checks[key].values(
            f"{key} bounds", res[2], plain[2], tol_q)
        out[f"{key}_ci_separated_checked"] = check_ci(key, res, plain, tol_q,
                                                      n_tiles)
    if not all(torch.equal(a, b) for a, b in zip(k10, kern)):
        raise AssertionError("K10's outputs are not bitwise equal to K1's")
    out["k10_bitwise_k1"] = True
    # soundness: every real row that is not a candidate scores (f64) >= its
    # bin bound - kernel_tolerance
    n = db.shape[0]
    q64, db64 = q.double(), db.double()
    s64 = (db64 * db64).sum(-1)[None, :] - 2.0 * q64 @ db64.T  # [Q, N]
    cand = torch.zeros((n_q, th.shape[0] + 1), dtype=torch.bool,
                       device=q.device)
    cand.scatter_(1, kern[1].long().clamp(max=th.shape[0]), True)
    cand = cand[:, :n]
    rows = torch.arange(n, device=q.device)
    bound = kern[2][:, (rows // tile_n) * BIN_W + rows % BIN_W].double()
    ktol = torch.from_numpy(kernel_tolerance(
        q.cpu().numpy(), db.cpu().numpy(), precision="bf16x3")).to(q.device)
    viol = (~cand) & (s64 < bound - ktol[:, None])
    if bool(viol.any()):
        raise AssertionError(f"exclusion bound unsound at {int(viol.sum())} rows")
    out["soundness_rows_checked"] = int((~cand).sum())
    return out


def compare_k11(check, q, db, tile_n, keep, parts=None):
    """K11 against its plain version at the kernel's own geometry (query
    block, tile segments): the same skipped (block, tile) cells, cd and
    bounds within the tolerance, ci equal on separated and skipped slots.
    ``parts`` plugs in prepared db parts.  Returns a summary dict."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    th, tl, tnorm = parts if parts is not None else ck.prepare_db(db, tile_n)
    qp = ck.pad_queries(q)
    n_tiles = th.shape[0] // tile_n
    block_q = ck.QUERY_BLOCK
    seg = ck.kernel_segment_tiles(q.shape[0], n_tiles, q.device, "fused")
    kern = ck.fused_select(qp, th, tl, tnorm, tile_n=tile_n, keep=keep)
    plain = ck.fused_select_plain(qp, th, tl, tnorm, tile_n=tile_n, keep=keep,
                                  block_q=block_q, seg_tiles=seg)
    torch.cuda.synchronize()
    skip = ck.skipped_cells(kern[0], n_tiles, block_q)
    if not torch.equal(skip, ck.skipped_cells(plain[0], n_tiles, block_q)):
        raise AssertionError("K11 skipped other cells than its plain version")
    tol_q = tolerance_q(q, db)
    return {"q": q.shape[0], "rows": db.shape[0], "dim": db.shape[1],
            "tile_n": tile_n, "keep": keep, "block_q": block_q,
            "seg_tiles": seg, "skipped_cells": int(skip.sum()),
            "cells": skip.numel(),
            "max_abs_err_cd": check.values("k11 cd", kern[0], plain[0], tol_q),
            "max_abs_err_bounds": check.values("k11 bounds", kern[2],
                                               plain[2], tol_q),
            "ci_checked": check_ci("k11", kern, plain, tol_q, n_tiles)}


def far_tile_case(dev, n_q=4096, tile_n=16384, n_tiles=8, dim=16):
    """tests/test_fused_overlap.py:87-89 scaled up: every query sits near a
    row of tiles 0-1; tile t >= 2 is shifted by 500 t, so each segment's
    later tiles are far above its carry and skip."""
    import torch

    rng = np.random.default_rng(7)
    db = rng.normal(size=(n_tiles * tile_n, dim)).astype(np.float32)
    for t in range(2, n_tiles):
        db[t * tile_n : (t + 1) * tile_n] += 500.0 * t
    q = (db[rng.integers(0, 2 * tile_n, size=n_q)]
         + rng.normal(size=(n_q, dim)).astype(np.float32) * 1e-2)
    return torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)


def f64_oracle(q, db, k, chunk=4096):
    """Exact lexicographic top-k on the card: float64 direct differences,
    (distance, index) order."""
    import torch

    from knn_tpu_torch.ops.topk import merge_topk

    q64 = q.double()
    best_d = torch.full((q.shape[0], k), torch.inf, dtype=torch.float64,
                        device=q.device)
    best_i = torch.full((q.shape[0], k), 2 ** 62, dtype=torch.int64,
                        device=q.device)
    for lo in range(0, db.shape[0], chunk):
        t = db[lo : lo + chunk].double()
        diff = q64[:, None, :] - t[None, :, :]
        d = (diff * diff).sum(-1)
        idx = torch.arange(lo, lo + t.shape[0], device=q.device).expand_as(d)
        best_d, best_i = merge_topk(best_d, best_i, d, idx, k)
    return best_d, best_i


def time_cuda(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound(n_q, n, dp, n_tiles, survivors):
    """Least time for K1's work on an H100: the larger of its bytes (each
    input read once, each output written once) over HBM bandwidth and its
    three bf16 products over the dense bf16 tensor-core rate.  Counted over
    the ``n`` real db rows: the PAD_VAL rows that fill the last tile are
    work the function does not need."""
    flops = 3 * 2 * n_q * n * dp
    w = n_tiles * survivors * 128
    nbytes = (n_q * dp * 4 + 2 * n * dp * 2 + n * 4
              + n_q * w * 8 + n_q * n_tiles * 128 * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def int_bound(n_q, n, dp, n_tiles, survivors, arm):
    """Least time for an int arm's work (K5, K6) on an H100: the larger of
    its bytes (int8 queries and their scales, the real rows' int8 or
    packed int4 values, norms and scales read once; cd, ci, bounds
    written once) over HBM bandwidth and its Q*N*Dp int8 multiply-adds
    (two operations each) over the dense int8 tensor-core rate.  Counted
    over the ``n`` real db rows."""
    ops = 2 * n_q * n * dp
    w = n_tiles * survivors * 128
    row_bytes = dp if arm == "int8" else dp // 2
    nbytes = (n_q * dp + n_q * 4 + n * row_bytes + 2 * n * 4
              + n_q * w * 8 + n_q * n_tiles * 128 * 4)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def int_case(dev, arm, n_q, n, dim, tile_n, seed):
    """Integer rows in the uint8 range with exact ties (rows 0-31 copied
    into the next two 128-row groups, four queries equal to db rows),
    quantized on the fly at the uint8 shift: the int entries' operands."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, size=(n, dim)).astype(np.float32)
    for lo in (128, 256):
        db[lo : lo + 32] = db[:32]
    q = rng.integers(0, 256, size=(n_q, dim)).astype(np.float32)
    q[:4] = db[:4]
    qi, qsc = ck.quantize_queries(torch.from_numpy(q).to(dev), 128.0)
    t, aux = ck.prepare_db_int(torch.from_numpy(db).to(dev), tile_n, arm,
                               128.0)
    return qi, qsc, t, aux


def bitwise(name, got, want):
    """Raises unless every tensor of ``got`` equals ``want``'s bitwise;
    returns the largest |difference| of the finite scores (0.0)."""
    import torch

    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: not bitwise equal")
    err = 0.0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        fin = torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, float((a[fin].double() - b[fin].double()).abs().max()))
    return err


def profile_search(knn, q_np, **knobs) -> dict:
    """One more certified search (``knobs`` passed on) under
    torch.profiler: device time by kernel name, the device's busy time
    (union of kernel intervals) and its idle share of the call's wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        knn.search_certified(q_np, margin=28, selector="pallas", **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"phase": "profile", "wall_ms": wall * 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
            "kernels_ms": {name[:80]: us / 1e3 for name, us in top},
            "kernel_events": len(kernels)}


def kernel_record(name, source, replaces):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": None,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="device,build,kernel,main,profile,stream,"
                    "quant,classify",
                    help="comma list of phases to run")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from knn_tpu_torch.device import set_precision_policy
    from knn_tpu_torch.ops import _cuda
    from knn_tpu_torch.ops import coarse_knn as ck

    set_precision_policy()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    # library_ms stays null for every entry: no single PyTorch call computes
    # a per-bin top-2 with exclusion bounds
    records = {
        "k1": kernel_record("binned_select_bf16x3",
                            "knn_tpu_torch/csrc/binned_coarse.cu",
                            "knn_tpu/ops/pallas_knn.py:856"),
        "k10": kernel_record("stream_select_bf16x3",
                             "knn_tpu_torch/csrc/binned_stream.cu",
                             "knn_tpu/ops/pallas_knn.py:1201"),
        "k11": kernel_record("fused_select_bf16x3",
                             "knn_tpu_torch/csrc/binned_stream.cu",
                             "knn_tpu/ops/pallas_knn.py:722"),
    }
    # the int arms: (kernel, arm) -> C library, TPU kernel line
    int_entries = {
        ("tiled", "int8"): ("binned_coarse", 415),
        ("tiled", "int4"): ("binned_coarse", 432),
        ("streaming", "int8"): ("binned_stream", 686),
        ("streaming", "int4"): ("binned_stream", 690),
        ("fused", "int8"): ("binned_stream", 753),
        ("fused", "int4"): ("binned_stream", 753),
    }
    wrappers = {"tiled": ck.binned_select, "streaming": ck.stream_select,
                "fused": ck.fused_select}
    for (kern, arm), (lib, line) in int_entries.items():
        records[f"{kern}_{arm}"] = kernel_record(
            f"{wrappers[kern].__name__}_{arm}", f"knn_tpu_torch/csrc/{lib}.cu",
            f"knn_tpu/ops/pallas_knn.py:{line}")
    checks = {key: Check() for key in records}
    # record key -> (wrapper, arm) whose launch count it reads
    counters = {"k1": (ck.binned_select, "bf16x3"),
                "k10": (ck.stream_select, "bf16x3"),
                "k11": (ck.fused_select, "bf16x3"),
                **{f"{kern}_{arm}": (wrappers[kern], arm)
                   for kern, arm in int_entries}}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = dict.fromkeys(ck.ARMS, 0)

    def read_launches():
        return {key: fn.launches[arm] for key, (fn, arm) in counters.items()}

    if "device" in phases:
        emit({"phase": "device", "device": kind, "nvidia_smi": smi,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    if "build" in phases:
        t0 = time.perf_counter()
        paths = _cuda.build()
        emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
              "libraries": {n: str(p.name) for n, p in paths.items()},
              "ptxas": {n: [ln.split(":", 1)[-1].strip()
                            for ln in log.splitlines()
                            if any(s in ln for s in ("Compiling entry",
                                                     "registers", "spill"))]
                        for n, log in _cuda.build_logs.items()}})

    if "kernel" in phases:
        rng = np.random.default_rng(0)
        cases = []
        # (queries, rows, dim, tile_n): ragged rows at dim 24 with 2 and 4
        # groups per tile, then dim 300 (three dim chunks)
        for n_q, n, dim, tile in ((37, 5 * 128 + 60, 24, 256),
                                  (37, 5 * 128 + 60, 24, 512),
                                  (11, 3 * 128 + 40, 300, 256)):
            q = torch.from_numpy(
                (rng.normal(size=(n_q, dim)) * 10).astype(np.float32)).to(dev)
            db = torch.from_numpy(
                (rng.normal(size=(n, dim)) * 10).astype(np.float32)).to(dev)
            cases.append(compare_k1(checks, q, db, tile))
        q = torch.from_numpy((rng.random((256, 128)) * 128).astype(np.float32)).to(dev)
        db = torch.from_numpy((rng.random((16384, 128)) * 128).astype(np.float32)).to(dev)
        cases.append(compare_k1(checks, q, db, ck.TILE_N))
        # K11 at the main path's keep (m+2 = 130: a depth-2 carry)
        k11_cases = [compare_k11(checks["k11"], q, db, ck.TILE_N, 130)]
        fq, fdb = far_tile_case(dev)
        far = compare_k11(checks["k11"], fq, fdb, ck.TILE_N, 130)
        if far["skipped_cells"] < 1:
            raise AssertionError("K11 skipped no tile on the far-tile case")
        k11_cases.append(far)
        del fq, fdb
        emit({"phase": "kernel", "cases": cases, "k11_cases": k11_cases,
              "max_abs_err": {key: c.max_abs_err for key, c in checks.items()}})

    # the SIFT1M-shape placement, queries and oracle, shared by main and
    # stream and built on first use
    sift = {}

    def sift_data():
        if sift:
            return sift
        from knn_tpu_torch import ShardedKNN

        n, dim, n_q, k = 1_000_000, 128, 4096, 100
        rng = np.random.default_rng(0)
        db_np = (rng.random(size=(n, dim)) * 128.0).astype(np.float32)
        q_np = (rng.random(size=(n_q, dim)) * 128.0).astype(np.float32)
        t0 = time.perf_counter()
        knn = ShardedKNN(db_np, k=k)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        q_dev = torch.from_numpy(q_np).to(dev)
        pl = knn.placement
        n_p, dp = pl.th.shape
        sift.update(n=n, dim=dim, n_q=n_q, k=k, q_np=q_np, knn=knn,
                    setup_s=setup_s, q_dev=q_dev, qp=ck.pad_queries(q_dev),
                    n_or=256,
                    # one bound for K1, K10 and K11: the same products
                    bound=k1_bound(n_q, n, dp, n_p // ck.TILE_N, ck.SURVIVORS))
        return sift

    def oracle_check(S, d, i, label):
        n_or, k = S["n_or"], S["k"]
        if "oi" not in S:  # after the first search: it times a cold call
            od, oi = f64_oracle(S["q_dev"][:n_or], S["knn"].placement.db, k)
            S["od"], S["oi"] = od.cpu().numpy(), oi.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i[:n_or], S["oi"])]))
        same = bool((i[:n_or] == S["oi"]).all())
        rel = float(np.max(np.abs(d[:n_or] - S["od"])
                           / np.maximum(S["od"], 1e-30)))
        if recall != 1.0 or not same or rel > ck.RANK_SLACK:
            raise AssertionError(
                f"{label}: oracle mismatch: recall@{k}={recall} "
                f"same_order={same} max_rel_dist_err={rel}")
        return recall, same, rel

    def timed_search(S, **knobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S["knn"].search_certified(S["q_np"], margin=28,
                                        selector="pallas", **knobs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the kernel configurations of search_certified that every arm runs
    kernel_configs = {"tiled": {"kernel": "tiled"},
                      "streaming": {"kernel": "streaming"},
                      "fused": {"kernel": "fused"},
                      "fused_overlap": {"kernel": "fused", "overlap": True,
                                        "batch_size": 1024,
                                        "overlap_depth": 2}}
    bf16x3_keys = {"tiled": "k1", "streaming": "k10", "fused": "k11"}

    def run_configs(D, arm, labels, ref=None):
        """search_certified(precision=arm) on D's placement through the
        kernel_configs ``labels``, the launch counts read around each call
        alone: each run launches its own kernel once per batch and no
        other kernel, returns ``ref``'s d and i bitwise (the first run's
        when None) and the oracle's on D's first queries."""
        n_q, n = D["q_np"].shape[0], D["knn"].n_train
        runs = {}
        for label in labels:
            knobs = dict(kernel_configs[label], precision=arm)
            kernel = knobs["kernel"]
            own = bf16x3_keys[kernel] if arm == "bf16x3" else f"{kernel}_{arm}"
            name = f"{arm} {label}"
            reset_launches()
            (d, i, stats), wall = timed_search(D, **knobs)
            launches = read_launches()
            n_batches = -(-n_q // knobs.get("batch_size", n_q))
            want = n_batches * ck.kernel_launches_per_batch(kernel, n,
                                                            ck.TILE_N)
            if launches[own] != want or sum(launches.values()) != want:
                raise AssertionError(
                    f"{name}: launches {launches}, expected {want} of {own} "
                    f"and no other kernel")
            _, wall_warm = timed_search(D, **knobs)
            if ref is None:
                ref = (d, i)
            elif not (np.array_equal(d, ref[0]) and np.array_equal(i, ref[1])):
                raise AssertionError(f"{name}: d, i differ from the tiled run")
            recall, same, rel = oracle_check(D, d, i, name)
            if knobs.get("overlap"):
                pipe = stats.get("pipeline")
                if not pipe or pipe["batches"] != n_batches or pipe["depth"] != 2:
                    raise AssertionError(f"{name}: pipeline stats {pipe}")
            runs[label] = {"launches": launches, "batches": n_batches,
                           "qps_first_call": n_q / wall,
                           "qps_second_call": n_q / wall_warm,
                           "bitwise_tiled": True, "recall_at_k": recall,
                           "same_indices": same, "max_rel_dist_err": rel,
                           "certified": stats["certified"],
                           "fallback_queries": stats["fallback_queries"],
                           "host_exact_queries": stats.get("host_exact_queries", 0),
                           "pipeline": stats.get("pipeline")}
        return runs

    def phase_main(S):
        knn, pl, qp = S["knn"], S["knn"].placement, S["qp"]
        n, dim, n_q, k = S["n"], S["dim"], S["n_q"], S["k"]

        # K1 against its plain version at the main path's shape, then both
        # timed with CUDA events
        kern = ck.binned_select(qp, pl.th, pl.tl, pl.tnorm, tile_n=ck.TILE_N)
        plain = ck.binned_select_plain(qp, pl.th, pl.tl, pl.tnorm,
                                       tile_n=ck.TILE_N)
        tol_q = tolerance_q(S["q_dev"], tmax=pl.db_norm_max)
        full_err = max(
            checks["k1"].values("cd@main", kern[0], plain[0], tol_q),
            checks["k1"].values("bounds@main", kern[2], plain[2], tol_q))
        S["k1_err"] = full_err
        del kern, plain
        ms = time_cuda(lambda: ck.binned_select(qp, pl.th, pl.tl, pl.tnorm,
                                                tile_n=ck.TILE_N), 3)
        plain_ms = time_cuda(lambda: ck.binned_select_plain(
            qp, pl.th, pl.tl, pl.tnorm, tile_n=ck.TILE_N), 1)
        bound = S["bound"]

        # the main path, with the launch count read around it alone
        reset_launches()
        (d, i, stats), wall = timed_search(S)
        launches = read_launches()
        want = ck.kernel_launches_per_batch("tiled", n, ck.TILE_N)
        if launches["k1"] != want or sum(launches.values()) != want:
            raise AssertionError(
                f"main: launches {launches}, expected {want} of k1 (one "
                f"batch) and no other kernel")
        # the same call again: the first one also pays one-time library
        # and allocator set-up
        _, wall_warm = timed_search(S)
        if d.shape != (n_q, k) or i.shape != (n_q, k) or not np.isfinite(d).all():
            raise AssertionError(f"bad result shapes {d.shape} {i.shape}")
        recall, same, rel = oracle_check(S, d, i, "main")
        S["tiled"] = (d, i)
        records["k1"].update(launches=launches["k1"], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound["bound_ms"],
                             bound_by=bound["bound_by"])
        emit({"phase": "main", "n": n, "dim": dim, "queries": n_q, "k": k,
              "qps": n_q / wall, "wall_s": wall, "setup_s": S["setup_s"],
              "qps_second_call": n_q / wall_warm,
              "k1_ms_per_launch": ms, "k1_plain_ms": plain_ms,
              "k1_launches": launches["k1"], "launches": launches,
              "k1_max_abs_err": full_err, "k1_bound": bound,
              "certified": stats["certified"],
              "fallback_queries": stats["fallback_queries"],
              "rank_corrected_queries": stats["rank_corrected_queries"],
              "host_exact_queries": stats.get("host_exact_queries", 0),
              "oracle_queries": S["n_or"], "recall_at_k": recall,
              "same_indices": same, "max_rel_dist_err": rel,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        if "profile" in phases:
            emit(profile_search(knn, S["q_np"]))

    def phase_stream(S):
        knn, pl, qp = S["knn"], S["knn"].placement, S["qp"]
        n, n_q, k = S["n"], S["n_q"], S["k"]
        if "tiled" not in S:
            (d, i, _), _ = timed_search(S)
            S["tiled"] = (d, i)
        keep = min(k + 28, n) + 2
        n_tiles = pl.th.shape[0] // ck.TILE_N
        args = (qp, pl.th, pl.tl, pl.tnorm)

        # K10 bitwise K1 at the main shape; K11 against its plain version
        # at its own geometry
        k1_out = ck.binned_select(*args, tile_n=ck.TILE_N)
        k10_out = ck.stream_select(*args, tile_n=ck.TILE_N)
        if not all(torch.equal(a, b) for a, b in zip(k10_out, k1_out)):
            raise AssertionError("K10 is not bitwise K1 at the main shape")
        del k1_out, k10_out
        if "k1_err" in S:
            # bitwise K1's outputs: K1's error against the same plain version
            checks["k10"].max_abs_err = max(checks["k10"].max_abs_err,
                                            S["k1_err"])
        parts = (pl.th, pl.tl, pl.tnorm)
        k11_main = compare_k11(checks["k11"], S["q_dev"], pl.db, ck.TILE_N,
                               keep, parts=parts)
        # ... and at the pipelined run's geometry: each of its four
        # 1,024-query batches, with that batch size's own tile segments
        pipe_bs = kernel_configs["fused_overlap"]["batch_size"]
        k11_batches = [
            compare_k11(checks["k11"], S["q_dev"][lo : lo + pipe_bs], pl.db,
                        ck.TILE_N, keep, parts=parts)
            for lo in range(0, n_q, pipe_bs)]
        block_q = ck.QUERY_BLOCK
        seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused")
        ms10 = time_cuda(lambda: ck.stream_select(*args, tile_n=ck.TILE_N), 3)
        ms11 = time_cuda(lambda: ck.fused_select(*args, tile_n=ck.TILE_N,
                                                 keep=keep), 3)
        plain10_ms = time_cuda(lambda: ck.binned_select_plain(
            *args, tile_n=ck.TILE_N), 1)
        plain11_ms = time_cuda(lambda: ck.fused_select_plain(
            *args, tile_n=ck.TILE_N, keep=keep, block_q=block_q,
            seg_tiles=seg), 1)

        runs = run_configs(S, "bf16x3", ("streaming", "fused",
                                         "fused_overlap"), ref=S["tiled"])
        # warm q/s of every configuration, tiled included, in five rounds
        # of turns, so that host noise falls on all of them alike
        qps_turns = {label: [] for label in kernel_configs}
        for _ in range(5):
            for label, knobs in kernel_configs.items():
                _, wall = timed_search(S, **knobs)
                qps_turns[label].append(n_q / wall)
        # the pipeline keeps its two CUDA streams per ShardedKNN: pipelined
        # calls on the kept streams against calls on two fresh ones, with
        # the caching allocator's new device segments (cudaMalloc calls)
        stream_turns = {"kept": [], "fresh": []}
        for _ in range(3):
            for label in stream_turns:
                if label == "fresh":
                    knn._streams = None
                torch.cuda.synchronize()
                segs = torch.cuda.memory_stats()["segment.all.allocated"]
                _, wall = timed_search(S, **kernel_configs["fused_overlap"])
                stream_turns[label].append({
                    "wall_ms": wall * 1e3,
                    "new_segments": torch.cuda.memory_stats()[
                        "segment.all.allocated"] - segs})
        prof = profile_search(knn, S["q_np"],
                              **kernel_configs["fused_overlap"])
        bound = S["bound"]
        records["k10"].update(launches=runs["streaming"]["launches"]["k10"],
                              ms=ms10, plain_ms=plain10_ms,
                              bound_ms=bound["bound_ms"],
                              bound_by=bound["bound_by"])
        records["k11"].update(launches=runs["fused"]["launches"]["k11"],
                              ms=ms11, plain_ms=plain11_ms,
                              bound_ms=bound["bound_ms"],
                              bound_by=bound["bound_by"])
        emit({"phase": "stream", "n": n, "queries": n_q, "k": k,
              "keep": keep, "block_q": block_q, "seg_tiles": seg,
              "k10_ms_per_launch": ms10, "k10_plain_ms": plain10_ms,
              "k11_ms_per_launch": ms11, "k11_plain_ms": plain11_ms,
              "bound": bound, "k11_at_main": k11_main,
              "k11_skipped_cells": k11_main["skipped_cells"],
              "k11_cells": k11_main["cells"],
              "k11_at_pipelined_batches": k11_batches, "runs": runs,
              "qps_in_turns": qps_turns,
              "pipeline_streams_kept_vs_fresh": stream_turns,
              "pipelined_profile": prof})


    def time_arm(D, arm):
        """The arm's three entries against their plain versions at the main
        path's shapes (bitwise), the fused entry also at the pipelined
        run's own geometry (each 1,024-query batch, with that batch size's
        tile segments: bitwise, so the same skipped cells), then each
        entry timed with CUDA events."""
        knn, q_dev = D["knn"], D["q_dev"]
        t, aux = knn._coarse_parts(ck.TILE_N, arm)
        qi, qsc = ck.quantize_queries(q_dev, knn._quant_placement(arm)["offset"])
        args = (qi, qsc, t, aux)
        n_q, n_tiles = qi.shape[0], t.shape[0] // ck.TILE_N
        keep = min(D["k"] + 28, knn.n_train) + 2
        seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused", arm)
        plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N)
        tiled = ck.binned_select(*args, tile_n=ck.TILE_N)
        out = {"seg_tiles": seg, "keep": keep}
        for kern, got in (("tiled", tiled), ("streaming", ck.stream_select(
                *args, tile_n=ck.TILE_N))):
            err = bitwise(f"{kern}_{arm}@main", got, plain)
            checks[f"{kern}_{arm}"].max_abs_err = max(
                checks[f"{kern}_{arm}"].max_abs_err, err)
        del plain

        def fused_vs_plain(name, sl):
            sub = (qi[sl], qsc[sl], t, aux)
            g = ck.kernel_segment_tiles(sub[0].shape[0], n_tiles, dev,
                                        "fused", arm)
            kern = ck.fused_select(*sub, tile_n=ck.TILE_N, keep=keep)
            fplain = ck.fused_select_plain(*sub, tile_n=ck.TILE_N, keep=keep,
                                           block_q=ck.QUERY_BLOCK,
                                           seg_tiles=g)
            err = bitwise(name, kern, fplain)
            checks[f"fused_{arm}"].max_abs_err = max(
                checks[f"fused_{arm}"].max_abs_err, err)
            skip = ck.skipped_cells(kern[0], n_tiles)
            return kern, {"q": sub[0].shape[0], "seg_tiles": g,
                          "skipped_cells": int(skip.sum()),
                          "cells": skip.numel(), "bitwise_plain": True}

        fused, at_main = fused_vs_plain(f"fused_{arm}@main", slice(None))
        out["skipped_cells"] = at_main["skipped_cells"]
        pipe_bs = kernel_configs["fused_overlap"]["batch_size"]
        out["fused_at_pipelined_batches"] = [
            fused_vs_plain(f"fused_{arm}@batch{lo // pipe_bs}",
                           slice(lo, lo + pipe_bs))[1]
            for lo in range(0, n_q, pipe_bs)]
        out["tied_bins"] = int((tiled[0].view(n_q, n_tiles, 2, 128)[:, :, 0]
                                == tiled[0].view(n_q, n_tiles, 2, 128)[:, :, 1]
                                ).sum())
        del tiled, fused
        for kern, fn, pfn, kw in (
                ("tiled", ck.binned_select, ck.binned_select_plain, {}),
                ("streaming", ck.stream_select, ck.binned_select_plain, {}),
                ("fused", ck.fused_select, ck.fused_select_plain,
                 {"keep": keep})):
            pkw = dict(kw, block_q=ck.QUERY_BLOCK, seg_tiles=seg) if kw else {}
            out[f"{kern}_ms"] = time_cuda(
                lambda: fn(*args, tile_n=ck.TILE_N, **kw), 3)
            out[f"{kern}_plain_ms"] = time_cuda(
                lambda: pfn(*args, tile_n=ck.TILE_N, **pkw), 1)
        out["bound"] = int_bound(n_q, knn.n_train, qi.shape[1], n_tiles,
                                 ck.SURVIVORS, arm)
        return out

    def phase_quant(S):
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.ops.quantize import score_error_bound

        # the six int entries against their plain versions, bitwise, on
        # integer data with exact ties; streaming bitwise tiled
        keep = min(S["k"] + 28, S["n"]) + 2
        cases = []
        for arm in ck.INT_ARMS:
            for n_q, n, dim, tile in ((37, 5 * 128 + 60, 24, 256),
                                      (11, 3 * 128 + 40, 300, 256),
                                      (256, 16384, 128, ck.TILE_N)):
                args = int_case(dev, arm, n_q, n, dim, tile, dim + n_q)
                n_tiles = args[2].shape[0] // tile
                seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused", arm)
                plain = ck.binned_select_plain(*args, tile_n=tile)
                tiled = ck.binned_select(*args, tile_n=tile)
                got = {"tiled": (tiled, plain),
                       "streaming": (ck.stream_select(*args, tile_n=tile),
                                     plain),
                       "fused": (ck.fused_select(*args, tile_n=tile,
                                                 keep=keep),
                                 ck.fused_select_plain(
                                     *args, tile_n=tile, keep=keep,
                                     block_q=ck.QUERY_BLOCK, seg_tiles=seg))}
                for kern, (k_out, p_out) in got.items():
                    err = bitwise(f"{kern}_{arm} case", k_out, p_out)
                    checks[f"{kern}_{arm}"].max_abs_err = max(
                        checks[f"{kern}_{arm}"].max_abs_err, err)
                bitwise(f"streaming_{arm} vs tiled", got["streaming"][0], tiled)
                cd = tiled[0].view(n_q, n_tiles, 2, 128)
                cases.append({"arm": arm, "q": n_q, "rows": n, "dim": dim,
                              "tile_n": tile, "bitwise": True,
                              "tied_bins": int((cd[:, :, 0] == cd[:, :, 1]).sum())})
        # the fused entries on the far-tile case: the same skipped cells
        fq, fdb = far_tile_case(dev)
        far = {}
        for arm in ck.INT_ARMS:
            qi, qsc = ck.quantize_queries(fq)
            t, aux = ck.prepare_db_int(fdb, ck.TILE_N, arm)
            n_tiles = t.shape[0] // ck.TILE_N
            seg = ck.kernel_segment_tiles(fq.shape[0], n_tiles, dev, "fused",
                                          arm)
            kern = ck.fused_select(qi, qsc, t, aux, tile_n=ck.TILE_N,
                                   keep=keep)
            plain = ck.fused_select_plain(qi, qsc, t, aux, tile_n=ck.TILE_N,
                                          keep=keep, block_q=ck.QUERY_BLOCK,
                                          seg_tiles=seg)
            bitwise(f"fused_{arm} far-tile", kern, plain)
            skipped = int(ck.skipped_cells(kern[0], n_tiles).sum())
            if skipped < 1:
                raise AssertionError(f"fused_{arm} skipped no far tile")
            far[arm] = {"seg_tiles": seg, "skipped_cells": skipped,
                        "cells": int(n_tiles * -(-fq.shape[0] // ck.QUERY_BLOCK))}
        del fq, fdb
        emit({"phase": "quant_kernels", "cases": cases, "far_tile": far,
              "max_abs_err": {f"{kern}_{arm}": checks[f"{kern}_{arm}"].max_abs_err
                              for kern, arm in int_entries}})

        # int8 on the main draw cast to uint8 (byte-exact placement), int4
        # on the main f32 data
        u8 = S["knn"].placement.db_host.astype(np.uint8)
        q8 = S["q_np"].astype(np.uint8).astype(np.float32)
        t0 = time.perf_counter()
        knn8 = ShardedKNN(u8, k=S["k"])
        knn8._quant_placement("int8")
        torch.cuda.synchronize()
        D8 = {"knn": knn8, "q_np": q8, "q_dev": torch.from_numpy(q8).to(dev),
              "n_or": S["n_or"], "k": S["k"], "setup_s": time.perf_counter() - t0}
        del u8
        t0 = time.perf_counter()
        S["knn"]._quant_placement("int4")
        torch.cuda.synchronize()
        D4 = dict(S, setup_s=time.perf_counter() - t0)
        out = {"phase": "quant"}
        for arm, D in (("int8", D8), ("int4", D4)):
            qp = D["knn"]._quant_placement(arm)
            eps = score_error_bound(D["q_np"], qp["stats"], offset=qp["offset"])
            runs = run_configs(D, arm, kernel_configs)
            timing = time_arm(D, arm)
            prof = (profile_search(D["knn"], D["q_np"], precision=arm)
                    if arm == "int8" else None)
            for kern in ("tiled", "streaming", "fused"):
                records[f"{kern}_{arm}"].update(
                    launches=runs[kern]["launches"][f"{kern}_{arm}"],
                    ms=timing[f"{kern}_ms"],
                    plain_ms=timing[f"{kern}_plain_ms"],
                    bound_ms=timing["bound"]["bound_ms"],
                    bound_by=timing["bound"]["bound_by"])
            out[arm] = {"placement_s": D["setup_s"], "offset": qp["offset"],
                        "stats": qp["stats"], "eps_max": float(eps.max()),
                        "eps_median": float(np.median(eps)),
                        "runs": runs, "kernels": timing, "profile": prof}
        emit(out)
        del D8, knn8

    if phases & {"main", "stream", "quant"}:
        if "main" in phases:
            phase_main(sift_data())
        if "stream" in phases:
            phase_stream(sift_data())
        if "quant" in phases:
            phase_quant(sift_data())
        sift.clear()  # frees the placement before the classify job
        torch.cuda.empty_cache()

    if "classify" in phases:
        import os

        from knn_tpu_torch.cli import args_to_config, build_parser
        from knn_tpu_torch.data.datasets import (make_mnist_like,
                                                 save_labeled_csv,
                                                 save_unlabeled_csv)
        from knn_tpu_torch.pipeline import run_job

        tr, trl, te, _, va, val = make_mnist_like(
            n_train=20_000, n_test=2_000, n_val=2_000)
        with tempfile.TemporaryDirectory() as tmp:
            files = {name: os.path.join(tmp, name + ".csv")
                     for name in ("train", "test", "val")}
            save_labeled_csv(files["train"], tr, trl)
            save_unlabeled_csv(files["test"], te)
            save_labeled_csv(files["val"], va, val)
            results = {}
            runs = {"certified": ("--mode", "certified"),
                    "certified_int8": ("--mode", "certified",
                                       "--pallas-precision", "int8"),
                    "exact": ("--mode", "exact")}
            for label, extra in runs.items():
                argv = ["--train", files["train"], "--test", files["test"],
                        "--val", files["val"], "--k", "50", *extra,
                        "--selector", "pallas",
                        "--out", os.path.join(tmp, f"Test_label_{label}.csv")]
                reset_launches()
                results[label] = run_job(args_to_config(build_parser().parse_args(argv)))
                results[label + "_launches"] = read_launches()
        cert, exact = results["certified"], results["exact"]
        cert8 = results["certified_int8"]
        if results["certified_launches"]["k1"] < 1:
            raise AssertionError("the classify job launched K1 no time")
        if results["certified_int8_launches"]["tiled_int8"] < 1:
            raise AssertionError("the int8 classify job launched K5 no time")
        for job in (cert, cert8):
            if not (np.array_equal(job.test_labels, exact.test_labels)
                    and np.array_equal(job.val_labels, exact.val_labels)):
                raise AssertionError("certified labels differ from exact labels")
        emit({"phase": "classify", "n_train": 20_000, "k": 50,
              "val_accuracy": cert.val_accuracy,
              "exact_val_accuracy": exact.val_accuracy,
              "labels_equal_exact": True,
              "k1_launches": results["certified_launches"]["k1"],
              "int8_labels_equal_exact": True,
              "int8_k5_launches": results["certified_int8_launches"]["tiled_int8"],
              "int8_certified_stats": {key: v for key, v in
                                       cert8.certified_stats.items()
                                       if key != "pallas_knobs"},
              "certified_qps": cert.queries_per_sec,
              "exact_qps": exact.queries_per_sec,
              "certified_stats": {key: v for key, v in cert.certified_stats.items()
                                  if key != "pallas_knobs"},
              "phase_times_s": cert.phase_times})

    for key, rec in records.items():
        rec["max_abs_err"] = checks[key].max_abs_err
    emit({"kernels": list(records.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
