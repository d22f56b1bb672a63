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
6. classify — the reference job (``python -m knn_tpu_torch.cli ... --k 50
             --mode certified --selector pallas``, run in-process through
             run_job) on make_mnist_like CSVs (20,000 train, 2,000 test,
             2,000 val); labels must equal the port's ``--mode exact``;
7. kernels — one JSON line per the contract: each ported kernel (K1,
             K10, K11) with its launches on its own path, its max error
             against its plain version, its time, its plain version's time
             and its bound (one bound for all three: the same products).

Then the ``nvidia-smi`` name/power line and, last, ``{"ok": true, ...}``.
``--phases`` runs a subset (e.g. ``--phases device,build,kernel`` or
``--phases device,build,kernel,stream``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
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
                    default="device,build,kernel,main,profile,stream,classify",
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
    # library_ms stays null for all three: no single PyTorch call computes
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
    checks = {key: Check() for key in records}
    counters = {"k1": ck.binned_select, "k10": ck.stream_select,
                "k11": ck.fused_select}

    def reset_launches():
        for fn in counters.values():
            fn.launches = 0

    def read_launches():
        return {key: fn.launches for key, fn in counters.items()}

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
        d_t, i_t = S["tiled"]
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
        pipe_bs = 1024
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

        runs = {}
        own = {"streaming": "k10", "fused": "k11"}
        configs = {"streaming": {"kernel": "streaming"},
                   "fused": {"kernel": "fused"},
                   "fused_overlap": {"kernel": "fused", "overlap": True,
                                     "batch_size": pipe_bs,
                                     "overlap_depth": 2}}
        for label, knobs in configs.items():
            reset_launches()
            (d, i, stats), wall = timed_search(S, **knobs)
            launches = read_launches()
            kernel = knobs["kernel"]
            n_batches = -(-n_q // knobs.get("batch_size", n_q))
            want = n_batches * ck.kernel_launches_per_batch(kernel, n,
                                                            ck.TILE_N)
            if launches[own[kernel]] != want or launches["k1"] != 0 or \
                    sum(launches.values()) != want:
                raise AssertionError(
                    f"{label}: launches {launches}, expected {want} of "
                    f"{own[kernel]} and no other kernel")
            _, wall_warm = timed_search(S, **knobs)
            if not (np.array_equal(d, d_t) and np.array_equal(i, i_t)):
                raise AssertionError(f"{label}: d, i differ from the tiled run")
            recall, same, rel = oracle_check(S, d, i, label)
            if knobs.get("overlap"):
                pipe = stats.get("pipeline")
                if not pipe or pipe["batches"] != n_batches or pipe["depth"] != 2:
                    raise AssertionError(f"{label}: pipeline stats {pipe}")
            runs[label] = {"launches": launches, "batches": n_batches,
                           "qps_first_call": n_q / wall,
                           "qps_second_call": n_q / wall_warm,
                           "bitwise_tiled": True, "recall_at_k": recall,
                           "same_indices": same, "max_rel_dist_err": rel,
                           "certified": stats["certified"],
                           "fallback_queries": stats["fallback_queries"],
                           "pipeline": stats.get("pipeline")}
        # warm q/s of every configuration, tiled included, in five rounds
        # of turns, so that host noise falls on all of them alike
        turns = {"tiled": {}, **configs}
        qps_turns = {label: [] for label in turns}
        for _ in range(5):
            for label, knobs in turns.items():
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
                _, wall = timed_search(S, **configs["fused_overlap"])
                stream_turns[label].append({
                    "wall_ms": wall * 1e3,
                    "new_segments": torch.cuda.memory_stats()[
                        "segment.all.allocated"] - segs})
        prof = profile_search(knn, S["q_np"], **configs["fused_overlap"])
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

    if "main" in phases or "stream" in phases:
        if "main" in phases:
            phase_main(sift_data())
        if "stream" in phases:
            phase_stream(sift_data())
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
            for mode in ("certified", "exact"):
                argv = ["--train", files["train"], "--test", files["test"],
                        "--val", files["val"], "--k", "50", "--mode", mode,
                        "--selector", "pallas",
                        "--out", os.path.join(tmp, f"Test_label_{mode}.csv")]
                reset_launches()
                results[mode] = run_job(args_to_config(build_parser().parse_args(argv)))
                results[mode + "_launches"] = ck.binned_select.launches
        cert, exact = results["certified"], results["exact"]
        if results["certified_launches"] < 1:
            raise AssertionError("the classify job launched K1 no time")
        if not (np.array_equal(cert.test_labels, exact.test_labels)
                and np.array_equal(cert.val_labels, exact.val_labels)):
            raise AssertionError("certified labels differ from exact labels")
        emit({"phase": "classify", "n_train": 20_000, "k": 50,
              "val_accuracy": cert.val_accuracy,
              "exact_val_accuracy": exact.val_accuracy,
              "labels_equal_exact": True,
              "k1_launches": results["certified_launches"],
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
