#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (knn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (a failed check raises, so the script
exits non-zero and prints no result):

1. device  — the card's name, ``nvidia-smi`` name and power limit, versions;
2. build   — builds every CUDA kernel of the port from ``knn_tpu_torch/csrc``
             with nvcc (one process per source, all at once);
3. kernel  — K1 (the fused bf16x3 binned-select kernel) against its plain
             PyTorch version on the card: dim 24 with ragged rows, dim 300
             (three dim chunks), one full 16,384-row SIFT tile at Q=256;
             cd and bounds within 64 eps_f32 (||q||^2 + max||t||^2), ci equal
             wherever a bin's values are separated by more than that, and
             the exclusion bound sound against float64 scores;
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
5. classify — the reference job (``python -m knn_tpu_torch.cli ... --k 50
             --mode certified --selector pallas``, run in-process through
             run_job) on make_mnist_like CSVs (20,000 train, 2,000 test,
             2,000 val); labels must equal the port's ``--mode exact``;
6. kernels — one JSON line per the contract: each ported kernel with its
             launches on the main path, its max error against its plain
             version, its time, its plain version's time and its bound.

Then the ``nvidia-smi`` name/power line and, last, ``{"ok": true, ...}``.
``--phases`` runs a subset (e.g. ``--phases device,build,kernel``).
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


def compare_k1(check, q, db, tile_n):
    """K1 vs its plain version on one input; returns a summary dict."""
    import torch

    from knn_tpu_torch.ops.coarse_knn import (BIN_W, SURVIVORS, binned_select,
                                              binned_select_plain,
                                              kernel_tolerance, pad_queries,
                                              prepare_db)

    survivors = SURVIVORS
    th, tl, tnorm = prepare_db(db, tile_n)
    qp = pad_queries(q)
    kern = binned_select(qp, th, tl, tnorm, tile_n=tile_n)
    plain = binned_select_plain(qp, th, tl, tnorm, tile_n=tile_n)
    torch.cuda.synchronize()
    q64 = q.double()
    qn = (q64 * q64).sum(-1)
    tmax = float((db.double() ** 2).sum(-1).max())
    tol_q = (64 * EPS32 * (qn + tmax)).float()
    err_cd = check.values("cd", kern[0], plain[0], tol_q)
    err_b = check.values("bounds", kern[2], plain[2], tol_q)
    # ci: equal wherever the slot's value is separated from its neighbours
    # in the bin's sorted order (survivor j vs j-1, j+1, and the bound)
    n_q = q.shape[0]
    n_tiles = th.shape[0] // tile_n
    cd_p = plain[0].view(n_q, n_tiles, survivors, BIN_W)
    bd_p = plain[2].view(n_q, n_tiles, 1, BIN_W)
    seq = torch.cat([cd_p, bd_p], dim=2)  # [Q, T, S+1, 128] ascending
    gap = (seq[:, :, 1:] - seq[:, :, :-1]).abs()
    tol4 = tol_q[:, None, None, None]
    sep = torch.ones_like(cd_p, dtype=torch.bool)
    sep &= gap[:, :, :survivors] > tol4  # above the next value
    sep[:, :, 1:] &= gap[:, :, : survivors - 1] > tol4  # below the previous
    sep &= torch.isfinite(cd_p)
    ci_k = kern[1].view(n_q, n_tiles, survivors, BIN_W)
    ci_p = plain[1].view(n_q, n_tiles, survivors, BIN_W)
    mism = int((sep & (ci_k != ci_p)).sum())
    if mism:
        raise AssertionError(f"ci: {mism} separated slots differ")
    out = {"q": n_q, "rows": db.shape[0], "dim": db.shape[1],
           "tile_n": tile_n, "max_abs_err_cd": err_cd,
           "max_abs_err_bounds": err_b,
           "ci_separated_checked": int(sep.sum())}
    # soundness: every real row that is not a candidate scores (f64) >= its
    # bin bound - kernel_tolerance
    n = db.shape[0]
    db64 = db.double()
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


def profile_search(knn, q_np) -> dict:
    """One more certified search under torch.profiler: device time by
    kernel name, the device's busy time (union of kernel intervals) and
    its idle share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        knn.search_certified(q_np, margin=28, selector="pallas")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="device,build,kernel,main,profile,classify",
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
    record = {"name": "binned_select_bf16x3", "route": "cuda",
              "source": "knn_tpu_torch/csrc/binned_coarse.cu",
              "replaces": "knn_tpu/ops/pallas_knn.py:856",
              "launches": None, "max_abs_err": None, "ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None}
    check = Check()

    if "device" in phases:
        emit({"phase": "device", "device": kind, "nvidia_smi": smi,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})

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
            cases.append(compare_k1(check, q, db, tile))
        q = torch.from_numpy((rng.random((256, 128)) * 128).astype(np.float32)).to(dev)
        db = torch.from_numpy((rng.random((16384, 128)) * 128).astype(np.float32)).to(dev)
        cases.append(compare_k1(check, q, db, ck.TILE_N))
        emit({"phase": "kernel", "cases": cases,
              "max_abs_err": check.max_abs_err})

    if "main" in phases:
        from knn_tpu_torch import ShardedKNN

        n, dim, n_q, k = 1_000_000, 128, 4096, 100
        rng = np.random.default_rng(0)
        db_np = (rng.random(size=(n, dim)) * 128.0).astype(np.float32)
        q_np = (rng.random(size=(n_q, dim)) * 128.0).astype(np.float32)
        t0 = time.perf_counter()
        knn = ShardedKNN(db_np, k=k)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        pl = knn.placement

        # K1 against its plain version at the main path's shape, then both
        # timed with CUDA events
        q_dev = torch.from_numpy(q_np).to(dev)
        qp = ck.pad_queries(q_dev)
        kern = ck.binned_select(qp, pl.th, pl.tl, pl.tnorm, tile_n=ck.TILE_N)
        plain = ck.binned_select_plain(qp, pl.th, pl.tl, pl.tnorm,
                                       tile_n=ck.TILE_N)
        qn = (q_dev.double() ** 2).sum(-1)
        tol_q = (64 * EPS32 * (qn + pl.db_norm_max)).float()
        full_err = max(check.values("cd@main", kern[0], plain[0], tol_q),
                       check.values("bounds@main", kern[2], plain[2], tol_q))
        del kern, plain
        ms = time_cuda(lambda: ck.binned_select(qp, pl.th, pl.tl, pl.tnorm,
                                                tile_n=ck.TILE_N), 3)
        plain_ms = time_cuda(lambda: ck.binned_select_plain(
            qp, pl.th, pl.tl, pl.tnorm, tile_n=ck.TILE_N), 1)
        n_p, dp = pl.th.shape
        bound = k1_bound(n_q, n, dp, n_p // ck.TILE_N, ck.SURVIVORS)

        # the main path, with the launch count read around it alone
        ck.binned_select.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i, stats = knn.search_certified(q_np, margin=28, selector="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ck.binned_select.launches
        if launches < 1:
            raise AssertionError("the main path launched K1 no time")
        # the same call again: the first one also pays one-time library
        # and allocator set-up
        t0 = time.perf_counter()
        knn.search_certified(q_np, margin=28, selector="pallas")
        torch.cuda.synchronize()
        wall_warm = time.perf_counter() - t0
        if d.shape != (n_q, k) or i.shape != (n_q, k) or not np.isfinite(d).all():
            raise AssertionError(f"bad result shapes {d.shape} {i.shape}")

        n_or = 256
        od, oi = f64_oracle(q_dev[:n_or], pl.db, k)
        oi = oi.cpu().numpy()
        od = od.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i[:n_or], oi)]))
        same = bool((i[:n_or] == oi).all())
        rel = float(np.max(np.abs(d[:n_or] - od) / np.maximum(od, 1e-30)))
        if recall != 1.0 or not same or rel > ck.RANK_SLACK:
            raise AssertionError(
                f"oracle mismatch: recall@{k}={recall} same_order={same} "
                f"max_rel_dist_err={rel}")
        record.update(launches=launches, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        emit({"phase": "main", "n": n, "dim": dim, "queries": n_q, "k": k,
              "qps": n_q / wall, "wall_s": wall, "setup_s": setup_s,
              "qps_second_call": n_q / wall_warm,
              "k1_ms_per_launch": ms, "k1_plain_ms": plain_ms,
              "k1_launches": launches, "k1_max_abs_err": full_err,
              "k1_bound": bound,
              "certified": stats["certified"],
              "fallback_queries": stats["fallback_queries"],
              "rank_corrected_queries": stats["rank_corrected_queries"],
              "host_exact_queries": stats.get("host_exact_queries", 0),
              "oracle_queries": n_or, "recall_at_k": recall,
              "same_indices": same, "max_rel_dist_err": rel,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        if "profile" in phases:
            emit(profile_search(knn, q_np))
        del knn, pl, q_dev, qp

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
                ck.binned_select.launches = 0
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

    record["max_abs_err"] = check.max_abs_err
    emit({"kernels": [record]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
