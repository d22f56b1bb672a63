"""Command line of the port on one GPU — the job path of knn_tpu/cli.py
(``main``) and its ``tune``, ``join``, ``index --selftest``, ``loadgen``,
``metrics``, ``doctor``, ``audit``, ``waterfall`` and ``roofline``
subcommands, as ``python -m knn_tpu_torch.cli``::

    python -m knn_tpu_torch.cli --train train.csv --test test.csv \\
        --val val.csv --k 50 --mode certified --selector pallas \\
        --out Test_label.csv
    python -m knn_tpu_torch.cli tune --n 100000 --dim 128 --k 100
    python -m knn_tpu_torch.cli join --n 100000 --rows 16384 --k 10
    python -m knn_tpu_torch.cli index --selftest
    python -m knn_tpu_torch.cli loadgen --synthetic 500 --slo-p99-ms 20
    python -m knn_tpu_torch.cli loadgen --n 100000 --dim 64 \\
        --rates 50,100,200
    python -m knn_tpu_torch.cli metrics --snapshot snap.json
    python -m knn_tpu_torch.cli doctor --port 9100
    python -m knn_tpu_torch.cli audit --bundle postmortem-....json
    python -m knn_tpu_torch.cli waterfall --log events.jsonl --top 4
    python -m knn_tpu_torch.cli roofline --n 1000000 --dim 128 \\
        --device-kind "NVIDIA H100 80GB HBM3"

The job's ``--metrics-port`` / ``--metrics-snapshot`` / ``--obs-log`` are
the telemetry exporters (knn_tpu_torch.obs); ``metrics``, ``doctor``,
``audit`` and ``waterfall`` read them (and postmortem bundles) back and,
like ``roofline``, touch no device.

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it exits with an error.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from knn_tpu_torch.ops.metrics import METRICS
from knn_tpu_torch.utils.config import (BACKENDS, CERTIFIED_PRECISIONS,
                                        SELECTORS, JobConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch",
        description="brute-force KNN classifier on one GPU (PyTorch/CUDA)")
    p.add_argument("--train", required=True, help="labeled train CSV (label,f0,f1,...)")
    p.add_argument("--test", required=True, help="unlabeled test CSV (f0,f1,...)")
    p.add_argument("--val", default=None, help="labeled validation CSV; enables accuracy scoring")
    p.add_argument("--out", default="Test_label.csv", help="predicted-label output path")
    p.add_argument("--k", type=int, default=50, help="neighbor count (ref K, knn_mpi.cpp:109)")
    p.add_argument("--metric", default="l2", choices=sorted(METRICS))
    p.add_argument("--dim", type=int, default=None, help="expected feature dim (validated)")
    p.add_argument("--num-classes", type=int, default=None, help="label count (inferred if omitted)")
    p.add_argument("--no-normalize", action="store_true", help="skip min-max normalization (ref Normalize=false)")
    p.add_argument("--backend", default="torch", choices=BACKENDS,
                   help="torch (the device path) or native (the C++ CPU "
                   "backend, built from knn_tpu_torch/native at first use)")
    p.add_argument("--train-tile", type=int, default=None, help="db rows per distance tile in the exact path")
    p.add_argument("--batch-size", type=int, default=None, help="queries per step")
    p.add_argument("--compute-dtype", default=None,
                   help="matmul dtype, e.g. bfloat16")
    p.add_argument(
        "--mode", default="exact", choices=("exact", "certified"),
        help="certified = a coarse pass + certificate + float64 repair "
        "(exact results)")
    p.add_argument("--selector", default="pallas", choices=SELECTORS,
                   help="certificate for --mode certified: pallas (the "
                   "one-pass coarse kernel, default) or the counted exact "
                   "/ approx")
    p.add_argument("--tune-cache", default=None, metavar="PATH",
                   help="autotuner winner cache the pallas selector's "
                   "kernel knobs resolve from (default: "
                   "~/.cache/knn_tpu_torch/autotune.json)")
    p.add_argument("--pallas-precision", default=None,
                   choices=CERTIFIED_PRECISIONS,
                   help="coarse-kernel precision (default bf16x3; also "
                   "bf16x3f, highest, int8, int4 and pq, whose codebooks "
                   "train on the train rows)")
    p.add_argument(
        "--serve-buckets", default=None, metavar="SPEC",
        help="shape-bucketed serving: 'auto' or a comma list like "
        "'64,128,256' — query chunks pad up a ladder of per-bucket "
        "executables (CUDA graphs on the card, built at warmup); "
        "per-bucket capture counts and latency percentiles land in the "
        "JSON metrics")
    p.add_argument(
        "--max-wait-ms", type=float, default=2.0,
        help="micro-batching deadline of a concurrent serving queue "
        "(knn_tpu_torch.serving.QueryQueue); the sequential job has no "
        "concurrent callers, so here it is only echoed into the serving "
        "metrics")
    p.add_argument("--num-threads", type=int, default=0,
                   help="native backend threads (0 = all cores)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path on the CPU)")
    p.add_argument("--metrics-json", default=None, help="write structured run metrics to this path")
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve live telemetry over HTTP while the job runs: /metrics "
        "(Prometheus text), /metrics.json, /healthz, /statusz "
        "(knn_tpu_torch.obs; read with `python -m knn_tpu_torch.cli "
        "metrics --port PORT`; 0 picks a free port)")
    p.add_argument(
        "--metrics-snapshot", default=None, metavar="PATH",
        help="write an atomic JSON telemetry snapshot (tmp + rename) at "
        "job end")
    p.add_argument(
        "--obs-log", default=None, metavar="PATH",
        help="append structured telemetry events (spans, phases) to this "
        "JSONL file, rotated to two generations")
    return p


def args_to_config(args: argparse.Namespace) -> JobConfig:
    return JobConfig(
        train_file=args.train,
        test_file=args.test,
        val_file=args.val,
        output_file=args.out,
        dim=args.dim,
        k=args.k,
        num_classes=args.num_classes,
        metric=args.metric,
        normalize=not args.no_normalize,
        validation=args.val is not None,
        backend=args.backend,
        device=args.device,
        train_tile=args.train_tile,
        batch_size=args.batch_size,
        compute_dtype=args.compute_dtype,
        mode=args.mode,
        selector=args.selector,
        tune_cache=args.tune_cache,
        pallas_precision=args.pallas_precision,
        serve_buckets=args.serve_buckets,
        max_wait_ms=args.max_wait_ms,
        num_threads=args.num_threads,
    )


def build_tune_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch tune",
        description="Autotune the coarse kernels for one problem shape and "
        "persist the winner (knn_tpu_torch.tuning); a second run for the "
        "same (device kind, n, dim, k, metric) resolves from the "
        "cache with zero re-timing.")
    p.add_argument("--n", type=int, default=100_000, help="database rows")
    p.add_argument("--dim", type=int, default=128, help="feature dim")
    p.add_argument("--k", type=int, default=100, help="neighbor count")
    p.add_argument("--metric", default="l2",
                   choices=("l2", "sql2", "euclidean"))
    p.add_argument("--queries", type=int, default=256,
                   help="timing/gate query count")
    p.add_argument("--margin", type=int, default=28, help="candidate margin")
    p.add_argument("--grid", default="standard",
                   choices=("quick", "standard", "full"),
                   help="knob grid size (tuning.knob_grid)")
    p.add_argument("--runs", type=int, default=2,
                   help="timed repetitions per candidate (fenced)")
    p.add_argument("--seed", type=int, default=0, help="synthetic data seed")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="cache file (default: "
                   "~/.cache/knn_tpu_torch/autotune.json)")
    p.add_argument("--force", action="store_true",
                   help="re-search even when a cached winner exists")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the result record to this path")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' tunes the plain "
                   "PyTorch versions)")
    return p


def run_tune(args: argparse.Namespace) -> int:
    """The ``tune`` subcommand (knn_tpu/cli.py:308-343): synthetic data at
    the requested shape (``rng.random * 128``), tuning.autotune, one
    summary line and one JSON line (winner, per-candidate timings,
    counters: the zero re-timing evidence)."""
    import json

    import numpy as np

    from knn_tpu_torch import tuning

    rng = np.random.default_rng(args.seed)
    db = (rng.random(size=(args.n, args.dim)) * 128.0).astype(np.float32)
    queries = (rng.random(size=(args.queries, args.dim)) * 128.0).astype(
        np.float32)
    tuning.reset_counters()
    entry = tuning.autotune(
        db, queries, args.k, metric=args.metric, margin=args.margin,
        grid_level=args.grid, runs=args.runs, cache_path=args.cache,
        force=args.force, device=args.device)
    record = {**entry, "counters": tuning.counters()}
    if entry["cached"]:
        print(f"cached winner for {record['cache_key']}: "
              f"{entry['winner']} ({entry['winner_ms']} ms) — "
              f"0 candidates re-timed")
    else:
        print(f"tuned {record['cache_key']}: winner {entry['winner']} "
              f"({entry['winner_ms']} ms) from "
              f"{len(entry['timings_ms'])} candidates -> "
              f"{record['cache_path']}")
    print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
    return 0


def build_join_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch join",
        description="Bulk all-pairs kNN join (knn_tpu_torch.join): every "
        "row of a host query set joined against the corpus through the "
        "double-buffered superblock stream (mode=stream) or the "
        "certified per-superblock loop (mode=certified).  Prints the plan "
        "and measured stats as one JSON line.")
    p.add_argument("--n", type=int, default=100_000, help="corpus rows (B)")
    p.add_argument("--rows", type=int, default=16_384,
                   help="query rows (A) — the join's outer set")
    p.add_argument("--dim", type=int, default=128, help="feature dim")
    p.add_argument("--k", type=int, default=10, help="neighbor count")
    p.add_argument("--metric", default="l2",
                   choices=("l2", "sql2", "euclidean", "cosine", "dot"))
    p.add_argument("--mode", default="stream",
                   choices=("stream", "certified"),
                   help="stream = double-buffered raw top-k; certified = "
                   "search_certified per superblock (exact, slower)")
    p.add_argument("--superblock", type=int, default=None,
                   help="query superblock rows (default: the h2d budget "
                   "model with --query-budget-bytes, else 4096)")
    p.add_argument("--depth", type=int, default=None,
                   help="superblocks in flight (default 2)")
    p.add_argument("--query-budget-bytes", type=int, default=None,
                   help="size superblocks from this h2d staging budget "
                   "(analysis.hbm.plan_superblocks)")
    p.add_argument("--hbm-budget-bytes", type=int, default=None,
                   help="device byte budget of the corpus: one larger "
                   "stays in host RAM and streams through the card in "
                   "budget-sized segments (ShardedKNN(hbm_budget_bytes=))")
    p.add_argument("--seed", type=int, default=0, help="synthetic data seed")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the stats record to this path")
    p.add_argument("--cpu-devices", type=int, default=None, metavar="N",
                   help="refused: JAX's virtual devices; use --device cpu")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path)")
    return p


def run_join(args: argparse.Namespace) -> int:
    """The ``join`` subcommand (knn_tpu/cli.py:344-422): synthetic data at
    the requested shape, knn_tpu_torch.join.knn_join, one summary line and
    one JSON line (the engine's stats: plan against executed counts,
    overlap_ratio, rows/s)."""
    import json

    import numpy as np

    from knn_tpu_torch.join import knn_join
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    if args.cpu_devices is not None:
        raise SystemExit(
            "join --cpu-devices: JAX's virtual CPU devices have no "
            "counterpart here; pass --device cpu")
    rng = np.random.default_rng(args.seed)
    db = rng.random(size=(args.n, args.dim)).astype(np.float32)
    qa = rng.random(size=(args.rows, args.dim)).astype(np.float32)
    prog = ShardedKNN(db, k=args.k, metric=args.metric, device=args.device,
                      hbm_budget_bytes=args.hbm_budget_bytes)
    _, _, stats = knn_join(
        prog, qa, mode=args.mode, superblock_rows=args.superblock,
        depth=args.depth, query_budget_bytes=args.query_budget_bytes)
    print(f"joined {stats['rows']} x {args.n} rows (k={args.k}, "
          f"{args.metric}, {stats['mode']}): "
          f"{stats['rows_per_s']} rows/s over "
          f"{stats['superblocks']} superblocks x "
          f"{stats['db_segments']} db segments "
          f"({stats['order']}, overlap {stats['overlap_ratio']})")
    print(json.dumps(stats))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
    return 0


def build_index_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch index",
        description="Mutable-index self-test (knn_tpu_torch.index): "
        "--selftest builds a small synthetic MutableIndex, runs an "
        "insert/delete/compact cycle and checks the mutation oracle "
        "(search_certified bitwise against a fresh index of the "
        "surviving rows) — exit 0 on a bitwise match.  --port/--snapshot "
        "render the index section of a process's /statusz or of a "
        "snapshot (exit 2 when no index is registered).")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--port", type=int, default=None,
                     help="fetch /statusz from http://HOST:PORT")
    src.add_argument("--snapshot", default=None, metavar="PATH",
                     help="read an atomic JSON snapshot file")
    src.add_argument("--selftest", action="store_true",
                     help="run the insert/delete/compact oracle check")
    p.add_argument("--host", default="127.0.0.1",
                   help="endpoint host for --port (default localhost)")
    p.add_argument("--json", action="store_true",
                   help="print the index section's JSON")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path)")
    return p


def run_index(args: argparse.Namespace) -> int:
    """The ``index`` subcommand (knn_tpu/cli.py:1269-1350): the status
    render of the registered indexes, or the mutation-oracle self-test."""
    import json

    import numpy as np

    from knn_tpu_torch.index import MutableIndex

    if not args.selftest:
        return _run_index_status(args)
    rng = np.random.default_rng(0)
    db = rng.normal(size=(600, 16)).astype(np.float32) * 10
    q = rng.normal(size=(8, 16)).astype(np.float32) * 10
    idx = MutableIndex(db, k=5, reserve=8, device=args.device)
    new = rng.normal(size=(6, 16)).astype(np.float32) * 10
    idx.insert(new, np.arange(1000, 1006))
    idx.delete([3, 11, 40])
    d_m, i_m, _ = idx.search_certified(q)
    surv = np.ones(600, bool)
    surv[[3, 11, 40]] = False
    rows = np.concatenate([db[surv], new])
    ids = np.concatenate([np.arange(600)[surv], np.arange(1000, 1006)])
    fresh = MutableIndex(rows, ids, k=5, reserve=8, device=args.device)
    d_f, i_f, _ = fresh.search_certified(q)
    oracle_ok = bool(np.array_equal(d_m, d_f) and np.array_equal(i_m, i_f))
    rep = idx.compact()
    d_c, i_c, _ = idx.search_certified(q)
    compact_ok = bool(np.array_equal(d_c, d_f)
                      and np.array_equal(i_c, i_f))
    out = {"ok": oracle_ok and compact_ok,
           "oracle_bitwise": oracle_ok,
           "post_compact_bitwise": compact_ok,
           "compaction": rep, "stats": idx.stats()}
    print(json.dumps(out, sort_keys=True, default=str))
    return 0 if out["ok"] else 1


def _run_index_status(args: argparse.Namespace) -> int:
    import json
    import urllib.request

    from knn_tpu_torch.obs import health

    if args.port is not None:
        url = f"http://{args.host}:{args.port}/statusz"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                report = json.loads(r.read().decode())
        except (OSError, json.JSONDecodeError) as e:
            print(f"statusz endpoint {url} unreachable: {e}",
                  file=sys.stderr)
            return 1
    else:
        try:
            with open(args.snapshot) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read snapshot {args.snapshot}: {e}",
                  file=sys.stderr)
            return 1
        report = health.report_from_snapshot(payload)
    section = report.get("index") or []
    if args.json:
        print(json.dumps(section, indent=1, sort_keys=True, default=str))
    else:
        if not section:
            print("no mutable index registered in this process")
        for line in health.render_text(report).splitlines():
            if line.startswith("index["):
                print(line)
    return 0 if section else 2


def build_loadgen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch loadgen",
        description="Open-loop load generation and knee sweep "
        "(knn_tpu_torch.loadgen): drive a serving target with a seeded "
        "Poisson / bursty / replayed multi-tenant workload through a "
        "stepped-rate sweep, and print the latency-vs-throughput knee "
        "block (rate steps, admitted p50/p95/p99, shed fraction, knee "
        "q/s) as one trailing JSON line.  --synthetic CAPACITY runs "
        "against the built-in single-server model (no device); otherwise "
        "a synthetic-data ShardedKNN + ServingEngine + QueryQueue is built "
        "at --n/--dim/--k on --device.  Admission control: --max-depth, "
        "--shed, --quota, --deadline-ms.")
    p.add_argument("--synthetic", type=float, default=None,
                   metavar="QPS", help="drive the synthetic target with "
                   "this service capacity instead of a real engine")
    p.add_argument("--n", type=int, default=100_000, help="database rows")
    p.add_argument("--dim", type=int, default=64, help="feature dim")
    p.add_argument("--k", type=int, default=10, help="neighbor count")
    p.add_argument("--metric", default="l2",
                   choices=("l2", "sql2", "euclidean", "cosine"))
    p.add_argument("--rates", default=None, metavar="R1,R2,...",
                   help="offered request rates (q/s) to step through; "
                   "unset = a ladder around a measured closed-loop anchor "
                   "(real target) or the synthetic capacity")
    p.add_argument("--duration", type=float, default=1.0, metavar="S",
                   help="seconds per rate step")
    p.add_argument("--slo-p99-ms", type=float, default=100.0,
                   help="admitted-request p99 bound defining the knee")
    p.add_argument("--tenants", default="default:1",
                   help="tenant mix: name[:weight[:priority]],...")
    p.add_argument("--batch-sizes", default="1,2,4,8",
                   help="request row counts, drawn uniformly per request")
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "onoff"),
                   help="arrival process (bursty on/off via --on-s/"
                   "--off-s/--burst)")
    p.add_argument("--on-s", type=float, default=0.25)
    p.add_argument("--off-s", type=float, default=0.25)
    p.add_argument("--burst", type=float, default=4.0,
                   help="on-phase rate multiplier for --arrival onoff")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline applied to every tenant; "
                   "implies deadline-aware shedding (--shed)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="micro-batching deadline of the driven queue")
    p.add_argument("--max-depth", type=int, default=None,
                   help="admission: bounded queue depth (explicit "
                   "rejection past it)")
    p.add_argument("--shed", action="store_true",
                   help="admission: deadline-aware load shedding")
    p.add_argument("--quota", action="append", default=[],
                   metavar="TENANT:RATE[:BURST]",
                   help="admission: per-tenant token-bucket quota "
                   "(repeatable)")
    p.add_argument("--replay", default=None, metavar="PATH",
                   help="replay a recorded JSONL trace instead of "
                   "generating arrivals (single run, no sweep)")
    p.add_argument("--save-trace", default=None, metavar="PATH",
                   help="record the generated schedule (first rate step) "
                   "to this JSONL file for a later --replay")
    p.add_argument("--json", action="store_true",
                   help="print the raw JSON block only")
    p.add_argument("--cpu-devices", type=int, default=None, metavar="N",
                   help="refused: JAX's virtual devices; use --device cpu")
    p.add_argument("--device", default=None,
                   help="torch device of the real target (default cuda; "
                   "'cpu' runs the plain PyTorch path)")
    return p


def run_loadgen(args: argparse.Namespace) -> int:
    """The ``loadgen`` subcommand (knn_tpu/cli.py:1101-1238): a knee sweep
    (or one replay run) against the synthetic model or a freshly built
    serving stack, a summary, and one trailing JSON line.  Admission
    flags map onto ``AdmissionConfig``; without any of them admission is
    off (there is no environment switch)."""
    import json

    import numpy as np

    from knn_tpu_torch import loadgen
    from knn_tpu_torch.serving.admission import AdmissionConfig, parse_quotas

    if args.cpu_devices is not None:
        raise SystemExit(
            "loadgen --cpu-devices: JAX's virtual CPU devices have no "
            "counterpart here; pass --device cpu")
    tenants = tuple(
        loadgen.TenantSpec(
            t.name, weight=t.weight, priority=t.priority,
            batch_sizes=tuple(int(b) for b in
                              args.batch_sizes.split(",") if b.strip()),
            deadline_ms=args.deadline_ms)
        for t in loadgen.parse_tenants(args.tenants))
    try:
        quotas = parse_quotas(",".join(args.quota))
    except ValueError as e:
        print(f"--quota: {e}", file=sys.stderr)
        return 1
    # only nonzero tenant levels make a priority table (an all-zero one
    # would defeat the queue's FIFO path)
    priorities = {t.name: t.priority for t in tenants if t.priority}
    admission = None
    if (args.max_depth is not None or args.shed or quotas or priorities
            or args.deadline_ms is not None):
        # --deadline-ms implies shedding: deadlines nobody enforces would
        # report shed=0 as "all deadlines met"
        admission = AdmissionConfig(
            max_depth=args.max_depth,
            shed=args.shed or args.deadline_ms is not None,
            quotas=quotas, priorities=priorities)
    rates_given = ([float(r) for r in args.rates.split(",") if r.strip()]
                   if args.rates else None) or None

    dim = args.dim
    if args.synthetic is not None:
        if admission is not None and (admission.quotas
                                      or admission.priorities):
            print("warning: --synthetic models max-depth and deadline "
                  "shedding only — quotas and priorities are ignored "
                  "(use a real engine to exercise them)",
                  file=sys.stderr)

        def make_target():
            return loadgen.SyntheticTarget(
                args.synthetic,
                max_depth=None if admission is None
                else admission.max_depth,
                shed_deadlines=admission.shed if admission else False)
        anchor = args.synthetic
        pool = np.zeros((max(64, *(max(t.batch_sizes) for t in tenants)),
                         dim), np.float32)
    else:
        from knn_tpu_torch.parallel.sharded import ShardedKNN
        from knn_tpu_torch.serving.engine import ServingEngine
        from knn_tpu_torch.serving.queue import QueryQueue

        rng = np.random.default_rng(args.seed)
        db = (rng.random((args.n, dim)) * 128.0).astype(np.float32)
        pool = (rng.random((4096, dim)) * 128.0).astype(np.float32)
        prog = ShardedKNN(db, k=args.k, metric=args.metric,
                          device=args.device)
        engine = ServingEngine(prog)
        print("warming serving engine ...", file=sys.stderr)
        engine.warmup()

        def make_target():
            return QueryQueue(engine, max_wait_ms=args.max_wait_ms,
                              admission=admission)

        anchor = None
        if rates_given is None and not args.replay:
            # the closed-loop anchor probe through an admission-free
            # queue, only when the rate ladder needs it
            with QueryQueue(engine, max_wait_ms=args.max_wait_ms) as q0:
                anchor = loadgen.closed_loop_anchor(q0, pool)

    base = loadgen.WorkloadSpec(
        rate_qps=1.0, duration_s=args.duration, seed=args.seed,
        arrival=args.arrival, tenants=tenants, on_s=args.on_s,
        off_s=args.off_s, burst=args.burst)
    if args.replay:
        reqs = loadgen.load_trace(args.replay)
        target = make_target()
        try:
            rep = loadgen.run_workload(target, reqs, queries=pool)
        finally:
            close = getattr(target, "close", None)
            if callable(close):
                close()
        if not args.json:
            lat = rep.get("latency_ms") or {}
            print(f"replayed {rep['offered']} requests: ok={rep['ok']} "
                  f"rejected={rep['rejected']} shed={rep['shed']} "
                  f"p99={lat.get('p99')} ms "
                  f"achieved={rep['achieved_qps']} q/s")
        print(json.dumps(rep))
        return 0
    rates = rates_given or loadgen.rates_around(anchor)
    if args.save_trace:
        loadgen.save_trace(loadgen.generate(base.at_rate(rates[0])),
                           args.save_trace)
        print(f"trace saved: {args.save_trace}", file=sys.stderr)
    block = loadgen.knee_sweep(make_target, base, rates, queries=pool,
                               slo_p99_ms=args.slo_p99_ms)
    if not args.json:
        for s in block["rate_steps"]:
            print(f"rate {s['rate_qps']:>9.2f} q/s: ok={s['ok']:>5} "
                  f"rejected={s['rejected']:>4} shed={s['shed']:>4} "
                  f"p99={s['admitted_p99_ms']} ms "
                  f"achieved={s['achieved_qps']} q/s "
                  f"{'WITHIN' if s['within_slo'] else 'OVER'} SLO")
        print(f"knee: {block['knee_qps']} q/s sustained "
              f"(offered {block['knee_rate_qps']} q/s) at p99 <= "
              f"{block['slo_p99_ms']} ms")
    print(json.dumps(block))
    return 0


def build_metrics_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch metrics",
        description="Read telemetry from a running process's "
        "--metrics-port endpoint or from an atomic JSON snapshot file "
        "(knn_tpu_torch.obs) and print it as Prometheus text or JSON.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--port", type=int, default=None,
                     help="fetch from http://HOST:PORT (a process "
                     "started with --metrics-port)")
    src.add_argument("--snapshot", default=None, metavar="PATH",
                     help="read an atomic JSON snapshot file "
                     "(--metrics-snapshot / obs.write_json_snapshot)")
    p.add_argument("--host", default="127.0.0.1",
                   help="endpoint host for --port (default localhost)")
    p.add_argument("--format", default="prom", choices=("prom", "json"),
                   help="output format (Prometheus text | snapshot JSON)")
    return p


def run_metrics(args: argparse.Namespace) -> int:
    """The ``metrics`` subcommand (knn_tpu/cli.py:423-478): no device is
    touched."""
    import json
    import urllib.request

    if args.port is not None:
        path = "/metrics" if args.format == "prom" else "/metrics.json"
        url = f"http://{args.host}:{args.port}{path}"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                sys.stdout.write(r.read().decode())
        except OSError as e:
            print(f"metrics endpoint {url} unreachable: {e}",
                  file=sys.stderr)
            return 1
        return 0
    try:
        with open(args.snapshot) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read snapshot {args.snapshot}: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        from knn_tpu_torch.obs import prometheus_text

        sys.stdout.write(prometheus_text(payload.get("metrics", {})))
    return 0


def build_doctor_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch doctor",
        description="Render the health / self-diagnosis report "
        "(knn_tpu_torch.obs.health) of a running process (/statusz) or "
        "of an atomic JSON snapshot.  Exit 0 healthy, 2 not ready, 1 "
        "unreadable source.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--port", type=int, default=None,
                     help="fetch /statusz from http://HOST:PORT (a "
                     "process started with --metrics-port)")
    src.add_argument("--snapshot", default=None, metavar="PATH",
                     help="read an atomic JSON snapshot file")
    p.add_argument("--host", default="127.0.0.1",
                   help="endpoint host for --port (default localhost)")
    p.add_argument("--json", action="store_true",
                   help="print the raw report JSON instead of the "
                   "human-readable rendering")
    return p


def run_doctor(args: argparse.Namespace) -> int:
    """The ``doctor`` subcommand (knn_tpu/cli.py:481-530)."""
    import json
    import urllib.request

    from knn_tpu_torch.obs import health

    if args.port is not None:
        url = f"http://{args.host}:{args.port}/statusz"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                report = json.loads(r.read().decode())
        except (OSError, json.JSONDecodeError) as e:
            print(f"statusz endpoint {url} unreachable: {e}",
                  file=sys.stderr)
            return 1
    else:
        try:
            with open(args.snapshot) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read snapshot {args.snapshot}: {e}",
                  file=sys.stderr)
            return 1
        report = health.report_from_snapshot(payload)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True, default=str))
    else:
        sys.stdout.write(health.render_text(report))
    return 0 if report.get("readiness", {}).get("ready") else 2


def build_audit_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch audit",
        description="Render the quality-observability state "
        "(knn_tpu_torch.obs.audit): the shadow audit sampler's sampled/"
        "replayed/deficient/dropped tallies and drift sketches from a "
        "running process's /statusz, an atomic JSON snapshot, or a "
        "flight-recorder postmortem bundle's embedded audit evidence; no "
        "device is touched.  Exit 0 clean, 2 deficient or dropped audits "
        "on record, 1 unreadable source.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--port", type=int, default=None,
                     help="fetch /statusz from http://HOST:PORT (a "
                     "process started with --metrics-port)")
    src.add_argument("--snapshot", default=None, metavar="PATH",
                     help="read an atomic JSON snapshot file "
                     "(--metrics-snapshot / obs.write_json_snapshot)")
    src.add_argument("--bundle", default=None, metavar="PATH",
                     help="read a flight-recorder postmortem bundle "
                     "(obs.blackbox.configure(postmortem_dir=...)) and "
                     "render its embedded audit evidence, failing records "
                     "included")
    p.add_argument("--host", default="127.0.0.1",
                   help="endpoint host for --port (default localhost)")
    p.add_argument("--json", action="store_true",
                   help="print the raw quality JSON instead of the "
                   "human-readable rendering")
    return p


def run_audit(args: argparse.Namespace) -> int:
    """The ``audit`` subcommand (knn_tpu/cli.py:609-720): no device is
    touched."""
    import json
    import urllib.request

    failures: list = []
    if args.port is not None:
        url = f"http://{args.host}:{args.port}/statusz"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                report = json.loads(r.read().decode())
        except (OSError, json.JSONDecodeError) as e:
            print(f"statusz endpoint {url} unreachable: {e}",
                  file=sys.stderr)
            return 1
        quality = report.get("quality") or {}
    elif args.snapshot is not None:
        from knn_tpu_torch.obs import health

        try:
            with open(args.snapshot) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read snapshot {args.snapshot}: {e}",
                  file=sys.stderr)
            return 1
        quality = health.report_from_snapshot(payload).get("quality") or {}
    else:
        from knn_tpu_torch.obs import blackbox

        try:
            payload = blackbox.read_bundle(args.bundle)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"cannot read bundle {args.bundle}: {e}",
                  file=sys.stderr)
            return 1
        audit_sec = payload.get("audit") or {}
        quality = audit_sec.get("summary") or {}
        failures = audit_sec.get("failures") or []
    if args.json:
        print(json.dumps({"quality": quality, "failures": failures},
                         indent=1, sort_keys=True, default=str))
    else:
        if not quality:
            print("audit: no quality section on record "
                  "(sampler never armed, or pre-quality source)")
        else:
            print(f"audit: rate={quality.get('rate')} "
                  f"budget_rows_s={quality.get('budget_rows_s')}")
            print(f"  sampled={quality.get('sampled_requests')} "
                  f"replayed={quality.get('replayed_queries')}q "
                  f"deficient={quality.get('deficient_queries')} "
                  f"rows_scored={quality.get('rows_scored')} "
                  f"last_recall@k={quality.get('last_recall_at_k')}")
            dropped = quality.get("dropped") or {}
            if dropped:
                drops = " ".join(f"{r}={c}"
                                 for r, c in sorted(dropped.items()))
                print(f"  dropped: {drops}")
            for i, dr in enumerate(quality.get("drift") or []):
                print(f"  drift[{i}]: "
                      f"queries={dr.get('queries_observed')} "
                      f"norm_psi={dr.get('norm_psi')} "
                      f"assign_psi={dr.get('centroid_assign_psi')}")
        if failures:
            print(f"failing audit record(s) ({len(failures)}):")
            for f_rec in failures:
                if "error" in f_rec:
                    print(f"  {f_rec.get('trace_id')} "
                          f"tenant={f_rec.get('tenant')} "
                          f"error={f_rec['error']}")
                    continue
                print(f"  {f_rec.get('trace_id')} "
                      f"tenant={f_rec.get('tenant')} "
                      f"epoch={f_rec.get('epoch')} "
                      f"deficient={f_rec.get('deficient_queries')} "
                      f"max_displacement="
                      f"{f_rec.get('max_rank_displacement')}")
                print(f"    recall@k={f_rec.get('recall_at_k')}")
                print(f"    worst q{f_rec.get('worst_query')}: "
                      f"served={f_rec.get('worst_served_ids')} "
                      f"oracle={f_rec.get('worst_oracle_ids')}")
    deficient = int(quality.get("deficient_queries") or 0)
    dropped_n = sum((quality.get("dropped") or {}).values())
    return 2 if (deficient or dropped_n or failures) else 0


def build_waterfall_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch waterfall",
        description="Render per-request latency waterfalls and the "
        "aggregated critical-path attribution "
        "(knn_tpu_torch.obs.waterfall) from a flight-recorder postmortem "
        "bundle, a JSONL event log (--obs-log; the rotated .1 generation "
        "is merged), or a running process's /waterfallz endpoint; no "
        "device is touched.  Exit 0 rendered, 1 unreadable source.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", default=None, metavar="PATH",
                     help="read a postmortem bundle written by the "
                     "flight recorder (obs.blackbox)")
    src.add_argument("--log", default=None, metavar="PATH",
                     help="read a JSONL event log (--obs-log / "
                     "obs.reset_event_log(path)); <PATH>.1 is merged when "
                     "present")
    src.add_argument("--port", type=int, default=None,
                     help="fetch /waterfallz from http://HOST:PORT (a "
                     "process started with --metrics-port)")
    p.add_argument("--host", default="127.0.0.1",
                   help="endpoint host for --port (default localhost)")
    p.add_argument("--trace-id", action="append", default=[],
                   metavar="ID", help="render only these request ids "
                   "(repeatable; default: the --top slowest)")
    p.add_argument("--top", type=int, default=8,
                   help="how many waterfalls to render, slowest first")
    p.add_argument("--json", action="store_true",
                   help="print the raw forensics payload JSON instead "
                   "of the rendering")
    return p


def run_waterfall(args: argparse.Namespace) -> int:
    """The ``waterfall`` subcommand (knn_tpu/cli.py:919-1021): no device
    is touched."""
    import json
    import urllib.request

    from knn_tpu_torch.obs import waterfall

    if args.port is not None:
        url = f"http://{args.host}:{args.port}/waterfallz"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.loads(r.read().decode())
        except (OSError, json.JSONDecodeError) as e:
            print(f"waterfallz endpoint {url} unreachable: {e}",
                  file=sys.stderr)
            return 1
        wfs = payload.get("waterfalls") or {}
        agg = payload.get("attribution") or waterfall.attribute(wfs)
        dvr = payload.get("device_vs_roofline")
    elif args.bundle is not None:
        from knn_tpu_torch.obs import blackbox

        try:
            payload = blackbox.read_bundle(args.bundle)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"cannot read bundle {args.bundle}: {e}",
                  file=sys.stderr)
            return 1
        # the bundle embeds the raw event ring — reconstruct from it so
        # offline rendering uses the same code path as live
        wfs = waterfall.reconstruct(payload.get("events") or [])
        agg = payload.get("attribution") or waterfall.attribute(wfs)
        dvr = payload.get("device_vs_roofline")
        if not args.json:
            # header stays off the --json stdout: that output must
            # parse as one JSON document
            print(f"postmortem bundle: "
                  f"objective={payload.get('objective')} "
                  f"state={payload.get('state')} "
                  f"written_at={payload.get('written_at')} "
                  f"pid={payload.get('pid')}")
    else:
        try:
            events = waterfall.read_jsonl_events(args.log)
        except (OSError, ValueError) as e:
            print(f"cannot read event log {args.log}: {e}",
                  file=sys.stderr)
            return 1
        wfs = waterfall.reconstruct(events)
        agg = waterfall.attribute(wfs)
        dvr = waterfall.device_vs_roofline(wfs)
        payload = {"waterfalls": wfs, "attribution": agg,
                   "device_vs_roofline": dvr}
    if args.json:
        print(json.dumps(payload, indent=1, sort_keys=True, default=str))
        return 0
    if args.trace_id:
        picked = [wfs[t] for t in args.trace_id if t in wfs]
        missing = [t for t in args.trace_id if t not in wfs]
        for t in missing:
            print(f"trace id {t}: no reconstructable request in this "
                  f"source", file=sys.stderr)
    else:
        picked = sorted(wfs.values(),
                        key=lambda w: -(w.get("total_s") or 0.0))
        picked = picked[: max(0, args.top)]
    print(waterfall.render_attribution(agg, dvr))
    for w in picked:
        print(waterfall.render_waterfall(w))
    if not picked:
        print("no reconstructable requests in this source",
              file=sys.stderr)
    return 0


def build_roofline_parser() -> argparse.ArgumentParser:
    from knn_tpu_torch.obs.roofline import (BOUND_CLASSES, PEAKS_BY_KIND,
                                            PRECISIONS)

    p = argparse.ArgumentParser(
        prog="knn_tpu_torch roofline",
        description="Render the analytic roofline (knn_tpu_torch.obs."
        "roofline) of one configuration: the terms' bytes and operations "
        "at the device's peaks, the ceiling q/s and the bound class "
        f"({', '.join(BOUND_CLASSES)}).  No device is touched.")
    p.add_argument("--n", type=int, required=True, help="database rows")
    p.add_argument("--dim", type=int, required=True, help="feature dim")
    p.add_argument("--k", type=int, default=100, help="neighbor count")
    p.add_argument("--nq", type=int, default=4096,
                   help="queries per call (the rate's numerator)")
    p.add_argument("--selector", default="pallas",
                   choices=("pallas", "exact", "approx"),
                   help="pallas = the coarse-kernel model (knob flags "
                   "below); exact / approx = the counted selectors")
    p.add_argument("--device-kind", default=None,
                   choices=sorted(PEAKS_BY_KIND),
                   help="peak-table row to model against; unset = the "
                   "generic-CPU peaks, flagged estimated")
    p.add_argument("--precision", default=None, choices=PRECISIONS,
                   help="coarse-kernel arm (pallas selector)")
    p.add_argument("--kernel", default=None,
                   choices=("tiled", "streaming", "fused"))
    p.add_argument("--grid-order", default=None,
                   choices=("query_major", "db_major"))
    p.add_argument("--binning", default=None, choices=("grouped", "lane"))
    p.add_argument("--tile-n", type=int, default=None)
    p.add_argument("--bin-w", type=int, default=None)
    p.add_argument("--survivors", type=int, default=None)
    p.add_argument("--margin", type=int, default=28)
    p.add_argument("--dtype", default=None,
                   choices=("bfloat16", "float16", "float32"),
                   help="placement compute dtype (exact / approx)")
    p.add_argument("--qps", type=float, default=None,
                   help="a measured q/s to attribute: adds roofline_pct")
    p.add_argument("--nprobe", type=int, default=None,
                   help="IVF lists probed per query (with --ncentroids)")
    p.add_argument("--ncentroids", type=int, default=None,
                   help="IVF list count (required with --nprobe)")
    p.add_argument("--pq-dsub", type=int, default=None,
                   help="pq dims per subspace (default 4)")
    p.add_argument("--pq-ncodes", type=int, default=None,
                   help="pq codes per subspace (default 256)")
    p.add_argument("--best", nargs="?", const=10, type=int, default=None,
                   metavar="N",
                   help="rank the autotuner's full knob grid by modeled "
                   "ceiling and print the top N (the offline twin of "
                   "autotune's prune=); the knob flags are ignored")
    p.add_argument("--json", action="store_true",
                   help="print the raw model JSON instead of the "
                   "rendering")
    return p


def _run_roofline_best(args) -> int:
    """``roofline --best``: ``tuning.knob_grid("full")`` ranked by modeled
    ceiling (knn_tpu/cli.py:804-870)."""
    import json

    from knn_tpu_torch import tuning
    from knn_tpu_torch.obs import roofline
    from knn_tpu_torch.tuning.autotune import _label

    ranked = []
    seen = set()
    for cand in tuning.knob_grid("full"):
        knobs = {**tuning.DEFAULT_KNOBS, **cand}
        # the final select does not enter the model: one line a geometry
        mkey = (knobs["precision"], knobs["kernel"], knobs["grid_order"],
                knobs["binning"], knobs["tile_n"], knobs["survivors"],
                knobs["bin_w"])
        if mkey in seen:
            continue
        seen.add(mkey)
        try:
            model = roofline.pallas_cost_model(
                n=args.n, d=args.dim, k=args.k, nq=args.nq,
                precision=knobs["precision"], kernel=knobs["kernel"],
                grid_order=knobs["grid_order"], binning=knobs["binning"],
                tile_n=knobs["tile_n"], survivors=knobs["survivors"],
                bin_w=knobs["bin_w"], margin=args.margin,
                device_kind=args.device_kind, nprobe=args.nprobe,
                ncentroids=args.ncentroids, pq_dsub=args.pq_dsub,
                pq_ncodes=args.pq_ncodes)
        except ValueError:
            continue  # a combination the model refuses
        if not model.get("ceiling_qps"):
            continue
        ranked.append({"config": _label(knobs),
                       "ceiling_qps": model["ceiling_qps"],
                       "bound_class": model["bound_class"],
                       "estimated": model["estimated"]})
    ranked.sort(key=lambda r: -r["ceiling_qps"])
    top = ranked[: max(1, int(args.best))]
    payload = {"best": top, "modeled": len(ranked),
               "model_version": roofline.MODEL_VERSION}
    if args.json:
        print(json.dumps(payload, indent=1, sort_keys=True))
        return 0
    est = (" (ESTIMATED generic fallback peaks)"
           if top and top[0]["estimated"] else "")
    print(f"top {len(top)} of {len(ranked)} modeled configs for "
          f"n={args.n} d={args.dim} k={args.k} nq={args.nq} on "
          f"{args.device_kind or 'generic-cpu'}{est}  "
          f"[roofline v{roofline.MODEL_VERSION}]")
    for rank, rec in enumerate(top, 1):
        print(f"  {rank:2d}. {rec['ceiling_qps']:>12,.0f} q/s  "
              f"{rec['bound_class']:<18} {rec['config']}")
    print(json.dumps(payload))
    return 0


def run_roofline(args: argparse.Namespace) -> int:
    """The ``roofline`` subcommand (knn_tpu/cli.py:727-918): the rendering
    (or the raw JSON) and one trailing JSON line."""
    import json

    from knn_tpu_torch.obs import roofline

    if (args.nprobe is None) != (args.ncentroids is None):
        print("--nprobe and --ncentroids must be set together",
              file=sys.stderr)
        return 2
    if args.best is not None:
        return _run_roofline_best(args)
    if args.selector == "pallas":
        model = roofline.pallas_cost_model(
            n=args.n, d=args.dim, k=args.k, nq=args.nq,
            precision=args.precision, kernel=args.kernel,
            grid_order=args.grid_order, binning=args.binning,
            tile_n=args.tile_n, survivors=args.survivors, bin_w=args.bin_w,
            margin=args.margin, device_kind=args.device_kind,
            nprobe=args.nprobe, ncentroids=args.ncentroids,
            pq_dsub=args.pq_dsub, pq_ncodes=args.pq_ncodes)
    else:
        model = roofline.counted_cost_model(
            n=args.n, d=args.dim, k=args.k, nq=args.nq,
            selector=args.selector, dtype=args.dtype, margin=args.margin, device_kind=args.device_kind,
            nprobe=args.nprobe, ncentroids=args.ncentroids)
    block = roofline.attribute(model, args.qps)
    if args.json:
        print(json.dumps(block, indent=1, sort_keys=True))
        return 0
    sys.stdout.write(roofline.render_text(block))
    print(json.dumps({k: block.get(k) for k in (
        "ceiling_qps", "bound_class", "roofline_pct", "estimated",
        "model_version")}))
    return 0


#: the subcommands, by leading token: the job's flat interface stays as it is
SUBCOMMANDS = {"tune": (build_tune_parser, run_tune),
               "join": (build_join_parser, run_join),
               "index": (build_index_parser, run_index),
               "loadgen": (build_loadgen_parser, run_loadgen),
               "metrics": (build_metrics_parser, run_metrics),
               "doctor": (build_doctor_parser, run_doctor),
               "audit": (build_audit_parser, run_audit),
               "waterfall": (build_waterfall_parser, run_waterfall),
               "roofline": (build_roofline_parser, run_roofline)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] and argv[0] in SUBCOMMANDS:
        build, run = SUBCOMMANDS[argv[0]]
        return run(build().parse_args(argv[1:]))
    args = build_parser().parse_args(argv)
    from knn_tpu_torch import obs
    from knn_tpu_torch.pipeline import run_job

    server = None
    if args.obs_log:
        obs.reset_event_log(args.obs_log)
    if args.metrics_port is not None:
        server = obs.start_metrics_server(args.metrics_port)
        port = server.server_address[1]  # resolved when PORT was 0
        print(f"metrics: http://127.0.0.1:{port}/metrics")
    try:
        result = run_job(args_to_config(args))
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    if result.val_accuracy is not None:
        print(f"accuracy = {result.val_accuracy}")  # knn_mpi.cpp:348
    print(f"Running time is {result.total_time} second")  # knn_mpi.cpp:398
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(result.metrics_json())
    if args.metrics_snapshot:
        obs.write_json_snapshot(args.metrics_snapshot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
