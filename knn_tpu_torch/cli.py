"""Command line for the reference job on one GPU — the job path of
knn_tpu/cli.py (``main``), as ``python -m knn_tpu_torch.cli``::

    python -m knn_tpu_torch.cli --train train.csv --test test.csv \\
        --val val.csv --k 50 --mode certified --selector pallas \\
        --out Test_label.csv

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it exits with an error.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from knn_tpu_torch.ops.metrics import PORTED_METRICS
from knn_tpu_torch.utils.config import CERTIFIED_PRECISIONS, SELECTORS, JobConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch",
        description="brute-force KNN classifier on one GPU (PyTorch/CUDA)")
    p.add_argument("--train", required=True, help="labeled train CSV (label,f0,f1,...)")
    p.add_argument("--test", required=True, help="unlabeled test CSV (f0,f1,...)")
    p.add_argument("--val", default=None, help="labeled validation CSV; enables accuracy scoring")
    p.add_argument("--out", default="Test_label.csv", help="predicted-label output path")
    p.add_argument("--k", type=int, default=50, help="neighbor count (ref K, knn_mpi.cpp:109)")
    p.add_argument("--metric", default="l2", choices=sorted(PORTED_METRICS))
    p.add_argument("--dim", type=int, default=None, help="expected feature dim (validated)")
    p.add_argument("--num-classes", type=int, default=None, help="label count (inferred if omitted)")
    p.add_argument("--no-normalize", action="store_true", help="skip min-max normalization (ref Normalize=false)")
    p.add_argument("--train-tile", type=int, default=None, help="db rows per distance tile in the exact path")
    p.add_argument("--batch-size", type=int, default=None, help="queries per step")
    p.add_argument(
        "--mode", default="exact", choices=("exact", "certified"),
        help="certified = the one-pass coarse kernel + exclusion-bound "
        "certificate + float64 repair (exact results)")
    p.add_argument("--selector", default="pallas", choices=SELECTORS,
                   help="coarse selector for --mode certified")
    p.add_argument("--pallas-precision", default=None,
                   choices=CERTIFIED_PRECISIONS,
                   help="coarse-kernel matmul precision (default bf16x3, the "
                   "one the port runs so far)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path on the CPU)")
    p.add_argument("--metrics-json", default=None, help="write structured run metrics to this path")
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
        device=args.device,
        train_tile=args.train_tile,
        batch_size=args.batch_size,
        mode=args.mode,
        selector=args.selector,
        pallas_precision=args.pallas_precision,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from knn_tpu_torch.pipeline import run_job

    result = run_job(args_to_config(args))
    if result.val_accuracy is not None:
        print(f"accuracy = {result.val_accuracy}")  # knn_mpi.cpp:348
    print(f"Running time is {result.total_time} second")  # knn_mpi.cpp:398
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(result.metrics_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
