"""The reference job end to end on one GPU — the port of
knn_tpu/pipeline.py (``run_job``; the backends ``_run_jax``, here
``_run_torch``, and ``_run_native``).

Reference flow (knn_mpi.cpp:86-399): read CSVs -> transductive min-max
normalize (joint extrema over train ∪ test ∪ val, reduced on the device,
rescale on host) -> place the database once -> classify val and test in
batches (exact, or certified-exact through the one-pass certificate) ->
score val -> write ``Test_label.csv``; every phase timed with a CUDA
synchronization at its boundaries.  ``backend="native"`` runs the C++ CPU
backend (knn_tpu_torch.native) instead: extrema, rescale and classify on
the host with ``num_threads`` threads, no device; a library that does not
build raises with the compiler's output.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from knn_tpu_torch.data.csv_io import read_labeled_csv, read_unlabeled_csv, write_labels
from knn_tpu_torch.device import resolve_device
from knn_tpu_torch.ops.normalize import minmax_stats, np_minmax_apply
from knn_tpu_torch.utils.config import JobConfig
from knn_tpu_torch.utils.timing import PhaseTimer


@dataclass
class JobResult:
    """Everything the reference prints or writes, plus structured metrics."""

    test_labels: np.ndarray
    val_labels: Optional[np.ndarray]
    val_accuracy: Optional[float]
    phase_times: Dict[str, float]
    total_time: float
    n_train: int
    n_test: int
    n_val: int
    config: JobConfig
    #: certified mode only: summed certificate stats over the batches
    certified_stats: Optional[dict] = None
    #: ``serve_buckets`` only: the engine's per-bucket capture (compile)
    #: and dispatch counts and latency percentiles, with ``max_wait_ms``
    serving_stats: Optional[dict] = None

    @property
    def queries_per_sec(self) -> float:
        n = self.n_test + self.n_val
        return n / self.total_time if self.total_time > 0 else float("inf")

    def metrics(self) -> dict:
        out = {
            "val_accuracy": self.val_accuracy,
            "queries_per_sec": self.queries_per_sec,
            "total_time_s": self.total_time,
            "phase_times_s": self.phase_times,
            "n_train": self.n_train,
            "n_test": self.n_test,
            "n_val": self.n_val,
            "config": dataclasses.asdict(self.config),
        }
        if self.certified_stats is not None:
            out["certified_stats"] = self.certified_stats
        if self.serving_stats is not None:
            out["serving"] = self.serving_stats
        # the process-wide telemetry view (knn_tpu_torch.obs) and one SLO
        # evaluation over it: absent with obs off, so that shape is the
        # pre-obs one
        from knn_tpu_torch import obs

        if obs.enabled():
            out["obs"] = obs.compact_snapshot()
            out["slo"] = obs.slo_report()
        return out

    def metrics_json(self) -> str:
        return json.dumps(self.metrics(), indent=2)


def _infer_num_classes(cfg: JobConfig, *label_arrays) -> int:
    if cfg.num_classes is not None:
        return cfg.num_classes
    hi = 0
    for a in label_arrays:
        if a is not None and a.size:
            hi = max(hi, int(a.max()))
    return hi + 1


def _accuracy(pred: np.ndarray, real: np.ndarray) -> float:
    """``acc_calc`` (knn_mpi.cpp:69-84)."""
    return float(np.mean(pred == real))


def _run_torch(cfg: JobConfig, timer: PhaseTimer, device, train, train_labels,
               test, val, val_labels_real):
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    if cfg.normalize:
        with timer.phase("normalize"):
            # joint extrema on the device (the reference's Allreduce
            # pair); the rescale runs on host
            present = [torch.from_numpy(a).to(device)
                       for a in (train, test, val) if a is not None]
            lo, hi = (x.cpu().numpy() for x in minmax_stats(present))
            train = np_minmax_apply(train, lo, hi)
            test = np_minmax_apply(test, lo, hi)
            if val is not None:
                val = np_minmax_apply(val, lo, hi)

    num_classes = _infer_num_classes(cfg, train_labels, val_labels_real)
    with timer.phase("distribute"):
        program = ShardedKNN(train, k=cfg.k, metric=cfg.metric,
                             train_tile=cfg.train_tile,
                             compute_dtype=cfg.compute_dtype,
                             labels=train_labels, num_classes=num_classes,
                             device=device)

    certified_stats = {"fallback_queries": 0, "certified": 0}

    engine = None
    if cfg.serve_buckets is not None:
        # shape-bucketed serving: every chunk rides one of the ladder's
        # executables, all built at warmup (on the card, CUDA graphs)
        from knn_tpu_torch.serving.buckets import parse_buckets
        from knn_tpu_torch.serving.engine import ServingEngine

        with timer.phase("serving_warmup"):
            engine = ServingEngine(program,
                                   buckets=parse_buckets(cfg.serve_buckets))
            engine.warmup(ops=("predict",))

    def classify(queries):
        n = queries.shape[0]
        bs = cfg.batch_size or n
        out = []
        for start in range(0, n, bs):
            chunk = queries[start : start + bs]
            if cfg.mode == "certified":
                labels_out, stats = program.predict_certified(
                    chunk, selector=cfg.selector, tune_cache=cfg.tune_cache,
                    precision=cfg.pallas_precision)
                for key, v in stats.items():
                    if isinstance(v, (int, np.integer)):
                        certified_stats[key] = certified_stats.get(key, 0) + v
                    else:  # the resolved knob set: kept as-is
                        certified_stats[key] = v
                out.append(labels_out)
            elif engine is not None:
                # the engine pads the (possibly short tail) chunk itself
                out.append(engine.predict(chunk))
            else:
                out.append(program.predict(chunk).cpu().numpy())
        return np.concatenate(out)

    val_pred = None
    if val is not None:
        with timer.phase("knn_val"):
            val_pred = classify(val)
    with timer.phase("knn_test"):
        test_pred = classify(test)
    serving_stats = None
    if engine is not None:
        serving_stats = {"max_wait_ms": cfg.max_wait_ms, **engine.stats()}
    return test_pred, val_pred, (
        certified_stats if cfg.mode == "certified" else None), serving_stats


def _run_native(cfg: JobConfig, timer: PhaseTimer, train, train_labels,
                test, val, val_labels_real):
    from knn_tpu_torch import native

    native.load()  # a failed build raises here with the compiler's output
    num_classes = _infer_num_classes(cfg, train_labels, val_labels_real)
    arrays = [a for a in (train, test, val) if a is not None]
    if cfg.normalize:
        with timer.phase("normalize"):
            lo, hi = native.minmax_stats(arrays)
            train = native.minmax_apply(train, lo, hi)
            test = native.minmax_apply(test, lo, hi)
            if val is not None:
                val = native.minmax_apply(val, lo, hi)
    val_pred = None
    if val is not None:
        with timer.phase("knn_val"):
            val_pred = native.knn_predict(
                train, train_labels, val, k=cfg.k, num_classes=num_classes,
                metric=cfg.metric, num_threads=cfg.num_threads)
    with timer.phase("knn_test"):
        test_pred = native.knn_predict(
            train, train_labels, test, k=cfg.k, num_classes=num_classes,
            metric=cfg.metric, num_threads=cfg.num_threads)
    return test_pred, val_pred


def run_job(cfg: JobConfig) -> JobResult:
    """Run the full reference job under ``cfg`` on ``cfg.device`` (None =
    cuda; the native backend runs on the host); returns what the
    reference prints/writes plus per-phase times."""
    device = None if cfg.backend == "native" else resolve_device(cfg.device)
    timer = PhaseTimer(device)
    with timer.phase("ingest"):
        train, train_labels = read_labeled_csv(cfg.train_file, cfg.dim)
        test = read_unlabeled_csv(cfg.test_file, cfg.dim or train.shape[1])
        val, val_labels_real = (None, None)
        if cfg.validation:
            val, val_labels_real = read_labeled_csv(cfg.val_file, cfg.dim)
    if cfg.k > train.shape[0]:
        raise ValueError(f"k={cfg.k} > n_train={train.shape[0]}")
    if train_labels.size and train_labels.min() < 0:
        raise ValueError(f"negative train label {int(train_labels.min())}")
    if cfg.num_classes is not None and train_labels.size and (
            train_labels.max() >= cfg.num_classes):
        raise ValueError(
            f"train label {int(train_labels.max())} outside [0, {cfg.num_classes})")

    if cfg.backend == "native":
        test_pred, val_pred = _run_native(
            cfg, timer, train, train_labels, test, val, val_labels_real)
        certified_stats = serving_stats = None
    else:
        test_pred, val_pred, certified_stats, serving_stats = _run_torch(
            cfg, timer, device, train, train_labels, test, val,
            val_labels_real)

    val_acc = None
    if val_pred is not None:
        val_acc = _accuracy(val_pred, val_labels_real)
    with timer.phase("output"):
        write_labels(cfg.output_file, test_pred)

    return JobResult(
        test_labels=np.asarray(test_pred),
        val_labels=None if val_pred is None else np.asarray(val_pred),
        val_accuracy=val_acc,
        phase_times=timer.phases,
        total_time=timer.total,
        n_train=train.shape[0],
        n_test=test.shape[0],
        n_val=0 if val is None else val.shape[0],
        config=cfg,
        certified_stats=certified_stats,
        serving_stats=serving_stats,
    )
