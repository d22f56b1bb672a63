"""Synthetic dataset generators for tests and benchmarks — a numpy-only
copy of knn_tpu/data/datasets.py (make_blobs, make_mnist_like, ...).

The reference ships no data and no generators — its workload is MNIST CSVs
prepared out of band (report PDF p.11 §3.3.2).  These generators produce
(a) Gaussian-blob classification sets with a controllable difficulty, used
as stand-ins for MNIST in tests/CLI fixtures, and (b) uniform/clustered
float vectors at SIFT1M-like shapes for the benchmark harness.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from knn_tpu_torch.data.csv_io import write_labels


def make_blobs(
    n_samples: int,
    dim: int,
    num_classes: int,
    *,
    cluster_std: float = 1.0,
    center_spread: float = 5.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(features [N, dim] float32, labels [N] int32): isotropic Gaussian
    clusters, one per class, classes cycling so every class is populated."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=center_spread, size=(num_classes, dim))
    labels = (np.arange(n_samples) % num_classes).astype(np.int32)
    rng.shuffle(labels)
    feats = centers[labels] + rng.normal(scale=cluster_std, size=(n_samples, dim))
    return feats.astype(np.float32), labels


def make_mnist_like(
    n_train: int = 60_000,
    n_test: int = 10_000,
    n_val: int = 10_000,
    *,
    dim: int = 784,
    num_classes: int = 10,
    prototypes_per_class: int = 12,
    noise: float = 150.0,
    seed: int = 0,
):
    """MNIST-shaped surrogate at the reference's oracle scale (knn_mpi.cpp
    defaults :108-119: 60000x784 train / 10000 test / 10000 val, 10 integer
    classes, pixel-valued features in [0, 255]).

    Digit-like structure: each class mixes ``prototypes_per_class``
    prototypes built from a shared "stroke" dictionary, with neighbouring
    classes sharing strokes (the 4-vs-9 / 3-vs-8 confusability that gives
    MNIST its KNN error floor).  ``noise`` is calibrated so K=50 L2
    normalized KNN lands in the reference's published accuracy band
    (95.39% = 4.61% error, report PDF p.12 §4.2.1): noise 120 -> ~97%,
    150 -> ~95%, 200 -> ~88% on held-out data.

    Returns ``(train, train_labels, test, test_labels, val, val_labels)``,
    features float32 [*, dim] in [0, 255], labels int32.
    """
    rng = np.random.default_rng(seed)
    n_strokes = 24
    strokes = np.zeros((n_strokes, dim), np.float32)
    # stroke-width bounds scale down with dim so small dims stay valid
    w_lo = min(30, max(2, dim // 4))
    w_hi = max(w_lo + 1, min(120, dim))
    for s in range(n_strokes):
        w = int(rng.integers(w_lo, w_hi))
        lo = int(rng.integers(0, dim - w))
        strokes[s, lo : lo + w] = np.sin(np.linspace(0, np.pi, w)) * rng.uniform(120, 255)
    protos = np.zeros((num_classes, prototypes_per_class, dim), np.float32)
    for c in range(num_classes):
        base = [(2 * c + j) % n_strokes for j in range(4)]  # overlaps c±1
        for p in range(prototypes_per_class):
            extra = rng.choice(n_strokes, size=2, replace=False)
            w = rng.uniform(0.4, 1.0, size=6)[:, None]
            protos[c, p] = np.clip(
                (strokes[np.array(base + list(extra))] * w).sum(0), 0, 255
            )

    def draw(n):
        labels = rng.integers(0, num_classes, size=n).astype(np.int32)
        pi = rng.integers(0, prototypes_per_class, size=n)
        feats = protos[labels, pi] + rng.normal(scale=noise, size=(n, dim))
        return np.clip(feats, 0, 255).astype(np.float32), labels

    train, train_labels = draw(n_train)
    test, test_labels = draw(n_test)
    val, val_labels = draw(n_val)
    return train, train_labels, test, test_labels, val, val_labels


def save_labeled_csv(path: str, feats: np.ndarray, labels: np.ndarray) -> None:
    """Write the reference's labeled format: ``label,f0,...`` per row
    (the shape knn_mpi.cpp:154-175 parses)."""
    with open(path, "w") as f:
        for lab, row in zip(labels, feats):
            f.write(str(int(lab)) + "," + ",".join(repr(float(v)) for v in row) + "\n")


def save_unlabeled_csv(path: str, feats: np.ndarray) -> None:
    """Write the reference's unlabeled test format (knn_mpi.cpp:177-197)."""
    with open(path, "w") as f:
        for row in feats:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


__all__ = [
    "make_blobs",
    "make_mnist_like",
    "save_labeled_csv",
    "save_unlabeled_csv",
    "write_labels",
]
