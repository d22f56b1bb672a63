"""CSV readers/writers matching the reference's formats exactly — a
numpy-only copy of knn_tpu/data/csv_io.py.

Reference input contract (knn_mpi.cpp:154-222; report PDF p.11 §3.3.2):
- labeled rows (train/val): ``label,f0,f1,...,f{dim-1}`` — integer label
  first, then ``dim`` float features;
- unlabeled rows (test): ``f0,...,f{dim-1}``;
- output: one predicted integer label per line, ``Test_label.csv``
  (:385-393).

Row counts are discovered from the file, and malformed rows raise.  The
JAX package parses through its native C++ reader when that is built; the
port parses with ``numpy.loadtxt`` (both round each decimal to the
nearest float32, so the arrays are identical).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np


def _parse_rows(path: str, dtype) -> np.ndarray:
    with warnings.catch_warnings():
        # an empty file is reported below as a ValueError, not a warning
        warnings.simplefilter("ignore", UserWarning)
        arr = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    if arr.size == 0:
        raise ValueError(f"{path}: empty CSV")
    return arr.astype(dtype)


def read_labeled_csv(path: str, dim: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(features [N, dim] float32, labels [N] int32) from label-first rows —
    the train/val reader (knn_mpi.cpp:154-175, 198-222).

    ``dim`` is validated if given (the reference trusts it blindly)."""
    arr = _parse_rows(path, np.float32)
    if arr.shape[1] < 2:
        raise ValueError(f"{path}: labeled rows need a label and >=1 feature")
    if dim is not None and arr.shape[1] != dim + 1:
        raise ValueError(f"{path}: expected {dim}+1 columns, found {arr.shape[1]}")
    labels = arr[:, 0]
    if not np.all(labels == np.round(labels)):
        raise ValueError(f"{path}: non-integer labels in first column")
    return np.ascontiguousarray(arr[:, 1:]), labels.astype(np.int32)


def read_unlabeled_csv(path: str, dim: Optional[int] = None) -> np.ndarray:
    """Features [N, dim] float32 from unlabeled rows — the test reader
    (knn_mpi.cpp:177-197)."""
    arr = _parse_rows(path, np.float32)
    if dim is not None and arr.shape[1] != dim:
        raise ValueError(f"{path}: expected {dim} columns, found {arr.shape[1]}")
    return arr


def write_labels(path: str, labels) -> None:
    """One integer label per line — the ``Test_label.csv`` writer
    (knn_mpi.cpp:385-393)."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(str(int(x)) for x in labels))
        f.write("\n")
    os.replace(tmp, path)

