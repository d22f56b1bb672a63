"""CSV readers/writers matching the reference's formats exactly — a
numpy-only copy of knn_tpu/data/csv_io.py.

Reference input contract (knn_mpi.cpp:154-222; report PDF p.11 §3.3.2):
- labeled rows (train/val): ``label,f0,f1,...,f{dim-1}`` — integer label
  first, then ``dim`` float features;
- unlabeled rows (test): ``f0,...,f{dim-1}``;
- output: one predicted integer label per line, ``Test_label.csv``
  (:385-393).

Row counts are discovered from the file, and malformed rows raise.  Like
the JAX package, the readers parse through the native C++ reader
(knn_tpu_torch.native) when its library builds; otherwise a Python reader
with the same refusals and messages (``ragged rows``, ``parse error`` for
an empty field such as a trailing comma, ``empty file``) and the same
values: each decimal rounds once to the nearest float32, as ``strtof``
does (a float64 parse rounded again to float32 differs on decimals next
to a float32 midpoint).
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np


def _f32_of_decimals(tokens, values: np.ndarray) -> np.ndarray:
    """float32 of the decimal strings ``tokens`` (their float64 parses in
    ``values``), each rounded once to the nearest float32.  The float64 to
    float32 cast rounds a second time; it differs from one rounding only
    where the float64 value is a float32 midpoint, which is settled on the
    decimal's exact value."""
    out = values.astype(np.float32)
    back = out.astype(np.float64)
    other = np.nextafter(out, np.where(values > back, np.inf, -np.inf)
                         .astype(np.float32)).astype(np.float64)
    tie = (values != back) & np.isfinite(other) & \
        (values == (back + other) / 2)
    for j in np.flatnonzero(tie):
        exact = Fraction(tokens[j].strip())
        mid = Fraction(float(values[j]))
        if exact != mid:  # off the midpoint: the side the decimal lies on
            lo, hi = sorted((float(back[j]), float(other[j])))
            out[j] = np.float32(hi if exact > mid else lo)
    return out


def _parse_rows_python(path: str) -> np.ndarray:
    """The native reader's contract in Python: comma-separated floats, one
    row per line, blank lines skipped, uniform width."""
    tokens, width = [], None
    try:
        with open(path, "r", newline="") as f:
            lines = f.read().split("\n")
    except OSError as e:
        raise ValueError(f"{path}: I/O error") from e
    for line in lines:
        if not line.strip(" \t\r"):
            continue
        fields = line.split(",")
        if width is None:
            width = len(fields)
        elif len(fields) != width:
            raise ValueError(f"{path}: ragged rows")
        tokens.extend(fields)
    if not tokens:
        raise ValueError(f"{path}: empty file")
    try:
        values = np.array([float(t) for t in tokens], dtype=np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: parse error") from e
    return _f32_of_decimals(tokens, values).reshape(-1, width)


def _parse_rows(path: str, dtype) -> np.ndarray:
    from knn_tpu_torch import native

    if native.available():
        return native.read_csv(path).astype(dtype, copy=False)
    return _parse_rows_python(path).astype(dtype, copy=False)


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



def read_labels(path: str) -> np.ndarray:
    """Read a one-label-per-line file back (for parity tests against the
    reference's output)."""
    with open(path, "r") as f:
        return np.asarray([int(line) for line in f if line.strip()], dtype=np.int32)
