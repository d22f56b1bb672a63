"""Readers and writers of the TexMex .fvecs / .ivecs / .bvecs formats of the
SIFT1M / GIST1M ANN benchmarks — a numpy-only copy of knn_tpu/data/vecs.py.

Format: each vector is ``int32 dim`` followed by ``dim`` components
(float32 / int32 / uint8).
"""

from __future__ import annotations

import numpy as np


def _read_vecs(path: str, dtype, component_bytes: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        raise ValueError(f"{path}: empty vecs file")
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    if dim <= 0:
        raise ValueError(f"{path}: bad leading dim {dim}")
    row_bytes = 4 + dim * component_bytes
    if raw.size % row_bytes:
        raise ValueError(f"{path}: size {raw.size} not a multiple of row size {row_bytes}")
    n = raw.size // row_bytes
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view(np.int32).ravel()
    if not np.all(dims == dim):
        raise ValueError(f"{path}: inconsistent per-row dims")
    return rows[:, 4:].copy().view(dtype).reshape(n, dim)


def read_fvecs(path: str) -> np.ndarray:
    """[N, dim] float32 (SIFT1M base / query files)."""
    return _read_vecs(path, np.float32, 4)


def read_ivecs(path: str) -> np.ndarray:
    """[N, dim] int32 (ground-truth neighbor-index files)."""
    return _read_vecs(path, np.int32, 4)


def read_bvecs(path: str) -> np.ndarray:
    """[N, dim] uint8 (SIFT1B-style byte vectors)."""
    return _read_vecs(path, np.uint8, 1)


def read_bvecs_quantized(path: str):
    """A bvecs payload as the int8 arm's rows (ops.quantize.QuantizedRows):
    the bytes shifted by the L2-invariant -128 land exactly in int8 at unit
    scale, residuals zero.  ``ShardedKNN`` built from the raw
    :func:`read_bvecs` uint8 array takes the same shortcut at placement."""
    from knn_tpu_torch.ops.quantize import from_uint8

    return from_uint8(read_bvecs(path))


def _write_vecs(path: str, x: np.ndarray, dtype) -> None:
    x = np.ascontiguousarray(x, dtype=dtype)
    n, dim = x.shape
    dims = np.full((n, 1), dim, dtype=np.int32)
    out = np.concatenate([dims.view(np.uint8).reshape(n, 4),
                          x.view(np.uint8).reshape(n, -1)], axis=1)
    out.tofile(path)


def write_fvecs(path: str, x) -> None:
    _write_vecs(path, np.asarray(x), np.float32)


def write_ivecs(path: str, x) -> None:
    _write_vecs(path, np.asarray(x), np.int32)
