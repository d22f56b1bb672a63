"""The port's CUDA kernels on the card, each against its plain PyTorch
version — tests marked ``cuda``, skipped without a GPU.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The comparison helpers here are shared with tests/test_torch_coarse_knn.py:
f32 scores agree within 64 eps_f32 (||q||^2 + max||t||^2) per query (the
two sum in different orders), ci is equal wherever a bin's values are
separated by more than that, and pad-row scores (~1e35, from PAD_VAL rows)
are compared by class.
"""

import numpy as np
import pytest
import torch

from knn_tpu_torch.ops import coarse_knn as ck

EPS32 = float(np.finfo(np.float32).eps)
PAD_SCALE = 1e30


def _data(rng, n_q, n, dim, scale=10.0):
    q = (rng.normal(size=(n_q, dim)) * scale).astype(np.float32)
    db = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
    return q, db


def _tol(q, db):
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    return 64 * EPS32 * ((q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max())


def _assert_scores(port, ref, tol):
    pad_p, pad_r = port >= PAD_SCALE, ref >= PAD_SCALE
    np.testing.assert_array_equal(pad_p, pad_r)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    real = ~pad_r & np.isfinite(ref)
    err = np.zeros(ref.shape)
    err[real] = np.abs(port[real] - ref[real])
    assert (err <= tol[:, None]).all(), float(err.max())


def _assert_ci_separated(cd, ci_p, ci_r, bounds, tol):
    survivors = ck.SURVIVORS
    n_q = cd.shape[0]
    seq = np.concatenate([cd.reshape(n_q, -1, survivors, 128),
                          bounds.reshape(n_q, -1, 1, 128)], axis=2)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(seq, axis=2))
    t = tol[:, None, None, None]
    sep = gap[:, :, :survivors] > t
    sep[:, :, 1:] &= gap[:, :, : survivors - 1] > t
    sep &= np.isfinite(seq[:, :, :survivors])
    a = ci_p.reshape(sep.shape)
    b = ci_r.reshape(sep.shape)
    assert sep.sum() > 0
    np.testing.assert_array_equal(a[sep], b[sep])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384)])
def test_cuda_kernel_matches_plain(cuda_device, dim, tile_n):
    rng = np.random.default_rng(dim)
    q, db = _data(rng, 37, 3 * tile_n // 2 + 60, dim)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(cuda_device), tile_n)
    qp = ck.pad_queries(torch.from_numpy(q).to(cuda_device))
    before = ck.binned_select.launches
    kern = [a.cpu().numpy() for a in ck.binned_select(qp, th, tl, tnorm,
                                                      tile_n=tile_n)]
    assert ck.binned_select.launches == before + 1
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(
        qp, th, tl, tnorm, tile_n=tile_n)]
    tol = _tol(q, db)
    _assert_scores(kern[0], plain[0], tol)
    _assert_scores(kern[2], plain[2], tol)
    _assert_ci_separated(plain[0], kern[1], plain[1], plain[2], tol)
