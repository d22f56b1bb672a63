"""The port's TexMex vecs readers / writers (``knn_tpu_torch.data.vecs``)
and ``make_database`` against the JAX package's: round trips, the same
arrays from the same files, the same refusals, bitwise generators."""

import numpy as np
import pytest

from knn_tpu.data import datasets as jdata
from knn_tpu.data import vecs as jvecs
from knn_tpu_torch import make_database
from knn_tpu_torch.data import vecs as pvecs


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(37, 13)).astype(np.float32),
            rng.integers(-2 ** 31, 2 ** 31 - 1, size=(37, 5)).astype(np.int32),
            rng.integers(0, 256, size=(37, 9)).astype(np.uint8))


def _write_bvecs(path, x):
    n, dim = x.shape
    rows = np.concatenate([np.full((n, 1), dim, np.int32).view(np.uint8),
                           x], axis=1)
    rows.tofile(path)


def test_fvecs_ivecs_round_trip_and_equal_the_reference(tmp_path):
    f, i, _ = _arrays()
    pvecs.write_fvecs(str(tmp_path / "a.fvecs"), f)
    pvecs.write_ivecs(str(tmp_path / "a.ivecs"), i)
    jvecs.write_fvecs(str(tmp_path / "j.fvecs"), f)
    jvecs.write_ivecs(str(tmp_path / "j.ivecs"), i)
    for ext in ("fvecs", "ivecs"):
        assert (tmp_path / f"a.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    got = pvecs.read_fvecs(str(tmp_path / "a.fvecs"))
    assert got.dtype == np.float32 and got.tobytes() == f.tobytes()
    np.testing.assert_array_equal(
        got, jvecs.read_fvecs(str(tmp_path / "a.fvecs")))
    got = pvecs.read_ivecs(str(tmp_path / "a.ivecs"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, i)
    np.testing.assert_array_equal(
        got, jvecs.read_ivecs(str(tmp_path / "a.ivecs")))


def test_bvecs_and_quantized_bvecs_equal_the_reference(tmp_path):
    _, _, b = _arrays(1)
    path = str(tmp_path / "a.bvecs")
    _write_bvecs(path, b)
    got = pvecs.read_bvecs(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, b)
    np.testing.assert_array_equal(got, jvecs.read_bvecs(path))
    qr, jqr = pvecs.read_bvecs_quantized(path), jvecs.read_bvecs_quantized(path)
    assert qr.values.dtype == np.int8 and qr.offset == jqr.offset == 128.0
    np.testing.assert_array_equal(qr.values, np.asarray(jqr.values))
    np.testing.assert_array_equal(qr.scales, np.asarray(jqr.scales))
    np.testing.assert_array_equal(qr.values.astype(np.int16) + 128, b)


@pytest.mark.parametrize("case", ["empty", "bad_dim", "ragged", "mixed_dims"])
def test_malformed_files_are_refused_as_the_reference_refuses(tmp_path, case):
    path = str(tmp_path / "bad.fvecs")
    if case == "empty":
        open(path, "wb").close()
    elif case == "bad_dim":
        np.array([0, 0], np.int32).tofile(path)
    elif case == "ragged":
        np.concatenate([np.array([2], np.int32).view(np.uint8),
                        np.zeros(9, np.uint8)]).tofile(path)
    else:
        np.array([1, 0, 2, 0], np.int32).tofile(path)
    with pytest.raises(ValueError) as ref:
        jvecs.read_fvecs(path)
    with pytest.raises(ValueError) as got:
        pvecs.read_fvecs(path)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("n,dim,seed,scale", [(100, 16, 0, 128.0),
                                              (1000, 7, 3, 1.0)])
def test_make_database_is_bitwise_the_reference(n, dim, seed, scale):
    got = make_database(n, dim, seed=seed, scale=scale)
    want = jdata.make_database(n, dim, seed=seed, scale=scale)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
