"""The two-stage pipeline (``search_certified(overlap=True)``) and
``search_bucketed`` on a mesh with several db shards, and the job's
``serve_buckets`` with ``db_shards=2``, against the port's sequential mesh
path, the JAX package's pipeline on a mesh of the same shape over its 8
virtual CPU devices and the JAX job.

Tolerances.  The pipeline runs the sequential path's kernels and tail, so
its ``(d, i)`` and every stat but ``pipeline`` are bitwise the sequential
call's.  Certified indices are exact: equal to the JAX package's.  A
bucketed batch is bitwise the eager mesh ``search`` of its padded batch;
the job's labels file is byte for byte the JAX job's.
"""

import numpy as np
import pytest

from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from tiers_mesh_common import DIM, jax_mesh_of, port_mesh

K = 5


def _data(seed=0, n=299, n_q=21):
    rng = np.random.default_rng(seed)
    db = (rng.random((n, DIM)) * 10).astype(np.float32)
    q = (rng.random((n_q, DIM)) * 10).astype(np.float32)
    return db, q


def _oracle_ids(db, q, k=K):
    d = oracles.sq_l2(q, db)
    return np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                      axis=-1)[:, :k]


CASES = [(kern, prec) for prec in ("bf16x3", "int8", "pq")
         for kern in ("tiled", "streaming", "fused")
         if (kern, prec) != ("fused", "pq")]


@pytest.fixture(scope="module")
def placed():
    db, q = _data()
    return db, q, ShardedKNN(db, mesh=port_mesh((2, 4)), k=K)


@pytest.mark.parametrize("kernel,precision", CASES)
def test_overlap_bitwise_sequential_on_a_mesh(placed, kernel, precision):
    db, q, knn = placed
    kw = dict(kernel=kernel, precision=precision, margin=8, batch_size=8,
              pq_ncodes=32)
    d, i, st = knn.search_certified(q, **kw)
    od, oi, ost = knn.search_certified(q, overlap=True, overlap_depth=2,
                                       **kw)
    np.testing.assert_array_equal(od, d)
    np.testing.assert_array_equal(oi, i)
    pipe = ost.pop("pipeline")
    assert "pipeline" not in st and ost == st
    assert pipe["batches"] == 3 and pipe["depth"] == 2
    np.testing.assert_array_equal(i, _oracle_ids(db, q))


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_overlap_indices_and_stats_keys_equal_jax(shape):
    db, q = _data(1)
    kw = dict(margin=8, batch_size=8, overlap=True, overlap_depth=2)
    d, i, st = ShardedKNN(db, mesh=port_mesh(shape),
                          k=K).search_certified(q, **kw)
    jd, ji, jst = JaxShardedKNN(db, mesh=jax_mesh_of(shape),
                                k=K).search_certified(q, selector="pallas",
                                                      **kw)
    np.testing.assert_array_equal(i, np.asarray(ji))
    assert set(st["pipeline"]) == set(jst["pipeline"])
    assert st["pipeline"]["batches"] == jst["pipeline"]["batches"] == 3
    assert st["pipeline"]["depth"] == jst["pipeline"]["depth"] == 2


def test_search_bucketed_on_a_mesh_is_the_eager_search(placed):
    db, q, knn = placed
    ladder = (4, 16, 32)
    seen = []
    for n in (1, 3, 9, 21):
        d, i = knn.search_bucketed(q[:n], buckets=ladder)
        rung = next(b for b in ladder if b >= n)
        padded = np.zeros((rung, DIM), np.float32)
        padded[:n] = q[:n]
        rd, ri = knn.search(padded)
        np.testing.assert_array_equal(d, rd.numpy()[:n])
        np.testing.assert_array_equal(i, ri.numpy()[:n])
        seen.append(rung)
    stats = knn.compile_cache_stats()
    assert stats["program_cache"]["size"] == len(set(seen))


def test_run_job_serve_buckets_on_two_db_shards_writes_the_jax_labels(
        tmp_path):
    from knn_tpu.data.datasets import (make_mnist_like, save_labeled_csv,
                                       save_unlabeled_csv)
    from knn_tpu.parallel.mesh import make_mesh
    from knn_tpu.pipeline import run_job as jax_run_job
    from knn_tpu.utils.config import JobConfig as JaxJobConfig
    from knn_tpu_torch import JobConfig, run_job

    tr, trl, te, _, va, val = make_mnist_like(300, 37, 29, dim=16,
                                              num_classes=4, seed=2)
    files = {n: str(tmp_path / f"{n}.csv") for n in ("train", "test", "val")}
    save_labeled_csv(files["train"], tr, trl)
    save_unlabeled_csv(files["test"], te)
    save_labeled_csv(files["val"], va, val)
    common = dict(train_file=files["train"], test_file=files["test"],
                  val_file=files["val"], k=5, serve_buckets="8,32",
                  batch_size=16, db_shards=2)
    jres = jax_run_job(JaxJobConfig(output_file=str(tmp_path / "jax.csv"),
                                    **common), mesh=make_mesh(1, 2))
    res = run_job(JobConfig(output_file=str(tmp_path / "port.csv"),
                            device="cpu", **common))
    np.testing.assert_array_equal(res.test_labels, jres.test_labels)
    assert res.val_accuracy == jres.val_accuracy
    with open(tmp_path / "jax.csv", "rb") as a, \
            open(tmp_path / "port.csv", "rb") as b:
        assert a.read() == b.read()
