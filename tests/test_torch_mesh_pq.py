"""The pq arm on a mesh with several db shards: ``ops.pq.train_pq(mesh=)``
and ``ShardedKNN(mesh=).search_certified(precision="pq")`` (codebooks
trained once on every row, each db shard's codes its own operand, the
whole database's codebooks and bound constants on every shard, K7's plain
version once a db shard a batch here on the CPU) against the JAX
package's pq on a mesh of the same shape over its 8 virtual CPU devices,
the port's (1, 1) placement and the float64 oracle.

Tolerances.  Training is compared on well-separated rows (no f32 near tie
in any k=1 assign), so codebooks and codes are bitwise the JAX package's
and the (1, 1) training's.  Certified indices are exact: bitwise the JAX
package's on the same mesh and the oracle's.  On rows whose subspaces
take codebook values exactly (``_lattice``) every residual is 0 and the
certificate passes its queries; on uniform rows every query falls back
(the repair is exact too).
"""

import numpy as np
import pytest
import torch

from knn_tpu.ops import pq as jpq
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.convert import pq_from_numpy
from knn_tpu_torch.ops import pq as ppq
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from tiers_mesh_common import DIM, jax_mesh_of, one_device, port_mesh

K = 5


def _oracle(db, q, k=K):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _separated(seed, n=600, dim=8, centers=40):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim)) * 40.0
    return (c[rng.integers(0, centers, size=n)]
            + rng.normal(size=(n, dim))).astype(np.float32)


def _lattice(seed, n=300, values=12, dsub=4):
    """Rows whose every subspace is one of ``values`` fixed vectors: with
    at least that many codes each is a codeword, so every residual is 0."""
    rng = np.random.default_rng(seed)
    m = DIM // dsub
    books = (rng.normal(size=(m, values, dsub)) * 5).astype(np.float32)
    codes = rng.integers(0, values, size=(n, m))
    db = np.concatenate([books[s][codes[:, s]] for s in range(m)], axis=1)
    q = (rng.normal(size=(13, DIM)) * 5).astype(np.float32)
    return db.astype(np.float32), q


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (2, 2, 2)])
def test_train_pq_on_a_mesh_matches_jax_and_one_device(shape):
    rows = _separated(shape[0])
    ours = ppq.train_pq(rows, mesh=port_mesh(shape), dsub=4, ncodes=16,
                        iters=3, seed=1)
    theirs = jpq.train_pq(rows, mesh=jax_mesh_of(shape), dsub=4, ncodes=16,
                          iters=3, seed=1)
    one = ppq.train_pq(rows, device="cpu", dsub=4, ncodes=16, iters=3,
                       seed=1)
    for res in (theirs, one):
        np.testing.assert_array_equal(ours.codebooks, res.codebooks)
        np.testing.assert_array_equal(ours.codes, res.codes)
        np.testing.assert_array_equal(ours.stats["r_sub"],
                                      res.stats["r_sub"])
    np.testing.assert_array_equal(
        ppq.encode_pq(rows, ours.codebooks, mesh=port_mesh(shape), dsub=4),
        ours.codes)
    with pytest.raises(ValueError, match="not both"):
        ppq.train_pq(rows, mesh=port_mesh(shape), device="cpu")


CONFIGS = [("tiled", "query_major"), ("tiled", "db_major"),
           ("streaming", "query_major")]


@pytest.mark.parametrize("kernel,grid", CONFIGS)
def test_pq_certified_on_a_mesh_matches_jax_and_oracle(kernel, grid):
    db, q = _lattice(2)
    od, oi = _oracle(db, q)
    shape = (2, 4)
    knn = ShardedKNN(db, mesh=port_mesh(shape), k=K)
    d, i, st = knn.search_certified(q, precision="pq", kernel=kernel,
                                    grid_order=grid, margin=8)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(d, od, rtol=5e-5)
    assert st["certified"] > q.shape[0] // 2
    assert st["pallas_knobs"]["precision"] == "pq"
    jknn = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=K)
    _, ji, _ = jknn.search_certified(q, selector="pallas", precision="pq",
                                     kernel=kernel, grid_order=grid,
                                     margin=8)
    np.testing.assert_array_equal(i, np.asarray(ji))
    # the (1, 1) placement certifies the same queries with the same ids
    one = ShardedKNN(db, k=K, device="cpu")
    _, ri, rst = one.search_certified(q, precision="pq", kernel=kernel,
                                      grid_order=grid, margin=8)
    np.testing.assert_array_equal(i, ri)


def test_pq_on_a_host_mesh_and_uniform_rows_fall_back_exactly():
    rng = np.random.default_rng(4)
    db = (rng.random((299, DIM)) * 10).astype(np.float32)
    q = (rng.random((9, DIM)) * 10).astype(np.float32)
    for shape in ((2, 2, 2), (4, 2)):
        knn = ShardedKNN(db, mesh=port_mesh(shape), k=K)
        _, i, st = knn.search_certified(q, precision="pq", margin=8,
                                        pq_ncodes=32)
        np.testing.assert_array_equal(i, _oracle(db, q)[1])
        assert st["certified"] + st["fallback_queries"] == q.shape[0]


def test_consts_are_the_whole_databases():
    # fewer codes than lattice values: residuals in every shard, the
    # largest of them in one
    db, q = _lattice(6, n=301)
    db[7] += 3.0
    knn = ShardedKNN(db, mesh=port_mesh((1, 4)), k=K)
    knn.search_certified(q, precision="pq", margin=8, pq_ncodes=8)
    top = knn._pq[(4, 8)]
    one = ShardedKNN(db, k=K, device="cpu")
    want = one._pq_placement(4, 8)
    np.testing.assert_array_equal(top["stats"]["r_sub"],
                                  want["stats"]["r_sub"])
    assert top["stats"]["r_sub"].max() > 0
    consts = torch.from_numpy(ppq.bound_consts_pq(want["stats"]))
    subs = knn._distinct_shards()
    assert len(subs) == 4
    per = knn._shard_rows()
    codes = want["codes"].numpy()
    for sub in subs:
        entry = sub._pq[(4, 8)]
        assert torch.equal(entry["consts"], consts)
        np.testing.assert_array_equal(entry["books"].numpy(),
                                      want["books"].numpy())
        lo = sub._row_offset
        block = entry["codes"].numpy()
        assert block.shape == (per, codes.shape[1])
        n_real = sub._n_valid
        np.testing.assert_array_equal(block[:n_real],
                                      codes[lo:lo + n_real])
        assert not block[n_real:].any()  # zero-code pad rows


def test_a_jax_pqresult_carried_across_gives_the_jax_indices():
    db, q = _lattice(8)
    db = db + np.float32(0.25) * np.random.default_rng(1).normal(
        size=db.shape).astype(np.float32)
    shape = (2, 4)
    res = jpq.train_pq(db, mesh=jax_mesh_of(shape), dsub=4, ncodes=256)
    knn = ShardedKNN(db, mesh=port_mesh(shape), k=K)
    entry = pq_from_numpy(knn, res.codebooks, res.codes, res.stats, res.dsub,
                          res.dim, ncodes=256)
    assert entry["train_s"] is None
    d, i, st = knn.search_certified(q, precision="pq", margin=8)
    jd, ji, jst = JaxShardedKNN(db, mesh=jax_mesh_of(shape),
                                k=K).search_certified(
        q, selector="pallas", precision="pq", margin=8)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(i, _oracle(db, q)[1])
    assert st["certified"] > 0
    with pytest.raises(ValueError, match="do not match"):
        pq_from_numpy(knn, res.codebooks, res.codes[:-1], res.stats,
                      res.dsub, res.dim)
    with pytest.raises(ValueError, match="dim rows"):
        pq_from_numpy(ShardedKNN(db[:, :8], mesh=one_device(), k=K),
                      res.codebooks, res.codes, res.stats, res.dsub, res.dim)
