"""The host-RAM tier on a mesh (``ShardedKNN(mesh=, hbm_budget_bytes=)``,
``MutableIndex(mesh=, hbm_budget_bytes=)``, the tiered join, ``cli join
--hbm-budget-bytes``) against the JAX package's tier on a mesh of the same
shape over its 8 virtual CPU devices, the port's resident mesh search and
the float64 oracle (``tests/oracles.py``).  The port's meshes are logical
over ``cpu`` (``tests/tiers_mesh_common.py``).

Tolerances.  The tier's f32 distances come from another GEMM shape than
the resident placement's (a segment's block, not the shard's), so they
may differ in the last bits (the JAX package's own
``test_hosttier.py::test_host_tier_on_hierarchical_mesh`` fails on that):
indices equal the oracle's and the JAX tier's wherever the oracle
separates rank k from rank k+1 by more than twice ``64 eps_f32 (||q||^2 +
max||t||^2)``, distances within that bound of the oracle's.  On integer
rows every f32 product and sum is exact in any order, so the tier is
bitwise the port's resident mesh search and the JAX tier.  Plans and
sweep counts are integers: equal.  The tiered join is bitwise the looped
tier search at its block shape.
"""

import json

import numpy as np
import pytest
import torch

from knn_tpu.analysis import hbm as jax_hbm
from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.analysis import hbm
from knn_tpu_torch.index import MutableIndex, MutationUnsupportedError
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from tiers_mesh_common import DIM, SHAPES, _tol, jax_mesh_of, port_mesh

K = 5


def _rows(seed, n, integer):
    rng = np.random.default_rng(seed)
    if integer:
        db = rng.integers(0, 10, size=(n, DIM)).astype(np.float32)
        db[n // 2: n // 2 + 8] = db[:8]  # exact duplicates: ties by index
        q = rng.integers(0, 10, size=(11, DIM)).astype(np.float32)
    else:
        db = (rng.normal(size=(n, DIM)) * 10).astype(np.float32)
        q = (rng.normal(size=(11, DIM)) * 10).astype(np.float32)
    return db, q


def _assert_rule(d, i, q, db, k, ref_i):
    """Indices equal the oracle's and ``ref_i`` where rank k and k+1 are
    separated by more than twice the f32 tolerance; distances within it."""
    d, i = np.asarray(d, np.float64), np.asarray(i)
    od = oracles.sq_l2(q, db)
    pos = np.broadcast_to(np.arange(db.shape[0]), od.shape)
    o = np.lexsort((pos, od), axis=-1)
    odk = np.take_along_axis(od, o[:, : k + 1], -1)
    tol = _tol(q, db)
    sep = (np.diff(odk, axis=-1) > 2 * tol).all(-1)
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(i[sep], o[sep, :k])
    np.testing.assert_array_equal(i[sep], np.asarray(ref_i)[sep])
    assert (np.abs(d - odk[:, :k]) <= tol).all()


# -- the byte model ---------------------------------------------------------------
def test_hbm_functions_equal_jax():
    for n, dim, budget in ((1000, 16, 4000), (301, 129, 20_000),
                           (7, 3, 100), (5000, 8, 900)):
        for itemsize in (1, 2, 4):
            assert hbm.placement_bytes(n, dim, itemsize) == \
                jax_hbm.placement_bytes(n, dim, itemsize)
            for hosts in (1, 2, 3):
                for mult in (1, 2, 4, 8):
                    kw = dict(itemsize=itemsize, hosts=hosts,
                              shard_multiple=mult)
                    assert hbm.rows_for_budget(budget, dim, **kw) == \
                        jax_hbm.rows_for_budget(budget, dim, **kw)
                    try:
                        want = jax_hbm.plan_segments(n, dim, budget, **kw)
                    except ValueError as e:
                        with pytest.raises(ValueError, match="fewer db"):
                            hbm.plan_segments(n, dim, budget, **kw)
                        assert "fewer db shards" in str(e)
                        continue
                    assert hbm.plan_segments(n, dim, budget, **kw) == want
                    assert hbm.n_sweeps(n, dim, budget, **kw) == \
                        jax_hbm.n_sweeps(n, dim, budget, **kw) == len(want)
    # the one-device calls keep their values
    assert hbm.plan_segments(1000, 16, 4000) == jax_hbm.plan_segments(
        1000, 16, 4000)
    assert hbm.placement_bytes(10, 16) == 10 * (16 * 4 + 4)


# -- the tier against the JAX tier, the resident mesh search and the oracle ------
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 2)])
def test_tier_on_a_mesh_matches_jax_resident_and_oracle(shape):
    budget = hbm.placement_bytes(64, DIM)
    hosts = shape[1] if len(shape) == 3 else 1
    shards = int(np.prod(shape[1:]))
    for integer in (True, False):
        db, q = _rows(3, 301, integer)
        tier = ShardedKNN(db, mesh=port_mesh(shape), k=K,
                          hbm_budget_bytes=budget)
        d, i = tier.search(q)
        jt = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=K,
                           hbm_budget_bytes=budget)
        jd, ji = jt.search(q)
        st, jst = tier.hosttier_stats(), jt.hosttier_stats()
        assert st["sweeps"] == jst["sweeps"] == hbm.n_sweeps(
            301, DIM, budget, hosts=hosts, shard_multiple=shards) > 1
        assert st["segment_rows"] == jst["segment_rows"]
        assert st["segment_rows"] % shards == 0
        assert st["last_search"]["sweeps"] == st["sweeps"]
        resident = ShardedKNN(db, mesh=port_mesh(shape), k=K)
        rd, ri = resident.search(q)
        _assert_rule(d, i, q, db, K, ji)
        _assert_rule(d, i, q, db, K, ri)
        if integer:
            assert torch.equal(d, rd) and torch.equal(i, ri)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_tier_plans_at_the_staged_four_bytes():
    """Divergence 65: the port stages every row as f32, so it plans the
    tier at 4 B an element whatever the caller's dtype.  The JAX package
    plans a 16-bit database at its own 2 B (fewer, larger segments); a
    uint8 one it widens to f32 first, as the port does.  The answers are
    the same on integer rows."""
    budget = hbm.placement_bytes(64, DIM)
    rng = np.random.default_rng(9)
    q = rng.integers(0, 100, size=(11, DIM)).astype(np.float32)
    for dtype, jax_itemsize in ((np.float16, 2), (np.uint8, 4)):
        db = rng.integers(0, 100, size=(301, DIM)).astype(dtype)
        tier = ShardedKNN(db, mesh=port_mesh((2, 4)), k=K,
                          hbm_budget_bytes=budget)
        jt = JaxShardedKNN(db, mesh=jax_mesh_of((2, 4)), k=K,
                           hbm_budget_bytes=budget)
        assert tier.hosttier_stats()["sweeps"] == hbm.n_sweeps(
            301, DIM, budget, itemsize=4, shard_multiple=4)
        assert jt.hosttier_stats()["sweeps"] == hbm.n_sweeps(
            301, DIM, budget, itemsize=jax_itemsize, shard_multiple=4)
        d, i = tier.search(q)
        jd, ji = jt.search(q)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert hbm.n_sweeps(301, DIM, budget, itemsize=2, shard_multiple=4) < \
        hbm.n_sweeps(301, DIM, budget, itemsize=4, shard_multiple=4)


def test_tier_cosine_and_k_override_on_a_mesh():
    db, q = _rows(5, 257, False)
    shape = (2, 4)
    budget = hbm.placement_bytes(48, DIM)
    tier = ShardedKNN(db, mesh=port_mesh(shape), k=3, metric="cosine",
                      hbm_budget_bytes=budget)
    jt = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=3, metric="cosine",
                       hbm_budget_bytes=budget)
    d, i = tier.search(q)
    jd, ji = jt.search(q)
    assert tier.hosttier_stats()["sweeps"] == jt.hosttier_stats()["sweeps"]
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    d7, i7 = tier.search(q, k=7)
    jd7, ji7 = jt.search(q, k=7)
    assert i7.shape == (q.shape[0], 7)
    np.testing.assert_array_equal(i7.numpy(), np.asarray(ji7))
    np.testing.assert_array_equal(i7[:, :3].numpy(), i.numpy())
    # a shard of the 48-row segment holds 12 rows on the (2, 4) mesh
    with pytest.raises(ValueError, match="use fewer db shards"):
        tier.search(q, k=13)
    # the resident-only entries refuse the tier by name on the mesh
    for call in (lambda: tier.search_certified(q),
                 lambda: tier.search_bucketed(q),
                 lambda: tier.radius_search(q, 0.5, max_neighbors=3)):
        with pytest.raises(ValueError, match="host-RAM shard tier"):
            call()


# -- MutableIndex -----------------------------------------------------------------
def test_mutable_index_searches_the_tier_and_refuses_writes():
    db, q = _rows(7, 300, True)
    budget = hbm.placement_bytes(96, DIM)
    shape = (4, 2)
    idx = MutableIndex(db, mesh=port_mesh(shape), k=K, reserve=4,
                       hbm_budget_bytes=budget)
    jidx = JaxMutableIndex(db, mesh=jax_mesh_of(shape), k=K, reserve=4,
                           hbm_budget_bytes=budget)
    d, i = idx.search(q)
    jd, ji = jidx.search(q)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ji))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(jd))
    assert idx._main.hosttier_stats()["sweeps"] == \
        jidx._main.hosttier_stats()["sweeps"] > 1
    for write in (lambda x: x.insert(db[:1], [9000]),
                  lambda x: x.delete([3])):
        with pytest.raises(MutationUnsupportedError, match="host-RAM"):
            write(idx)
        with pytest.raises(Exception, match="host-RAM"):
            write(jidx)


# -- the tiered join --------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_tiered_join_both_orders_bitwise_looped_tier_search(shape):
    rng = np.random.default_rng(11)
    db = (rng.random((400, DIM)) * 10).astype(np.float32)
    qa = (rng.random((70, DIM)) * 10).astype(np.float32)
    tier = ShardedKNN(db, mesh=port_mesh(shape), k=K,
                      hbm_budget_bytes=hbm.placement_bytes(96, DIM))
    seen = set()
    for sb in (8, 70):
        d, i, st = knn_join(tier, qa, superblock_rows=sb)
        seen.add(st["order"])
        assert st["db_segments"] == tier.hosttier_stats()["sweeps"]
        assert st["dispatches"] == st["superblocks"] * st["db_segments"]
        pad = -(-qa.shape[0] // sb) * sb
        qp = np.zeros((pad, DIM), np.float32)
        qp[: qa.shape[0]] = qa
        loop = [tier.search(qp[lo:lo + sb]) for lo in range(0, pad, sb)]
        np.testing.assert_array_equal(
            d, np.concatenate([x[0].numpy() for x in loop])[: qa.shape[0]])
        np.testing.assert_array_equal(
            i, np.concatenate([x[1].numpy() for x in loop])[: qa.shape[0]])
    assert seen == {"db_major", "query_major"}


# -- the CLI ----------------------------------------------------------------------
def test_cli_join_hbm_budget_places_on_a_two_device_mesh(monkeypatch, capsys):
    """``join --hbm-budget-bytes`` places the tier on ``make_mesh()`` (two
    CPU devices standing in for two cards here), as the JAX CLI does."""
    from knn_tpu_torch.cli import main
    from knn_tpu_torch.parallel import mesh as pmesh
    from knn_tpu_torch.parallel import sharded

    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    make = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, devices=None, **kw:
                        make(*a, devices=two if devices is None else devices,
                             **kw))
    built = []

    class Recorded(sharded.ShardedKNN):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    monkeypatch.setattr(sharded, "ShardedKNN", Recorded)
    budget = hbm.placement_bytes(500, 8)
    assert main(["join", "--n", "2000", "--rows", "300", "--dim", "8",
                 "--k", "4", "--superblock", "128",
                 "--hbm-budget-bytes", str(budget)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["db_segments"] == 4 and stats["superblocks"] == 3
    (knn,) = built
    assert knn.mesh.size == 2 and knn._host_tier is not None
    assert knn.hosttier_stats()["sweeps"] == 4
