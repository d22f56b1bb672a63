"""The port's host-RAM tier (``ShardedKNN(hbm_budget_bytes=)``,
knn_tpu_torch.analysis.hbm) against the JAX package's single-device host
tier (knn_tpu.parallel.ShardedKNN on make_mesh(1, 1)) and a float64
oracle: the reference's tests/test_hosttier.py cases at its shapes (dim
16, corpora of 64-400 rows, budgets of 40-127 rows).

Tolerances: on integer-valued rows every f32 product and sum is exact in
any order, so the tier's ``(d, i)`` are BITWISE the JAX host tier's, the
port's resident search and the oracle's indices.  On real-valued rows
(cosine, dot) the segment's query blocks differ from the resident ones
and the CPU GEMM's rounding with them: indices equal the resident
search's wherever its adjacent values are separated by more than 64
eps_f32 (||q||^2 + max||t||^2) (cosine: 64 eps_f32 x 2, unit rows), values
within that bound.  Plans, sweep counts and stats keys are integers and
names: equal.  (The reference's meshed cases fail in the JAX package
itself; the port has one card, so its mesh case is the oracle case.)
"""

import numpy as np
import pytest
import torch

from knn_tpu.analysis import hbm as jax_hbm
from knn_tpu.parallel import ShardedKNN as JaxShardedKNN
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import ShardedKNN, obs
from knn_tpu_torch.analysis import hbm
from knn_tpu_torch.convert import placement_from_numpy
from knn_tpu_torch.index import MutableIndex, MutationUnsupportedError
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.serving import ServingEngine

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

DIM = 16
EPS32 = float(np.finfo(np.float32).eps)


def _budget_for_rows(rows: int, dim: int = DIM) -> int:
    """The budget that holds exactly ``rows`` placed rows."""
    return hbm.placement_bytes(rows, dim)


def _int_rows(rng, n, dim=DIM):
    """Integer-valued rows with exact duplicates: every f32 product exact,
    ties broken by index on both sides."""
    x = rng.integers(0, 10, size=(n, dim)).astype(np.float32)
    if n >= 16:
        x[n // 2: n // 2 + 8] = x[:8]
    return x


def _oracle(db, q, k):
    d = ((db.astype(np.float64)[None] - q.astype(np.float64)[:, None])
         ** 2).sum(-1)
    pos = np.broadcast_to(np.arange(db.shape[0]), d.shape)
    o = np.lexsort((pos, d), axis=-1)[:, :k]
    return np.take_along_axis(d, o, -1), o


def _np(t):
    return tuple(x.cpu().numpy() for x in t)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, 1)


def test_corpus_exactly_at_budget_stays_resident(mesh):
    db = _int_rows(np.random.default_rng(0), 128)
    prog = ShardedKNN(db, k=5, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(128))
    assert prog.hosttier_stats() is None and prog.placement is not None
    jprog = JaxShardedKNN(db, mesh=mesh, k=5,
                          hbm_budget_bytes=_budget_for_rows(128))
    assert jprog.hosttier_stats() is None


def test_one_row_over_budget_streams_two_sweeps(mesh):
    rng = np.random.default_rng(1)
    db, q = _int_rows(rng, 128), _int_rows(rng, 9)
    ref_d, ref_i = _np(ShardedKNN(db, k=5, device="cpu").search(q))
    prog = ShardedKNN(db, k=5, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(127))
    st = prog.hosttier_stats()
    assert st is not None and st["sweeps"] == 2 and prog.placement is None
    d, i = _np(prog.search(q))
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(d, ref_d)
    jd, ji = JaxShardedKNN(db, mesh=mesh, k=5,
                           hbm_budget_bytes=_budget_for_rows(127)).search(q)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(d, np.asarray(jd))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_many_times_over_budget_matches_byte_model_and_is_bitwise(mesh,
                                                                  depth):
    """Many times over the budget: the sweeps run, counted and planned
    equal hbm.n_sweeps and the JAX tier's, one dispatch shape serves every
    sweep (the ragged tail included), and the result is bitwise the JAX
    host tier's, the resident search's and the oracle's indices, whatever
    the depth."""
    rng = np.random.default_rng(2)
    db, q = _int_rows(rng, 400), _int_rows(rng, 17)
    budget = _budget_for_rows(64)
    expect = hbm.n_sweeps(400, DIM, budget)
    assert expect == jax_hbm.n_sweeps(400, DIM, budget) == 7
    prog = ShardedKNN(db, k=7, device="cpu", hbm_budget_bytes=budget,
                      hosttier_depth=depth)
    jprog = JaxShardedKNN(db, mesh=mesh, k=7, hbm_budget_bytes=budget)
    assert prog.hosttier_stats()["sweeps"] == expect
    assert prog.hosttier_stats()["depth"] == depth
    before = obs.counter(mn.HOSTTIER_SWEEPS).get()
    d, i = _np(prog.search(q))
    assert obs.counter(mn.HOSTTIER_SWEEPS).get() - before == expect
    jd, ji = jprog.search(q)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(d, np.asarray(jd))
    ref_d, ref_i = _np(ShardedKNN(db, k=7, device="cpu").search(q))
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(d, ref_d)
    od, oi = _oracle(db, q, 7)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(d, od)
    last = prog.hosttier_stats()["last_search"]
    jlast = jprog.hosttier_stats()["last_search"]
    assert last["sweeps"] == jlast["sweeps"] == expect
    assert len(last["sweep_walls_s"]) == expect
    assert sorted(last) == sorted(jlast)
    assert prog.compile_cache_stats()["distinct_shapes"] == 1
    assert len(jprog._dispatch_shapes) == 1


def test_host_tier_matches_the_f64_oracle():
    """The reference's meshed case (test_host_tier_on_hierarchical_mesh)
    fails in the JAX package; on one card the same corpus and budget are
    held against the float64 oracle."""
    rng = np.random.default_rng(3)
    db, q = _int_rows(rng, 240), _int_rows(rng, 8)
    prog = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(80) // 2)
    assert prog.hosttier_stats()["sweeps"] == 6
    d, i = _np(prog.search(q))
    od, oi = _oracle(db, q, 4)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(d.astype(np.float64), od)


def _separated(ref_d, tol):
    sep = np.ones(ref_d.shape, bool)
    gap = np.diff(ref_d.astype(np.float64), axis=-1) > tol
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    return sep


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_host_tier_k_override_and_real_valued_metrics(mesh, metric):
    """``search(k=)`` above the constructor's k on real-valued rows: the
    JAX host tier's indices wherever its values are separated, values
    within the f32 bound of the JAX tier's and the port's resident
    search's."""
    rng = np.random.default_rng(4)
    db = (rng.random((160, DIM)) * 10).astype(np.float32)
    q = (rng.random((6, DIM)) * 10).astype(np.float32)
    width = DIM + (metric == "dot")
    tier = ShardedKNN(db, k=3, metric=metric, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(48, width))
    assert tier.hosttier_stats()["sweeps"] >= 3
    d, i = _np(tier.search(q, k=5))
    jd, ji = JaxShardedKNN(db, mesh=mesh, k=3, metric=metric,
                           hbm_budget_bytes=_budget_for_rows(48, width)
                           ).search(q, k=5)
    rd, ri = _np(ShardedKNN(db, k=3, metric=metric, device="cpu").search(
        q, k=5))
    if metric == "cosine":
        tol = np.full((q.shape[0], 1), 64 * EPS32 * 2.0)
    else:
        rows = tier._host_train().astype(np.float64)
        tol = 64 * EPS32 * ((q.astype(np.float64) ** 2).sum(-1)
                            + (rows ** 2).sum(-1).max())[:, None]
    for ref_d, ref_i in ((np.asarray(jd), np.asarray(ji)), (rd, ri)):
        assert (np.abs(d - ref_d) <= tol).all()
        sep = _separated(ref_d, tol)
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(i[sep], ref_i[sep])


def test_return_sqrt_is_the_resident_map():
    rng = np.random.default_rng(5)
    db, q = _int_rows(rng, 200), _int_rows(rng, 5)
    tier = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(50))
    d, i = _np(tier.search(q, return_sqrt=True))
    rd, ri = _np(ShardedKNN(db, k=4, device="cpu").search(
        q, return_sqrt=True))
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)


def test_resident_only_paths_refuse_host_tier():
    rng = np.random.default_rng(6)
    db = _int_rows(rng, 128)
    labels = (np.arange(128) % 3).astype(np.int32)
    prog = ShardedKNN(db, k=5, device="cpu", labels=labels, num_classes=3,
                      hbm_budget_bytes=_budget_for_rows(40))
    q = _int_rows(np.random.default_rng(1), 4)
    for call in (
        lambda: prog.search_certified(q),
        lambda: prog.search_certified(q, selector="exact"),
        lambda: prog.predict(q),
        lambda: prog.predict_certified(q),
        lambda: prog.radius_search(q, 1.0, max_neighbors=3),
        lambda: prog.search_bucketed(q),
        lambda: ServingEngine(prog),
    ):
        with pytest.raises(ValueError, match="host-RAM shard tier"):
            call()


def test_mutable_index_refuses_writes_on_the_host_tier(mesh):
    """The reference's MutableIndex refusals (mutable.py:323-330): writes
    on a host-tier main raise, searches run; certified search refuses
    through the main placement."""
    from knn_tpu.index.artifact import (
        MutationUnsupportedError as JaxUnsupported)
    from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex

    rng = np.random.default_rng(7)
    db, q = _int_rows(rng, 200), _int_rows(rng, 4)
    budget = _budget_for_rows(60)
    idx = MutableIndex(db, k=3, reserve=4, device="cpu",
                       hbm_budget_bytes=budget)
    jidx = JaxMutableIndex(db, mesh=mesh, k=3, reserve=4,
                           hbm_budget_bytes=budget)
    for write in (lambda x: x.insert(q[:1], [999]),
                  lambda x: x.delete([3]),
                  lambda x: x.compact()):
        with pytest.raises(MutationUnsupportedError,
                           match="host-RAM shard tier"):
            write(idx)
        with pytest.raises(JaxUnsupported, match="host-RAM shard tier"):
            write(jidx)
    with pytest.raises(ValueError, match="host-RAM shard tier"):
        idx.search_certified(q)


def test_bad_budget_values_raise():
    db = _int_rows(np.random.default_rng(8), 64)
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        ShardedKNN(db, k=3, device="cpu", hbm_budget_bytes=0)
    # a budget too small for even one row is loud
    with pytest.raises(ValueError, match="cannot hold"):
        ShardedKNN(db, k=3, device="cpu", hbm_budget_bytes=8)
    # k past one segment's rows cannot be ranked a sweep at a time
    with pytest.raises(ValueError, match="segment"):
        ShardedKNN(db, k=9, device="cpu",
                   hbm_budget_bytes=_budget_for_rows(8))


@pytest.mark.parametrize("n,dim,rows", [
    (1000, 32, 256), (400, 16, 64), (128, 16, 127), (1_000_000, 128, None)])
def test_plan_segments_model(n, dim, rows):
    """Equal segments covering every row, the JAX package's plan (at one
    host and one shard), n_sweeps its length; the smoke's plan at 128
    MiB: 260,111-row segments, 4 sweeps."""
    budget = (128 << 20) if rows is None else hbm.placement_bytes(rows, dim)
    segs = hbm.plan_segments(n, dim, budget)
    assert segs == jax_hbm.plan_segments(n, dim, budget)
    assert segs[0][0] == 0 and segs[-1][1] == n
    assert all(b == c for (_, b), (c, _) in zip(segs, segs[1:]))
    assert hbm.n_sweeps(n, dim, budget) == len(segs) == \
        jax_hbm.n_sweeps(n, dim, budget)
    assert hbm.rows_for_budget(budget, dim) == \
        jax_hbm.rows_for_budget(budget, dim)
    assert hbm.placement_bytes(n, dim) == jax_hbm.placement_bytes(n, dim)
    if rows is None:
        assert segs[0] == (0, 260_111) and len(segs) == 4
        assert segs[-1] == (780_333, 1_000_000)
    assert hbm.AUX_BYTES_PER_ROW == jax_hbm.AUX_BYTES_PER_ROW


def test_hosttier_metrics_registered():
    db = _int_rows(np.random.default_rng(9), 128)
    prog = ShardedKNN(db, k=3, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(40))
    assert obs.gauge(mn.HOSTTIER_SEGMENT_ROWS).get() == 40.0
    before = obs.counter(mn.HOSTTIER_SWEEPS).get()
    hist = obs.histogram(mn.HOSTTIER_SWEEP_SECONDS).summary()["count"]
    prog.search(_int_rows(np.random.default_rng(1), 4))
    sweeps = prog.hosttier_stats()["sweeps"]
    assert obs.counter(mn.HOSTTIER_SWEEPS).get() - before == sweeps == 4
    assert obs.histogram(mn.HOSTTIER_SWEEP_SECONDS).summary()["count"] \
        - hist == sweeps
    assert not {mn.HOSTTIER_SWEEPS, mn.HOSTTIER_SEGMENT_ROWS,
                mn.HOSTTIER_SWEEP_SECONDS} & mn.UNWRITTEN


def test_budget_on_a_placed_database_refuses_loudly():
    """The tier streams from host rows: a Placement or a tensor that
    cannot fit the budget is refused, one that fits is placed."""
    db = _int_rows(np.random.default_rng(10), 128)
    pl = placement_from_numpy(db, device="cpu")
    for train in (pl, torch.from_numpy(db)):
        with pytest.raises(ValueError, match="host-array construction"):
            ShardedKNN(train, k=5, hbm_budget_bytes=_budget_for_rows(40),
                       device=None if train is pl else "cpu")
    prog = ShardedKNN(pl, k=5, hbm_budget_bytes=_budget_for_rows(256))
    assert prog.hosttier_stats() is None
    prog = ShardedKNN(torch.from_numpy(db), k=5, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(256))
    assert prog.hosttier_stats() is None


def test_serving_engine_refuses_host_tier_placement():
    prog = ShardedKNN(_int_rows(np.random.default_rng(11), 128), k=5,
                      device="cpu", hbm_budget_bytes=_budget_for_rows(40))
    with pytest.raises(ValueError, match="host-RAM shard tier"):
        ServingEngine(prog)


def test_hosttier_knobs_are_arguments_not_environment(monkeypatch, mesh):
    """ROADMAP divergence 35: the JAX package reads
    KNN_TPU_HOSTTIER_BUDGET_BYTES / KNN_TPU_HOSTTIER_DEPTH; the port takes
    ``hbm_budget_bytes=`` and ``hosttier_depth=`` (default 2, the JAX
    default) and reads no environment."""
    db = _int_rows(np.random.default_rng(12), 128)
    monkeypatch.setenv("KNN_TPU_HOSTTIER_BUDGET_BYTES",
                       str(_budget_for_rows(40)))
    monkeypatch.setenv("KNN_TPU_HOSTTIER_DEPTH", "four")
    assert ShardedKNN(db, k=5, device="cpu").hosttier_stats() is None
    prog = ShardedKNN(db, k=5, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(40))
    assert prog.hosttier_stats()["depth"] == 2
    # the JAX package reads both switches
    with pytest.raises(ValueError, match="KNN_TPU_HOSTTIER_DEPTH"):
        JaxShardedKNN(db, mesh=mesh, k=5)
    monkeypatch.delenv("KNN_TPU_HOSTTIER_DEPTH")
    assert JaxShardedKNN(db, mesh=mesh, k=5).hosttier_stats()["depth"] == 2
    for depth in (0, -1):
        with pytest.raises(ValueError, match="hosttier_depth"):
            ShardedKNN(db, k=5, device="cpu", hosttier_depth=depth,
                       hbm_budget_bytes=_budget_for_rows(40))


def test_hosttier_stats_keys_equal_jax(mesh):
    db = _int_rows(np.random.default_rng(13), 200)
    budget = _budget_for_rows(64)
    prog = ShardedKNN(db, k=3, device="cpu", hbm_budget_bytes=budget)
    jprog = JaxShardedKNN(db, mesh=mesh, k=3, hbm_budget_bytes=budget)
    st, jst = prog.hosttier_stats(), jprog.hosttier_stats()
    assert st == jst  # before a search: the plan alone
    q = _int_rows(np.random.default_rng(1), 3)
    prog.search(q)
    jprog.search(q)
    st, jst = prog.hosttier_stats(), jprog.hosttier_stats()
    assert sorted(st) == sorted(jst)
    for key in ("segment_rows", "budget_bytes", "bytes_per_sweep", "depth",
                "itemsize", "sweeps"):
        assert st[key] == jst[key], key
    for key in ("sweeps", "k", "queries"):
        assert st["last_search"][key] == jst["last_search"][key], key


@pytest.mark.parametrize("metric", ["l2", "sql2", "cosine", "dot", "l1"])
def test_prepared_train_side_keeps_every_value(metric):
    """The segment program makes the segment's side of the distance once
    a sweep (ops.distance.prepare_train): the distances and the search
    are bitwise those made without it, on real-valued rows."""
    from knn_tpu_torch.ops.distance import pairwise_distance, prepare_train
    from knn_tpu_torch.ops.topk import knn_search

    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.normal(size=(9, DIM)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(50, DIM)).astype(np.float32))
    prep = prepare_train(t, metric)
    assert torch.equal(pairwise_distance(q, t, metric, prepared=prep),
                       pairwise_distance(q, t, metric))
    for a, b in zip(knn_search(q, t, 5, metric, n_valid=41, prepared=prep),
                    knn_search(q, t, 5, metric, n_valid=41)):
        assert torch.equal(a, b)


def test_segment_program_prepares_the_segment_once_a_sweep(monkeypatch):
    """A sweep's query blocks share one prepare_train of the segment:
    one call a sweep, however many blocks the budget makes."""
    from knn_tpu_torch.ops import distance
    from knn_tpu_torch.parallel import sharded

    calls = []
    real = distance.prepare_train
    monkeypatch.setattr(sharded, "prepare_train",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(22)
    db, q = _int_rows(rng, 300), _int_rows(rng, 40)
    prog = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(64))
    d, i = _np(prog.search(q))
    sweeps = prog.hosttier_stats()["sweeps"]
    assert len(calls) == sweeps == 5
    od, oi = _oracle(db, q, 4)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(d.astype(np.float64), od)


def test_concurrent_tier_searches_equal_sequential():
    """Threads searching one tier at once each get their sequential
    search's answer (one tier search at a time)."""
    import threading

    rng = np.random.default_rng(23)
    db = _int_rows(rng, 300)
    qs = [_int_rows(rng, 6) for _ in range(4)]
    prog = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=_budget_for_rows(64))
    want = [_np(prog.search(q)) for q in qs]
    got = [None] * len(qs)

    def run(j):
        got[j] = _np(prog.search(qs[j]))

    threads = [threading.Thread(target=run, args=(j,))
               for j in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (wd, wi), (gd, gi) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
