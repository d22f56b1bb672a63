"""The port's bulk kNN join (knn_tpu_torch.join) and its byte model
(knn_tpu_torch.analysis) against the JAX package's (knn_tpu.join,
knn_tpu.analysis on make_mesh(1, 1)) and the float64 oracle, at the
reference fixture's shape (600 x 16 corpus with duplicate rows, 70
queries).

Tolerances: the stream join is BITWISE the port's own looped
``ShardedKNN.search`` at the same padded block shape (one program);
against the JAX join its indices are equal wherever the JAX values of
adjacent ranks are separated by more than 64 eps_f32 (||q||^2 +
max||t||^2) (l1: 64 eps_f32 times the row's largest value; cosine: 64
eps_f32 x 2, unit rows) — the f32 values of two packages may differ in
the last bits — and its distances within that bound.  The certified join
is BITWISE the JAX certified join through the counted selectors and on
the IVF tier (float64-refined answers), and bitwise the port's looped
certified path through every selector.  Plans and byte-model numbers are integers:
equal.
"""

import numpy as np
import pytest

from knn_tpu.analysis import hbm as jax_hbm
from knn_tpu.analysis import widths as jax_widths
from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.join import default_plan as jax_default_plan
from knn_tpu.join import knn_join as jax_knn_join
from knn_tpu.obs.roofline import db_operand_nbytes as jax_db_operand_nbytes
from knn_tpu.parallel import ShardedKNN as JaxShardedKNN
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import ShardedKNN
from knn_tpu_torch.analysis import hbm, widths
from knn_tpu_torch.cli import main as cli_main
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.join import JOIN_MODES, default_plan, knn_join

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

DIM = 16
EPS32 = float(np.finfo(np.float32).eps)


def _oracle(db, queries, k):
    d = ((db.astype(np.float64)[None]
          - queries.astype(np.float64)[:, None]) ** 2).sum(-1)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _db(rng, n, dim=DIM):
    return (rng.random((n, dim)) * 10).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    db = _db(rng, 600)
    db[200:220] = db[:20]  # exact duplicates
    return db, _db(rng, 70)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, 1)


def _looped_search(prog, q, sb_rows, **kw):
    """The looped-search reference at the stream's padded block shape."""
    ds, is_ = [], []
    for lo in range(0, q.shape[0], sb_rows):
        blk = q[lo:lo + sb_rows]
        valid = blk.shape[0]
        if valid < sb_rows:
            blk = np.pad(blk, ((0, sb_rows - valid), (0, 0)))
        d, i = prog.search(blk, **kw)
        ds.append(d.cpu().numpy()[:valid])
        is_.append(i.cpu().numpy()[:valid])
    return np.concatenate(ds), np.concatenate(is_)


# -- stream mode --------------------------------------------------------------
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "dot"])
def test_stream_join_bitwise_looped_search_and_jax(corpus, mesh, metric):
    db, q = corpus
    prog = ShardedKNN(db, k=7, metric=metric, device="cpu")
    d, i, st = knn_join(prog, q, mode="stream", superblock_rows=32)
    ref_d, ref_i = _looped_search(prog, q, 32)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(d, ref_d)
    assert st["mode"] == "stream" and st["rows"] == q.shape[0]
    assert st["superblocks"] == st["dispatches"] == -(-q.shape[0] // 32)
    assert st["db_segments"] == 1 and st["order"] == "query_major"
    assert st["rows_per_s"] > 0 and 0.0 <= st["overlap_ratio"] <= 1.0
    # the JAX join: values within the f32 bound, indices equal wherever
    # the JAX values of adjacent ranks are separated by more than it
    jd, ji, jst = jax_knn_join(
        JaxShardedKNN(db, mesh=mesh, k=7, metric=metric), q, mode="stream",
        superblock_rows=32)
    jd = np.asarray(jd, np.float64)
    if metric == "l1":
        tol = 64 * EPS32 * np.abs(jd).max(-1, keepdims=True)
    elif metric == "cosine":  # 1 - q^.t^ of unit rows
        tol = np.full((q.shape[0], 1), 64 * EPS32 * 2.0)
    else:
        rows = db.astype(np.float64)
        tol = 64 * EPS32 * ((q.astype(np.float64) ** 2).sum(-1)
                            + (rows ** 2).sum(-1).max())[:, None]
    assert (np.abs(d - jd) <= tol).all()
    sep = np.ones(ji.shape, bool)
    gap = np.diff(jd, axis=-1) > tol
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(i[sep], np.asarray(ji)[sep])
    for key in ("superblocks", "db_segments", "dispatches", "order", "plan",
                "superblock_rows", "depth"):
        assert st[key] == jst[key], key


def test_stream_join_return_sqrt_matches_search(corpus):
    db, q = corpus
    prog = ShardedKNN(db, k=5, device="cpu")
    d, i, _ = knn_join(prog, q, mode="stream", superblock_rows=24,
                       return_sqrt=True)
    ref_d, ref_i = _looped_search(prog, q, 24, return_sqrt=True)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(d, ref_d)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_join_depth_does_not_move_the_answer(corpus, depth):
    db, q = corpus
    prog = ShardedKNN(db, k=5, device="cpu")
    d1, i1, _ = knn_join(prog, q, superblock_rows=16)
    d2, i2, st = knn_join(prog, q, superblock_rows=16, depth=depth)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    assert st["depth"] == depth


# -- certified mode -----------------------------------------------------------
@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_certified_join_bitwise_jax(corpus, mesh, selector):
    db, q = corpus
    ref_d, ref_i = _oracle(db, q, 7)
    prog = ShardedKNN(db, k=7, device="cpu")
    d, i, st = knn_join(prog, q, mode="certified", superblock_rows=24,
                        selector=selector)
    jd, ji, _ = jax_knn_join(JaxShardedKNN(db, mesh=mesh, k=7), q,
                             mode="certified", superblock_rows=24,
                             selector=selector)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(d, ref_d, rtol=1e-9)
    assert st["overlap_ratio"] is None and st["superblocks"] == 3


@pytest.mark.parametrize("kw", [
    {}, {"kernel": "streaming"}, {"kernel": "fused", "precision": "int8"},
    {"selector": "exact", "return_sqrt": True}])
def test_certified_join_bitwise_looped_certified(corpus, kw):
    db, q = corpus
    prog = ShardedKNN(db, k=5, device="cpu")
    d, i, _ = knn_join(prog, q, mode="certified", superblock_rows=32, **kw)
    ld, li = [], []
    for lo in range(0, q.shape[0], 32):
        dd, ii, _ = prog.search_certified(q[lo:lo + 32], **kw)
        ld.append(dd)
        li.append(ii)
    np.testing.assert_array_equal(d, np.concatenate(ld))
    np.testing.assert_array_equal(i, np.concatenate(li))
    np.testing.assert_array_equal(i, _oracle(db, q, 5)[1])


def test_certified_join_on_ivf_tier_bitwise_jax(mesh):
    rng = np.random.default_rng(1)
    db = _db(rng, 800)
    q = _db(rng, 40)
    ref_d, ref_i = _oracle(db, q, 6)
    idx = IVFIndex(db, k=6, seed=0, device="cpu")
    d, i, st = knn_join(idx, q, mode="certified", superblock_rows=16)
    jd, ji, _ = jax_knn_join(JaxIVFIndex(db, mesh=mesh, k=6, seed=0), q,
                             mode="certified", superblock_rows=16)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(d, ref_d, rtol=1e-9)
    assert st["superblocks"] == -(-40 // 16)
    with pytest.raises(ValueError, match="certified"):
        knn_join(idx, q, mode="stream")


# -- the host-RAM-tier corpus, both nesting orders -----------------------------
def _int_rows(rng, n):
    """Integer-valued rows: every f32 product exact, so the tier, the
    resident search and the JAX tier agree bitwise."""
    return rng.integers(0, 10, size=(n, DIM)).astype(np.float32)


@pytest.mark.parametrize("sb,order", [(16, "db_major"), (48, "query_major")])
def test_tiered_join_bitwise_looped_host_tier_search_and_jax(mesh, sb, order):
    """B over the budget (the JAX package's test_superhbm_b_join_* shapes):
    the join nests the order plan_join picks (db_major with three
    superblocks, query_major with one), its counts equal the plan and the
    JAX join's, and it is bitwise the looped host-tier search at the same
    block shape, the resident search's and the JAX tiered join's."""
    rng = np.random.default_rng(21)
    db, q = _int_rows(rng, 400), _int_rows(rng, 48)
    db[300:320] = db[:20]
    budget = hbm.placement_bytes(64, DIM)
    prog = ShardedKNN(db, k=5, device="cpu", hbm_budget_bytes=budget)
    segs = hbm.n_sweeps(400, DIM, budget)
    assert segs == 7
    d, i, st = knn_join(prog, q, mode="stream", superblock_rows=sb)
    plan = default_plan(prog, 48, superblock_rows=sb)
    assert st["order"] == plan["order"] == order
    assert st["db_segments"] == plan["db_segments"] == segs
    assert st["superblocks"] == plan["superblocks"] == 48 // sb
    assert st["dispatches"] == plan["dispatches"] == segs * (48 // sb)
    assert plan["db_segment_rows"] == 64
    ref_d, ref_i = _looped_search(prog, q, sb)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(d, ref_d)
    res_d, res_i = _looped_search(ShardedKNN(db, k=5, device="cpu"), q, sb)
    np.testing.assert_array_equal(i, res_i)
    np.testing.assert_array_equal(d, res_d)
    jprog = JaxShardedKNN(db, mesh=mesh, k=5, hbm_budget_bytes=budget)
    jd, ji, jst = jax_knn_join(jprog, q, mode="stream", superblock_rows=sb)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert plan == jax_default_plan(jprog, 48, superblock_rows=sb)
    for key in ("order", "superblocks", "db_segments", "dispatches"):
        assert st[key] == jst[key], key


def test_tiered_join_return_sqrt_and_depth():
    rng = np.random.default_rng(22)
    db, q = _int_rows(rng, 300), _int_rows(rng, 40)
    prog = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=hbm.placement_bytes(50, DIM))
    ref = None
    for depth in (1, 2, 5):
        d, i, st = knn_join(prog, q, mode="stream", superblock_rows=16,
                            depth=depth, return_sqrt=True)
        if ref is None:
            ref = (d, i)
        np.testing.assert_array_equal(i, ref[1])
        np.testing.assert_array_equal(d, ref[0])
    sd, si = _looped_search(prog, q, 16, return_sqrt=True)
    np.testing.assert_array_equal(ref[1], si)
    np.testing.assert_array_equal(ref[0], sd)


@pytest.mark.parametrize("n_a,n_b,sb,seg", [
    (48, 400, 16, 64), (48, 400, 48, 64), (16384, 1_000_000, 4096, 260_111),
    (16384, 1_000_000, 16384, 260_111), (5, 7, 2, 3)])
def test_plan_join_with_db_segments_equals_jax(n_a, n_b, sb, seg):
    assert hbm.plan_join(n_a, n_b, 128, superblock_rows=sb,
                         db_segment_rows=seg) == \
        jax_hbm.plan_join(n_a, n_b, 128, superblock_rows=sb,
                          db_segment_rows=seg)
    assert hbm.n_superblocks(n_a, 128, hbm.query_block_bytes(sb, 128)) == \
        jax_hbm.n_superblocks(n_a, 128, hbm.query_block_bytes(sb, 128))


# -- the plan and the byte model ----------------------------------------------
def test_query_budget_boundary_matrix_matches_jax_plans(corpus, mesh):
    """Budget holds A exactly -> 1 superblock; one row short -> 2; many
    times over -> the byte model's count: executed counts equal the plan,
    and plans equal the JAX package's."""
    db, q = corpus
    n_a = q.shape[0]
    prog = ShardedKNN(db, k=5, device="cpu")
    jprog = JaxShardedKNN(db, mesh=mesh, k=5)
    ref_i = None
    for budget, expect in ((hbm.query_block_bytes(72, DIM), 1),
                           (hbm.query_block_bytes(69, DIM), 2),
                           (hbm.query_block_bytes(16, DIM), 5)):
        assert len(hbm.plan_superblocks(n_a, DIM, budget)) == expect
        assert hbm.plan_superblocks(n_a, DIM, budget) == \
            jax_hbm.plan_superblocks(n_a, DIM, budget)
        plan = default_plan(prog, n_a, query_budget_bytes=budget)
        assert plan == jax_default_plan(jprog, n_a,
                                        query_budget_bytes=budget)
        d, i, st = knn_join(prog, q, mode="stream",
                            query_budget_bytes=budget)
        assert st["superblocks"] == st["dispatches"] == expect
        assert st["plan"] == plan
        if ref_i is None:
            ref_i = i
        np.testing.assert_array_equal(i, ref_i)
    with pytest.raises(ValueError, match="cannot hold"):
        knn_join(prog, q, mode="stream", query_budget_bytes=8)


@pytest.mark.parametrize("n_a,n_b,sb", [
    (70, 600, 32), (48, 400, 16), (48, 400, 48), (1, 1, 1),
    (16384, 1_000_000, 4096), (16384, 131_072, 16384)])
def test_plan_join_equals_jax(n_a, n_b, sb):
    """The resident-corpus plan (the JAX package's default
    ``db_segment_rows=0``)."""
    assert hbm.plan_join(n_a, n_b, 128, superblock_rows=sb) == \
        jax_hbm.plan_join(n_a, n_b, 128, superblock_rows=sb)


def test_byte_model_helpers_equal_jax():
    for n, dim in ((0, 1), (1000, 128), (7, 300)):
        assert hbm.query_block_bytes(n, dim) == \
            jax_hbm.query_block_bytes(n, dim)
    for budget in (512, 4096, 10 ** 6):
        assert hbm.superblock_rows_for_budget(budget, 16) == \
            jax_hbm.superblock_rows_for_budget(budget, 16)
    for prec in ("bf16x3", "bf16x3f", "int8", "int4", "highest", "default",
                 "pq"):
        for dim in (12, 128, 300):
            assert widths.db_row_bytes(dim, prec) == \
                jax_widths.db_row_bytes(dim, prec)
            assert widths.db_operand_nbytes(1000, dim, prec) == \
                jax_db_operand_nbytes(1000, dim, prec)
        assert widths.aux_rows_for(prec) == jax_widths.aux_rows_for(prec)


def test_default_plan_is_what_the_join_executes(corpus):
    db, q = corpus
    prog = ShardedKNN(db, k=5, device="cpu")
    plan = default_plan(prog, q.shape[0], superblock_rows=32)
    ref = hbm.plan_join(q.shape[0], 600, DIM, superblock_rows=32)
    for key in ("order", "superblocks", "db_segments", "dispatches",
                "h2d_bytes"):
        assert plan[key] == ref[key]
    _, _, st = knn_join(prog, q, mode="stream", superblock_rows=32)
    for key in ("superblocks", "db_segments", "dispatches"):
        assert st[key] == plan[key]


def test_join_argument_validation(corpus):
    db, q = corpus
    prog = ShardedKNN(db, k=5, device="cpu")
    assert set(JOIN_MODES) == {"stream", "certified"}
    with pytest.raises(ValueError, match="unknown join mode"):
        knn_join(prog, q, mode="batch")
    with pytest.raises(ValueError, match="incompatible"):
        knn_join(prog, q[:, :8], mode="stream")
    with pytest.raises(ValueError, match="superblock_rows"):
        knn_join(prog, q, mode="stream", superblock_rows=0)
    with pytest.raises(ValueError, match="program.k"):
        knn_join(prog, q, mode="certified", k=9)
    with pytest.raises(ValueError, match="exceeds"):
        knn_join(prog, q, mode="stream", k=601)


def test_cli_join_on_cpu(capsys):
    import json

    assert cli_main(["join", "--n", "2000", "--rows", "300", "--dim", "8",
                     "--k", "4", "--superblock", "128",
                     "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["superblocks"] == 3 and stats["mode"] == "stream"
    assert cli_main(["join", "--n", "500", "--rows", "40", "--dim", "8",
                     "--k", "4", "--mode", "certified",
                     "--device", "cpu"]) == 0
    # the host-RAM tier: 2,000 rows behind a 500-row budget, 4 segments
    assert cli_main(["join", "--n", "2000", "--rows", "300", "--dim", "8",
                     "--k", "4", "--superblock", "128", "--hbm-budget-bytes",
                     str(hbm.placement_bytes(500, 8)), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["db_segments"] == 4 and stats["superblocks"] == 3
    assert stats["plan"]["db_segment_rows"] == 500
    with pytest.raises(ValueError, match="cannot hold"):
        cli_main(["join", "--hbm-budget-bytes", "4", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_main(["join", "--cpu-devices", "4", "--device", "cpu"])
