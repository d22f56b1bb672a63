"""The index tiers' serving frontends (``MutableServingEngine``,
``IVFServingEngine``) against the JAX package's (knn_tpu.index /
knn_tpu.ivf on make_mesh(1, 1)) and against the tiers' own direct
searches, through the port's ``QueryQueue``.

Tolerances: a ``MutableServingEngine`` read is BITWISE the index's
``search`` of the same padded batch at the epoch it pinned (one program
per part, the same lexicographic merge), and its ids equal the JAX
frontend's; an ``IVFServingEngine`` read is BITWISE the direct
``search_certified`` and the JAX frontend's (both float64-refined over a
certified candidate set).  No test asserts a wall time: the background
compaction is waited out by its epoch.
"""

import time

import numpy as np
import pytest

from knn_tpu import obs
from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.serving import QueryQueue as JaxQueue
from knn_tpu_torch.index import MutableIndex, MutableServingEngine
from knn_tpu_torch.ivf import IVFIndex, IVFServingEngine
from knn_tpu_torch.serving import QueryQueue, bucket_for

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

DIM = 12
K = 5
BUCKETS = (8, 16)
WAIT = 60.0


@pytest.fixture(scope="module", autouse=True)
def _obs_off():
    obs.reset(enabled=False)
    yield
    obs.reset()


@pytest.fixture
def data():
    rng = np.random.default_rng(9)
    db = rng.normal(size=(500, DIM)).astype(np.float32) * 10
    q = rng.normal(size=(6, DIM)).astype(np.float32) * 10
    return db, q


def _padded_search(index, q, ladder=BUCKETS):
    rows = bucket_for(ladder, q.shape[0]) or q.shape[0]
    padded = np.zeros((rows, q.shape[1]), np.float32)
    padded[:q.shape[0]] = q
    d, i = index.search(padded)
    return d[:q.shape[0]], i[:q.shape[0]]


def _mutate(idx, q):
    idx.insert(q[:2] + 0.01, [8000, 8001])  # near-certain top hits
    idx.delete([0, 1])


# -- MutableServingEngine ---------------------------------------------------
def test_mutable_frontend_is_the_padded_direct_search_and_jax_ids(data):
    db, q = data
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    eng = idx.serving_engine(buckets=BUCKETS)
    assert isinstance(eng, MutableServingEngine)
    assert eng.warmup() == {"search": 2, "tail_buckets": 2}
    jidx = JaxMutableIndex(db, mesh=make_mesh(1, 1), k=K, reserve=8)
    jeng = jidx.serving_engine(buckets=BUCKETS)
    jeng.warmup()
    _mutate(idx, q)
    _mutate(jidx, q)
    for n in (1, 6):
        d, i = eng.search(q[:n])
        pd, pi = _padded_search(idx, q[:n])
        np.testing.assert_array_equal(d, pd)
        np.testing.assert_array_equal(i, pi)
        np.testing.assert_array_equal(i, jeng.search(q[:n])[1])
    assert i[:2, 0].tolist() == [8000, 8001]
    np.testing.assert_array_equal(eng.search(q, return_sqrt=True)[0],
                                  np.sqrt(d))
    st = eng.stats()
    obs.reset(enabled=True)  # the JAX frontend's telemetry-on stats shape
    try:
        jst = jeng.stats()
    finally:
        obs.reset(enabled=False)
    assert st["index"]["tail_rows"] == 2 and st["index"]["tombstones"] == 2
    assert set(st) <= set(jst) | {"index"}
    assert set(st["index"]) == set(idx.stats())
    with pytest.raises(ValueError, match="search"):
        eng.submit(q, op="predict")
    with pytest.raises(ValueError, match="incompatible"):
        eng.submit(q[:, :4])
    with pytest.raises(RuntimeError, match="already"):
        idx.serving_engine(buckets=(8,))


def test_writes_through_the_queue_are_first_class(data):
    db, q = data
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    eng = idx.serving_engine(buckets=BUCKETS)
    jidx = JaxMutableIndex(db, mesh=make_mesh(1, 1), k=K, reserve=8)
    jeng = jidx.serving_engine(buckets=BUCKETS)
    outs = {}
    for name, cls, e in (("port", QueryQueue, eng), ("jax", JaxQueue, jeng)):
        with cls(e, max_wait_ms=1.0) as qq:
            f1 = qq.submit_write("insert", vectors=q[:1], ids=[8000],
                                 tenant="w")
            f2 = qq.submit_write("delete", ids=[8000])
            bad = qq.submit_write("delete", ids=[999999])
            with pytest.raises(KeyError):
                bad.result()
            nope = qq.submit_write("upsert", ids=[1])
            with pytest.raises(ValueError, match="write kind"):
                nope.result()
            _, ids = qq.submit(q).result(timeout=WAIT)
            outs[name] = (f1.result(), f2.result(), ids,
                          qq.stats()["writes"])
    assert outs["port"][0] == outs["jax"][0] == {"epoch": 0, "tail_rows": 1}
    assert outs["port"][1] == outs["jax"][1]
    np.testing.assert_array_equal(outs["port"][2], outs["jax"][2])
    assert not (outs["port"][2] == 8000).any()
    assert outs["port"][3] == outs["jax"][3] == {"insert": 1, "delete": 1,
                                                 "errors": 2}


def test_compaction_swaps_in_a_prewarmed_engine(data):
    db, q = data
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    eng = idx.serving_engine(buckets=BUCKETS)
    eng.warmup()
    old = idx._snapshot().engine
    _mutate(idx, q)
    before = eng.search(q)
    rep = idx.compact()
    new = idx._snapshot().engine
    assert new is not old and new.program is idx._snapshot().main
    # built and warmed before the swap: every rung ready, the same ops
    assert new.warmed_ops == old.warmed_ops == {"search"}
    assert new.stats()["compile_count"] == len(BUCKETS)
    after = eng.search(q)
    assert new.stats()["compile_count"] == len(BUCKETS)  # nothing new
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[1], _padded_search(idx, q)[1])
    assert rep["epoch"] == 1 and eng.stats()["index"]["tail_rows"] == 0
    # an index without a frontend compacts without building an engine
    plain = MutableIndex(db, k=K, reserve=8, device="cpu")
    plain.compact()
    assert plain._snapshot().engine is None


def test_reads_across_a_background_compaction_are_each_epochs_search(data):
    """Reads through the queue while the compactor swaps: each is bitwise
    the direct padded search of the snapshot before or after the swap,
    and the reads after it are bitwise a fresh index of the survivors."""
    db, q = data
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    eng = idx.serving_engine(buckets=BUCKETS)
    eng.warmup()
    with QueryQueue(eng, max_wait_ms=0.0) as qq:
        qq.submit_write("insert", vectors=q[:3] + 0.02,
                        ids=[8000, 8001, 8002]).result()
        qq.submit_write("delete", ids=[5, 8001]).result()
        blocks = [q[:1], q[1:4], q]
        pre = [_padded_search(idx, b) for b in blocks]
        idx.start_compactor(interval_s=0.01)
        reads = []
        t0 = time.monotonic()
        while idx.epoch == 0 or len(reads) < 6:
            assert time.monotonic() - t0 < WAIT
            j = len(reads) % 3
            reads.append((j, qq.submit(blocks[j]).result(timeout=WAIT)))
        idx.close()
        last = [qq.submit(b).result(timeout=WAIT) for b in blocks]
    post = [_padded_search(idx, b) for b in blocks]
    for j, r in reads:
        assert any(all(np.array_equal(x, y) for x, y in zip(r, want))
                   for want in (pre[j], post[j]))
    snap = idx._snapshot()
    fresh = MutableIndex(snap.main._host_train(), snap.base_ids, k=K,
                         reserve=8, device="cpu")
    for r, b, p in zip(last, blocks, post):
        assert all(np.array_equal(x, y) for x, y in zip(r, p))
        assert all(np.array_equal(x, y)
                   for x, y in zip(r, _padded_search(fresh, b)))
    assert sorted(snap.base_ids.tolist()) == sorted(
        [i for i in range(500) if i != 5] + [8000, 8002])


# -- IVFServingEngine -------------------------------------------------------------
@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    cents = (rng.normal(size=(8, DIM)) * 20.0).astype(np.float32)
    rows = np.concatenate([
        c + rng.normal(size=(40, DIM)).astype(np.float32) * 0.05
        for c in cents])
    qs = (cents[rng.integers(0, 8, 24)]
          + rng.normal(size=(24, DIM)).astype(np.float32) * 0.05)
    return rows, qs


def test_ivf_frontend_is_bitwise_search_certified_and_jax(blobs):
    rows, qs = blobs
    kw = dict(k=K, ncentroids=8, nprobe=2, train_iters=2, seed=0)
    idx = IVFIndex(rows, device="cpu", **kw)
    jidx = JaxIVFIndex(rows, mesh=make_mesh(1, 1), **kw)
    eng = idx.serving_engine()
    jeng = jidx.serving_engine()
    assert isinstance(eng, IVFServingEngine)
    assert eng.buckets == jeng.buckets == (8, 16)
    assert eng.warmup() == jeng.warmup() == {"search": 2}
    assert eng.warmed_ops == jeng.warmed_ops
    with QueryQueue(eng, max_wait_ms=0.0) as qq:
        served = [qq.submit(qs[lo:lo + 8]).result(timeout=WAIT)
                  for lo in range(0, 24, 8)]
    d = np.concatenate([s[0] for s in served])
    i = np.concatenate([s[1] for s in served])
    dd, di, _ = idx.search_certified(qs)
    np.testing.assert_array_equal(d, dd)
    np.testing.assert_array_equal(i, di)
    jd, ji = jeng.search(qs)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(eng.search(qs, return_sqrt=True)[0],
                                  np.sqrt(dd))
    assert set(eng.stats()) == set(jeng.stats()) == {"index"}
    with pytest.raises(ValueError, match="search"):
        eng.submit(qs, op="predict")
    with pytest.raises(ValueError, match="incompatible"):
        eng.submit(qs[:, :3])


def test_ivf_frontend_search_knobs_and_writes(blobs):
    rows, qs = blobs
    idx = IVFIndex(rows, k=K, ncentroids=8, nprobe=2, train_iters=2, seed=0,
                   device="cpu")
    eng = idx.serving_engine(buckets=(8,), selector="pallas",
                             precision="bf16x3")
    d, i = eng.search(qs[:8])
    dd, di, _ = idx.search_certified(qs[:8], selector="pallas",
                                     precision="bf16x3")
    np.testing.assert_array_equal(d, dd)
    np.testing.assert_array_equal(i, di)
    # the frontend takes the two settings a request runs with, no other
    with pytest.raises(TypeError, match="tile_n"):
        idx.serving_engine(tile_n=256)
    with QueryQueue(eng, max_wait_ms=0.0) as qq:
        w = qq.submit_write("insert", vectors=qs[:1] + 0.001,
                            ids=[9000]).result()
        assert w == {"epoch": 0, "tail_rows": 1}
        _, ids = qq.submit(qs[:1]).result(timeout=WAIT)
        assert ids[0, 0] == 9000
        qq.submit_write("delete", ids=[9000]).result()
        _, ids = qq.submit(qs[:1]).result(timeout=WAIT)
        assert 9000 not in ids
        assert qq.stats()["writes"] == {"insert": 1, "delete": 1,
                                        "errors": 0}


def test_a_frontend_made_during_a_compaction_serves_the_swapped_placement(
        data, monkeypatch):
    """serving_engine() while a compaction builds its placement: after the
    swap the frontend's engine serves the new placement (never the old
    one under the new ids)."""
    import threading

    from knn_tpu_torch.parallel import sharded

    db, q = data
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    _mutate(idx, q)
    building, release = threading.Event(), threading.Event()
    real = sharded.ShardedKNN

    def slow_placement(*a, **kw):
        building.set()
        assert release.wait(WAIT)
        return real(*a, **kw)

    monkeypatch.setattr(sharded, "ShardedKNN", slow_placement)
    t = threading.Thread(target=idx.compact)
    t.start()
    assert building.wait(WAIT)
    eng = idx.serving_engine(buckets=BUCKETS)
    release.set()
    t.join(WAIT)
    assert not t.is_alive()
    monkeypatch.setattr(sharded, "ShardedKNN", real)
    snap = idx._snapshot()
    assert snap.epoch == 1 and snap.engine.program is snap.main
    np.testing.assert_array_equal(eng.search(q)[1],
                                  _padded_search(idx, q)[1])
