"""The port's IVF tier (knn_tpu_torch.ivf) against the JAX package's
(knn_tpu.ivf on make_mesh(1, 1), Pallas in interpret mode), float64 brute
force and the IVF autotuner, at the reference fixture's shape (8
well-separated 16-dim blobs of 40 rows, k=5).

Tolerances: ``search_certified`` is BITWISE the JAX index's and float64
brute force (``refine_shared_exact`` over every live row): both anchor
their answers in the same float64 per-pair refine of a candidate set that
the residual certificate proves, or the repair makes, exact.  The search
stats equal the JAX index's where the two k-means give bitwise the same
centroids (asserted first: the port's k=1 assign can differ on an f32 near
tie, and the blobs here have none); their key sets are always equal.
"""

import threading

import numpy as np
import pytest

from knn_tpu import tuning as jax_tuning
from knn_tpu.tuning.autotune import ivf_label as jax_ivf_label
from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.ops.refine import refine_shared_exact as jax_refine_shared
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import tuning
from knn_tpu_torch.index import MutationBudgetError
from knn_tpu_torch.ivf import SELECTORS, IVFIndex
from knn_tpu_torch.ops.refine import refine_shared_exact

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

DIM = 16
K = 5
NCLUSTERS = 8


def _clustered(rng, per=40, spread=0.05, sep=20.0):
    cents = (rng.normal(size=(NCLUSTERS, DIM)) * sep).astype(np.float32)
    rows = np.concatenate([
        cents[i] + rng.normal(size=(per, DIM)).astype(np.float32) * spread
        for i in range(NCLUSTERS)])
    qs = (cents[rng.integers(0, NCLUSTERS, 24)]
          + rng.normal(size=(24, DIM)).astype(np.float32) * spread)
    return rows, qs


def _exact(db, q, k=K):
    return refine_shared_exact(db, q, np.arange(db.shape[0], dtype=np.int64),
                               k)


@pytest.fixture(scope="module")
def clustered():
    return _clustered(np.random.default_rng(7))


@pytest.fixture(scope="module")
def pair(clustered):
    """The reference's nprobe=2 index, built once on each side."""
    rows, _ = clustered
    kw = dict(k=K, ncentroids=NCLUSTERS, nprobe=2, train_iters=2, seed=0)
    return (IVFIndex(rows, device="cpu", **kw),
            JaxIVFIndex(rows, mesh=make_mesh(1, 1), **kw))


def _without_wall(stats):
    return {key: v for key, v in stats.items() if key != "wall_s"}


@pytest.mark.parametrize("selector", SELECTORS)
def test_search_certified_bitwise_jax_and_brute_force(clustered, pair,
                                                      selector):
    rows, qs = clustered
    port, ref = pair
    kw = dict(selector=selector, margin=8, tile_n=256)
    d_p, i_p, st_p = port.search_certified(qs, **kw)
    d_j, i_j, st_j = ref.search_certified(qs, **kw)
    np.testing.assert_array_equal(d_p, d_j)
    np.testing.assert_array_equal(i_p, i_j)
    d_ref, i_ref = _exact(rows, qs)
    np.testing.assert_array_equal(d_p, d_ref)
    np.testing.assert_array_equal(i_p, i_ref)
    assert set(st_p) == set(st_j)
    np.testing.assert_array_equal(port._centroids, ref._centroids)
    assert _without_wall(st_p) == _without_wall(st_j)
    assert st_p["fallback_rate"] == 0.0 and st_p["recall_at_k"] == 1.0


@pytest.mark.parametrize("selector", SELECTORS)
def test_nprobe_all_reproduces_brute_force_bitwise(clustered, selector):
    rows, qs = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, nprobe=NCLUSTERS,
                   train_iters=2, seed=0, device="cpu")
    d_i, i_i, st = idx.search_certified(qs, selector=selector, margin=8,
                                        tile_n=256)
    d_ref, i_ref = _exact(rows, qs)
    np.testing.assert_array_equal(d_i, d_ref)
    np.testing.assert_array_equal(i_i, i_ref)
    assert st["probe_fraction"] == 1.0 and st["groups"] == 1


@pytest.mark.parametrize("precision,kernel", [
    ("highest", "tiled"), ("bf16x3", "streaming"), ("int8", "streaming"),
    ("bf16x3", "fused"),
])
def test_bitwise_across_pallas_precisions_and_kernels(clustered, pair,
                                                      precision, kernel):
    rows, qs = clustered
    kw = dict(selector="pallas", precision=precision, kernel=kernel,
              margin=8, tile_n=256)
    d_i, i_i, _ = pair[0].search_certified(qs, **kw)
    d_ref, i_ref = _exact(rows, qs)
    np.testing.assert_array_equal(d_i, d_ref)
    np.testing.assert_array_equal(i_i, i_ref)


def test_forced_miss_is_detected_and_repaired(clustered, pair):
    """Queries between two clusters at nprobe=1: the residual certificate
    flags them, the float64 repair makes them exact — as in the JAX
    index, stats included."""
    rows, _ = clustered
    port, ref = pair
    rng = np.random.default_rng(11)
    cents = port._centroids
    pairs = rng.choice(NCLUSTERS, size=(12, 2), replace=True)
    qs = ((cents[pairs[:, 0]] + cents[pairs[:, 1]]) / 2).astype(np.float32)
    d_p, i_p, st_p = port.search_certified(qs, nprobe=1)
    d_j, i_j, st_j = ref.search_certified(qs, nprobe=1)
    d_ref, i_ref = _exact(rows, qs)
    np.testing.assert_array_equal(d_p, d_ref)
    np.testing.assert_array_equal(i_p, i_ref)
    np.testing.assert_array_equal(d_p, d_j)
    np.testing.assert_array_equal(i_p, i_j)
    assert st_p["fallback_queries"] > 0, st_p
    assert st_p["fallback_rate"] == st_p["fallback_queries"] / qs.shape[0]
    assert _without_wall(st_p) == _without_wall(st_j)


def test_step_timings_cover_the_call(clustered, pair):
    _, qs = clustered
    timings = {}
    _, _, st = pair[0].search_certified(qs, timings=timings)
    assert set(timings) == {"probe", "gather", "device", "refine", "repair",
                            "other"}
    assert timings["device"] > 0 and timings["repair"] == 0.0
    assert abs(sum(timings.values()) - st["wall_s"]) < 1e-3


def test_mutation_oracle_across_compactions(clustered):
    """Inserts, deletes and two re-cluster compactions: bitwise the JAX
    index after the same writes, float64 brute force over the survivors
    and a fresh port index of them, for both selectors."""
    rows, qs = clustered
    n0 = rows.shape[0]
    rng = np.random.default_rng(3)
    ins1 = rows[:30] + rng.normal(size=(30, DIM)).astype(np.float32)
    ins2 = rows[40:55] + rng.normal(size=(15, DIM)).astype(np.float32)
    kw = dict(k=K, ncentroids=NCLUSTERS, nprobe=2, train_iters=2, seed=0)
    sides = [IVFIndex(rows, device="cpu", **kw),
             JaxIVFIndex(rows, mesh=make_mesh(1, 1), **kw)]
    reports = []
    for idx in sides:
        idx.insert(ins1, np.arange(n0, n0 + 30))
        idx.delete(np.arange(0, 20))
        rep1 = idx.compact()
        idx.insert(ins2, np.arange(n0 + 30, n0 + 45))
        idx.delete(np.arange(25, 35))
        rep2 = idx.compact()
        reports.append([{key: v for key, v in r.items() if key != "wall_s"}
                        for r in (rep1, rep2)])
    assert reports[0] == reports[1]
    assert sides[0].stats()["compactions"] == 2
    surv_rows = np.concatenate([rows[20:25], rows[35:], ins1, ins2])
    surv_ids = np.concatenate([np.arange(20, 25), np.arange(35, n0),
                               np.arange(n0, n0 + 45)])
    d_ref, p_ref = _exact(surv_rows, qs)
    i_ref = surv_ids[p_ref]
    for sel in SELECTORS:
        got = sides[0].search_certified(qs, selector=sel, margin=8,
                                        tile_n=256)
        want = sides[1].search_certified(qs, selector=sel, margin=8,
                                         tile_n=256)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], d_ref)
        np.testing.assert_array_equal(got[1], i_ref)
    fresh = IVFIndex(surv_rows, surv_ids, device="cpu", **kw)
    d_f, i_f, _ = fresh.search_certified(qs)
    np.testing.assert_array_equal(d_f, d_ref)
    np.testing.assert_array_equal(i_f, i_ref)


def test_write_contract_refusals(clustered):
    rows, _ = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, train_iters=2, seed=0,
                   device="cpu")
    extra = rows[:2] + 1.0
    idx.insert(extra, [9000, 9001])
    with pytest.raises(ValueError, match="already live"):
        idx.insert(extra[:1], [9000])
    idx.delete([9000])
    with pytest.raises(ValueError, match="compact"):
        idx.insert(extra[:1], [9000])
    with pytest.raises(KeyError):
        idx.delete([424242])
    small = IVFIndex(rows[:8], k=K, ncentroids=2, train_iters=1, seed=0,
                     device="cpu")
    with pytest.raises(MutationBudgetError):
        small.delete(list(range(4)))  # would leave live < k
    with pytest.raises(ValueError, match="l2"):
        IVFIndex(rows, k=K, metric="cosine", device="cpu")


def test_index_stats_match_jax(clustered, pair):
    """The keys, ``drift`` among them, and the values; the drift sketches
    of two fresh indexes that served the same queries are equal (counts
    exactly, PSI within 1e-12 relative)."""
    rows, qs = clustered
    port, ref = pair
    st_p, st_j = port.stats(), ref.stats()
    assert set(st_p) - {"last_compaction_error"} == set(st_j)
    assert "drift" in st_p
    for key in ("ncentroids", "nprobe", "train_iters", "seed", "base_rows",
                "tail_rows", "tombstones", "live_rows", "metric"):
        assert st_p[key] == st_j[key], key
    kw = dict(k=K, ncentroids=NCLUSTERS, nprobe=2, train_iters=2, seed=0)
    fresh = (IVFIndex(rows, device="cpu", **kw),
             JaxIVFIndex(rows, mesh=make_mesh(1, 1), **kw))
    for block in (qs[:5], qs[5:] * 3.0):
        for idx in fresh:
            idx.search_certified(block)
    dr_p, dr_j = (idx.stats()["drift"] for idx in fresh)
    assert set(dr_p) == set(dr_j)
    for key, value in dr_j.items():
        assert dr_p[key] == pytest.approx(value, rel=1e-12, abs=0), key
    assert dr_p["queries_observed"] == qs.shape[0]
    defaults = IVFIndex(clustered[0], k=K, device="cpu").stats()
    ref_defaults = JaxIVFIndex(clustered[0], mesh=make_mesh(1, 1),
                               k=K).stats()
    for key in ("ncentroids", "nprobe", "train_iters", "seed"):
        assert defaults[key] == ref_defaults[key], key


def test_concurrent_reads_during_writes(clustered):
    """Snapshot isolation: readers racing writes and a compaction always
    see a consistent corpus."""
    rows, qs = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, nprobe=2,
                   train_iters=2, seed=0, device="cpu")
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                d_i, i_i, _ = idx.search_certified(qs[:4])
                assert d_i.shape == (4, K) and (i_i >= 0).all()
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    n0 = rows.shape[0]
    for b in range(4):
        idx.insert(rows[:5] + np.float32(b + 1),
                   np.arange(n0 + 5 * b, n0 + 5 * (b + 1)))
    idx.compact()
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_compactor_records_its_error_and_close_reraises(clustered,
                                                        monkeypatch):
    import time

    rows, _ = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, train_iters=1, seed=0,
                   compact_tail_rows=1, device="cpu")

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(idx, "compact", broken)
    idx.start_compactor(interval_s=0.01)
    idx.insert(rows[:1] + 1.0, [9000])
    deadline = time.monotonic() + 30
    while idx.stats()["last_compaction_error"] is None:
        assert time.monotonic() < deadline, "the error was never recorded"
        time.sleep(0.02)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        idx.close()


def test_close_waits_out_a_long_failing_compaction_and_reraises(
        clustered, monkeypatch):
    """close() during a background compaction that outlasts 10 s (a
    re-clustering of a real corpus can) and then fails waits for it and
    re-raises its error: the fault is never recorded after close() has
    returned."""
    import time

    rows, _ = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, train_iters=1, seed=0,
                   compact_tail_rows=1, device="cpu")
    started = threading.Event()

    def slow_broken():
        started.set()
        time.sleep(10.5)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(idx, "compact", slow_broken)
    idx.start_compactor(interval_s=0.01)
    idx.insert(rows[:1] + 1.0, [9000])
    assert started.wait(30), "the compaction never started"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        idx.close()
    assert time.monotonic() - t0 > 5
    assert not idx.stats()["compactor_alive"]


def test_compactor_restarts_after_close(clustered):
    import time

    rows, _ = clustered
    idx = IVFIndex(rows, k=K, ncentroids=NCLUSTERS, train_iters=1, seed=0,
                   compact_tail_rows=1, device="cpu")
    idx.start_compactor(interval_s=0.01)
    idx.close()
    assert not idx.stats()["compactor_alive"]
    idx.start_compactor(interval_s=0.01)
    assert idx.stats()["compactor_alive"]
    idx.insert(rows[:1] + 1.0, [9000])
    deadline = time.monotonic() + 30
    while idx.stats()["compactions"] < 1:
        assert time.monotonic() < deadline, "the restarted compactor idles"
        time.sleep(0.02)
    idx.close()
    assert idx.stats()["last_compaction_error"] is None


# -- refine_shared_exact and the autotuner -----------------------------------
def test_refine_shared_exact_bitwise_jax(clustered):
    rows, qs = clustered
    pos = np.random.default_rng(5).permutation(rows.shape[0])[:200]
    got = refine_shared_exact(rows, qs, pos, 7)
    want = jax_refine_shared(rows, qs, pos, 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 100, 5000, 100000, 1_000_000])
def test_ivf_grid_equals_jax(n):
    grid = tuning.ivf_grid(n)
    assert grid == jax_tuning.ivf_grid(n)
    for cc in {c["ncentroids"] for c in grid}:
        assert {"ncentroids": cc, "nprobe": cc} in grid
    assert [tuning.ivf_label(c) for c in grid] == [
        jax_ivf_label(c) for c in grid]


def test_autotune_ivf_gates_a_broken_candidate_out(clustered, monkeypatch):
    """Every sound candidate passes the bitwise gate against float64 brute
    force; one whose answer is corrupted is gated out and cannot win."""
    rows, qs = clustered
    real = IVFIndex.search_certified

    def corrupt_at_nprobe_2(self, queries, **kw):
        d, i, st = real(self, queries, **kw)
        if kw.get("nprobe") == 2:
            i = i.copy()
            i[0, [0, 1]] = i[0, [1, 0]]
        return d, i, st

    monkeypatch.setattr(IVFIndex, "search_certified", corrupt_at_nprobe_2)
    grid = [{"ncentroids": NCLUSTERS, "nprobe": p} for p in (1, 2,
                                                             NCLUSTERS)]
    entry = tuning.autotune_ivf(rows, qs, K, runs=1, grid=grid,
                                train_iters=2, seed=0, device="cpu")
    assert entry["gate"] == "bitwise-vs-reference"
    label = f"c{NCLUSTERS}p2"
    assert entry["timings_ms"][label] is None
    assert entry["errors"][label] == "bitwise gate: result != reference"
    assert entry["winner"] != label
    assert entry["timings_ms"][entry["winner"]] is not None
    assert entry["stats_per_candidate"][
        f"c{NCLUSTERS}p{NCLUSTERS}"]["probe_fraction"] == 1.0
    assert entry["backend"] == "cpu"
