"""The port's MutableIndex (knn_tpu_torch.index) against the JAX package's
(knn_tpu.index on make_mesh(1, 1), Pallas in interpret mode) and a float64
oracle, at the reference fixture's shape (1,500 x 12, k=5, reserve 4).

Tolerances: ``search_certified`` is BITWISE the JAX index's and a fresh
port index of the surviving rows (each side refines a certified-exact
candidate set per pair in float64 with the same numpy arithmetic, and
merges in the same lexicographic order); against the independent float64
oracle the indices are equal and the distances within 1e-12 relative.
``search`` carries f32 values: its indices equal the oracle's, its
distances the JAX index's within 64 eps_f32 (||q||^2 + max||t||^2).
"""

import threading
import time

import numpy as np
import pytest

from knn_tpu.index.artifact import MutationBudgetError as JaxBudgetError
from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch.cli import main as cli_main
from knn_tpu_torch.index import (MutableIndex, MutationBudgetError,
                                 MutationUnsupportedError)

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

DIM = 12
K = 5
EPS32 = float(np.finfo(np.float32).eps)


def _f64_oracle(rows, ids, q, k=K):
    d = ((rows.astype(np.float64)[None]
          - q.astype(np.float64)[:, None]) ** 2).sum(-1)
    pos = np.broadcast_to(np.arange(rows.shape[0]), d.shape)
    o = np.lexsort((pos, d), axis=-1)[:, :k]
    return np.take_along_axis(d, o, -1), ids[o]


def _mutate(idx, new):
    idx.insert(new[:4], np.arange(9000, 9004))
    idx.insert(new[4:], np.arange(9004, 9006))
    idx.delete([3, 250, 1499])
    return idx


@pytest.fixture(scope="module")
def scenario():
    """The reference fixture's mutated index, built once on each side,
    and the port's fresh index of the surviving rows."""
    rng = np.random.default_rng(7)
    db = rng.normal(size=(1500, DIM)).astype(np.float32) * 20
    q = rng.normal(size=(9, DIM)).astype(np.float32) * 20
    new = rng.normal(size=(6, DIM)).astype(np.float32) * 20
    mesh = make_mesh(1, 1)
    surv = np.ones(1500, bool)
    surv[[3, 250, 1499]] = False
    rows = np.concatenate([db[surv], new])
    ids = np.concatenate([np.arange(1500)[surv], np.arange(9000, 9006)])
    return {
        "port": _mutate(MutableIndex(db, k=K, reserve=4, device="cpu"), new),
        "jax": _mutate(JaxMutableIndex(db, mesh=mesh, k=K, reserve=4), new),
        "fresh": MutableIndex(rows, ids, k=K, reserve=4, device="cpu"),
        "q": q, "db": db, "new": new, "rows": rows, "ids": ids,
        "mesh": mesh}


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- the mutation oracle, against the JAX package ---------------------------
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "int8"])
@pytest.mark.parametrize("kernel", ["tiled", "streaming", "fused"])
def test_mutation_oracle_bitwise_pallas(scenario, precision, kernel):
    kw = dict(selector="pallas", margin=8, tile_n=256, precision=precision,
              kernel=kernel)
    d_p, i_p, st = scenario["port"].search_certified(scenario["q"], **kw)
    d_j, i_j, _ = scenario["jax"].search_certified(scenario["q"], **kw)
    d_f, i_f, _ = scenario["fresh"].search_certified(scenario["q"], **kw)
    _assert_bitwise((d_p, i_p), (d_j, i_j))
    _assert_bitwise((d_p, i_p), (d_f, i_f))
    assert st["index"] == {"epoch": 0, "k_eff": K + 4, "tail_rows": 6,
                           "tombstones": 3, "tail_certified": "host_f64"}
    od, oi = _f64_oracle(scenario["rows"], scenario["ids"], scenario["q"])
    np.testing.assert_array_equal(i_p, oi)
    np.testing.assert_allclose(d_p, od, rtol=1e-12)


@pytest.mark.parametrize("selector", ["approx", "exact"])
def test_mutation_oracle_bitwise_counted(scenario, selector):
    d_p, i_p, _ = scenario["port"].search_certified(scenario["q"],
                                                    selector=selector)
    d_j, i_j, _ = scenario["jax"].search_certified(scenario["q"],
                                                   selector=selector)
    d_f, i_f, _ = scenario["fresh"].search_certified(scenario["q"],
                                                     selector=selector)
    _assert_bitwise((d_p, i_p), (d_j, i_j))
    _assert_bitwise((d_p, i_p), (d_f, i_f))


def test_default_selector_is_pallas_with_the_same_answer(scenario):
    """ROADMAP divergence 5: the port's default selector is "pallas", the
    JAX package's "approx"; the final (d, ids) are the same."""
    d_p, i_p, st = scenario["port"].search_certified(scenario["q"])
    d_j, i_j, _ = scenario["jax"].search_certified(scenario["q"])
    _assert_bitwise((d_p, i_p), (d_j, i_j))
    assert "pallas_knobs" in st


def test_step_timings_cover_the_call(scenario):
    """``timings=`` splits the call into its steps, the tail's float64
    scan among them, and leaves the answer as it was."""
    timings = {}
    got = scenario["port"].search_certified(scenario["q"], timings=timings)
    _assert_bitwise(got[:2], scenario["port"].search_certified(
        scenario["q"])[:2])
    assert set(timings) == {"main_certified", "main_refine", "tail_refine",
                            "merge", "other"}
    assert all(v >= 0 for v in timings.values())
    assert timings["main_certified"] > 0 and timings["tail_refine"] > 0


def test_oracle_survives_compaction_and_carryover(scenario):
    """Compact mid-stream, keep mutating: bitwise the JAX index after the
    same writes, and a fresh port index of the survivors."""
    rng = np.random.default_rng(11)
    extra = rng.normal(size=(2, DIM)).astype(np.float32) * 20
    sides = {"port": MutableIndex(scenario["db"], k=K, reserve=4,
                                  device="cpu"),
             "jax": JaxMutableIndex(scenario["db"], mesh=scenario["mesh"],
                                    k=K, reserve=4)}
    reports = {}
    for name, idx in sides.items():
        idx.insert(scenario["new"], np.arange(9000, 9006))
        idx.delete([3, 250])
        reports[name] = idx.compact()
        idx.insert(extra, [9100, 9101])
        idx.delete([1499, 9001])
    for key in ("epoch", "rows", "rows_dropped", "tail_rows_merged",
                "carry_tail_rows", "carry_tombstones"):
        assert reports["port"][key] == reports["jax"][key], key
    surv0 = np.ones(1500, bool)
    surv0[[3, 250, 1499]] = False
    keep_new = np.ones(6, bool)
    keep_new[1] = False  # id 9001
    rows = np.concatenate([scenario["db"][surv0],
                           scenario["new"][keep_new], extra])
    ids = np.concatenate([np.arange(1500)[surv0],
                          np.arange(9000, 9006)[keep_new], [9100, 9101]])
    fresh = MutableIndex(rows, ids, k=K, reserve=4, device="cpu")
    for kw in (dict(selector="approx"),
               dict(selector="pallas", margin=8, tile_n=256,
                    kernel="streaming")):
        got = sides["port"].search_certified(scenario["q"], **kw)
        _assert_bitwise(got, sides["jax"].search_certified(scenario["q"],
                                                           **kw))
        _assert_bitwise(got, fresh.search_certified(scenario["q"], **kw))
    assert sides["port"].stats()["epoch"] == 1


# -- search (f32 values) -----------------------------------------------------
def test_search_matches_jax_and_oracle(scenario):
    q = scenario["q"]
    d_p, i_p = scenario["port"].search(q)
    d_j, i_j = scenario["jax"].search(q)
    _, oi = _f64_oracle(scenario["rows"], scenario["ids"], q)
    np.testing.assert_array_equal(i_p, oi)
    np.testing.assert_array_equal(i_p, i_j)
    scale = ((q.astype(np.float64) ** 2).sum(-1)
             + (scenario["rows"].astype(np.float64) ** 2).sum(-1).max())
    assert (np.abs(d_p - np.asarray(d_j)) <= 64 * EPS32 * scale[:, None]).all()
    d3, i3 = scenario["port"].search(q, k=3, return_sqrt=True)
    np.testing.assert_array_equal(i3, oi[:, :3])
    np.testing.assert_allclose(d3, np.sqrt(d_p[:, :3]), rtol=1e-6)
    with pytest.raises(ValueError, match="certify reserve"):
        scenario["port"].search(q, k=K + 1)


def test_tail_search_is_the_segment_program_at_its_rung(scenario):
    """The tail is placed at its ladder rung, its valid rows a runtime
    argument: a search returns the same tail rows whatever the rung."""
    snap = scenario["port"]._snapshot()
    dev = scenario["port"]._tail_device(snap)
    assert dev["capacity"] == 256 and dev["nv"] == 6
    d, pos = scenario["port"]._dispatch_tail(snap, scenario["q"]).fetch()
    assert d.shape == (9, K + 4)
    # six valid tail rows: the rest of the k + reserve slots are sentinels
    assert (pos[:, :6] >= 1500).all() and (pos[:, :6] < 1506).all()
    assert np.isinf(d[:, 6:]).all() and (pos[:, 6:] == 1 << 62).all()


def test_delete_mask_certified_soundness():
    """Deleting the nearest neighbors promotes exactly the next live rows,
    certified, never a tombstoned id; search masks identically."""
    rng = np.random.default_rng(0)
    db = rng.normal(size=(600, DIM)).astype(np.float32) * 10
    q = rng.normal(size=(7, DIM)).astype(np.float32) * 10
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    _, i0, _ = idx.search_certified(q)
    dead = sorted({int(i0[r, 0]) for r in range(3)})
    idx.delete(dead)
    d, i, _ = idx.search_certified(q)
    assert not np.isin(i, np.asarray(dead)).any()
    surv = np.ones(600, bool)
    surv[dead] = False
    od, oi = _f64_oracle(db[surv], np.arange(600)[surv], q)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(d, od, rtol=1e-12)
    _, ip = idx.search(q)
    np.testing.assert_array_equal(ip, oi)


def test_epoch_visibility_and_write_then_read():
    rng = np.random.default_rng(1)
    db = rng.normal(size=(400, DIM)).astype(np.float32)
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    assert idx.epoch == 0
    idx.insert(q[:1], [7000])  # the query itself: its nearest row
    _, i = idx.search(q)
    assert i[0, 0] == 7000, "insert must be visible to the next search"
    idx.delete([7000])
    _, i = idx.search(q)
    assert not (i == 7000).any(), "delete must be visible immediately"
    idx.compact()
    assert idx.epoch == 1
    _, i2 = idx.search(q)
    np.testing.assert_array_equal(i, i2)
    st = idx.stats()
    assert st["tail_rows"] == 0 and st["tombstones"] == 0
    assert st["compactions"] == 1


# -- refusals and id rules, against the JAX package --------------------------
def _refusal_script(make, big):
    """The reference's budget / id-rule sequence; returns each step's
    (exception type name, message up to its first ';') or None."""
    db = np.random.default_rng(2).normal(size=(300, DIM)).astype(np.float32)
    idx = make(db)
    steps = [lambda: idx.insert(db[:1], [5]),
             lambda: idx.delete([12345]),
             lambda: idx.delete([0, 1, 2, 3]),
             lambda: idx.delete([4]),
             lambda: idx.insert(db[:1], [0]),
             lambda: idx.compact(),
             lambda: idx.insert(db[:1], [0]),
             lambda: idx.insert(big, np.arange(20000, 20128))]
    out = []
    for step in steps:
        try:
            step()
            out.append(None)
        except (ValueError, KeyError, RuntimeError) as e:
            out.append((type(e).__name__, str(e).split(";")[0]))
    return out


def test_budget_refusals_and_id_rules_match_jax():
    big = np.random.default_rng(3).normal(size=(128, DIM)).astype(np.float32)
    kw = dict(k=K, reserve=4, delta_min_rows=64, delta_max_rows=128)
    port = _refusal_script(
        lambda db: MutableIndex(db, device="cpu", **kw), big)
    ref = _refusal_script(
        lambda db: JaxMutableIndex(db, mesh=make_mesh(1, 1), **kw), big)
    assert port == ref
    assert [r and r[0] for r in port] == [
        "ValueError", "KeyError", None, "MutationBudgetError", "ValueError",
        None, None, "MutationBudgetError"]
    assert issubclass(MutationBudgetError, RuntimeError)
    assert MutationBudgetError.__name__ == JaxBudgetError.__name__


@pytest.mark.parametrize("metric", ["l1", "cosine", "dot"])
def test_metric_refusal(metric):
    db = np.zeros((50, DIM), np.float32)
    with pytest.raises(MutationUnsupportedError, match="l2"):
        MutableIndex(db, k=K, metric=metric, device="cpu")


@pytest.mark.parametrize("mode", ["on", "off"])
def test_stats_keys_are_the_reference_keys(mode):
    """Telemetry on and off in both packages: the same keys (the port adds
    ``last_compaction_error``, divergence 25) and values."""
    from knn_tpu import obs as jobs
    from knn_tpu_torch import obs as pobs

    db = np.random.default_rng(4).normal(size=(100, DIM)).astype(np.float32)
    try:
        for pkg in (jobs, pobs):
            pkg.reset(enabled=mode == "on")
        port = MutableIndex(db, k=K, device="cpu").stats()
        ref = JaxMutableIndex(db, mesh=make_mesh(1, 1), k=K).stats()
    finally:
        jobs.reset()
        pobs.reset()
    assert set(port) == set(ref) | {"last_compaction_error"}
    assert {key: port[key] for key in ref} == ref


# -- compaction: swaps, the compactor, its recorded error --------------------
def test_compaction_swap_atomicity_hammer():
    """8 reader threads against repeated swaps, the switch interval
    shortened: every result equals the mutation-free baseline."""
    import sys

    rng = np.random.default_rng(5)
    db = rng.normal(size=(500, DIM)).astype(np.float32) * 10
    q = rng.normal(size=(6, DIM)).astype(np.float32) * 10
    idx = MutableIndex(db, k=K, reserve=8, device="cpu")
    _, base_ids = idx.search(q)
    errors, mismatches = [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                _, i = idx.search(q)
                if not np.array_equal(i, base_ids):
                    mismatches.append(i)
            except Exception as e:  # noqa: BLE001 — the hammer's verdict
                errors.append(e)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(8)]
        for t in threads:
            t.start()
        for _ in range(4):
            idx.compact()  # no pending writes: results must not move
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    assert not mismatches, "a search observed a half-swapped state"
    assert idx.epoch == 4


def test_compactor_thresholds_fire():
    db = np.random.default_rng(6).normal(size=(300, DIM)).astype(np.float32)
    with MutableIndex(db, k=K, reserve=8, compact_tail_rows=4,
                      device="cpu") as idx:
        idx.start_compactor()
        idx.insert(np.random.default_rng(7).normal(
            size=(5, DIM)).astype(np.float32), np.arange(8000, 8005))
        deadline = time.monotonic() + 30
        while idx.stats()["compactions"] < 1:
            assert time.monotonic() < deadline, "compactor never fired"
            time.sleep(0.02)
        st = idx.stats()
        assert st["epoch"] >= 1 and st["rows"] == 305
        assert st["last_compaction_error"] is None


def test_compactor_records_its_error_and_close_reraises(monkeypatch):
    """A failing background compaction never vanishes: stats() reports
    it, the loop goes on, and close() re-raises it."""
    db = np.random.default_rng(8).normal(size=(300, DIM)).astype(np.float32)
    idx = MutableIndex(db, k=K, reserve=8, compact_tombstones=1,
                       device="cpu")

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(idx, "compact", broken)
    idx.start_compactor()
    idx.delete([0])
    deadline = time.monotonic() + 30
    while idx.stats()["last_compaction_error"] is None:
        assert time.monotonic() < deadline, "the error was never recorded"
        time.sleep(0.02)
    st = idx.stats()
    assert st["last_compaction_error"] == (
        "RuntimeError: CUDA error: an illegal memory access")
    assert st["compactor_alive"]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        idx.close()
    assert not idx.stats()["compactor_alive"]


def test_close_waits_out_a_long_failing_compaction_and_reraises(
        monkeypatch):
    """close() during a background compaction that outlasts 10 s and
    then fails waits for it and re-raises its error: the fault is never
    recorded after close() has returned."""
    db = np.random.default_rng(8).normal(size=(300, DIM)).astype(np.float32)
    idx = MutableIndex(db, k=K, reserve=8, compact_tombstones=1,
                       device="cpu")
    started = threading.Event()

    def slow_broken():
        started.set()
        time.sleep(10.5)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(idx, "compact", slow_broken)
    idx.start_compactor()
    idx.delete([0])
    assert started.wait(30), "the compaction never started"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        idx.close()
    assert time.monotonic() - t0 > 5
    assert not idx.stats()["compactor_alive"]


def test_compactor_restarts_after_close():
    db = np.random.default_rng(9).normal(size=(300, DIM)).astype(np.float32)
    idx = MutableIndex(db, k=K, reserve=8, compact_tail_rows=2,
                       device="cpu")
    idx.start_compactor()
    idx.close()
    assert not idx.stats()["compactor_alive"]
    idx.start_compactor()
    assert idx.stats()["compactor_alive"]
    idx.insert(np.ones((2, DIM), np.float32), [7000, 7001])
    deadline = time.monotonic() + 30
    while idx.stats()["compactions"] < 1:
        assert time.monotonic() < deadline, "the restarted compactor idles"
        time.sleep(0.02)
    idx.close()


# -- the CLI self-test --------------------------------------------------------
def test_cli_index_selftest(capsys):
    assert cli_main(["index", "--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"oracle_bitwise": true' in out
    assert '"post_compact_bitwise": true' in out
    # the status render reads a snapshot: an unreadable one exits 1
    assert cli_main(["index", "--snapshot", "missing-snapshot.json"]) == 1


def test_a_device_error_raises_at_once(monkeypatch):
    """No transient retry (ROADMAP queue C): an error inside the tail's
    segment program or a join block raises on its first occurrence."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.join import knn_join
    from knn_tpu_torch.parallel import sharded

    rng = np.random.default_rng(9)
    db = rng.normal(size=(300, DIM)).astype(np.float32)
    idx = MutableIndex(db, k=K, device="cpu")
    idx.insert(db[:2] + 1.0, [7000, 7001])
    knn = ShardedKNN(db, k=K, device="cpu")
    calls = []

    def fail(*a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(sharded, "knn_search_tiled", fail)
    for run in (lambda: idx.search(db[:3]),
                lambda: knn_join(knn, db[:40], superblock_rows=16)):
        calls.clear()
        with pytest.raises(RuntimeError, match="launch failure"):
            run()
        assert len(calls) == 1
