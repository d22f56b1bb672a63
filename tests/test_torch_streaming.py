"""The port's resumable streaming (knn_tpu_torch.streaming) against the
JAX package's (knn_tpu.streaming on make_mesh(1, 1)) on the same seeded
inputs, at the reference fixture's shape (300 x 12 rows, 70 queries).

Tolerances: neighbour indices equal the JAX streams' exactly.  The plain
stream's f32 distances agree within 64 eps_f32 (||q||^2 + max||t||^2) per
query; the certified stream's float64 distances (counted ``exact``
selector) within 1e-12 relative, its pallas-selector f32 distances within
RANK_SLACK relative (the tolerances of the direct searches).  Against the
port's own direct ``search`` / ``search_certified`` a stream — resumed or
not — is BITWISE, distances, indices and summed stats.
"""

import json
import os

import numpy as np
import pytest

from knn_tpu.parallel import make_mesh
from knn_tpu.parallel import sharded as jax_sharded
from knn_tpu import streaming as jax_streaming
from knn_tpu_torch import ShardedKNN
from knn_tpu_torch import streaming
from knn_tpu_torch.ops.coarse_knn import RANK_SLACK
from knn_tpu_torch.streaming import (StreamingCertifiedSearch,
                                     StreamingSearch, _fingerprint,
                                     streaming_certified_knn, streaming_knn)

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(300, 12)).astype(np.float32)
    queries = rng.normal(size=(70, 12)).astype(np.float32)
    return db, queries


@pytest.fixture
def no_wait(monkeypatch):
    """Retries without their backoff sleeps, on both sides."""
    monkeypatch.setattr(streaming, "_RETRY_WAIT_S", 0.0)
    monkeypatch.setattr(jax_sharded, "_retry_wait", lambda attempt: None)


def _tol(q, db):
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    return 64 * EPS32 * ((q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max())


def _direct(db, q, k):
    d, i = ShardedKNN(db, k=k, device="cpu").search(q)
    return d.numpy(), i.numpy()


# -- the plain stream --------------------------------------------------------
@pytest.mark.parametrize("batch_size", [16, 70, 128])
def test_streaming_knn_matches_jax_and_the_direct_search(tmp_path, data,
                                                        batch_size):
    db, queries = data
    d, i = streaming_knn(db, queries, 5, str(tmp_path / "p"),
                         batch_size=batch_size, device="cpu")
    jd, ji = jax_streaming.streaming_knn(
        db, queries, 5, str(tmp_path / "j"), mesh=make_mesh(1, 1),
        batch_size=batch_size)
    np.testing.assert_array_equal(i, ji)
    assert (np.abs(d - jd) <= _tol(queries, db)[:, None]).all()
    # bitwise each padded batch's direct search
    prog = ShardedKNN(db, k=5, device="cpu")
    for lo in range(0, 70, batch_size):
        chunk = queries[lo:lo + batch_size]
        pad = np.zeros((batch_size, 12), np.float32)
        pad[:chunk.shape[0]] = chunk
        dd, ii = (t.numpy()[:chunk.shape[0]] for t in prog.search(pad))
        np.testing.assert_array_equal(d[lo:lo + batch_size], dd)
        np.testing.assert_array_equal(i[lo:lo + batch_size], ii)


def test_resume_runs_only_the_missing_batches(tmp_path, data):
    db, queries = data
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def flaky(chunk):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt  # a preemption: never retried
        return _direct(db, chunk, 5)

    stream = StreamingSearch(flaky, 5, ckpt, batch_size=16, max_retries=0)
    with pytest.raises(KeyboardInterrupt):
        stream.run(queries)
    st = stream.state(queries.shape[0])
    assert st.done == [0, 1] and not st.complete and st.n_batches == 5
    healthy = []

    def ok(chunk):
        healthy.append(chunk.shape[0])
        return _direct(db, chunk, 5)

    d, i = StreamingSearch(ok, 5, ckpt, batch_size=16).run(queries)
    assert healthy == [16, 16, 16]  # batches 2-4, the tail padded to 16
    want = StreamingSearch(ok, 5, str(tmp_path / "c"),
                           batch_size=16).run(queries)
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(i, want[1])
    assert sorted(os.listdir(ckpt)) == [
        "batch_000000.npz", "batch_000001.npz", "batch_000002.npz",
        "batch_000003.npz", "batch_000004.npz", "manifest.json"]


def test_a_stream_takes_tensor_outputs(tmp_path, data):
    db, queries = data
    prog = ShardedKNN(db, k=4, device="cpu")
    d, i = StreamingSearch(prog.search, 4, str(tmp_path / "t"),
                           batch_size=32).run(queries)
    assert isinstance(d, np.ndarray) and i.dtype == np.int64
    np.testing.assert_array_equal(i, prog.search(queries)[1].numpy())


# -- the retry rules -----------------------------------------------------------
def _attempts(cls, error, fails, tmp_path, data, max_retries=2):
    """(attempts made, outcome) of a stream whose fn raises ``error`` on
    its first ``fails`` calls."""
    db, queries = data
    n = {"calls": 0}

    def fn(chunk):
        n["calls"] += 1
        if n["calls"] <= fails:
            raise error
        return _direct(db, chunk, 4)

    stream = cls(fn, 4, str(tmp_path / f"r{id(error)}{cls.__module__}"),
                 batch_size=70, max_retries=max_retries)
    try:
        stream.run(queries)
        outcome = "ok"
    except Exception as e:  # noqa: BLE001 - the outcome is the point
        outcome = f"{type(e).__name__}: {e}"
    return n["calls"], outcome


@pytest.mark.parametrize("error,fails", [
    (RuntimeError("UNAVAILABLE: simulated device loss"), 2),
    (RuntimeError("UNAVAILABLE: simulated device loss"), 5),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), 5),
    (RuntimeError("dead device"), 5),
    (RuntimeError("flaky once"), 1),
    (ValueError("bad input"), 5),
    (OSError("connection reset"), 1)])
def test_retry_rules_equal_the_jax_classifier(tmp_path, data, no_wait,
                                              error, fails):
    port = _attempts(StreamingSearch, error, fails, tmp_path, data)
    jax = _attempts(jax_streaming.StreamingSearch, error, fails, tmp_path,
                    data)
    assert port == jax


def test_exhausted_and_repeated_failures_raise_as_jax(tmp_path, data,
                                                      no_wait):
    calls, outcome = _attempts(StreamingSearch, RuntimeError("dead device"),
                               5, tmp_path, data, max_retries=1)
    assert calls == 2 and "identical error repeated" in outcome
    calls, outcome = _attempts(
        StreamingSearch, RuntimeError("UNAVAILABLE: x"), 5, tmp_path, data,
        max_retries=1)
    assert calls == 2 and "after 2 attempts" in outcome


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: UNAVAILABLE"),  # device wins over transient
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
])
def test_a_cuda_error_raises_on_its_first_occurrence(tmp_path, data,
                                                     no_wait, error):
    """Divergence: the reference would retry an unknown or transient
    text; the port never retries a CUDA error (ROADMAP queue C)."""
    for cls in (StreamingSearch, StreamingCertifiedSearch):
        calls, outcome = _attempts(cls, error, 5, tmp_path, data)
        assert calls == 1 and outcome == f"RuntimeError: {error}"


def test_torch_device_error_classes_are_device_errors():
    import torch

    assert streaming._classify_failure(
        torch.cuda.OutOfMemoryError("x")) == "device"
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert streaming._classify_failure(accel("boom")) == "device"
    assert streaming._classify_failure(RuntimeError("aborted")) == \
        jax_sharded._classify_failure(RuntimeError("aborted")) == "transient"


# -- manifest refusals -----------------------------------------------------------
def test_the_manifest_refuses_another_run(tmp_path, data):
    db, queries = data
    ckpt = str(tmp_path / "ckpt")
    streaming_knn(db, queries, 5, ckpt, batch_size=16, device="cpu")
    for kw in (dict(k=7), dict(db=db + 1.0), dict(queries=queries + 0.5),
               dict(metric="cosine"), dict(batch_size=32),
               dict(train_tile=64)):
        args = dict(db=db, queries=queries, k=5, batch_size=16)
        args.update(kw)
        with pytest.raises(ValueError, match="different run"):
            streaming_knn(args.pop("db"), args.pop("queries"),
                          args.pop("k"), ckpt, device="cpu", **args)
    with open(os.path.join(ckpt, "manifest.json")) as f:
        man = json.load(f)
    assert man["search_config"]["device"] == "cpu"
    assert set(man) == {"n_queries", "query_fingerprint", "batch_size", "k",
                        "db_fingerprint", "search_config"}


def test_incomplete_assemble_raises(tmp_path, data):
    db, queries = data
    stream = StreamingSearch(lambda c: _direct(db, c, 3), 3,
                             str(tmp_path / "c"), batch_size=16)
    with pytest.raises(RuntimeError, match="incomplete"):
        stream.assemble(queries.shape[0])


def test_fingerprint_equals_the_reference(data):
    db, queries = data
    assert _fingerprint(db) == jax_streaming._fingerprint(db)
    assert _fingerprint(queries) == jax_streaming._fingerprint(queries)
    assert _fingerprint(db) != _fingerprint(db + 1e-3)


def test_entries_take_no_mesh(tmp_path, data):
    """The entries take ``mesh`` and ``merge`` (divergence 32 closed): with
    ``device`` as well they raise, as ``ShardedKNN`` does, and on a
    logical (2, 2) mesh each stream is bitwise the direct search of a
    placement on that mesh."""
    from knn_tpu_torch.parallel.mesh import make_mesh as port_mesh

    db, queries = data
    with pytest.raises(ValueError, match="not both"):
        streaming_knn(db, queries, 3, str(tmp_path / "m"),
                      mesh=port_mesh(1, 2, devices=["cpu"] * 2),
                      device="cpu")
    with pytest.raises(ValueError, match="not both"):
        streaming_certified_knn(db, queries, 3, str(tmp_path / "c"),
                                merge="ring", device="cpu",
                                mesh=port_mesh(1, 2, devices=["cpu"] * 2))
    mesh = port_mesh(2, 2, devices=["cpu"] * 4)
    direct = ShardedKNN(db, k=3, mesh=mesh, merge="ring")
    d, i = streaming_knn(db, queries, 3, str(tmp_path / "s"), mesh=mesh,
                         merge="ring", batch_size=32)
    want = [direct.search(np.pad(queries[lo:lo + 32],
                                 ((0, max(0, lo + 32 - 70)), (0, 0))))
            for lo in range(0, 70, 32)]
    np.testing.assert_array_equal(
        d, np.concatenate([w[0].numpy() for w in want])[:70])
    np.testing.assert_array_equal(
        i, np.concatenate([w[1].numpy() for w in want])[:70])
    cd, ci, st = streaming_certified_knn(
        db, queries, 3, str(tmp_path / "p"), mesh=mesh, merge="ring",
        segment_size=32)
    rd, ri, _ = direct.search_certified(queries)
    np.testing.assert_array_equal(ci, ri)
    np.testing.assert_array_equal(cd, rd)
    with open(os.path.join(str(tmp_path / "p"), "manifest.json")) as f:
        assert json.load(f)["search_config"]["merge"] == "ring"


# -- the certified stream -------------------------------------------------------
def test_certified_stream_exact_selector_matches_jax(tmp_path, data):
    db, queries = data
    d, i, st = streaming_certified_knn(
        db, queries, 5, str(tmp_path / "p"), segment_size=16,
        selector="exact", device="cpu")
    jd, ji, jst = jax_streaming.streaming_certified_knn(
        db, queries, 5, str(tmp_path / "j"), mesh=make_mesh(1, 1),
        segment_size=16, selector="exact")
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-12, atol=0)
    assert st["certified"] + st["fallback_queries"] == 70
    assert st["certified"] == jst["certified"]


def test_certified_stream_pallas_matches_jax_and_is_the_direct_search(
        tmp_path, data):
    db, queries = data
    d, i, st = streaming_certified_knn(
        db, queries, 5, str(tmp_path / "p"), segment_size=16, margin=8,
        device="cpu")
    jd, ji, _ = jax_streaming.streaming_certified_knn(
        db, queries, 5, str(tmp_path / "j"), mesh=make_mesh(1, 1),
        segment_size=16, selector="pallas", margin=8)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=RANK_SLACK, atol=0)
    rd, ri, rst = ShardedKNN(db, k=5, device="cpu").search_certified(
        queries, margin=8)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)
    assert st["certified"] + st["fallback_queries"] == 70
    assert st["fallback_queries"] == rst["fallback_queries"]


def test_certified_stream_resumes_bitwise(tmp_path, data):
    db, queries = data
    prog = ShardedKNN(db, k=5, device="cpu")

    def certified(chunk):
        return prog.search_certified(chunk, margin=8)

    ctl = StreamingCertifiedSearch(certified, 5, str(tmp_path / "ctl"),
                                   batch_size=16,
                                   db_fingerprint=_fingerprint(db))
    cd, ci, cstats = ctl.run(queries)
    calls = []

    def dying(chunk):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return certified(chunk)

    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(KeyboardInterrupt):
        StreamingCertifiedSearch(dying, 5, ckpt, batch_size=16,
                                 db_fingerprint=_fingerprint(db),
                                 max_retries=0).run(queries)
    resumed = []

    def healthy(chunk):
        resumed.append(chunk.shape[0])
        return certified(chunk)

    d, i, stats = StreamingCertifiedSearch(
        healthy, 5, ckpt, batch_size=16,
        db_fingerprint=_fingerprint(db)).run(queries)
    assert resumed == [16, 16, 6]  # segments 2-4, the tail unpadded
    np.testing.assert_array_equal(i, ci)
    np.testing.assert_array_equal(d, cd)
    assert stats == cstats


def test_certified_stream_without_distances_and_knob_refusal(tmp_path, data):
    db, queries = data
    ckpt = str(tmp_path / "c")
    d, i, stats = streaming_certified_knn(
        db, queries, 5, ckpt, segment_size=32, margin=8,
        return_distances=False, device="cpu")
    assert d is None and "fallback_queries" in stats
    np.testing.assert_array_equal(i, ShardedKNN(db, k=5, device="cpu")
                                  .search_certified(queries, margin=8)[1])
    for kw in (dict(selector="exact"), dict(margin=12),
               dict(precision="int8")):
        args = dict(segment_size=32, margin=8, return_distances=False)
        args.update(kw)
        with pytest.raises(ValueError, match="different run"):
            streaming_certified_knn(db, queries, 5, ckpt, device="cpu",
                                    **args)
