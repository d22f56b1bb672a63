"""The port's serving engine (knn_tpu_torch.serving) against the JAX
package's (knn_tpu.serving on make_mesh(1, 1)) on the same seeded inputs,
at the reference fixture's shape (400 x 12, k=7, buckets 8/16/32).

Tolerances: the bucket functions equal the reference's, errors included;
a bucketed result is BITWISE the port's own ``ShardedKNN.search`` of the
same padded batch (one program, pad rows sliced away); neighbour indices
equal the JAX engine's exactly, and its f32 distances agree within
64 eps_f32 (||q||^2 + max||t||^2) per query (the two frameworks sum in
different orders); per-bucket compile and dispatch counts, warmup counts
and the report keys (telemetry on and off) equal the JAX engine's.
"""

import numpy as np
import pytest
import torch

from knn_tpu import obs
from knn_tpu.parallel import ShardedKNN as JaxShardedKNN
from knn_tpu.parallel import make_mesh
from knn_tpu.serving import ServingEngine as JaxServingEngine
from knn_tpu.serving import buckets as jax_buckets
from knn_tpu_torch import ShardedKNN
from knn_tpu_torch.serving import ServingEngine, bucket_for, buckets

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

K = 7
DIM = 12
BUCKETS = (8, 16, 32)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _obs_off():
    """The JAX engine with telemetry off: the shape the port keeps."""
    obs.reset(enabled=False)
    yield
    obs.reset()


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(3)
    db = (rng.random((400, DIM)) * 10).astype(np.float32)
    q = (rng.random((40, DIM)) * 10).astype(np.float32)
    labels = rng.integers(0, 3, 400).astype(np.int32)
    prog = ShardedKNN(db, k=K, labels=labels, num_classes=3, device="cpu")
    jprog = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=K, labels=labels,
                          num_classes=3)
    return {"prog": prog, "jprog": jprog, "db": db, "q": q,
            "labels": labels}


def _padded(q, rows):
    out = np.zeros((rows, q.shape[1]), np.float32)
    out[: q.shape[0]] = q
    return out


def _direct_padded(prog, q, ladder=BUCKETS):
    """A direct search of ``q`` as the engine splits and pads it."""
    d, i = [], []
    for lo in range(0, q.shape[0], ladder[-1]):
        chunk = q[lo:lo + ladder[-1]]
        dd, ii = prog.search(_padded(chunk, bucket_for(ladder, chunk.shape[0])))
        d.append(dd.numpy()[: chunk.shape[0]])
        i.append(ii.numpy()[: chunk.shape[0]])
    return np.concatenate(d), np.concatenate(i)


def _tol(q, db):
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    return 64 * EPS32 * ((q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max())


# -- the ladder functions, against the reference --------------------------
def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - compared by type and text
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("lo,hi,growth", [
    (1, 1, 2.0), (8, 64, 2.0), (8, 100, 2.0), (5, 5, 2.0), (3, 1000, 1.5),
    (32, 4096, 2.0), (7, 7000, 3.3), (0, 8, 2.0), (16, 8, 2.0),
    (8, 64, 1.0), (2, 9, 1.01)])
def test_bucket_ladder_equals_the_reference(lo, hi, growth):
    assert _outcome(buckets.bucket_ladder, lo, hi, growth) == _outcome(
        jax_buckets.bucket_ladder, lo, hi, growth)


@pytest.mark.parametrize("spec", [
    None, "", "  ", "auto", "AUTO", "64, 8,16", "8,8,32", "8,x", ",", "0,8",
    [32, 8, 8], (4,), [], "-3,4"])
def test_parse_and_normalize_equal_the_reference(spec):
    assert _outcome(buckets.parse_buckets, spec) == _outcome(
        jax_buckets.parse_buckets, spec)
    if isinstance(spec, (list, tuple)):
        assert _outcome(buckets.normalize_ladder, spec) == _outcome(
            jax_buckets.normalize_ladder, spec)


@pytest.mark.parametrize("ladder", [BUCKETS, (5,), (1, 2, 3, 100)])
def test_bucket_for_and_split_sizes_equal_the_reference(ladder):
    for n in range(-1, 2 * ladder[-1] + 3):
        assert _outcome(bucket_for, ladder, n) == _outcome(
            jax_buckets.bucket_for, ladder, n), n
        assert _outcome(buckets.split_sizes, n, ladder[-1]) == _outcome(
            jax_buckets.split_sizes, n, ladder[-1]), n
    assert buckets.DEFAULT_MIN_BUCKET == jax_buckets.DEFAULT_MIN_BUCKET
    assert buckets.DEFAULT_MAX_BUCKET == jax_buckets.DEFAULT_MAX_BUCKET


# -- exactness -------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 40])
def test_bucketed_bitwise_the_padded_direct_search_and_jax_indices(
        served, n):
    prog, q = served["prog"], served["q"]
    eng = ServingEngine(prog, buckets=BUCKETS)
    d, i = eng.search(q[:n])
    de, ie = _direct_padded(prog, q[:n])
    np.testing.assert_array_equal(d, de)
    np.testing.assert_array_equal(i, ie)
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    jd, ji = jeng.search(q[:n])
    np.testing.assert_array_equal(i, ji)
    assert (np.abs(d - jd) <= _tol(q[:n], served["db"])[:, None]).all()


def test_tie_break_order_matches_jax():
    """Exact duplicate rows force (distance, index) ties into the top-k;
    the port's engine resolves them as the JAX engine does."""
    rng = np.random.default_rng(8)
    db = rng.integers(-3, 4, size=(200, DIM)).astype(np.float32)
    db[100:] = db[:100]
    q = db[:13] + 0.0
    eng = ServingEngine(ShardedKNN(db, k=K, device="cpu"), buckets=BUCKETS)
    jeng = JaxServingEngine(JaxShardedKNN(db, mesh=make_mesh(1, 1), k=K),
                            buckets=BUCKETS)
    np.testing.assert_array_equal(eng.search(q)[1], jeng.search(q)[1])


def test_counts_equal_the_jax_engine_on_one_trace(served):
    """A trace of 20 distinct sizes (two oversize): per-bucket compiles and
    dispatches, compile_count and executables equal the JAX engine's, and
    every result's indices equal its direct search's."""
    q = np.concatenate([served["q"], served["q"]])
    reqs = [q[:n] for n in list(range(1, 19)) + [45, 70]]
    eng = ServingEngine(served["prog"], buckets=BUCKETS)
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    res, rep = eng.replay(reqs, depth=2)
    jres, jrep = jeng.replay(reqs, depth=2)
    for key in ("per_bucket_compiles", "per_bucket_dispatches",
                "compile_count", "executables", "requests",
                "total_queries", "queries_total", "buckets", "depth"):
        assert rep[key] == jrep[key], key
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r[1], jr[1])
    assert rep["latency_ms"]["count"] == 20


@pytest.mark.parametrize("mode", ["on", "off"])
def test_replay_report_keys_are_the_reference_keys(served, mode):
    """The report's keys with telemetry on in both packages (the ``slo``
    and ``slowest_requests`` sections, their objectives and a slowest
    row's fields) and with it off in both."""
    from knn_tpu_torch import obs as pobs

    q = served["q"]
    reqs = [q[:n] for n in (3, 9, 17)]
    try:
        for pkg in (obs, pobs):
            pkg.reset(enabled=mode == "on")
            pkg.reset_slo_engine()
        _, rep = ServingEngine(served["prog"], buckets=BUCKETS).replay(reqs)
        _, jrep = JaxServingEngine(served["jprog"],
                                   buckets=BUCKETS).replay(reqs)
    finally:
        obs.reset(enabled=False)
        pobs.reset()
    assert set(rep) == set(jrep)
    assert ({"slo", "slowest_requests"} <= set(rep)) == (mode == "on")
    assert set(rep["latency_ms"]) == set(jrep["latency_ms"])
    # the tuner keys no profile (ROADMAP divergence 20)
    assert set(rep["tuning"]) == set(jrep["tuning"]) - {"profile"}
    if mode == "on":
        assert set(rep["slo"]) == set(jrep["slo"])
        assert set(rep["slo"]["objectives"]) == set(
            jrep["slo"]["objectives"])
        assert len(rep["slowest_requests"]) == len(
            jrep["slowest_requests"]) == 3
        assert [set(r) for r in rep["slowest_requests"]] == [
            set(r) for r in jrep["slowest_requests"]]


def test_warmup_counts_equal_jax_and_a_warmed_trace_builds_nothing(served):
    q = served["q"]
    eng = ServingEngine(served["prog"], buckets=BUCKETS)
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    assert eng.warmup() == jeng.warmup() == {"search": 3}
    assert eng.warmup(ops=("predict",)) == jeng.warmup(ops=("predict",))
    assert eng.warmed_ops == jeng.warmed_ops == {"search", "predict"}
    before = eng.stats()["compile_count"]
    eng.replay([q[:n] for n in (1, 5, 9, 17, 30)], depth=2)
    assert eng.stats()["compile_count"] == before == 6
    assert eng.stats()["executables"] == 6
    assert eng.cache_hits == 5


def test_predict_equals_sharded_predict_and_jax(served):
    prog, q = served["prog"], served["q"]
    eng = ServingEngine(prog, buckets=BUCKETS)
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    for n in (1, 9, 40):
        got = eng.predict(q[:n])
        np.testing.assert_array_equal(got, prog.predict(q[:n]).numpy())
        np.testing.assert_array_equal(got, jeng.predict(q[:n]))
        assert got.dtype == np.int32


def test_oversize_request_splits_like_jax(served):
    eng = ServingEngine(served["prog"], buckets=BUCKETS)
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    d, i = eng.search(served["q"])  # 40 = 32 + 8
    np.testing.assert_array_equal(i, jeng.search(served["q"])[1])
    assert eng.stats()["per_bucket_dispatches"] == {8: 1, 32: 1}
    assert d.shape == (40, K)


def test_engine_validates(served):
    prog, q = served["prog"], served["q"]
    eng = ServingEngine(prog, buckets=BUCKETS)
    with pytest.raises(ValueError, match="unknown op"):
        eng.submit(q[:3], op="nope")
    with pytest.raises(ValueError, match="incompatible"):
        eng.submit(q[:, :4])
    with pytest.raises(ValueError, match="depth"):
        eng.replay([q[:2]], depth=0)
    with pytest.raises(ValueError, match="unknown op"):
        eng.warmup(ops=("nope",))
    with pytest.raises(RuntimeError, match="labels"):
        ServingEngine(ShardedKNN(np.ones((64, DIM), np.float32), k=3,
                                 device="cpu"),
                      buckets=(8,)).warmup(ops=("predict",))
    with pytest.raises(ValueError, match="k="):
        ServingEngine(prog, k=401)
    assert eng.stats()["errors_total"] == 0


def test_cpu_engine_is_eager_and_donation_is_reported(served):
    eng = ServingEngine(served["prog"], buckets=BUCKETS)
    assert not eng.graphs and eng.graph_pool_bytes() is None
    assert eng.stats()["donate_queries"] is False
    jeng = JaxServingEngine(served["jprog"], buckets=BUCKETS)
    assert eng.stats()["donate_queries"] == jeng.stats()["donate_queries"]
    # divergence: donation is accepted, reported, and changes nothing
    d0 = ServingEngine(served["prog"], buckets=BUCKETS).search(served["q"])
    d1 = ServingEngine(served["prog"], buckets=BUCKETS,
                       donate_queries=True).search(served["q"])
    assert all(np.array_equal(a, b) for a, b in zip(d0, d1))


def test_aot_false_runs_the_same_program(served):
    a = ServingEngine(served["prog"], buckets=BUCKETS).search(served["q"])
    eager = ServingEngine(served["prog"], buckets=BUCKETS, aot=False)
    assert not eager.graphs
    b = eager.search(served["q"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot", "l1"])
def test_metric_matrix_equals_jax(metric):
    rng = np.random.default_rng(12)
    db = (rng.random((300, DIM)) * 10).astype(np.float32)
    q = (rng.random((11, DIM)) * 10).astype(np.float32)
    prog = ShardedKNN(db, k=5, metric=metric, device="cpu")
    jprog = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=5, metric=metric)
    eng = ServingEngine(prog, buckets=BUCKETS)
    d, i = eng.search(q)
    de, ie = _direct_padded(prog, q)
    np.testing.assert_array_equal(d, de)
    np.testing.assert_array_equal(i, ie)
    jd, ji = JaxServingEngine(jprog, buckets=BUCKETS).search(q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        prog.search_bucketed(q, buckets=BUCKETS)[1], ji)
    np.testing.assert_allclose(
        eng.search(q, return_sqrt=True)[0],
        jprog.search_bucketed(q, buckets=BUCKETS, return_sqrt=True)[0],
        rtol=1e-5, atol=1e-5)


def test_search_bucketed_and_compile_cache_stats(served):
    rng = np.random.default_rng(14)
    db = (rng.random((300, DIM)) * 10).astype(np.float32)
    q = (rng.random((9, DIM)) * 10).astype(np.float32)
    prog = ShardedKNN(db, k=K, device="cpu")
    jprog = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=K)
    d1, i1 = prog.search_bucketed(q, buckets=BUCKETS)
    d2, i2 = prog.search_bucketed(q, buckets=[32, 8, 16, 8])  # same engine
    assert np.array_equal(d1, d2) and np.array_equal(i1, i2)
    assert len(prog._serving_engines) == 1
    np.testing.assert_array_equal(i1, jprog.search_bucketed(
        q, buckets=BUCKETS)[1])
    prog.search(q)
    prog.search(q, k=3)
    jprog.search(q)
    jprog.search(q, k=3)
    st, jst = prog.compile_cache_stats(), jprog.compile_cache_stats()
    assert set(st) == set(jst)
    assert set(st["program_cache"]) == set(jst["program_cache"])
    for key in ("distinct_shapes", "dispatches", "shape_counts"):
        assert st[key] == jst[key], key
    assert st["program_cache"] == {"hits": 1, "misses": 1, "size": 1}
    assert st["serving_engines"][0]["per_bucket_dispatches"] == {16: 2}


def test_warmup_prebuilds_int8_placement_when_the_winner_says_so(
        served, empty_default_tune_cache):
    from knn_tpu_torch import tuning

    prog = ShardedKNN(served["db"], k=K, device="cpu")
    key = tuning.cache_key("cpu", prog.n_train, prog.placement.db.shape[1],
                           prog.k, "l2", None)
    tuning.TuneCache(empty_default_tune_cache).put(
        key, {"knobs": {**tuning.DEFAULT_KNOBS, "precision": "int8"}})
    try:
        eng = ServingEngine(prog, buckets=BUCKETS)
        assert "int8" not in prog._quant
        counts = eng.warmup()
        assert counts == {"search": 3, "int8_placement": 1}
        assert "int8" in prog._quant
        assert eng.stats()["tuning"]["source"] == "cache"
    finally:
        open(empty_default_tune_cache, "w").close()
    # without the winner: defaults, no placement built
    prog2 = ShardedKNN(served["db"], k=K, device="cpu")
    assert ServingEngine(prog2, buckets=BUCKETS).warmup() == {"search": 3}
    assert prog2._quant == {}


def test_latency_summary_equals_the_reference():
    from knn_tpu.serving.engine import latency_summary as jax_summary
    from knn_tpu_torch.serving import latency_summary

    rng = np.random.default_rng(15)
    vals = list(rng.random(37))
    pairs = [(float(t), float(v)) for t, v in zip(np.cumsum(vals), vals)]
    for samples in ([], vals, pairs):
        assert latency_summary(samples) == jax_summary(samples)


def test_engine_results_are_host_arrays_off_the_tensors(served):
    """The handle returns numpy arrays (int64 indices, the port's index
    dtype) and a second result() call returns the same objects."""
    eng = ServingEngine(served["prog"], buckets=BUCKETS)
    h = eng.submit(served["q"][:5])
    d, i = h.result()
    assert isinstance(d, np.ndarray) and i.dtype == np.int64
    assert h.result()[0] is d
    assert not isinstance(d, torch.Tensor)


# -- the job and the command line -------------------------------------------
def _job_files(tmp_path):
    from knn_tpu.data.datasets import (make_mnist_like, save_labeled_csv,
                                       save_unlabeled_csv)

    tr, trl, te, _, va, val = make_mnist_like(
        n_train=600, n_test=70, n_val=50, dim=24, noise=60.0, seed=4)
    files = {n: str(tmp_path / f"{n}.csv") for n in ("train", "test", "val")}
    save_labeled_csv(files["train"], tr, trl)
    save_unlabeled_csv(files["test"], te)
    save_labeled_csv(files["val"], va, val)
    return files


def test_job_serve_buckets_equals_jax_and_reports_serving(tmp_path):
    from knn_tpu.parallel.mesh import make_mesh as jax_mesh
    from knn_tpu.pipeline import run_job as jax_run_job
    from knn_tpu.utils.config import JobConfig as JaxJobConfig
    from knn_tpu_torch import JobConfig, run_job

    files = _job_files(tmp_path)
    common = dict(train_file=files["train"], test_file=files["test"],
                  val_file=files["val"], k=9, serve_buckets="8,32",
                  max_wait_ms=3.0, batch_size=40)
    jres = jax_run_job(JaxJobConfig(output_file=str(tmp_path / "j.csv"),
                                    **common), mesh=jax_mesh(1, 1))
    res = run_job(JobConfig(output_file=str(tmp_path / "p.csv"),
                            device="cpu", **common))
    plain = run_job(JobConfig(output_file=str(tmp_path / "q.csv"),
                              device="cpu",
                              **dict(common, serve_buckets=None)))
    np.testing.assert_array_equal(res.test_labels, jres.test_labels)
    np.testing.assert_array_equal(res.val_labels, jres.val_labels)
    np.testing.assert_array_equal(res.test_labels, plain.test_labels)
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()
    srv, jsrv = res.metrics()["serving"], jres.metrics()["serving"]
    for key in ("max_wait_ms", "buckets", "compile_count", "executables",
                "per_bucket_compiles", "per_bucket_dispatches",
                "requests_total", "queries_total"):
        assert srv[key] == jsrv[key], key
    assert srv["per_bucket_dispatches"] == {8: 2, 32: 4}  # 40 = 32 + 8
    assert "serving_warmup" in res.phase_times
    assert "serving" not in plain.metrics()


def test_job_config_serving_validation_equals_jax():
    from knn_tpu.utils.config import JobConfig as JaxJobConfig
    from knn_tpu_torch import JobConfig

    base = dict(validation=False)
    for kw in (dict(serve_buckets="auto"), dict(serve_buckets=""),
               dict(serve_buckets="8,x"), dict(max_wait_ms=-1.0),
               dict(serve_buckets="8", mode="certified"),
               dict(serve_buckets="0,4")):
        outs = []
        for cls in (JobConfig, JaxJobConfig):
            try:
                outs.append(("ok", cls(**base, **kw).serve_buckets))
            except ValueError as e:
                outs.append(("err", str(e)))
        assert outs[0] == outs[1], kw


def test_cli_job_serve_buckets(tmp_path):
    import json

    from knn_tpu_torch.cli import main

    files = _job_files(tmp_path)
    out = str(tmp_path / "metrics.json")
    assert main(["--train", files["train"], "--test", files["test"],
                 "--k", "5", "--serve-buckets", "16,64", "--max-wait-ms",
                 "4", "--out", str(tmp_path / "T.csv"), "--device", "cpu",
                 "--metrics-json", out]) == 0
    with open(out) as f:
        m = json.load(f)
    assert m["serving"]["buckets"] == [16, 64]
    assert m["serving"]["max_wait_ms"] == 4.0
    assert m["config"]["serve_buckets"] == "16,64"


def test_cli_loadgen_synthetic_and_refusals(tmp_path, capsys):
    import json

    from knn_tpu_torch.cli import main

    trace = str(tmp_path / "t.jsonl")
    assert main(["loadgen", "--synthetic", "2000", "--rates", "20,40",
                 "--duration", "0.2", "--save-trace", trace,
                 "--tenants", "gold:2,free:1:3", "--json"]) == 0
    block = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert validate_knee(block) == []
    assert [s["rate_qps"] for s in block["rate_steps"]] == [20.0, 40.0]
    assert main(["loadgen", "--synthetic", "2000", "--replay", trace,
                 "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["offered"] == sum(1 for _ in open(trace))
    assert main(["loadgen", "--synthetic", "100", "--quota", "bad"]) == 1
    with pytest.raises(SystemExit, match="cpu-devices"):
        main(["loadgen", "--synthetic", "100", "--cpu-devices", "8"])


def test_cli_loadgen_on_a_real_engine_on_the_cpu(capsys):
    import json

    from knn_tpu_torch.cli import main

    assert main(["loadgen", "--n", "500", "--dim", "8", "--k", "3",
                 "--rates", "30", "--duration", "0.3", "--max-depth", "64",
                 "--device", "cpu", "--json"]) == 0
    block = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert validate_knee(block) == []
    step = block["rate_steps"][0]
    assert step["errors"] == 0 and step["ok"] + step["rejected"] \
        + step["shed"] == step["offered"]


def validate_knee(block):
    from knn_tpu_torch.loadgen import validate_knee_block

    return validate_knee_block(block)
