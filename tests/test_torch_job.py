"""The port's classifier and reference job against the JAX package's, plus
the port's import and device rules.

Labels, accuracy and the bytes of Test_label.csv must be equal in exact
and certified (pallas) mode, on a small make_mnist_like set and on an
identical-rows tie fixture (the reference's running-argmax vote and the
lower-index tie-break both decide there).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from knn_tpu.data.datasets import make_mnist_like, save_labeled_csv, save_unlabeled_csv
from knn_tpu.models.classifier import KNNClassifier as JaxClassifier
from knn_tpu.ops.normalize import normalize_transductive as jax_normalize
from knn_tpu.ops.vote import majority_vote as jax_vote
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.pipeline import run_job as jax_run_job
from knn_tpu.utils.config import JobConfig as JaxJobConfig
from knn_tpu_torch import (JobConfig, KNNClassifier, KNNRegressor,
                           NearestNeighbors, RadiusNeighborsClassifier,
                           RadiusNeighborsRegressor, ShardedKNN, run_job)
from knn_tpu_torch.ops.normalize import normalize_transductive
from knn_tpu_torch.ops.topk import knn_search_tiled, topk_pairs
from knn_tpu_torch.ops.vote import majority_vote

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mnist(seed=0):
    return make_mnist_like(n_train=1200, n_test=120, n_val=120, dim=48,
                           noise=60.0, seed=seed)


def _tie_fixture():
    # every train vector appears three times with different labels; the
    # queries sit exactly on train vectors, so distance ties decide
    rng = np.random.default_rng(11)
    base = rng.normal(size=(60, 12)).astype(np.float32)
    X = np.concatenate([base, base, base])
    y = np.concatenate([np.zeros(60), np.ones(60), 2 * np.ones(60)]).astype(np.int32)
    y[::7] = 3
    return X, y, base[:25].copy()


@pytest.mark.parametrize("mode", ["exact", "certified"])
@pytest.mark.parametrize("data", ["mnist", "ties"])
def test_classifier_labels_match_jax(mode, data):
    if data == "mnist":
        X, y, Q, _, _, _ = _mnist()
        k, normalize = 15, True
    else:
        X, y, Q = _tie_fixture()
        k, normalize = 4, False
    jkw = {"mesh": make_mesh(1, 1), "selector": "pallas"} if mode == "certified" else {}
    jclf = JaxClassifier(k=k, normalize=normalize, mode=mode, **jkw).fit(X, y)
    clf = KNNClassifier(k=k, normalize=normalize, mode=mode,
                        device="cpu").fit(X, y)
    ref = np.asarray(jclf.predict(Q))
    np.testing.assert_array_equal(clf.predict(Q), ref)
    assert clf.score(Q, ref) == 1.0
    if data == "ties":
        # the reference's vote on the float64 lexicographic neighbors
        np.testing.assert_array_equal(
            ref, oracles.knn_classify(X, y, Q, k, int(y.max()) + 1))


@pytest.mark.parametrize("mode", ["exact", "certified"])
@pytest.mark.parametrize("data", ["mnist", "ties"])
def test_run_job_matches_jax(tmp_path, mode, data):
    if data == "mnist":
        tr, trl, te, _, va, val = _mnist(seed=1)
        k = 15
    else:
        tr, trl, te = _tie_fixture()
        va, val, k = te, np.arange(len(te), dtype=np.int32) % 4, 4
    files = {n: str(tmp_path / f"{n}.csv") for n in ("train", "test", "val")}
    save_labeled_csv(files["train"], tr, trl)
    save_unlabeled_csv(files["test"], te)
    save_labeled_csv(files["val"], va, val)
    common = dict(train_file=files["train"], test_file=files["test"],
                  val_file=files["val"], k=k, mode=mode, selector="pallas")
    jres = jax_run_job(JaxJobConfig(output_file=str(tmp_path / "jax.csv"),
                                    **common), mesh=make_mesh(1, 1))
    res = run_job(JobConfig(output_file=str(tmp_path / "port.csv"),
                            device="cpu", **common))
    np.testing.assert_array_equal(res.test_labels, jres.test_labels)
    np.testing.assert_array_equal(res.val_labels, jres.val_labels)
    assert res.val_accuracy == jres.val_accuracy
    with open(tmp_path / "jax.csv", "rb") as a, open(tmp_path / "port.csv", "rb") as b:
        assert a.read() == b.read()
    if mode == "certified":
        assert res.certified_stats["certified"] + \
            res.certified_stats["fallback_queries"] == len(te) + len(va)


def test_cli_job_on_cpu(tmp_path):
    from knn_tpu_torch.cli import main

    tr, trl, te, _, va, val = _mnist(seed=2)
    save_labeled_csv(str(tmp_path / "tr.csv"), tr, trl)
    save_unlabeled_csv(str(tmp_path / "te.csv"), te)
    out = str(tmp_path / "Test_label.csv")
    assert main(["--train", str(tmp_path / "tr.csv"), "--test",
                 str(tmp_path / "te.csv"), "--k", "9", "--mode", "certified",
                 "--selector", "pallas", "--out", out, "--device", "cpu"]) == 0
    labels = np.loadtxt(out, dtype=np.int64)
    assert labels.shape == (120,)


@pytest.mark.parametrize("flags", [
    ("--mode", "certified", "--selector", "exact"),
    ("--mode", "certified", "--selector", "approx"),
    ("--mode", "certified", "--selector", "exact", "--batch-size", "50"),
    ("--compute-dtype", "bfloat16"),
    ("--metric", "l1"),
    ("--metric", "dot"),
    ("--metric", "manhattan", "--train-tile", "256"),
    ("--mode", "certified", "--selector", "pallas", "--tune-cache", "CACHE"),
])
def test_cli_job_options_match_jax(tmp_path, flags):
    from knn_tpu.cli import args_to_config as jax_args_to_config
    from knn_tpu.cli import build_parser as jax_parser
    from knn_tpu_torch.cli import args_to_config, build_parser

    tr, trl, te, _, va, val = _mnist(seed=3)
    files = {n: str(tmp_path / f"{n}.csv") for n in ("train", "test", "val")}
    save_labeled_csv(files["train"], tr, trl)
    save_unlabeled_csv(files["test"], te)
    save_labeled_csv(files["val"], va, val)
    flags = [str(tmp_path / "tune.json") if f == "CACHE" else f
             for f in flags]
    argv = ["--train", files["train"], "--test", files["test"], "--val",
            files["val"], "--k", "11", *flags]
    jcfg = jax_args_to_config(jax_parser().parse_args(
        argv + ["--out", str(tmp_path / "jax.csv")]))
    jres = jax_run_job(jcfg, mesh=make_mesh(1, 1))
    cfg = args_to_config(build_parser().parse_args(
        argv + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"]))
    res = run_job(cfg)
    np.testing.assert_array_equal(res.val_labels, jres.val_labels)
    with open(tmp_path / "jax.csv", "rb") as a, open(tmp_path / "port.csv", "rb") as b:
        assert a.read() == b.read()
    assert cfg.compute_dtype == jcfg.compute_dtype
    assert cfg.tune_cache == jcfg.tune_cache


def test_certified_job_reads_only_its_tune_cache(tmp_path, monkeypatch):
    # a winner for the job's shape in the named file: the job's knobs come
    # from it, and no cache path but that one is opened, under HOME or
    # anywhere else
    from knn_tpu_torch import tuning
    from knn_tpu_torch.tuning import cache as tcache

    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    tr, trl, te, _, va, val = _mnist(seed=4)
    save_labeled_csv(str(tmp_path / "tr.csv"), tr, trl)
    save_unlabeled_csv(str(tmp_path / "te.csv"), te)
    cache = str(tmp_path / "tune.json")
    key = tuning.cache_key("cpu", tr.shape[0], tr.shape[1], 9, "l2")
    tuning.TuneCache(cache).put(key, {"knobs": {"tile_n": 512},
                                      "winner_ms": 1.0})
    opened = []
    real = tcache.TuneCache.__init__

    def spy(self, path=None):
        real(self, path)
        opened.append(self.path)

    monkeypatch.setattr(tcache.TuneCache, "__init__", spy)
    res = run_job(JobConfig(train_file=str(tmp_path / "tr.csv"),
                            test_file=str(tmp_path / "te.csv"), val_file=None,
                            validation=False, k=9, mode="certified",
                            tune_cache=cache, device="cpu",
                            output_file=str(tmp_path / "out.csv")))
    assert opened and set(opened) == {cache}
    assert res.certified_stats["tuning"]["source"] == "cache"
    assert res.certified_stats["pallas_knobs"]["tile_n"] == 512
    assert not any(home.iterdir())
    # without it, the job reads the default path and nothing else
    opened.clear()
    run_job(JobConfig(train_file=str(tmp_path / "tr.csv"),
                      test_file=str(tmp_path / "te.csv"), val_file=None,
                      validation=False, k=9, mode="certified", device="cpu",
                      output_file=str(tmp_path / "out2.csv")))
    assert set(opened) == {tcache.default_cache_path()}


def test_job_config_refuses_as_the_reference_does():
    with pytest.raises(ValueError, match="l2 or cosine"):
        JobConfig(metric="dot", mode="certified", validation=False)
    with pytest.raises(ValueError, match="selector"):
        JobConfig(selector="fast", validation=False)
    assert JobConfig(metric="MANHATTAN", validation=False).metric == "manhattan"


def test_vote_and_normalize_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, size=(200, 9)).astype(np.int32)
    labels[:20] = np.array([1, 2, 2, 1, 3, 3, 0, 0, 4])  # several tie shapes
    np.testing.assert_array_equal(
        majority_vote(torch.from_numpy(labels), 5).numpy(),
        np.asarray(jax_vote(labels, 5)))
    np.testing.assert_array_equal(
        majority_vote(torch.from_numpy(labels), 5).numpy(),
        oracles.running_argmax_vote(labels, 5))
    a = rng.normal(size=(30, 6)).astype(np.float32)
    b = rng.normal(size=(10, 6)).astype(np.float32) * 3
    a[:, 2] = 7.0
    b[:, 2] = 7.0  # constant dim passes through
    ours = normalize_transductive(torch.from_numpy(a), torch.from_numpy(b))
    ref = jax_normalize(a, b)
    assert ours[2] is None and ref[2] is None
    for x, r in zip(ours[:2], ref[:2]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))


def test_data_copies_match_jax(tmp_path):
    # the port's numpy copies of the generators and CSV readers give the
    # JAX package's arrays, bit for bit
    from knn_tpu.data import csv_io as jcsv
    from knn_tpu.data import datasets as jdata
    from knn_tpu_torch.data import csv_io as pcsv
    from knn_tpu_torch.data import datasets as pdata

    for a, b in zip(pdata.make_blobs(90, 7, 4, seed=3),
                    jdata.make_blobs(90, 7, 4, seed=3)):
        np.testing.assert_array_equal(a, b)
    mnist = pdata.make_mnist_like(n_train=50, n_test=20, n_val=10, dim=32,
                                  seed=4)
    for a, b in zip(mnist, jdata.make_mnist_like(n_train=50, n_test=20,
                                                 n_val=10, dim=32, seed=4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tr, trl, te = mnist[:3]
    pdata.save_labeled_csv(str(tmp_path / "tr.csv"), tr, trl)
    pdata.save_unlabeled_csv(str(tmp_path / "te.csv"), te)
    for a, b in zip(pcsv.read_labeled_csv(str(tmp_path / "tr.csv"), 32),
                    jcsv.read_labeled_csv(str(tmp_path / "tr.csv"), 32)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pcsv.read_unlabeled_csv(str(tmp_path / "te.csv")),
                                  jcsv.read_unlabeled_csv(str(tmp_path / "te.csv")))
    np.testing.assert_array_equal(pcsv.read_unlabeled_csv(str(tmp_path / "te.csv")), te)


def test_topk_breaks_ties_toward_lower_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 3.0]])
    i = torch.tensor([[9, 7, 2, 5, 4, 1]])
    sd, si = topk_pairs(d, i, 4)
    assert si.tolist() == [[5, 2, 4, 7]]
    rng = np.random.default_rng(5)
    # small integers: every f32 distance is exact, so equal distances
    # are exact ties (duplicates and distinct rows alike)
    db = rng.integers(-3, 4, size=(300, 4)).astype(np.float32)
    db[150:] = db[:150]
    q = db[:20]
    for tile in (None, 64):
        _, idx = knn_search_tiled(torch.from_numpy(q), torch.from_numpy(db), 6,
                                  train_tile=tile)
        _, ref = oracles.topk_lowindex(oracles.sq_l2(q, db), 6)
        np.testing.assert_array_equal(idx.numpy(), ref)


def test_port_imports_neither_jax_nor_knn_tpu():
    code = (
        "import sys\n"
        "import knn_tpu_torch, knn_tpu_torch.cli, knn_tpu_torch.pipeline\n"
        "import knn_tpu_torch.convert, knn_tpu_torch.tuning\n"
        "import knn_tpu_torch.tuning.autotune, knn_tpu_torch.tuning.cache\n"
        "import knn_tpu_torch.ops.coarse_knn, knn_tpu_torch.ops.certified\n"
        "import knn_tpu_torch.ops.refine, knn_tpu_torch.data.datasets\n"
        "import knn_tpu_torch.models.classifier, knn_tpu_torch.parallel.sharded\n"
        "import knn_tpu_torch.models.regressor, knn_tpu_torch.models.neighbors\n"
        "import knn_tpu_torch.models.radius, knn_tpu_torch.ops.radius\n"
        "import knn_tpu_torch.ops.distance, knn_tpu_torch.ops.topk\n"
        "import knn_tpu_torch.data.vecs, knn_tpu_torch.ops.metrics\n"
        "import knn_tpu_torch.index, knn_tpu_torch.index.mutable\n"
        "import knn_tpu_torch.ivf.index, knn_tpu_torch.join\n"
        "import knn_tpu_torch.join.engine, knn_tpu_torch.analysis\n"
        "import knn_tpu_torch.analysis.hbm, knn_tpu_torch.analysis.widths\n"
        "import knn_tpu_torch.serving, knn_tpu_torch.serving.admission\n"
        "import knn_tpu_torch.serving.buckets, knn_tpu_torch.serving.engine\n"
        "import knn_tpu_torch.serving.queue, knn_tpu_torch.streaming\n"
        "import knn_tpu_torch.loadgen, knn_tpu_torch.loadgen.workload\n"
        "import knn_tpu_torch.loadgen.driver, knn_tpu_torch.loadgen.knee\n"
        "import knn_tpu_torch.loadgen.synthetic, knn_tpu_torch.ivf\n"
        "import knn_tpu_torch.obs, knn_tpu_torch.obs.roofline\n"
        "import knn_tpu_torch.obs.health, knn_tpu_torch.obs.profiler\n"
        "import knn_tpu_torch.obs.export, knn_tpu_torch.obs.trace\n"
        "import knn_tpu_torch.native, knn_tpu_torch.data.csv_io\n"
        "import knn_tpu_torch.utils.config, knn_tpu_torch.utils.timing\n"
        "import knn_tpu_torch.obs.names, knn_tpu_torch.index.artifact\n"
        "import knn_tpu_torch.obs.slo, knn_tpu_torch.obs.audit\n"
        "import knn_tpu_torch.obs.drift, knn_tpu_torch.obs.waterfall\n"
        "import knn_tpu_torch.obs.blackbox, knn_tpu_torch.obs.traceread\n"
        "import knn_tpu_torch.obs.calibrate, knn_tpu_torch.obs.fleet\n"
        "import knn_tpu_torch.campaign\n"
        "import knn_tpu_torch.analysis.core, knn_tpu_torch.analysis.annotations\n"
        "import knn_tpu_torch.analysis.lockorder\n"
        "import knn_tpu_torch.analysis.check_concurrency\n"
        "import knn_tpu_torch.analysis.check_metrics\n"
        "import knn_tpu_torch.analysis.switches\n"
        "import knn_tpu_torch.analysis.check_switches\n"
        "import knn_tpu_torch.analysis.check_torch\n"
        "import knn_tpu_torch.analysis.artifacts\n"
        "import knn_tpu_torch.analysis.check_artifacts\n"
        "import knn_tpu_torch.ivf.artifact, knn_tpu_torch.join.artifact\n"
        "import knn_tpu_torch.ops.pq_artifact\n"
        "import knn_tpu_torch.parallel.mesh, knn_tpu_torch.parallel.collectives\n"
        "import knn_tpu_torch.parallel.crossover\n"
        "import knn_tpu_torch.parallel.multihost\n"
        "import knn_tpu_torch.ops.pq, knn_tpu_torch.ivf.kmeans\n"
        "import knn_tpu_torch.obs.sentinel, knn_tpu_torch.scripts\n"
        "import knn_tpu_torch.scripts.perf_sentinel\n"
        "import knn_tpu_torch.scripts.refresh_bench_artifacts\n"
        "from knn_tpu_torch import parallel as _p\n"
        "[getattr(_p, name) for name in _p.__all__]\n"
        "from knn_tpu_torch.parallel import crossover as _x\n"
        "_x.validate_multihost_block({'hosts': 1})\n"
        "from knn_tpu_torch.analysis import artifacts as _a\n"
        "[_a.version_value(s.name) for s in _a.CATALOG if s.version_field]\n"
        "knn_tpu_torch.analysis.run('.')\n"
        "knn_tpu_torch.native.load()\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'knn_tpu' or m.startswith('knn_tpu.'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    from knn_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedKNN(X, k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KNNClassifier(k=2)
    csv = str(tmp_path / "t.csv")
    save_labeled_csv(csv, X, np.zeros(10, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job(JobConfig(train_file=csv, test_file=csv, val_file=None,
                          validation=False, k=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--train", csv, "--test", csv, "--k", "2"])
    for cls in (KNNRegressor, NearestNeighbors):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(k=2)
    for cls in (RadiusNeighborsClassifier, RadiusNeighborsRegressor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(1.0)
    assert ShardedKNN(X, k=2, device="cpu").device.type == "cpu"
    assert KNNClassifier(k=2, device="cpu").device.type == "cpu"
    assert NearestNeighbors(k=2, device="cpu").device.type == "cpu"
