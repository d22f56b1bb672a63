"""The port's native C++ backend (knn_tpu_torch.native, built from the
port's own copy of the source) and the job's last pieces (the CSV fast
path, ``read_labels``, ``JobConfig.to_json`` / ``from_json`` and
``BACKENDS``, ``PhaseTimer.summary``, the classifier's free functions)
against the JAX package's (knn_tpu.native, knn_tpu.data.csv_io,
knn_tpu.utils, knn_tpu.models.classifier) on the same inputs.

Tolerances: the two native libraries compile the same C++, so their
outputs are BITWISE equal; against the JAX path (f32 distances) the
native f64 distances agree within 1e-4 (the reference test's), indices
and labels equal.  The CSV readers return bitwise the JAX package's
arrays (each decimal rounded once to float32, as ``strtof`` does), and
the native job's ``Test_label.csv`` bytes equal the JAX native job's.
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import knn_tpu.native as jax_native
from knn_tpu.data import csv_io as jax_csv
from knn_tpu.data.datasets import make_blobs
from knn_tpu.models.classifier import knn_kneighbors as jax_kneighbors
from knn_tpu.models.classifier import knn_predict as jax_knn_predict
from knn_tpu.ops.normalize import minmax_apply as jax_minmax_apply
from knn_tpu.ops.normalize import minmax_stats as jax_minmax_stats
from knn_tpu.ops.topk import knn_search as jax_knn_search
from knn_tpu.pipeline import run_job as jax_run_job
from knn_tpu.utils.config import JobConfig as JaxJobConfig
from knn_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
from knn_tpu_torch import native
from knn_tpu_torch.data import csv_io
from knn_tpu_torch.data.datasets import save_labeled_csv, save_unlabeled_csv
from knn_tpu_torch.models.classifier import knn_kneighbors, knn_predict
from knn_tpu_torch.pipeline import run_job
from knn_tpu_torch.utils.config import BACKENDS, JobConfig
from knn_tpu_torch.utils.timing import PhaseTimer

jnp = pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries built (the port's into knn_tpu_torch/_build/)."""
    native.load()
    assert jax_native.available()


@pytest.fixture
def blob_data():
    feats, labels = make_blobs(200, 10, 4, cluster_std=1.0, seed=11)
    # duplicate a block to force exact distance ties through every path
    feats[150:170] = feats[100:120]
    queries = feats[180:].copy()
    return feats[:180], labels[:180], queries


# -- the reference's tests/test_native.py cases on the port's copy ------------
def test_search_parity(blob_data):
    train, _, queries = blob_data
    nd, ni = native.knn_search(train, queries, 7)
    rd, ri = jax_native.knn_search(train, queries, 7)
    np.testing.assert_array_equal(ni, ri)
    np.testing.assert_array_equal(nd, rd)
    jd, ji = jax_knn_search(jnp.asarray(queries), jnp.asarray(train), 7)
    np.testing.assert_array_equal(ni, np.asarray(ji))
    np.testing.assert_allclose(nd, np.asarray(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "dot"])
def test_search_parity_metrics(blob_data, metric):
    train, _, queries = blob_data
    nd, ni = native.knn_search(train, queries, 5, metric)
    rd, ri = jax_native.knn_search(train, queries, 5, metric)
    np.testing.assert_array_equal(ni, ri)
    np.testing.assert_array_equal(nd, rd)
    _, ji = jax_knn_search(jnp.asarray(queries), jnp.asarray(train), 5,
                           metric)
    np.testing.assert_array_equal(ni, np.asarray(ji))


def test_predict_parity(blob_data):
    train, labels, queries = blob_data
    n_pred = native.knn_predict(train, labels, queries, k=9, num_classes=4)
    np.testing.assert_array_equal(n_pred, jax_native.knn_predict(
        train, labels, queries, k=9, num_classes=4))
    j_pred = jax_knn_predict(jnp.asarray(train), jnp.asarray(labels),
                             jnp.asarray(queries), k=9, num_classes=4)
    np.testing.assert_array_equal(n_pred, np.asarray(j_pred))


def test_predict_vote_tie_semantics():
    # three-way ties: the first label to reach the final max wins, in
    # (distance, index) order, in every backend
    train = np.asarray([[0.0], [1.0], [-1.0], [2.0], [-2.0], [3.0]],
                       dtype=np.float32)
    labels = np.asarray([2, 1, 1, 0, 0, 2], dtype=np.int32)
    queries = np.asarray([[0.0], [0.4], [-0.4]], dtype=np.float32)
    n_pred = native.knn_predict(train, labels, queries, k=5, num_classes=3)
    np.testing.assert_array_equal(n_pred, jax_native.knn_predict(
        train, labels, queries, k=5, num_classes=3))
    j_pred = jax_knn_predict(jnp.asarray(train), jnp.asarray(labels),
                             jnp.asarray(queries), k=5, num_classes=3)
    np.testing.assert_array_equal(n_pred, np.asarray(j_pred))


def test_predict_rejects_out_of_range_labels(blob_data):
    train, labels, queries = blob_data
    bad = labels.copy()
    bad[0] = 99
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="label outside"):
            mod.knn_predict(train, bad, queries, k=9, num_classes=4)


def test_minmax_parity(blob_data):
    train, _, queries = blob_data
    nlo, nhi = native.minmax_stats([train, queries])
    rlo, rhi = jax_native.minmax_stats([train, queries])
    np.testing.assert_array_equal(nlo, rlo)
    np.testing.assert_array_equal(nhi, rhi)
    jlo, jhi = jax_minmax_stats([jnp.asarray(train), jnp.asarray(queries)])
    np.testing.assert_allclose(nlo, np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(nhi, np.asarray(jhi), rtol=1e-6)
    napp = native.minmax_apply(train, nlo, nhi)
    np.testing.assert_array_equal(napp, jax_native.minmax_apply(
        train, rlo, rhi))
    japp = jax_minmax_apply(jnp.asarray(train), jlo, jhi)
    np.testing.assert_allclose(napp, np.asarray(japp), rtol=1e-5, atol=1e-6)


def test_minmax_constant_dim_passthrough():
    x = np.asarray([[1.0, 5.0], [2.0, 5.0]], dtype=np.float32)
    lo, hi = native.minmax_stats([x])
    out = native.minmax_apply(x, lo, hi)
    np.testing.assert_allclose(out[:, 0], [0.0, 1.0])
    np.testing.assert_allclose(out[:, 1], [5.0, 5.0])  # knn_mpi.cpp:284
    np.testing.assert_array_equal(out, jax_native.minmax_apply(x, lo, hi))


def test_native_csv_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(30, 5)).astype(np.float32)
    labels = rng.integers(0, 3, size=30).astype(np.int32)
    p = str(tmp_path / "t.csv")
    save_labeled_csv(p, feats, labels)
    arr = native.read_csv(p)
    assert arr.shape == (30, 6)
    np.testing.assert_allclose(arr[:, 0], labels)
    np.testing.assert_allclose(arr[:, 1:], feats, rtol=1e-6)
    np.testing.assert_array_equal(arr, jax_native.read_csv(p))
    np.testing.assert_array_equal(arr, csv_io._parse_rows_python(p))


def test_native_csv_rejects_trailing_comma(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("3,4,\n1,2,\n")
    for read in (native.read_csv, jax_native.read_csv,
                 csv_io._parse_rows_python):
        with pytest.raises(ValueError, match="parse error"):
            read(str(p))


def test_native_accuracy():
    a = np.asarray([1, 2, 3, 4], dtype=np.int32)
    b = np.asarray([1, 0, 3, 0], dtype=np.int32)
    assert native.accuracy(a, b) == jax_native.accuracy(a, b) == 0.5


def test_multithreaded_matches_single_thread(blob_data):
    train, labels, queries = blob_data
    one = native.knn_predict(train, labels, queries, k=7, num_classes=4,
                             num_threads=1)
    many = native.knn_predict(train, labels, queries, k=7, num_classes=4,
                              num_threads=4)
    np.testing.assert_array_equal(one, many)


def _job_files(tmp_path):
    feats, labels = make_blobs(240, 6, 3, cluster_std=0.8, seed=5)
    paths = {name: str(tmp_path / f"{name}.csv")
             for name in ("train", "val", "test")}
    save_labeled_csv(paths["train"], feats[:160], labels[:160])
    save_labeled_csv(paths["val"], feats[160:200], labels[160:200])
    save_unlabeled_csv(paths["test"], feats[200:])
    return paths


def test_pipeline_backend_parity(tmp_path):
    """The port's torch and native backends give the same labels and
    accuracy, and the native job's Test_label.csv bytes are the JAX
    native job's."""
    paths = _job_files(tmp_path)

    def cfg(cls, backend, out, **kw):
        return cls(train_file=paths["train"], test_file=paths["test"],
                   val_file=paths["val"], output_file=str(tmp_path / out),
                   k=5, backend=backend, **kw)

    torch_res = run_job(cfg(JobConfig, "torch", "out_torch.csv",
                            device="cpu"))
    before = native.calls["read_csv"]
    nat_res = run_job(cfg(JobConfig, "native", "out_native.csv",
                          num_threads=2))
    assert native.calls["read_csv"] - before == 3  # the fast path
    np.testing.assert_array_equal(torch_res.test_labels, nat_res.test_labels)
    np.testing.assert_array_equal(torch_res.val_labels, nat_res.val_labels)
    assert torch_res.val_accuracy == nat_res.val_accuracy
    jax_run_job(cfg(JaxJobConfig, "native", "out_jax_native.csv",
                    num_threads=2))
    with open(tmp_path / "out_native.csv", "rb") as a, \
            open(tmp_path / "out_jax_native.csv", "rb") as b:
        assert a.read() == b.read()


# -- the build -----------------------------------------------------------------
def test_library_is_built_from_the_port_source_into_the_build_dir():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.name == "_build"
    assert native.SOURCE.parent.parent == native.BUILD_DIR.parent / "native"
    assert not list(native.SOURCE.parent.parent.glob("*.so"))
    # the port's source is the JAX package's, line for line below its
    # header comment
    ours = native.SOURCE.read_text().split("#include <algorithm>", 1)[1]
    ref = open(os.path.join(os.path.dirname(jax_native.__file__), "src",
                            "knn_native.cpp")).read()
    assert ours == ref.split("#include <algorithm>", 1)[1]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    """Where the JAX package swallows a failed build (native/__init__.py:
    41-51), the port raises with the compiler's stderr wherever native is
    asked for; available() answers False."""
    src = tmp_path / "native"
    (src / "src").mkdir(parents=True)
    (src / "Makefile").write_text((native._DIR / "Makefile").read_text())
    (src / "src" / "knn_native.cpp").write_text(
        native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "SOURCE", src / "src" / "knn_native.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.load()
    assert not native.available()
    with pytest.raises(native.NativeBuildError, match="this is not C"):
        native.knn_search(np.zeros((4, 2), np.float32),
                          np.zeros((1, 2), np.float32), 1)
    paths = _job_files(tmp_path)
    with pytest.raises(native.NativeBuildError):
        run_job(JobConfig(train_file=paths["train"],
                          test_file=paths["test"], val_file=paths["val"],
                          output_file=str(tmp_path / "o.csv"), k=3,
                          backend="native"))
    # the readers take their Python path and return the same arrays
    arr, _ = csv_io.read_labeled_csv(paths["train"])
    np.testing.assert_array_equal(arr, jax_csv.read_labeled_csv(
        paths["train"])[0])


# -- the CSV readers --------------------------------------------------------
def _midpoint_decimals(draw_f32, offsets):
    """Decimal strings next to the float32 midpoints above each value:
    the midpoint itself, and just above and just below it (a float64
    parse rounds those onto the midpoint, and float32 then ties to even)."""
    from decimal import Decimal, localcontext

    out = []
    with localcontext() as ctx:
        ctx.prec = 120  # the midpoint's digits and 30 more, unrounded
        for x, off in zip(draw_f32, offsets):
            a = np.float32(x)
            b = np.nextafter(a, np.float32(np.inf))
            mid = (Decimal(float(a)) + Decimal(float(b))) / 2
            tiny = Decimal(10) ** (mid.adjusted() - 30)
            out.append(str(mid + off * tiny))
    return out


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6, width=32,
                          allow_subnormal=False), min_size=2, max_size=24),
       st.lists(st.sampled_from([-3, -1, 0, 1, 3]), min_size=24,
                max_size=24))
def test_readers_round_decimals_next_to_f32_midpoints_as_jax(tmp_path_factory,
                                                             values, offs):
    tokens = _midpoint_decimals(values, offs)
    n = len(tokens) // 2 * 2
    rows = [",".join(tokens[j:j + 2]) for j in range(0, n, 2)]
    p = str(tmp_path_factory.mktemp("csv") / "mid.csv")
    with open(p, "w") as f:
        f.write("\n".join(rows) + "\n")
    want = jax_csv.read_unlabeled_csv(p)  # the JAX reader (native built)
    got_native = csv_io.read_unlabeled_csv(p)
    got_python = csv_io._parse_rows_python(p)
    np.testing.assert_array_equal(got_native.view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(got_python.view(np.uint32),
                                  want.view(np.uint32))
    # a float64 parse cast to float32 rounds twice; where it differs, the
    # readers' value is the strictly nearer float32
    twice = np.asarray([float(t) for t in tokens[:n]]).astype(np.float32)
    for t, w, d in zip(tokens[:n], want.ravel(), twice):
        if w != d:
            assert abs(Fraction(t) - Fraction(float(w))) < \
                abs(Fraction(t) - Fraction(float(d)))


def test_one_rounding_differs_from_a_float64_parse_cast_again(tmp_path):
    """Decimals just above the float32 midpoints over 1.0 and 3.0, whose
    even neighbour lies below: a float64 parse cast to float32 returns
    1.0 / 3.0, every reader the float32 above."""
    tokens = _midpoint_decimals([1.0, 3.0], [1, 1])
    p = tmp_path / "up.csv"
    p.write_text(",".join(tokens) + "\n")
    twice = np.asarray([float(t) for t in tokens]).astype(np.float32)
    assert list(twice) == [1.0, 3.0]
    above = np.nextafter(np.float32([1.0, 3.0]), np.float32(np.inf))
    for arr in (jax_csv.read_unlabeled_csv(str(p)),
                csv_io.read_unlabeled_csv(str(p)),
                csv_io._parse_rows_python(str(p))):
        np.testing.assert_array_equal(arr[0], above)


@pytest.mark.parametrize("text,reason", [
    ("3,4,\n1,2,\n", "parse error"),   # trailing comma: an empty field
    ("1,,2\n", "parse error"),
    ("1,x\n", "parse error"),
    ("1,2.0,3.0\n2,4.0\n", "ragged rows"),
    ("\n\n", "empty file"),
    ("", "empty file"),
])
def test_reader_refusals_match_jax(tmp_path, text, reason):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    for read in (native.read_csv, csv_io._parse_rows_python,
                 jax_native.read_csv):
        with pytest.raises(ValueError, match=reason):
            read(str(p))
    with pytest.raises(ValueError, match=reason):
        jax_csv.read_unlabeled_csv(str(p))
    with pytest.raises(ValueError, match=reason):
        csv_io.read_unlabeled_csv(str(p))


def test_readers_skip_blank_lines_and_crlf_as_jax(tmp_path):
    p = tmp_path / "crlf.csv"
    p.write_bytes(b"1,0.1, 2.5\r\n\r\n  \n3,1e-3,-4\r\n")
    want = jax_csv.read_labeled_csv(str(p))
    for got in (csv_io.read_labeled_csv(str(p)),
                (csv_io._parse_rows_python(str(p))[:, 1:],
                 csv_io._parse_rows_python(str(p))[:, 0].astype(np.int32))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# -- the job's last pieces --------------------------------------------------
def test_labels_roundtrip(tmp_path):
    """tests/test_data.py:45 on the port."""
    labels = np.asarray([3, 1, 4, 1, 5], dtype=np.int32)
    p = str(tmp_path / "Test_label.csv")
    csv_io.write_labels(p, labels)
    np.testing.assert_array_equal(csv_io.read_labels(p), labels)
    np.testing.assert_array_equal(jax_csv.read_labels(p), labels)
    assert open(p).read() == "3\n1\n4\n1\n5\n"


def test_config_validation_and_json_roundtrip():
    """tests/test_pipeline.py:178 on the port: the backend check and the
    JSON round trip.  The port's own backend is "torch" where the JAX
    package's is "jax" (ROADMAP divergence 36)."""
    assert BACKENDS == ("torch", "native")
    with pytest.raises(ValueError, match="metric"):
        JobConfig(metric="chebyshev")
    with pytest.raises(ValueError, match="backend"):
        JobConfig(backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        JobConfig(backend="jax")
    with pytest.raises(ValueError, match="k must be"):
        JobConfig(k=0)
    with pytest.raises(ValueError, match="requires val_file"):
        JobConfig(validation=True, val_file=None)
    cfg = JobConfig()
    assert JobConfig.from_json(cfg.to_json()) == cfg
    cfg = JobConfig(backend="native", num_threads=3, k=7, metric="L1")
    assert JobConfig.from_json(cfg.to_json()) == cfg
    # the fields both packages share serialize alike
    ours = JobConfig(k=7, num_threads=3).to_json()
    ref = JaxJobConfig(k=7, num_threads=3).to_json()
    import json

    shared = set(json.loads(ours)) & set(json.loads(ref))
    assert {"k", "num_threads", "metric", "selector", "backend"} <= shared
    for key in shared - {"backend", "selector"}:
        assert json.loads(ours)[key] == json.loads(ref)[key], key


def test_config_serving_validation():
    """tests/test_pipeline.py:238 on the port."""
    with pytest.raises(ValueError, match="bad bucket spec"):
        JobConfig(serve_buckets="8,x")
    with pytest.raises(ValueError, match="does not compose"):
        JobConfig(serve_buckets="auto", mode="certified")
    with pytest.raises(ValueError, match="torch backend"):
        JobConfig(serve_buckets="auto", backend="native")
    with pytest.raises(ValueError, match="max_wait_ms"):
        JobConfig(max_wait_ms=-0.5)
    assert JobConfig(serve_buckets="").serve_buckets is None
    cfg = JobConfig(serve_buckets="16,64", max_wait_ms=3.0)
    assert JobConfig.from_json(cfg.to_json()) == cfg


def test_phase_timer_summary_is_the_jax_shape():
    ours, ref = PhaseTimer(), JaxPhaseTimer()
    for timer in (ours, ref):
        with timer.phase("ingest"):
            pass
        with timer.phase("knn"):
            pass
    s, r = ours.summary(), ref.summary()
    assert sorted(s) == sorted(r) == ["ingest", "knn", "total"]
    assert s["total"] == ours.total and s["ingest"] == ours.phases["ingest"]


def test_classifier_free_functions_match_jax(blob_data):
    train, labels, queries = blob_data
    t, lab, q = (torch.from_numpy(train), torch.from_numpy(labels),
                 torch.from_numpy(queries))
    for metric in ("l2", "l1", "cosine"):
        pred = knn_predict(t, lab, q, k=9, num_classes=4, metric=metric,
                           train_tile=64)
        j_pred = jax_knn_predict(jnp.asarray(train), jnp.asarray(labels),
                                 jnp.asarray(queries), k=9, num_classes=4,
                                 metric=metric, train_tile=64)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(j_pred))
        d, i = knn_kneighbors(t, q, k=6, metric=metric)
        jd, ji = jax_kneighbors(jnp.asarray(train), jnp.asarray(queries),
                                k=6, metric=metric)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-4)
