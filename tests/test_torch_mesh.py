"""The port's db-sharded mesh — knn_tpu_torch.parallel.{mesh, collectives,
crossover} and ``ShardedKNN(mesh=)`` — against the JAX package's
``ShardedKNN`` on a mesh of the same shape over its 8 virtual CPU devices,
the port's one-device placement and the float64 oracle.  The port's meshes
are logical: ``devices=["cpu"] * 8``.

Parity levels: exact ``search`` indices are equal wherever the oracle's
top-(k+1) distances are separated by more than twice the f32 tolerance
``64 eps_f32 (||q||^2 + max ||t||^2)``, and its distances lie within that
tolerance of the JAX package's and of the port's one-device values; ring
and allgather on one mesh, and every mesh of one shape family, are bitwise
each other; labels, radius counts and the job's ``Test_label.csv`` bytes
are equal.  The certified paths are in test_torch_mesh_certified.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from knn_tpu import obs as jobs
from knn_tpu.parallel import crossover as jxo
from knn_tpu.parallel.mesh import make_host_mesh as jax_host_mesh
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu.parallel.sharded import sharded_minmax as jax_minmax
from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.parallel import collectives as coll
from knn_tpu_torch.parallel import crossover as xo
from knn_tpu_torch.parallel import mesh as pmesh
from knn_tpu_torch.parallel.sharded import (ShardedKNN, sharded_knn,
                                            sharded_knn_predict,
                                            sharded_minmax,
                                            sharded_normalize_transductive)

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
FLAT = [(8, 1), (4, 2), (2, 4), (1, 8)]
HOST = [(2, 2, 2), (2, 4, 1)]
PAIRS = [(a, b) for a in ("ring", "allgather") for b in ("ring", "allgather")]
#: every (mesh shape, merge, dcn_merge) case: flat meshes have no dcn level
CASES = ([(s, m, None) for s in FLAT for m in ("ring", "allgather")]
         + [(s, a, b) for s in HOST for a, b in PAIRS])
EPS32 = float(np.finfo(np.float32).eps)


def port_mesh(shape):
    if len(shape) == 2:
        return pmesh.make_mesh(*shape, devices=CPU8)
    return pmesh.make_host_mesh(*shape, devices=CPU8)


def jax_mesh_of(shape):
    return jax_mesh(*shape) if len(shape) == 2 else jax_host_mesh(*shape)


def _data(seed=0, n=301, dim=12, n_q=23):
    # 301 rows: every db shard count pads the last shard with PAD_VAL rows
    rng = np.random.default_rng(seed)
    db = (rng.random((n, dim)) * 10).astype(np.float32)
    q = (rng.random((n_q, dim)) * 10).astype(np.float32)
    return db, q


def _tol(q, db):
    q64, t64 = q.astype(np.float64), db.astype(np.float64)
    return 64 * EPS32 * ((q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1).max())


def _assert_search(d, i, ref_d, ref_i, q, db, k):
    d, i = np.asarray(d), np.asarray(i)
    od = np.sort(oracles.sq_l2(q, db), axis=-1)[:, : k + 1]
    tol = _tol(q, db)
    sep = (np.diff(od, axis=-1) > 2 * tol).all(-1)
    assert sep.mean() > 0.8
    np.testing.assert_array_equal(i[sep], np.asarray(ref_i)[sep])
    assert (np.abs(d - np.asarray(ref_d)) <= tol).all()


@pytest.mark.parametrize("shape,merge,dcn", CASES)
def test_search_matches_jax_and_one_device(shape, merge, dcn):
    db, q = _data()
    k = 7
    port = ShardedKNN(db, mesh=port_mesh(shape), k=k, merge=merge,
                      dcn_merge=dcn)
    assert (port.merge, port.merge_source) == (merge, "explicit")
    assert port.db_shards == int(np.prod(shape[1:]))
    d, i = port.search(q)
    assert d.device.type == "cpu" and i.shape == (q.shape[0], k)
    jd, ji = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=k, merge=merge,
                           dcn_merge=dcn).search(q)
    _assert_search(d, i, jd, ji, q, db, k)
    od, oi = ShardedKNN(db, k=k, device="cpu").search(q)
    _assert_search(d, i, od, oi, q, db, k)


@pytest.mark.parametrize("shape", FLAT + HOST)
def test_ring_and_allgather_and_every_mesh_bitwise(shape):
    db, q = _data(1)
    ref = None
    for merge in ("ring", "allgather"):
        for dcn in (("ring", "allgather") if len(shape) == 3 else (None,)):
            out = ShardedKNN(db, mesh=port_mesh(shape), k=5, merge=merge,
                             dcn_merge=dcn).search(q)
            if ref is None:
                ref = out
            for a, b in zip(out, ref):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", FLAT + HOST)
def test_predict_and_radius_match_jax(shape):
    db, q = _data(2)
    labels = np.random.default_rng(2).integers(0, 4, db.shape[0])
    port = ShardedKNN(db, mesh=port_mesh(shape), k=5, labels=labels,
                      num_classes=4)
    jax_ = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=5, labels=labels,
                         num_classes=4)
    np.testing.assert_array_equal(port.predict(q).numpy(),
                                  np.asarray(jax_.predict(q)))
    # a radius off every pair's distance by far more than an ulp
    d64 = np.sqrt(oracles.sq_l2(q, db))
    radius = float(np.median(np.sort(d64, axis=-1)[:, 3]))
    while (np.abs(d64 - radius) < 1e-3).any():
        radius += 1e-2
    pd, pi, pc = port.radius_search(q, radius, max_neighbors=6)
    jd, ji, jc = jax_.radius_search(q, radius, max_neighbors=6)
    np.testing.assert_array_equal(pc, np.asarray(jc))
    np.testing.assert_array_equal(pc, (d64 <= radius).sum(-1))
    np.testing.assert_array_equal(pi, np.asarray(ji))
    # l1 runs one pass over the whole database (no sharded l1 count)
    l1 = ShardedKNN(db, mesh=port_mesh(shape), k=5, metric="l1")
    _, li, lc = l1.radius_search(q, 20.0, max_neighbors=4)
    np.testing.assert_array_equal(lc, (oracles.l1(q, db) <= 20.0).sum(-1))


@pytest.mark.parametrize("metric", ["cosine", "dot", "l1"])
def test_metrics_on_a_mesh_match_one_device(metric):
    db, q = _data(3)
    d, i = ShardedKNN(db, mesh=port_mesh((2, 4)), k=6,
                      metric=metric).search(q)
    rd, ri = ShardedKNN(db, k=6, metric=metric, device="cpu").search(q)
    np.testing.assert_array_equal(i.numpy(), ri.numpy())
    np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=1e-5, atol=1e-4)


def test_one_shot_wrappers_and_minmax_match_jax():
    db, q = _data(4)
    labels = (np.arange(db.shape[0]) % 3).astype(np.int32)
    m, jm = port_mesh((4, 2)), jax_mesh(4, 2)
    d, i = sharded_knn(q, db, 4, mesh=m, merge="ring")
    _, ji = JaxShardedKNN(db, mesh=jm, k=4).search(q)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        sharded_knn_predict(db, labels, q, k=4, num_classes=3,
                            mesh=m).numpy(),
        np.asarray(JaxShardedKNN(db, mesh=jm, k=4, labels=labels,
                                 num_classes=3).predict(q)))
    arrays = [db, q, q[:0], db[:5]]
    lo, hi = sharded_minmax(arrays, mesh=port_mesh((2, 2, 2)))
    jlo, jhi = jax_minmax(arrays, mesh=jax_host_mesh(2, 2, 2))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    tr, te, va = sharded_normalize_transductive(db, q, None, mesh=m)
    assert va is None
    ref_tr, ref_te = oracles.minmax_normalize_transductive(db, q)[:2]
    np.testing.assert_allclose(tr.numpy(), ref_tr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(te.numpy(), ref_te, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("estimator", ["classifier", "certified",
                                       "regressor", "neighbors"])
def test_estimators_on_a_mesh_match_jax(estimator):
    from knn_tpu.models import classifier as jclf, neighbors as jnb
    from knn_tpu.models import regressor as jreg
    from knn_tpu_torch import KNNClassifier, KNNRegressor, NearestNeighbors

    db, q = _data(5)
    y = (np.random.default_rng(5).integers(0, 3, db.shape[0])
         ).astype(np.int32)
    m, jm = port_mesh((4, 2)), jax_mesh(4, 2)
    if estimator in ("classifier", "certified"):
        mode = "exact" if estimator == "classifier" else "certified"
        port = KNNClassifier(k=5, mesh=m, merge="ring", mode=mode,
                             selector="pallas").fit(db, y)
        ref = jclf.KNNClassifier(k=5, mesh=jm, merge="ring", mode=mode,
                                 selector="pallas").fit(db, y)
        assert port._program.mesh is m
        np.testing.assert_array_equal(port.predict(q),
                                      np.asarray(ref.predict(q)))
    elif estimator == "regressor":
        t = y.astype(np.float32) * 1.5
        port = KNNRegressor(k=5, mesh=m).fit(db, t)
        ref = jreg.KNNRegressor(k=5, mesh=jm).fit(db, t)
        np.testing.assert_allclose(port.predict(q), np.asarray(ref.predict(q)),
                                   rtol=1e-6)
    else:
        port = NearestNeighbors(k=5, mesh=m).fit(db)
        ref = jnb.NearestNeighbors(k=5, mesh=jm).fit(db)
        _, pi = port.kneighbors(q)
        _, ri = ref.kneighbors(q)
        np.testing.assert_array_equal(pi, np.asarray(ri))
    with pytest.raises(ValueError, match="not both"):
        KNNClassifier(k=5, mesh=m, device="cpu")


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_job_with_two_db_shards_matches_jax(tmp_path, merge):
    from knn_tpu.data.datasets import (make_mnist_like, save_labeled_csv,
                                       save_unlabeled_csv)
    from knn_tpu.pipeline import run_job as jax_run_job
    from knn_tpu.utils.config import JobConfig as JaxJobConfig
    from knn_tpu_torch import JobConfig, run_job
    from knn_tpu_torch.cli import main as port_cli

    tr, trl, te, _, va, val = make_mnist_like(
        n_train=600, n_test=60, n_val=60, dim=24, noise=60.0, seed=3)
    paths = {n: str(tmp_path / f"{n}.csv") for n in ("train", "test", "val")}
    save_labeled_csv(paths["train"], tr, trl)
    save_unlabeled_csv(paths["test"], te)
    save_labeled_csv(paths["val"], va, val)
    common = dict(train_file=paths["train"], test_file=paths["test"],
                  val_file=paths["val"], k=9, db_shards=2, merge=merge)
    jout = str(tmp_path / "jax.csv")
    jres = jax_run_job(JaxJobConfig(output_file=jout, **common))
    pout = str(tmp_path / "port.csv")
    pres = run_job(JobConfig(output_file=pout, device="cpu", **common))
    np.testing.assert_array_equal(pres.test_labels, np.asarray(jres.test_labels))
    assert open(pout, "rb").read() == open(jout, "rb").read()
    assert pres.val_accuracy == jres.val_accuracy
    cout = str(tmp_path / "cli.csv")
    assert port_cli(["--train", paths["train"], "--test", paths["test"],
                     "--val", paths["val"], "--k", "9", "--db-shards", "2",
                     "--merge", merge, "--device", "cpu",
                     "--out", cout]) == 0
    assert open(cout, "rb").read() == open(jout, "rb").read()
    # the JAX package's field set, and the port's device beside it
    port_fields = set(json.loads(
        JobConfig(output_file=pout, device="cpu", **common).to_json()))
    assert port_fields - {"device"} == set(json.loads(
        JaxJobConfig(output_file=jout, **common).to_json()))


# --- the crossover: the JAX package's measured table --------------------------

def _scaling_rows():
    with open(os.path.join(REPO, "SCALING.json")) as f:
        return json.load(f)["rows"]


def test_crossover_table_matches_scaling_json():
    best = {}
    for row in _scaling_rows():
        if row["merge"] == "none":
            continue
        key = (row["k"], int(row["mesh"].split("x")[1]))
        if key not in best or row["wall_s"] < best[key][1]:
            best[key] = (row["merge"], row["wall_s"])
    assert {k: v[0] for k, v in best.items()} == xo.MEASURED_CROSSOVER
    assert xo.MEASURED_CROSSOVER == jxo.MEASURED_CROSSOVER
    assert xo.STRATEGIES == jxo.STRATEGIES and xo.SOURCES == jxo.SOURCES


def test_merge_bytes_and_choice_match_jax():
    for row in _scaling_rows():
        if row["merge"] == "none":
            continue
        q, p = (int(x) for x in row["mesh"].split("x"))
        got = xo.merge_bytes(2048 // q, row["k"], p, row["merge"]) * q
        assert got == row["merge_bytes_per_sweep"]
    for k in (1, 5, 10, 30, 100, 500):
        for shards in (1, 2, 3, 4, 6, 8, 16):
            assert xo.choose_merge(k, shards) == jxo.choose_merge(k, shards)
            assert xo.resolve_merge(None, k, shards) == \
                jxo.resolve_merge(None, k, shards)
            for s in ("ring", "allgather"):
                assert xo.merge_bytes(4096, k, shards, s) == \
                    jxo.merge_bytes(4096, k, shards, s)
    assert xo.merge_bytes(4096, 100, 2, "allgather") == 6_553_600
    with pytest.raises(ValueError, match="unknown merge"):
        xo.resolve_merge("tree", 10, 2)


def test_merge_counters_equal_jax_on_one_sequence():
    db, q = _data(6)

    def run(side):
        pkg = obs if side == "port" else jobs
        pkg.reset(enabled=True)
        for shape, merge, dcn in [((4, 2), None, None),
                                  ((2, 4), "ring", None),
                                  ((2, 2, 2), "allgather", "ring"),
                                  ((1, 1), None, None)]:
            if side == "port":
                knn = ShardedKNN(db, mesh=port_mesh(shape) if shape != (1, 1)
                                 else pmesh.make_mesh(1, 1, devices=["cpu"]),
                                 k=4, merge=merge, dcn_merge=dcn)
            else:
                knn = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=4,
                                    merge=merge, dcn_merge=dcn)
            knn.search(q)
            knn.search(q[:5], k=3)
            knn.radius_search(q, 5.0, max_neighbors=4)
        snap = pkg.snapshot()
        return {(name, tuple(sorted(s["labels"].items())), s["value"])
                for name in (mn.MERGE_SELECTED, mn.MERGE_BYTES)
                for s in snap.get(name, {}).get("series", [])}

    port, jax_ = run("port"), run("jax")
    obs.reset(enabled=True)
    jobs.reset(enabled=True)
    assert port == jax_
    assert {c[0] for c in port} == {mn.MERGE_SELECTED, mn.MERGE_BYTES}


# --- collectives, meshes and the refusals ------------------------------------

def test_collectives_are_device_copies():
    m = port_mesh((4, 2))
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    rep = coll.replicate(x, m)
    assert all(torch.equal(p, torch.from_numpy(x)) for p in rep.parts.flat)
    sh = coll.shard(x, m, pmesh.DB_AXIS)
    assert sh.n_blocks == 2 and torch.equal(sh.gather(), torch.from_numpy(x))
    assert torch.equal(sh.parts[3, 1], torch.from_numpy(x[4:]))
    host = coll.shard(x, port_mesh((2, 2, 2)), ("host", "db"))
    assert torch.equal(host.block(3), torch.from_numpy(x[6:]))
    with pytest.raises(ValueError, match="pad first"):
        coll.shard(x[:7], m, pmesh.DB_AXIS)
    parts = [torch.tensor([3.0, 1.0]), torch.tensor([2.0, 5.0])]
    assert torch.equal(coll.allreduce_min(parts)[1], torch.tensor([2.0, 1.0]))
    assert torch.equal(coll.allreduce_max(parts)[0], torch.tensor([3.0, 5.0]))
    assert torch.equal(coll.allreduce_sum(parts)[0], torch.tensor([5.0, 6.0]))
    assert torch.equal(coll.reduce_min(parts, "cpu"), torch.tensor([2.0, 1.0]))
    assert torch.equal(coll.reduce_max(parts, "cpu"), torch.tensor([3.0, 5.0]))
    assert torch.equal(coll.reduce_sum(parts, "cpu"), torch.tensor([5.0, 6.0]))
    assert coll.gather(parts, "cpu", tiled=False).shape == (2, 2)
    coll.barrier(sh, parts[0])
    padded, n = pmesh.pad_to_multiple(torch.ones(5, 2), 4, fill=-1.0)
    assert n == 5 and padded.shape == (8, 2) and padded[-1, 0] == -1.0
    assert pmesh.pad_to_multiple(np.ones((8, 2)), 4)[1] == 8


@pytest.mark.parametrize("hosts,chips", [(1, 4), (2, 2), (4, 1), (1, 1)])
@pytest.mark.parametrize("merge", ["ring", "allgather"])
def test_merge_tree_merges_once_a_level(monkeypatch, hosts, chips, merge):
    """One query shard's lists merge once a level, onto position (0, 0):
    the ring runs P-1 pairwise merges of a level's P lists, the allgather
    one selection, and no position's list is merged that the result does
    not read.  The result is the flat top-k of every list."""
    from knn_tpu_torch.parallel import sharded

    calls = {"merge_topk": 0, "topk_pairs": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(sharded, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(sharded, name, counted)
    rng = np.random.default_rng(3)
    d = [[torch.from_numpy(np.sort(rng.random((5, 4)).astype(np.float32)))
          for _ in range(chips)] for _ in range(hosts)]
    gi = [[torch.from_numpy(rng.permutation(1000)[:20].reshape(5, 4)
                            .astype(np.int32) + 1000 * (h * chips + c))
           for c in range(chips)] for h in range(hosts)]
    md, mi = sharded._merge_shards(d, gi, 4, merge, None)
    levels = [chips] * hosts + ([hosts] if hosts > 1 else [])
    merges = [p for p in levels if p > 1]
    if merge == "ring":
        assert calls == {"merge_topk": sum(p - 1 for p in merges),
                         "topk_pairs": 0}
    else:
        assert calls == {"merge_topk": 0, "topk_pairs": len(merges)}
    fd = torch.cat([x for row in d for x in row], 1)
    fi = torch.cat([x for row in gi for x in row], 1)
    order = np.lexsort((fi.numpy(), fd.numpy()), axis=-1)[:, :4]
    np.testing.assert_array_equal(md.numpy(), np.take_along_axis(
        fd.numpy(), order, -1))
    np.testing.assert_array_equal(mi.numpy(), np.take_along_axis(
        fi.numpy(), order, -1))


def test_pre_placed_rows_take_n_train():
    db, q = _data(7, n=296)
    m = port_mesh((2, 4))
    padded, n = pmesh.pad_to_multiple(db, 4)
    placed = coll.shard(padded, m, pmesh.db_axes(m))
    knn = ShardedKNN(placed, mesh=m, k=5, n_train=n)
    d, i = knn.search(q)
    rd, ri = ShardedKNN(db, mesh=m, k=5).search(q)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    with pytest.raises(ValueError, match="n_train is only"):
        ShardedKNN(db, mesh=m, k=5, n_train=3)
    with pytest.raises(ValueError, match="needs a host array"):
        ShardedKNN(placed, mesh=m, k=5, metric="cosine")


def test_mesh_shapes_topology_and_logical_devices():
    m = port_mesh((2, 2, 2))
    assert m.shape == {"query": 2, "host": 2, "db": 2} and m.size == 8
    assert pmesh.is_hier(m) and pmesh.db_axes(m) == ("host", "db")
    assert pmesh.db_topology(m) == (2, 2)
    assert m.logical and m.distinct_devices == [torch.device("cpu")]
    assert pmesh.grid3(port_mesh((4, 2))).shape == (4, 1, 2)
    f = pmesh.make_mesh(None, 4, devices=CPU8)
    assert f.shape == {"query": 2, "db": 4}
    assert pmesh.make_mesh(1, 1, devices=["cpu"]) == \
        pmesh.make_mesh(1, 1, devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match="needs 16 devices"):
        pmesh.make_mesh(4, 4, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_host_mesh(None, 3, 1, devices=CPU8)
    # the JAX shapes, one for one
    for shape in FLAT + HOST:
        assert tuple(port_mesh(shape).shape.items()) == \
            tuple(jax_mesh_of(shape).shape.items())


def test_mixed_and_missing_devices_raise():
    grid = np.empty((1, 2), dtype=object)
    grid[0, 0], grid[0, 1] = torch.device("cpu"), torch.device("cuda", 0)
    with pytest.raises(ValueError, match="mixes"):
        pmesh.Mesh(grid, (pmesh.QUERY_AXIS, pmesh.DB_AXIS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            pmesh.make_mesh(1, 2)
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            pmesh.default_mesh()
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            pmesh.make_mesh(1, 2, devices=["cpu", "cuda"])
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            ShardedKNN(np.ones((8, 2), np.float32), k=1,
                       mesh=None)  # the default mesh is the card


def test_refusals_by_name():
    db, q = _data(8)
    m = port_mesh((2, 4))
    knn = ShardedKNN(db, mesh=m, k=5)
    # pq, the pipeline, search_bucketed and the host-RAM tier run on the
    # mesh (tests/test_torch_mesh_{pq, overlap, hosttier}.py hold them)
    _, i, _ = knn.search_certified(q, precision="pq", pq_ncodes=16)
    _, oi, st = knn.search_certified(q, overlap=True, batch_size=4)
    assert st["pipeline"]["batches"] == -(-q.shape[0] // 4)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(knn.search_bucketed(q)[1],
                                  knn.search(q)[1].numpy())
    from knn_tpu_torch.analysis import hbm
    from tiers_mesh_common import assert_exact

    tier = ShardedKNN(db, mesh=m, k=5,
                      hbm_budget_bytes=hbm.placement_bytes(64, db.shape[1]))
    assert_exact(*tier.search(q), *knn.search(q), q, db, 5)
    assert tier.hosttier_stats()["sweeps"] > 1
    with pytest.raises(ValueError, match="exceeds db shard size"):
        ShardedKNN(db, mesh=port_mesh((1, 8)), k=39)
    with pytest.raises(ValueError, match="not both"):
        ShardedKNN(db, mesh=m, device="cpu", k=5)
    with pytest.raises(ValueError, match="unknown merge"):
        ShardedKNN(db, mesh=m, k=5, merge="tree")
    with pytest.raises(ValueError, match="max_neighbors=50 exceeds"):
        ShardedKNN(db, mesh=port_mesh((1, 8)), k=5).radius_search(
            q, 5.0, max_neighbors=50)
    from knn_tpu_torch.convert import placement_from_numpy

    with pytest.raises(ValueError, match="one device's rows"):
        ShardedKNN(placement_from_numpy(db, device="cpu"), mesh=m, k=5)
    # a query-only mesh keeps one placement and everything on it
    qonly = ShardedKNN(db, mesh=port_mesh((8, 1)), k=5)
    assert qonly.placement is not None
    d, i = qonly.search_bucketed(q, min_bucket=8, max_bucket=32)
    ri = ShardedKNN(db, k=5, device="cpu").search(q)[1]
    np.testing.assert_array_equal(np.asarray(i), ri.numpy())


def test_serving_engine_runs_on_a_db_sharded_mesh():
    """The engine serves a placement with several db shards (queue A item
    4.1): every request bitwise the mesh search of its padded batch."""
    from knn_tpu_torch.serving.engine import ServingEngine

    db, q = _data(8)
    knn = ShardedKNN(db, mesh=port_mesh((2, 4)), k=5)
    eng = ServingEngine(knn, buckets=(4, 8))
    d, i = eng.search(q[:3])
    padded = np.zeros((4, db.shape[1]), np.float32)
    padded[:3] = q[:3]
    wd, wi = knn.search(padded)
    np.testing.assert_array_equal(d, wd.numpy()[:3])
    np.testing.assert_array_equal(i, wi.numpy()[:3])
    assert eng.stats()["executables"] == 1
