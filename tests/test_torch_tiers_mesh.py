"""The tiers' mesh programs, their refusals by name, the ``MERGE_*``
counters of one tier sequence against the JAX package's, and the CLI's
placements on a mesh of several devices.  The tiers themselves are held
against the JAX package's in ``test_torch_tiers_mesh_{mutable, ivf,
join, serving}.py``; inputs, tolerances and helpers:
``tests/tiers_mesh_common.py``.
"""

import time

import numpy as np
import pytest
import torch

from knn_tpu import obs as jobs
from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.join import knn_join as jax_join
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch import obs
from knn_tpu_torch.index.mutable import MutableIndex
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.parallel.sharded import (ShardedKNN,
                                            query_stream_program,
                                            segment_search_program)

from tiers_mesh_common import (DIM, IVF_KW, K, SHAPES, clustered, jax_mesh_of,
                               mutable_data, mutate, one_device, port_mesh)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


# -- the programs ---------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 2)])
def test_segment_and_stream_programs_on_a_mesh(shape):
    rng = np.random.default_rng(17)
    seg = (rng.random((64, DIM)) * 10).astype(np.float32)
    q = (rng.random((13, DIM)) * 10).astype(np.float32)
    m = port_mesh(shape)
    one = segment_search_program(K, device="cpu")
    prog = segment_search_program(K, mesh=m, merge="ring")
    for n_valid in (64, 37, 3):
        d, i = prog(q, seg, n_valid)
        rd, ri = one(q, seg, n_valid)
        np.testing.assert_array_equal(i.numpy(), ri.numpy())
        np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=1e-5,
                                   atol=1e-4)
    knn = ShardedKNN(seg, mesh=m, k=K)
    sp = query_stream_program(K, n_valid=knn.n_train, mesh=m)
    got = sp(torch.from_numpy(q), knn.placed_db())
    want = knn.search(q)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not both"):
        segment_search_program(K, mesh=m, device="cpu")
    with pytest.raises(ValueError, match="use fewer db shards"):
        segment_search_program(9, mesh=port_mesh((1, 8)))(q, seg, 64)


# -- refusals -------------------------------------------------------------------
def test_refusals_by_name_on_a_mesh():
    db, q, new = mutable_data()
    m = port_mesh((2, 4))
    for build in (lambda: MutableIndex(db, mesh=m, device="cpu", k=K),
                  lambda: IVFIndex(db, mesh=m, device="cpu", **IVF_KW)):
        with pytest.raises(ValueError, match="not both"):
            build()
    # k above a db shard's rows: the JAX package's text
    small = db[:40]
    with pytest.raises(ValueError, match="use fewer db shards"):
        MutableIndex(small, mesh=port_mesh((1, 8)), k=6, reserve=2)
    with pytest.raises(ValueError, match="use fewer db shards"):
        JaxMutableIndex(small, mesh=jax_mesh(1, 8), k=6, reserve=2)
    knn = ShardedKNN(small, mesh=port_mesh((1, 8)), k=5)
    with pytest.raises(ValueError, match="use fewer db shards"):
        knn_join(knn, q, k=6, mode="stream")
    # the host-RAM tier, its join, pq, the pipeline and search_bucketed
    # run on the mesh (tests/test_torch_mesh_{hosttier, pq, overlap}.py
    # hold them against the JAX package)
    from knn_tpu_torch.analysis import hbm

    budget = hbm.placement_bytes(128, DIM)
    tier = ShardedKNN(db, mesh=m, k=K, hbm_budget_bytes=budget)
    idx = MutableIndex(db, mesh=m, k=K, reserve=4, hbm_budget_bytes=budget)
    d, i = tier.search(q)
    np.testing.assert_array_equal(np.asarray(idx.search(q)[1]), i.numpy())
    jd, ji, st = knn_join(tier, q, superblock_rows=4)
    np.testing.assert_array_equal(ji, i.numpy())
    assert st["db_segments"] == tier.hosttier_stats()["sweeps"] > 1
    knn = ShardedKNN(db, mesh=m, k=K)
    _, pi, _ = knn.search_certified(q, precision="pq", pq_ncodes=16)
    _, oi, ost = knn.search_certified(q, overlap=True, batch_size=4)
    np.testing.assert_array_equal(pi, oi)
    assert ost["pipeline"]["batches"] == -(-q.shape[0] // 4)
    np.testing.assert_array_equal(knn.search_bucketed(q)[1],
                                  knn.search(q)[1].numpy())
    from knn_tpu_torch.tuning import autotune, autotune_ivf

    with pytest.raises(TypeError, match="mesh"):
        autotune(db, q, K, mesh=m)
    # the IVF tuner runs on the mesh (held against the JAX package's below)
    rows, cq = clustered(3, n=240)
    entry = autotune_ivf(rows, cq, K, mesh=m, runs=1, train_iters=2,
                         grid=[{"ncentroids": 8, "nprobe": 8}])
    assert entry["winner"] == "c8p8" and entry["backend"] == "cpu"
    assert entry["errors"] == {}
    with pytest.raises(ValueError, match="pass mesh= or device="):
        autotune_ivf(db, q, K, mesh=one_device(), device="cpu")


# -- the IVF tuner on a mesh ----------------------------------------------------
class _Clock:
    """A clock that advances one second a reading: every timed run of
    every candidate lasts exactly 1 s, so the winner is the first
    eligible candidate in grid order in both packages, and the
    comparison holds the candidates' gates and stats, not the host's
    speed."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t

    strftime = staticmethod(time.strftime)
    gmtime = staticmethod(time.gmtime)


@pytest.mark.parametrize("shape,selector", [((2, 4), "exact"),
                                            ((1, 8), "pallas")])
def test_autotune_ivf_on_a_mesh_equals_jax(shape, selector, monkeypatch):
    """``autotune_ivf(mesh=)`` on the port's logical mesh against the JAX
    package's ``autotune_ivf(mesh=)`` on a mesh of the same shape, the
    same grid, seed and ``train_iters``, under the counted and the pallas
    selector (on the CPU the port's plain versions, the JAX package's
    kernels in interpret mode): the same winner, every candidate through
    the bitwise gate, the same per-candidate stats."""
    import importlib

    port_tune = importlib.import_module("knn_tpu_torch.tuning.autotune")
    jax_tune = importlib.import_module("knn_tpu.tuning.autotune")
    for mod in (port_tune, jax_tune):
        monkeypatch.setattr(mod, "time", _Clock())
    rows, cq = clustered(5)
    grid = [{"ncentroids": 12, "nprobe": p} for p in (1, 3, 12)] + \
        [{"ncentroids": 6, "nprobe": 2}]
    kw = dict(runs=1, grid=grid, selector=selector,
              train_iters=IVF_KW["train_iters"], seed=IVF_KW["seed"])
    got = port_tune.autotune_ivf(rows, cq, K, mesh=port_mesh(shape), **kw)
    want = jax_tune.autotune_ivf(rows, cq, K, mesh=jax_mesh_of(shape), **kw)
    labels = {f"c{c['ncentroids']}p{c['nprobe']}" for c in grid}
    assert got["errors"] == want["errors"] == {}
    assert set(got["timings_ms"]) == labels
    assert all(v == 1000.0 for v in got["timings_ms"].values())
    assert got["timings_ms"] == want["timings_ms"]
    assert got["winner"] == want["winner"] == "c6p2"
    assert got["knobs"] == want["knobs"]
    assert got["stats_per_candidate"] == want["stats_per_candidate"]
    assert got["stats_per_candidate"]["c12p12"]["probe_fraction"] == 1.0
    for key in ("gate", "runs", "n_queries", "selector"):
        assert got[key] == want[key], key


# -- telemetry ------------------------------------------------------------------
def test_merge_counters_equal_jax_on_one_tier_sequence():
    """MERGE_SELECTED and MERGE_BYTES after one scripted sequence of tier
    calls on meshes equal the JAX package's: each tier builds and
    searches its placements as the JAX tier does."""
    db, q, new = mutable_data()
    rows, cq = clustered(8, n=240)

    def run(side):
        pkg = obs if side == "port" else jobs
        pkg.reset(enabled=True)
        mk = port_mesh if side == "port" else jax_mesh_of
        Mut = MutableIndex if side == "port" else JaxMutableIndex
        Ivf = IVFIndex if side == "port" else JaxIVFIndex
        join = knn_join if side == "port" else jax_join
        Knn = ShardedKNN if side == "port" else JaxShardedKNN
        idx = Mut(db, mesh=mk((4, 2)), k=K, reserve=4)
        idx.search(q)
        mutate(idx, new)
        idx.search(q[:5])
        idx.search_certified(q, selector="exact")
        idx.compact()
        ivf = Ivf(rows, mesh=mk((2, 4)), **IVF_KW)
        ivf.search_certified(cq, selector="exact")
        knn = Knn(db, mesh=mk((2, 2, 2)), k=K, merge="ring",
                  dcn_merge="allgather")
        join(knn, q, mode="stream", superblock_rows=4)
        host = Mut(db, mesh=mk((2, 2, 2)), k=K, reserve=4)
        snap = pkg.snapshot()
        dcn0 = {tuple(sorted(x["labels"].items())): x["value"]
                for x in snap.get(mn.MERGE_BYTES, {}).get("series", [])}
        host.search(q)
        snap = pkg.snapshot()
        if side == "port":
            # the host-mesh index's search: the dcn level's bytes are the
            # roofline's merge term of that call
            from knn_tpu_torch.obs import roofline

            strategy = host._main.dcn_merge
            label = (("level", "dcn"), ("strategy", strategy))
            got = [x["value"] for x in snap[mn.MERGE_BYTES]["series"]
                   if tuple(sorted(x["labels"].items())) == label][0]
            term = roofline.pallas_cost_model(
                n=db.shape[0], d=DIM, k=host._main.k, nq=10, db_hosts=2,
                dcn_merge=strategy)["terms"]["dcn"]
            assert got - dcn0.get(label, 0) == term["bytes"] > 0
            assert any(e.get("k_eff") == host._main.k
                       for e in obs.health.report()["index"])
        return {(name, tuple(sorted(s["labels"].items())), s["value"])
                for name in (mn.MERGE_SELECTED, mn.MERGE_BYTES)
                for s in snap.get(name, {}).get("series", [])}

    port, ref = run("port"), run("jax")
    obs.reset(enabled=True)
    jobs.reset(enabled=True)
    assert port == ref
    assert {c[0] for c in port} == {mn.MERGE_SELECTED, mn.MERGE_BYTES}


# -- the CLI --------------------------------------------------------------------
def test_cli_placements_stay_runnable_on_a_mesh_of_several_devices(
        monkeypatch, capsys):
    """With no ``--device`` the CLI places on ``make_mesh()``, every
    visible device on the query axis; two CPU devices stand in for two
    cards here.  ``join --hbm-budget-bytes`` runs the host-RAM tier on
    that two-device mesh and ``loadgen`` serves a mesh over several
    devices with ``aot=False`` (CUDA graphs of such a mesh are queued,
    ROADMAP divergence 64)."""
    import json

    from knn_tpu_torch.analysis import hbm
    from knn_tpu_torch.cli import main
    from knn_tpu_torch.parallel import mesh as pmesh
    from knn_tpu_torch.serving import engine as serving_engine

    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    make = pmesh.make_mesh

    def make_mesh(*args, devices=None, **kw):
        return make(*args, devices=two if devices is None else devices,
                    **kw)

    monkeypatch.setattr(pmesh, "make_mesh", make_mesh)
    budget = hbm.placement_bytes(500, 8)
    db = np.zeros((2000, 8), np.float32)
    tier = ShardedKNN(db, mesh=pmesh.make_mesh(), k=4, hbm_budget_bytes=budget)
    assert tier.mesh.size == 2 and tier.hosttier_stats()["sweeps"] == 4
    assert main(["join", "--n", "2000", "--rows", "300", "--dim", "8",
                 "--k", "4", "--superblock", "128",
                 "--hbm-budget-bytes", str(budget)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["db_segments"] == 4 and stats["superblocks"] == 3
    built = []
    engine_cls = serving_engine.ServingEngine

    class Recorded(engine_cls):
        def __init__(self, program, *args, aot=True, **kw):
            built.append((len(program.mesh.distinct_devices), aot))
            super().__init__(program, *args, aot=aot, **kw)

    monkeypatch.setattr(serving_engine, "ServingEngine", Recorded)
    assert main(["loadgen", "--n", "500", "--dim", "8", "--k", "3",
                 "--rates", "30", "--duration", "0.3", "--max-depth", "64",
                 "--json"]) == 0
    assert built == [(2, False)]
    step = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["rate_steps"][0]
    assert step["errors"] == 0 and step["ok"] > 0
