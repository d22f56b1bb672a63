"""The port's process-spanning mesh (knn_tpu_torch.parallel.multihost.
global_mesh / global_host_mesh / shard_across_hosts, ``ShardedKNN`` on
them): real child processes join a gloo process group on a free local
port, each drives only its own grid positions, and every merge level,
exclusion-bound minimum and count that spans processes crosses them
through the group.  The children import neither ``jax`` nor ``knn_tpu``.

The parent holds the results of every process against each other (equal),
against the port's one-process logical mesh of the same shape
(``make_mesh(..., devices=["cpu"] * n)``: distances, indices and stats
bitwise), against the JAX package's one-process ``ShardedKNN`` on the
same mesh shape of its virtual CPU devices (indices equal; the result
tests/test_multihost.py holds its processes to) and against the float64
oracle (indices).  The JAX package's hierarchical mesh is a reference
fault (ROADMAP queue C), so the spanning host mesh is held against the
flat spanning mesh and the oracle instead.  One module fixture a
process count spawns the processes once; the group's timeout is 60 s and
each child's 120 s, so a lost peer fails a test, not the suite.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.models.classifier import KNNClassifier
from knn_tpu_torch.ops.coarse_knn import PAD_VAL
from knn_tpu_torch.parallel import collectives as coll
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.crossover import merge_bytes
from knn_tpu_torch.parallel.mesh import make_host_mesh, make_mesh
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ, K, MARGIN, CLASSES = 128, 8, 10, 5, 8, 4
ARMS = ("bf16x3", "int8", "highest")
SELECTORS = ("exact", "approx")
PAIRS = [(a, b) for a in ("ring", "allgather") for b in ("ring", "allgather")]


def data():
    rng = np.random.default_rng(0)
    db = (rng.random((N, D)) * 10).astype(np.float32)
    q = (rng.random((NQ, D)) * 10).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    return db, q, labels


CHILD = r'''
import json, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
pid, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
N, D, NQ, K, MARGIN, CLASSES = 128, 8, 10, 5, 8, 4
ARMS = ("bf16x3", "int8", "highest")
from knn_tpu_torch import obs
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.sharded import ShardedKNN

rng = np.random.default_rng(0)
db = (rng.random((N, D)) * 10).astype(np.float32)
q = (rng.random((NQ, D)) * 10).astype(np.float32)
labels = rng.integers(0, CLASSES, N).astype(np.int32)
# an empty tuner cache of the run's own: every knob left at None resolves
# to the library defaults, as in the parent's one-process runs
tune = sys.argv[5]
out = {"tune": tune}


def refused(key, fn):
    try:
        fn()
        out[key] = None
    except Exception as e:  # the parent checks the type and the name
        out[key] = [type(e).__name__, str(e)]


def certified(knn, **kw):
    d, i, st = knn.search_certified(q, margin=MARGIN, tune_cache=tune, **kw)
    return {"d": d.tolist(), "i": i.tolist(), "stats": st}


def searched(knn):
    d, i = knn.search(q)
    return {"d": d.tolist(), "i": i.tolist()}


if sys.argv[4] == "lost":
    # nccl on the CPU is refused by name; the next attempt joins through
    # the same store with gloo and a 3 s group timeout
    refused("nccl", lambda: multihost.initialize(
        f"localhost:{port}", n_proc, pid, backend="nccl", devices=["cpu"]))
    multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=3,
                         backend="gloo", devices=["cpu"])
    knn = ShardedKNN(db, k=K, mesh=multihost.global_mesh(1, n_proc))
    out["before"] = searched(knn)
    if pid == 1:  # never arrives at the next search
        time.sleep(12)
    else:
        t0 = time.perf_counter()
        refused("lost", lambda: knn.search(q))
        out["waited_s"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(out), flush=True)
    sys.exit(0)

obs.reset(enabled=True)
multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=60,
                     backend="gloo", devices=["cpu"])
out["backend"] = multihost.backend()
if n_proc == 2:
    mesh = multihost.global_mesh(1, 2)
    out["mesh"] = [repr(mesh), [list(p) for p in mesh.local_positions]]
    knn = ShardedKNN(db, k=K, mesh=mesh, labels=labels, num_classes=CLASSES)
    out["search"] = searched(knn)
    out["report_search"] = multihost.last_report()
    for arm in ARMS:
        out[f"pallas/{arm}"] = certified(knn, precision=arm)
    out["report_certified"] = multihost.last_report()
    for sel in ("exact", "approx"):
        out[f"counted/{sel}"] = certified(knn, selector=sel)
    out["predict"] = knn.predict(q).tolist()
    # a radius off every pair's distance by far more than an ulp
    d64 = np.sqrt(((q.astype(np.float64)[:, None] - db[None]) ** 2).sum(-1))
    radius = float(np.median(np.sort(d64, axis=-1)[:, 3]))
    while (np.abs(d64 - radius) < 1e-3).any():
        radius += 1e-2
    rd, ri, rc = knn.radius_search(q, radius, max_neighbors=6)
    out["radius"] = {"r": radius, "d": rd.tolist(), "i": ri.tolist(),
                     "c": rc.tolist()}
    lab, st = knn.predict_certified(q, margin=MARGIN, tune_cache=tune)
    out["predict_certified"] = [lab.tolist(), st]
    from knn_tpu_torch.models.classifier import KNNClassifier

    clf = KNNClassifier(k=K, mesh=mesh).fit(db, labels)
    out["classifier"] = clf.predict(q).tolist()
    for merge in ("ring", "allgather"):
        flat = ShardedKNN(db, k=K, mesh=mesh, merge=merge)
        out[f"flat/{merge}"] = {"search": searched(flat),
                                "certified": certified(flat)}
    flat4 = multihost.global_mesh(1, 4, devices=["cpu", "cpu"])
    out["flat4"] = {"search": searched(ShardedKNN(db, k=K, mesh=flat4)),
                    "certified": certified(ShardedKNN(db, k=K, mesh=flat4))}
    hmesh = multihost.global_host_mesh(1, 2, 2, devices=["cpu", "cpu"])
    out["host_mesh"] = repr(hmesh)
    for merge, dcn in [(a, b) for a in ("ring", "allgather")
                       for b in ("ring", "allgather")]:
        hk = ShardedKNN(db, k=K, mesh=hmesh, merge=merge, dcn_merge=dcn)
        out[f"host/{merge}/{dcn}"] = {
            "search": searched(hk), "certified": certified(hk),
            "report": multihost.last_report()}
    # each process's own half placed on its own position
    half = N // 2
    placed = multihost.shard_across_hosts(db[pid * half:(pid + 1) * half],
                                          mesh)
    pk = ShardedKNN(placed, k=K, mesh=mesh)
    out["placed"] = searched(pk)
    out["placed_gather"] = placed.gather().numpy().tolist() == db.tolist()
    refused("placed_certified", lambda: pk.search_certified(q))
    # a padded placement: the last PAD_VAL rows of process 1 masked
    padded = db.copy()
    padded[-3:] = 3.0e30
    pp = ShardedKNN(multihost.shard_across_hosts(
        padded[pid * half:(pid + 1) * half], mesh), k=K, mesh=mesh,
        n_train=N - 3)
    out["placed_padded"] = searched(pp)
    # the certificate's db term: the real rows' largest norm, every process
    out["placed_padded_norm"] = [s.placement.db_norm_max
                                 for s in pp._shards.values()]
    refused("n_train_outside", lambda: ShardedKNN(placed, k=K, mesh=mesh,
                                                  n_train=N + 1))
    # the paths still queued on a spanning mesh, each by name (the tiers
    # run there: tests/test_torch_global_tiers.py)
    from knn_tpu_torch.serving import ServingEngine

    queued = {
        "ServingEngine": lambda: ServingEngine(knn),
        "search_bucketed": lambda: knn.search_bucketed(q),
        "hosttier": lambda: ShardedKNN(db, k=K, mesh=mesh,
                                       hbm_budget_bytes=1024),
        "pq": lambda: knn.search_certified(q, precision="pq"),
        "overlap": lambda: knn.search_certified(q, overlap=True),
        "streaming_kernel": lambda: knn.search_certified(
            q, kernel="streaming"),
        "fused_kernel": lambda: knn.search_certified(q, kernel="fused"),
    }
    for name, fn in queued.items():
        refused(f"queued/{name}", fn)
    # the collectives' cross-process forms, one participant a process
    from knn_tpu_torch.parallel import collectives as coll

    t = torch.tensor([float(pid), 10.0 - pid])
    own, cpu = [0, 1], torch.device("cpu")
    parts = [t if p == pid else None for p in own]
    like = ((2,), torch.float32)
    out["coll"] = {
        "gather": coll.gather(parts, cpu, owners=own, like=like).tolist(),
        "stack": coll.gather(parts, cpu, owners=own, like=like,
                             tiled=False).tolist(),
        "elsewhere": (lambda g: None if g is None else g.tolist())(
            coll.gather([None, None] if pid == 0 else [t, t], cpu,
                        owners=[1, 1], like=like)),
        **{name: getattr(coll, name)(parts, cpu, owners=own,
                                     like=like).tolist()
           for name in ("reduce_min", "reduce_max", "reduce_sum")},
        **{name: [None if x is None else x.tolist() for x in getattr(
            coll, name)(parts, owners=own, like=like)]
           for name in ("allreduce_min", "allreduce_max", "allreduce_sum")},
    }
    coll.barrier(placed)
    out["merge_bytes_dcn"] = sum(
        s["value"] for s in obs.snapshot()[obs.names.MERGE_BYTES]["series"]
        if s["labels"]["level"] == "dcn")
    out["health"] = [ln for ln in obs.health.render_text(
        obs.health.report()).splitlines() if ln.startswith("multihost:")]
else:
    for label, mesh in (("2x2", multihost.global_mesh(2, 2)),
                        ("1x4", multihost.global_mesh(1, 4)),
                        ("hosts4", multihost.global_host_mesh(1, 4, 1))):
        for merge in ("ring", "allgather"):
            knn = ShardedKNN(db, k=K, mesh=mesh, merge=merge,
                             dcn_merge=merge if label == "hosts4" else None)
            out[f"{label}/{merge}"] = {"search": searched(knn),
                                       "certified": certified(knn)}
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
multihost.shutdown()
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, n_proc, mode="main", timeout=120):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(CHILD))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(p), str(n_proc), str(port), mode,
         str(tmp_path / "autotune.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(n_proc)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, err[-3000:]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gm2"), 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gm4"), 4)


def _jsonable(x):
    return json.loads(json.dumps(x))


def _logical(shape, **kw):
    db, _, labels = data()
    mk = make_mesh if len(shape) == 2 else make_host_mesh
    mesh = mk(*shape, devices=["cpu"] * int(np.prod(shape)))
    return ShardedKNN(db, k=K, mesh=mesh, **kw)


def _oracle_idx(db, q, k=K):
    od = oracles.sq_l2(q, db)
    return np.lexsort((np.broadcast_to(np.arange(db.shape[0]), od.shape),
                       od), axis=-1)[:, :k]


def _certified_ref(knn, results, **kw):
    _, q, _ = data()
    d, i, st = knn.search_certified(q, margin=MARGIN,
                                    tune_cache=results[0]["tune"], **kw)
    return _jsonable({"d": d.tolist(), "i": i.tolist(), "stats": st})


def _search_ref(knn):
    _, q, _ = data()
    d, i = knn.search(q)
    return {"d": d.tolist(), "i": i.tolist()}


def test_every_process_returns_the_same_whole_result(two, four):
    for results in (two, four):
        for key in results[0]:
            if key.startswith(("report", "mesh", "host/")) or \
                    key in ("health", "host_mesh", "coll"):
                continue
            for r in results[1:]:
                assert r[key] == results[0][key], key
        for r in results:
            assert r["foreign"] == [] and r["backend"] == "gloo"
    mesh0, local0 = two[0]["mesh"]
    assert "p0:cpu, p1:cpu; rank 0" in mesh0 and local0 == [[0, 0]]
    assert two[1]["mesh"][1] == [[0, 1]]


def test_two_process_search_is_the_logical_mesh_and_jax(two):
    db, q, labels = data()
    got = two[0]["search"]
    assert got == _search_ref(_logical((1, 2), labels=labels,
                                       num_classes=CLASSES))
    _, ji = JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K).search(q)
    np.testing.assert_array_equal(np.asarray(got["i"]), np.asarray(ji))
    np.testing.assert_array_equal(np.asarray(got["i"]), _oracle_idx(db, q))


@pytest.mark.parametrize("arm", ARMS)
def test_two_process_certified_pallas_bitwise(two, arm):
    db, q, _ = data()
    got = two[0][f"pallas/{arm}"]
    assert got == _certified_ref(_logical((1, 2)), two, precision=arm)
    _, ji, _ = JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K).search_certified(
        q, selector="pallas", margin=MARGIN, precision=arm)
    np.testing.assert_array_equal(np.asarray(got["i"]), ji)
    np.testing.assert_array_equal(np.asarray(got["i"]), _oracle_idx(db, q))
    assert got["stats"]["certified"] + got["stats"]["fallback_queries"] == NQ


@pytest.mark.parametrize("selector", SELECTORS)
def test_two_process_counted_selectors_bitwise(two, selector):
    db, q, _ = data()
    got = two[0][f"counted/{selector}"]
    assert got == _certified_ref(_logical((1, 2)), two, selector=selector)
    jd, ji, _ = JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K).search_certified(
        q, selector=selector, margin=MARGIN)
    np.testing.assert_array_equal(np.asarray(got["i"]), ji)
    # float64 refines of the same candidates: the JAX package's values
    np.testing.assert_array_equal(np.asarray(got["d"]), jd)


def test_two_process_predict_and_estimator(two):
    db, q, labels = data()
    want = JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K, labels=labels,
                         num_classes=CLASSES).predict(q)
    np.testing.assert_array_equal(np.asarray(two[0]["predict"]),
                                  np.asarray(want))
    lab, st = two[0]["predict_certified"]
    ref = _logical((1, 2), labels=labels, num_classes=CLASSES)
    rlab, rst = ref.predict_certified(q, margin=MARGIN,
                                      tune_cache=two[0]["tune"])
    assert lab == rlab.tolist() and st == _jsonable(rst)
    one = KNNClassifier(k=K, device="cpu").fit(db, labels).predict(q)
    np.testing.assert_array_equal(np.asarray(two[0]["classifier"]),
                                  np.asarray(one))


def test_two_process_radius_search(two):
    db, q, _ = data()
    got = two[0]["radius"]
    r = got["r"]
    rd, ri, rc = _logical((1, 2)).radius_search(q, r, max_neighbors=6)
    assert got == _jsonable({"r": r, "d": rd.tolist(), "i": ri.tolist(),
                             "c": rc.tolist()})
    _, ji, jc = JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K).radius_search(
        q, r, max_neighbors=6)
    np.testing.assert_array_equal(np.asarray(got["i"]), np.asarray(ji))
    np.testing.assert_array_equal(np.asarray(got["c"]), np.asarray(jc))
    d64 = np.sqrt(oracles.sq_l2(q, db))
    np.testing.assert_array_equal(np.asarray(got["c"]), (d64 <= r).sum(-1))


@pytest.mark.parametrize("merge,dcn", PAIRS)
def test_two_process_host_mesh_bitwise_flat_and_oracle(two, merge, dcn):
    db, q, _ = data()
    got = two[0][f"host/{merge}/{dcn}"]
    assert "p0:cpu, p1:cpu" in two[0]["host_mesh"]
    # the flat spanning mesh of the same four shards, two a process
    flat = two[0]["flat4"]
    assert got["search"] == flat["search"]
    assert got["certified"]["d"] == flat["certified"]["d"]
    assert got["certified"]["i"] == flat["certified"]["i"]
    assert flat["certified"] == _certified_ref(_logical((1, 4)), two)
    assert flat["certified"]["i"] == two[0]["flat/ring"]["certified"]["i"]
    np.testing.assert_array_equal(np.asarray(got["certified"]["i"]),
                                  _oracle_idx(db, q))
    rep = got["report"]
    assert rep["transport"] == "in_mesh:gloo" and rep["hosts"] == 2
    assert rep["dcn_merge"] == dcn
    assert rep["dcn_merge_bytes"] == merge_bytes(NQ, K, 2, dcn)
    if dcn == "ring":  # one send / recv hop of the accumulator
        ops = [e["op"] for e in rep["exchange_log"]]
        assert ("send" in ops) != ("recv" in ops)


def test_two_process_flat_merges_agree_and_report(two):
    for merge in ("ring", "allgather"):
        assert two[0][f"flat/{merge}"] == two[0]["flat/ring"]
        assert two[0][f"flat/{merge}"]["certified"] == _certified_ref(
            _logical((1, 2), merge=merge), two)
    for r in two:
        rep = r["report_certified"]
        assert rep["transport"] == "in_mesh:gloo"
        assert rep["hosts"] == 2 and rep["exchanges"] == len(
            rep["exchange_log"]) > 0
        assert rep["exchange_bytes"] == sum(
            e["bytes"] for e in rep["exchange_log"]) > 0
        assert {e["op"] for e in rep["exchange_log"]} == {"all_gather",
                                                          "all_reduce"}
        assert r["report_search"]["dcn_merge_bytes"] == merge_bytes(
            NQ, K, 2, r["report_search"]["dcn_merge"])
        assert r["health"][0].startswith("multihost: 2 host(s) [in_mesh:gloo]")
        # every search of a flat spanning mesh counts its db level as the
        # cross-process level: the first search, 2 flat, 4 host meshes,
        # the placed and the padded placed searches
        assert r["merge_bytes_dcn"] > 0


def test_two_process_collectives_cross_the_group(two):
    for pid, r in enumerate(two):
        c = r["coll"]
        assert c["gather"] == [0.0, 10.0, 1.0, 9.0]
        assert c["stack"] == [[0.0, 10.0], [1.0, 9.0]]
        assert c["reduce_min"] == [0.0, 9.0]
        assert c["reduce_max"] == [1.0, 10.0]
        assert c["reduce_sum"] == [1.0, 19.0]
        for name, want in (("allreduce_min", [0.0, 9.0]),
                           ("allreduce_max", [1.0, 10.0]),
                           ("allreduce_sum", [1.0, 19.0])):
            # the total at this process's participant, None at the other's
            assert c[name][pid] == want and c[name][1 - pid] is None
    # both participants on process 1: process 0 takes no part
    assert two[0]["coll"]["elsewhere"] is None
    assert two[1]["coll"]["elsewhere"] == [1.0, 9.0, 1.0, 9.0]


def test_two_process_shard_across_hosts(two):
    db, q, _ = data()
    assert two[0]["placed"] == _search_ref(_logical((1, 2)))
    assert two[0]["placed_gather"] is True
    kind, msg = two[0]["placed_certified"]
    assert kind == "ValueError" and "needs a host copy" in msg
    got = np.asarray(two[0]["placed_padded"]["i"])
    np.testing.assert_array_equal(got, _oracle_idx(db[:N - 3], q))
    real = float((db[:N - 3].astype(np.float64) ** 2).sum(-1).max())
    for r in two:
        assert r["placed_padded_norm"] == [real]
    kind, msg = two[0]["n_train_outside"]
    assert kind == "ValueError" and "outside" in msg


@pytest.mark.parametrize("name", [
    "ServingEngine", "search_bucketed", "hosttier", "pq", "overlap",
    "streaming_kernel", "fused_kernel"])
def test_two_process_queued_paths_refused_by_name(two, name):
    kind, msg = two[0][f"queued/{name}"]
    assert kind == "ValueError" and "spans processes is queued" in msg


@pytest.mark.parametrize("label,shape", [("2x2", (2, 2)), ("1x4", (1, 4))])
@pytest.mark.parametrize("merge", ["ring", "allgather"])
def test_four_processes_bitwise_logical_and_jax(four, label, shape, merge):
    db, q, _ = data()
    got = four[0][f"{label}/{merge}"]
    ref = _logical(shape, merge=merge)
    assert got["search"] == _search_ref(ref)
    assert got["certified"] == _certified_ref(ref, four)
    jmesh = jax_mesh(*shape)
    _, ji = JaxShardedKNN(db, mesh=jmesh, k=K).search(q)
    np.testing.assert_array_equal(np.asarray(got["search"]["i"]),
                                  np.asarray(ji))
    _, ji, _ = JaxShardedKNN(db, mesh=jmesh, k=K).search_certified(
        q, selector="pallas", margin=MARGIN)
    np.testing.assert_array_equal(np.asarray(got["certified"]["i"]), ji)


@pytest.mark.parametrize("merge", ["ring", "allgather"])
def test_four_processes_on_the_host_axis_bitwise_flat(four, merge):
    db, q, _ = data()
    got = four[0][f"hosts4/{merge}"]
    flat = four[0]["1x4/ring"]
    assert got["search"] == flat["search"]
    assert got["certified"]["i"] == flat["certified"]["i"]
    assert got["certified"]["d"] == flat["certified"]["d"]
    np.testing.assert_array_equal(np.asarray(got["certified"]["i"]),
                                  _oracle_idx(db, q))


def test_lost_peer_raises_within_the_group_timeout(tmp_path):
    results = _spawn(tmp_path, 2, mode="lost", timeout=60)
    for r in results:
        kind, msg = r["nccl"]
        assert kind == "ValueError" and "backend='gloo'" in msg
        assert r["before"] == results[0]["before"]
    kind, _ = results[0]["lost"]
    assert kind in ("RuntimeError", "DistBackendError")
    assert 2.5 < results[0]["waited_s"] < 11


def test_nccl_on_one_card_is_refused_by_name():
    one_card = {"devices": ["cuda:0"], "ids": ["cuda/GPU-1234"]}
    with pytest.raises(ValueError, match="two processes on one card.*"
                                         "backend='gloo'"):
        multihost.check_backend("nccl", [one_card, dict(one_card)])
    with pytest.raises(ValueError, match="runs on cards"):
        multihost.check_backend("nccl", [{"devices": ["cpu"],
                                          "ids": ["cpu/h"]}] * 2)
    multihost.check_backend("nccl", [
        one_card, {"devices": ["cuda:0"], "ids": ["cuda/GPU-5678"]}])
    multihost.check_backend("gloo", [one_card, dict(one_card)])


def test_spanning_mesh_owners_and_remote_blocks():
    owners = [0, 0, 1, 1]
    m0 = make_mesh(1, 4, devices=["cpu"] * 4, owners=owners, rank=0)
    m1 = make_mesh(1, 4, devices=["cpu"] * 4, owners=owners, rank=1)
    local = make_mesh(1, 4, devices=["cpu"] * 4)
    assert m0.spans_processes and not local.spans_processes
    assert m0.local_positions == [(0, 0), (0, 1)]
    assert m1.local_positions == [(0, 2), (0, 3)]
    # two processes' "cpu" are two devices: the mesh is logical only
    # within a process, and keyed by (owner, device)
    assert m0 == m1 and m0 != local and hash(m0) == hash(m1)
    assert m0.logical and m0.distinct_devices == [m0.first_device]
    two = make_mesh(1, 2, devices=["cpu"] * 2, owners=[0, 1], rank=0)
    assert not two.logical
    placed = coll.shard(np.arange(8.0).reshape(4, 2), local, "db")
    remote = coll.Placed(m0, np.array([[placed.parts[0, 0],
                                        placed.parts[0, 1], None, None]],
                                      dtype=object), "db", 0, (4, 2))
    assert remote.block(1) is placed.parts[0, 1]
    with pytest.raises(ValueError, match="lies on process"):
        remote.block(2)
    with pytest.raises(ValueError, match="the process of each"):
        make_mesh(1, 2, owners=[0, 1])
    host = make_host_mesh(1, 2, 2, devices=["cpu"] * 4, owners=owners,
                          rank=1)
    assert host.local_positions == [(0, 1, 0), (0, 1, 1)]
