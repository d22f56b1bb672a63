"""The port's autotuner (knn_tpu_torch.tuning) — tests/test_tuning.py's
cases that have a counterpart, on the CPU (the plain versions): winner
persistence and reload, zero re-timing on a warm cache, key mismatches and
stale kernel tokens falling back to the defaults, the bitwise gate keeping
broken candidates from winning, explicit knobs beating the cache, the CLI
round trip, and the grid: the JAX package's at every level and profile
with its block_q axis removed."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from knn_tpu import tuning as jax_tuning
from knn_tpu_torch import tuning
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

# the module (the package exports the autotune function under its name)
autotune_mod = importlib.import_module("knn_tpu_torch.tuning.autotune")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(700, 16)).astype(np.float32) * 10
    q = rng.normal(size=(9, 16)).astype(np.float32) * 10
    return db, q


@pytest.fixture
def cache_path(tmp_path):
    return str(tmp_path / "autotune.json")


def _tune(db, q, cache_path, **kw):
    kw = {"margin": 8, "grid_level": "quick", "runs": 1, **kw}
    return tuning.autotune(db, q, 5, cache_path=cache_path, device="cpu",
                           **kw)


def test_winner_persistence_and_reload_roundtrip(data, cache_path):
    db, q = data
    tuning.reset_counters()
    entry = _tune(db, q, cache_path)
    assert entry["cached"] is False
    assert tuning.counters()["candidates_timed"] >= 3
    raw = json.load(open(cache_path))
    assert raw["version"] == 1
    (key,) = raw["entries"]
    assert key == tuning.cache_key("cpu", 700, 16, 5, "l2")
    reloaded = tuning.TuneCache(cache_path).get(key)
    assert reloaded["knobs"] == entry["knobs"]
    assert reloaded["winner_ms"] == entry["winner_ms"]
    assert "smem" not in entry           # the resource gate: CUDA only
    knobs, info = tuning.resolve_full(700, 16, 5, cache_path=cache_path,
                                      device_kind="cpu")
    assert info["source"] == "cache"
    assert knobs == {**tuning.DEFAULT_KNOBS, **entry["knobs"]}


def test_warm_cache_zero_retiming(data, cache_path):
    db, q = data
    _tune(db, q, cache_path)
    tuning.reset_counters()
    entry = _tune(db, q, cache_path)
    assert entry["cached"] is True
    c = tuning.counters()
    assert c["candidates_timed"] == 0
    assert c["tune_searches"] == 0
    assert c["cache_hits"] == 1


def test_cache_key_mismatch_falls_back_to_defaults(data, cache_path):
    db, q = data
    _tune(db, q, cache_path)
    for kwargs in (
        dict(n=700, d=16, k=7),
        dict(n=701, d=16, k=5),
        dict(n=700, d=32, k=5),
        dict(n=700, d=16, k=5, metric="cosine"),
        dict(n=700, d=16, k=5, device_kind="NVIDIA H100 80GB HBM3"),
    ):
        n, d, k = (kwargs.pop(key) for key in ("n", "d", "k"))
        kwargs.setdefault("device_kind", "cpu")
        knobs, info = tuning.resolve_full(n, d, k, cache_path=cache_path,
                                          **kwargs)
        assert info["source"] == "default", kwargs
        assert knobs == tuning.DEFAULT_KNOBS


def test_gate_failed_candidate_can_never_win(data, cache_path, monkeypatch):
    db, q = data
    real_search = autotune_mod._search_once

    def corrupt_streaming(queries, knn, k, margin, knobs):
        d, i = real_search(queries, knn, k, margin, knobs)
        if knobs["kernel"] == "streaming":
            i = np.array(i)
            i[0, 0] = (i[0, 0] + 1) % knn.n_train  # one wrong neighbor
        return d, i

    monkeypatch.setattr(autotune_mod, "_search_once", corrupt_streaming)
    tuning.reset_counters()
    entry = _tune(db, q, cache_path)
    assert entry["timings_ms"]["kernel=streaming"] is None
    assert "bitwise gate" in entry["errors"]["kernel=streaming"]
    assert entry["knobs"]["kernel"] != "streaming"
    assert tuning.counters()["candidates_gated_out"] >= 1
    knobs, info = tuning.resolve_full(700, 16, 5, cache_path=cache_path,
                                      device_kind="cpu")
    assert info["source"] == "cache"
    assert knobs["kernel"] != "streaming"


def test_explicit_knobs_beat_cache(data, cache_path):
    db, q = data
    key = tuning.cache_key("cpu", 700, 16, 5, "l2")
    tuning.TuneCache(cache_path).put(key, {
        "knobs": {**tuning.DEFAULT_KNOBS, "kernel": "streaming",
                  "tile_n": 256, "survivors": 4},
        "winner_ms": 1.0,
    })
    knobs, info = tuning.resolve_full(
        700, 16, 5, cache_path=cache_path, device_kind="cpu",
        overrides={"kernel": "tiled", "survivors": None})
    assert info["source"] == "cache"
    assert knobs["kernel"] == "tiled"        # the override beat the cache
    assert knobs["tile_n"] == 256            # un-overridden cache knobs kept
    assert knobs["survivors"] == 4
    assert info["overridden"] == ["kernel"]

    # end to end through ShardedKNN.search_certified: explicit args win,
    # the rest comes from the cache, and the stats record both
    prog = ShardedKNN(db, k=5, device="cpu")
    _, i_cache, st = prog.search_certified(q, margin=8, tune_cache=cache_path)
    assert st["tuning"]["source"] == "cache"
    assert st["pallas_knobs"]["kernel"] == "streaming"
    assert st["pallas_knobs"]["tile_n"] == 256
    assert st["pallas_knobs"]["survivors"] == 4
    _, i_over, st2 = prog.search_certified(
        q, margin=8, tune_cache=cache_path, kernel="tiled", tile_n=384,
        survivors=2)
    assert st2["pallas_knobs"]["kernel"] == "tiled"
    assert st2["pallas_knobs"]["tile_n"] == 384
    assert set(st2["tuning"]["overridden"]) == {"kernel", "tile_n",
                                                "survivors"}
    np.testing.assert_array_equal(i_cache, i_over)


def test_resolve_rejects_unknown_knob():
    with pytest.raises(ValueError, match="unknown pallas knob"):
        tuning.resolve(100, 8, 3, overrides={"warp_speed": 9})
    # block_q has no CUDA meaning: the port takes no such knob
    with pytest.raises(ValueError, match="unknown pallas knob"):
        tuning.resolve(100, 8, 3, overrides={"block_q": 256})


def test_corrupt_cache_degrades_to_defaults(cache_path):
    with open(cache_path, "w") as f:
        f.write("{not json")
    knobs, info = tuning.resolve_full(700, 16, 5, cache_path=cache_path,
                                      device_kind="cpu")
    assert info["source"] == "default"
    assert knobs == tuning.DEFAULT_KNOBS


def test_cli_tune_roundtrip_zero_retiming(tmp_path):
    cache = str(tmp_path / "cli_tune.json")
    args = [sys.executable, "-m", "knn_tpu_torch.cli", "tune", "--n", "600",
            "--dim", "8", "--k", "3", "--queries", "8", "--margin", "4",
            "--grid", "quick", "--runs", "1", "--cache", cache,
            "--device", "cpu"]
    env = {key: v for key, v in os.environ.items() if key != "PYTHONPATH"}

    def run():
        r = subprocess.run(args, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    first = run()
    assert first["cached"] is False
    assert first["counters"]["candidates_timed"] >= 3
    assert os.path.exists(cache)
    second = run()
    assert second["cached"] is True
    assert second["counters"]["candidates_timed"] == 0
    assert second["counters"]["tune_searches"] == 0
    assert second["knobs"] == first["knobs"]


def test_cache_key_carries_the_port_kernel_version_token():
    key = tuning.cache_key("cpu", 700, 16, 5, "l2")
    token = tuning.kernel_version_token()
    assert key.endswith(f"|kv{token}")
    assert token.startswith("torch")
    # no JAX package key for the same shape can match
    assert key != jax_tuning.cache_key("cpu", 700, 16, 5, "l2", None)


def test_stale_kernel_version_entry_falls_back_to_defaults(cache_path):
    key = tuning.cache_key("cpu", 700, 16, 5, "l2")
    base = key.rsplit("|kv", 1)[0]
    cache = tuning.TuneCache(cache_path)
    cache.put(base, {"knobs": {**tuning.DEFAULT_KNOBS, "kernel": "streaming"}})
    cache.put(base + "|kvtorch1-000000000000",
              {"knobs": {**tuning.DEFAULT_KNOBS, "tile_n": 256}})
    cache.put(jax_tuning.cache_key("cpu", 700, 16, 5, "l2", None),
              {"knobs": {**tuning.DEFAULT_KNOBS, "precision": "int4"}})
    knobs, info = tuning.resolve_full(700, 16, 5, cache_path=cache_path,
                                      device_kind="cpu")
    assert info["source"] == "default"
    assert knobs == tuning.DEFAULT_KNOBS
    cache.put(key, {"knobs": {**tuning.DEFAULT_KNOBS, "survivors": 3}})
    knobs, info = tuning.resolve_full(700, 16, 5, cache_path=cache_path,
                                      device_kind="cpu")
    assert info["source"] == "cache"
    assert knobs["survivors"] == 3


def _strip_block_q(grid):
    out, seen = [], set()
    for cand in grid:
        cand = {key: v for key, v in cand.items() if key != "block_q"}
        label = json.dumps(cand, sort_keys=True)
        if label not in seen:
            seen.add(label)
            out.append(cand)
    return out


@pytest.mark.parametrize("profile", ["latency", "throughput"])
@pytest.mark.parametrize("level", ["quick", "standard", "full"])
def test_knob_grid_is_the_reference_grid_without_block_q(level, profile):
    assert tuning.knob_grid(level, profile) == _strip_block_q(
        jax_tuning.knob_grid(level, profile))
    # every candidate is a set of the port's knobs, none refused by them
    from knn_tpu_torch.ops import coarse_knn as ck

    for cand in tuning.knob_grid(level, profile):
        assert set(cand) == set(tuning.DEFAULT_KNOBS)
        ck.check_knobs(**{key: cand[key] for key in (
            "precision", "binning", "grid_order", "kernel", "final_select",
            "bin_w", "survivors")})


def test_standard_grid_includes_int8_candidate():
    grid = tuning.knob_grid("standard")
    assert any(c["precision"] == "int8" for c in grid)
    assert all(c["precision"] != "int8" for c in tuning.knob_grid("quick"))
    assert any(c["precision"] == "int8" and c["kernel"] == "streaming"
               for c in tuning.knob_grid("full"))


def test_grid_covers_sub_int8_arms_and_refuses_pq_fused():
    std = tuning.knob_grid("standard")
    assert any(c["precision"] == "int4" and c["kernel"] == "streaming"
               for c in std)
    assert any(c["precision"] == "pq" and c["kernel"] == "streaming"
               for c in std)
    assert any(c["precision"] == "pq" and c["kernel"] == "tiled" for c in std)
    assert any(c["precision"] == "int4" and c["kernel"] == "fused"
               for c in tuning.knob_grid("full"))
    for level in ("quick", "standard", "full"):
        assert all(not (c["precision"] == "pq" and c["kernel"] == "fused")
                   for c in tuning.knob_grid(level)), level
        # survivors and bin_w are no axis of the grid, as in the reference
        assert all(c["survivors"] is None and c["bin_w"] is None
                   for c in tuning.knob_grid(level))
    assert all(c["precision"] not in ("int4", "pq")
               for c in tuning.knob_grid("quick"))


def test_gated_out_int8_candidate_can_never_win(data, cache_path,
                                                monkeypatch):
    db, q = data
    real_search = autotune_mod._search_once

    def corrupt_int8(queries, knn, k, margin, knobs):
        d, i = real_search(queries, knn, k, margin, knobs)
        if knobs["precision"] == "int8":
            i = np.array(i)
            i[0, 0] = (i[0, 0] + 1) % knn.n_train
        return d, i

    monkeypatch.setattr(autotune_mod, "_search_once", corrupt_int8)
    tuning.reset_counters()
    grid = [dict(tuning.DEFAULT_KNOBS),
            {**tuning.DEFAULT_KNOBS, "precision": "int8"}]
    entry = _tune(db, q, cache_path, grid=grid)
    assert entry["timings_ms"]["precision=int8"] is None
    assert "bitwise gate" in entry["errors"]["precision=int8"]
    assert entry["knobs"]["precision"] != "int8"
    assert tuning.counters()["candidates_gated_out"] >= 1


def test_int8_candidate_eligible_when_results_match(cache_path):
    rng = np.random.default_rng(1)
    db = rng.integers(-100, 101, size=(700, 16)).astype(np.float32)
    db[:, 0] = 127.0  # pins every row scale at exactly 1.0
    q = rng.integers(-100, 101, size=(9, 16)).astype(np.float32)
    q[:, 0] = 127.0
    grid = [dict(tuning.DEFAULT_KNOBS),
            {**tuning.DEFAULT_KNOBS, "precision": "int8"}]
    entry = _tune(db, q, cache_path, grid=grid)
    assert entry["timings_ms"]["precision=int8"] is not None
    assert "precision=int8" not in entry["errors"]


def test_deep_survivors_candidate_rides_the_gate(data, cache_path):
    # survivors reach a search through a grid (or a cache entry): the deep
    # build's certified answer is the default's, so it is eligible; at one
    # survivor more queries fall back to the float64 repair, whose
    # distances are not the f32 ones the default returns: gated out, with
    # the reason, as any candidate whose final answer differs
    db, q = data
    grid = [dict(tuning.DEFAULT_KNOBS),
            {**tuning.DEFAULT_KNOBS, "survivors": 5},
            {**tuning.DEFAULT_KNOBS, "survivors": 3, "kernel": "fused"},
            {**tuning.DEFAULT_KNOBS, "survivors": 1}]
    entry = _tune(db, q, cache_path, grid=grid)
    assert entry["timings_ms"]["survivors=5"] is not None
    assert entry["timings_ms"]["kernel=fused,survivors=3"] is not None
    assert entry["errors"] == {"survivors=1":
                               "bitwise gate: result != reference"}


def test_unported_tuner_parts_are_refused_by_name(data, cache_path):
    db, q = data
    # pruning is ported (tests/test_torch_roofline.py); a threshold that
    # is no threshold is refused by name
    with pytest.raises(ValueError, match="prune must be a threshold"):
        _tune(db, q, cache_path, prune=0.0)
    with pytest.raises(ValueError, match="squared-L2"):
        _tune(db, q, cache_path, metric="cosine")


def test_throughput_profile_grid_is_a_superset():
    for level in ("quick", "standard", "full"):
        lat = tuning.knob_grid(level)
        thr = tuning.knob_grid(level, profile="throughput")
        assert lat == tuning.knob_grid(level, profile="latency")
        assert thr[: len(lat)] == lat
        assert len(thr) >= len(lat)
    # without block_q, what the ladder adds is its tile and precision arms
    assert len(tuning.knob_grid("quick", "throughput")) == 11
    assert {"precision": "int8", "tile_n": 32768} in [
        {key: c[key] for key in ("precision", "tile_n")}
        for c in tuning.knob_grid("standard", "throughput")]
    with pytest.raises(ValueError, match="profile"):
        tuning.knob_grid("standard", profile="bulk")


def test_cache_key_is_the_reference_latency_layout_at_float32():
    kind = "NVIDIA H100 80GB HBM3"
    key = tuning.cache_key(kind, 1_000_000, 128, 100, "L2")
    assert tuning.PROFILES == jax_tuning.PROFILES
    # the JAX package's latency key, field for field, up to its tokens
    ref = jax_tuning.cache_key(kind, 1_000_000, 128, 100, "L2", None)
    assert key.split("|rl", 1)[0] == ref.split("|rl", 1)[0]
    assert key == (f"{kind}|n1000000|d128|k100|l2|float32"
                   f"|rl{tuning.roofline_token()}"
                   f"|kv{tuning.kernel_version_token()}")


def test_default_cache_path_is_the_ports_own():
    path = tuning.default_cache_path()
    assert path.endswith(os.path.join(".cache", "knn_tpu_torch",
                                      "autotune.json"))
    assert path != jax_tuning.default_cache_path()


def test_search_without_a_cache_path_runs_the_defaults(data):
    # the module's default cache is empty (empty_default_tune_cache)
    db, q = data
    _, _, st = ShardedKNN(db, k=5, device="cpu").search_certified(q, margin=8)
    assert st["tuning"]["source"] == "default"
    assert st["pallas_knobs"] == tuning.DEFAULT_KNOBS


@pytest.mark.parametrize("entry", ["search_certified", "predict_certified"])
def test_search_without_a_cache_path_reads_the_default_cache(
        data, empty_default_tune_cache, entry):
    db, q = data
    labels = np.arange(db.shape[0], dtype=np.int32) % 3
    prog = ShardedKNN(db, k=5, labels=labels, num_classes=3, device="cpu")
    key = tuning.cache_key("cpu", 700, 16, 5, "l2")
    cache = tuning.TuneCache(empty_default_tune_cache)
    cache.put(key, {"knobs": {**tuning.DEFAULT_KNOBS, "kernel": "streaming",
                              "survivors": 3}})
    try:
        if entry == "search_certified":
            _, i, st = prog.search_certified(q, margin=8)
            _, i_ref, _ = prog.search_certified(
                q, margin=8, kernel="streaming", survivors=3,
                tune_cache=str(empty_default_tune_cache) + ".absent")
            np.testing.assert_array_equal(i, i_ref)
        else:
            _, st = prog.predict_certified(q, margin=8)
        assert st["tuning"]["source"] == "cache"
        assert st["tuning"]["cache_path"] == empty_default_tune_cache
        assert st["pallas_knobs"]["kernel"] == "streaming"
        assert st["pallas_knobs"]["survivors"] == 3
    finally:
        os.remove(empty_default_tune_cache)
