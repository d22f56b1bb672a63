"""The port's H100 roofline (knn_tpu_torch.obs.roofline), the device-trace
summary (obs.profiler) and the tuner's roofline pruning, on the CPU.

What is pinned: the per-kernel bounds at the SIFT1M shape are PERF.md's
(K1 3.18 ms, K5 0.53 ms, K7 15.67 ms on the H100's data-sheet peaks, to
the printed digit); the model's geometry mirrors ops.coarse_knn's exactly;
``db_operand_nbytes`` equals the bytes of the operands ShardedKNN places
for every arm; ``validate_block`` accepts every block the model emits and
rejects malformed ones; ``publish`` is a no-op with obs off; pruned
candidates are never timed and each carries ``ceiling_qps < threshold x
best``, and without ``prune`` the timed grid is the whole grid.
"""

import json
import types

import numpy as np
import pytest
import torch

from knn_tpu_torch import obs, tuning
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.obs import profiler
from knn_tpu_torch.obs import roofline as rl
from knn_tpu_torch.ops import coarse_knn as ck

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

H100 = "NVIDIA H100 80GB HBM3"
NQ, N, DP = 4096, 1_000_000, 128


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset(enabled=True)
    obs.reset_event_log()
    rl.reset()
    yield
    obs.reset()
    rl.reset()


# -- the per-kernel bounds (chip_smoke.py's numbers) ------------------------
def test_main_shape_bounds_are_perf_md_s():
    n_tiles = -(-N // ck.TILE_N)
    k1 = rl.f32_bound(NQ, N, DP, n_tiles, 2)
    assert round(k1["bound_ms"], 2) == 3.18 and k1["bound_by"] == "operations"
    k5 = rl.int_bound(NQ, N, DP, n_tiles, 2, "int8")
    assert round(k5["bound_ms"], 2) == 0.53
    k7 = rl.pq_bound(NQ, N, 32, 256, n_tiles, 256, 128, 132, 1.98e9)
    assert round(k7["bound_ms"], 2) == 15.67
    assert k7["lookup_ms"] > k7["add_ms"] > k7["bytes_ms"]
    # the bound counts the real rows and dims only
    assert rl.f32_bound(NQ, N, 256, n_tiles, 2, d_real=129)["flops"] == \
        3 * 2 * NQ * N * 129


def test_peaks_and_the_h100_row():
    peaks, est = rl.peaks_for(H100)
    assert not est and peaks["bf16_flops"] == rl.PEAK_BF16_FLOPS == 989e12
    assert rl.PEAK_HBM_BYTES == 3.35e12 and rl.SMEM_WORDS_PER_CLOCK == 32
    assert rl.ESTIMATED_PEAKS[H100] == ("h2d_gbps",)
    for kind in ("TPU v5e", None, "NVIDIA A100"):
        peaks, est = rl.peaks_for(kind)
        assert est and peaks == rl.GENERIC_CPU_PEAKS
    assert rl.peaks_for(H100, backend="cpu")[1]


def test_model_at_the_main_shape_is_k1s_bound():
    m = rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, device_kind=H100)
    assert m["bound_class"] == "tensor_core_bound"
    assert round(m["terms"]["tensor_core"]["time_s"] * 1e3, 2) == 3.18
    assert m["ceiling_qps"] == round(NQ / m["terms"]["tensor_core"]["time_s"],
                                     1)
    assert m["config"]["n_tiles"] == 62 and not m["estimated"]
    pq = rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, precision="pq",
                              device_kind=H100)
    assert pq["bound_class"] == "smem_bound"
    assert round(pq["terms"]["smem"]["time_s"] * 1e3, 2) == 15.67
    i8 = rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, precision="int8",
                              device_kind=H100)
    assert round(i8["terms"]["tensor_core"]["time_s"] * 1e3, 2) == 0.53
    hi = rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, precision="highest",
                              device_kind=H100)
    assert hi["terms"]["tensor_core"]["dtype"] == "fp64"
    # the kernel and grid only reorder the same work
    for kw in ({"kernel": "streaming"}, {"kernel": "fused"},
               {"grid_order": "db_major"}):
        assert rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ,
                                    device_kind=H100, **kw)[
            "ceiling_qps"] == m["ceiling_qps"]


def test_a_measured_pct_of_the_bound_never_exceeds_one():
    """The main search's measured q/s sits below its ceiling (PERF.md:
    pallas 69.0k-70.8k q/s warm, a ceiling of ~1.29M q/s)."""
    m = rl.attribute(rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ,
                                          device_kind=H100), 70_800.0)
    assert 0 < m["roofline_pct"] < 0.1


@pytest.mark.parametrize("n,tile,bin_w,surv,binning", [
    (1_000_000, 16384, 128, None, "grouped"),
    (700, 16384, 128, None, "grouped"),
    (5000, 4096, 256, 3, "lane"),
    (300, 1024, 128, 8, "grouped"),
    (70_000, 8192, 512, None, "lane"),
])
def test_geometry_mirrors_coarse_knn(n, tile, bin_w, surv, binning):
    for width in (30, 130, 900):
        eff = ck.effective_tile(n, tile, bin_w, surv, binning, width)
        assert rl.effective_tile(n, tile, bin_w, surv, binning, width) == eff
        assert rl.geometry(eff, bin_w, surv, binning) == ck._geometry(
            eff, bin_w, surv, binning)
    assert (rl.TILE_N_DEFAULT, rl.BIN_W, rl.DIM_CHUNK, rl.MAX_SURVIVORS,
            rl.SURVIVORS_GROUPED_DEFAULT) == (
        ck.TILE_N, ck.BIN_W, ck.DIM_CHUNK, ck.MAX_SURVIVORS, ck.SURVIVORS)


@pytest.mark.parametrize("precision", rl.PRECISIONS)
def test_db_operand_nbytes_is_the_placed_operands(precision):
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(1)
    n, d, tile = 700, 40, 256
    knn = ShardedKNN(rng.normal(size=(n, d)).astype(np.float32), k=4,
                     device="cpu")
    pq = knn._pq_placement() if precision == "pq" else None
    parts = knn._coarse_parts(tile, precision, pq=pq)
    if precision == "pq":
        parts = pq["parts"] if parts is None else parts
    seen, nbytes = set(), 0
    for t in parts:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            nbytes += st.nbytes()
    want = rl.db_operand_nbytes(n, d, precision, tile_n=tile)
    assert sum(want.values()) == nbytes
    assert want["db_aux"] == -(-n // tile) * tile * (
        8 if precision in ("int8", "int4") else 4)


def test_counted_and_join_models():
    ex = rl.counted_cost_model(n=N, d=DP, k=100, nq=NQ, device_kind=H100)
    assert ex["bound_class"] == "cuda_core_bound"
    bf = rl.counted_cost_model(n=N, d=DP, k=100, nq=NQ, dtype="bfloat16",
                               device_kind=H100)
    assert bf["terms"]["tensor_core"]["ops"] == 2.0 * NQ * N * DP
    assert bf["ceiling_qps"] > ex["ceiling_qps"]
    assert rl.cost_model(selector="approx", n=N, d=DP, k=100, nq=NQ,
                         device_kind=H100)["selector"] == "approx"
    j = rl.join_cost_model(n_a=16384, n_b=N, d=DP, k=10,
                           superblock_rows=4096, device_kind=H100)
    assert j["terms"]["h2d"]["bytes"] == 4096 * DP * 4
    assert j["join"]["superblocks"] == 4
    assert j["estimated_peaks"] == ["h2d_gbps"]
    ivf = rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, nprobe=8,
                               ncentroids=1024, device_kind=H100)
    assert ivf["config"]["probe_fraction"] == 8 / 1024
    assert ivf["ceiling_qps"] > rl.pallas_cost_model(
        n=N, d=DP, k=100, nq=NQ, device_kind=H100)["ceiling_qps"]


def test_refusals_by_name():
    with pytest.raises(ValueError, match="queue A item 8"):
        rl.pallas_cost_model(n=N, d=DP, k=10, nq=NQ, db_hosts=2)
    with pytest.raises(ValueError, match="queue A item 8"):
        rl.counted_cost_model(n=N, d=DP, k=10, nq=NQ, db_hosts=4)
    with pytest.raises(ValueError, match="together"):
        rl.pallas_cost_model(n=N, d=DP, k=10, nq=NQ, nprobe=4)
    with pytest.raises(ValueError, match="precision"):
        rl.pallas_cost_model(n=N, d=DP, k=10, nq=NQ, precision="fp8")


def test_validate_block_accepts_real_blocks_and_rejects_malformed():
    blocks = [
        rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, device_kind=H100),
        rl.attribute(rl.pallas_cost_model(n=700, d=16, k=5, nq=9), 12.0),
        rl.counted_cost_model(n=N, d=DP, k=100, nq=NQ),
        rl.join_cost_model(n_a=100, n_b=1000, d=16, k=5, superblock_rows=32),
        rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ, nprobe=2,
                             ncentroids=64, precision="pq"),
    ]
    for b in blocks:
        assert rl.validate_block(b) == []
        assert rl.validate_block(json.loads(json.dumps(b))) == []
    good = blocks[1]
    assert rl.validate_block([1]) == ["roofline block is list, not a dict"]
    assert rl.validate_block({k: v for k, v in good.items()
                              if k != "terms"}) == ["missing field: terms"]
    assert rl.validate_block({**good, "bound_class": "mxu_bound"})
    assert rl.validate_block({**good, "ceiling_qps": -1.0})
    assert rl.validate_block({**good, "model_version": "1"})
    assert rl.validate_block({**good, "estimated": "yes"})
    assert rl.validate_block({**good, "roofline_pct": -0.5})
    assert rl.validate_block({**good, "terms": {"hbm": {"time_s": None}}})


def test_publish_is_a_noop_when_off_and_publishes_once_when_on():
    block = rl.attribute(rl.pallas_cost_model(n=N, d=DP, k=100, nq=NQ,
                                              device_kind=H100), 70_000.0)
    label = rl.config_label(N, DP, 100, device_kind=H100)
    obs.reset(enabled=False)
    rl.publish(label, block)
    assert not rl.was_published(label) and rl.last_reports() == {}
    obs.reset(enabled=True)
    rl.publish(label, block)
    assert rl.was_published(label)
    assert obs.gauge(mn.ROOFLINE_PCT, config=label).get() == \
        block["roofline_pct"]
    assert obs.gauge(mn.ROOFLINE_BOUND, config=label,
                     **{"class": "tensor_core_bound"}).get() == 1.0
    assert obs.counter(mn.ROOFLINE_EVALUATIONS).get() == 1.0
    assert rl.last_reports()[label]["bound_class"] == "tensor_core_bound"
    text = obs.health.render_text(obs.health.report())
    assert f"roofline {label}: " in text
    assert "roofline v1 [pallas]" in rl.render_text(block)


# -- the tuner: roofline pruning, attribution, the cache key --------------
@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(700, 16)).astype(np.float32) * 10
    q = rng.normal(size=(9, 16)).astype(np.float32) * 10
    return db, q


GRID = [dict(tuning.DEFAULT_KNOBS),
        {**tuning.DEFAULT_KNOBS, "precision": "int8"},
        {**tuning.DEFAULT_KNOBS, "precision": "highest"},
        {**tuning.DEFAULT_KNOBS, "kernel": "streaming"},
        {**tuning.DEFAULT_KNOBS, "precision": "bf16x3f"}]


def _timed_labels(entry):
    return {lbl for lbl, ms in entry["timings_ms"].items() if ms is not None}


def test_pruned_candidates_are_never_timed(data, tmp_path, monkeypatch):
    db, q = data
    timed = []
    real = tuning.autotune.__globals__["_timed_program"]

    def spy(knn, queries, margin, knobs):
        timed.append(tuning.autotune.__globals__["_label"](knobs))
        return real(knn, queries, margin, knobs)

    monkeypatch.setitem(tuning.autotune.__globals__, "_timed_program", spy)
    entry = tuning.autotune(db, q, 5, margin=8, grid=GRID, runs=1,
                            cache_path=str(tmp_path / "c.json"),
                            device="cpu", prune=0.5)
    pr = entry["pruning"]
    assert pr["candidates_pruned"] == len(pr["pruned"]) > 0
    assert pr["candidates_modeled"] == len(GRID)
    for label, rec in pr["pruned"].items():
        assert rec["ceiling_qps"] < 0.5 * rec["best_ceiling_qps"]
        assert label not in timed
        assert entry["timings_ms"][label] is None
        assert entry["errors"][label].startswith("roofline-pruned")
    assert set(timed) == _timed_labels(entry)
    assert obs.counter(mn.TUNING_CANDIDATES_PRUNED).get() == \
        pr["candidates_pruned"]
    # the winner's attribution rides the entry and was published
    assert rl.validate_block(entry["roofline"]) == []
    assert entry["roofline_pct"] == entry["roofline"]["roofline_pct"]
    assert set(entry["roofline_per_candidate"]) == set(timed)
    label = rl.config_label(700, 16, 5, device_kind="cpu")
    assert rl.was_published(label)


def test_without_prune_the_whole_grid_is_timed(data, tmp_path):
    db, q = data
    entry = tuning.autotune(db, q, 5, margin=8, grid=GRID, runs=1,
                            cache_path=str(tmp_path / "c.json"),
                            device="cpu")
    labels = {tuning.autotune.__globals__["_label"](c) for c in GRID}
    assert set(entry["timings_ms"]) == labels
    assert "pruning" not in entry
    assert not any(e.startswith("roofline-pruned")
                   for e in entry["errors"].values())
    assert obs.counter(mn.TUNING_CANDIDATES_TIMED).get() >= len(
        _timed_labels(entry))


def test_prune_candidates_keeps_the_best_and_unpriceable():
    kept, pruned, best = tuning.prune_candidates(
        GRID + [{**tuning.DEFAULT_KNOBS, "precision": "no-such-arm"}],
        n=N, d=DP, k=100, nq=NQ, threshold=0.5, device_kind=H100)
    labels = [tuning.autotune.__globals__["_label"](c) for c in kept]
    assert "precision=int8" in labels  # the best-modeled arm
    assert "precision=no-such-arm" in labels  # the model cannot price it
    assert "defaults" in pruned  # bf16x3: 6x int8's products
    assert best == rl.pallas_cost_model(
        n=N, d=DP, k=100, nq=NQ, precision="int8",
        device_kind=H100)["ceiling_qps"]


def test_warm_resolve_carries_and_publishes_the_winner_once(data, tmp_path):
    db, q = data
    cache = str(tmp_path / "c.json")
    tuning.autotune(db, q, 5, margin=8, grid=GRID[:2], runs=1,
                    cache_path=cache, device="cpu")
    rl.reset()
    _, info = tuning.resolve_full(700, 16, 5, cache_path=cache,
                                  device_kind="cpu")
    assert info["source"] == "cache" and "roofline_pct" in info
    assert info["bound_class"] in rl.BOUND_CLASSES
    # one publish by the search, one by the first resolve after the store
    # was dropped; the second resolve publishes nothing
    evals = obs.counter(mn.ROOFLINE_EVALUATIONS).get()
    tuning.resolve_full(700, 16, 5, cache_path=cache, device_kind="cpu")
    assert obs.counter(mn.ROOFLINE_EVALUATIONS).get() == evals == 2.0
    assert obs.counter(mn.TUNING_CACHE_HITS).get() == 2.0


def test_cache_key_carries_the_roofline_model_version():
    key = tuning.cache_key("cpu", 700, 16, 5, "l2")
    assert f"|rl{tuning.roofline_token()}|kv" in key
    assert tuning.roofline_token() == f"torch{rl.MODEL_VERSION}"


# -- the device-trace summary -----------------------------------------------
def _ev(name, start, end, device=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=types.SimpleNamespace(name="CUDA" if device else "CPU"))


def test_summarize_counts_the_marked_block():
    evs = [_ev("warm_add", 0, 5, True),                  # before the block
           _ev("cudaDeviceSynchronize", 1, 2),            # before the block
           _ev(profiler.BODY_MARKER, 10, 110),
           _ev(profiler.BODY_MARKER, 12, 108, True),  # its device range
           _ev("binned_select_bf16x3<...>", 20, 50, True),
           _ev("binned_select_bf16x3<...>", 40, 60, True),
           _ev("sort", 70, 80, True),
           _ev("Memcpy DtoH (Device -> Pinned)", 85, 86, True),
           _ev("cudaMemcpyAsync", 84, 85),
           _ev("cudaEventSynchronize", 90, 100),
           _ev("cudaStreamSynchronize", 101, 102)]
    s = profiler.summarize(evs)
    assert s["device_busy_ms"] == pytest.approx(0.051)
    assert s["wall_ms"] == pytest.approx(0.1)
    assert s["device_idle_share"] == pytest.approx(1 - 0.51)
    assert s["kernels_ms"]["binned_select_bf16x3<...>"] == pytest.approx(0.05)
    assert s["syncs"] == {"cudaStreamSynchronize": 1,
                          "cudaDeviceSynchronize": 0,
                          "cudaEventSynchronize": 1}
    assert s["sync_count"] == 2 and s["d2h_copies"] == 1
    assert s["memcpy_async_calls"] == 1 and s["kernel_events"] == 4
    assert profiler.summarize(evs, wall_s=1e-3)["device_idle_share"] == \
        pytest.approx(1 - 0.051)


@pytest.mark.parametrize("offset_us", [-400.0, 0.0, 250.0])
def test_summarize_reads_device_events_on_the_device_clock(offset_us):
    """C1: a device timeline offset from the host's (here by -400 µs,
    which puts the block's first kernels before the host marker opens)
    loses no kernel: device events are read in the marker's device-side
    range, host runtime calls in its host range."""
    def dev(name, s, e):
        return _ev(name, s + offset_us, e + offset_us, True)

    evs = [_ev(profiler.BODY_MARKER, 1000, 2000),
           dev(profiler.BODY_MARKER, 1005, 1950),
           dev("binned_select_bf16x3<...>", 1010, 1400),
           dev("sort", 1500, 1600),
           dev("Memcpy DtoH (Device -> Pinned)", 1900, 1950),
           dev("before the block", 900, 950),
           _ev("cudaStreamSynchronize", 1960, 1990),
           _ev("cudaStreamSynchronize", 500, 510)]  # before the block
    s = profiler.summarize(evs)
    assert s["device_filter"] == "device_marker"
    assert s["kernel_names"] == sorted(
        ["binned_select_bf16x3<...>", "sort",
         "Memcpy DtoH (Device -> Pinned)"])
    assert s["kernel_events"] == 3 and s["device_events_before"] == 1
    assert s["device_busy_ms"] == pytest.approx(0.54)
    assert s["d2h_copies"] == 1 and s["sync_count"] == 1
    assert s["wall_ms"] == pytest.approx(1.0)
    # the host-range filter this replaces would drop the first kernel at
    # the -400 µs offset
    host_lo = 1000
    kept = [e for e in evs if e.device_type.name == "CUDA"
            and e.name.startswith("binned") and e.time_range.start >= host_lo]
    assert bool(kept) == (offset_us >= 0)


def test_summarize_without_a_device_range_counts_every_device_event():
    evs = [_ev(profiler.BODY_MARKER, 10, 110),
           _ev("binned_select_bf16x3<...>", 5, 50, True)]
    s = profiler.summarize(evs)
    assert s["device_filter"] == "none" and s["kernel_events"] == 1


def test_device_trace_off_captures_nothing_and_on_writes_a_trace(tmp_path):
    with profiler.device_trace("main") as cap:
        assert cap is None
    with profiler.device_trace("main|n1000", out_dir=str(tmp_path)) as cap:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert cap.path == str(tmp_path / "main_n1000")
    assert (tmp_path / "main_n1000" / "trace.json").exists()
    s = cap.summary()
    assert s["kernel_events"] == 0 and s["wall_ms"] > 0  # no card here
    assert [e["section"] for e in obs.get_event_log().recent()
            if e.get("name") == "profiler.trace"] == ["main_n1000"]


def test_cli_roofline(capsys):
    from knn_tpu_torch.cli import main

    assert main(["roofline", "--n", "1000000", "--dim", "128",
                 "--device-kind", H100, "--qps", "70000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("roofline v1 [pallas] n=1000000 d=128")
    last = json.loads(out[-1])
    assert last["bound_class"] == "tensor_core_bound"
    assert 0 < last["roofline_pct"] < 1
    assert main(["roofline", "--n", "1000000", "--dim", "128",
                 "--device-kind", H100, "--best", "3", "--json"]) == 0
    best = json.loads(capsys.readouterr().out)
    assert len(best["best"]) == 3
    assert best["best"][0]["ceiling_qps"] >= best["best"][-1]["ceiling_qps"]
    assert main(["roofline", "--n", "1000", "--dim", "16", "--selector",
                 "exact", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["estimated"] is True
    assert main(["roofline", "--n", "1000", "--dim", "16",
                 "--nprobe", "4"]) == 2
    with pytest.raises(SystemExit):
        main(["roofline", "--n", "1000", "--dim", "16",
              "--device-kind", "TPU v5e"])
