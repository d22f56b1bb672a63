"""Curation rules of the port's refresher
(knn_tpu_torch/scripts/refresh_bench_artifacts.py, which builds
``GPU_BENCH_r{N}.jsonl`` from ``gpu_bench_lines.jsonl``) —
tests/test_refresh_artifacts.py case by case, in a repo-shaped
``tmp_path`` given as ``--root``: the card's backend tier beats
everything, greener gates supersede, equal rank curates the best value, a
recorded ``gate_note`` never vanishes without a green verdict, the
provenance stamps and the ``stale`` mark, int8 kept apart, and the
cataloged blocks curated (hoisted, printed) or refused.  The JAX script is
the oracle on the same lines (its ``tpu`` backend the port's ``cuda``).
"""

import json
import os
import subprocess
import sys

import pytest

from knn_tpu_torch.obs import roofline
from knn_tpu_torch.scripts import refresh_bench_artifacts as refresh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_lines(path, lines):
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))


def _curated(tmp_path, round_no):
    out = tmp_path / f"GPU_BENCH_r{round_no:02d}.jsonl"
    return [json.loads(ln) for ln in out.read_text().splitlines()]


def _refresh(tmp_path, capsys, round_no, lines, seed_lines=None,
             prev_curated=None):
    """Run the refresher under ``tmp_path``; (exit code, stdout, stderr)."""
    _write_lines(tmp_path / "gpu_bench_lines.jsonl", lines)
    if seed_lines is not None:
        _write_lines(tmp_path / f"GPU_BENCH_r{round_no - 1:02d}.jsonl",
                     seed_lines)
    if prev_curated is not None:
        _write_lines(tmp_path / f"GPU_BENCH_r{round_no:02d}.jsonl",
                     prev_curated)
    rc = refresh.main([str(round_no), "--root", str(tmp_path)])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _run(tmp_path, capsys, round_no, lines, **kw):
    rc, _, err = _refresh(tmp_path, capsys, round_no, lines, **kw)
    assert rc == 0, err
    assert not list(tmp_path.glob("TPU_BENCH_*"))
    return _curated(tmp_path, round_no)


def _line(value, *, backend="cuda", gate=..., note=None, cfg="knn_qps_x"):
    rec = {"metric": cfg, "value": value, "backend": backend}
    if gate is not ...:
        rec["pallas_gate_ok"] = gate
    if note is not None:
        rec["gate_note"] = note
    return rec


@pytest.mark.parametrize("other", ["cpu", "tpu", None])
def test_other_backend_never_supersedes_cuda(tmp_path, capsys, other):
    rows = _run(tmp_path, capsys, 9, [
        _line(100.0, backend="cuda", gate=True),
        _line(9999.0, backend=other, gate=True),  # faster, not the card
    ])
    want = _line(100.0, backend="cuda", gate=True)
    assert len(rows) == 1
    assert {k: rows[0][k] for k in want} == want


def test_cuda_line_supersedes_a_faster_cpu_incumbent(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9, [
        _line(9999.0, backend="cpu", gate=True),
        _line(100.0, backend="cuda", gate=False),  # red, but the card
    ])
    assert rows[0]["backend"] == "cuda" and rows[0]["value"] == 100.0


def test_green_gate_supersedes_red_and_drops_note(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9, [
        _line(500.0, gate=False, note="1 undetected miss"),
        _line(300.0, gate=True),
    ])
    assert rows[0]["value"] == 300.0
    assert rows[0]["pallas_gate_ok"] is True
    assert "gate_note" not in rows[0]


def test_ungated_line_inherits_failure_stamp(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9, [
        _line(500.0, gate=False, note="1 undetected miss"),
        _line(800.0, gate=None),
    ])
    assert rows[0]["value"] == 800.0
    assert rows[0]["gate_note"] == "1 undetected miss"


def test_equal_rank_curates_best_value_not_latest(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9, [_line(900.0, gate=True),
                                      _line(700.0, gate=True)])
    assert rows[0]["value"] == 900.0


def test_annotation_never_erased_by_bare_line(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9, [
        _line(500.0, gate=True),
        {"metric": "knn_qps_x", "value": 600.0, "backend": "cuda"},
    ])
    assert rows[0]["value"] == 500.0 and rows[0]["pallas_gate_ok"] is True


def test_seeds_from_previous_round(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9,
                [_line(100.0, gate=True, cfg="knn_qps_a")],
                seed_lines=[_line(50.0, gate=True, cfg="knn_qps_b")])
    by_cfg = {r["metric"]: r for r in rows}
    assert by_cfg["knn_qps_b"]["value"] == 50.0
    assert by_cfg["knn_qps_a"]["value"] == 100.0


def test_every_curated_line_carries_provenance(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9,
                [_line(100.0, gate=True, cfg="knn_qps_fresh")],
                seed_lines=[_line(50.0, gate=True, cfg="knn_qps_carried")])
    for r in rows:
        assert {"measured_round", "measured_at_commit", "stale"} <= set(r)


def test_fresh_line_stamped_current_round_not_stale(tmp_path, capsys):
    (r,) = _run(tmp_path, capsys, 9, [_line(100.0, gate=True)])
    assert r["measured_round"] == 9
    assert r["stale"] is False
    # the root is no git checkout: the honest fallback stamp
    assert r["measured_at_commit"] == "unknown"


def test_carried_over_line_marked_stale(tmp_path, capsys):
    rows = _run(tmp_path, capsys, 9,
                [_line(100.0, gate=True, cfg="knn_qps_fresh")],
                seed_lines=[_line(50.0, gate=True, cfg="knn_qps_old")])
    by_cfg = {r["metric"]: r for r in rows}
    old = by_cfg["knn_qps_old"]
    assert old["measured_round"] == 8
    assert old["stale"] is True
    assert old["measured_at_commit"] == "unknown(pre-provenance)"
    fresh = by_cfg["knn_qps_fresh"]
    assert fresh["measured_round"] == 9 and fresh["stale"] is False


def test_existing_provenance_survives_reround(tmp_path, capsys):
    seed = dict(_line(70.0, gate=True), measured_round=7,
                measured_at_commit="abc1234")
    (r,) = _run(tmp_path, capsys, 9, [], seed_lines=[seed])
    assert r["measured_round"] == 7
    assert r["measured_at_commit"] == "abc1234"
    assert r["stale"] is True


def test_unstamped_prev_curation_never_claims_current_round(tmp_path,
                                                            capsys):
    rows = _run(tmp_path, capsys, 9,
                [_line(100.0, gate=True, cfg="knn_qps_fresh")],
                prev_curated=[_line(80.0, gate=True, cfg="knn_qps_legacy"),
                              _line(100.0, gate=True, cfg="knn_qps_fresh")])
    by_cfg = {r["metric"]: r for r in rows}
    legacy = by_cfg["knn_qps_legacy"]
    assert legacy["measured_round"] == 8 and legacy["stale"] is True
    fresh = by_cfg["knn_qps_fresh"]
    assert fresh["measured_round"] == 9 and fresh["stale"] is False


def test_stale_recomputed_when_line_remeasured(tmp_path, capsys):
    seed = dict(_line(70.0, gate=True), measured_round=7,
                measured_at_commit="abc1234")
    (r,) = _run(tmp_path, capsys, 9, [_line(90.0, gate=True)],
                seed_lines=[seed])
    assert r["value"] == 90.0
    assert r["measured_round"] == 9
    assert r["stale"] is False


def test_requires_explicit_round_argument(tmp_path):
    """No round: a usage error through the module's command line, and
    nothing written under the root."""
    _write_lines(tmp_path / "gpu_bench_lines.jsonl", [_line(1.0)])
    r = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.scripts.refresh_bench_artifacts",
         "--root", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "usage" in (r.stderr + r.stdout)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["gpu_bench_lines.jsonl"]


def test_int8_line_curated_separately_from_f32_family(tmp_path, capsys):
    f32_line = dict(_line(100.0, gate=True), precision="bf16x3")
    int8_line = dict(_line(180.0, gate=True), precision="int8",
                     quant_bound_max=12.5, quant_scales_dtype="float32")
    out = _run(tmp_path, capsys, 9, [f32_line, int8_line])
    assert len(out) == 2
    by_prec = {r.get("precision"): r for r in out}
    assert by_prec["bf16x3"]["value"] == 100.0
    assert by_prec["int8"]["value"] == 180.0
    assert by_prec["int8"]["quant_bound_max"] == 12.5
    for r in out:
        assert r["measured_round"] == 9 and r["stale"] is False


def test_int8_carryover_marked_stale_like_any_line(tmp_path, capsys):
    old8 = dict(_line(150.0, gate=True), precision="int8",
                measured_round=8, measured_at_commit="abc")
    (r,) = _run(tmp_path, capsys, 9, [], prev_curated=[old8])
    assert r["precision"] == "int8"
    assert r["measured_round"] == 8 and r["stale"] is True


def test_obs_overhead_survives_curation_when_measured(tmp_path, capsys):
    with_obs = dict(_line(120.0, gate=True, cfg="knn_qps_obs"),
                    obs_overhead_pct=0.42)
    bare = _line(80.0, gate=True, cfg="knn_qps_bare")
    rows = _run(tmp_path, capsys, 9, [with_obs, bare])
    by_cfg = {r["metric"]: r for r in rows}
    assert by_cfg["knn_qps_obs"]["obs_overhead_pct"] == 0.42
    assert "obs_overhead_pct" not in by_cfg["knn_qps_bare"]


def test_obs_overhead_carryover_marked_stale(tmp_path, capsys):
    seed = dict(_line(120.0, gate=True), obs_overhead_pct=0.9,
                measured_round=7, measured_at_commit="abc1234")
    (r,) = _run(tmp_path, capsys, 9, [], seed_lines=[seed])
    assert r["obs_overhead_pct"] == 0.9
    assert r["measured_round"] == 7 and r["stale"] is True


# -- the cataloged blocks -----------------------------------------------------
def _roofline_block(qps=100.0):
    return roofline.attribute(
        roofline.pallas_cost_model(n=1000, d=16, k=5, nq=8,
                                   device_kind=roofline.H100), qps)


def test_roofline_pct_curated_and_printed(tmp_path, capsys):
    block = _roofline_block()
    with_rl = dict(_line(120.0, gate=True, cfg="knn_qps_rl"),
                   roofline=block)
    bare = _line(80.0, gate=True, cfg="knn_qps_bare")
    rc, out, err = _refresh(tmp_path, capsys, 9, [with_rl, bare])
    assert rc == 0, err
    by_cfg = {row["metric"]: row for row in _curated(tmp_path, 9)}
    assert by_cfg["knn_qps_rl"]["roofline_pct"] == block["roofline_pct"]
    assert by_cfg["knn_qps_rl"]["bound_class"] == block["bound_class"]
    assert "roofline" not in by_cfg["knn_qps_bare"]
    assert "roofline=" in out


def test_line_without_a_block_back_derived_from_its_config(tmp_path,
                                                           capsys):
    """A card's line carrying a modelable config (the shape in its metric
    name, mode, knobs) gets the H100 block derived onto it; a TPU kind of
    the history gets the generic estimate, never a TPU peak."""
    knobs = {"precision": "bf16x3", "kernel": "tiled", "tile_n": 16384,
             "binning": "grouped", "survivors": 2, "bin_w": 128}
    rec = {"metric": "knn_qps_main_n1000000_d128_k100", "value": 60000.0,
           "backend": "cuda", "mode": "certified_pallas",
           "device_kind": roofline.H100, "batch": 4096,
           "pallas_knobs": knobs}
    tpu = dict(rec, metric="knn_qps_sift1m_n1000000_d128_k100",
               backend="tpu", device_kind="TPU v5 lite",
               device_phase_qps=24199.3, value=6110.0)
    rc, out, err = _refresh(tmp_path, capsys, 9, [rec, tpu])
    assert rc == 0, err
    card, est = _curated(tmp_path, 9)
    want = roofline.attribute(roofline.pallas_cost_model(
        n=1_000_000, d=128, k=100, nq=4096, device_kind=roofline.H100,
        **{k: knobs[k] for k in ("precision", "kernel", "tile_n", "binning",
                                 "survivors", "bin_w")}), 60000.0)
    assert card["roofline"] == dict(want, derived=True)
    assert card["roofline"]["estimated"] is False
    assert card["bound_class"] == want["bound_class"] == "tensor_core_bound"
    assert card["roofline_pct"] == want["roofline_pct"]
    assert est["roofline"]["estimated"] is True
    assert est["roofline"]["peaks"] == roofline.GENERIC_CPU_PEAKS
    assert "roofline=" in out


def test_malformed_roofline_block_refused(tmp_path, capsys):
    bad = dict(_line(120.0, gate=True), roofline={"bound_class": "gpu_bound"})
    rc, out, err = _refresh(tmp_path, capsys, 9, [bad])
    assert rc != 0
    assert "malformed roofline block" in err
    assert not (tmp_path / "GPU_BENCH_r09.jsonl").exists()


def test_knee_block_curated_and_printed(tmp_path, capsys):
    block = {"version": 1, "slo_p99_ms": 100.0,
             "rate_steps": [{"rate_qps": 200.0, "offered": 190,
                             "ok": 180, "achieved_qps": 171.3,
                             "shed_fraction": 0.05, "within_slo": True}],
             "knee_qps": 171.3, "knee_rate_qps": 200.0}
    rec = dict(_line(120.0, gate=True, cfg="knn_qps_knee"),
               loadgen_knee=block)
    rc, out, err = _refresh(tmp_path, capsys, 9, [rec])
    assert rc == 0, err
    (row,) = _curated(tmp_path, 9)
    assert row["knee_qps"] == 171.3
    assert row["loadgen_knee"] == block
    assert "knee=171.3q/s" in out


def test_malformed_knee_block_refused(tmp_path, capsys):
    bad = dict(_line(120.0, gate=True),
               loadgen_knee={"version": 1, "rate_steps": []})
    rc, _, err = _refresh(tmp_path, capsys, 9, [bad])
    assert rc != 0
    assert "malformed loadgen_knee block" in err
    assert not (tmp_path / "GPU_BENCH_r09.jsonl").exists()


_MULTIHOST = {"hosts": 2, "chips_per_host": 2,
              "merge": {"intra": {"strategy": "allgather",
                                  "source": "measured"},
                        "dcn": {"strategy": "ring", "source": "measured"}},
              "dcn_merge_bytes": 2560,
              "hosttier": {"sweeps": 4, "budget_bytes": 17408,
                           "segment_rows": 512}}


def test_multihost_block_curated_and_printed(tmp_path, capsys):
    rec = dict(_line(120.0, gate=True, cfg="knn_qps_multihost"),
               multihost=_MULTIHOST)
    rc, out, err = _refresh(tmp_path, capsys, 9, [rec])
    assert rc == 0, err
    (row,) = _curated(tmp_path, 9)
    assert row["multihost_hosts"] == 2
    assert row["multihost_merge"] == "ring"
    assert row["hosttier_sweeps"] == 4
    assert row["multihost"] == _MULTIHOST
    assert "multihost=2xring/4sweeps" in out


def test_malformed_multihost_block_refused(tmp_path, capsys):
    bad = dict(_line(120.0, gate=True),
               multihost={"hosts": 0,
                          "merge": {"dcn": {"strategy": "bogus",
                                            "source": "vibes"}}})
    rc, _, err = _refresh(tmp_path, capsys, 9, [bad])
    assert rc != 0
    assert "malformed multihost block" in err
    assert not (tmp_path / "GPU_BENCH_r09.jsonl").exists()


_MUTATION = {
    "mutation_version": 1,
    "write_mix": {"insert_fraction": 0.1, "delete_fraction": 0.05},
    "rate_qps": 200.0, "duration_s": 2.0,
    "admitted_p99_ms": 14.2, "compactions": 3, "epoch": 3,
    "reads": {"offered": 360, "ok": 360},
    "writes": {"insert": {"ok": 40}, "total": 55, "ok": 52},
    "slo_breach_transitions": 0,
}


def test_mutation_block_curated_and_printed(tmp_path, capsys):
    rec = dict(_line(120.0, gate=True, cfg="knn_qps_mutation"),
               mutation=_MUTATION)
    rc, out, err = _refresh(tmp_path, capsys, 9, [rec])
    assert rc == 0, err
    (row,) = _curated(tmp_path, 9)
    assert row["mutation_admitted_p99_ms"] == 14.2
    assert row["mutation"] == _MUTATION
    assert "mutation=14.2ms/p99" in out


def test_malformed_mutation_block_refused(tmp_path, capsys):
    bad = dict(_line(120.0, gate=True),
               mutation={"mutation_version": 1, "compactions": 0})
    rc, _, err = _refresh(tmp_path, capsys, 9, [bad])
    assert rc != 0
    assert "malformed mutation block" in err
    assert not (tmp_path / "GPU_BENCH_r09.jsonl").exists()


# -- sentinel verdicts, and the JAX script on the same lines -----------------
HISTORY = [
    {"metric": "knn_qps_sift1m_n1000000_d128_k100", "value": v,
     "backend": "cuda", "measured_round": r, "measured_at_commit": c}
    for r, v, c in ((1, 6000.0, "aaa"), (2, 6060.0, "bbb"),
                    (3, 5940.0, "ccc"), (4, 6120.0, "ddd"))]


def test_refresher_stamps_sentinel_verdicts(tmp_path, capsys):
    """Each fresh line's verdict against the strictly earlier rounds of
    the port's family; the TPU rounds of the same metric never meet it."""
    for rec in HISTORY:
        _write_lines(tmp_path / f"GPU_BENCH_r{rec['measured_round']:02d}"
                                f".jsonl", [rec])
        _write_lines(tmp_path / f"TPU_BENCH_r{rec['measured_round']:02d}"
                                f".jsonl", [dict(rec, backend="tpu",
                                                 value=rec["value"] / 2)])
    fresh = {"metric": "knn_qps_sift1m_n1000000_d128_k100", "value": 4700.0,
             "backend": "cuda", "pallas_gate_ok": True,
             "measured_at_commit": "fff"}
    rc, out, err = _refresh(tmp_path, capsys, 5, [fresh])
    assert rc == 0, err
    (rec,) = _curated(tmp_path, 5)
    assert rec["sentinel"]["verdict"] == "regress"
    assert rec["sentinel"]["baseline_key"].endswith("|cuda|default")
    assert rec["sentinel"]["fields"]["value"]["baseline_n"] == 4
    assert "sentinel=regress" in out


def test_curation_equals_the_jax_script_on_the_same_lines(tmp_path, capsys):
    """The same session, seed and current-round lines through the JAX
    script (``tpu`` lines, ``TPU_BENCH_r*``) and the port's (``cuda``,
    ``GPU_BENCH_r*``): the same curated lines, stamps, notes, hoists and
    verdicts, the backend aside."""
    session = [
        _line(500.0, gate=False, note="miss", cfg="knn_qps_a"),
        _line(800.0, gate=None, cfg="knn_qps_a"),
        _line(900.0, gate=True, cfg="knn_qps_b"),
        _line(700.0, gate=True, cfg="knn_qps_b"),
        dict(_line(180.0, gate=True, cfg="knn_qps_b"), precision="int8"),
        dict(_line(120.0, gate=True, cfg="knn_qps_c"),
             loadgen_knee={"version": 1, "slo_p99_ms": 100.0,
                           "rate_steps": [{"rate_qps": 200.0, "offered": 1,
                                           "ok": 1, "achieved_qps": 1.0,
                                           "shed_fraction": 0.0,
                                           "within_slo": True}],
                           "knee_qps": 1.0},
             multihost=_MULTIHOST, mutation=_MUTATION),
        {"metric": "knn_qps_d", "value": 600.0, "backend": "cuda"},
    ]
    seed = [dict(_line(50.0, gate=True, cfg="knn_qps_e"), measured_round=7,
                 measured_at_commit="abc")]
    prev = [_line(80.0, gate=True, cfg="knn_qps_f")]
    history = [dict(_line(100.0 + i, cfg="knn_qps_b"), measured_round=i,
                    measured_at_commit=f"c{i}") for i in range(1, 8)]
    jax_root = tmp_path / "jax"
    (jax_root / "scripts").mkdir(parents=True)
    script = jax_root / "scripts" / "refresh_bench_artifacts.py"
    script.write_text(open(os.path.join(
        REPO, "scripts", "refresh_bench_artifacts.py")).read())

    def as_tpu(lines):
        return [dict(r, backend="tpu") for r in lines]

    for i, h in enumerate(history, 1):
        _write_lines(jax_root / f"TPU_BENCH_r{i:02d}.jsonl", as_tpu([h]))
    _write_lines(jax_root / "tpu_bench_lines.jsonl", as_tpu(session))
    _write_lines(jax_root / "TPU_BENCH_r08.jsonl", as_tpu(seed))
    _write_lines(jax_root / "TPU_BENCH_r09.jsonl", as_tpu(prev))
    r = subprocess.run([sys.executable, str(script), "9"],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    want = [json.loads(ln) for ln in
            (jax_root / "TPU_BENCH_r09.jsonl").read_text().splitlines()]

    port_root = tmp_path / "port"
    port_root.mkdir()
    for i, h in enumerate(history, 1):
        _write_lines(port_root / f"GPU_BENCH_r{i:02d}.jsonl", [h])
    rows = _run(port_root, capsys, 9, session, seed_lines=seed,
                prev_curated=prev)

    def norm(rec):
        out = {k: v for k, v in rec.items() if k != "backend"}
        if "sentinel" in out:
            out["sentinel"] = dict(out["sentinel"], baseline_key=out[
                "sentinel"]["baseline_key"].rsplit("|", 2)[0])
        return out

    assert [norm(x) for x in rows] == [norm(x) for x in want]
    assert any(x.get("sentinel", {}).get("verdict") == "ok" for x in rows)
    assert [x["stale"] for x in rows] == [x["stale"] for x in want]
