"""The port's perf-regression sentinel (knn_tpu_torch.obs.sentinel and
knn_tpu_torch/scripts/perf_sentinel.py) — tests/test_sentinel.py case by
case, and against the JAX package's sentinel on the repo's real history.

On recorded history fixtures a 20% drop is ``regress``, a drop within the
historical MAD ``ok`` and one between the bars ``warn``; stale lines and
same-commit republications stay out of the baseline; backend and
precision key separately, so an H100 (``cuda``) line never meets a TPU
baseline; a short history gives ``no_baseline``.  On the repo's
``TPU_BENCH_r*.jsonl`` / ``BENCH_r*.json`` the port's baselines and
verdicts equal the JAX package's exactly (the sentinel does no float
arithmetic the two could order differently: the same Python on the same
lines).
"""

import json
import os
import subprocess
import sys

import pytest

from knn_tpu.analysis import artifacts as jart
from knn_tpu.obs import sentinel as jsentinel
from knn_tpu_torch.analysis import artifacts as art
from knn_tpu_torch.obs import sentinel
from knn_tpu_torch.scripts import perf_sentinel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "knn_qps_sift1m_n1000000_d128_k100"

#: a tight recorded history of the card's lines across four rounds, ~6000
#: q/s with ~±60 jitter (MAD 60 -> sigma ~89, sigma_rel ~1.5%)
HISTORY = [
    {"metric": METRIC, "value": 6000.0, "device_phase_qps": 24000.0,
     "mfu": 0.03, "backend": "cuda", "measured_round": 1,
     "measured_at_commit": "aaa1111"},
    {"metric": METRIC, "value": 6060.0, "device_phase_qps": 24100.0,
     "mfu": 0.031, "backend": "cuda", "measured_round": 2,
     "measured_at_commit": "bbb2222"},
    {"metric": METRIC, "value": 5940.0, "device_phase_qps": 23900.0,
     "mfu": 0.029, "backend": "cuda", "measured_round": 3,
     "measured_at_commit": "ccc3333"},
    {"metric": METRIC, "value": 6120.0, "device_phase_qps": 24150.0,
     "mfu": 0.031, "backend": "cuda", "measured_round": 4,
     "measured_at_commit": "ddd4444"},
]
KEY = f"{METRIC}|cuda|default"

#: a stale republication with an absurd value: must NEVER enter
STALE_LINE = {"metric": METRIC, "value": 60000.0, "backend": "cuda",
              "stale": True, "measured_round": 1,
              "measured_at_commit": "aaa1111"}


def _baselines(extra=()):
    return sentinel.build_baselines(list(HISTORY) + list(extra))


def test_constants_and_curated_fields_equal_jax():
    for name in ("MIN_SAMPLES", "OK_FLOOR", "REGRESS_FLOOR", "OK_SIGMAS",
                 "REGRESS_SIGMAS", "OK_CEIL", "REGRESS_CEIL", "MAD_SCALE"):
        assert getattr(sentinel, name) == getattr(jsentinel, name), name
    assert (sentinel.MIN_SAMPLES, sentinel.OK_FLOOR, sentinel.REGRESS_FLOOR,
            sentinel.OK_CEIL, sentinel.REGRESS_CEIL, sentinel.MAD_SCALE) == \
        (3, 0.02, 0.10, 0.25, 0.40, 1.4826)
    assert sentinel.CURATED_FIELDS == art.curated_fields() == \
        jsentinel.CURATED_FIELDS == jart.curated_fields()


def test_synthetic_20pct_regression_flagged_regress():
    base = _baselines()
    med = base[KEY]["value"]["median"]
    line = {"metric": METRIC, "backend": "cuda", "value": med * 0.8}
    v = sentinel.verdict_for_line(line, baselines=base)
    assert v["verdict"] == "regress"
    f = v["fields"]["value"]
    assert f["drop_rel"] == pytest.approx(0.2, abs=1e-6)
    assert f["effect_sigmas"] > 4
    assert v == jsentinel.verdict_for_line(
        line, baselines=jsentinel.build_baselines(HISTORY))


def test_jitter_within_historical_mad_stays_ok():
    base = _baselines()
    stats = base[KEY]["value"]
    line = {"metric": METRIC, "backend": "cuda",
            "value": stats["median"] - stats["mad"]}
    v = sentinel.verdict_for_line(line, baselines=base)
    assert v["verdict"] == "ok"
    line["value"] = stats["median"] * 1.3
    assert sentinel.verdict_for_line(line, baselines=base)["verdict"] == "ok"


def test_between_the_bars_is_warn():
    base = _baselines()
    stats = base[KEY]["value"]
    line = {"metric": METRIC, "backend": "cuda",
            "value": stats["median"] * 0.94}
    v = sentinel.verdict_for_line(line, baselines=base)
    assert v["fields"]["value"]["verdict"] == "warn"
    assert v["verdict"] == "warn"


def test_stale_lines_never_enter_the_baseline():
    with_stale = _baselines(extra=[STALE_LINE])
    clean = _baselines()
    assert with_stale[KEY]["value"] == clean[KEY]["value"]
    assert with_stale[KEY]["value"]["n"] == len(HISTORY)
    assert 60000.0 not in with_stale[KEY]["value"]["values"]


def test_same_commit_same_value_counts_once():
    dup = dict(HISTORY[0])
    base = _baselines(extra=[dup])
    assert base[KEY]["value"]["n"] == len(HISTORY)
    remeasured = dict(HISTORY[0], value=6010.0)
    base = _baselines(extra=[remeasured])
    assert base[KEY]["value"]["n"] == len(HISTORY) + 1


def test_backend_and_precision_key_separately():
    """A ``tpu`` history of the same metric never becomes the ``cuda``
    baseline, nor a cpu or int8 line; each lands under its own key."""
    tpu = [dict(r, backend="tpu", value=r["value"] * 10) for r in HISTORY]
    cpu_line = {"metric": METRIC, "value": 50.0, "backend": "cpu"}
    int8_line = {"metric": METRIC, "value": 9000.0, "backend": "cuda",
                 "precision": "int8"}
    base = _baselines(extra=tpu + [cpu_line, int8_line] * 3)
    assert base[KEY]["value"]["n"] == len(HISTORY)
    assert base[f"{METRIC}|tpu|default"]["value"]["median"] > \
        5 * base[KEY]["value"]["median"]
    assert f"{METRIC}|cpu|default" in base
    assert f"{METRIC}|cuda|int8" in base
    v = sentinel.verdict_for_line(dict(cpu_line), baselines=base)
    assert v["baseline_key"].endswith("|cpu|default")
    assert v["fields"]["value"]["verdict"] == "ok"
    # a card's line against a TPU-only history: no baseline, whatever the
    # TPU numbers
    only_tpu = sentinel.build_baselines(tpu)
    v = sentinel.verdict_for_line(dict(HISTORY[0]), baselines=only_tpu)
    assert v["verdict"] == "no_baseline" and v["baseline_key"] == KEY


def test_short_history_yields_no_baseline():
    assert sentinel.build_baselines(HISTORY[:2]) == {}
    v = sentinel.verdict_for_line(
        {"metric": "knn_qps_other", "backend": "cuda", "value": 1.0},
        baselines=_baselines())
    assert v["verdict"] == "no_baseline"
    with pytest.raises(ValueError, match="repo_dir or baselines"):
        sentinel.verdict_for_line({"metric": METRIC})


def test_bench_line_sentinel_block_shape():
    v = sentinel.verdict_for_line(
        {"metric": METRIC, "backend": "cuda", "value": 6000.0, "mfu": 0.030,
         "device_phase_qps": 24000.0}, baselines=_baselines())
    assert v["verdict"] == "ok"
    assert set(v["fields"]) == {"value", "mfu", "device_phase_qps"}
    for f in v["fields"].values():
        assert f["verdict"] == "ok"
        assert {"baseline_median", "baseline_n", "drop_rel", "ok_bar",
                "regress_bar"} <= set(f)
    for style in ("legacy", "normalized"):
        assert art.validate("sentinel", v, style=style) == []


# -- the repo's real history ------------------------------------------------
def test_real_history_baselines_equal_jax():
    records = list(sentinel.iter_history_lines(REPO))
    assert any(r.get("metric", "").startswith("knn_qps_sift1m")
               for r in records)
    assert records == list(jsentinel.iter_history_lines(REPO))
    got = sentinel.build_baselines(records)
    assert got == jsentinel.build_baselines(
        jsentinel.iter_history_lines(REPO))
    assert got and all(key.split("|")[1] in ("tpu", "cpu") for key in got)
    bounded = list(sentinel.iter_history_lines(REPO, max_round=4))
    assert bounded and all(sentinel._file_round(r["_source"]) < 4
                           for r in bounded)


def test_every_history_line_judged_as_jax_judges_it():
    """Each line of the repo's history against the baselines of strictly
    earlier rounds: the port's verdict equals the JAX package's; the same
    line relabelled ``cuda`` meets no baseline."""
    verdicts = set()
    for rec in sentinel.iter_history_lines(REPO):
        rnd = sentinel._file_round(rec["_source"])
        got = sentinel.verdict_for_line(rec, baselines=sentinel.build_baselines(
            sentinel.iter_history_lines(REPO, max_round=rnd)))
        want = jsentinel.verdict_for_line(
            rec, baselines=jsentinel.build_baselines(
                jsentinel.iter_history_lines(REPO, max_round=rnd)))
        assert got == want, rec["_source"]
        verdicts.add(got["verdict"])
        card = dict(rec, backend="cuda")
        v = sentinel.verdict_for_line(card, repo_dir=REPO)
        assert v["verdict"] == "no_baseline", v
        assert v["baseline_key"].endswith("|cuda|default")
    assert len(verdicts) > 1


def test_port_family_is_read_after_the_tpu_rounds(tmp_path):
    """``GPU_BENCH_r*.jsonl`` lines join the history (after the TPU
    family) and key under ``cuda``; a TPU line of the same round never
    enters their baseline."""
    _write(tmp_path, "TPU_BENCH", {
        i + 1: [dict(HISTORY[i], backend="tpu")] for i in range(4)})
    _write(tmp_path, "GPU_BENCH", {i + 1: [HISTORY[i]] for i in range(4)})
    recs = list(sentinel.iter_history_lines(str(tmp_path)))
    assert [r["_source"][:3] for r in recs] == ["TPU"] * 4 + ["GPU"] * 4
    base = sentinel.build_baselines(recs)
    assert base[KEY]["value"] == _baselines()[KEY]["value"]
    assert base[f"{METRIC}|tpu|default"]["value"]["n"] == 4


# -- the CLI ----------------------------------------------------------------
def _write(tmp_path, family, rounds):
    for rnd, lines in rounds.items():
        p = tmp_path / f"{family}_r{rnd:02d}.jsonl"
        p.write_text("".join(json.dumps(ln) + "\n" for ln in lines))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.scripts.perf_sentinel", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_perf_sentinel_cli_lint_and_strict_gate(tmp_path, capsys):
    # rounds 1-4: the tight history; round 5: a 20% regression
    _write(tmp_path, "GPU_BENCH", {i + 1: [HISTORY[i]] for i in range(4)})
    _write(tmp_path, "GPU_BENCH", {5: [
        {"metric": METRIC, "value": 4800.0, "backend": "cuda",
         "measured_round": 5, "measured_at_commit": "eee5555"}]})
    assert perf_sentinel.main(["--repo", str(tmp_path), "--lint"]) == 0
    assert "bench lines: 5 validated" in capsys.readouterr().out
    # warn-only by default: verdict printed, exit 0
    assert perf_sentinel.main(["--repo", str(tmp_path),
                               "--check-latest"]) == 0
    out = capsys.readouterr().out
    assert "regress" in out and "|cuda|default" in out
    # --strict turns the regress verdict into a hard failure, through the
    # module's command line
    r = _cli("--repo", str(tmp_path), "--check-latest", "--strict")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "1 regression verdict(s)" in r.stderr
    # a healthy latest round passes strict
    _write(tmp_path, "GPU_BENCH", {5: [
        {"metric": METRIC, "value": 6050.0, "backend": "cuda",
         "measured_round": 5, "measured_at_commit": "eee5555"}]})
    r = _cli("--repo", str(tmp_path), "--check-latest", "--strict")
    assert r.returncode == 0, r.stdout + r.stderr


def test_perf_sentinel_lint_refuses_a_malformed_block(tmp_path, capsys):
    _write(tmp_path, "GPU_BENCH", {1: [dict(
        HISTORY[0], sentinel={"verdict": "absent"})]})
    assert perf_sentinel.main(["--repo", str(tmp_path), "--lint"]) == 1
    err = capsys.readouterr().err
    assert "sentinel block on " + METRIC in err
    bad_slo = tmp_path / "slo.json"
    bad_slo.write_text("[]")
    _write(tmp_path, "GPU_BENCH", {1: [HISTORY[0]]})
    assert perf_sentinel.main(["--repo", str(tmp_path), "--lint"]) == 0
    assert perf_sentinel.main(["--repo", str(tmp_path), "--lint",
                               "--slo-config", str(bad_slo)]) == 1
    assert "slo config" in capsys.readouterr().err


def test_perf_sentinel_on_the_repo_equals_the_jax_script(tmp_path, capsys):
    """``--lint`` on the repo prints what the JAX script prints; the TPU
    rounds are not the port's to judge (``--check-latest`` finds no GPU
    round); ``--line`` renders one line's block."""
    assert perf_sentinel.main(["--lint"]) == 0
    port = capsys.readouterr().out
    r = subprocess.run([sys.executable, "scripts/perf_sentinel.py", "--lint"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and port == r.stdout
    assert perf_sentinel.main(["--check-latest", "--strict"]) == 0
    assert "nothing to check" in capsys.readouterr().out
    line = tmp_path / "line.json"
    line.write_text(json.dumps(HISTORY[0]))
    assert perf_sentinel.main(["--line", str(line)]) == 0
    block = json.loads(capsys.readouterr().out)
    assert block["verdict"] == "no_baseline" and block["baseline_key"] == KEY
