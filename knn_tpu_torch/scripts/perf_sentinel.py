"""Perf-regression sentinel CLI (knn_tpu_torch.obs.sentinel) — the port of
scripts/perf_sentinel.py.

    python -m knn_tpu_torch.scripts.perf_sentinel [--repo DIR] MODE

Three modes, all reading the recorded bench history under ``--repo``
(default: this checkout) — the JAX package's ``TPU_BENCH_r*.jsonl`` and
``BENCH_r*.json`` and the port's ``GPU_BENCH_r*.jsonl`` — never timing
anything:

``--lint``
    The SLO objectives (the defaults, or the JSON list at
    ``--slo-config``) parse and reference only cataloged metrics, the
    bench history parses into baselines, and every block on every
    history line — roofline, calibration, campaign, loadgen_knee,
    mutation, multihost, the sentinel verdict, the bench line's own
    top-level fields — plus every ``MULTICHIP_r*.json`` record is
    validated against the artifact-schema catalog
    (knn_tpu_torch.analysis.artifacts), with exact-version schemas
    exempting blocks from pre-schema rounds and the per-family counts
    printed.  Exit 1 on any problem.

``--check-latest``
    Judge the newest round of the port's curated family
    (``GPU_BENCH_r*.jsonl``) against baselines built from strictly
    earlier rounds.  Prints one verdict line per config.  Warn-only by
    default; ``--strict`` exits 1 if any line regresses.

``--line FILE``
    Render the sentinel block for a single bench JSON line (``-`` for
    stdin) against the full history; exit 1 on ``regress``.

Default (no mode flag): print the baseline table.
"""

from __future__ import annotations

import argparse
import fnmatch
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if not __package__:
    # run as a file: the checkout holding this script is the import root
    sys.path.insert(0, REPO)

from knn_tpu_torch.obs import sentinel  # noqa: E402 - path set above


def _latest_round(repo):
    rounds = sorted({r for r in (
        sentinel._file_round(p) for p in glob.glob(
            os.path.join(repo, sentinel.PORT_CURATED_GLOB)))
        if r is not None})
    return rounds[-1] if rounds else None


def run_lint(repo, slo_config=None) -> int:
    errors = []
    try:
        from knn_tpu_torch.obs import slo

        objs = slo.load_objectives(slo_config)
        print(f"slo config: OK ({len(objs)} objectives: "
              f"{', '.join(o.name for o in objs)})")
    except Exception as e:  # noqa: BLE001 - every failure is a lint hit
        errors.append(f"slo config: {type(e).__name__}: {e}")
    try:
        records = list(sentinel.iter_history_lines(repo))
        baselines = sentinel.build_baselines(records)
        n_fields = sum(len(f) for f in baselines.values())
        print(f"bench history: OK ({len(records)} records -> "
              f"{len(baselines)} baseline keys, {n_fields} field "
              f"baselines)")
    except Exception as e:  # noqa: BLE001
        errors.append(f"bench history: {type(e).__name__}: {e}")
        records = []
    try:
        from knn_tpu_torch.analysis import artifacts

        counts, problems = artifacts.sweep_records(records)
        for p in problems:
            errors.append(f"{p['label']} block on {p['metric']} "
                          f"({p['source']}): {p['error']}")
        mc_n, mc_problems = artifacts.sweep_multichip(repo)
        for p in mc_problems:
            errors.append(f"{p['label']} record {p['source']}: "
                          f"{p['error']}")

        def _c(name, key="validated"):
            return counts.get(name, {}).get(key, 0)

        def _exempt(name):
            n = counts.get(name, {}).get("version_exempt", 0)
            return f", {n} version-exempt" if n else ""

        rl_viol = sum(1 for p in problems if p["schema"] == "roofline")
        if not rl_viol:
            print(f"roofline blocks: OK ({_c('roofline')} validated, "
                  f"{_c('roofline', 'advisory_error')} advisory-error "
                  f"blocks skipped)")
        else:
            print(f"roofline blocks: {rl_viol} violation(s) across "
                  f"{_c('roofline')} blocks")
        cal_viol = sum(1 for p in problems
                       if p["schema"] in ("calibration", "campaign"))
        if not cal_viol:
            print(f"calibration blocks: OK ({_c('calibration')} "
                  f"calibration, {_c('campaign')} campaign validated)")
        else:
            print(f"calibration blocks: {cal_viol} violation(s) across "
                  f"{_c('calibration') + _c('campaign')} blocks")
        for name, label in (("loadgen_knee", "knee"),
                            ("mutation", "mutation"),
                            ("ivf", "ivf"),
                            ("join", "join"),
                            ("quality", "quality"),
                            ("multihost", "multihost"),
                            ("fleet", "fleet"),
                            ("sentinel", "sentinel verdict")):
            viol = sum(1 for p in problems if p["schema"] == name)
            if not viol:
                print(f"{label} blocks: OK ({_c(name)} validated"
                      f"{_exempt(name)})")
            else:
                print(f"{label} blocks: {viol} violation(s) across "
                      f"{_c(name)} blocks")
        line_viol = sum(1 for p in problems
                        if p["schema"] == "bench_line")
        print(f"bench lines: {_c('bench_line')} validated against the "
              f"artifact-schema catalog"
              + (f", {line_viol} violation(s)" if line_viol else "")
              + f"; multichip records: {mc_n} validated")
    except Exception as e:  # noqa: BLE001
        errors.append(f"artifact sweep: {type(e).__name__}: {e}")
    for err in errors:
        print(f"perf_sentinel --lint: {err}", file=sys.stderr)
    return 1 if errors else 0


def run_check_latest(repo, strict: bool) -> int:
    latest = _latest_round(repo)
    if latest is None:
        print(f"perf_sentinel: no curated {sentinel.PORT_CURATED_GLOB} "
              f"rounds — nothing to check")
        return 0
    baselines = sentinel.build_baselines(
        sentinel.iter_history_lines(repo, max_round=latest))
    if not baselines:
        print(f"perf_sentinel: no baselines below round {latest} — "
              f"history too short, skipping")
        return 0
    regressed = []
    for rec in sentinel.iter_history_lines(repo, max_round=latest + 1):
        source = rec.get("_source", "")
        if not fnmatch.fnmatch(source, sentinel.PORT_CURATED_GLOB) \
                or sentinel._file_round(source) != latest:
            continue
        if rec.get("stale") is True:
            # a republished earlier-round number re-judged against its
            # own history is noise, not a measurement of this round
            print(f"{rec.get('metric')}: skipped (stale republication "
                  f"from round {rec.get('measured_round')})")
            continue
        v = sentinel.verdict_for_line(rec, baselines=baselines)
        worst = v["verdict"]
        print(f"{rec.get('metric')} [{v['baseline_key']}]: {worst}")
        for fname, fv in v["fields"].items():
            detail = (f"value={fv.get('value')} "
                      f"median={fv.get('baseline_median')} "
                      f"drop={fv.get('drop_rel')} "
                      f"sigmas={fv.get('effect_sigmas')}"
                      if "value" in fv else fv.get("reason", ""))
            print(f"    {fname}: {fv['verdict']} {detail}")
        if worst == "regress":
            regressed.append(rec.get("metric"))
    if regressed:
        msg = (f"perf_sentinel: {len(regressed)} regression verdict(s): "
               f"{', '.join(regressed)}")
        if strict:
            print(msg, file=sys.stderr)
            return 1
        print(msg + "  (warn-only; --strict hard-fails)")
    return 0


def run_line(repo, path) -> int:
    if path == "-":
        raw = sys.stdin.read()
    else:
        with open(path) as f:
            raw = f.read()
    v = sentinel.verdict_for_line(json.loads(raw), repo_dir=repo)
    print(json.dumps(v, indent=1, sort_keys=True))
    return 0 if v["verdict"] != "regress" else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="perf_sentinel", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repo", default=REPO,
                   help="history directory (default: this checkout)")
    p.add_argument("--slo-config", default=None, metavar="PATH",
                   help="with --lint: the SLO objectives file to check "
                        "(default: the built-in objectives)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--lint", action="store_true",
                      help="validate SLO config + history fixtures")
    mode.add_argument("--check-latest", action="store_true",
                      help="judge the newest curated GPU round against "
                           "earlier rounds")
    mode.add_argument("--line", metavar="FILE",
                      help="sentinel block for one bench JSON line "
                           "('-' = stdin)")
    p.add_argument("--strict", action="store_true",
                   help="with --check-latest: exit 1 on any regress")
    args = p.parse_args(argv)
    if args.lint:
        return run_lint(args.repo, args.slo_config)
    if args.check_latest:
        return run_check_latest(args.repo, args.strict)
    if args.line:
        return run_line(args.repo, args.line)
    baselines = sentinel.build_baselines(
        sentinel.iter_history_lines(args.repo))
    print(json.dumps(baselines, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
