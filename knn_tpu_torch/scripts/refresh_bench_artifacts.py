"""Rebuild ``GPU_BENCH_r{N}.jsonl`` from the freshest bench line per config
in ``gpu_bench_lines.jsonl`` — the port of
scripts/refresh_bench_artifacts.py, for the port's own file family
(ROADMAP divergence 67).

    python -m knn_tpu_torch.scripts.refresh_bench_artifacts <round> [--root DIR]

Both files live under ``--root`` (default: this checkout).  The round
argument is REQUIRED: any default would guess wrong in some window (a
hard-coded round rewrites a frozen round; a newest-file default does the
same at the round boundary).  The previous round's curated file seeds the
curation, so configs that did not re-measure this round survive with
their provenance intact.  It never writes a ``TPU_BENCH_r*`` file.

Ranking: a line's tier is the card — a ``cuda`` line outranks every other
backend's (a CPU line never supersedes a card's line, whatever its gate
or freshness); within a tier a green soundness gate (``pallas_gate_ok``
true) beats an unknown one, which beats a red one, and a line with no
gate key ranks below any annotated line.  Among equals the faster line
wins, never one that would drop the incumbent's annotation; a recorded
``gate_note`` drops only under an explicitly green winner.  int8 lines
curate under their own key.

PROVENANCE CONTRACT: every curated line carries ``measured_round``,
``measured_at_commit`` (the fresh lines' root checkout's git HEAD, else
the line's own stamp; carried lines without one backfill
"unknown(pre-provenance)") and ``stale`` (true when measured_round < the
round being curated); a line missing them is refused.

Fresh lines are then curated table-driven over the artifact-schema
catalog (:func:`knn_tpu_torch.analysis.artifacts.curate_line`): every
cataloged block is validated, a malformed one REFUSES the round (exit 1,
nothing written), each schema's hoist keys land top-level, and a line
with no roofline block gets one derived from its own config fields
(``obs.roofline.block_for_bench_line``).  Each fresh line carries its
sentinel verdict against the history of strictly earlier rounds; the
per-line print shows each block's readout beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if not __package__:
    # run as a file: the checkout holding this script is the import root
    sys.path.insert(0, REPO)

from knn_tpu_torch.analysis import artifacts  # noqa: E402 - path set above
from knn_tpu_torch.obs import sentinel  # noqa: E402

#: provenance every written line must carry (stale is recomputed)
PROVENANCE_FIELDS = ("measured_round", "measured_at_commit")

#: the session lines a benchmark appends, and the curated round files
SESSION_LINES = "gpu_bench_lines.jsonl"
CURATED_NAME = "GPU_BENCH_r{:02d}.jsonl"

#: the backend of the accelerator tier
ACCELERATOR_BACKEND = "cuda"


def head_commit(root: str) -> str:
    """Short git HEAD of ``root`` (the checkout the fresh session lines
    were measured at), or "unknown" outside a checkout."""
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=10)
        return r.stdout.strip() or "unknown"
    except Exception:  # noqa: BLE001 — no git, no stamp
        return "unknown"


def rank(rec: dict):
    """(backend tier, gate rank): the card's lines first; then explicit
    true > gate-absent-but-annotated / unknown > explicit false, and a
    line with neither a gate nor a ``gate_note`` last."""
    tier = 1 if rec.get("backend") == ACCELERATOR_BACKEND else 0
    if "pallas_gate_ok" not in rec:
        return (tier, -1 if "gate_note" not in rec else 0)
    return (tier, {True: 2, None: 1}.get(rec["pallas_gate_ok"], 0))


class Curation:
    """The best line per config, in first-seen order."""

    def __init__(self, head: str):
        self.head = head
        self.best: Dict[str, dict] = {}
        self.order: List[str] = []

    def feed(self, path: str, source_round: int, fresh: bool = False):
        """Feed one file's lines.  ``source_round`` is the round the
        file's UNSTAMPED lines were measured in; lines already carrying
        provenance keep it.  ``fresh`` lines stamp the root's HEAD,
        anything older backfills "unknown(pre-provenance)"."""
        if not os.path.exists(path):
            return
        with open(path) as f:
            raw = f.read().splitlines()
        for line in raw:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            cfg = rec.get("metric")
            if not cfg or rec.get("value") is None:
                continue
            if rec.get("precision") == "int8":
                cfg = f"{cfg}+int8"
            rec.setdefault("measured_round", source_round)
            if "measured_at_commit" not in rec:
                rec["measured_at_commit"] = (
                    self.head if fresh else "unknown(pre-provenance)")
            if cfg not in self.best:
                self.order.append(cfg)
                self.best[cfg] = rec
                continue
            cur = self.best[cfg]
            incumbent_annotated = ("pallas_gate_ok" in cur
                                   or "gate_note" in cur)
            challenger_annotated = ("pallas_gate_ok" in rec
                                    or "gate_note" in rec)
            equal = rank(rec) == rank(cur)
            take = (rank(rec) > rank(cur)
                    or (equal and rec["value"] >= cur["value"]
                        and (challenger_annotated
                             or not incumbent_annotated)))
            if take:
                # a recorded soundness failure drops only under an
                # explicitly green winner
                if ("gate_note" in cur and "gate_note" not in rec
                        and rec.get("pallas_gate_ok") is not True):
                    rec = dict(rec, gate_note=cur["gate_note"])
                self.best[cfg] = rec


def _print_line(cfg: str, r: dict) -> None:
    print(f"{cfg}: value={r['value']} mode={r.get('mode')} "
          f"backend={r.get('backend')} "
          f"gate={r.get('pallas_gate_ok')} recall={r.get('recall_at_k')} "
          f"round={r['measured_round']}"
          + (f" obs_overhead={r['obs_overhead_pct']}%"
             if "obs_overhead_pct" in r else "")
          + (f" sentinel={r['sentinel']['verdict']}"
             if "sentinel" in r else "")
          + artifacts.line_summary(r)
          + (" STALE" if r["stale"] else ""))


def refresh(round_no: int, root: str) -> Optional[str]:
    """Curate round ``round_no`` under ``root``; returns the refusal
    message (nothing written) or None once the file is written."""
    cur = Curation(head_commit(root))
    # the previous round's curation, this round's current one (unstamped
    # lines there are of unknowable round: they backfill as LAST round,
    # so over-claimed staleness is recoverable and freshness never is),
    # then this round's session lines
    cur.feed(os.path.join(root, CURATED_NAME.format(round_no - 1)),
             round_no - 1)
    dst = os.path.join(root, CURATED_NAME.format(round_no))
    cur.feed(dst, round_no - 1)
    cur.feed(os.path.join(root, SESSION_LINES), round_no, fresh=True)
    for cfg, rec in cur.best.items():
        missing = [f for f in PROVENANCE_FIELDS if f not in rec]
        if missing:  # unreachable through feed(); guards future edits
            return (f"refusing to emit curated line for {cfg}: missing "
                    f"provenance field(s) {missing}")
        rec["stale"] = rec["measured_round"] < round_no
    for cfg, rec in cur.best.items():
        if rec["stale"]:
            continue  # a republished number keeps its old blocks verbatim
        refusal = artifacts.curate_line(rec)
        if refusal:
            return f"refusing to emit curated line for {cfg}: {refusal}"
    # every fresh line's verdict against the strictly earlier rounds; a
    # stale carry's old verdict drops (advisory: a failure here never
    # blocks the curation)
    try:
        baselines = sentinel.build_baselines(
            sentinel.iter_history_lines(root, max_round=round_no))
        for rec in cur.best.values():
            if rec["stale"]:
                rec.pop("sentinel", None)
            else:
                rec["sentinel"] = sentinel.verdict_for_line(
                    rec, baselines=baselines)
    except Exception as e:  # noqa: BLE001 — advisory, as in the JAX script
        print(f"sentinel verdicts skipped: {type(e).__name__}: {e}",
              file=sys.stderr)
    with open(dst, "w") as f:
        for cfg in cur.order:
            f.write(json.dumps(cur.best[cfg]) + "\n")
    for cfg in cur.order:
        _print_line(cfg, cur.best[cfg])
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="refresh_bench_artifacts",
        description="curate gpu_bench_lines.jsonl into "
                    "GPU_BENCH_r{N}.jsonl")
    p.add_argument("round", type=int,
                   help="the round being curated (explicit, so no default "
                        "can rewrite a frozen round's file)")
    p.add_argument("--root", default=REPO,
                   help="directory holding the session lines and the "
                        "curated files (default: this checkout)")
    args = p.parse_args(argv)
    refusal = refresh(args.round, args.root)
    if refusal:
        print(refusal, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
