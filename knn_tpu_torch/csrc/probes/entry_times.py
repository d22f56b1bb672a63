"""Times every coarse entry of the given arms on one card.

    python3 knn_tpu_torch/csrc/probes/entry_times.py [--arms default,int8,int4]
        [--survivors 1,3,4,5,8]

Imports ``knn_tpu_torch`` from the checkout that holds this file (three
directories up), so a copy of the file placed in another checkout of the
repository times that checkout's kernels: two checkouts can be timed in
turns in one run on one card.  At 4,096 queries against 1,000,000 x
128 uniform rows (the SIFT1M shape, drawn as chip_smoke.py draws them; pq:
a random LUT of 32 subspaces x 256 codes and random codes, as its timing
needs no training), for each arm: the grouped tiled, db-major, streaming
and fused (not pq) entries and the lane tiled, db-major and streaming
entries (128-row bins, 2 survivors),
each timed with CUDA events (mean of 3 launches after one warm-up), in
turns grouped, lane, lane, grouped; with ``--survivors``, the grouped
entries at those counts (the deep grouped builds) between the lane runs
and the second grouped one.  Prints the card's name and power limit, then
one JSON line per (arm, entry).

Parent and change in turns: place a copy of this file in a checkout of the
parent commit (``git archive`` into a directory ``.gitignore`` lists) and
run the two copies p c c p in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from knn_tpu_torch.ops import _cuda  # noqa: E402
from knn_tpu_torch.ops import coarse_knn as ck  # noqa: E402


def time_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default="default,int8,int4")
    ap.add_argument("--survivors", default="",
                    help="comma list of grouped survivor counts (not 2) to "
                    "time beside the two-survivor entries")
    args_ = ap.parse_args()
    arms = args_.arms.split(",")
    deep = [int(s) for s in args_.survivors.split(",") if s]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, n_q = 1_000_000, 4096
    db = torch.from_numpy((rng.random(size=(n, 128)) * 128.0)
                          .astype(np.float32)).to(dev)
    q = torch.from_numpy((rng.random(size=(n_q, 128)) * 128.0)
                         .astype(np.float32)).to(dev)
    lane = {"binning": "lane"}
    entries = {"tiled": (ck.binned_select, {}),
               "db_major": (ck.binned_select, {"grid_order": "db_major"}),
               "streaming": (ck.stream_select, {}),
               "fused": (ck.fused_select, {"keep": 130})}
    for arm in arms:
        if arm == "pq":
            m, c = 32, 256
            lut = torch.from_numpy((rng.normal(size=(n_q, m * c)) * 100)
                                   .astype(np.float32)).to(dev)
            codes = torch.from_numpy(rng.integers(0, c, size=(n, m))
                                     .astype(np.uint8)).to(dev)
            args = (lut, *ck.prepare_db_pq(codes, ck.TILE_N))
        elif arm in ck.INT_ARMS:
            args = (*ck.quantize_queries(q), *ck.prepare_db_int(db, ck.TILE_N,
                                                                arm))
        else:
            args = (ck.pad_queries(q), *ck.prepare_db_arm(db, ck.TILE_N, arm))
        for entry, (fn, kw) in entries.items():
            if (arm, entry) == ("pq", "fused"):
                continue          # refused, as in the JAX package

            def grouped(survivors=None):
                return fn(*args, tile_n=ck.TILE_N, arm=arm, **kw,
                          survivors=survivors)

            def lanes():
                return fn(*args, tile_n=ck.TILE_N, arm=arm, **kw, **lane)
            out = {"checkout": ROOT.name, "arm": arm, "entry": entry,
                   "queries": n_q, "rows": n}
            g1 = time_ms(grouped)
            if entry != "fused":   # grouped binning only
                out["lane_ms"] = [time_ms(lanes), time_ms(lanes)]
            if deep:
                out["deep_ms"] = {s: time_ms(lambda: grouped(s))
                                  for s in deep}
            out["grouped_ms"] = [g1, time_ms(grouped)]
            if entry != "fused":
                out["lane_over_grouped"] = (sum(out["lane_ms"])
                                            / sum(out["grouped_ms"]))
            if deep:
                g = sum(out["grouped_ms"]) / 2
                out["deep_over_grouped"] = {s: ms / g for s, ms
                                            in out["deep_ms"].items()}
            print(json.dumps(out), flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
