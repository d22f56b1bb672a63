"""Where one call of the campaign's bench stage goes, on the card.

The campaign times ``knn_search_pallas`` (knn_tpu_torch.campaign, stage
3): each call places the host rows afresh and runs one certified search.
This probe splits such a call at the main draw (``--n`` x ``--dim`` rows
and ``--queries`` queries drawn as the campaign draws them, seed 0,
k = ``--k``) into

- ``place_s``: ``ShardedKNN(rows, k=k)`` (the host rows prepared, copied
  to the card, split into bf16 parts), host seconds between
  synchronizations;
- per tile of ``--tiles``: the certified search's host seconds, ``cold``
  (the tile's first call on this placement: its padded db parts built)
  and ``warm`` (the call again), its fallback queries, and the warm
  call's device busy time and top device operations from a device trace
  (obs.profiler).

Prints one JSON object, with the card's ``nvidia-smi`` name and power
limit.  Run: ``python3 knn_tpu_torch/csrc/probes/campaign_split.py``
(one card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..", "..")))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--tiles", default="124928,16384")
    args = ap.parse_args()

    import numpy as np
    import torch

    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.obs import profiler

    if not torch.cuda.is_available():
        raise SystemExit("campaign_split: no CUDA device visible")
    rng = np.random.default_rng(0)
    db = (rng.random((args.n, args.dim)) * 128.0).astype(np.float32)
    q = (rng.random((args.queries, args.dim)) * 128.0).astype(np.float32)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ShardedKNN(db[:4096], k=args.k)  # builds, allocator, cuBLAS off the clock
    knn, place_s = timed(lambda: ShardedKNN(db, k=args.k))
    tiles = {}
    for tile in (int(t) for t in args.tiles.split(",")):
        def search():
            return knn.search_certified(q, margin=28, tile_n=tile)

        (_, _, st), cold = timed(search)
        _, warm = timed(search)
        with tempfile.TemporaryDirectory() as tmp:
            with profiler.device_trace(f"tile{tile}", out_dir=tmp) as cap:
                _, traced = timed(search)
            s = cap.summary(wall_s=traced)
        tiles[tile] = {"cold_s": cold, "warm_s": warm,
                       "fallback_queries": st["fallback_queries"],
                       "traced_wall_s": traced,
                       "device_busy_s": s["device_busy_ms"] / 1e3,
                       "device_idle_share": s["device_idle_share"],
                       "top_device_ms": dict(
                           list(s["kernels_ms"].items())[:6])}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"n": args.n, "dim": args.dim, "k": args.k,
                      "queries": args.queries, "place_s": place_s,
                      "tiles": tiles, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
