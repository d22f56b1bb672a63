"""Where a device trace puts the traced block's kernels, trace after trace
in one process: the probe behind ``obs.profiler.summarize``'s filter.

On the card::

    python3 knn_tpu_torch/csrc/probes/trace_clock.py --traces 24
    python3 knn_tpu_torch/csrc/probes/trace_clock.py --traces 12 \
        --flood 40000

Builds the tiled coarse kernels, places the 1M x 128 main draw (seed 0,
``rng.random * 128``) and traces ``--traces`` warm certified searches
(4,096 queries, k=100) with ``torch.profiler`` inside the
``obs.profiler.BODY_MARKER`` range, alternately bare and after
``obs.profiler.WARMUP_KERNELS`` tiny warm-up kernels (``--warmup`` sets
another count), with two untraced searches between traces; ``--flood N``
takes, before each of them, a trace of N tiny kernels (a trace of tens of
thousands of events, as an int8 search's repair gives).  For each trace it
prints one JSON line: the K1 events (``binned_select_``) in the
unfiltered trace, inside the marker's host-clock range and inside its
device-side range, the offsets of the first K1 start and of the device
range from the host range's start (µs), and the device events before
the host range opens.  The last line sums them; ``trace_dumps/
trace_clock_flood<N>.json`` (in the repository's root) holds every
trace's unfiltered device events.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

REQUIRE = "binned_select_"


def one_trace(knn, q_np, warmup: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from knn_tpu_torch.obs import profiler

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warmup:
            warm = torch.zeros(8, device="cuda")
            for _ in range(warmup):
                warm.add_(1)
            torch.cuda.synchronize()
        with record_function(profiler.BODY_MARKER):
            knn.search_certified(q_np, margin=28)
            torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if profiler._is_device(e)]
    host_mark = [e for e in events if e.name == profiler.BODY_MARKER
                 and not profiler._is_device(e)]
    dev_mark = [e for e in dev if e.name == profiler.BODY_MARKER]
    h_lo = min(e.time_range.start for e in host_mark)
    h_hi = max(e.time_range.end for e in host_mark)
    k1 = [e for e in dev if REQUIRE in e.name]
    out = {
        "warmup": warmup,
        "device_events": len(dev),
        "k1_unfiltered": len(k1),
        "k1_in_host_range": sum(h_lo <= e.time_range.start <= h_hi
                                for e in k1),
        "device_marker": len(dev_mark),
        "device_events_before_host_range": sum(
            e.time_range.start < h_lo for e in dev
            if e.name != profiler.BODY_MARKER),
        "k1_start_minus_host_lo_us": (
            min(e.time_range.start for e in k1) - h_lo if k1 else None),
    }
    if dev_mark:
        d_lo = min(e.time_range.start for e in dev_mark)
        d_hi = max(e.time_range.end for e in dev_mark)
        out["k1_in_device_range"] = sum(d_lo <= e.time_range.start <= d_hi
                                        for e in k1)
        out["device_lo_minus_host_lo_us"] = d_lo - h_lo
    s = profiler.summarize(events)
    out["summary_holds_k1"] = any(REQUIRE in n for n in s["kernel_names"])
    out["summary_device_filter"] = s["device_filter"]
    out["summary_device_events_before"] = s["device_events_before"]
    out["events"] = [(e.name[:60], e.time_range.start - h_lo,
                      e.time_range.end - h_lo) for e in dev]
    return out


def flood(n: int) -> None:
    """A trace of ``n`` tiny kernels, its events read and dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(8, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
    len(prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=24)
    ap.add_argument("--flood", type=int, default=0,
                    help="tiny kernels in a trace taken before each one")
    ap.add_argument("--warmup", type=int, default=None,
                    help="warm-up kernels of the warm traces (default "
                    "obs.profiler.WARMUP_KERNELS)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trace_clock: no CUDA device visible", file=sys.stderr)
        return 2
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.device import set_precision_policy
    from knn_tpu_torch.obs.profiler import WARMUP_KERNELS
    from knn_tpu_torch.ops import _cuda

    warmup = WARMUP_KERNELS if args.warmup is None else args.warmup
    set_precision_policy()
    _cuda.build(["binned_coarse"])
    rng = np.random.default_rng(0)
    db = (rng.random(size=(1_000_000, 128)) * 128.0).astype(np.float32)
    q = (rng.random(size=(4096, 128)) * 128.0).astype(np.float32)
    knn = ShardedKNN(db, k=100)
    for _ in range(2):
        knn.search_certified(q, margin=28)
    rows = []
    for t in range(args.traces):
        if args.flood:
            flood(args.flood)
        r = one_trace(knn, q, warmup=warmup * (t % 2))
        r["trace"] = t
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "events"}),
              flush=True)
        for _ in range(2):
            knn.search_certified(q, margin=28)
    out = REPO / "trace_dumps"
    out.mkdir(exist_ok=True)
    (out / f"trace_clock_flood{args.flood}.json").write_text(
        json.dumps(rows))
    offs = [r["device_lo_minus_host_lo_us"] for r in rows
            if "device_lo_minus_host_lo_us" in r]
    print(json.dumps({
        "traces": len(rows), "flood": args.flood, "warmup": warmup,
        "warmup_recorded": [r["device_events_before_host_range"]
                            for r in rows if r["warmup"]],
        "k1_lost_unfiltered": sum(r["k1_unfiltered"] == 0 for r in rows),
        "k1_lost_by_host_range": sum(
            r["k1_unfiltered"] > r["k1_in_host_range"] for r in rows),
        "k1_lost_by_device_range": sum(
            r["k1_unfiltered"] > r.get("k1_in_device_range", 0)
            for r in rows),
        "summary_lost_k1": sum(not r["summary_holds_k1"] for r in rows),
        "device_marker_missing": sum(r["device_marker"] == 0 for r in rows),
        "device_lo_minus_host_lo_us": [min(offs), max(offs)] if offs else None,
        "nvidia_smi": os.popen(
            "nvidia-smi --query-gpu=name,power.limit "
            "--format=csv,noheader").read().strip(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
