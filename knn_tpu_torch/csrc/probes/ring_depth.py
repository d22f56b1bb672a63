"""Times the tensor-core walk's ring depth for the one-operand arms.

    python3 knn_tpu_torch/csrc/probes/ring_depth.py

binned_mma.cuh keeps kRing = 4 stages for default (K3), int8 (K5) and int4
(K6), whose stages are half the bf16x3 stage or less, and 2 for the
others.  This probe builds a second copy of the kernels with kRing = 2 for
every arm (a temporary directory; the repository's sources are not
touched) and times every entry (tiled, db-major, streaming, fused) of each
one-operand arm in both builds on one card, in turns (4, 2, 2, 4 stages),
at 4,096 queries against 1,000,000 x 128 uniform rows (the SIFT1M shape),
with CUDA events, after checking that both builds give the same bits.
Prints the card's name and power limit, then one JSON line per entry.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))  # the repo
from knn_tpu_torch.ops import _cuda  # noqa: E402
from knn_tpu_torch.ops import coarse_knn as ck  # noqa: E402

RING = "kArm == Arm::kDefault || kIsInt<kArm> ? 4 : 2"


def use_sources(csrc: Path, build: Path) -> None:
    """Points the kernel loader at the sources in ``csrc``."""
    _cuda.CSRC = csrc
    _cuda.SOURCES = {name: csrc / f"{name}.cu" for name in _cuda.SOURCES}
    _cuda.BUILD_DIR = build
    _cuda._loaded.clear()


def time_ms(fn, reps=5):
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    repo_csrc, repo_build = _cuda.CSRC, _cuda.BUILD_DIR
    tmp = Path(tempfile.mkdtemp())
    try:
        two = tmp / "csrc"
        shutil.copytree(repo_csrc, two)
        header = two / "binned_mma.cuh"
        text = header.read_text()
        if RING not in text:
            raise RuntimeError("binned_mma.cuh's kRing is not the probed one")
        header.write_text(text.replace(RING, "false ? 4 : 2"))
        builds = {4: (repo_csrc, repo_build), 2: (two, tmp / "build")}
        for depth, (csrc, build) in builds.items():
            use_sources(csrc, build)
            _cuda.build()

        dev = torch.device("cuda")
        rng = np.random.default_rng(0)
        n, n_q = 1_000_000, 4096
        db = torch.from_numpy((rng.random((n, 128)) * 128)
                              .astype(np.float32)).to(dev)
        q = torch.from_numpy((rng.random((n_q, 128)) * 128)
                             .astype(np.float32)).to(dev)
        operands = {"default": (ck.pad_queries(q),
                                *ck.prepare_db_arm(db, ck.TILE_N, "default"))}
        for arm in ck.INT_ARMS:
            operands[arm] = (*ck.quantize_queries(q),
                             *ck.prepare_db_int(db, ck.TILE_N, arm))
        del db
        keep = 130   # the main path's m + 2: a depth-2 carry
        entries = {"tiled": (ck.binned_select, {}),
                   "db_major": (ck.binned_select, {"grid_order": "db_major"}),
                   "streaming": (ck.stream_select, {}),
                   "fused": (ck.fused_select, {"keep": keep})}
        for arm, args in operands.items():
            for entry, (fn, kw) in entries.items():
                def run():
                    return fn(*args, tile_n=ck.TILE_N, arm=arm, **kw)
                outs, times = {}, {4: [], 2: []}
                for depth in (4, 2, 2, 4):
                    use_sources(*builds[depth])
                    if depth not in outs:
                        outs[depth] = run()
                    times[depth].append(time_ms(run))
                same = all(torch.equal(a, b)
                           for a, b in zip(outs[4], outs[2]))
                if not same:
                    raise AssertionError(f"{arm} {entry}: ring depths differ")
                print(json.dumps({"arm": arm, "entry": entry,
                                  "queries": n_q, "rows": n,
                                  "ms_ring4": times[4], "ms_ring2": times[2],
                                  "bitwise_equal": same}), flush=True)
    finally:
        use_sources(repo_csrc, repo_build)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
