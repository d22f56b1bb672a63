"""Device memory of the host-RAM tier's pieces, on the card.

Prints one JSON object:

- ``cublas_workspace_bytes``: the bytes a process's first matmul adds to
  ``torch.cuda.memory_allocated`` on the current stream, and
  ``cublas_workspace_new_stream_bytes`` those of a first matmul on a new
  stream (PyTorch keeps a cuBLAS workspace per stream, in the caching
  allocator);
- ``block``: for query blocks of ``--rows`` rows against one padded
  segment of ``--segment-rows`` x ``--dim`` rows (the tier's segment at
  the main draw and a 128 MiB budget), the device bytes one block search
  adds at its peak, with the segment's norms made once beforehand
  (``prepared``) and made in the block, each also per score of the
  [rows, segment rows] block.

Run: ``python3 knn_tpu_torch/csrc/probes/hosttier_memory.py`` (one card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..", "..")))


def _added(fn) -> int:
    """Peak bytes ``fn()`` adds to the allocated bytes, its results kept."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segment-rows", type=int, default=260111)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--rows", type=int, nargs="+", default=[16, 64])
    args = ap.parse_args()

    import torch

    from knn_tpu_torch.ops.distance import prepare_train
    from knn_tpu_torch.ops.topk import knn_search

    dev = torch.device("cuda")
    a = torch.ones(8, 8, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.mm(a, a)
    torch.cuda.synchronize()
    ws = torch.cuda.memory_allocated() - base
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        base = torch.cuda.memory_allocated()
        torch.mm(a, a)
        side.synchronize()
        ws_new = torch.cuda.memory_allocated() - base

    gen = torch.Generator(device=dev).manual_seed(0)
    seg = torch.rand((args.segment_rows, args.dim), generator=gen,
                     device=dev) * 128.0
    n_valid = args.segment_rows - 7
    prep = prepare_train(seg, "l2")
    block = {}
    for rows in args.rows:
        q = torch.rand((rows, args.dim), generator=gen, device=dev) * 128.0
        scores = rows * args.segment_rows
        made_once = _added(lambda: knn_search(q, seg, args.k, "l2",
                                              n_valid=n_valid,
                                              prepared=prep))
        in_block = _added(lambda: knn_search(q, seg, args.k, "l2",
                                             n_valid=n_valid))
        block[str(rows)] = {
            "prepared_bytes": made_once,
            "prepared_bytes_per_score": made_once / scores,
            "norms_in_block_bytes": in_block,
            "norms_in_block_bytes_per_score": in_block / scores,
        }
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cublas_workspace_bytes": ws,
        "cublas_workspace_new_stream_bytes": ws_new,
        "segment_rows": args.segment_rows, "dim": args.dim, "k": args.k,
        "segment_bytes": seg.nbytes,
        "block": block,
    }))


if __name__ == "__main__":
    main()
