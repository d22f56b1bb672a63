"""Coarse-kernel knob defaults — a copy of ``DEFAULT_KNOBS`` from
knn_tpu/tuning/autotune.py:56-67.

The JAX package resolves knobs as explicit argument > persisted autotuner
winner > these defaults.  The autotuner and its cache are a later slice of
the port, so here a knob resolves as explicit argument, else default.
The copy leaves out ``block_q``: it only re-blocks query rows of the TPU
grid, and the CUDA kernel picks its own query block.
"""

from __future__ import annotations

from typing import Dict

DEFAULT_KNOBS: Dict[str, object] = {
    "kernel": "tiled",
    "tile_n": None,
    "bin_w": None,
    "survivors": None,
    "precision": "bf16x3",
    "final_select": "exact",
    "binning": "grouped",
    "grid_order": "query_major",
    "final_recall_target": None,
}


def resolve(**overrides) -> Dict[str, object]:
    """The knob set a call runs: every explicit (non-None) override wins,
    everything else takes its default."""
    unknown = set(overrides) - set(DEFAULT_KNOBS)
    if unknown:
        raise ValueError(f"unknown knobs {sorted(unknown)}")
    out = dict(DEFAULT_KNOBS)
    out.update({k: v for k, v in overrides.items() if v is not None})
    return out
