"""Min-max normalization with the reference's transductive semantics — the
port of knn_tpu/ops/normalize.py (``normalize_transductive``) plus the
host rescale of knn_tpu/pipeline.py (``_np_minmax_apply``).

- Extrema are computed over train ∪ test ∪ val jointly (knn_mpi.cpp:245-274).
- Constant dimensions (max == min) pass through untouched (the
  ``max-min != 0`` guard at knn_mpi.cpp:284).
- Accumulators start at ±inf (the reference's ``max=-1, min=999999`` init
  at knn_mpi.cpp:241-242 is wrong for negative or large data).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


def local_minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension (min, max) over the rows of x [N, D]; (+inf, -inf) on
    empty input, the identity of a later min/max reduce."""
    if x.shape[0] == 0:
        d = x.shape[-1]
        return (torch.full((d,), torch.inf, device=x.device),
                torch.full((d,), -torch.inf, device=x.device))
    x32 = x.float()
    return x32.amin(0), x32.amax(0)


def minmax_stats(arrays: Iterable[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint per-dim (min, max) over several [N_i, D] tensors."""
    mins, maxs = None, None
    for a in arrays:
        lo, hi = local_minmax(a)
        mins = lo if mins is None else torch.minimum(mins, lo)
        maxs = hi if maxs is None else torch.maximum(maxs, hi)
    if mins is None:
        raise ValueError("minmax_stats needs at least one array")
    return mins, maxs


def minmax_apply(x: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """x -> (x - min) / (max - min), constant dims passed through."""
    x32 = x.float()
    rng = maxs - mins
    safe = torch.where(rng != 0, rng, 1.0)
    return torch.where(rng != 0, (x32 - mins) / safe, x32)


def np_minmax_apply(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host-side rescale with the same guard (the pipeline applies it on
    host so no full array has to sit on the device twice)."""
    rng = hi - lo
    safe = np.where(rng != 0, rng, 1.0)
    return np.where(rng != 0, (x - lo) / safe, x).astype(np.float32)


def normalize_transductive(
    train: torch.Tensor,
    test: Optional[torch.Tensor] = None,
    val: Optional[torch.Tensor] = None,
) -> Sequence[Optional[torch.Tensor]]:
    """Joint extrema over all provided sets, then rescale each; None
    passes through."""
    present = [a for a in (train, test, val) if a is not None]
    mins, maxs = minmax_stats(present)
    return tuple(None if a is None else minmax_apply(a, mins, maxs)
                 for a in (train, test, val))
