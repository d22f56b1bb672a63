"""The port's persistent kernel autotuning — knn_tpu/tuning for the CUDA
kernels.

Every coarse-kernel knob consumer resolves through one call::

    from knn_tpu_torch import tuning
    knobs = tuning.resolve(n, d, k, metric="l2",
                           overrides={"tile_n": explicit_or_None, ...})

Precedence: explicit overrides > the persisted winner for this exact
``(device kind, n, d, k, metric)`` > library defaults.  Winners come
from :func:`autotune` (``python -m knn_tpu_torch.cli tune``) and live in one
JSON file (:mod:`knn_tpu_torch.tuning.cache`; its path is an argument).
Candidates must reproduce the default configuration's certified answer
bitwise before they may win.
"""

from knn_tpu_torch.tuning.autotune import (
    DEFAULT_KNOBS,
    PROFILES,
    autotune,
    autotune_ivf,
    counters,
    device_kind_of,
    ivf_grid,
    ivf_label,
    knob_grid,
    prune_candidates,
    reset_counters,
    resolve,
    resolve_full,
)
from knn_tpu_torch.tuning.cache import (
    TuneCache,
    cache_key,
    default_cache_path,
    kernel_version_token,
    roofline_token,
)

__all__ = [
    "DEFAULT_KNOBS",
    "autotune",
    "autotune_ivf",
    "counters",
    "device_kind_of",
    "ivf_grid",
    "ivf_label",
    "knob_grid",
    "prune_candidates",
    "reset_counters",
    "resolve",
    "resolve_full",
    "PROFILES",
    "TuneCache",
    "cache_key",
    "default_cache_path",
    "kernel_version_token",
    "roofline_token",
]
