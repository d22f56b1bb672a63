"""Query-distribution drift sketches and index-health gauges — the port of
knn_tpu/obs/drift.py (pure numpy, the JAX package's arithmetic line for
line, so the two give equal values on the same inputs).

Recall regressions tend to start before a wrong answer shows: the query
distribution walks away from the one the index was trained on (IVF
centroids mis-assign, the probe set stops covering), or the index degrades
structurally (one list absorbs the growth, the delta tail swamps the
trained base, tombstones dilute every scan).  This module makes both
gauges.

:class:`QueryDriftMonitor` freezes a train-time baseline (a query-norm
histogram over quantile bin edges of the training rows' norms, and the
k-means centroid-assignment histogram) and scores every live batch's
accumulated distribution against it with the population stability index::

    PSI = sum_i (q_i - p_i) * ln(q_i / p_i)

(eps-smoothed; 0 = identical, > 0.2 the classical "investigate" bar, > 0.5
"act").  The sketches are O(bins) counters (no query is kept), and
``IVFIndex`` builds a monitor only while telemetry is on
(``obs.reset(enabled=False)`` builds none).

:func:`index_health` publishes the structural gauges from a snapshot's
geometry: list imbalance (max / mean trained-list size), delta-tail
fraction and tombstone density.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from knn_tpu_torch.obs import names, registry

#: norm-histogram bins (quantile edges over the training norms)
NORM_BINS = 16
#: smoothing epsilon for PSI (an empty bin must not blow up the log)
_EPS = 1e-6


def psi(expected: np.ndarray, observed: np.ndarray) -> float:
    """Population stability index between two count / fraction vectors of
    equal length (eps-smoothed, each renormalized)."""
    p = np.asarray(expected, np.float64) + _EPS
    q = np.asarray(observed, np.float64) + _EPS
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


class QueryDriftMonitor:
    """Streaming drift sketch against a frozen train-time baseline.

    ``train_norms`` are the L2 norms of the training rows (the baseline
    the norm sketch bins against); ``assign_baseline`` is the per-centroid
    training assignment count vector (the k-means counts).  Either may be
    omitted; its PSI is then not scored."""

    def __init__(self, train_norms: Optional[np.ndarray] = None,
                 assign_baseline: Optional[np.ndarray] = None,
                 nbins: int = NORM_BINS) -> None:
        self._norm_edges: Optional[np.ndarray] = None
        self._norm_base: Optional[np.ndarray] = None
        self._norm_counts: Optional[np.ndarray] = None
        if train_norms is not None and len(train_norms) > 0:
            tn = np.asarray(train_norms, np.float64)
            # interior edges only: the two outer bins are open-ended, so a
            # live norm out of the training range lands in a bin
            edges = np.unique(np.quantile(
                tn, np.linspace(0.0, 1.0, nbins + 1)[1:-1]))
            self._norm_edges = edges
            base = np.bincount(np.searchsorted(edges, tn),
                               minlength=len(edges) + 1)
            self._norm_base = base.astype(np.float64)
            self._norm_counts = np.zeros(len(edges) + 1, np.float64)
        self._assign_base: Optional[np.ndarray] = None
        self._assign_counts: Optional[np.ndarray] = None
        if assign_baseline is not None and len(assign_baseline) > 0:
            ab = np.asarray(assign_baseline, np.float64)
            self._assign_base = ab
            self._assign_counts = np.zeros(len(ab), np.float64)
        self._queries = 0

    def observe(self, norms: Optional[np.ndarray] = None,
                assignments: Optional[np.ndarray] = None) -> None:
        """Fold one live batch into the sketches and publish the PSI
        gauges.  ``norms``: per-query L2 norms; ``assignments``: per-query
        nearest-centroid index."""
        n_q = 0
        if norms is not None and self._norm_edges is not None:
            ns = np.asarray(norms, np.float64).ravel()
            n_q = max(n_q, ns.shape[0])
            self._norm_counts += np.bincount(
                np.searchsorted(self._norm_edges, ns),
                minlength=self._norm_counts.shape[0])
            registry.gauge(names.DRIFT_NORM_PSI).set(
                psi(self._norm_base, self._norm_counts))
        if assignments is not None and self._assign_base is not None:
            asg = np.asarray(assignments, np.int64).ravel()
            n_q = max(n_q, asg.shape[0])
            self._assign_counts += np.bincount(
                np.clip(asg, 0, self._assign_base.shape[0] - 1),
                minlength=self._assign_base.shape[0])
            registry.gauge(names.DRIFT_ASSIGN_PSI).set(
                psi(self._assign_base, self._assign_counts))
        if n_q:
            self._queries += n_q
            registry.counter(names.DRIFT_QUERIES).inc(n_q)

    def status(self) -> dict:
        """JSON-safe sketch state for /statusz and doctor."""
        out = {"queries_observed": self._queries}
        if self._norm_base is not None:
            out["norm_psi"] = psi(self._norm_base, self._norm_counts)
            out["norm_bins"] = int(self._norm_counts.shape[0])
        if self._assign_base is not None:
            out["centroid_assign_psi"] = psi(self._assign_base,
                                             self._assign_counts)
            out["centroids"] = int(self._assign_base.shape[0])
        return out


def index_health(list_sizes: Optional[np.ndarray], tail_rows: int,
                 n_all: int, live_rows: int) -> dict:
    """Publish the structural index-health gauges from one snapshot's
    geometry and return the same numbers as a JSON-safe dict:

    - list imbalance: max / mean trained IVF list size (1.0 = balanced);
    - delta-tail fraction: unindexed tail rows / all rows, the slice every
      search brute-forces;
    - tombstone density: dead rows / all rows, the dilution of every byte
      streamed."""
    out = {}
    if list_sizes is not None and len(list_sizes) > 0:
        sizes = np.asarray(list_sizes, np.float64)
        mean = float(sizes.mean())
        imbalance = float(sizes.max() / mean) if mean > 0 else 0.0
        registry.gauge(names.INDEX_LIST_IMBALANCE).set(imbalance)
        out["list_imbalance"] = imbalance
    if n_all > 0:
        tail_fraction = float(tail_rows) / float(n_all)
        tombstone_density = float(n_all - live_rows) / float(n_all)
        registry.gauge(names.INDEX_TAIL_FRACTION).set(tail_fraction)
        registry.gauge(names.INDEX_TOMBSTONE_DENSITY).set(tombstone_density)
        out["delta_tail_fraction"] = tail_fraction
        out["tombstone_density"] = tombstone_density
    return out
