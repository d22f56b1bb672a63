"""Machine-readable source annotations the checkers key on — the port's
copy of knn_tpu/analysis/annotations.py.

Stdlib-only and import-cycle-free by construction (this module imports
nothing from knn_tpu_torch): runtime modules — serving, obs, tuning —
mark their own hot paths and thread-safety contracts here, and the AST
checkers (knn_tpu_torch.analysis) read the markers WITHOUT importing
those modules.

Two conventions:

- ``@hot_path`` / ``@hot_path(allow=("np.asarray",))`` — a function on
  the serving/dispatch hot path.  The torch-hygiene checker flags
  host-sync calls (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize``, ``.synchronize()`` on a stream or event,
  ``np.asarray``/``np.array``/``np.ascontiguousarray``,
  ``float()``/``int()`` of a call result) inside it.  ``allow``
  whitelists specific call names AT the annotation — the exemption
  rides next to the code it exempts, with the decorator itself as the
  written record (e.g. input coercion of host-side request arrays is
  np.asarray-by-design).  Runtime cost: one identity call at def time,
  zero per invocation.

- **Thread-safety docstring markers** (no runtime artifact at all):
  a class whose docstring contains ``Thread-safety: guarded by
  ``self._lock``.`` (any attribute name) opts into the concurrency
  checker — writes to shared attributes outside a ``with self._lock:``
  block become findings.  A helper method that REQUIRES the lock held
  declares it with ``Caller holds ``self._lock``.`` in its docstring.
  Grammar: knn_tpu_torch/analysis/check_concurrency.py.
"""

from __future__ import annotations

from typing import Callable, Sequence


def hot_path(fn: Callable = None, *, allow: Sequence[str] = ()):
    """Mark a function as serving-hot-path (see module docstring).
    Identity at runtime; the checker reads the decorator — and its
    ``allow`` tuple — from the AST."""
    if fn is not None:  # bare @hot_path
        return fn

    def wrap(f):
        return f

    return wrap
