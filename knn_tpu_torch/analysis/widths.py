"""Per-precision db operand byte widths — the port's copy of the parts of
knn_tpu/analysis/widths.py (and of the JAX package's
``obs.roofline.db_operand_nbytes``) that the IVF tier's stats read, kept at
the JAX package's widths so ``bytes_streamed_ratio`` is its value (the
bytes the port places per arm are knn_tpu_torch.obs.roofline's
``db_operand_nbytes``).

What the coarse kernels stream per db row (ops.coarse_knn.prepare_db*):
bf16x3 the bf16 hi and lo parts (2 + 2 B/elem), bf16x3f one 3x-wide bf16
contraction (6 B/elem), int8 one byte, int4 two dims per byte over the
DIM_CHUNK-padded dims, pq one code byte per subspace, highest and default
the f32 rows (4 B/elem); beside them an aux block of f32 rows per db row
(8 norm rows; int8 stacks 8 scale rows under them).
"""

from __future__ import annotations

from typing import Dict

from knn_tpu_torch.ops.coarse_knn import DIM_CHUNK
from knn_tpu_torch.ops.pq import PQ_DSUB_DEFAULT

#: db stream width per element by kernel precision; "pq" is absent (its
#: row width is ``ceil(d / dsub)`` bytes: :func:`db_row_bytes`)
DB_ELEM_BYTES: Dict[str, float] = {
    "bf16x3": 4, "bf16x3f": 6, "int8": 1, "int4": 0.5,
    "highest": 4, "default": 4,
}

#: f32 aux bytes beside each placed row (the hoisted squared norm) — the
#: placement model of analysis.hbm (the JAX package's widths.py:86)
AUX_BYTES_PER_ROW = 4

#: f32 rows of the per-tile aux block by precision
AUX_ROWS: Dict[str, int] = {"int8": 16}
AUX_ROWS_DEFAULT = 8


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def db_row_bytes(d: int, precision: str) -> int:
    """Exact bytes one db row streams at this precision: int4 rounds the
    DIM_CHUNK-padded dim up to nibble pairs, pq streams ``ceil(d / dsub)``
    code bytes at the default subspace width (the only one a tier
    places)."""
    d = int(d)
    if precision == "pq":
        return _ceil_div(d, PQ_DSUB_DEFAULT)
    if precision == "int4":
        return _ceil_div(_ceil_div(d, DIM_CHUNK) * DIM_CHUNK, 2)
    if precision not in DB_ELEM_BYTES:
        raise ValueError(
            f"precision {precision!r} not in "
            f"{sorted(DB_ELEM_BYTES) + ['pq']}")
    return int(d * DB_ELEM_BYTES[precision])


def aux_rows_for(precision: str) -> int:
    return AUX_ROWS.get(precision, AUX_ROWS_DEFAULT)


def db_operand_nbytes(n: int, d: int, precision: str) -> Dict[str, int]:
    """Bytes of the db-side operands one full stream of ``n`` rows moves:
    the values and the aux block (knn_tpu/obs/roofline.py:342-355)."""
    return {
        "db_values": int(n) * db_row_bytes(d, precision),
        "db_aux": int(n) * aux_rows_for(precision) * 4,
    }
