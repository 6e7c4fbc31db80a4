"""Numeric range and exactness contracts of the Gramian accumulation.

A JAX-free copy of the part of ``spark_examples_tpu/ops/contracts.py`` the
port's dense Gramian uses: the declared range of count-valued join rows,
the exact-integer window of each dtype, and the one flush projection
formula, :func:`flush_entry_increment`, which the accumulator checks before
every flush.

The port accumulates int8 × int8 → int32 from the first flush, so the
window that matters is int32's: the projection guards it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class RangeContract:
    """One declared operand range: every value of this operand class lies
    in ``[lo, hi]`` (inclusive) and, for ``integral`` contracts, is an
    integer."""

    name: str
    lo: int
    hi: int
    description: str
    integral: bool = True


#: Count-valued rows (same-set joins): a callset column appearing k times
#: per variant contributes k — the reference pair loop's multiplicity
#: (``VariantsPca.scala:224-229``). The declared ceiling is a set joined
#: with itself at most this many times; the accumulator measures the true
#: per-flush maximum, and the unpack kernel takes any count int8 holds.
SAME_SET_JOIN_MAX_COUNT = 4
COUNT_ROW = RangeContract(
    "count_row",
    0,
    SAME_SET_JOIN_MAX_COUNT,
    "count-valued join row (duplicate-id multiplicity, declared ceiling)",
)

#: Mantissa-driven exact-integer windows of the float dtypes: every
#: integer of magnitude <= the window is exactly representable.
_FLOAT_WINDOWS = {
    "float64": 1 << 53,
    "float32": 1 << 24,
    "bfloat16": 1 << 8,
    "float16": 1 << 11,
}


def exact_int_window(dtype) -> Optional[int]:
    """Largest magnitude M such that every integer ``|n| <= M`` is exactly
    representable in ``dtype`` (an int dtype's own max; 2^mantissa for
    floats; ``None`` for dtypes with no integer-exactness story). Accepts a
    name string, a numpy dtype or scalar type."""
    if isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", None) or str(dtype)
    if name in _FLOAT_WINDOWS:
        return _FLOAT_WINDOWS[name]
    try:
        np_dtype = np.dtype(name)
    except TypeError:
        return None
    if np_dtype.kind in ("i", "u"):
        return int(np.iinfo(np_dtype).max)
    if np_dtype.kind == "b":
        return 1
    return None


#: f32 accumulation is exact for integers up to 2^24 (the reference's
#: f32 → int32 switch point; the port is int32 throughout).
EXACT_F32_LIMIT = exact_int_window(np.float32) or (1 << 24)


def flush_entry_increment(rows: int, max_count: int) -> int:
    """Conservative per-entry Gramian increment of one flush of ``rows``
    variant rows whose entries are bounded by ``max_count``: every entry of
    ``XᵀX`` gains at most ``rows × max_count²``."""
    return int(rows) * int(max_count) * int(max_count)


#: Declared production geometry: the most candidate sites one run may scan
#: (the reference's ceiling: the whole-genome synthetic grid carries about
#: 39.5M). The host-memory bound charges it for inputs whose size it cannot
#: read (``check/hostmem.py``).
DECLARED_MAX_SITES = 40_000_000


__all__ = [
    "COUNT_ROW",
    "DECLARED_MAX_SITES",
    "EXACT_F32_LIMIT",
    "RangeContract",
    "SAME_SET_JOIN_MAX_COUNT",
    "exact_int_window",
    "flush_entry_increment",
]
