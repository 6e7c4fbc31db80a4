"""Numeric range and exactness contracts of the Gramian accumulation.

A JAX-free copy of ``spark_examples_tpu/ops/contracts.py``: the declared
range of each operand class (:data:`CONTRACTS`, which ``graftcheck ranges``
seeds its intervals from), the exact-integer window of each dtype, and the
one flush projection formula, :func:`flush_entry_increment`, which the
accumulator checks before every flush.

The port accumulates int8 × int8 → int32 from the first flush, so the
window that matters is int32's: the projection guards it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

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


#: VCF/synthetic genotype allele-dosage values (0 = ref, 1 = het, 2 = hom
#: alt): the widest per-site value the parse and generation layers stage.
GENOTYPE = RangeContract(
    "genotype", 0, 2, "diploid allele dosage (0/1/2) from parse/devicegen"
)

#: The Gramian's row operand on every default path: the per-(variant,
#: sample) has-variation membership bit (``VariantsPca.scala:65-69``).
HAS_VARIATION = RangeContract(
    "has_variation", 0, 1, "per-sample has-variation membership bit"
)

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

#: Allele frequencies, the one real-valued (non-integral) contract.
ALLELE_FREQUENCY = RangeContract(
    "allele_frequency", 0, 1, "per-site allele frequency", integral=False
)

#: A bit-packed ring or staging wire byte (8 has-variation bits,
#: ``np.packbits``).
PACKED_BYTE = RangeContract(
    "packed_byte", 0, 255, "bit-packed wire byte (8 has-variation bits)"
)

CONTRACTS: Dict[str, RangeContract] = {
    c.name: c
    for c in (GENOTYPE, HAS_VARIATION, COUNT_ROW, ALLELE_FREQUENCY, PACKED_BYTE)
}

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


def exactness_headroom_sites(dtype, max_count: int = 1) -> int:
    """The largest variant-row count whose Gramian accumulation is provably
    exact on ``dtype``: ``window(dtype) // max_count²`` (0 when the dtype
    has no exact-integer window) — the reference's formula, which
    ``graftcheck plan`` reports for float32 and int32."""
    window = exact_int_window(dtype)
    if window is None or max_count < 1:
        return 0
    return int(window) // (int(max_count) * int(max_count))


#: Declared production geometry: the most candidate sites one run may scan
#: (the reference's ceiling: the whole-genome synthetic grid carries about
#: 39.5M). The host-memory bound charges it for inputs whose size it cannot
#: read (``check/hostmem.py``).
DECLARED_MAX_SITES = 40_000_000

#: Site-grid scalars: dispatch offsets, valid-site counts and per-set row
#: counters, all bounded by the declared production geometry. The contract
#: of the generation kernel's scalar operands (``ops/devicegen.py:
#: gen_genotypes``): without it every generated genotype, a function of
#: its site's position, would be unbounded to the range prover.
SITE_INDEX = RangeContract(
    "site_index",
    0,
    DECLARED_MAX_SITES,
    "site-grid offset / site count (declared geometry ceiling)",
)
CONTRACTS[SITE_INDEX.name] = SITE_INDEX


__all__ = [
    "ALLELE_FREQUENCY",
    "CONTRACTS",
    "COUNT_ROW",
    "DECLARED_MAX_SITES",
    "EXACT_F32_LIMIT",
    "GENOTYPE",
    "HAS_VARIATION",
    "PACKED_BYTE",
    "RangeContract",
    "SAME_SET_JOIN_MAX_COUNT",
    "SITE_INDEX",
    "exact_int_window",
    "exactness_headroom_sites",
    "flush_entry_increment",
]
