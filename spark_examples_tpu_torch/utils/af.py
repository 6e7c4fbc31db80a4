"""Canonical allele-frequency filter arithmetic.

The ``--min-allele-frequency`` comparison (strictly greater,
``VariantsPca.scala:136-148``) must agree bit-for-bit across the host
synthetic source and the device generation kernel, whose AF values are Q32
dyadic rationals. The canonical rule compares micro-units:
``round(af · 1e6)  >  floor(threshold · 1e6)`` with the threshold expanded
over its exact binary value (via Fraction) — integer comparisons sidestep
the non-dyadic ``1e-6`` grid entirely.

Also the analyses' exact integer per-site moments (:func:`carrier_counts`,
:func:`variance_counts`), as in ``spark_examples_tpu/utils/af.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def af_filter_micro(threshold: Optional[float]) -> Optional[int]:
    """``floor(threshold · 1e6)`` over the exact binary value of the
    threshold. ``None`` stays ``None`` (no filter)."""
    if threshold is None:
        return None
    from fractions import Fraction

    return int(Fraction(threshold) * 10**6 // 1)


def af_passes(af: np.ndarray, threshold: Optional[float]) -> np.ndarray:
    """Canonical micro-unit comparison. ``af`` may be the Q32 dyadic site AF
    or a value parsed back from the 6-decimal wire string — both round to
    the same integer (round-half-even, matching the device kernel)."""
    if threshold is None:
        return np.ones(np.shape(af), dtype=bool)
    micro = np.round(np.asarray(af, dtype=np.float64) * 1e6).astype(np.int64)
    return micro > af_filter_micro(threshold)


def carrier_counts(rows: np.ndarray) -> np.ndarray:
    """Per-site carrier counts ``k = Σ_s x[v, s]`` of a ``(B, N)``
    has-variation block (``ops/contracts.py:HAS_VARIATION`` {0,1} rows;
    count-valued join rows are out of contract for the analyses). int64 so
    downstream integer moments (``k²``, ``k·(n−k)``, ``n·C − k_i·k_j``)
    never wrap. Ragged tails are fine: B is whatever arrived."""
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"expected a (B, N) block, got shape {rows.shape}")
    return rows.astype(np.int64, copy=False).sum(axis=1)


def variance_counts(counts: np.ndarray, num_samples: int) -> np.ndarray:
    """Integer per-site variance numerator ``k · (n − k) = n² · p·q`` —
    exact int64, the shared denominator ingredient of GRM's VanRaden
    scaling and LD's r². Monomorphic sites (k == 0 or k == n) are exactly
    0, the zero-variance guard every consumer inherits. Counts outside
    [0, n] fail loudly: they mean a count-valued join row leaked into a
    {0,1} has-variation path (the frequency ``k / n`` would leave the
    ``ops/contracts.py:ALLELE_FREQUENCY`` [0, 1] range)."""
    n = int(num_samples)
    if n < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    k = np.asarray(counts, dtype=np.int64)
    if k.size and (k.min() < 0 or k.max() > n):
        raise ValueError(
            f"carrier counts outside [0, {n}]: min {k.min()}, max {k.max()} "
            "(has-variation rows must be {0,1} membership bits)"
        )
    return k * (n - k)


__all__ = [
    "af_filter_micro",
    "af_passes",
    "carrier_counts",
    "variance_counts",
]
