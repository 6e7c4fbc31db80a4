"""Canonical allele-frequency filter arithmetic.

The ``--min-allele-frequency`` comparison (strictly greater,
``VariantsPca.scala:136-148``) must agree bit-for-bit across the host
synthetic source and the device generation kernel, whose AF values are Q32
dyadic rationals. The canonical rule compares micro-units:
``round(af · 1e6)  >  floor(threshold · 1e6)`` with the threshold expanded
over its exact binary value (via Fraction) — integer comparisons sidestep
the non-dyadic ``1e-6`` grid entirely.
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


__all__ = [
    "af_filter_micro",
    "af_passes",
]
