"""Peaks of one NVIDIA H100 SXM and the operations and bytes a kernel's
work needs, for roofline shares.

Peaks are NVIDIA's data sheet's dense rates at the card's full 700 W:
int8 tensor-core operations at 1,979 TOP/s and HBM3 at 3.35 TB/s. A card
set below 700 W reads a lower share; the result line carries its limit.
"""

from __future__ import annotations

PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def gram_ops(n: int, sites: int) -> int:
    """Operations of ``G += XᵀX`` over ``sites`` rows of ``n`` samples: the
    symmetric half with its diagonal, a multiply and an add each."""
    return n * (n + 1) // 2 * sites * 2


def gram_bytes(n: int, sites: int) -> int:
    """Bytes the product must move for one Gramian: Xᵀ read once (int8),
    the int32 G written once."""
    return n * sites + 4 * n * n


def least_seconds(ops: float, bytes_moved: float, ops_rate: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(ops / ops_rate, bytes_moved / PEAK_BYTES_PER_S)


def gram_least_seconds(n: int, sites: int) -> float:
    return least_seconds(gram_ops(n, sites), gram_bytes(n, sites), PEAK_INT8_OPS_PER_S)


__all__ = [
    "PEAK_BYTES_PER_S",
    "PEAK_INT8_OPS_PER_S",
    "gram_bytes",
    "gram_least_seconds",
    "gram_ops",
    "least_seconds",
]
