"""Gower double-centering of the similarity matrix.

The reference centers row-by-row against broadcast row sums
(``VariantsPca.scala:246-263``): entry (i, j) becomes
``v − rowMean(i) − colMean(j) + matrixMean`` with means over the full row
count N. The port computes it in float64 — the reference centers in Double,
and whole-genome counts pass 2^24, where float32 arithmetic would round the
counts themselves — and returns float32 for the eigensolve (float64 when
float64 came in), as ``spark_examples_tpu/ops/centering.py`` does under x64.
"""

from __future__ import annotations

import torch


def gower_center(S: torch.Tensor) -> torch.Tensor:
    """B = S − rowMean − colMean + matrixMean (``VariantsPca.scala:252-263``)."""
    out = torch.float64 if S.dtype == torch.float64 else torch.float32
    Sw = S.to(torch.float64)
    row_mean = Sw.mean(dim=1, keepdim=True)
    col_mean = Sw.mean(dim=0, keepdim=True)
    return (Sw - row_mean - col_mean + Sw.mean()).to(out)


__all__ = ["gower_center"]
