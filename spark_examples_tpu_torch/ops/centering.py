"""Gower double-centering of the similarity matrix.

The reference centers row-by-row against broadcast row sums
(``VariantsPca.scala:246-263``): entry (i, j) becomes
``v − rowMean(i) − colMean(j) + matrixMean`` with means over the full row
count N. The port computes it in float64 — the reference centers in Double,
and whole-genome counts pass 2^24, where float32 arithmetic would round the
counts themselves — and returns float32 for the eigensolve (float64 when
float64 came in), as ``spark_examples_tpu/ops/centering.py`` does under x64;
:func:`gower_center_sharded` does the same over the sharded strategy's row
tiles.
"""

from __future__ import annotations

import torch

from spark_examples_tpu_torch.parallel.collectives import all_reduce_sum
from spark_examples_tpu_torch.parallel.mesh import RowSharded


def gower_center(S: torch.Tensor) -> torch.Tensor:
    """B = S − rowMean − colMean + matrixMean (``VariantsPca.scala:252-263``)."""
    out = torch.float64 if S.dtype == torch.float64 else torch.float32
    Sw = S.to(torch.float64)
    row_mean = Sw.mean(dim=1, keepdim=True)
    col_mean = Sw.mean(dim=0, keepdim=True)
    return (Sw - row_mean - col_mean + Sw.mean()).to(out)


def gower_center_sharded(S: RowSharded, n_true: int | None = None) -> RowSharded:
    """Centering of a row-sharded Gramian (``spark_examples_tpu/ops/
    centering.py:gower_center_sharded``): row means are local to a tile,
    column and matrix means come from one sum of the tiles' column sums
    over the positions (the reference's ``psum``). Means divide by the true
    cohort ``n_true`` (default ``S.n_true``): padded rows and columns are
    zero, so sums over the padded extent are sums over the true one, and
    they are zeroed again after centring — the dense result embedded in a
    zero block. Float64 arithmetic in the reference's order (integer sums
    are exact in any order), float32 tiles out. Across processes each
    process centres its own tiles; the column sums are summed over every
    process."""
    n = S.n_true if n_true is None else int(n_true)
    wide = [None if tile is None else tile.to(torch.float64) for tile in S.tiles]
    col_sums = all_reduce_sum(
        [None if w is None else w.sum(dim=0, keepdim=True) for w in wide],
        S.shared, like=((1, S.padded), torch.float64),
    )
    out = []
    for i, (w, col_sum) in enumerate(zip(wide, col_sums)):
        if w is None:
            out.append(None)
            continue
        n_local, row_start = w.shape[0], i * S.rows
        row_mean = w.sum(dim=1, keepdim=True) / n
        col_mean = col_sum / n
        total_mean = col_sum.sum() / (n * n)
        centred = w - row_mean - col_mean + total_mean
        rows = torch.arange(row_start, row_start + n_local, device=w.device) < n
        cols = torch.arange(w.shape[1], device=w.device) < n
        out.append(torch.where(rows[:, None] & cols[None, :], centred, 0.0).to(torch.float32))  # range: centered values are real-valued (means subtracted); the subspace eigensolve runs in f32 by design, and integer exactness ends at the centering boundary
    return RowSharded(out, S.positions, n, S.padded, torch.float32, S.shared)


__all__ = ["gower_center", "gower_center_sharded"]
