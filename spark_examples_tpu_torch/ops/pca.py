"""Principal components of the centered similarity matrix.

The reference feeds centered rows into MLlib's
``RowMatrix.computePrincipalComponents`` (``VariantsPca.scala:264-266``). For
a Gower double-centered matrix B (symmetric, zero row/column means) the
column covariance is ``B²/(n−1)``, whose eigenvectors are B's ordered by
eigenvalue *magnitude* — so the components are B's top-|λ| eigenvectors.

The driver path uses subspace iteration plus Rayleigh–Ritz (skinny
``(N×N)@(N×k)`` products and ``torch.linalg.qr``/``eigh``, as the JAX package
leaves these to XLA); the full ``eigh`` is the test oracle. The start is the
port's own ``torch.Generator`` seeded with 0, so components agree with the
JAX package's within the iteration's convergence, not bit for bit. Sign
convention: each component's largest-|entry| is positive.

Float32 products run in full float32: TF32 is switched off explicitly.

Under the sharded strategy the centred matrix is row tiles
(``parallel/mesh.py:RowSharded``): :func:`principal_components_subspace_sharded`
multiplies each tile by the skinny iterate and gathers the results, so no
position holds the N×N matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.parallel.collectives import all_gather_rows
from spark_examples_tpu_torch.parallel.mesh import RowSharded


def _full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


def _fix_signs(top: torch.Tensor) -> torch.Tensor:
    """Deterministic sign: the largest-|component| entry of each column is
    positive."""
    idx = top.abs().argmax(dim=0)
    signs = torch.sign(top[idx, torch.arange(top.shape[1], device=top.device)])
    return top * torch.where(signs == 0, torch.ones_like(signs), signs)


def _symmetric_f32(centered: torch.Tensor) -> torch.Tensor:
    B = centered.to(torch.float32)  # range: centered input is real-valued; the eigensolve is defined in f32, and integer exactness ends at the centering boundary by design
    return (B + B.T) * 0.5


def principal_components(
    centered: torch.Tensor, num_pc: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k principal components by a full ``eigh``: ``(components (N, k),
    eigenvalues (k,))``, |λ|-descending."""
    _full_float32()
    eigenvalues, eigenvectors = torch.linalg.eigh(_symmetric_f32(centered))
    order = torch.argsort(-eigenvalues.abs(), stable=True)[:num_pc]
    return _fix_signs(eigenvectors[:, order]), eigenvalues[order]


def principal_components_subspace(
    centered: torch.Tensor,
    num_pc: int = 2,
    iterations: int = 80,
    oversample: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k principal components by subspace iteration + Rayleigh–Ritz
    (``num_pc`` is tiny, so the O(N³) ``eigh`` is the wrong tool at cohort
    sizes). Deterministic: a fixed seed, a fixed iteration count."""
    _full_float32()
    B = _symmetric_f32(centered)
    n = B.shape[0]
    k = min(num_pc + oversample, n)
    generator = torch.Generator(device=B.device).manual_seed(0)
    V = torch.randn((n, k), generator=generator, dtype=B.dtype, device=B.device)
    V, _ = torch.linalg.qr(V)
    for _ in range(iterations):
        V, _ = torch.linalg.qr(B @ V)
    return _rayleigh_ritz(V, B @ V, num_pc)


def _rayleigh_ritz(V: torch.Tensor, W: torch.Tensor, num_pc: int):
    """Project (T = VᵀW, W = BV), eigh the small k×k, order by |λ| and fix
    the sign convention."""
    T = V.T @ W
    evals, Wk = torch.linalg.eigh((T + T.T) * 0.5)
    order = torch.argsort(-evals.abs(), stable=True)[:num_pc]
    return _fix_signs(V @ Wk[:, order]), evals[order]


def principal_components_subspace_sharded(
    centered: RowSharded,
    num_pc: int = 2,
    iterations: int = 80,
    oversample: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subspace iteration on a row-sharded centred matrix
    (``spark_examples_tpu/ops/pca.py:principal_components_subspace_sharded``):
    per iteration each tile computes ``B_local @ V`` (its true columns
    against the skinny iterate) and the (N, k) results are gathered; QR and
    Rayleigh–Ritz run once on the gathered iterate. The start is the dense
    solve's (the same seeded draw of the true ``N × k``), so the two agree
    within the dense solve's tolerance; padded rows come back zero.
    Returns ``(components (padded, num_pc), eigenvalues (num_pc,))`` on the
    device of this process's first tile; across processes the iterate is
    gathered in every process, so each runs the same solve."""
    _full_float32()
    n, padded = centered.n_true, centered.padded
    k = min(num_pc + oversample, n)
    device = centered.device
    generator = torch.Generator(device=device).manual_seed(0)
    V = torch.randn((n, k), generator=generator, dtype=torch.float32, device=device)
    V, _ = torch.linalg.qr(V)

    def gathered_bv(V: torch.Tensor) -> torch.Tensor:
        W = [None if tile is None else tile[:, :n] @ V.to(tile.device) for tile in centered.tiles]
        gathered = all_gather_rows(
            W, centered.positions if centered.shared else None,
            like=((centered.rows, k), torch.float32),
        )
        return gathered[0].to(device)[:n]

    for _ in range(iterations):
        V, _ = torch.linalg.qr(gathered_bv(V))
    components, evals = _rayleigh_ritz(V, gathered_bv(V), num_pc)
    pad = torch.zeros((padded - n, num_pc), dtype=components.dtype, device=device)
    return torch.cat([components, pad]), evals


def mllib_reference_pca(centered, num_pc: int = 2):
    """NumPy oracle replicating MLlib ``computePrincipalComponents``
    literally: column covariance of the rows, then eigh, descending
    eigenvalues (the ``--pca-backend host`` path)."""
    M = np.asarray(centered, dtype=np.float64)
    n = M.shape[0]
    mean = M.mean(axis=0, keepdims=True)
    cov = (M - mean).T @ (M - mean) / (n - 1)
    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    order = np.argsort(-eigenvalues)[:num_pc]
    return eigenvectors[:, order], eigenvalues[order]


__all__ = [
    "mllib_reference_pca",
    "principal_components",
    "principal_components_subspace",
    "principal_components_subspace_sharded",
]
