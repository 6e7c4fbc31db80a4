"""Composable public API: the PCoA pipeline as library functions.

The port of ``spark_examples_tpu/api.py``, itself the reference's Python
decomposition (``src/main/python/variants_pca.py:19-152``):
``prepare_call_data`` → ``calculate_similarity_matrix`` → ``center_matrix``
→ ``perform_pca``, and the flag-driven :func:`pca`. ``device`` takes the
place of the reference's ``mesh``: the Gramian accumulates on the CUDA card
unless the caller asks for the CPU, and stays there through centering and
the eigensolve; only :func:`perform_pca`'s (N, num_pc) result comes back.

Example (synthetic cohort, BRCA1 region, on the CPU)::

    >>> from spark_examples_tpu_torch import api
    >>> from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
    >>> source = SyntheticGenomicsSource(num_samples=12, seed=5)
    >>> callsets = source.search_callsets(["vs"])
    >>> id_to_index = {c["id"]: i for i, c in enumerate(callsets)}
    >>> variants = source.client().search_variants(
    ...     {"variantSetIds": ["vs"], "referenceName": "17",
    ...      "start": 41196311, "end": 41216311}
    ... )
    >>> calls = api.prepare_call_data(variants, id_to_index)
    >>> S = api.calculate_similarity_matrix(calls, len(id_to_index), device="cpu")
    >>> B = api.center_matrix(S)
    >>> components = api.perform_pca(B, num_pc=2)
    >>> components.shape
    (12, 2)
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.ops.gramian import GramianAccumulator, accumulate_index_rows
from spark_examples_tpu_torch.ops.pca import principal_components_subspace
from spark_examples_tpu_torch.utils.device import DeviceLike


def prepare_call_data(
    variants: Iterable[Mapping],
    id_to_index: Dict[str, int],
    use_names: bool = True,
) -> Iterator[List[int]]:
    """Wire variant records → per-variant lists of varying column indices.

    The counterpart of ``variants_pca.py:prepare_call_data`` (``:19-52``):
    keep calls with any non-zero genotype, drop empty rows, map callset
    names (or ids, ``use_names=False``) to matrix columns."""
    key = "callSetName" if use_names else "callSetId"
    for record in variants:
        calls = record.get("calls", []) if isinstance(record, Mapping) else [
            {
                "callSetName": c.callset_name,
                "callSetId": c.callset_id,
                "genotype": c.genotype,
            }
            for c in (record.calls or [])
        ]
        row = [
            id_to_index[c[key]]
            for c in calls
            # Variation means a strictly positive allele (Call.has_variation,
            # ``VariantsPca.scala:67``) — no-call encodings like -1 don't count.
            if any(g > 0 for g in c["genotype"]) and c[key] in id_to_index
        ]
        if row:
            yield row


def calculate_similarity_matrix(
    call_rows: Iterable[Sequence[int]],
    matrix_size: int,
    block_size: int = 1024,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Per-variant index rows → similarity counts ``G = XᵀX`` on the device
    (int32, exact).

    The counterpart of ``variants_pca.py:calculate_similarity_matrix``
    (``:54-82``): blocks of rows ship bit-packed to the card, which unpacks
    and accumulates them (``ops/gramian.py``)."""
    acc = GramianAccumulator(matrix_size, device=device, block_size=block_size)
    accumulate_index_rows(acc, call_rows, matrix_size, block_size)
    return acc.finalize_device()


def center_matrix(similarity) -> torch.Tensor:
    """Gower double-centering, the counterpart of
    ``variants_pca.py:center_matrix`` (``:84-121``): float64 arithmetic on
    the similarity's device, float32 out (float64 when float64 came in), as
    the driver centers. A host array is centered on the CPU."""
    if not isinstance(similarity, torch.Tensor):
        similarity = torch.from_numpy(np.asarray(similarity))
    return gower_center(similarity)


def perform_pca(centered: torch.Tensor, num_pc: int = 2) -> np.ndarray:
    """Top principal components of the centered similarity matrix, the
    counterpart of ``variants_pca.py:perform_pca`` (``:123-152``): subspace
    iteration on the matrix's device; only the (N, num_pc) result lands on
    the host, as float64."""
    components, _ = principal_components_subspace(centered, num_pc)
    return components.cpu().numpy().astype(np.float64)


def pca(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> List[str]:
    """The full flag-driven pipeline (``variants_pca.py:pca``, ``:154-201``):
    parses the reference's flag grammar, runs the driver end to end, returns
    the emitted TSV lines. ``device`` overrides ``--device``."""
    from spark_examples_tpu_torch.pipeline.pca_driver import run

    return run(list(argv) if argv is not None else [], device=device)


__all__ = [
    "calculate_similarity_matrix",
    "center_matrix",
    "pca",
    "perform_pca",
    "prepare_call_data",
]
