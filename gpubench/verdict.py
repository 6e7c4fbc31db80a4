"""The comparison that decides ``correct``: a job's output against the plain
reference (``reference.py``).

Numbers compared, each against its configuration's limit:

- ``gramian_mismatch``: entries of the job's Gramian that differ from the
  reference's exact one (limit 0);
- ``rows_wrong``: emitted rows that are missing, duplicated, unknown, of
  another dataset or malformed (limit 0);
- ``pc_error``: the widest of four shares, each of the reference's |λ₁|
  or of 1, for the emitted components vᵢ read back from the rows, with B
  the reference's float64 centred matrix:
  the residual ``‖B vᵢ − ρᵢ vᵢ‖ / (‖vᵢ‖ |λ₁|)`` with ρᵢ the Rayleigh
  quotient, the eigenvalue gap ``|ρᵢ − λᵢ| / |λ₁|``, the overlap
  ``|vᵢ·vⱼ| / (‖vᵢ‖ ‖vⱼ‖)`` of two components, and ``|‖vᵢ‖ − 1|``.
  A backward error: it does not depend on how far λ₂ lies from λ₃, which
  in a cohort of four equal populations is close;
- ``failed_jobs``: jobs in the window that raised or emitted another
  number of rows than the cohort has samples (limit 0).

The judge holds nothing (N, N) but the reference's int32 Gramian beside
the program's: the Gramians compare a row block at a time, integer to
integer, and B is the reference's :class:`Centred` operator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from gpubench.reference import (
    SCRATCH_BYTES,
    Centred,
    Cohort,
    JobOutput,
    reference_gramian,
    top_components,
)

#: The numbers compared, in the order they print.
NUMBERS = ("failed_jobs", "rows_wrong", "gramian_mismatch", "pc_error")
#: ``pc_error``'s share where a component is missing or not a number: a
#: finite value (the result line is strict JSON) no sound output reaches.
UNREADABLE = 1.0e9


def read_rows(cohort: Cohort, lines: List[str], num_pc: int) -> Tuple[int, torch.Tensor]:
    """``(wrong rows, components (N, num_pc) float64)`` from emitted rows;
    a sample without a sound row has NaN components."""
    index = {name: i for i, name in enumerate(cohort.names())}
    V = torch.full((cohort.num_samples, num_pc), math.nan, dtype=torch.float64)
    seen = set()
    wrong = 0
    for line in lines:
        fields = line.split("\t")
        i = index.get(fields[0])
        if i is None or i in seen or len(fields) != 2 + num_pc or fields[1] != cohort.variant_set_id:
            wrong += 1
            continue
        try:
            V[i] = torch.tensor([float(f) for f in fields[2:]], dtype=torch.float64)
        except ValueError:
            wrong += 1
            continue
        seen.add(i)
    return wrong + cohort.num_samples - len(seen), V


def gramian_mismatch(got: torch.Tensor, G: torch.Tensor) -> int:
    """Entries of the program's Gramian ``got`` that differ from the
    reference's G, compared a row block at a time on G's device; every
    entry where the shapes differ."""
    if tuple(got.shape) != tuple(G.shape):
        return G.numel()
    n = G.shape[0]
    rows = max(1, SCRATCH_BYTES // (4 * n))
    return sum(int((got[r : r + rows].to(G.device) != G[r : r + rows]).sum())
               for r in range(0, n, rows))


def pc_error_parts(B, evals: torch.Tensor, V: torch.Tensor) -> Dict[str, float]:
    """The four shares of ``pc_error`` for components V against B (a
    tensor or a :class:`Centred`)."""
    lam1 = float(evals.abs().max())
    norms = V.norm(dim=0)
    BV = B @ V
    rho = (V * BV).sum(dim=0) / norms**2
    residual = (BV - V * rho[None, :]).norm(dim=0) / (norms * lam1)
    unit = V / norms[None, :]
    gram = unit.T @ unit
    off = gram - torch.diag(torch.diagonal(gram))
    parts = {
        "residual": float(residual.max()),
        "eigval_gap": float(((rho - evals).abs() / lam1).max()),
        "overlap": float(off.abs().max()) if V.shape[1] > 1 else 0.0,
        "norm_gap": float((norms - 1).abs().max()),
    }
    return {k: (v if math.isfinite(v) else UNREADABLE) for k, v in parts.items()}


def judge(cohort: Cohort, output: JobOutput, num_pc: int, device) -> Dict[str, object]:
    """Readings of one job's output: ``gramian_mismatch``, ``rows_wrong``,
    ``pc_error`` and, for the record, ``pc_error``'s parts."""
    wrong, V = read_rows(cohort, output.lines, num_pc)
    G = reference_gramian(cohort, device)
    mismatch = gramian_mismatch(output.gramian, G)
    B = Centred(G)
    _, evals = top_components(B, num_pc)
    parts = pc_error_parts(B, evals, V.to(device))
    return {
        "gramian_mismatch": mismatch,
        "rows_wrong": wrong,
        "pc_error": max(parts.values()),
        "pc_error_parts": parts,
    }


def checks(readings: Dict[str, object], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in ``NUMBERS`` order."""
    return {name: {"value": readings[name], "limit": limits[name]} for name in NUMBERS}


def passes(table: Dict[str, Dict[str, float]]) -> bool:
    return all(row["value"] <= row["limit"] for row in table.values())


def worst(readings: List[Dict[str, object]]) -> Dict[str, object]:
    """The largest reading of each number over several judged jobs."""
    out: Dict[str, object] = {}
    for r in readings:
        for name, value in r.items():
            if name == "pc_error_parts":
                prev = out.get(name, {})
                out[name] = {k: max(v, prev.get(k, -math.inf)) for k, v in value.items()}
            else:
                out[name] = max(value, out.get(name, value))
    return out


__all__ = [
    "NUMBERS",
    "checks",
    "gramian_mismatch",
    "judge",
    "passes",
    "pc_error_parts",
    "read_rows",
    "worst",
]
