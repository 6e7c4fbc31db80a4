"""Per-site case/control association scan: allelic 2×2 chi-square, the
``assoc-scan`` verb.

The port's copy of ``spark_examples_tpu/analyses/assoc.py``. Phenotypes
arrive as a two-column TSV (callset name, status 0/1); per streamed block
the device counts the carriers among the cases ``a`` and in all ``t``
(``ops/ld.py:case_counts``: on the card ``case_counts_kernel`` over the
block's bit-packed rows, launched on the B rows the block has), and the
host closes the 2×2 table in exact integers:

    a = case carriers        b = n_cases − a
    c = control carriers = t − a
    d = n_controls − c

    χ² = n · (a·d − b·c)² / (n_cases · n_controls · t · (n − t))

The cross-product difference is int64 (|a·d − b·c| ≤ n²/4) and squared in
float64, so the statistic is the exact float64 of the integer counts and
the NumPy oracle (:func:`chi2_from_counts` over ``case_counts_reference``)
matches it with zero tolerance. Sites with ``t == n`` get χ² = 0 by the
shared zero-variance convention; ``t == 0`` rows never arrive (the sources
drop all-zero rows).

Per-site statistics spill through the windowed writer
(``pipeline/sitewriter.py``); the printed ranking rides a bounded
``--assoc-top`` heap, so nothing O(M) lives on the host. The stage
``ingest+assoc-scan`` carries the child ``assoc-case-counts``, summed over
the blocks: the packing, the copy to the device, the kernel and the fetch.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch.analyses.base import AnalysisContext, finish_analysis_run
from spark_examples_tpu_torch.config import AssocConf
from spark_examples_tpu_torch.obs.heartbeat import Heartbeat
from spark_examples_tpu_torch.ops.ld import block_case_counts, case_counts_reference, pack_case
from spark_examples_tpu_torch.pipeline.sitewriter import SiteOutputWriter
from spark_examples_tpu_torch.utils.device import DeviceLike, synchronizer
from spark_examples_tpu_torch.utils.tracing import StageTimes


def load_phenotypes(path: str) -> Dict[str, int]:
    """Parse the ``--phenotypes`` TSV: ``name<TAB>status`` per line, '#'
    comments and blank lines skipped, status strictly 0 or 1. Duplicate
    names and malformed lines fail loudly — a silently-dropped sample
    would bias every statistic."""
    statuses: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{lineno}: expected 'name<TAB>status', got {line!r}"
                )
            name, status = parts[0].strip(), parts[1].strip()
            if status not in ("0", "1"):
                raise ValueError(
                    f"{path}:{lineno}: status must be 0 (control) or 1 "
                    f"(case), got {status!r}"
                )
            if name in statuses:
                raise ValueError(f"{path}:{lineno}: duplicate sample {name!r}")
            statuses[name] = int(status)
    if not statuses:
        raise ValueError(f"{path}: no phenotype rows")
    values = set(statuses.values())
    if values != {0, 1}:
        missing = "case (1)" if 1 not in values else "control (0)"
        raise ValueError(
            f"{path}: needs at least one case AND one control; no "
            f"{missing} rows present"
        )
    return statuses


def case_vector(statuses: Dict[str, int], sample_names: Sequence[str]) -> np.ndarray:
    """The cohort-ordered {0,1} case mask. Coverage is strict both ways:
    every cohort sample must carry a status, and every status row must
    name a cohort sample — anything else is a silent cohort mismatch."""
    missing = [n for n in sample_names if n not in statuses]
    if missing:
        raise ValueError(
            f"--phenotypes covers {len(statuses)} samples but the cohort "
            f"has {len(sample_names)}; missing e.g. {missing[:5]}"
        )
    extra = set(statuses) - set(sample_names)
    if extra:
        raise ValueError(
            f"--phenotypes names {len(extra)} sample(s) not in the "
            f"cohort, e.g. {sorted(extra)[:5]}"
        )
    return np.array([statuses[n] for n in sample_names], dtype=np.uint8)


def chi2_from_counts(
    a: np.ndarray,
    t: np.ndarray,
    n_cases: int,
    n_controls: int,
) -> np.ndarray:
    """Vectorized allelic chi-square from integer per-site counts (module
    docstring formula), float64, with the zero-variance guard (``t == 0``
    or ``t == n`` → 0). Shared verbatim by the streamed run and the
    NumPy oracle — parity is exact equality."""
    n = int(n_cases) + int(n_controls)
    a = np.asarray(a, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    c = t - a
    b = n_cases - a
    d = n_controls - c
    diff = a * d - b * c  # |diff| <= n_cases*n_controls <= n²/4: exact int64
    denom = (
        float(n_cases)
        * float(n_controls)
        * t.astype(np.float64)
        * (n - t).astype(np.float64)
    )
    num = float(n) * diff.astype(np.float64) ** 2
    out = np.zeros_like(num)
    np.divide(num, denom, out=out, where=denom > 0)
    return out


@dataclass
class AssocResult:
    """One completed scan: tested-site count, the bounded top ranking
    (``(chi2, contig, pos, case_carriers, total_carriers)`` descending),
    the output path (when written), and the manifest bookkeeping."""

    sites_tested: int
    top: List[Tuple[float, str, int, int, int]]
    n_cases: int
    n_controls: int
    out_path: Optional[str] = None
    manifest: Optional[Dict] = None
    manifest_path: Optional[str] = None


def run_assoc_pipeline(conf: AssocConf, device: DeviceLike = None) -> AssocResult:
    """The association-scan core, CLI-free: conf in, per-site statistics
    out (spilled), bounded top ranking returned; on ``device`` (default
    ``conf.device``)."""
    if not conf.phenotypes:
        raise ValueError("the assoc analysis requires --phenotypes TSV")
    ctx = AnalysisContext(conf, "assoc", device=device)
    statuses = load_phenotypes(conf.phenotypes)
    case = case_vector(statuses, ctx.sample_names())
    n_cases = int(case.sum())
    n_controls = ctx.num_samples - n_cases
    print(f"Phenotypes: {n_cases} cases / {n_controls} controls.")
    times = StageTimes(recorder=ctx.spans)
    host_oracle = conf.pca_backend == "host"
    case_packed = None if host_oracle else pack_case(case, ctx.device)
    writer = None
    if conf.assoc_out:
        writer = SiteOutputWriter(
            conf.assoc_out,
            header=("contig", "pos", "case_carriers", "carriers", "chi2"),
        )
    heartbeat = None
    if conf.heartbeat_seconds > 0:
        heartbeat = Heartbeat(conf.heartbeat_seconds, ctx.registry).start()
    sites_tested = 0
    counts_seconds = 0.0
    # Bounded ranking: a size-K min-heap of (chi2, tie-break) — the O(M)
    # stream never accumulates, only the K best survive on the host.
    top_heap: List[Tuple[float, int, str, int, int, int]] = []
    seq = 0
    try:
        with times.stage("ingest+assoc-scan", sync=synchronizer(ctx.device)):
            for contig, block in ctx.blocks():
                hv = np.asarray(block["has_variation"], dtype=np.uint8)
                positions = np.asarray(block["positions"], dtype=np.int64)
                t0 = time.perf_counter()
                if host_oracle:
                    a, t = case_counts_reference(hv, case)
                else:
                    # The kernel runs on the rows the block has: no padding
                    # to --block-size (the reference pads for one compile).
                    a, t = block_case_counts(hv, case_packed, ctx.device)
                counts_seconds += time.perf_counter() - t0
                chi2 = chi2_from_counts(a, t, n_cases, n_controls)
                if writer is not None:
                    writer.write_rows(
                        (contig, int(positions[i]), int(a[i]), int(t[i]), repr(float(chi2[i])))
                        for i in range(len(positions))
                    )
                # Vectorized candidate pre-filter: once the heap is full, a
                # streamed site can only displace the minimum with a
                # STRICTLY greater chi2 (every heap entry has an earlier
                # seq, so equal statistics always lose the -seq
                # tie-break) — the Python-level heap loop runs over the
                # handful of block rows above the floor, not all M sites.
                if len(top_heap) < conf.assoc_top:
                    candidates = range(len(positions))
                else:
                    candidates = np.nonzero(chi2 > top_heap[0][0])[0]
                for i in candidates:
                    # seq is a deterministic tie-break (stream order) so
                    # equal statistics rank stably across runs.
                    entry = (
                        float(chi2[i]),
                        -(seq + int(i)),
                        contig,
                        int(positions[i]),
                        int(a[i]),
                        int(t[i]),
                    )
                    if len(top_heap) < conf.assoc_top:
                        heapq.heappush(top_heap, entry)
                    elif entry > top_heap[0]:
                        heapq.heapreplace(top_heap, entry)
                seq += len(positions)
                sites_tested += len(positions)
            ctx.spans.add("assoc-case-counts", counts_seconds, synced=not host_oracle)
    except BaseException:
        if writer is not None:
            writer.abort()
        raise
    finally:
        if heartbeat is not None:
            heartbeat.stop()
    if writer is not None:
        writer.close()
        print(f"Per-site scan written to {conf.assoc_out}.")
    top = [
        (chi2, contig, pos, a_i, t_i)
        for chi2, _seq, contig, pos, a_i, t_i in sorted(top_heap, reverse=True)
    ]
    print(f"Association scan: {sites_tested} sites tested.")
    for chi2, contig, pos, a_i, t_i in top:
        print(f"{contig}\t{pos}\t{a_i}\t{t_i}\t{chi2:.6g}")
    print(str(ctx.io_stats))
    if conf.profile_dir:
        print(str(times))
    manifest, manifest_path, _ = finish_analysis_run(
        conf,
        "assoc",
        ctx.spans,
        ctx.registry,
        ctx.io_stats,
        sites_tested=sites_tested,
        sites_kept=None,
    )
    return AssocResult(
        sites_tested=sites_tested,
        top=top,
        n_cases=n_cases,
        n_controls=n_controls,
        out_path=conf.assoc_out,
        manifest=manifest,
        manifest_path=manifest_path,
    )


def run(argv: Sequence[str], device: DeviceLike = None) -> AssocResult:
    """The ``assoc-scan`` CLI verb: joins the run's processes when the
    cluster flags name them, then scans on one device (the mesh's flags
    are taken and, as in the reference, unused here). ``device``
    overrides ``--device``."""
    conf = AssocConf.parse(argv)
    conf.init_distributed()
    return run_assoc_pipeline(conf, device=device)


__all__ = [
    "AssocResult",
    "case_vector",
    "chi2_from_counts",
    "load_phenotypes",
    "run",
    "run_assoc_pipeline",
]
