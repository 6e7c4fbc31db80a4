"""GRM/kinship: allele-frequency-standardized genetic relatedness, the
``grm`` verb.

The port's copy of ``spark_examples_tpu/analyses/grm.py``. The VanRaden
genetic relatedness matrix over has-variation genotypes
``X ∈ {0,1}^(M×N)`` with per-site observed frequencies ``p_v = k_v / n``:

    GRM = (X − P)ᵀ (X − P) / Σ_v p_v·q_v,       P[v, s] = p_v

is a reweighting of the Gramian, not a new reduction: expanding the
centering,

    (X − P)ᵀ(X − P) = XᵀX − (U·1ᵀ + 1·Uᵀ)/n + (Σ_v k_v²)/n² · J

where ``U = Σ_v k_v·x_v`` (an N-vector). So the O(M·N²) device work is the
PCA similarity accumulation (``ops/gramian.py``: on the card
``unpack_rows_t`` and ``gram_accumulate``), and the AF pass is O(M·N)
integer moments computed on the host from the same streamed blocks
(``utils/af.py``). The finalize is one float64 formula over exact int64
numerators:

    GRM = (n²·G − n·(U·1ᵀ + 1·Uᵀ) + S2·J) / C,
    S2 = Σ k_v²,   C = Σ k_v·(n − k_v) = n²·Σ p·q

— every term an exact integer, so the NumPy oracle, the reference and the
port compute the identical float64 matrix byte for byte. The int32 G
fetched from the card widens to int64 before ``n²·G``. ``C == 0`` (every
site monomorphic) is an error, not a NaN matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch.analyses.base import (
    analysis_partitions,
    check_analysis_conf,
    cohort_sample_names,
    finish_analysis_run,
    iter_site_blocks,
)
from spark_examples_tpu_torch.config import GrmConf
from spark_examples_tpu_torch.obs.heartbeat import Heartbeat
from spark_examples_tpu_torch.pipeline.pca_driver import VariantsPcaDriver
from spark_examples_tpu_torch.pipeline.sitewriter import SiteOutputWriter
from spark_examples_tpu_torch.utils.af import carrier_counts, variance_counts
from spark_examples_tpu_torch.utils.device import DeviceLike, synchronizer
from spark_examples_tpu_torch.utils.tracing import StageTimes


class GrmMoments:
    """The AF pass: exact int64 per-site moments accumulated block by
    block beside the device Gramian feed — ``U = Σ k·x`` (N,), ``S2 =
    Σ k²``, ``C = Σ k·(n−k)`` — O(N) host state, never O(M)."""

    def __init__(self, num_samples: int):
        self.n = int(num_samples)
        self.U = np.zeros(self.n, dtype=np.int64)
        self.S2 = 0
        self.C = 0
        self.sites = 0

    def add_block(self, rows: np.ndarray) -> None:
        X = np.asarray(rows, dtype=np.int64)
        k = carrier_counts(X)
        self.U += k @ X
        self.S2 += int((k * k).sum())
        self.C += int(variance_counts(k, self.n).sum())
        self.sites += X.shape[0]


def grm_finalize(G: np.ndarray, moments: GrmMoments) -> np.ndarray:
    """The float64 VanRaden finalize over exact int64 numerators (module
    docstring formula). ``G`` is the raw integer Gramian ``XᵀX``."""
    n = moments.n
    if moments.C == 0:
        raise ValueError(
            f"kinship undefined: all {moments.sites} streamed site(s) are "
            "monomorphic (zero variance) — nothing to standardize by"
        )
    Gi = np.asarray(G).astype(np.int64)  # private copy, mutated in place
    if Gi.shape != (n, n):
        raise ValueError(f"expected a ({n}, {n}) Gramian, got {Gi.shape}")
    # n²·G − n·(U·1ᵀ + 1·Uᵀ) + S2, built in place: the transients are two
    # N-vectors, not N×N temporaries.
    Gi *= n * n
    nU = n * moments.U
    Gi -= nU[:, None]
    Gi -= nU[None, :]
    Gi += moments.S2
    return np.true_divide(Gi, float(moments.C))


def grm_reference(rows: np.ndarray, num_samples: int) -> np.ndarray:
    """Host NumPy oracle: the same integer-moment formula over the full
    (M, N) genotype matrix at once — what the streamed result must match
    byte for byte. ``XᵀX`` runs through float64 BLAS, which is exact here
    (every partial sum is an integer below 2^53) and, unlike NumPy's int64
    product, fast at a full cohort; the int64 cast gives the reference's
    integer Gramian."""
    X = np.asarray(rows)
    moments = GrmMoments(num_samples)
    moments.add_block(X)
    Xf = X.astype(np.float64)
    return grm_finalize((Xf.T @ Xf).astype(np.int64), moments)


def format_grm_rows(names: Sequence[str], matrix: np.ndarray) -> Iterator[Tuple]:
    """The kinship TSV rows (name + float64 reprs), as the reference
    formats them."""
    for name, row in zip(names, np.asarray(matrix)):
        yield (name, *(repr(float(v)) for v in row))


@dataclass
class GrmResult:
    """One completed GRM run: the host kinship matrix (float64), the
    column-order sample names, the summary, the manifest bookkeeping and
    the driver that ran it (its accumulator, spans and registry)."""

    matrix: np.ndarray
    sample_names: List[str]
    summary: Dict
    driver: VariantsPcaDriver
    manifest: Optional[Dict] = None
    manifest_path: Optional[str] = None


def _summarize(matrix: np.ndarray, sites: int) -> Dict:
    """Host-side facts about a kinship matrix."""
    M = np.asarray(matrix)
    n = M.shape[0]
    diag = np.diagonal(M)
    off_mask = ~np.eye(n, dtype=bool)
    return {
        "shape": [int(s) for s in M.shape],
        "sites": int(sites),
        "trace": float(np.trace(M)),
        "diag_mean": float(diag.mean()),
        "off_diag_mean": float(M[off_mask].mean()) if n > 1 else 0.0,
    }


def run_grm_pipeline(conf: GrmConf, device: DeviceLike = None) -> GrmResult:
    """The GRM core, CLI-free: conf in, kinship and manifest out, in the
    reference's order. The Gramian rides a ``VariantsPcaDriver``'s packed
    arm on ``device`` (default ``conf.device``), so the GRM inherits its
    accumulator, flush telemetry and launch accounting."""
    check_analysis_conf(conf, "grm")
    driver = VariantsPcaDriver(conf, device=conf.device if device is None else device)
    n = len(driver.indexes)
    moments = GrmMoments(n)
    times = StageTimes(recorder=driver.spans)
    heartbeat = None
    if conf.heartbeat_seconds > 0:
        heartbeat = Heartbeat(conf.heartbeat_seconds, driver.registry).start()
    try:
        with times.stage("ingest+gramian", sync=synchronizer(driver.device)):

            def rows():
                for _contig, block in iter_site_blocks(
                    conf,
                    driver.source,
                    analysis_partitions(conf, driver.source),
                    driver.io_stats,
                    driver.registry,
                ):
                    hv = block["has_variation"]
                    moments.add_block(hv)
                    yield hv

            similarity = driver.get_similarity_rows(rows())
        with times.stage("grm-finalize"):
            if not isinstance(similarity, np.ndarray):
                similarity = similarity.cpu().numpy()
            matrix = grm_finalize(similarity, moments)
    finally:
        if heartbeat is not None:
            heartbeat.stop()

    names = cohort_sample_names(driver.indexes, driver.names)
    if conf.grm_out:
        with SiteOutputWriter(conf.grm_out, header=("name", *names)) as writer:
            writer.write_rows(format_grm_rows(names, matrix))
        print(f"Kinship matrix written to {conf.grm_out}.")

    summary = _summarize(matrix, moments.sites)
    print(
        f"GRM over {moments.sites} sites x {n} samples: trace "
        f"{summary['trace']:.4f}, diag mean {summary['diag_mean']:.4f}."
    )
    driver.report_io_stats()
    if conf.profile_dir:
        print(str(times))
    manifest, manifest_path, _ = finish_analysis_run(
        conf,
        "grm",
        driver.spans,
        driver.registry,
        driver.io_stats,
        sites_tested=moments.sites,
        sites_kept=None,
    )
    return GrmResult(matrix, names, summary, driver, manifest, manifest_path)


def run(argv: Sequence[str], device: DeviceLike = None) -> GrmResult:
    """The ``grm`` CLI verb. ``device`` overrides ``--device``."""
    return run_grm_pipeline(GrmConf.parse(argv), device=device)


__all__ = [
    "GrmMoments",
    "GrmResult",
    "format_grm_rows",
    "grm_finalize",
    "grm_reference",
    "run",
    "run_grm_pipeline",
]
