"""Shared plumbing of the population-genetics analyses (``analyses/``).

The port's copy of ``spark_examples_tpu/analyses/base.py``. The analyses
stream the same contig-ordered has-variation blocks the PCA Gramian
accumulates (one ``genotype_blocks`` contract across the synthetic and
file sources), under the same partitioner, telemetry registry, spans and
manifest epilogue:

- :func:`analysis_conf_violations` / :func:`check_analysis_conf` — the
  shared preconditions, with the reference's codes and messages: one
  variant set, a synthetic or file source, no PCA-only flags;
- :func:`iter_site_blocks` — the contig-ordered block stream with the
  standard ingest accounting;
- :class:`AnalysisContext` — the LD prune's and association scan's
  subset of the driver: source, cohort, telemetry, the run's device and
  its mesh (:meth:`AnalysisContext.make_mesh`);
- :func:`finish_analysis_run` — the manifest epilogue with the
  ``analysis`` block and the ``analysis.pre-manifest`` kill point.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from spark_examples_tpu_torch.obs import MetricsRegistry, SpanRecorder
from spark_examples_tpu_torch.obs.manifest import build_run_manifest, write_manifest
from spark_examples_tpu_torch.obs.metrics import (
    ANALYSIS_SITES_KEPT,
    ANALYSIS_SITES_TESTED,
    INGEST_PARTITIONS_DONE,
    INGEST_PARTITIONS_PLANNED,
    INGEST_SITES_SCANNED,
    well_known_gauge,
)
from spark_examples_tpu_torch.pipeline.pca_driver import make_source
from spark_examples_tpu_torch.parallel.mesh import resolve_run_mesh, run_devices
from spark_examples_tpu_torch.pipeline.stats import VariantsDatasetStats
from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner
from spark_examples_tpu_torch.sources import partition_page_requests
from spark_examples_tpu_torch.utils import faults
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device

#: The analysis kinds of the reference.
ANALYSIS_KINDS = ("grm", "ld", "assoc")


def analysis_conf_violations(conf, kind: str) -> List[Tuple[str, str]]:
    """Every shared-precondition violation of ``conf`` for analysis
    ``kind``, as ``(code, message)`` pairs — the reference's catalogue,
    code for code."""
    if kind not in ANALYSIS_KINDS:
        raise ValueError(f"unknown analysis kind {kind!r}")
    violations: List[Tuple[str, str]] = []
    if len(conf.variant_set_id) != 1:
        violations.append((
            "analysis-variant-sets",
            f"the {kind} analysis takes exactly one variant set "
            f"(got {len(conf.variant_set_id)}); joins/merges are a PCA "
            "pipeline capability",
        ))
    if conf.source == "rest":
        violations.append((
            "analysis-source",
            f"the {kind} analysis streams packed genotype blocks; the "
            "paginated REST source has no packed path (--source synthetic "
            "or file)",
        ))
    if conf.input_path:
        violations.append((
            "analysis-input-path",
            "--input-path checkpoint resume loads wire records; the "
            f"{kind} analysis streams packed blocks (run from the "
            "original source)",
        ))
    if conf.save_variants:
        violations.append((
            "analysis-save-variants",
            "--save-variants materializes wire records; the packed "
            f"{kind} analysis never builds them",
        ))
    if conf.gramian_checkpoint_dir or conf.resume_from:
        violations.append((
            "analysis-checkpoint",
            "--gramian-checkpoint-dir/--resume-from checkpoint the PCA "
            f"similarity accumulator; the {kind} analysis is not "
            "checkpointable yet",
        ))
    if conf.ingest not in ("auto", "packed"):
        violations.append((
            "analysis-ingest",
            f"the {kind} analysis has one ingest path (packed blocks); "
            f"--ingest {conf.ingest} does not apply",
        ))
    if conf.stream_chunk_bytes is not None and conf.stream_chunk_bytes > 0:
        violations.append((
            "analysis-streaming",
            f"explicit --stream-chunk-bytes streaming is not wired into "
            f"the {kind} analysis yet; it uses the windowed packed parse "
            "(drop the flag, or 0 to silence the auto decision)",
        ))
    return violations


def check_analysis_conf(conf, kind: str) -> None:
    """Raise ``ValueError`` with the first violation's message."""
    violations = analysis_conf_violations(conf, kind)
    if violations:
        raise ValueError(violations[0][1])


def analysis_partitions(conf, source):
    """The run's shard windows: the contig resolution and partitioner of
    the PCA driver, for the analyses' single variant set."""
    contigs = conf.get_contigs(source, conf.variant_set_id)
    partitioner = VariantsPartitioner(contigs, conf.bases_per_partition)
    return partitioner.get_partitions(conf.variant_set_id[0])


def iter_site_blocks(
    conf, source, partitions, io_stats, registry
) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
    """Contig-ordered block stream for one variant set with the standard
    ingest accounting: yields ``(contig_name, block)`` where ``block`` is
    the sources' ``genotype_blocks`` dict (``positions``,
    ``has_variation``, ``af``), one block at a time. Parallel to
    ``pipeline/pca_driver.py:_packed_similarity``'s block stream; unlike
    it, this one also advances the sites-scanned gauge, as the reference's
    does."""
    well_known_gauge(registry, INGEST_PARTITIONS_PLANNED).set(len(partitions))
    done_gauge = well_known_gauge(registry, INGEST_PARTITIONS_DONE)
    sites_gauge = well_known_gauge(registry, INGEST_SITES_SCANNED)
    sites_scanned = 0
    for index, part in enumerate(partitions):
        if io_stats is not None:
            io_stats.add_partition(part.range)
            io_stats.add_requests(
                partition_page_requests(
                    source, part.variant_set_id, part.contig, conf.bases_per_partition
                )
            )
        window_variants = 0
        for block in source.genotype_blocks(
            part.variant_set_id,
            part.contig,
            block_size=conf.block_size,
            min_allele_frequency=conf.min_allele_frequency,
        ):
            window_variants += len(block["positions"])
            sites_scanned += len(block["positions"])
            sites_gauge.set(sites_scanned)
            yield part.contig.reference_name, block
        if io_stats is not None:
            io_stats.add_variants(window_variants)
        done_gauge.set(index + 1)


def cohort_sample_names(indexes: Dict[str, int], names: Dict[str, str]) -> List[str]:
    """Callset names in cohort column order, from a driver's ``{id:
    index}`` / ``{id: name}`` pair."""
    reverse = {i: cs_id for cs_id, i in indexes.items()}
    return [names[reverse[i]] for i in range(len(indexes))]


class AnalysisContext:
    """Source + callsets + telemetry + device for the per-site analyses.

    The reference's ``AnalysisContext``: a subset of ``VariantsPcaDriver``,
    since LD and assoc have no N×N accumulator. They need the shared
    plumbing (cohort discovery, partitioning, registry, spans and stats)
    but none of the similarity machinery. The run's ``torch.device``
    (``device``, default ``conf.device``; a CUDA request without a card
    raises) holds the work off the mesh; :meth:`make_mesh` resolves the
    mesh over ``devices`` (default: the device's cards, or CPU positions).
    """

    def __init__(self, conf, kind: str, device: DeviceLike = None, devices=None):
        check_analysis_conf(conf, kind)
        self.conf = conf
        self.kind = kind
        self.device = resolve_device(conf.device if device is None else device)
        self.devices = devices
        self.source = make_source(conf)
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder()
        self.io_stats = VariantsDatasetStats(self.registry)
        callsets = self.source.search_callsets(conf.variant_set_id)
        self.indexes: Dict[str, int] = {cs["id"]: i for i, cs in enumerate(callsets)}
        self.names: Dict[str, str] = {cs["id"]: cs["name"] for cs in callsets}
        self.num_samples = len(self.indexes)
        if self.num_samples < 1:
            raise ValueError(
                f"the {kind} analysis found an empty cohort for variant "
                f"set {conf.variant_set_id[0]!r}"
            )
        print(f"Cohort size: {self.num_samples}.")

    def sample_names(self) -> List[str]:
        """Callset names in column order (cohort order, not the PCA emit's
        name-sorted order)."""
        return cohort_sample_names(self.indexes, self.names)

    def partitions(self):
        return analysis_partitions(self.conf, self.source)

    def blocks(self) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
        return iter_site_blocks(
            self.conf, self.source, self.partitions(), self.io_stats, self.registry
        )

    def make_mesh(self):
        """The run's mesh, by the PCA driver's rule
        (``parallel/mesh.py:resolve_run_mesh``): ``--mesh-shape``, else
        every place capped by ``--num-reduce-partitions``; ``None`` on one
        place."""
        devices = self.devices if self.devices is not None else run_devices(self.device)
        return resolve_run_mesh(self.conf.mesh_shape, self.conf.num_reduce_partitions, devices)


def finish_analysis_run(
    conf,
    kind: str,
    spans,
    registry,
    io_stats,
    sites_tested: int,
    sites_kept: Optional[int],
) -> Tuple[Optional[Dict], Optional[str], Dict]:
    """The analyses' run epilogue: the ``analysis.pre-manifest`` kill
    point (every per-site output is published by now), the sites gauges,
    and the schema-v2 manifest with the ``analysis`` block, written
    atomically when ``--metrics-json`` asked. Returns ``(manifest_doc,
    manifest_path, analysis_block)``."""
    faults.kill_point("analysis.pre-manifest")
    well_known_gauge(registry, ANALYSIS_SITES_TESTED).set(int(sites_tested))
    well_known_gauge(registry, ANALYSIS_SITES_KEPT).set(
        int(sites_kept if sites_kept is not None else sites_tested)
    )
    analysis_block = {
        "kind": kind,
        "sites_kept": int(sites_kept) if sites_kept is not None else None,
        "sites_tested": int(sites_tested),
    }
    manifest_doc: Optional[Dict] = None
    manifest_path: Optional[str] = None
    if conf.metrics_json:
        manifest_doc = build_run_manifest(
            conf=conf,
            spans=spans,
            registry=registry,
            io_stats=io_stats,
            analysis=analysis_block,
        )
        try:
            write_manifest(conf.metrics_json, manifest_doc)
        except OSError as e:
            # A bad telemetry path must not destroy completed compute.
            print(f"Run manifest NOT written to {conf.metrics_json}: {e}", file=sys.stderr)
        else:
            manifest_path = conf.metrics_json
            print(f"Run manifest written to {conf.metrics_json}.")
    return manifest_doc, manifest_path, analysis_block


__all__ = [
    "ANALYSIS_KINDS",
    "AnalysisContext",
    "analysis_conf_violations",
    "analysis_partitions",
    "check_analysis_conf",
    "cohort_sample_names",
    "finish_analysis_run",
    "iter_site_blocks",
]
