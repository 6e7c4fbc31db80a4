"""The flagship PCoA pipeline on one CUDA card: ``variants-pca``.

The port of ``spark_examples_tpu/pipeline/pca_driver.py``'s main path
(``VariantsPca.scala:45-336``): synthetic source → device-generation ingest
fused with ``G += XᵀX`` (``ops/devicegen.py``, two hand-written CUDA
kernels) → float64 Gower centering (``ops/centering.py``) → subspace
eigensolve (``ops/pca.py``) → the TSV rows and the "Variants API stats"
epilogue. Every printed line but the PC values is identical to the JAX
package's on the same argv.

Two PCA backends, as in the reference: ``gpu`` (the device pipeline) and
``host`` (the NumPy replication of the reference algorithm, the oracle).
Both ingest through device generation, the one ingest path ported so far.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.config import PcaConf, check_ported
from spark_examples_tpu_torch.obs import MetricsRegistry, SpanRecorder
from spark_examples_tpu_torch.obs.metrics import (
    DEVICEGEN_DISPATCHES,
    DEVICEGEN_SITES_CAPACITY,
    INGEST_PARTITIONS_PLANNED,
    INGEST_SITES_SCANNED,
    well_known_gauge,
)
from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.ops.devicegen import (
    DeviceGenGramianAccumulator,
    auto_blocks_per_dispatch,
)
from spark_examples_tpu_torch.ops.pca import (
    mllib_reference_pca,
    principal_components_subspace,
)
from spark_examples_tpu_torch.pipeline.stats import VariantsDatasetStats
from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.af import af_filter_micro
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device


def make_source(conf: PcaConf) -> SyntheticGenomicsSource:
    sizes = conf.num_samples_per_set
    return SyntheticGenomicsSource(
        num_samples=conf.num_samples,
        seed=conf.seed,
        cohort_sizes=dict(zip(conf.variant_set_id, sizes)) if sizes else None,
    )


class VariantsPcaDriver:
    """Reusable driver (``VariantsPca.scala:89-336``) on one device."""

    def __init__(
        self,
        conf: PcaConf,
        source: Optional[SyntheticGenomicsSource] = None,
        device: DeviceLike = None,
    ):
        self.conf = conf
        self.device = resolve_device(device)
        self.source = source if source is not None else make_source(conf)
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder()
        self.io_stats = VariantsDatasetStats(self.registry)
        # Driver-side callset fetch → (indexes, names) (``VariantsPca.scala:97-109``).
        callsets = self.source.search_callsets(conf.variant_set_id)
        self.indexes: Dict[str, int] = {cs["id"]: i for i, cs in enumerate(callsets)}
        self.names: Dict[str, str] = {cs["id"]: cs["name"] for cs in callsets}
        print(f"Matrix size: {len(self.indexes)}.")

    def get_similarity_device_gen(self, contigs) -> torch.Tensor:
        """Fused on-device ingest and similarity: per dispatch group the host
        sends two scalars, the device generates genotypes and accumulates
        the int32 ``G += XᵀX``. Multi-set cohorts (shared site grid) are
        per-set column blocks of one matrix, so the reference's join and
        merge (``VariantsPca.scala:155-188``) need no join machinery here."""
        source, conf = self.source, self.conf
        sets = conf.variant_set_id
        blocks_per_dispatch = (
            conf.blocks_per_dispatch
            if conf.blocks_per_dispatch is not None
            else auto_blocks_per_dispatch(len(self.indexes), conf.block_size)
        )
        sizes = [source.num_samples_for(v) for v in sets]
        asymmetric = any(s != source.num_samples for s in sizes)
        acc = DeviceGenGramianAccumulator(
            num_samples=source.num_samples,
            vs_keys=[source.genotype_stream_key(v) for v in sets],
            pops=source.populations,
            site_key=source.site_key,
            spacing=source.variant_spacing,
            ref_block_fraction=source.ref_block_fraction,
            min_af_micro=af_filter_micro(conf.min_allele_frequency),
            block_size=conf.block_size,
            blocks_per_dispatch=blocks_per_dispatch,
            n_pops=source.n_pops,
            set_sizes=sizes if asymmetric else None,
            pops_per_set=[source.populations_for(v) for v in sets] if asymmetric else None,
            device=self.device,
        )
        partitioner = VariantsPartitioner(contigs, conf.bases_per_partition)
        partitions = [p for v in sets for p in partitioner.get_partitions(v)]
        well_known_gauge(self.registry, INGEST_PARTITIONS_PLANNED).set(len(partitions))
        sites_gauge = well_known_gauge(self.registry, INGEST_SITES_SCANNED)
        scanned = 0
        for contig in contigs:
            k0, k1 = source.site_grid_range(contig)
            if k1 > k0:
                acc.add_grid(k0, k1)
            scanned += k1 - k0
            sites_gauge.set(scanned)
        # Wire-equivalent accounting: per shard, per variant set
        # (``SyntheticGenomicsSource.page_requests``).
        for partition in partitions:
            self.io_stats.add_partition(partition.range)
            self.io_stats.add_requests(
                source.page_requests(partition.contig, conf.bases_per_partition)
            )
        well_known_gauge(self.registry, DEVICEGEN_DISPATCHES).set(acc.dispatches)
        well_known_gauge(self.registry, DEVICEGEN_SITES_CAPACITY).set(acc.sites_capacity)
        self.accumulator = acc
        # The synchronous counter fetch ends the ingest stage with its work.
        per_set, _kept = acc.ingest_counters()
        self.io_stats.add_variants(int(per_set.sum()))
        return acc.finalize_device()

    def compute_pca(self, similarity: torch.Tensor) -> List[Tuple[str, List[float]]]:
        """Center and eigendecompose (``VariantsPca.scala:238-271``)."""
        n = len(self.indexes)
        if self.conf.pca_backend == "host":
            S = similarity.cpu().numpy().astype(np.float64)
            nonzero = int((S.sum(axis=1) > 0).sum())
            print(f"Non zero rows in matrix: {nonzero} / {n}.")
            components, _ = mllib_reference_pca(self._host_center(S), self.conf.num_pc)
        else:
            with self.spans.span("center"):
                centered = gower_center(similarity)
            with self.spans.span("eigh"):
                device_components, _ = principal_components_subspace(
                    centered, self.conf.num_pc
                )
            # any() rather than sum() > 0: int32 row sums overflow at
            # whole-genome scale.
            nonzero = int((similarity != 0).any(dim=1).sum())
            print(f"Non zero rows in matrix: {nonzero} / {n}.")
            components = device_components.cpu().numpy().astype(np.float64)
        reverse = {i: cs_id for cs_id, i in self.indexes.items()}
        return [(reverse[i], [float(c) for c in components[i]]) for i in range(n)]

    @staticmethod
    def _host_center(similarity: np.ndarray) -> np.ndarray:
        """Literal replication of the centering at ``VariantsPca.scala:246-263``."""
        n = similarity.shape[0]
        row_sums = similarity.sum(axis=1)
        matrix_mean = row_sums.sum() / n / n
        row_mean = row_sums / n
        return similarity - row_mean[:, None] - row_mean[None, :] + matrix_mean

    def emit_result(self, result: Sequence[Tuple[str, List[float]]]) -> List[str]:
        """Print and optionally save the TSV (``VariantsPca.scala:273-286``):
        ``name<TAB>dataset<TAB>pc...`` sorted by name on the console; the
        saved file keeps the reference's column order ``name, pcs...,
        dataset`` under ``<output-path>-pca.tsv/part-00000``."""
        rows = []
        for callset_id, pcs in result:
            rows.append((self.names[callset_id], callset_id.split("-")[0], pcs))
        rows.sort(key=lambda r: r[0])
        lines = []
        for name, dataset, pcs in rows:
            pc_text = "\t".join(str(c) for c in pcs)
            lines.append(f"{name}\t{dataset}\t{pc_text}")
            print(lines[-1])
        if self.conf.output_path:
            out_dir = self.conf.output_path + "-pca.tsv"
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "part-00000"), "w") as f:
                for name, dataset, pcs in rows:
                    pc_text = "\t".join(str(c) for c in pcs)
                    f.write(f"{name}\t{pc_text}\t{dataset}\n")
        return lines

    def report_io_stats(self) -> None:
        print(str(self.io_stats))


def _sync(device: torch.device):
    """The closing fetch of a stage span: a stage's wall-clock ends with its
    work on the card."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None


@dataclass
class PipelineResult:
    """One completed analysis: the emitted TSV lines, and the driver that
    ran it (its accumulator, spans and registry)."""

    lines: List[str]
    driver: VariantsPcaDriver


def run_pipeline(conf: PcaConf, device: DeviceLike = None) -> PipelineResult:
    """The analysis, CLI-free: config in, result out. Runs on ``device``
    (default ``conf.device``); raises when a CUDA device is asked for and
    none is present."""
    check_ported(conf)
    driver = VariantsPcaDriver(conf, device=conf.device if device is None else device)
    sync = _sync(driver.device)
    with driver.spans.span("ingest+similarity", sync=sync):
        contigs = conf.get_contigs(driver.source, conf.variant_set_id)
        similarity = driver.get_similarity_device_gen(contigs)
    with driver.spans.span("center+pca", sync=sync):
        result = driver.compute_pca(similarity)
    lines = driver.emit_result(result)
    driver.report_io_stats()
    return PipelineResult(lines, driver)


def run(argv: Sequence[str], device: DeviceLike = None) -> List[str]:
    """``VariantsPcaDriver.main`` (``VariantsPca.scala:47-59``): parse the
    flags and run. ``device`` overrides ``--device``."""
    return run_pipeline(PcaConf.parse(argv), device=device).lines


__all__ = ["PipelineResult", "VariantsPcaDriver", "make_source", "run", "run_pipeline"]
