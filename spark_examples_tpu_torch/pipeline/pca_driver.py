"""The flagship PCoA pipeline on one CUDA card: ``variants-pca``.

The port of ``spark_examples_tpu/pipeline/pca_driver.py``
(``VariantsPca.scala:45-336``): synthetic or file source → ingest and
``G += XᵀX`` → float64 Gower centering (``ops/centering.py``) → subspace
eigensolve (``ops/pca.py``) → the TSV rows and the "Variants API stats"
epilogue. Every printed line but the PC values is identical to the JAX
package's on the same argv.

Three ingest arms, resolved from ``--ingest`` exactly as the reference
resolves them (:func:`resolve_ingest`):

- **device** (``auto`` for distinct synthetic variant sets): the card
  generates the genotypes and accumulates G (``ops/devicegen.py``, two
  CUDA kernels);
- **packed**: the host builds dense genotype blocks — the synthetic
  source's, or a VCF's decoded by the chunk-parallel native parser, in one
  bounded-memory streamed pass when the file wants streaming — and
  ``ops/gramian.py:GramianAccumulator`` ships them bit-packed to the card,
  unpacks them there and accumulates G (``unpack_rows_t`` +
  ``gram_accumulate``);
- **wire**: the host pages variant records through the source's client
  (``pipeline/datasets.py``) or a ``--input-path`` checkpoint, joins
  multiple sets (``iter_calls``; ``--save-variants`` writes the records as
  they stream) and feeds per-variant column-index rows to the same
  accumulator — the arm of ``auto`` with duplicate variant-set ids, of
  small file inputs, and of the host backend.

The REST source (``--source rest``, ``sources/rest.py``) feeds the wire
arm.

The run's telemetry is the reference's: ``--heartbeat-seconds`` (stderr
progress lines), ``--profile-dir`` (stage timings and a ``torch.profiler``
trace) and ``--metrics-json`` (the schema-v2 manifest, built last).

Robustness is the reference's too: ``--gramian-checkpoint-dir`` puts a
``pipeline/checkpoint.py:GramianFeeder`` between the host-fed arms and
their accumulator (periodic atomic snapshots), ``--resume-from`` restores
the newest snapshot and fast-forwards the stream past it, and a fault plan
(``--fault-plan`` or ``SPARK_EXAMPLES_TPU_FAULTS``, ``utils/faults.py``)
fires at the registered kill points and IO boundaries.

Two PCA backends, as in the reference: ``gpu`` (the device pipeline) and
``host`` (the NumPy replication of the reference algorithm, the oracle,
which ingests through the wire arm).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes, runtime_baseline_bytes
from spark_examples_tpu_torch.config import PcaConf, check_ported
from spark_examples_tpu_torch.models.variant import Variant
from spark_examples_tpu_torch.obs import MetricsRegistry, SpanRecorder
from spark_examples_tpu_torch.obs.heartbeat import Heartbeat
from spark_examples_tpu_torch.obs.manifest import build_run_manifest, write_manifest
from spark_examples_tpu_torch.obs.metrics import (
    DEVICEGEN_DISPATCHES,
    DEVICEGEN_SITES_CAPACITY,
    HOST_BASELINE_RSS_BYTES,
    HOST_PEAK_RSS_BYTES,
    HOST_STATIC_BOUND_BYTES,
    INGEST_PARTITIONS_DONE,
    INGEST_PARTITIONS_PLANNED,
    INGEST_SITES_SCANNED,
    VCF_NATIVE_PARSE,
    read_host_peak_rss_bytes,
    record_prover_conformance,
    well_known_gauge,
)
from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.ops.devicegen import (
    DeviceGenGramianAccumulator,
    auto_blocks_per_dispatch,
)
from spark_examples_tpu_torch.ops.gramian import GramianAccumulator, accumulate_index_rows
from spark_examples_tpu_torch.ops.pca import (
    mllib_reference_pca,
    principal_components_subspace,
)
from spark_examples_tpu_torch.pipeline.checkpoint import (
    CheckpointWriter,
    GramianFeeder,
    gramian_checkpoint_fingerprint,
    load_gramian_checkpoint,
    load_variants,
)
from spark_examples_tpu_torch.pipeline.datasets import (
    PrefetchIterator,
    VariantsDataset,
    _parallel_shards,
)
from spark_examples_tpu_torch.pipeline.stats import VariantsDatasetStats
from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner
from spark_examples_tpu_torch.sources import partition_page_requests
from spark_examples_tpu_torch.sources.base import GenomicsSource, get_access_token
from spark_examples_tpu_torch.sources.files import (
    FileGenomicsSource,
    StreamCounters,
    _resolve_ingest_workers,
    af_float,
    file_set_ids,
)
from spark_examples_tpu_torch.sources.rest import RestGenomicsSource
from spark_examples_tpu_torch.sources.stream import MergeJoinStats, merge_join
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils import faults
from spark_examples_tpu_torch.utils.af import af_filter_micro, af_passes
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device, synchronizer
from spark_examples_tpu_torch.utils.tracing import StageTimes, device_trace

#: A similarity matrix: on the device (gpu backend) or a host array (host).
Similarity = Union[torch.Tensor, np.ndarray]


@dataclass(frozen=True)
class CallData:
    """``(hasVariation, callsetIndex)`` (``VariantsPca.scala:338``)."""

    has_variation: bool
    callset_id: int


def extract_call_info(variant: Variant, mapping: Dict[str, int]) -> List[CallData]:
    """``VariantsPcaDriver.extractCallInfo`` (``VariantsPca.scala:65-69``)."""
    if variant.calls is None:
        return []
    return [
        CallData(call.has_variation(), mapping[call.callset_id])
        for call in variant.calls
    ]


def make_source(conf: PcaConf) -> GenomicsSource:
    """The source ``--source`` names: the synthetic cohort, the files of
    ``--input-files``, or the REST backend with the token of
    ``--client-secrets``."""
    if conf.source == "rest":
        return RestGenomicsSource(auth=get_access_token(conf.client_secrets))
    if conf.source == "file":
        return FileGenomicsSource(
            conf.input_files or [],
            stream_chunk_bytes=conf.stream_chunk_bytes,
            ingest_workers=conf.ingest_workers,
        )
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
        source: Optional[GenomicsSource] = None,
        device: DeviceLike = None,
    ):
        self.conf = conf
        self.device = resolve_device(device)
        self.source = source if source is not None else make_source(conf)
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder()
        #: The packed arm's prefetch overlap accounting (the manifest's
        #: ``overlap`` block); ``None`` on the other arms.
        self.overlap: Optional[Dict] = None
        # Stats are disabled when resuming from materialized input
        # (``VariantsPca.scala:332-335``).
        self.io_stats: Optional[VariantsDatasetStats] = (
            None if conf.input_path else VariantsDatasetStats(self.registry)
        )
        #: The accumulator of the last similarity stage (device or host-fed).
        self.accumulator = None
        #: The checkpoint feeder between the host-fed rows and the
        #: accumulator (``_wrap_accumulator``); ``None`` without the flags.
        self.feeder: Optional[GramianFeeder] = None
        # The resume artifact loads here, before any ingest, so a
        # fingerprint mismatch or a corrupt artifact fails in milliseconds
        # instead of after a re-ingest pass.
        self._gramian_resume: Optional[Dict] = None
        self._ckpt_fingerprint = ""
        if conf.gramian_checkpoint_dir or conf.resume_from:
            self._ckpt_fingerprint = gramian_checkpoint_fingerprint(conf)
            if conf.resume_from:
                self._gramian_resume = load_gramian_checkpoint(
                    conf.resume_from, self._ckpt_fingerprint
                )
                if self._gramian_resume is not None:
                    print(
                        f"Resuming from Gramian checkpoint at {conf.resume_from}: "
                        f"{self._gramian_resume['meta']['sites']} sites already "
                        "accumulated."
                    )
        # Driver-side callset fetch → (indexes, names) (``VariantsPca.scala:97-109``).
        callsets = self.source.search_callsets(conf.variant_set_id)
        self.indexes: Dict[str, int] = {cs["id"]: i for i, cs in enumerate(callsets)}
        self.names: Dict[str, str] = {cs["id"]: cs["name"] for cs in callsets}
        print(f"Matrix size: {len(self.indexes)}.")
        # After callset discovery: the bound needs the real cohort width
        # (file sources carry theirs in the data, not the flag).
        self._register_host_memory_gauges()

    def _register_host_memory_gauges(self) -> None:
        """The host-memory pair the heartbeat and the manifest show: the
        peak-RSS gauge (every read samples the OS's mark) and the static
        bound of this configuration, ``check/hostmem.py:
        conf_host_peak_bytes`` on the port's one device and one process,
        as the reference's ``_register_host_memory_gauges`` resolves it,
        over this device's runtime baseline (``runtime_baseline_bytes``:
        measured here on the card, before any data is staged). Telemetry
        never takes down a run: if the resolver raises, the runtime
        baseline is registered."""
        if read_host_peak_rss_bytes() is not None:
            well_known_gauge(self.registry, HOST_PEAK_RSS_BYTES).set_function(
                lambda: float(read_host_peak_rss_bytes() or 0)
            )
        baseline = runtime_baseline_bytes(self.device)
        try:
            bound = conf_host_peak_bytes(
                self.conf,
                device_count=1,
                num_samples=len(self.indexes) or None,
                num_hosts=1,
                baseline_bytes=baseline,
            )
        except Exception:
            bound = baseline
        well_known_gauge(self.registry, HOST_BASELINE_RSS_BYTES).set(float(baseline))
        well_known_gauge(self.registry, HOST_STATIC_BOUND_BYTES).set(float(bound))

    # ------------------------------------------------------------------ data

    def get_data(self) -> List[VariantsDataset]:
        """One sharded dataset per variant set (``VariantsPca.scala:111-125``);
        all datasets share one partitioner built from the flattened contig
        list, or a checkpoint reader under ``--input-path``."""
        if self.conf.input_path:
            return [load_variants(self.conf.input_path)]
        contigs = self.conf.get_contigs(self.source, self.conf.variant_set_id)
        partitioner = VariantsPartitioner(contigs, self.conf.bases_per_partition)
        return [
            VariantsDataset(
                self.source,
                variant_set_id,
                partitioner,
                stats=self.io_stats,
                num_workers=self.conf.num_workers,
            )
            for variant_set_id in self.conf.variant_set_id
        ]

    def filter_variant(self, variant: Variant) -> bool:
        """``--min-allele-frequency`` on the AF info field
        (``VariantsPca.scala:136-148``): strictly greater, first AF value,
        variants without AF dropped. The synthetic source compares with the
        canonical micro-unit rule (``utils/af.py``), so the wire arm agrees
        bit for bit with the packed and device arms; the file source with
        the packed parsers' AF grammar (``sources/files.py:af_float``), so
        its wire and packed arms agree record for record."""
        if self.conf.min_allele_frequency is None:
            return True
        af = variant.info.get("AF")
        if not af:
            return False
        if isinstance(self.source, SyntheticGenomicsSource):
            return bool(af_passes(float(af[0]), self.conf.min_allele_frequency))
        if isinstance(self.source, FileGenomicsSource):
            return af_float(af[0]) > self.conf.min_allele_frequency
        return float(af[0]) > self.conf.min_allele_frequency

    def iter_calls(self, datasets: List[VariantsDataset]) -> Iterator[List[int]]:
        """Variant → varying callset column indices
        (``VariantsPca.scala:193-208``): single-dataset map, two-dataset key
        join, ≥3 merge-intersect; keep varying calls, drop empty rows."""
        n_sets = len(self.conf.variant_set_id)
        if self.conf.min_allele_frequency is not None:
            print(f"Min allele frequency {self.conf.min_allele_frequency}.")

        if n_sets == 1:
            if self.conf.save_variants:
                yield from self._iter_calls_saving(datasets[0], self.conf.save_variants)
                return
            for variant in datasets[0].variants():
                if not self.filter_variant(variant):
                    continue
                calls = extract_call_info(variant, self.indexes)
                row = [c.callset_id for c in calls if c.has_variation]
                if row:
                    yield row
            return

        # Multi-dataset: all datasets share the same partitions, so records
        # with equal variant keys co-locate per window; join there with the
        # streaming k-way merge over per-set key-sorted streams, windows
        # built ahead in the bounded pool (``_parallel_shards``).
        partitions = datasets[0].partitions()
        partition_lists = [dataset.partitions() for dataset in datasets]
        debug = self.conf.debug_datasets

        def window_records(index: int) -> List[List[Tuple[str, List[CallData]]]]:
            per_set: List[List[Tuple[str, List[CallData]]]] = []
            for dataset, parts in zip(datasets, partition_lists):
                keyed: List[Tuple[str, List[CallData]]] = []
                for variant in (v for _, v in dataset.compute(parts[index])):
                    if not self.filter_variant(variant):
                        continue
                    keyed.append(
                        (variant.variant_key(debug), extract_call_info(variant, self.indexes))
                    )
                # Per window, sort by key so merge_join's sortedness
                # contract holds per stream.
                keyed.sort(key=lambda kr: kr[0])
                per_set.append(keyed)
            return per_set

        stats = MergeJoinStats()
        for _, per_set in _parallel_shards(
            list(range(len(partitions))), window_records, self.conf.num_workers
        ):
            for _key, groups in merge_join([iter(keyed) for keyed in per_set], stats=stats):
                if n_sets == 2:
                    # joinDatasets (``VariantsPca.scala:155-168``): inner
                    # join, concatenate both call lists.
                    calls_a, calls_b = groups
                    for ca in calls_a:
                        for cb in calls_b:
                            row = [c.callset_id for c in ca + cb if c.has_variation]
                            if row:
                                yield row
                else:
                    # mergeDatasets (``VariantsPca.scala:176-188``): keep keys
                    # whose total record count equals the dataset count.
                    if sum(len(g) for g in groups) != n_sets:
                        continue
                    merged: List[CallData] = []
                    for records in groups:
                        for calls in records:
                            merged.extend(calls)
                    row = [c.callset_id for c in merged if c.has_variation]
                    if row:
                        yield row

    def _iter_calls_saving(self, dataset: VariantsDataset, path: str) -> Iterator[List[int]]:
        """Single-set wire ingest that also writes every shard as a
        checkpoint part while it streams (``--save-variants``). Records are
        written unfiltered, before the AF filter, so a resumed run
        re-applies any threshold. The checkpoint's manifest is written only
        after the last shard, so an interrupted save fails loudly on
        resume."""
        writer = CheckpointWriter(path)
        for _part, records in dataset.iter_shards():
            writer.write_shard(records)
            for _key, variant in records:
                if not self.filter_variant(variant):
                    continue
                calls = extract_call_info(variant, self.indexes)
                row = [c.callset_id for c in calls if c.has_variation]
                if row:
                    yield row
        writer.close()
        print(f"Saved {writer.total} variants to {path}.")

    # ------------------------------------------------------------ similarity

    def _dense_accumulator(self, pipeline_depth: Optional[int] = None) -> GramianAccumulator:
        acc = GramianAccumulator(
            len(self.indexes),
            device=self.device,
            block_size=self.conf.block_size,
            pipeline_depth=pipeline_depth,
            registry=self.registry,
            spans=self.spans,
        )
        self.accumulator = acc
        return acc

    def _wrap_accumulator(self, acc):
        """Interpose the checkpoint feeder between the ingest stream and a
        fresh accumulator when checkpointing or resume is configured; the
        accumulator itself otherwise. The feeder restores the persisted
        partial into ``acc`` and fast-forwards the first
        ``checkpoint_sites`` rows it is fed. (A resume flag with no complete
        artifact yet still gets a feeder: it starts from zero and the
        manifest says so.)"""
        conf = self.conf
        if conf.gramian_checkpoint_dir is None and conf.resume_from is None:
            return acc
        self.feeder = GramianFeeder(
            acc,
            directory=conf.gramian_checkpoint_dir,
            every_sites=conf.checkpoint_every_sites,
            fingerprint=self._ckpt_fingerprint,
            resume=self._gramian_resume,
            registry=self.registry,
        )
        return self.feeder

    def _finish_checkpointing(self) -> None:
        """End of ingest: the final snapshot (a crash between here and the
        finalize resumes at O(1) re-ingest), then the ``driver.pre-finalize``
        kill point — a no-op unless a fault plan names it."""
        if self.feeder is not None:
            self.feeder.finish()
        faults.kill_point("driver.pre-finalize")

    def get_similarity_matrix(self, calls: Iterable[List[int]]) -> Similarity:
        """Similarity counts G = XᵀX from per-variant index rows
        (``VariantsPca.scala:210-231``, dense strategy): on the device, or
        the host replication under ``--pca-backend host``."""
        if self.conf.pca_backend == "host":
            return self._host_similarity(calls)
        acc = self._dense_accumulator()
        # Duplicate callset indices only arise when a variant set is joined
        # with itself; only then do rows carry counts (the reference's
        # pair-loop multiplicity, ``VariantsPca.scala:224-229``).
        ids = self.conf.variant_set_id
        accumulate_index_rows(
            self._wrap_accumulator(acc), calls, len(self.indexes), self.conf.block_size,
            accumulate_duplicates=len(set(ids)) != len(ids),
        )
        self._finish_checkpointing()
        return acc.finalize_device()

    def get_similarity_rows(
        self, blocks: Iterable[np.ndarray], pipeline_depth: Optional[int] = None
    ) -> Similarity:
        """Packed arm: feed dense uint8 row blocks. ``pipeline_depth`` keeps
        that many flushes in flight (``ops/gramian.py``)."""
        n = len(self.indexes)
        if self.conf.pca_backend == "host":
            matrix = np.zeros((n, n), dtype=np.int64)
            for block in blocks:
                X = np.asarray(block, dtype=np.int64)
                matrix += X.T @ X
            return matrix.astype(np.float64)
        acc = self._dense_accumulator(pipeline_depth)
        feed = self._wrap_accumulator(acc)
        for block in blocks:
            feed.add_rows(block)
        self._finish_checkpointing()
        return acc.finalize_device()

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

    def _host_similarity(self, calls: Iterable[List[int]]) -> np.ndarray:
        """Literal host replication of ``getSimilarityMatrix``
        (``VariantsPca.scala:222-231``)."""
        n = len(self.indexes)
        matrix = np.zeros((n, n), dtype=np.int64)
        for row in calls:
            idx = np.asarray(row, dtype=np.int64)
            # Unbuffered: duplicate indices contribute per occurrence pair,
            # as the reference's loop does (``VariantsPca.scala:224-229``).
            np.add.at(matrix, np.ix_(idx, idx), 1)
        return matrix.astype(np.float64)

    # ------------------------------------------------------------------- pca

    def compute_pca(self, similarity: Similarity) -> List[Tuple[str, List[float]]]:
        """Center and eigendecompose (``VariantsPca.scala:238-271``)."""
        n = len(self.indexes)
        if self.conf.pca_backend == "host":
            if isinstance(similarity, torch.Tensor):
                similarity = similarity.cpu().numpy()
            S = np.asarray(similarity, dtype=np.float64)
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
        if self.io_stats is not None:
            print(str(self.io_stats))


@dataclass
class PipelineResult:
    """One completed analysis: the emitted TSV lines, the driver that ran
    it (its accumulator, spans and registry), the run manifest when one was
    built (``--metrics-json``) and the path it was written to when the
    write succeeded."""

    lines: List[str]
    driver: VariantsPcaDriver
    manifest: Optional[Dict] = None
    manifest_path: Optional[str] = None


def resolve_ingest(conf: PcaConf, source: GenomicsSource) -> Tuple[bool, bool]:
    """``(use_device, use_packed)`` for ``conf`` — neither means the wire
    arm — with the reference's rules and errors
    (``spark_examples_tpu/pipeline/pca_driver.py:run_pipeline``): ``auto``
    takes device generation on the gpu backend with distinct synthetic
    variant sets, the packed arm for a single-set VCF that wants streaming,
    and the wire arm otherwise; ``--save-variants`` forces the wire arm,
    and Gramian checkpointing leaves device generation for the packed
    (one set) or wire arm. ``source`` is the run's source."""
    synthetic_gpu = (
        conf.source == "synthetic" and not conf.input_path and conf.pca_backend == "gpu"
    )
    # Duplicate ids collapse the column index: a same-set join that only
    # the wire arm's count multiplicity reproduces.
    device_ok = len(set(conf.variant_set_id)) == len(conf.variant_set_id)
    use_device = conf.ingest == "device" or (
        conf.ingest == "auto" and synthetic_gpu and device_ok
    )
    if conf.ingest == "auto" and synthetic_gpu and not device_ok:
        print(
            "Device ingest unavailable (duplicate variant-set ids collapse "
            "the column index); using wire ingest."
        )
    use_packed = conf.ingest == "packed"
    file_packed = (
        conf.source == "file" and not conf.input_path and conf.pca_backend == "gpu"
    )
    if (
        not use_packed
        and conf.ingest == "auto"
        and file_packed
        and len(conf.variant_set_id) == 1
        and isinstance(source, FileGenomicsSource)
        and source.wants_streaming(conf.variant_set_id[0])
    ):
        # A large (or explicitly streamed) single-set VCF: the packed arm
        # with the bounded-memory streamed pass — the wire arm would hold
        # the whole file as Python records.
        use_packed = True
    if conf.save_variants:
        # The writer materializes wire records shard by shard; device and
        # packed ingest never build them.
        if conf.ingest in ("device", "packed"):
            raise ValueError(
                "--save-variants materializes wire records; it needs the "
                "wire ingest (--ingest wire, or leave --ingest auto)"
            )
        if conf.input_path:
            raise ValueError(
                "--save-variants with --input-path would re-save an "
                "existing checkpoint; copy the directory instead"
            )
        if len(conf.variant_set_id) != 1:
            raise ValueError(
                "--save-variants supports a single variant set "
                "(--input-path resume loads one dataset)"
            )
        if isinstance(source, FileGenomicsSource) and source.wants_streaming(
            conf.variant_set_id[0]
        ):
            raise ValueError(
                "--save-variants uses the wire ingest, which would load "
                "this streaming-scale VCF fully into host memory; the "
                "input is already resumable from disk. Force the in-memory "
                "path with --stream-chunk-bytes 0 if the host has room."
            )
        use_device = False
        use_packed = False
    if conf.gramian_checkpoint_dir or conf.resume_from:
        # Checkpoints snapshot the device accumulator against a host-fed,
        # deterministically ordered row cursor: the host backend has no
        # accumulator and device generation no host-side cursor.
        if conf.pca_backend != "gpu":
            raise ValueError(
                "--gramian-checkpoint-dir/--resume-from checkpoint the "
                "device accumulator; they need --pca-backend gpu"
            )
        if conf.ingest == "device":
            raise ValueError(
                "--ingest device has no host-fed row cursor to checkpoint "
                "or resume; use --ingest packed or wire (or leave --ingest "
                "auto, which falls back for checkpointed runs)"
            )
        if use_device:
            single = len(conf.variant_set_id) == 1
            print(
                "Device ingest disabled for Gramian checkpointing (the "
                "fused generator has no host-fed cursor); using "
                + ("packed ingest." if single else "wire ingest.")
            )
            use_device = False
            use_packed = single
    if use_device and not (synthetic_gpu and device_ok):
        raise ValueError(
            "--ingest device requires --source synthetic, --pca-backend gpu, "
            "and distinct variant-set ids"
        )
    if use_packed and not (synthetic_gpu or file_packed):
        raise ValueError(
            "--ingest packed requires --pca-backend gpu and --source "
            "synthetic or file (VCF inputs)"
        )
    if use_packed and len(conf.variant_set_id) != 1:
        raise ValueError(
            "--ingest packed supports a single variant set; use --ingest "
            "device (distinct sets) or --ingest wire"
        )
    if use_packed and file_packed:
        # Packed file ingest is VCF-only: fail here, not from a worker
        # thread mid-pipeline.
        selected = dict(zip(file_set_ids(conf.input_files or []), conf.input_files))[
            conf.variant_set_id[0]
        ]
        lowered = selected[:-3] if selected.endswith(".gz") else selected
        if not lowered.endswith(".vcf"):
            raise ValueError(
                f"--ingest packed needs a .vcf[.gz] input; got {selected!r} "
                "(use --ingest wire for JSONL/checkpoint inputs)"
            )
    return use_device, use_packed


def _feed_rows(conf: PcaConf, driver: VariantsPcaDriver, rows: Iterable[np.ndarray]) -> Similarity:
    """Run a block stream through the bounded prefetch thread (with ingest
    workers enabled) into the double-buffered accumulator
    (``pipeline_depth=2``), so the host builds block k+1 while the card
    works on block k. The overlap accounting lands in the registry and the
    manifest; ``--profile-dir`` also prints it."""
    ingest_workers = _resolve_ingest_workers(conf.ingest_workers)
    prefetch = None
    if ingest_workers > 0:
        rows = prefetch = PrefetchIterator(
            rows, depth=2, registry=driver.registry, spans=driver.spans
        )
    try:
        return driver.get_similarity_rows(
            rows, pipeline_depth=2 if ingest_workers > 0 else None
        )
    finally:
        if prefetch is not None:
            prefetch.close()
            driver.overlap = prefetch.overlap_stats()
            if conf.profile_dir:
                print(prefetch.overlap_report())


def _packed_similarity(conf: PcaConf, driver: VariantsPcaDriver) -> Similarity:
    """The packed arm: dense genotype blocks from the source — the
    synthetic generator's, or a VCF's from the native parser — window by
    window in partition order, or, for a VCF that wants streaming, from one
    bounded-memory pass in file order (G += XᵀX commutes). Both account
    the same per-shard pages and variants in the I/O stats."""
    source = driver.source
    set_id = conf.variant_set_id[0]
    contigs = conf.get_contigs(source, conf.variant_set_id)
    partitions = VariantsPartitioner(contigs, conf.bases_per_partition).get_partitions(set_id)
    well_known_gauge(driver.registry, INGEST_PARTITIONS_PLANNED).set(len(partitions))
    done_gauge = well_known_gauge(driver.registry, INGEST_PARTITIONS_DONE)
    io_stats = driver.io_stats
    file_source = isinstance(source, FileGenomicsSource)
    streamed = file_source and source.wants_streaming(set_id)

    if streamed:
        counters = StreamCounters(len(partitions), registry=driver.registry)

        def streamed_rows():
            for block in source.stream_genotype_blocks(
                set_id,
                [p.contig for p in partitions],
                block_size=conf.block_size,
                min_allele_frequency=conf.min_allele_frequency,
                counters=counters,
            ):
                yield block["has_variation"]

        similarity = _feed_rows(conf, driver, streamed_rows())
        # Every window is done, including any past the file's last record
        # that the cursor never reached.
        done_gauge.set(len(partitions))
        if io_stats is not None:
            for part in partitions:
                io_stats.add_partition(part.range)
            io_stats.add_requests(counters.requests())
            io_stats.add_variants(counters.variants)
    else:

        def block_stream():
            # Blocks flow one at a time from the per-window producer; stats
            # account per window as it streams, in partition order.
            for index, part in enumerate(partitions):
                if io_stats is not None:
                    io_stats.add_partition(part.range)
                    io_stats.add_requests(
                        partition_page_requests(
                            source, part.variant_set_id, part.contig,
                            conf.bases_per_partition,
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
                    yield block["has_variation"]
                if io_stats is not None:
                    io_stats.add_variants(window_variants)
                done_gauge.set(index + 1)

        similarity = _feed_rows(conf, driver, block_stream())
    if file_source:
        native = source.native_parse(set_id, streamed)
        if native is not None:
            well_known_gauge(driver.registry, VCF_NATIVE_PARSE).set(float(native))
    return similarity


def _similarity_stage(
    conf: PcaConf, driver: VariantsPcaDriver, use_device: bool, use_packed: bool
) -> Similarity:
    """The ingest+similarity stage of :func:`run_pipeline`, one of the
    three arms."""
    if use_device:
        contigs = conf.get_contigs(driver.source, conf.variant_set_id)
        return driver.get_similarity_device_gen(contigs)
    if use_packed:
        return _packed_similarity(conf, driver)
    return driver.get_similarity_matrix(driver.iter_calls(driver.get_data()))


def run_pipeline(
    conf: PcaConf, device: DeviceLike = None, source: Optional[GenomicsSource] = None
) -> PipelineResult:
    """The analysis, CLI-free: config in, result out, in the reference's
    order (``spark_examples_tpu/pipeline/pca_driver.py:run_pipeline``): the
    fault plan is configured, the heartbeat starts, the stages run under
    ``--profile-dir``'s device trace, the rows and the stats print, then the
    stage report and the manifest, built last so it snapshots what the
    epilogue printed. Runs on ``device`` (default ``conf.device``); raises
    when a CUDA device is asked for and none is present. ``source``
    replaces the one ``--source`` names (a REST source with its own
    transport, say)."""
    check_ported(conf)
    if conf.fault_plan is not None:
        # The flag wins over the environment variable; configuring resets
        # hit counts, so every run starts a fresh deterministic schedule.
        faults.configure(conf.fault_plan)
    else:
        # Parse the environment's plan now: a typo'd site fails here, not
        # at the first checkpoint of a whole-genome run.
        faults.active()
    if source is None:
        source = make_source(conf)
    use_device, use_packed = resolve_ingest(conf, source)
    driver = VariantsPcaDriver(
        conf, source, device=conf.device if device is None else device
    )
    times = StageTimes(recorder=driver.spans)
    heartbeat = None
    if conf.heartbeat_seconds > 0:
        heartbeat = Heartbeat(conf.heartbeat_seconds, driver.registry).start()
    # Every arm's stage ends with the card synchronised.
    sync = synchronizer(driver.device)
    try:
        with device_trace(conf.profile_dir):
            with times.stage("ingest+similarity", sync=sync):
                similarity = _similarity_stage(conf, driver, use_device, use_packed)
            with times.stage("center+pca", sync=sync):
                result = driver.compute_pca(similarity)
    finally:
        # A failed run gets its last heartbeat, then silence.
        if heartbeat is not None:
            heartbeat.stop()
    _register_prover_conformance(driver)
    lines = driver.emit_result(result)
    driver.report_io_stats()
    if conf.profile_dir:
        print(str(times))
        print(f"Device trace written to {conf.profile_dir}.")
    manifest = manifest_path = None
    if conf.metrics_json:
        resume = None
        if driver.feeder is not None:
            # Where this run started from (0 for a fresh checkpointed run),
            # how much ingest the cursor fast-forwarded, and how many
            # faults fired in-process.
            resume = {
                "checkpoint_sites": int(driver.feeder.checkpoint_sites),
                "sites_skipped": int(driver.feeder.sites_skipped),
                "faults_injected": int(faults.injected_count()),
            }
        manifest = build_run_manifest(
            conf=conf,
            spans=driver.spans,
            registry=driver.registry,
            io_stats=driver.io_stats,
            overlap=driver.overlap,
            resume=resume,
        )
        try:
            write_manifest(conf.metrics_json, manifest)
        except OSError as e:
            # The results are printed already: report the lost telemetry
            # and keep the run's exit intact.
            print(f"Run manifest NOT written to {conf.metrics_json}: {e}", file=sys.stderr)
        else:
            manifest_path = conf.metrics_json
            print(f"Run manifest written to {conf.metrics_json}.")
    return PipelineResult(lines, driver, manifest, manifest_path)


def _register_prover_conformance(driver: VariantsPcaDriver) -> None:
    """The run's ``hostmem`` conformance pair (the manifest's
    ``conformance`` block): the peak RSS measured against the bound the
    driver registered at set-up, as the reference's epilogue records it.
    The ``sched`` and ``ranges`` pairs belong to flags the port does not
    take yet (the sharded schedule, ``--check-ranges``), so they stay
    absent. Telemetry never takes down a completed run."""
    registry = driver.registry
    try:
        measured = registry.value(HOST_PEAK_RSS_BYTES)
        if measured is not None and measured == measured:
            bound = registry.value(HOST_STATIC_BOUND_BYTES)
            record_prover_conformance(
                registry, "hostmem", measured,
                bound if bound is not None and bound == bound else None,
            )
    except Exception:
        pass


def run(argv: Sequence[str], device: DeviceLike = None) -> List[str]:
    """``VariantsPcaDriver.main`` (``VariantsPca.scala:47-59``): parse the
    flags and run. ``device`` overrides ``--device``."""
    return run_pipeline(PcaConf.parse(argv), device=device).lines


__all__ = [
    "CallData",
    "PipelineResult",
    "VariantsPcaDriver",
    "extract_call_info",
    "make_source",
    "resolve_ingest",
    "run",
    "run_pipeline",
]
