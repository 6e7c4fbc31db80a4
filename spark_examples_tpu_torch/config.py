"""CLI configuration: the JAX package's flag grammar, preserved.

``GenomicsConf`` mirrors ``spark_examples_tpu/config.py:GenomicsConf``
(``GenomicsConf.scala:29-64``), the flags of the seven examples' verbs;
``PcaConf`` extends it as ``spark_examples_tpu/config.py:PcaConf`` does
(``GenomicsConf.scala:66-98``): every flag, name and default is the same, so
one argv parses identically in both packages, and a ``variants-pca`` flag
given to an example verb is refused by argparse, as the reference refuses
it. Two values differ:

- ``--pca-backend {gpu,host}``: the device value is ``gpu`` (the default);
  ``host`` stays the NumPy oracle of the reference algorithm;
- ``--device {cuda,cpu}`` (default ``cuda``) is the one added flag: where
  the port's tensors live. ``cpu`` runs the kernels' plain PyTorch versions.

The port runs the synthetic source's three ingest arms (device generation,
packed, wire), the file source's (packed, streamed, wire) and the REST
source's (wire), variant checkpoints (``--save-variants``,
``--input-path``), Gramian checkpoints and resume
(``--gramian-checkpoint-dir``, ``--checkpoint-every-sites``,
``--resume-from``), fault plans (``--fault-plan``) and the run's telemetry
(``--metrics-json``, ``--profile-dir``, ``--heartbeat-seconds``), the
dense and sharded strategies on a mesh
(``--mesh-shape``, ``--num-reduce-partitions``, ``--similarity-strategy``,
``--ring-pack-bits``, ``--reduce-schedule``), across several processes
(``--coordinator-address``, ``--num-processes``, ``--process-id``:
:meth:`GenomicsConf.init_distributed`), and the host-fed accumulators'
range sampling (``--check-ranges``); :class:`GrmConf` adds the ``grm`` verb's
``--grm-out``, :class:`LdConf` the ``ld-prune`` verb's ``--ld-*`` flags and
:class:`AssocConf` the ``assoc-scan`` verb's ``--phenotypes`` and
``--assoc-*``; the analyses take the mesh's flags too. The one combination
the port does not run, Gramian checkpoints across processes, raises
:class:`NotImplementedError` naming the flag (:func:`check_ported`), so it
is never silently ignored.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from spark_examples_tpu_torch.constants import GoogleGenomicsPublicData
from spark_examples_tpu_torch.sharding.contig import (
    BRCA1,
    DEFAULT_BASES_PER_SHARD,
    Contig,
    SexChromosomeFilter,
    parse_contigs,
)
from spark_examples_tpu_torch.sources.files import file_set_ids
from spark_examples_tpu_torch.utils.faults import parse_plan


def _num_samples_value(text: str) -> str:
    """Validate ``--num-samples`` (an int, or a comma list of ints) at parse
    time so malformed input gets argparse's usage error, not a traceback."""
    values = [v for v in text.split(",") if v.strip()]
    if not values:
        raise argparse.ArgumentTypeError("needs at least one value")
    for v in values:
        try:
            int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(f"invalid int value: {v!r}")
    return text


def _build_base_parser(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The base flags (``spark_examples_tpu/config.py:_build_base_parser``)
    plus ``--device``."""
    p.add_argument("--bases-per-partition", type=int, default=DEFAULT_BASES_PER_SHARD,
                   help="Partition each reference using a fixed number of bases")
    p.add_argument("--client-secrets", default="client_secrets.json")
    p.add_argument("--input-path", default=None)
    p.add_argument("--num-reduce-partitions", type=int, default=10,
                   help="Caps the data axis of the default mesh (every card, "
                   "data-major) when no --mesh-shape is given.")
    p.add_argument("--output-path", default=None)
    p.add_argument("--references", default=BRCA1,
                   help="Comma separated tuples of reference:start:end,... one "
                   "list per variantset in the corresponding order (lists "
                   "separated by ';').")
    p.add_argument("--spark-master", default=None,
                   help="Accepted for flag compatibility with the reference; unused.")
    p.add_argument("--variant-set-id",
                   default=GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1,
                   help="Comma-separated list of VariantSetIds to use in the analysis.")
    p.add_argument("--source", choices=["synthetic", "rest", "file"], default="synthetic",
                   help="Genomics backend to stream from.")
    p.add_argument("--input-files", default=None,
                   help="Comma-separated input files for --source file: "
                   ".vcf[.gz] / .jsonl[.gz] variants (or a checkpoint "
                   "directory), .sam reads. Each file becomes one variant set "
                   "(or read group set) whose id is its sanitized stem; "
                   "--variant-set-id defaults to all of them in order; the "
                   "reads examples take their readsets in file order.")
    p.add_argument("--stream-chunk-bytes", type=int, default=None,
                   help="Bounded-memory streaming ingest for --source file VCF "
                   "inputs: parse in chunks of this many decompressed bytes "
                   "(one pass, coordinate-sorted VCFs only). Unset = automatic "
                   "(streams past the size threshold); 0 = never stream; N > 0 "
                   "= always stream with N-byte chunks.")
    p.add_argument("--ingest-workers", type=int, default=None,
                   help="Packed ingest: parse threads of the chunk-parallel "
                   "VCF parser; >= 1 also builds blocks on a prefetch thread "
                   "and keeps two flushes in flight; 0 is the serial path. "
                   "Default: min(8, cpu_count).")
    p.add_argument("--num-samples", type=_num_samples_value, default="2504",
                   help="Synthetic-source cohort size; a comma-separated list "
                   "gives per-variant-set sizes, zipped with --variant-set-id.")
    p.add_argument("--seed", type=int, default=42, help="Synthetic-source base seed.")
    p.add_argument("--heartbeat-seconds", type=float, default=0.0,
                   help="Write a progress line to stderr every N seconds "
                   "(obs/heartbeat.py). 0 = off (default).")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="Write the schema-v2 run manifest here "
                   "(obs/manifest.py).")
    p.add_argument("--trace-dir", default=None, metavar="DIR")
    p.add_argument("--gramian-checkpoint-dir", default=None, metavar="DIR",
                   help="Periodically persist the accumulator state (partial "
                   "Gramian, site cursor, conf fingerprint) as one atomically "
                   "published artifact under DIR, so a killed run resumes "
                   "(host-fed ingest: packed or wire; --pca-backend gpu).")
    p.add_argument("--checkpoint-every-sites", type=int, default=None, metavar="N",
                   help="Snapshot cadence for --gramian-checkpoint-dir: one "
                   "checkpoint per N accumulated sites. Default: "
                   "pipeline/checkpoint.py:DEFAULT_CHECKPOINT_EVERY_SITES.")
    p.add_argument("--resume-from", default=None, metavar="DIR",
                   help="Resume from the newest complete Gramian checkpoint in "
                   "DIR (its conf fingerprint must match this run's flags); no "
                   "complete artifact yet starts from zero. Checkpoints of "
                   "either package resume in the other.")
    p.add_argument("--fault-plan", default=None, metavar="SPEC",
                   help="Deterministic fault-injection plan (testing): "
                   "comma-separated action@site[#nth][=arg] entries "
                   "(utils/faults.py). Equivalent to the "
                   "SPARK_EXAMPLES_TPU_FAULTS environment variable; the flag "
                   "wins when both are set.")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the port's tensors live: the CUDA card "
                   "(default) or the CPU, which runs the kernels' plain "
                   "PyTorch versions.")
    return p


def build_pca_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    """The ``variants-pca`` flag surface (``spark_examples_tpu/config.py:
    build_pca_parser``) plus ``--device``."""
    p = _build_base_parser(parser or argparse.ArgumentParser())
    p.add_argument("--all-references", action="store_true",
                   help="Use all references (except X and Y) to compute PCA "
                   "(overrides --references).")
    p.add_argument("--debug-datasets", action="store_true")
    p.add_argument("--min-allele-frequency", type=float, default=None)
    p.add_argument("--num-pc", type=int, default=2)
    p.add_argument("--pca-backend", choices=["gpu", "host"], default="gpu",
                   help="PCA compute path: the device pipeline or the NumPy "
                   "oracle of the reference algorithm.")
    p.add_argument("--mesh-shape", default=None,
                   help="'data,samples': the mesh of positions over this "
                   "process's cards (on --device cpu, CPU positions).")
    p.add_argument("--block-size", type=int, default=1024,
                   help="Sites per device block: one generation block, or one "
                   "host-fed flush of variant rows.")
    p.add_argument("--ingest", choices=["auto", "device", "packed", "wire"],
                   default="auto",
                   help="Genotype ingest path: 'device' generates the synthetic "
                   "data plane on the device fused with the Gramian; 'packed' "
                   "ships host-built bit-packed genotype blocks; 'wire' pages "
                   "variant records and joins variant sets on the host; 'auto' "
                   "is device for distinct variant sets on the gpu backend, "
                   "wire otherwise.")
    p.add_argument("--fused-jobs", type=int, default=None, metavar="K",
                   help="Plan-time directive of the reference; a batch run "
                   "ignores it.")
    p.add_argument("--blocks-per-dispatch", type=int, default=None,
                   help="Blocks per dispatch group. Default: auto, constant "
                   "work per group (ops/devicegen.py:auto_blocks_per_dispatch).")
    p.add_argument("--ring-pack-bits", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--reduce-schedule", choices=["auto", "flat", "hier"], default="auto")
    p.add_argument("--check-ranges", action="store_true",
                   help="DEBUG: sample the max |accumulator entry| after every "
                   "Gramian flush (one device read a flush) into the "
                   "gramian_entry_max gauge, next to the statically projected "
                   "gramian_static_entry_bound; the run manifest records the pair "
                   "(gramian_exactness, the ranges conformance pair) — the "
                   "runtime half of `graftcheck ranges`. Host-fed accumulators "
                   "only (packed/wire ingest); the device-generation path has no "
                   "host flush to sample.")
    p.add_argument("--exact-similarity", action="store_true",
                   help="Integer Gramian accumulation; device generation is "
                   "always exact (int8 x int8 -> int32).")
    p.add_argument("--similarity-strategy", choices=["auto", "dense", "sharded"],
                   default="auto")
    p.add_argument("--num-workers", type=int, default=8,
                   help="Host threads of the wire ingest's shard pool.")
    p.add_argument("--profile-dir", default=None,
                   help="Print stage timings and write a torch.profiler "
                   "Chrome trace of the run into this directory.")
    p.add_argument("--save-variants", default=None, metavar="PATH",
                   help="Save the variant records read (wire ingest, single "
                   "set) as a checkpoint that --input-path resumes from.")
    return p


@dataclass
class GenomicsConf:
    """Parsed base flags (``GenomicsConf.scala:29-64``): the examples'
    verbs."""

    bases_per_partition: int = DEFAULT_BASES_PER_SHARD
    client_secrets: str = "client_secrets.json"
    input_path: Optional[str] = None
    num_reduce_partitions: int = 10
    output_path: Optional[str] = None
    references: str = BRCA1
    spark_master: Optional[str] = None
    variant_set_id: List[str] = field(
        default_factory=lambda: [GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1]
    )
    source: str = "synthetic"
    input_files: Optional[List[str]] = None
    stream_chunk_bytes: Optional[int] = None
    ingest_workers: Optional[int] = None
    num_samples: int = 2504
    num_samples_per_set: Optional[List[int]] = None
    seed: int = 42
    heartbeat_seconds: float = 0.0
    metrics_json: Optional[str] = None
    trace_dir: Optional[str] = None
    gramian_checkpoint_dir: Optional[str] = None
    checkpoint_every_sites: Optional[int] = None
    resume_from: Optional[str] = None
    fault_plan: Optional[str] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    device: str = "cuda"

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "GenomicsConf":
        parser = _build_base_parser(argparse.ArgumentParser())
        return cls._from_namespace(parser.parse_args(list(argv)))

    @classmethod
    def _from_namespace(cls, ns: argparse.Namespace):
        conf = cls(**{f: getattr(ns, f) for f in cls.__dataclass_fields__ if hasattr(ns, f)})
        if isinstance(conf.variant_set_id, str):
            conf.variant_set_id = [v for v in conf.variant_set_id.split(",") if v.strip()]
        if isinstance(conf.input_files, str):
            conf.input_files = [p.strip() for p in conf.input_files.split(",") if p.strip()]
        if isinstance(conf.num_samples, str):
            sizes = [int(s) for s in conf.num_samples.split(",") if s.strip()]
            conf.num_samples = sizes[0]
            conf.num_samples_per_set = sizes if len(sizes) > 1 else None
        if conf.heartbeat_seconds < 0:
            raise ValueError(
                f"--heartbeat-seconds must be >= 0 (0 = off), got "
                f"{conf.heartbeat_seconds}"
            )
        if conf.ingest_workers is not None and conf.ingest_workers < 0:
            raise ValueError(
                f"--ingest-workers must be >= 0 (0 = serial oracle path), "
                f"got {conf.ingest_workers}"
            )
        if conf.checkpoint_every_sites is not None and conf.checkpoint_every_sites < 1:
            raise ValueError(
                f"--checkpoint-every-sites must be >= 1, got "
                f"{conf.checkpoint_every_sites} (omit the flag for the "
                "default cadence)"
            )
        if conf.fault_plan is not None:
            # A typo'd site name fails at parse time, not mid-run.
            parse_plan(conf.fault_plan)
        conf._check_flags()
        if conf.num_samples_per_set:
            if conf.source != "synthetic":
                raise ValueError(
                    "per-set --num-samples is synthetic-source-only "
                    f"(--source {conf.source} reads its cohorts from the data)"
                )
            if len(set(conf.variant_set_id)) != len(conf.variant_set_id):
                raise ValueError(
                    "per-set --num-samples requires distinct --variant-set-id "
                    "values (duplicate ids share one cohort)"
                )
        if conf.source == "file":
            if not conf.input_files:
                raise ValueError("--source file requires --input-files")
            ids = file_set_ids(conf.input_files)
            if conf.variant_set_id == [GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1]:
                # The untouched default: every input file is one variant set.
                conf.variant_set_id = ids
            elif not set(conf.variant_set_id) <= set(ids):
                raise ValueError(
                    f"--variant-set-id {conf.variant_set_id} not among the "
                    f"file-derived set ids {ids}"
                )
        return conf

    def init_distributed(self) -> None:
        """Join the run of several processes the cluster flags name (a
        no-op without them) — call before any device use. The process's
        positions live where ``--device`` says
        (``parallel/mesh.py:distributed_init``)."""
        from spark_examples_tpu_torch.parallel.mesh import distributed_init

        distributed_init(
            coordinator_address=self.coordinator_address,
            num_processes=self.num_processes,
            process_id=self.process_id,
            device=self.device,
        )

    def _check_flags(self) -> None:
        """The subclass's own flag checks, before the source checks. The
        examples take every base flag, as the reference's do; the ones their
        paths do not read (telemetry, checkpoints, the cluster's) are unused
        there too."""

    def get_references(self) -> List[List[Contig]]:
        """One contig list per variant set (``GenomicsConf.scala:59-63``),
        ';' between the per-set lists and ',' within one."""
        return [parse_contigs(spec) for spec in self.references.split(";")]


@dataclass
class PcaConf(GenomicsConf):
    """Parsed ``variants-pca`` flags (``GenomicsConf.scala:66-98``)."""

    all_references: bool = False
    debug_datasets: bool = False
    min_allele_frequency: Optional[float] = None
    num_pc: int = 2
    pca_backend: str = "gpu"
    mesh_shape: Optional[str] = None
    block_size: int = 1024
    ingest: str = "auto"
    fused_jobs: Optional[int] = None
    blocks_per_dispatch: Optional[int] = None
    ring_pack_bits: str = "auto"
    reduce_schedule: str = "auto"
    check_ranges: bool = False
    exact_similarity: bool = False
    similarity_strategy: str = "auto"
    num_workers: int = 8
    profile_dir: Optional[str] = None
    save_variants: Optional[str] = None

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "PcaConf":
        return cls._from_namespace(build_pca_parser().parse_args(list(argv)))

    def _check_flags(self) -> None:
        if self.blocks_per_dispatch is not None and self.blocks_per_dispatch <= 0:
            raise ValueError(
                f"--blocks-per-dispatch must be a positive dispatch-group "
                f"length, got {self.blocks_per_dispatch} (omit the flag for "
                "the auto rule)"
            )
        check_ported(self)

    def get_contigs(self, source, variant_set_ids: Sequence[str]) -> List[Contig]:
        """Contigs for all datasets (``GenomicsConf.scala:83-97``):
        ``--all-references`` asks the source for every contig but X and Y;
        otherwise the per-variantset ``--references`` lists are zipped with
        the variant sets and truncated to the shorter (Scala ``zip``)."""
        print(f"Running PCA on {len(variant_set_ids)} datasets.")
        contigs: List[Contig] = []
        if self.all_references:
            for variant_set_id in variant_set_ids:
                print(f"Variantset: {variant_set_id}; All refs, exclude XY")
                contigs.extend(
                    source.get_contigs(variant_set_id, SexChromosomeFilter.EXCLUDE_XY)
                )
        else:
            for variant_set_id, spec in zip(variant_set_ids, self.references.split(";")):
                print(f"Variantset: {variant_set_id}; Refs: {spec}")
                contigs.extend(parse_contigs(spec))
        return contigs


def check_ported(conf: PcaConf) -> None:
    """Raise :class:`NotImplementedError` for the one combination the port
    does not run: the Gramian checkpoints in a run of several processes
    (every process would write the one directory)."""
    if (conf.num_processes or 1) > 1 and (conf.gramian_checkpoint_dir or conf.resume_from):
        flag = "--gramian-checkpoint-dir" if conf.gramian_checkpoint_dir else "--resume-from"
        raise NotImplementedError(
            f"{flag} with --num-processes {conf.num_processes}: Gramian "
            "checkpoints run in a run of one process in the port"
        )


def build_grm_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    """``grm`` verb flags (``spark_examples_tpu/config.py:build_grm_parser``):
    the PCA surface plus the kinship output path."""
    p = build_pca_parser(parser)
    p.add_argument("--grm-out", default=None, metavar="PATH",
                   help="Write the N×N VanRaden kinship matrix as a TSV (one "
                   "row per sample: name, then N float64 values; atomic "
                   "publish). Unset: only the summary is printed.")
    return p


def build_ld_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    """``ld-prune`` verb flags (``spark_examples_tpu/config.py:
    build_ld_parser``): windowed r² pruning over contig-ordered sites."""
    p = build_pca_parser(parser)
    p.add_argument("--ld-r2-threshold", type=float, default=0.2,
                   help="Prune a site whose r² with any previously-kept site in "
                   "its window is STRICTLY greater than this (greedy, contig "
                   "order; must be in [0, 1]).")
    p.add_argument("--ld-window-sites", type=int, default=256,
                   help="Sites per pruning window (>= 2). Windows are "
                   "contig-ordered and independent; the device computes one "
                   "W×W co-carrier matrix per window, so host and device "
                   "memory cost is O(W²), never O(M).")
    p.add_argument("--ld-out", default=None, metavar="PATH",
                   help="Write the per-site kept mask as a TSV (contig, pos, "
                   "kept 0/1), streamed window by window (bounded host memory, "
                   "atomic publish). Unset: only the kept/tested counts are "
                   "printed.")
    return p


def build_assoc_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    """``assoc-scan`` verb flags (``spark_examples_tpu/config.py:
    build_assoc_parser``): per-site case/control chi-square."""
    p = build_pca_parser(parser)
    p.add_argument("--phenotypes", default=None, metavar="TSV",
                   help="REQUIRED: two-column TSV (sample name, status "
                   "0=control/1=case; '#' comment lines skipped) covering "
                   "every cohort sample by its callset name.")
    p.add_argument("--assoc-out", default=None, metavar="PATH",
                   help="Write the per-site scan as a TSV (contig, pos, case "
                   "carriers, total carriers, chi2), streamed block by block "
                   "(bounded host memory, atomic publish). Unset: only the "
                   "top-ranked sites are printed.")
    p.add_argument("--assoc-top", type=int, default=10,
                   help="How many top-chi² sites to print (and return) — a "
                   "bounded heap, so the ranking never holds O(M) rows on host.")
    return p


@dataclass
class GrmConf(PcaConf):
    """``grm`` flags: allele-frequency-standardized kinship (VanRaden)."""

    grm_out: Optional[str] = None

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "GrmConf":
        return cls._from_namespace(build_grm_parser().parse_args(list(argv)))


@dataclass
class LdConf(PcaConf):
    """``ld-prune`` flags: windowed LD r² pruning."""

    ld_r2_threshold: float = 0.2
    ld_window_sites: int = 256
    ld_out: Optional[str] = None

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "LdConf":
        return cls._from_namespace(build_ld_parser().parse_args(list(argv)))

    @classmethod
    def _from_namespace(cls, ns: argparse.Namespace) -> "LdConf":
        conf = super()._from_namespace(ns)
        # Parse-time rejects, the reference's words: a threshold outside
        # [0, 1] silently keeps or prunes everything, a window below 2 has
        # nothing to correlate.
        if not (0.0 <= conf.ld_r2_threshold <= 1.0):
            raise ValueError(
                f"--ld-r2-threshold must be in [0, 1], got "
                f"{conf.ld_r2_threshold}"
            )
        if conf.ld_window_sites < 2:
            raise ValueError(
                f"--ld-window-sites must be >= 2, got {conf.ld_window_sites}"
            )
        return conf


@dataclass
class AssocConf(PcaConf):
    """``assoc-scan`` flags: per-site case/control chi-square."""

    phenotypes: Optional[str] = None
    assoc_out: Optional[str] = None
    assoc_top: int = 10

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "AssocConf":
        return cls._from_namespace(build_assoc_parser().parse_args(list(argv)))

    @classmethod
    def _from_namespace(cls, ns: argparse.Namespace) -> "AssocConf":
        conf = super()._from_namespace(ns)
        if conf.assoc_top < 1:
            raise ValueError(f"--assoc-top must be >= 1, got {conf.assoc_top}")
        return conf


__all__ = [
    "AssocConf",
    "GenomicsConf",
    "GrmConf",
    "LdConf",
    "PcaConf",
    "build_assoc_parser",
    "build_grm_parser",
    "build_ld_parser",
    "build_pca_parser",
    "check_ported",
]
