"""CLI configuration: the JAX package's PCA flag grammar, preserved.

``PcaConf`` mirrors ``spark_examples_tpu/config.py:PcaConf`` (itself
``GenomicsConf.scala:29-98``): every flag, name and default is the same, so
one argv parses identically in both packages. Two values differ:

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
(``--metrics-json``, ``--profile-dir``, ``--heartbeat-seconds``), dense
strategy, one device; :class:`GrmConf` adds the ``grm`` verb's
``--grm-out``. A flag that belongs to any other path raises
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


def build_pca_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    """The ``variants-pca`` flag surface (``spark_examples_tpu/config.py:
    build_pca_parser``) plus ``--device``."""
    p = parser or argparse.ArgumentParser()
    p.add_argument("--bases-per-partition", type=int, default=DEFAULT_BASES_PER_SHARD,
                   help="Partition each reference using a fixed number of bases")
    p.add_argument("--client-secrets", default="client_secrets.json")
    p.add_argument("--input-path", default=None)
    p.add_argument("--num-reduce-partitions", type=int, default=10,
                   help="Reference flag; one device needs no reduce partitions.")
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
                   "directory). Each file becomes one variant set whose id is "
                   "its sanitized stem; --variant-set-id defaults to all of "
                   "them in order.")
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
    p.add_argument("--all-references", action="store_true",
                   help="Use all references (except X and Y) to compute PCA "
                   "(overrides --references).")
    p.add_argument("--debug-datasets", action="store_true")
    p.add_argument("--min-allele-frequency", type=float, default=None)
    p.add_argument("--num-pc", type=int, default=2)
    p.add_argument("--pca-backend", choices=["gpu", "host"], default="gpu",
                   help="PCA compute path: the device pipeline or the NumPy "
                   "oracle of the reference algorithm.")
    p.add_argument("--mesh-shape", default=None)
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
    p.add_argument("--check-ranges", action="store_true")
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the port's tensors live: the CUDA card "
                   "(default) or the CPU, which runs the kernels' plain "
                   "PyTorch versions.")
    return p


@dataclass
class PcaConf:
    """Parsed ``variants-pca`` flags (``GenomicsConf.scala:29-98``)."""

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
    device: str = "cuda"

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "PcaConf":
        return cls._from_namespace(build_pca_parser().parse_args(list(argv)))

    @classmethod
    def _from_namespace(cls, ns: argparse.Namespace) -> "PcaConf":
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
        if conf.blocks_per_dispatch is not None and conf.blocks_per_dispatch <= 0:
            raise ValueError(
                f"--blocks-per-dispatch must be a positive dispatch-group "
                f"length, got {conf.blocks_per_dispatch} (omit the flag for "
                "the auto rule)"
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
        check_ported(conf)
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


#: Flags of paths the port does not run yet: (field, flag, value that leaves
#: the flag unused). Any other value raises.
_UNPORTED = (
    ("trace_dir", "--trace-dir", None),
    ("coordinator_address", "--coordinator-address", None),
    ("num_processes", "--num-processes", None),
    ("process_id", "--process-id", None),
    ("mesh_shape", "--mesh-shape", None),
    ("ring_pack_bits", "--ring-pack-bits", "auto"),
    ("reduce_schedule", "--reduce-schedule", "auto"),
    ("check_ranges", "--check-ranges", False),
)


def check_ported(conf: PcaConf) -> None:
    """Raise :class:`NotImplementedError` for a flag whose path the port
    does not run yet (the flight recorder, multi-host, meshes and rings)."""
    for name, flag, unused in _UNPORTED:
        value = getattr(conf, name)
        if value != unused:
            raise NotImplementedError(
                f"{flag} {value!r}: this path is not ported to PyTorch yet "
                "(the port runs the synthetic, file and REST sources' device, "
                "packed, streamed and wire ingest, dense strategy, one device)"
            )
    if conf.similarity_strategy == "sharded":
        raise NotImplementedError(
            "--similarity-strategy sharded: the sharded ring is not ported "
            "to PyTorch yet (use dense or auto)"
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


@dataclass
class GrmConf(PcaConf):
    """``grm`` flags: allele-frequency-standardized kinship (VanRaden)."""

    grm_out: Optional[str] = None

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "GrmConf":
        return cls._from_namespace(build_grm_parser().parse_args(list(argv)))


__all__ = ["GrmConf", "PcaConf", "build_grm_parser", "build_pca_parser", "check_ported"]
