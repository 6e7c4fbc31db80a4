"""The four read analyses (``SearchReadsExample.scala:76-307``): the port's
copy of ``spark_examples_tpu/analyses/reads_examples.py``.

Output strings replicate the reference's formats (including Scala tuple
rendering in the saved text files) so results are comparable byte-for-byte;
the per-position aggregations run on the device ``--device`` resolves, as
the hand-written kernels of ``ops/depth.py`` (``csrc/depth.cu``) instead of
flatMap+shuffle.

Reads contribute coverage beyond their own shard's right edge; the reference
merged those contributions in the ``reduceByKey`` shuffle. Here each shard
computes an extended window and the tail is carried into the next shard — the
streaming equivalent, exact for shards processed in coordinate order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.config import GenomicsConf
from spark_examples_tpu_torch.constants import Examples
from spark_examples_tpu_torch.models.read import Read
from spark_examples_tpu_torch.ops.depth import (
    BASES,
    base_counts,
    depth_counts,
    encode_bases,
)
from spark_examples_tpu_torch.pipeline.datasets import ReadsDataset
from spark_examples_tpu_torch.pipeline.sitewriter import SiteOutputWriter
from spark_examples_tpu_torch.sharding.partitioners import (
    FixedSplits,
    ReadsPartitioner,
    TargetSizeSplits,
)
from spark_examples_tpu_torch.sources.base import GenomicsSource
from spark_examples_tpu_torch.utils.device import resolve_device


def _pad_read_length(max_len: int) -> int:
    """Round a shard's max read length up to a multiple of 64, as the JAX
    package buckets its static shape (there to bound recompiles): the
    window's overhang and ``depth_counts``' offset cut follow it, so the
    counts and the carry are the reference's, and long reads are never
    truncated."""
    return max(64, -(-int(max_len) // 64) * 64)


def _write_part_file(out_dir: str, lines: Sequence[str]) -> None:
    """``saveAsTextFile`` shape: a directory with a part file."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "part-00000"), "w") as f:
        for line in lines:
            f.write(line + "\n")


def run_example1(
    conf: GenomicsConf,
    source: GenomicsSource,
    snp: int = Examples.CILANTRO,
    sequence: str = "11",
    readset: str = Examples.GOOGLE_EXAMPLE_READSET,
) -> List[str]:
    """Pileup around the cilantro/soap SNP
    (``SearchReadsExample.scala:76-111``): filter covering reads, align text
    columns, print the quality of the SNP base inline.

    A read covers the SNP when ``position <= snp < position + len(seq)``,
    the half-open span of its bases. The JAX package keeps a read with
    ``position + len(seq) >= snp``, which also takes a read whose last base
    lies at ``snp - 1``; indexing that read's quality at ``snp - position
    = len(seq)`` raises ``IndexError`` (at the synthetic read geometry a
    read starts at ``snp - 100``, so the CLI's defaults always meet one).
    Wherever the JAX function returns, the lines are the same; where it
    raises, this prints the pileup of the reads that do cover the SNP
    (documented divergence)."""
    resolve_device(conf.device)
    region = {sequence: (snp - 1000, snp + 1000)}
    dataset = ReadsDataset(
        source, [readset], ReadsPartitioner(region, FixedSplits(1))
    )
    covering = [
        read
        for _, read in dataset
        if read.position <= snp < read.position + len(read.aligned_sequence)
    ]
    first = min((r.position for r in covering), default=999999999)
    out = []
    out.append(" " * (snp - first) + "v")
    for read in covering:
        i = snp - read.position
        head, tail = read.aligned_sequence[: i + 1], read.aligned_sequence[i + 1 :]
        q = "%02d" % read.aligned_quality[i]
        out.append(" " * (read.position - first) + head + "(" + q + ") " + tail)
    out.append(" " * (snp - first) + "^")
    for line in out:
        print(line)
    return out


def run_example2(
    conf: GenomicsConf,
    source: GenomicsSource,
    sequence: str = "21",
    region: Optional[Tuple[int, int]] = None,
    readset: str = Examples.GOOGLE_EXAMPLE_READSET,
) -> float:
    """Mean coverage of a chromosome (``SearchReadsExample.scala:116-135``):
    Σ aligned-sequence lengths / sequence length, one device reduce per
    shard (a torch ``.sum()`` on the run's device)."""
    device = resolve_device(conf.device)
    length = Examples.HUMAN_CHROMOSOMES[sequence]
    if region is None:
        region = (1, length)
    dataset = ReadsDataset(
        source,
        [readset],
        ReadsPartitioner(
            {sequence: region}, TargetSizeSplits(100, 5, 1024, 16 * 1024 * 1024)
        ),
    )
    total = 0
    for _, shard in dataset.iter_shards():
        if shard:
            lengths = torch.tensor(
                [len(read.aligned_sequence) for _, read in shard],
                dtype=torch.int32, device=device,
            )
            # One scalar fetch per shard: the running total is host state
            # and shards arrive serially from the paged source.
            total += int(lengths.sum())
    coverage = total / float(length)
    print(f"Coverage of chromosome {sequence} = {coverage}")
    return coverage


def _shard_reads_arrays(
    records: Sequence[Tuple[object, Read]],
) -> Tuple[np.ndarray, np.ndarray]:
    positions = np.asarray([r.position for _, r in records], dtype=np.int32)
    lengths = np.asarray(
        [len(r.aligned_sequence) for _, r in records], dtype=np.int32
    )
    return positions, lengths


def run_example3(
    conf: GenomicsConf,
    source: GenomicsSource,
    sequence: str = "21",
    region: Optional[Tuple[int, int]] = None,
    readset: str = Examples.GOOGLE_EXAMPLE_READSET,
) -> str:
    """Per-base read depth (``SearchReadsExample.scala:140-167``): dense
    scatter-add per shard with boundary carry; ``(pos,depth)`` lines for
    covered positions stream, ascending, through the bounded per-site
    writer into ``coverage_<chr>/part-00000`` (the reference's
    ``saveAsTextFile`` bytes, headerless) — peak host memory is O(shard
    window), never O(region). Returns the part-file path."""
    device = resolve_device(conf.device)
    out_path = conf.output_path or "."
    length = Examples.HUMAN_CHROMOSOMES[sequence]
    if region is None:
        region = (1, length)
    dataset = ReadsDataset(
        source,
        [readset],
        ReadsPartitioner(
            {sequence: region}, TargetSizeSplits(100, 5, 1024, 16 * 1024 * 1024)
        ),
    )
    part_path = os.path.join(out_path, f"coverage_{sequence}", "part-00000")
    carry = np.zeros(0, dtype=np.int64)
    carry_start = None
    # Each shard's covered (pos,depth) rows stream straight into the
    # bounded writer — the whole-region in-memory line list (the last
    # hostmem(unbounded) surface of analyses/) is retired.
    with SiteOutputWriter(part_path) as writer:
        for part, shard in dataset.iter_shards():
            span = int(part.end - part.start)
            positions = lengths = None
            read_pad = 64
            if shard:
                positions, lengths = _shard_reads_arrays(shard)
                read_pad = _pad_read_length(int(lengths.max()))
            # The window covers the shard span plus the longest read's
            # overhang (and any carry from the previous shard) — no
            # truncation cap.
            overhang = carry_start + len(carry) - part.start if carry_start is not None else 0
            window = max(span + read_pad, int(overhang))
            # Fresh per-shard window (O(window), reset every iteration — the
            # carry below is the only state crossing shards).
            if shard:
                counts = (
                    depth_counts(  # graftcheck: disable=GC001 -- deliberate per-shard fetch: the depth window is host state and shards arrive serially from the paged source; there is no launch pipeline to stall
                        torch.from_numpy(positions).to(device),
                        torch.from_numpy(lengths).to(device),
                        int(part.start),
                        window,
                        read_pad,
                    )
                    .cpu()
                    .numpy()
                    .astype(np.int64)
                )
            else:
                counts = np.zeros(window, dtype=np.int64)
            if carry_start is not None and len(carry):
                off = carry_start - part.start
                lo, hi = max(0, off), min(window, off + len(carry))
                if hi > lo:
                    counts[lo:hi] += carry[lo - off : hi - off]
            covered = np.nonzero(counts[:span] > 0)[0]
            writer.write_rows(
                (f"({part.start + i},{counts[i]})",) for i in covered
            )
            carry = counts[span:].copy()
            carry_start = part.end
        if carry_start is not None:
            writer.write_rows(
                (f"({carry_start + i},{carry[i]})",)
                for i in np.nonzero(carry > 0)[0]
            )
    return part_path


def _base_frequencies(
    source: GenomicsSource,
    readsets: List[str],
    partitioner: ReadsPartitioner,
    sequence: str,
    region: Tuple[int, int],
    min_mapping_quality: int,
    min_base_quality: int,
    device: torch.device,
) -> Dict[int, np.ndarray]:
    """Position → per-base counts (the ``freqRDD`` construction,
    ``SearchReadsExample.scala:219-244``), scatter-added per shard on device
    with boundary carry."""
    dataset = ReadsDataset(source, readsets, partitioner)
    result: Dict[int, np.ndarray] = {}
    carry = np.zeros((0, len(BASES)), dtype=np.int64)
    carry_start = None
    for part, shard in dataset.iter_shards():
        span = int(part.end - part.start)
        kept = [r for _, r in shard if r.mapping_quality >= min_mapping_quality]
        L = max((len(r.aligned_sequence) for r in kept), default=0)
        read_pad = _pad_read_length(L) if kept else 64
        overhang = carry_start + len(carry) - part.start if carry_start is not None else 0
        window = max(span + read_pad, int(overhang))
        # Fresh per-shard window (O(window); the carry is the only state
        # crossing shards) — the device scatter-add result, or zeros when
        # no read passed the mapping-quality gate.
        if kept:
            positions = np.asarray([r.position for r in kept], dtype=np.int32)
            codes = np.full((len(kept), L), -1, dtype=np.int8)
            qual_ok = np.zeros((len(kept), L), dtype=bool)
            for i, read in enumerate(kept):
                seq = read.aligned_sequence
                codes[i, : len(seq)] = encode_bases(seq)
                # Base-quality gate (``SearchReadsExample.scala:228``): index
                # must exist in alignedQuality and pass the threshold.
                nq = min(len(read.aligned_quality), len(seq))
                qual_ok[i, :nq] = (
                    np.asarray(read.aligned_quality[:nq]) >= min_base_quality
                )
            counts = (
                base_counts(  # graftcheck: disable=GC001 -- deliberate per-shard fetch: the base counts are host state and shards arrive serially from the paged source; there is no launch pipeline to stall
                    torch.from_numpy(positions).to(device),
                    torch.from_numpy(codes).to(device),
                    torch.from_numpy(qual_ok).to(device),
                    int(part.start),
                    window,
                )
                .cpu()
                .numpy()
                .astype(np.int64)
            )
        else:
            counts = np.zeros((window, len(BASES)), dtype=np.int64)
        if carry_start is not None and len(carry):
            off = carry_start - part.start
            lo, hi = max(0, off), min(window, off + len(carry))
            if hi > lo:
                counts[lo:hi] += carry[lo - off : hi - off]
        covered = np.nonzero(counts[:span].sum(axis=1) > 0)[0]
        for i in covered:
            result[part.start + int(i)] = counts[i].copy()
        carry = counts[span:].copy()
        carry_start = part.end
    if carry_start is not None:
        for i in np.nonzero(carry.sum(axis=1) > 0)[0]:
            result[carry_start + int(i)] = carry[i].copy()
    return result


def run_example4(
    conf: GenomicsConf,
    source: GenomicsSource,
    sequence: str = "1",
    region: Tuple[int, int] = (100_000_000, 101_000_000),
    normal_readset: str = Examples.GOOGLE_DREAM_SET3_NORMAL,
    tumor_readset: str = Examples.GOOGLE_DREAM_SET3_TUMOR,
    min_mapping_quality: int = 30,
    min_base_quality: int = 30,
    min_freq: float = 0.25,
) -> List[str]:
    """Tumor/normal base-frequency comparison
    (``SearchReadsExample.scala:174-307``): per-position frequent-base sets
    from both readsets, join on position, keep differing sets; saved as
    ``(pos,(normalBases,tumorBases))`` lines under ``diff_<chr>``."""
    device = resolve_device(conf.device)
    out_path = conf.output_path or "."
    partitioner = ReadsPartitioner(
        {sequence: region}, TargetSizeSplits(100, 30, 1024, 16 * 1024 * 1024)
    )
    normal = _base_frequencies(
        source, [normal_readset], partitioner, sequence, region,
        min_mapping_quality, min_base_quality, device,
    )
    tumor = _base_frequencies(
        source, [tumor_readset], partitioner, sequence, region,
        min_mapping_quality, min_base_quality, device,
    )

    def frequent(counts: np.ndarray) -> str:
        total = counts.sum()
        if total == 0:
            return ""
        return "".join(
            sorted(
                BASES[i]
                for i in range(len(BASES))
                if counts[i] / total >= min_freq
            )
        )

    lines = []
    for pos in sorted(set(normal) & set(tumor)):
        a, b = frequent(normal[pos]), frequent(tumor[pos])
        if a != b:
            lines.append(f"({pos},({a},{b}))")
    _write_part_file(os.path.join(out_path, f"diff_{sequence}"), lines)
    return lines


__all__ = ["run_example1", "run_example2", "run_example3", "run_example4"]
