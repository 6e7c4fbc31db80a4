"""Partitioners: genomic ranges → independent shards ("partitions").

``VariantsPartitioner`` / ``VariantsPartition`` mirror
``rdd/VariantsRDD.scala:229-262``: each contig is split into fixed-base
windows, one partition per window, each carrying the search range for its
variant set. The port uses them for the per-shard page accounting of the
run's I/O statistics.

``ReadsPartitioner`` / ``ReadsPartition`` mirror
``rdd/ReadsPartitioner.scala:24-64``: a ``{sequence: (start, end)}`` map is
split per-sequence by a pluggable :class:`SequenceSplitter` policy
(``FixedSplits`` / ``TargetSizeSplits``, ``rdd/ReadsPartitioner.scala:69-90``),
with a stable sequence→starting-partition offset table so partition indices
are globally unique and ordered by sequence name.

``ReadsPartitioner.get_partition`` maps a ``ReadKey`` to its partition index.
The reference's formula (``rdd/ReadsPartitioner.scala:44``) divides by
``len / position`` using the *absolute* position, which misassigns keys for
ranges not starting at 0; like the JAX package, the port implements the
intended inverse of ``get_partitions``' span layout instead (documented
divergence — bug fix).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from spark_examples_tpu_torch.sharding.contig import Contig, DEFAULT_BASES_PER_SHARD


@dataclass(frozen=True)
class VariantsPartition:
    """A search range over a contig (``rdd/VariantsRDD.scala:232-240``)."""

    index: int
    variant_set_id: str
    contig: Contig

    def get_variants_request(self) -> Dict:
        """The SearchVariants request body for this shard
        (``rdd/VariantsRDD.scala:235-237``)."""
        return {
            "variantSetIds": [self.variant_set_id],
            "referenceName": self.contig.reference_name,
            "start": self.contig.start,
            "end": self.contig.end,
        }

    @property
    def range(self) -> int:
        return self.contig.range


class VariantsPartitioner:
    """Contigs → fixed-base-window partitions (``rdd/VariantsRDD.scala:252-262``)."""

    def __init__(
        self,
        contigs: Sequence[Contig],
        bases_per_partition: int = DEFAULT_BASES_PER_SHARD,
    ):
        self.contigs = list(contigs)
        self.bases_per_partition = int(bases_per_partition)

    def get_partitions(self, variant_set_id: str) -> List[VariantsPartition]:
        shards = [
            shard
            for contig in self.contigs
            for shard in contig.get_shards(self.bases_per_partition)
        ]
        return [
            VariantsPartition(index, variant_set_id, shard)
            for index, shard in enumerate(shards)
        ]


class SequenceSplitter:
    """How a sequence should be partitioned (``rdd/ReadsPartitioner.scala:69-71``)."""

    def splits(self, sequence_length: int) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class FixedSplits(SequenceSplitter):
    """A fixed number of partitions (``rdd/ReadsPartitioner.scala:76-78``)."""

    num_splits: int

    def splits(self, sequence_length: int) -> int:
        return int(min(sequence_length, self.num_splits))


@dataclass(frozen=True)
class TargetSizeSplits(SequenceSplitter):
    """Partition count from estimated data volume per base
    (``rdd/ReadsPartitioner.scala:84-90``): bytes ≈ (len / read_length) ×
    read_depth × read_size, divided into ``partition_size`` chunks."""

    read_length: int
    read_depth: int
    read_size: int
    partition_size: int

    def splits(self, sequence_length: int) -> int:
        return 1 + int(
            ((sequence_length // self.read_length) * self.read_depth * self.read_size)
            // (self.partition_size + 1)
        )


@dataclass(frozen=True)
class ReadsPartition:
    """A search range over a named sequence (``rdd/ReadsRDD.scala:123-128``)."""

    index: int
    read_group_set_ids: Tuple[str, ...]
    sequence: str
    start: int
    end: int

    def get_reads_request(self) -> Dict:
        """The SearchReads request body (``rdd/ReadsRDD.scala:111-115``)."""
        return {
            "readGroupSetIds": list(self.read_group_set_ids),
            "referenceName": self.sequence,
            "start": self.start,
            "end": self.end,
        }


class ReadsPartitioner:
    """Sequences → per-sequence span partitions (``rdd/ReadsPartitioner.scala:24-64``)."""

    def __init__(
        self,
        sequences: Dict[str, Tuple[int, int]],
        splitter: SequenceSplitter,
    ):
        self.sequences = dict(sequences)
        self.splitter = splitter
        # Sequence → partition count, ordered by sequence name (the reference
        # uses a TreeMap, ``rdd/ReadsPartitioner.scala:27-28``).
        self.parts: Dict[str, int] = {
            name: splitter.splits(rng[1] - rng[0])
            for name, rng in sorted(self.sequences.items())
        }
        # Total partition count (``:31``).
        self.count = sum(self.parts.values())
        # Sequence → starting partition index (``:34-35``).
        self.steps: Dict[str, int] = {}
        offset = 0
        for name, n in self.parts.items():
            self.steps[name] = offset
            offset += n

    @property
    def num_partitions(self) -> int:
        return self.count

    def get_partition(self, sequence: str, position: int) -> int:
        """Partition index owning ``position`` on ``sequence``.

        Intended inverse of :meth:`get_partitions`' span layout (the
        reference's formula at ``rdd/ReadsPartitioner.scala:44`` is broken for
        ranges not starting at 0 — see module docstring).
        """
        start, end = self.sequences[sequence]
        n = self.parts[sequence]
        span = (end - start) // n
        if span <= 0:
            return self.steps[sequence]
        i = min(n - 1, max(0, (position - start) // span))
        return self.steps[sequence] + int(i)

    def get_partitions(self, read_group_set_ids: Sequence[str]) -> List[ReadsPartition]:
        """All partitions for all sequences (``rdd/ReadsPartitioner.scala:50-63``).

        Matches the reference's layout exactly: each sequence's range is cut
        into ``n`` spans of ``(end - start) / n`` bases (integer division, so
        trailing remainder bases beyond ``start + n*span`` are dropped, as in
        the reference).
        """
        ids = tuple(read_group_set_ids)
        partitions = []
        for name, (start, end) in sorted(self.sequences.items()):
            idx = self.steps[name]
            n = self.parts[name]
            span = (end - start) // n
            for i in range(n):
                s = start + i * span
                partitions.append(ReadsPartition(idx, ids, name, s, s + span))
                idx += 1
        partitions.sort(key=lambda p: p.index)
        return partitions


__all__ = [
    "VariantsPartition",
    "VariantsPartitioner",
    "SequenceSplitter",
    "FixedSplits",
    "TargetSizeSplits",
    "ReadsPartition",
    "ReadsPartitioner",
]
