"""Partitioners: genomic ranges → independent shards ("partitions").

``VariantsPartitioner`` / ``VariantsPartition`` mirror
``rdd/VariantsRDD.scala:229-262``: each contig is split into fixed-base
windows, one partition per window, each carrying the search range for its
variant set. The port uses them for the per-shard page accounting of the
run's I/O statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

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


__all__ = [
    "VariantsPartition",
    "VariantsPartitioner",
]
