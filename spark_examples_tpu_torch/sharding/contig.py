"""Genomic coordinate ranges ("contigs") and their shard math.

The reference delegates this to ``com.google.cloud.genomics.utils.Contig``
(used at ``rdd/VariantsRDD.scala:252-262`` and ``GenomicsConf.scala:59-97``);
the behavior reimplemented here:

- a contig is ``reference_name:[start, end)``;
- ``get_shards(bases_per_shard)`` splits it into fixed-base windows — the
  reference's long-axis ("sequence length") scaling mechanism: whole-genome
  scale means more windows, not bigger ones (``README.md:134-135``);
- ``parse_contigs`` parses the ``--references`` grammar
  ``ref:start:end,ref:start:end,...`` (``GenomicsConf.scala:40-43``);
- ``SexChromosomeFilter.EXCLUDE_XY`` supports ``--all-references``
  (``GenomicsConf.scala:66-73``).

In the port, shard windows drive the page and partition accounting of
the "Variants API stats" epilogue; the device walks the site grid itself.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, List

#: Default shard width, matching genomics-utils
#: ``Contig.DEFAULT_NUMBER_OF_BASES_PER_SHARD`` (used via
#: ``GenomicsConf.scala:30-32``).
DEFAULT_BASES_PER_SHARD = 1_000_000

#: The default --references value (``GenomicsConf.scala:40``): the BRCA1 gene.
BRCA1 = "17:41196311:41277499"


class SexChromosomeFilter(enum.Enum):
    """``Contig.SexChromosomeFilter`` (used at ``GenomicsConf.scala:26,67``)."""

    INCLUDE_XY = "include_xy"
    EXCLUDE_XY = "exclude_xy"


@dataclass(frozen=True, order=True)
class Contig:
    """A half-open coordinate range on a reference sequence."""

    reference_name: str
    start: int
    end: int

    @property
    def range(self) -> int:
        return self.end - self.start

    def get_shards(self, bases_per_shard: int = DEFAULT_BASES_PER_SHARD) -> List["Contig"]:
        """Split into fixed-width windows (``rdd/VariantsRDD.scala:256-261``)."""
        if bases_per_shard <= 0:
            raise ValueError(f"bases_per_shard must be positive, got {bases_per_shard}")
        shards = []
        pos = self.start
        while pos < self.end:
            shards.append(
                Contig(self.reference_name, pos, min(pos + bases_per_shard, self.end))
            )
            pos += bases_per_shard
        return shards


def parse_contigs(spec: str) -> List[Contig]:
    """Parse ``ref:start:end,...`` (``GenomicsConf.scala:40-43,59-63``)."""
    contigs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(
                f"bad contig spec {part!r}: expected reference:start:end"
            )
        contigs.append(Contig(fields[0], int(fields[1]), int(fields[2])))
    return contigs


_SEX_CHROMOSOMES = frozenset({"X", "Y", "chrX", "chrY", "x", "y"})


def filter_sex_chromosomes(
    contigs: Iterable[Contig], sex_filter: SexChromosomeFilter
) -> List[Contig]:
    """Drop X/Y when ``EXCLUDE_XY`` (the ``--all-references`` behavior,
    ``GenomicsConf.scala:83-97``)."""
    if sex_filter is SexChromosomeFilter.INCLUDE_XY:
        return list(contigs)
    return [c for c in contigs if c.reference_name not in _SEX_CHROMOSOMES]


__all__ = [
    "BRCA1",
    "DEFAULT_BASES_PER_SHARD",
    "Contig",
    "SexChromosomeFilter",
    "filter_sex_chromosomes",
    "parse_contigs",
]
