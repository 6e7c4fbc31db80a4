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
:func:`partition_contigs_by_host` / :func:`host_partition` split a run's
contigs over its processes for host-sharded ingest.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

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


def partition_contigs_by_host(
    contigs: Iterable[Contig],
    num_hosts: int,
    weight: Optional[Callable[[Contig], int]] = None,
) -> List[List[Contig]]:
    """The host → contig-partition split of host-sharded ingest (the
    reference's rule, ``spark_examples_tpu/sharding/contig.py``): every
    process of a run reads only its partition, and the merged Gramian is
    the one-process run's (``G += XᵀX`` commutes over any split of the
    rows).

    - Contigs are walked in the given order, never reordered or split:
      partitions are contiguous runs whose concatenation is the list.
    - ``weight(contig)`` declares each contig's sites (default: its base
      range). Host ``h`` closes its partition once the cumulative weight
      reaches the fair-share boundary ``(h+1)·total/H``, compared in exact
      integers (``cum·H >= (h+1)·total``).
    - A contig landing exactly on a boundary closes the earlier host.
    - Zero-weight contigs ride the partition open at their position; when
      every weight is zero, one contig a host in order (extras on the
      last).
    - One giant contig may cover several fair shares: the hosts it covers
      get empty partitions (their partial Gramian is zero).

    Pure integer arithmetic over the shared list: every process computes
    the same split without a collective."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    ordered = list(contigs)
    weigh = weight if weight is not None else (lambda c: max(0, c.range))
    weights = [int(weigh(c)) for c in ordered]
    for c, w in zip(ordered, weights):
        if w < 0:
            raise ValueError(
                f"negative declared weight {w} for contig "
                f"{c.reference_name}:{c.start}:{c.end}"
            )
    total = sum(weights)
    parts: List[List[Contig]] = [[] for _ in range(num_hosts)]
    if total == 0:
        for i, c in enumerate(ordered):
            parts[min(i, num_hosts - 1)].append(c)
        return parts
    host = cum = 0
    for c, w in zip(ordered, weights):
        parts[host].append(c)
        cum += w
        while host < num_hosts - 1 and cum * num_hosts >= (host + 1) * total:
            host += 1
    return parts


def host_partition(
    contigs: Iterable[Contig],
    process_index: int,
    process_count: int,
    weight: Optional[Callable[[Contig], int]] = None,
) -> List[Contig]:
    """Process ``process_index``'s slice of :func:`partition_contigs_by_host`
    over ``process_count`` processes."""
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} outside [0, {process_count})"
        )
    return partition_contigs_by_host(contigs, process_count, weight)[process_index]


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
    "host_partition",
    "parse_contigs",
    "partition_contigs_by_host",
]
