"""Genomics source abstraction: the seam the reference never had.

The reference streams variants/reads from the live Google Genomics REST API
through ``Client`` + ``Paginator`` (``Client.scala:42-54``,
``rdd/VariantsRDD.scala:200-207``) and its authors noted the missing test seam
in-code (``SearchVariantsExample.scala:74-76``). Here the seam is first-class:

- :class:`GenomicsSource` — a backend (synthetic, REST, file) that can open
  per-partition :class:`GenomicsClient` sessions and answer driver-side
  metadata queries (callsets, contigs).
- :class:`GenomicsClient` — a per-partition session with the reference's I/O
  health counters (``initializedRequestsCount`` etc., ``Client.scala:50-54``),
  flushed into dataset stats when a shard's iterator is exhausted
  (``rdd/VariantsRDD.scala:192-196,214-224``).
- :class:`ShardBoundary` — ``Paginator.ShardBoundary`` semantics
  (``rdd/VariantsRDD.scala:201``): ``STRICT`` counts a record in exactly one
  shard (the one containing its start); ``OVERLAPS`` returns every record
  overlapping the range.
"""

from __future__ import annotations

import enum
import json
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

from spark_examples_tpu_torch.sharding.contig import Contig, SexChromosomeFilter


class ShardBoundary(enum.Enum):
    """``Paginator.ShardBoundary`` (used at ``rdd/VariantsRDD.scala:201``)."""

    STRICT = "strict"
    OVERLAPS = "overlaps"


@dataclass
class ClientCounters:
    """I/O health counters (``Client.scala:50-54``).

    Mutate through the ``add_*`` methods — the one place the counting
    semantics live (and the seam the graftcheck GC009 rule points ad-hoc
    ``counters.x += n`` sites at). Each client session is single-threaded
    (one per partition worker), so plain ints suffice; the aggregation
    into the registry-backed run stats happens at flush time
    (``pipeline/stats.py:add_client``).
    """

    initialized_requests: int = 0
    unsuccessful_responses: int = 0
    io_exceptions: int = 0
    retries: int = 0

    def add_request(self, n: int = 1) -> None:
        self.initialized_requests += n

    def add_unsuccessful_response(self, n: int = 1) -> None:
        self.unsuccessful_responses += n

    def add_io_exception(self, n: int = 1) -> None:
        self.io_exceptions += n

    def add_retry(self, n: int = 1) -> None:
        """One transient failure the client will retry after backoff —
        the manifest's transient-pressure signal (``io_retries_total``)."""
        self.retries += n


@dataclass(frozen=True)
class OfflineAuth:
    """A serializable auth token usable on workers (``Client.scala:32-40``)."""

    client_secrets_file: str
    access_token: Optional[str] = None


def get_access_token(
    client_secrets_file: str, application_name: str = "spark-examples-tpu"
) -> OfflineAuth:
    """``Authentication.getAccessToken`` (``Client.scala:33-39``).

    Reads the client-secrets file if present; the interactive OAuth prompt
    flow of the reference is not reproducible offline, so the token is
    whatever the secrets file carries (or None for the synthetic source,
    which needs no auth).
    """
    token = None
    try:
        with open(client_secrets_file) as f:
            secrets = json.load(f)
        token = secrets.get("access_token")
    except (OSError, ValueError):
        pass
    return OfflineAuth(client_secrets_file=client_secrets_file, access_token=token)


class GenomicsClient(ABC):
    """A per-partition session with request/failure counters."""

    def __init__(self) -> None:
        self.counters = ClientCounters()

    @abstractmethod
    def search_variants(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = 1024,
    ) -> Iterator[Dict]:
        """Yield variant wire-format dicts for a SearchVariants request
        (``rdd/VariantsRDD.scala:201-207``), counting one initialized request
        per page."""

    @abstractmethod
    def search_reads(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = 1024,
    ) -> Iterator[Dict]:
        """Yield read wire-format dicts for a SearchReads request
        (``rdd/ReadsRDD.scala:108-116``)."""


class GenomicsSource(ABC):
    """A genomics backend."""

    @abstractmethod
    def client(self) -> GenomicsClient:
        """Open a fresh session (one per partition, as in
        ``rdd/VariantsRDD.scala:200``)."""

    @abstractmethod
    def search_callsets(self, variant_set_ids: Sequence[str]) -> List[Dict]:
        """All callsets of the given variant sets, as ``{"id", "name"}`` dicts
        (``VariantsPca.scala:97-109``)."""

    @abstractmethod
    def get_contigs(
        self,
        variant_set_id: str,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.INCLUDE_XY,
    ) -> List[Contig]:
        """Contig bounds of a variant set
        (``Contig.getContigsInVariantSet``, used at ``GenomicsConf.scala:88``)."""

    def declared_sites(self, contig: Contig) -> int:
        """The contig's declared candidate-site weight — the balance input
        of the host → contig-partition split
        (``sharding/contig.py:partition_contigs_by_host``). Base sources
        declare the base range (sites ∝ bases is the honest prior for
        real data); the synthetic source overrides with its exact
        site-grid span."""
        return max(0, contig.range)


__all__ = [
    "ShardBoundary",
    "ClientCounters",
    "OfflineAuth",
    "get_access_token",
    "GenomicsClient",
    "GenomicsSource",
]
