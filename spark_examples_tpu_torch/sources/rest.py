"""Google Genomics v1beta2 REST backend (``--source rest``).

The port's copy of ``spark_examples_tpu/sources/rest.py``: the real-API
counterpart of the reference's ``Client`` + ``Paginator``
(``Client.scala:42-54``; paging loop behavior of
``Paginator.Variants.create(...).search(req)`` at
``rdd/VariantsRDD.scala:201-207``): POST search requests, follow
``nextPageToken`` until exhausted, apply the shard-boundary filter
client-side, and count requests / unsuccessful responses / IO exceptions.

The v1beta2 API itself has been sunset, so this backend exists for
API-shape parity and for deployments that point ``base_url`` at a live,
compatible endpoint (e.g. a GA4GH-style server). All logic except the actual socket I/O is exercised by unit tests
via an injectable ``transport`` callable; every transport attempt passes
the ``rest.post`` fault point, and transient failures retry with the
shared backoff (``utils/retry.py``). The source's records feed the wire
ingest arm of ``variants-pca``.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence

from spark_examples_tpu_torch.sharding.contig import Contig, SexChromosomeFilter, filter_sex_chromosomes
from spark_examples_tpu_torch.sources.base import (
    GenomicsClient,
    GenomicsSource,
    OfflineAuth,
    ShardBoundary,
)
from spark_examples_tpu_torch.sources.stream import StreamBudgetError, windowed
from spark_examples_tpu_torch.utils import faults
from spark_examples_tpu_torch.utils.retry import (
    full_jitter_delay,
    retry_after_seconds,
)

DEFAULT_BASE_URL = "https://www.googleapis.com/genomics/v1beta2"

#: transport(url, payload_dict, headers) -> response_dict
Transport = Callable[[str, Mapping, Mapping], Dict]


def _urllib_transport(url: str, payload: Mapping, headers: Mapping) -> Dict:
    data = json.dumps(payload).encode("utf-8")
    request = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json", **headers}
    )
    with urllib.request.urlopen(request, timeout=60) as response:
        return json.loads(response.read().decode("utf-8"))


def _retryable_http(code: int) -> bool:
    """5xx and 429 (rate-limit) are transient; other 4xx are caller errors
    that no retry can fix (a bad variant-set id stays bad)."""
    return code >= 500 or code == 429


class RestClient(GenomicsClient):
    def __init__(
        self,
        auth: Optional[OfflineAuth],
        base_url: str = DEFAULT_BASE_URL,
        transport: Transport = _urllib_transport,
        max_retries: int = 3,
        backoff_base: float = 0.5,
        backoff_cap: float = 8.0,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ):
        super().__init__()
        self.auth = auth
        self.base_url = base_url.rstrip("/")
        self.transport = transport
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()

    def _headers(self) -> Dict[str, str]:
        if self.auth and self.auth.access_token:
            return {"Authorization": f"Bearer {self.auth.access_token}"}
        return {}

    def _post(self, path: str, payload: Mapping) -> Dict:
        """POST with retries for transient failures only: exponential backoff
        with full jitter (the shared ``utils/retry.py`` arithmetic — delay
        uniform in ``[0, min(cap, base·2^attempt)]``) for 5xx/429/IO errors;
        a server-sent ``Retry-After`` on 429/503 is honored instead, capped
        by ``backoff_cap`` so a hostile or broken header can never park the
        pipeline. Non-retryable 4xx raises immediately. Every attempt and
        failure feeds the reference's accounting counters
        (``Client.scala:42-54``; report format ``pipeline/stats.py``), and
        every backoff counts into ``retries`` → the manifest's
        ``io_retries`` transient-pressure field."""
        url = f"{self.base_url}/{path}"
        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries):
            self.counters.add_request()
            delay: Optional[float] = None
            try:
                # Registered IO fault boundary: one transport attempt
                # (ioerror here exercises this very retry loop).
                faults.io_point("rest.post")
                return self.transport(url, payload, self._headers())
            except urllib.error.HTTPError as e:
                self.counters.add_unsuccessful_response()
                if not _retryable_http(e.code):
                    raise RuntimeError(
                        f"request to {url} failed with HTTP {e.code} "
                        "(not retryable)"
                    ) from e
                last_error = e
                if e.code in (429, 503):
                    delay = retry_after_seconds(e.headers, self.backoff_cap)
            except (urllib.error.URLError, OSError) as e:
                self.counters.add_io_exception()
                last_error = e
            if attempt + 1 < self.max_retries:
                self.counters.add_retry()
                if delay is None:
                    delay = full_jitter_delay(
                        attempt, self.backoff_base, self.backoff_cap, self._rng
                    )
                self._sleep(delay)
        raise RuntimeError(f"request to {url} failed after retries") from last_error

    def _paginate(
        self, path: str, request: Mapping, items_field: str, page_size: int
    ) -> Iterator[Dict]:
        """One page resident at a time — the REST arm of the windowed
        stream discipline (``sources/stream.py``): each decoded page is
        re-yielded through :func:`windowed` (window = the requested page
        size), and a server page more than 4x the requested size raises
        :class:`StreamBudgetError` — a misbehaving server must fail
        loudly, not silently inflate host residency past the bound the
        prover charged for this source."""
        payload = dict(request)
        payload["pageSize"] = page_size
        token: Optional[str] = None
        while True:
            if token is not None:
                payload["pageToken"] = token
            response = self._post(path, payload)
            items = response.get(items_field, [])
            if len(items) > 4 * page_size:
                raise StreamBudgetError(
                    f"{path}: server returned {len(items)} items against "
                    f"pageSize {page_size} (>4x) — refusing to stage an "
                    "unbounded page on host"
                )
            for window in windowed(items, page_size):
                for item in window:
                    yield item
            token = response.get("nextPageToken")
            if not token:
                return

    def search_variants(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = 1024,
    ) -> Iterator[Dict]:
        start = int(request.get("start", 0))
        end = int(request.get("end", 1 << 62))
        for variant in self._paginate("variants/search", request, "variants", page_size):
            if boundary is ShardBoundary.STRICT:
                if not (start <= int(variant["start"]) < end):
                    continue
            yield variant

    def search_reads(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = 256,
    ) -> Iterator[Dict]:
        start = int(request.get("start", 0))
        end = int(request.get("end", 1 << 62))
        for read in self._paginate("reads/search", request, "alignments", page_size):
            position = int(read["alignment"]["position"]["position"])
            if boundary is ShardBoundary.STRICT and not (start <= position < end):
                continue
            yield read


class RestGenomicsSource(GenomicsSource):
    """The REST backend as a source: one :class:`RestClient` per partition
    (``client``), driver-side callset and contig discovery. ``sleep`` is the
    clients' backoff sleep (injectable, as ``RestClient``'s)."""

    def __init__(
        self,
        auth: Optional[OfflineAuth] = None,
        base_url: str = DEFAULT_BASE_URL,
        transport: Transport = _urllib_transport,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.auth = auth
        self.base_url = base_url
        self.transport = transport
        self.sleep = sleep

    def client(self) -> RestClient:
        return RestClient(self.auth, self.base_url, self.transport, sleep=self.sleep)

    def search_callsets(self, variant_set_ids: Sequence[str]) -> List[Dict]:
        """Driver-side callset fetch (``VariantsPca.scala:97-109``)."""
        client = self.client()
        return [
            {"id": cs["id"], "name": cs.get("name")}
            for cs in client._paginate(
                "callsets/search",
                {"variantSetIds": list(variant_set_ids)},
                "callSets",
                1024,
            )
        ]

    def get_contigs(
        self,
        variant_set_id: str,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.INCLUDE_XY,
    ) -> List[Contig]:
        """``Contig.getContigsInVariantSet`` over the variant-set metadata's
        ``referenceBounds`` (used at ``GenomicsConf.scala:88``)."""
        client = self.client()
        response = client._post(f"variantsets/{variant_set_id}", {})
        contigs = [
            Contig(b["referenceName"], 0, int(b["upperBound"]))
            for b in response.get("referenceBounds", [])
        ]
        return filter_sex_chromosomes(contigs, sex_filter)


__all__ = ["RestClient", "RestGenomicsSource", "DEFAULT_BASE_URL"]
