"""Sharded host-streaming datasets and the prefetching block feed.

The part of ``spark_examples_tpu/pipeline/datasets.py`` the wire and
packed ingest arms use. The reference's ``VariantsRDD`` is a lazy record
stream whose partitions are genomic ranges (``rdd/VariantsRDD.scala:
179-226``); here a :class:`VariantsDataset` pages each shard through the
source's client with STRICT boundaries in a bounded thread pool
(:func:`_parallel_shards`), and :class:`PrefetchIterator` hands packed
genotype blocks from a producer thread to the device feeder, so the host
builds block k+1 while the card works on block k. :class:`ReadsDataset`
pages read shards the same way for the reads examples
(``analyses/reads_examples.py``).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, TypeVar

from spark_examples_tpu_torch.models.read import Read, ReadBuilder, ReadKey
from spark_examples_tpu_torch.models.variant import Variant, VariantKey, VariantsBuilder
from spark_examples_tpu_torch.obs.metrics import (
    PREFETCH_QUEUE_DEPTH,
    PREFETCH_QUEUE_OCCUPANCY,
    well_known_gauge,
)
from spark_examples_tpu_torch.pipeline.stats import VariantsDatasetStats
from spark_examples_tpu_torch.sharding.partitioners import (
    ReadsPartition,
    ReadsPartitioner,
    VariantsPartition,
    VariantsPartitioner,
)
from spark_examples_tpu_torch.sources.base import GenomicsSource, ShardBoundary

T = TypeVar("T")


def _parallel_shards(
    partitions: Sequence[T],
    compute: Callable[[T], List],
    num_workers: int,
) -> Iterator[Tuple[T, List]]:
    """Compute shards in a thread pool, yielding in partition order, with
    at most ``num_workers + 2`` shards in flight ahead of the consumer."""
    if num_workers <= 1 or len(partitions) <= 1:
        for part in partitions:
            yield part, compute(part)
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_workers) as pool:
        window = num_workers + 2
        futures = {}
        next_submit = 0
        for i, part in enumerate(partitions):
            while next_submit < min(len(partitions), i + window):
                futures[next_submit] = pool.submit(compute, partitions[next_submit])
                next_submit += 1
            yield part, futures.pop(i).result()


class PrefetchIterator:
    """Bounded background-thread prefetch of an iterator — the hand-off
    between the block producer and the device feeder.

    The queue holds at most ``depth`` items (plus the one the producer is
    computing), so a slow feeder stalls the producer instead of letting
    blocks pile up in host memory. Exceptions from the source iterator
    re-raise at the consuming position. :meth:`overlap_stats` gives the
    producer-busy, producer-blocked and consumer-wait seconds: blocked time
    means the device feed is the bottleneck, wait time means the producer
    is. ``registry`` gets the queue's depth and live occupancy gauges and,
    on :meth:`close`, the overlap gauges; ``spans`` a ``chunk-parse``
    aggregate span. Always :meth:`close` it (in a ``finally``), or its
    thread outlives a failed run.
    """

    _DONE = object()

    def __init__(self, iterable, depth: int = 2, registry=None, spans=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._registry = registry
        self._spans = spans
        self._published = False
        self.producer_seconds = 0.0
        self.producer_blocked_seconds = 0.0
        self.consumer_wait_seconds = 0.0
        self.items = 0
        self._occupancy_gauge = None
        if registry is not None:
            well_known_gauge(registry, PREFETCH_QUEUE_DEPTH).set(self.depth)
            self._occupancy_gauge = well_known_gauge(registry, PREFETCH_QUEUE_OCCUPANCY)
            self._occupancy_gauge.set_function(self._queue.qsize)
        self._thread = threading.Thread(
            target=self._run, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _run(self, it) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                self.producer_seconds += t1 - t0
                self._put(item)
                self.producer_blocked_seconds += time.perf_counter() - t1
        except BaseException as e:  # surfaced from __next__
            self._error = e
        finally:
            # close() may have filled the queue already; drop the sentinel
            # rather than deadlock on a full queue nobody will drain.
            try:
                self._queue.put_nowait(self._DONE)
            except queue.Full:
                pass

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # The producer exited, perhaps after this get() timed
                    # out with its last item (or the sentinel) now queued:
                    # one non-blocking drain sees everything.
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        item = self._DONE
                    break
        self.consumer_wait_seconds += time.perf_counter() - t0
        if item is self._DONE:
            if self._error is not None:
                error, self._error = self._error, None
                raise error
            raise StopIteration
        self.items += 1
        return item

    def close(self) -> None:
        """Stop the producer and release its thread (idempotent); publish
        the final overlap numbers to the registry and span recorder once."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._occupancy_gauge is not None:
            # Freeze the live gauge so the registry drops the dead queue.
            self._occupancy_gauge.set(self._queue.qsize())
        if self._published:
            return
        self._published = True
        stats = self.overlap_stats()
        if self._registry is not None:
            for name, help_text in (
                ("parse_busy_seconds", "Producer time spent building blocks."),
                (
                    "parse_blocked_on_feed_seconds",
                    "Producer time blocked on the full queue (device feed "
                    "is the bottleneck).",
                ),
                (
                    "feeder_waited_on_parse_seconds",
                    "Consumer time waiting on the empty queue (the producer "
                    "is the bottleneck).",
                ),
            ):
                self._registry.gauge(f"ingest_overlap_{name}", help_text).set(stats[name])
            self._registry.counter(
                "prefetch_blocks_total", "Blocks that passed through the prefetch queue."
            ).inc(stats["blocks"])
        if self._spans is not None:
            self._spans.add("chunk-parse", stats["parse_busy_seconds"])

    def overlap_stats(self) -> dict:
        """Structured ingest/compute overlap accounting."""
        return {
            "parse_busy_seconds": self.producer_seconds,
            "parse_blocked_on_feed_seconds": self.producer_blocked_seconds,
            "feeder_waited_on_parse_seconds": self.consumer_wait_seconds,
            "blocks": self.items,
            "queue_depth": self.depth,
        }

    def overlap_report(self) -> str:
        """One line of ingest/compute overlap accounting (the stdout form
        of :meth:`overlap_stats` that ``--profile-dir`` prints, in the
        reference's format)."""
        stats = self.overlap_stats()
        return (
            f"ingest overlap: parse {stats['parse_busy_seconds']:.3f}s busy, "
            f"{stats['parse_blocked_on_feed_seconds']:.3f}s blocked on device feed "
            f"(backpressure); feeder waited {stats['feeder_waited_on_parse_seconds']:.3f}s "
            f"on parse; {stats['blocks']} blocks through a depth-{stats['queue_depth']} queue"
        )


class VariantsDataset:
    """A sharded stream of ``(VariantKey, Variant)`` records
    (``rdd/VariantsRDD.scala:179-226``)."""

    def __init__(
        self,
        source: GenomicsSource,
        variant_set_id: str,
        partitioner: VariantsPartitioner,
        stats: Optional[VariantsDatasetStats] = None,
        num_workers: int = 8,
    ):
        self.source = source
        self.variant_set_id = variant_set_id
        self.partitioner = partitioner
        self.stats = stats
        self.num_workers = num_workers

    def partitions(self) -> List[VariantsPartition]:
        return self.partitioner.get_partitions(self.variant_set_id)

    def compute(self, partition: VariantsPartition) -> List[Tuple[VariantKey, Variant]]:
        """Stream one shard (``rdd/VariantsRDD.scala:198-225``): open a fresh
        client, page with STRICT boundaries, build records (dropping
        non-normalizable contigs), then flush counters into stats."""
        client = self.source.client()
        records: List[Tuple[VariantKey, Variant]] = []
        n_seen = 0
        for wire in client.search_variants(
            partition.get_variants_request(), ShardBoundary.STRICT
        ):
            n_seen += 1
            built = VariantsBuilder.build(wire)
            if built is not None:
                records.append(built)
        if self.stats is not None:
            self.stats.add_variants(n_seen)
            self.stats.add_partition(partition.range)
            self.stats.add_client(client.counters)
        return records

    def iter_shards(self) -> Iterator[Tuple[VariantsPartition, List[Tuple[VariantKey, Variant]]]]:
        yield from _parallel_shards(self.partitions(), self.compute, self.num_workers)

    def __iter__(self) -> Iterator[Tuple[VariantKey, Variant]]:
        for _, records in self.iter_shards():
            yield from records

    def variants(self) -> Iterator[Variant]:
        """Values only — the ``.map(_._2)`` at ``VariantsPca.scala:122``."""
        for _, variant in self:
            yield variant


class ReadsDataset:
    """A sharded stream of ``(ReadKey, Read)`` records
    (``rdd/ReadsRDD.scala:93-118``)."""

    def __init__(
        self,
        source: GenomicsSource,
        read_group_set_ids: Sequence[str],
        partitioner: ReadsPartitioner,
        num_workers: int = 8,
    ):
        self.source = source
        self.read_group_set_ids = list(read_group_set_ids)
        self.partitioner = partitioner
        self.num_workers = num_workers

    def partitions(self) -> List[ReadsPartition]:
        return self.partitioner.get_partitions(self.read_group_set_ids)

    def compute(self, partition: ReadsPartition) -> List[Tuple[ReadKey, Read]]:
        """One shard: a fresh client pages the reads STARTING in the
        partition's range (STRICT), so each read lands in one shard."""
        client = self.source.client()
        return [
            ReadBuilder.build(wire)
            for wire in client.search_reads(
                partition.get_reads_request(), ShardBoundary.STRICT
            )
        ]

    def iter_shards(self) -> Iterator[Tuple[ReadsPartition, List[Tuple[ReadKey, Read]]]]:
        yield from _parallel_shards(self.partitions(), self.compute, self.num_workers)

    def __iter__(self) -> Iterator[Tuple[ReadKey, Read]]:
        for _, records in self.iter_shards():
            yield from records

    def reads(self) -> Iterator[Read]:
        for _, read in self:
            yield read


__all__ = ["PrefetchIterator", "ReadsDataset", "VariantsDataset"]
