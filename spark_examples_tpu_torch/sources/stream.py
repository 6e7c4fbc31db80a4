"""Streaming merge-join over key-sorted record streams.

The part of ``spark_examples_tpu/sources/stream.py`` the wire ingest's
multi-set joins use (``pipeline/pca_driver.py:iter_calls``): the k-way
:func:`merge_join`, its :class:`MergeJoinStats`, and the
:class:`UnsortedStreamError` it raises. The windowed file readers wait for
file ingest.
"""

from __future__ import annotations

import heapq
from typing import Any, Iterator, List, Optional, Sequence, Tuple


class UnsortedStreamError(ValueError):
    """A single-pass consumer met records out of key-sorted order."""


class MergeJoinStats:
    """Observability for :func:`merge_join`'s bounded-window claim: the
    peak number of records tracked at once (one key group: ≤ k × per-key
    duplicates) and the group count."""

    def __init__(self) -> None:
        self.peak_tracked = 0
        self.groups = 0

    def add_group(self, tracked: int) -> None:
        """Account one emitted key group holding ``tracked`` records."""
        self.groups += 1
        if tracked > self.peak_tracked:
            self.peak_tracked = tracked


def merge_join(
    streams: Sequence[Iterator[Tuple[Any, Any]]],
    stats: Optional[MergeJoinStats] = None,
) -> Iterator[Tuple[Any, List[List[Any]]]]:
    """Streaming k-way merge-join over key-sorted ``(key, record)``
    streams: yields ``(key, per_stream_records)`` for every key present in
    ANY stream, keys ascending, holding exactly one key group in memory.

    Each stream must be non-decreasing in key (checked;
    :class:`UnsortedStreamError` on regression). Join policy — inner,
    intersection, count thresholds — is the caller's: every per-stream
    list is present (possibly empty), so any policy is a filter over the
    yielded groups."""
    k = len(streams)
    iters = [iter(s) for s in streams]
    heap: List[Tuple[Any, int, Any]] = []
    last_key: List[Optional[Any]] = [None] * k
    for i, it in enumerate(iters):
        for key, record in it:
            heap.append((key, i, record))
            last_key[i] = key
            break
    heapq.heapify(heap)

    def _pull(i: int) -> None:
        for key, record in iters[i]:
            prev = last_key[i]
            if prev is not None and key < prev:
                raise UnsortedStreamError(
                    f"merge_join: stream {i} key {key!r} regressed below "
                    f"{prev!r} — merge-join needs key-sorted streams"
                )
            last_key[i] = key
            heapq.heappush(heap, (key, i, record))
            break

    while heap:
        group_key = heap[0][0]
        group: List[List[Any]] = [[] for _ in range(k)]
        tracked = 0
        while heap and heap[0][0] == group_key:
            _, i, record = heapq.heappop(heap)
            group[i].append(record)
            tracked += 1
            _pull(i)
        if stats is not None:
            stats.add_group(tracked)
        yield group_key, group


__all__ = ["MergeJoinStats", "UnsortedStreamError", "merge_join"]
