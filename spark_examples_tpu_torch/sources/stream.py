"""The windowed, contig-ordered stream abstraction every file read of the
port goes through (the port's copy of ``spark_examples_tpu/sources/
stream.py``).

- **Bounded windows + partial-record carry** (:func:`iter_byte_windows`,
  :func:`iter_text_lines`): a (possibly gzipped) file is read in
  ``window_bytes`` pieces cut at line boundaries, the partial last line
  carried into the next window. Peak residency is one window plus the
  longest record, never the file.
- **Sortedness probe** (:class:`SortednessProbe`): each contig's records
  contiguous and non-decreasing in position, checked as a single-pass
  consumer advances.
- **Budgeted accumulators** (:class:`ChunkedArrayBuilder`,
  :class:`SpooledRecordTable`): growth past the declared row capacity
  (:func:`wire_rows_bound`) raises :class:`StreamBudgetError` instead of
  allocating.
- **Streaming k-way merge-join** (:func:`merge_join`): multi-set joins
  hold one key group at a time.

The reference's read-fault injection point (``utils/faults.py``) waits for
the port's fault plans; the windows read the file directly.
"""

from __future__ import annotations

import gzip
import heapq
import json
import os
import struct
import tempfile
from typing import (
    Any,
    BinaryIO,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
)

import numpy as np

T = TypeVar("T")

#: Smallest honored window: guards zero/negative requests while letting
#: tests fuzz chunk boundaries with windows smaller than one line (the
#: carry handles lines longer than the window).
WINDOW_FLOOR_BYTES = 64

#: Default window for line-oriented readers that do not inherit a chunk
#: size from their caller (header scans, JSONL part files). Deliberately
#: small: decode + line split transiently hold ~3× the window, and the
#: streamed-ingest memory regression tests pin peak RSS to O(chunk).
DEFAULT_WINDOW_BYTES = 256 << 10

#: Floor on a well-formed wire data line: a minimal VCF data line is 8
#: single-character mandatory fields + 7 tabs + newline = 16 bytes; JSONL
#: and SAM minima are larger. ``decompressed_size / 16`` therefore bounds
#: the row count of ANY wire input — the closed-form row bound
#: ``conf_host_peak_bytes`` charges and the spooled tables enforce.
MIN_WIRE_LINE_BYTES = 16

#: Sound-by-contract cap on a gzip member's decompression ratio. Single
#: member archives < 4 GiB are sized EXACTLY from the ISIZE trailer (RFC
#: 1952); multi-member archives (bgzip) and ≥ 4 GiB streams fall back to
#: on-disk size × this ratio. Real VCF genotype matrices compress 10-30×;
#: DEFLATE's absolute maximum is ~1032×. 128 leaves a 4× margin over real
#: data while keeping the static bound finite — and the budgeted builders
#: enforce the same cap at runtime, so a pathological archive fails
#: loudly (:class:`StreamBudgetError`) instead of exceeding the proof.
GZ_DECOMPRESS_RATIO_BOUND = 128

#: Charged bytes per spooled-table index row: three int64 index columns
#: (start, offset, length — 24 B) plus build-time Python-int slack before
#: the arrays freeze. The records themselves live on disk.
SPOOL_INDEX_BYTES_PER_ROW = 128


class StreamBudgetError(RuntimeError):
    """A budgeted accumulator was asked to exceed its declared capacity —
    the runtime face of the closed-form row bound (:func:`wire_rows_bound`). The
    input violated a contract the bound was derived from (e.g. a gzip
    archive past :data:`GZ_DECOMPRESS_RATIO_BOUND`); the fix is the
    input, never a bigger silent allocation."""


class UnsortedStreamError(ValueError):
    """A single-pass consumer met records out of contig-contiguous,
    position-sorted order (see :class:`SortednessProbe`)."""


# --------------------------------------------------------------- file facts


def open_binary(path: str) -> BinaryIO:
    """The one opener: transparent gzip, binary mode. Every data-file
    handle in the port's ``sources/`` and ``pipeline/`` originates here."""
    if path.endswith(".gz"):
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def decompressed_size_bound(path: str) -> int:
    """Finite upper bound on ``path``'s decompressed byte size, from
    on-disk metadata alone (no data pass).

    Plain files: exact (``st_size``). ``.gz``: the RFC 1952 ISIZE trailer
    — exact for the standard single-member archive under 4 GiB — taken
    together with on-disk size × :data:`GZ_DECOMPRESS_RATIO_BOUND` so
    multi-member (bgzip) and ≥ 4 GiB streams stay soundly bounded. An
    unreadable path bounds at 0 (the caller layers its contract-level
    fallback)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if not path.endswith(".gz"):
        return int(size)
    isize = 0
    if size >= 18:  # minimal gzip member: 10B header + 8B trailer
        try:
            with open(path, "rb") as f:
                f.seek(-4, os.SEEK_END)
                (isize,) = struct.unpack("<I", f.read(4))
        except OSError:
            isize = 0
    return max(int(isize), int(size) * GZ_DECOMPRESS_RATIO_BOUND)


def wire_rows_bound(path: str) -> int:
    """Closed-form bound on the wire-record count of one input file:
    ``decompressed_size_bound / MIN_WIRE_LINE_BYTES``, plus one for a
    final unterminated line. 0-byte (or unreadable) paths bound at 1."""
    return decompressed_size_bound(path) // MIN_WIRE_LINE_BYTES + 1


# ---------------------------------------------------------------- windowing


def iter_byte_windows(path: str, window_bytes: int) -> Iterator[bytes]:
    """Stream a (possibly gzipped) text file in ~``window_bytes`` pieces
    that end at line boundaries — the partial last line carries into the
    next window, so concatenating the windows reproduces the decompressed
    bytes exactly and no record is ever split.

    Peak residency: one window + one carry (≤ the longest line). For
    ``.gz`` inputs decompression happens through gzip's windowed read —
    the compressed buffer held at any instant is gzip's internal O(KB)
    read-ahead, never the whole file, and never beside more than one
    decompressed window (the co-residency contract, regression-tested).
    """
    window_bytes = max(WINDOW_FLOOR_BYTES, int(window_bytes))
    carry = b""
    with open_binary(path) as f:
        while True:
            data = f.read(window_bytes)
            if not data:
                break
            if carry:
                data = carry + data
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            carry = data[cut + 1 :]
            yield data[: cut + 1]
    if carry:
        yield carry


def iter_text_lines(path: str, window_bytes: int = DEFAULT_WINDOW_BYTES) -> Iterator[str]:
    """Decoded lines of a (possibly gzipped) text file, without their
    terminators, in O(window) memory — the streaming replacement for
    ``for line in open(path)``. Newline handling matches text-mode
    universal newlines (``\\r\\n`` and lone ``\\r`` break lines), so a
    consumer migrated from a raw text handle sees identical lines."""
    for window in iter_byte_windows(path, window_bytes):
        text = window.decode("utf-8")
        if "\r" in text:
            text = text.replace("\r\n", "\n").replace("\r", "\n")
        lines = text.split("\n")
        # A line-aligned window ends with '\n' (final empty piece); the
        # last carry may not — its final piece is a real unterminated line.
        tail = lines.pop()
        for line in lines:
            yield line
        if tail:
            yield tail


def windowed(items: Iterable[T], size: int) -> Iterator[List[T]]:
    """Generic bounded windowing of an object stream: lists of at most
    ``size`` items, in order — the page/window shape shared by the REST
    paginator and the synthetic generator so every source speaks the same
    bounded contract."""
    if size <= 0:
        raise ValueError(f"window size must be >= 1, got {size}")
    window: List[T] = []
    for item in items:
        window.append(item)
        if len(window) >= size:
            yield window
            window = []
    if window:
        yield window


# --------------------------------------------------------- sortedness probe


class SortednessProbe:
    """Single-pass ordering contract for one stream: each contig's records
    must be contiguous and non-decreasing in position (the standard
    coordinate-sorted layout). ``check`` takes one same-contig run at a
    time; violations raise ``error_cls`` with a message naming the fix.

    This is the generalization of the VCF streaming path's run-order
    guard — ``hint`` carries the source-specific remedy (e.g. "sort the
    input or disable streaming")."""

    def __init__(
        self,
        label: str,
        *,
        error_cls: Callable[[str], Exception] = UnsortedStreamError,
        hint: str = "",
    ):
        self.label = label
        self.error_cls = error_cls
        self.hint = f"; {hint}" if hint else ""
        self.current: Optional[str] = None
        self.last_pos = -1
        self.finished: set = set()

    def check(self, name: str, positions: "np.ndarray") -> None:
        if name != self.current:
            if self.current is not None:
                self.finished.add(self.current)
            if name in self.finished:
                raise self.error_cls(
                    f"{self.label}: records for contig {name!r} are not "
                    "contiguous — a single streaming pass needs "
                    f"contig-contiguous input{self.hint}"
                )
            self.current = name
            self.last_pos = -1
        if len(positions) == 0:
            return
        if int(positions[0]) < self.last_pos or (
            len(positions) > 1 and bool(np.any(np.diff(positions) < 0))
        ):
            raise self.error_cls(
                f"{self.label}: contig {name!r} positions are not sorted — "
                f"a single streaming pass needs sorted positions{self.hint}"
            )
        self.last_pos = int(positions[-1])


# ----------------------------------------------------- budgeted accumulators


class ChunkedArrayBuilder:
    """Bounded-growth array accumulator: parts append into a preallocated
    buffer grown by doubling through slice assignment, with an optional
    hard row capacity enforced at runtime (:class:`StreamBudgetError`). The
    one way to assemble a column from a windowed stream; its residency is
    at most 2× the final size during a growth step."""

    def __init__(
        self,
        dtype: Any,
        row_shape: Tuple[int, ...] = (),
        capacity_rows: Optional[int] = None,
        label: str = "stream",
    ):
        self.dtype = np.dtype(dtype)
        self.row_shape = tuple(int(d) for d in row_shape)
        self.capacity_rows = (
            None if capacity_rows is None else int(capacity_rows)
        )
        self.label = label
        self.rows = 0
        self._buf = np.empty((0,) + self.row_shape, dtype=self.dtype)

    def add(self, part: "np.ndarray") -> None:
        part = np.asarray(part, dtype=self.dtype)
        n = part.shape[0]
        if n == 0:
            return
        new_rows = self.rows + n
        if self.capacity_rows is not None and new_rows > self.capacity_rows:
            raise StreamBudgetError(
                f"{self.label}: {new_rows} rows exceed the declared "
                f"capacity of {self.capacity_rows} — the input violates "
                "the bound this run was admitted under"
            )
        if new_rows > self._buf.shape[0]:
            grown = np.empty(
                (max(new_rows, 2 * self._buf.shape[0]),) + self.row_shape,
                dtype=self.dtype,
            )
            grown[: self.rows] = self._buf[: self.rows]
            self._buf = grown
        self._buf[self.rows : new_rows] = part
        self.rows = new_rows

    def finish(self) -> "np.ndarray":
        """The accumulated rows (a view; no copy)."""
        return self._buf[: self.rows]


class SpooledRecordTable:
    """Per-contig start-sorted wire-record table whose RECORDS live in an
    unlinked disk spool (JSON lines) — resident memory is the integer
    index (:data:`SPOOL_INDEX_BYTES_PER_ROW` per row) plus one decode
    window, never O(file). This is how the wire VCF/JSONL tables stream:
    random-access bisect queries read records back lazily via ``os.pread``
    (thread-safe, no shared seek state); JSON round-trips every wire dict.

    Rows are capacity-enforced against the closed-form bound
    (``wire_rows_bound``); ``finish`` freezes the index with a per-contig
    stable sort by start (equal starts keep insertion order)."""

    def __init__(self, label: str, capacity_rows: Optional[int] = None):
        self.label = label
        self.capacity_rows = (
            None if capacity_rows is None else int(capacity_rows)
        )
        self.rows_total = 0
        self._finished = False
        self._spool = tempfile.TemporaryFile(prefix="graft-spool-")
        self._offset = 0
        self._starts: Dict[str, List[int]] = {}
        self._offsets: Dict[str, List[int]] = {}
        self._lengths: Dict[str, List[int]] = {}
        self._index: Dict[
            str, Tuple["np.ndarray", "np.ndarray", "np.ndarray"]
        ] = {}

    def add(self, contig: str, start: int, record: Dict[str, Any]) -> None:
        if self._finished:
            raise ValueError(f"{self.label}: table already finished")
        if (
            self.capacity_rows is not None
            and self.rows_total >= self.capacity_rows
        ):
            raise StreamBudgetError(
                f"{self.label}: row {self.rows_total + 1} exceeds the "
                f"declared capacity of {self.capacity_rows} — the input "
                "violates the bound this run was admitted under"
            )
        data = json.dumps(record, separators=(",", ":")).encode("utf-8")
        self._spool.write(data)
        self._spool.write(b"\n")
        self._starts.setdefault(contig, []).append(int(start))
        self._offsets.setdefault(contig, []).append(self._offset)
        self._lengths.setdefault(contig, []).append(len(data))
        self._offset += len(data) + 1
        self.rows_total += 1

    def finish(self) -> "SpooledRecordTable":
        """Flush the spool and freeze the index, start-sorted per contig
        (stable — duplicate starts keep insertion order)."""
        if self._finished:
            return self
        self._finished = True
        self._spool.flush()
        for contig, starts in self._starts.items():
            arr = np.asarray(starts, dtype=np.int64)
            order = np.argsort(arr, kind="stable")
            self._index[contig] = (
                arr[order],
                np.asarray(self._offsets[contig], dtype=np.int64)[order],
                np.asarray(self._lengths[contig], dtype=np.int64)[order],
            )
        self._starts.clear()
        self._offsets.clear()
        self._lengths.clear()
        return self

    # ----------------------------------------------------------- queries

    def contig_names(self) -> List[str]:
        self._need_finished()
        return list(self._index)

    def rows(self, contig: str) -> int:
        self._need_finished()
        idx = self._index.get(contig)
        return 0 if idx is None else int(idx[0].shape[0])

    def starts(self, contig: str) -> "np.ndarray":
        """Start-sorted positions of one contig (int64; empty if absent)."""
        self._need_finished()
        idx = self._index.get(contig)
        return np.empty(0, np.int64) if idx is None else idx[0]

    def record(self, contig: str, i: int) -> Dict[str, Any]:
        """One record, decoded from the spool (``os.pread`` — safe from
        concurrent per-shard workers; no seek state)."""
        self._need_finished()
        _, offsets, lengths = self._index[contig]
        data = os.pread(
            self._spool.fileno(), int(lengths[i]), int(offsets[i])
        )
        decoded: Dict[str, Any] = json.loads(data)
        return decoded

    def iter_records(
        self, contig: str, lo: int = 0, hi: Optional[int] = None
    ) -> Iterator[Dict[str, Any]]:
        """Records ``[lo, hi)`` of one contig in start order, decoded one
        at a time — the O(window) query surface bisect consumers stream
        from."""
        self._need_finished()
        if contig not in self._index:
            return
        n = self.rows(contig)
        hi = n if hi is None else min(int(hi), n)
        for i in range(max(0, int(lo)), hi):
            yield self.record(contig, i)

    def tail_records(self, contig: str, n: int) -> List[Dict[str, Any]]:
        """The last ``n`` records of one contig (bounded helper for span
        estimation)."""
        total = self.rows(contig)
        return [
            self.record(contig, i) for i in range(max(0, total - n), total)
        ]

    def close(self) -> None:
        try:
            self._spool.close()
        except OSError:
            pass

    def _need_finished(self) -> None:
        if not self._finished:
            raise ValueError(f"{self.label}: finish() the table first")


# --------------------------------------------------------------- merge-join


class MergeJoinStats:
    """Observability for :func:`merge_join`'s bounded-window claim: the
    peak number of records tracked at once (one key group: ≤ k × per-key
    duplicates) and the group count — what the property test asserts
    against ``k × window``."""

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
    streams: yields ``(key, per_stream_records)`` for every key present
    in ANY stream, keys ascending, holding exactly one key group in
    memory (≤ k × that key's duplicate count) — the bounded replacement
    for materializing per-set tables before a multi-set join.

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


__all__ = [
    "ChunkedArrayBuilder",
    "DEFAULT_WINDOW_BYTES",
    "GZ_DECOMPRESS_RATIO_BOUND",
    "MIN_WIRE_LINE_BYTES",
    "MergeJoinStats",
    "SPOOL_INDEX_BYTES_PER_ROW",
    "SortednessProbe",
    "SpooledRecordTable",
    "StreamBudgetError",
    "UnsortedStreamError",
    "WINDOW_FLOOR_BYTES",
    "decompressed_size_bound",
    "iter_byte_windows",
    "iter_text_lines",
    "merge_join",
    "open_binary",
    "windowed",
    "wire_rows_bound",
]
