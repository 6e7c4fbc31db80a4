"""Crash-durable flight recorder: the last seconds before any ``kill -9``.

The port's copy of ``spark_examples_tpu/obs/recorder.py``; the segment
format is the reference's, key for key, so either package reads the
other's segments. The in-memory telemetry (``obs/spans.py``, the metrics
registry) dies with its process; the :class:`FlightRecorder` keeps a
timeline that survives it. ``variants-pca --trace-dir DIR`` records the
run's stages into one segment per process (``host<process index>``), and
a fleet of processes merges into one Chrome trace (``obs/trace.py``):

- **a bounded per-replica event ring**: :meth:`record` appends one event
  dict to an in-memory deque in O(1) under a leaf lock. The ring holds
  UNFLUSHED events only and is bounded (``capacity``); past the bound the
  oldest pending event is dropped and counted — the recorder can never
  become the unbounded buffer ``graftcheck hostmem`` forbids everywhere
  else;
- **crash-durable flushes**: :meth:`flush` drains the ring to an
  append-only JSONL segment file under ``<run_dir>/trace/``. The driver
  flushes when its stages end and at every registered fault kill-point
  *before* the fault fires (``utils/faults.py:add_flush_hook``), so a
  ``kill -9`` always lands on a segment that already contains the events
  leading up to it. An ``atexit`` hook catches polite exits;
  segments merge via the ``trace export`` CLI verb
  (``python -m spark_examples_tpu_torch trace export``, ``obs/trace.py``);
- **torn-tail tolerance**: a kill mid-append can tear at most the last
  line of a segment; readers (``obs/trace.py``) skip unparseable lines,
  exactly like the journal fold.

Event schema (one JSON object per line)::

    {"ts": 1722…,               # unix seconds (float)
     "name": "job",             # what happened
     "ph": "B" | "E" | "i",     # span begin / span end / instant
     "trace": "…32 hex…",       # trace id (one job = one trace)
     "job": "job-a-000001",
     "replica": "a",            # or "solo"
     "pid": 1234,
     "tid": "small-0",          # executor slice, or "control"
     "args": {…}}               # free-form attributes (epoch, status, …)

``B``/``E`` pairs are matched by ``(replica, job, name)`` at export time
(``obs/trace.py``); a ``B`` whose ``E`` died with its process is closed
as a truncated span by the exporter, never left orphaned.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

#: Segment files live here under the shared run directory — one file per
#: replica incarnation, append-only, merged by the ``trace export`` verb.
TRACE_DIRNAME = "trace"

#: Default ring bound: unflushed events held in memory. Control-plane
#: event rates are a handful per job, so thousands of pending events mean
#: flushing stopped — drop the oldest and say so, never grow.
DEFAULT_CAPACITY = 4096


def trace_dir(run_dir: str) -> str:
    return os.path.join(run_dir, TRACE_DIRNAME)


class FlightRecorder:
    """One process's half of the run directory's flight-recorder record;
    see the module docstring for the durability contract."""

    def __init__(
        self,
        run_dir: str,
        name: str,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.time,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        safe = "".join(
            c if c.isalnum() or c in "._-" else "_" for c in str(name)
        )
        if not safe:
            raise ValueError(f"recorder name {name!r} is empty once sanitized")
        self.run_dir = run_dir
        self.name = safe
        #: Segment name carries the pid so a restarted replica with the
        #: same id appends to its OWN segment — two incarnations' torn
        #: tails must never interleave in one file.
        self.path = os.path.join(
            trace_dir(run_dir), f"{safe}.{os.getpid()}.jsonl"
        )
        self.capacity = int(capacity)
        self._clock = clock
        # lock order: recorder lock is a leaf — nothing else is acquired
        # while holding it (append/drain bookkeeping only; file writes
        # happen holding it too but acquire no further locks).
        self._lock = threading.Lock()
        self._pending: Deque[Dict] = deque()
        self._file = None
        self._closed = False
        self.dropped = 0
        self.recorded = 0
        self.flushed = 0
        atexit.register(self._atexit)

    # -------------------------------------------------------------- record

    def record(
        self,
        name: str,
        ph: str = "i",
        trace: Optional[str] = None,
        job: Optional[str] = None,
        tid: str = "control",
        **args,
    ) -> None:
        """Append one event to the ring — O(1), never touches the disk.
        ``ph`` is the Chrome-trace phase this event exports as: ``B``/``E``
        span boundaries (paired by ``(replica, job, name)``) or ``i``
        instants."""
        if ph not in ("B", "E", "i"):
            raise ValueError(f"unknown event phase {ph!r} (B, E, or i)")
        event: Dict = {
            "ts": self._clock(),
            "name": str(name),
            "ph": ph,
            "replica": self.name,
            "pid": os.getpid(),
            "tid": str(tid),
        }
        if trace is not None:
            event["trace"] = str(trace)
        if job is not None:
            event["job"] = str(job)
        if args:
            event["args"] = args
        with self._lock:
            if self._closed:
                return
            if len(self._pending) >= self.capacity:
                self._pending.popleft()
                self.dropped += 1
            self._pending.append(event)
            self.recorded += 1

    def begin(self, name: str, **kw) -> None:
        self.record(name, ph="B", **kw)

    def end(self, name: str, **kw) -> None:
        self.record(name, ph="E", **kw)

    # --------------------------------------------------------------- flush

    def flush(self, fsync: bool = True) -> int:
        """Drain every pending event to the append-only segment file;
        returns how many events landed. Safe to call from any thread and
        from the fault hook's pre-kill window — failures are swallowed
        (telemetry must never take down the run OR turn a deterministic
        kill-point into a different crash)."""
        with self._lock:
            if not self._pending:
                return 0
            events = list(self._pending)
            self._pending.clear()
            dropped, self.dropped = self.dropped, 0
            lines = events
            if dropped:
                # The gap is part of the record: a reader must know the
                # ring overflowed rather than infer silence.
                lines = [
                    {
                        "ts": events[0]["ts"],
                        "name": "ring-overflow",
                        "ph": "i",
                        "replica": self.name,
                        "pid": os.getpid(),
                        "tid": "control",
                        "args": {"dropped": dropped},
                    }
                ] + events
            try:
                if self._file is None:
                    os.makedirs(os.path.dirname(self.path), exist_ok=True)
                    self._file = open(self.path, "a", encoding="utf-8")
                for event in lines:
                    self._file.write(json.dumps(event, sort_keys=True) + "\n")
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())
            except Exception:
                # A failed flush (ENOSPC, unopenable dir) must not also
                # discard the timeline: restore the drained events and
                # the drop count so the next attempt retries them. A
                # half-written batch may duplicate lines on retry — the
                # exporter tolerates that; losing the pre-crash record
                # it exists to preserve would be worse.
                self._pending.extendleft(reversed(events))
                self.dropped += dropped
                return 0
            self.flushed += len(lines)
            return len(lines)

    def close(self) -> None:
        """Final flush + file close; further records are ignored (a late
        telemetry write after teardown must not resurrect the file)."""
        self.flush()
        with self._lock:
            self._closed = True
            if self._file is not None:
                try:
                    self._file.close()
                except Exception:
                    pass
                self._file = None
        # Release the atexit pin: a long-lived embedder that starts and
        # stops many services must not accumulate dead recorders.
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass

    def _atexit(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def read_segments(run_dir: str) -> List[Dict]:
    """Every event from every segment under ``<run_dir>/trace/``, in
    per-file order then globally sorted by timestamp. Torn or corrupt
    lines (a ``kill -9`` mid-append) are skipped, like the journal fold;
    non-segment files are ignored."""
    directory = trace_dir(run_dir)
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return []
    events: List[Dict] = []
    for fname in names:
        if not fname.endswith(".jsonl"):
            continue
        try:
            f = open(os.path.join(directory, fname), "r", encoding="utf-8")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed writer
                if (
                    isinstance(event, dict)
                    and isinstance(event.get("ts"), (int, float))
                    and isinstance(event.get("name"), str)
                    and event.get("ph") in ("B", "E", "i")
                    # The merge hard-indexes the replica; a foreign JSONL
                    # dropped into trace/ must be skipped like a torn
                    # tail, never crash the export.
                    and isinstance(event.get("replica"), str)
                ):
                    events.append(event)
    events.sort(key=lambda e: e["ts"])
    return events


__all__ = [
    "DEFAULT_CAPACITY",
    "TRACE_DIRNAME",
    "FlightRecorder",
    "read_segments",
    "trace_dir",
]
