"""Hierarchical run spans.

A :class:`SpanRecorder` holds a tree of named, timed spans (the subset of
``spark_examples_tpu/obs/spans.py`` the port's driver uses). A PCoA run's
roots are ``setup`` (with ``callsets``), the two stages
``ingest+similarity`` and ``center+pca``, and ``epilogue`` (with
``emit``). Device-generated ingest nests ``plan``, ``walk`` (a ``dispatch``
a dispatch group) and ``counters`` under its stage, host-fed ingest its
``dispatch``, ``reduce-flush`` and ``chunk-parse``; the PCA stage nests
``center``, ``eigh`` and ``rows``.

Kernel launches are asynchronous, so a span's wall time is only meaningful
when it ends in a synchronisation: ``span(..., sync=fn)`` calls ``fn``
(``torch.cuda.synchronize`` on the card) before closing the measurement,
and the span records ``synced: true``.

Every span opened with :meth:`SpanRecorder.span` is also a
``torch.profiler.record_function`` range of its name, closed after the
span's ``sync``: a profiler trace (``--profile-dir``, or any profiler
around the run) names the host's and the card's time by the span tree, on
the profiler's own clock. A span attached with :meth:`SpanRecorder.add`
(a duration measured elsewhere) is no range. With no profiler running a
range costs one dispatcher call.

Thread model: the open-span stack is per-thread; completed spans attach to
their parent, or to the recorder's root list when nothing is open on that
thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from torch.profiler import record_function


class Span:
    """One timed region: name, seconds, sync-honesty flag, start time,
    children."""

    __slots__ = ("name", "seconds", "synced", "children", "started_unix")

    def __init__(self, name: str, synced: bool, started_unix: float):
        self.name = str(name)
        self.seconds: Optional[float] = None  # None while still open
        self.synced = bool(synced)
        self.children: List["Span"] = []
        self.started_unix = started_unix

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "seconds": self.seconds,
            "synced": self.synced,
            "started_unix": self.started_unix,
            "children": [c.as_dict() for c in self.children],
        }


class SpanRecorder:
    """A tree of spans with a per-thread open stack."""

    def __init__(self) -> None:
        # lock order: recorder lock is a leaf — nothing else is acquired
        # while holding it.
        self._lock = threading.Lock()
        self.roots: List[Span] = []
        self._stacks: Dict[int, List[Span]] = {}

    def _attach(self, span: Span) -> None:
        tid = threading.get_ident()
        with self._lock:
            stack = self._stacks.get(tid)
            if stack:
                stack[-1].children.append(span)
            else:
                self.roots.append(span)

    @contextlib.contextmanager
    def span(self, name: str, sync: Optional[Callable[[], object]] = None):
        """Open a child span of the current thread's innermost open span
        (or a new root), inside a profiler range of the same name. ``sync``
        is called before the measurement closes: pass the device's
        synchronisation so the span, and its range, end with its work."""
        span = Span(name, synced=sync is not None, started_unix=time.time())
        self._attach(span)
        tid = threading.get_ident()
        with self._lock:
            self._stacks.setdefault(tid, []).append(span)
        with record_function(span.name):
            start = time.perf_counter()
            try:
                yield span
            finally:
                try:
                    if sync is not None:
                        sync()
                finally:
                    # The span closes and the stack pops even when the sync
                    # raises (a device error mid-measurement) — otherwise
                    # every later span on this thread would silently nest
                    # under a dead parent.
                    span.seconds = time.perf_counter() - start
                    with self._lock:
                        stack = self._stacks.get(tid, [])
                        if span in stack:
                            # Pop through `span` (robust to a child left open
                            # by a mid-body exception: everything above it
                            # closes too).
                            del stack[stack.index(span):]
                        if not stack:
                            self._stacks.pop(tid, None)

    def add(self, name: str, seconds: float, synced: bool = False) -> None:
        """Attach a pre-measured duration (an aggregate timed elsewhere,
        e.g. the total host time of the Gramian flushes) as a closed span;
        it opens no profiler range."""
        span = Span(name, synced=synced, started_unix=time.time())
        span.seconds = float(seconds)
        self._attach(span)

    # -------------------------------------------------------------- exports

    def as_list(self) -> List[Dict]:
        """The span tree, JSON-safe (open spans report ``seconds: null``):
        the run manifest's ``spans`` block."""
        with self._lock:
            roots = list(self.roots)
        return [s.as_dict() for s in roots]

    def flat(self) -> List[Dict]:
        """Depth-first ``{path, seconds, synced}`` rows, '/'-joined paths —
        the grep-able form of the tree."""
        rows: List[Dict] = []

        def walk(span: Span, prefix: str) -> None:
            path = f"{prefix}/{span.name}" if prefix else span.name
            rows.append(
                {"path": path, "seconds": span.seconds, "synced": span.synced}
            )
            for child in span.children:
                walk(child, path)

        with self._lock:
            roots = list(self.roots)
        for root in roots:
            walk(root, "")
        return rows


__all__ = ["Span", "SpanRecorder"]
