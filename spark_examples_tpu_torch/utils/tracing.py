"""Stage timings and the device trace behind ``--profile-dir``.

The port's copy of ``spark_examples_tpu/utils/tracing.py``:

- :class:`StageTimes` — coarse per-stage wall-clock accounting for the
  driver, recorded as spans of the run's :class:`SpanRecorder` (each span
  a profiler range of its own, ``obs/spans.py``) and, with a flight
  recorder, as its ``begin``/``end`` pair, so the printed "Stage timings"
  report, the manifest's span tree, the device trace and the crash-durable
  timeline are views of one measurement;
- :func:`device_trace` — a ``torch.profiler`` trace of the host's and the
  card's activity (every CUDA kernel with its start and duration), written
  as a Chrome trace into the directory. It stands where the reference's
  ``jax.profiler`` trace stands.

Kernel launches are asynchronous, so a stage's wall time is only meaningful
when the stage ends in a synchronisation (``sync=``); the span carries this
as its ``synced`` flag.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from spark_examples_tpu_torch.obs.recorder import FlightRecorder
from spark_examples_tpu_torch.obs.spans import SpanRecorder


class StageTimes:
    """Ordered per-stage wall-clock accounting, recorded as spans.

    ``recorder`` shares the run's :class:`SpanRecorder` (stages nest under
    whatever span is open, and deeper phases nest under the stages); a
    private recorder is created otherwise. ``flight``, the run's
    :class:`FlightRecorder` under ``--trace-dir``, gets each stage's
    ``begin`` and, once the stage has ended with its work, its ``end``
    (thread ``pipeline``); a stage that raises leaves its ``begin`` open,
    which the export marks truncated. ``stages`` keeps the ``[(name,
    seconds)]`` list the printed report reads.
    """

    def __init__(
        self, recorder: Optional[SpanRecorder] = None, flight: Optional[FlightRecorder] = None
    ) -> None:
        self.recorder = recorder if recorder is not None else SpanRecorder()
        self.flight = flight
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[Callable[[], object]] = None):
        """Time a stage; ``sync`` (if given) is called before closing the
        measurement, so the stage ends with the card's work. The stage's
        span is a named range of any profiler trace (:func:`device_trace`),
        the window its device busy share is read over."""
        if self.flight is not None:
            self.flight.begin(name, tid="pipeline")
        span = None
        try:
            with self.recorder.span(name, sync=sync) as span:
                yield self
        finally:
            if span is not None and span.seconds is not None:
                self.stages.append((name, span.seconds))
        if self.flight is not None:
            self.flight.end(name, tid="pipeline")

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)

    def __str__(self) -> str:
        lines = ["Stage timings:", "-------------------------------"]
        total = 0.0
        for name, seconds in self.stages:
            lines.append(f"{name}: {seconds:.3f} s")
            total += seconds
        lines.append(f"total: {total:.3f} s")
        return "\n".join(lines)


#: File name of the Chrome trace :func:`device_trace` writes (``{stamp}`` is
#: the start time in milliseconds and the process id, so traces of several
#: runs into one directory never overwrite each other).
TRACE_FILE = "torch_trace_{stamp}.json"


@contextlib.contextmanager
def device_trace(profile_dir: Optional[str]):
    """``torch.profiler.profile`` over the block when a directory is given,
    a no-op otherwise. Records host activity and, when a card is present,
    CUDA kernels and copies; on exit writes the Chrome trace (loadable in
    Perfetto or ``chrome://tracing``) into ``profile_dir``. Yields the
    profiler, or ``None`` when tracing is off."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    stamp = f"{int(time.time() * 1000)}_{os.getpid()}"
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE.format(stamp=stamp)))


__all__ = ["StageTimes", "TRACE_FILE", "device_trace"]
