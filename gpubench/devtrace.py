"""What a ``torch.profiler`` Chrome trace says about the card over a
stretch of whole jobs.

The stretch runs from the start of the first ``gpubench.job`` range to the
end of the last. Inside it:

- the card is busy where a kernel, a copy or a memset runs: the union of
  those intervals (the port's ``chip_smoke.py:busy_share`` rule);
- each device operation's time, clipped to the stretch, summed by name;
- each idle gap (the stretch less the busy union) is named by what the
  host thread that ran the jobs had open at the gap's midpoint: the
  innermost profiler range and the innermost operator inside it.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

JOB_RANGE = "gpubench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template and arguments."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name.strip()


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged ``(start, end)`` intervals."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of ``[lo, hi]`` outside the merged ``busy`` intervals."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def name_points(points: Sequence[float], host: Sequence[Tuple[float, float, str, str]]) -> List[str]:
    """For each point (ascending), ``<innermost range>/<innermost operator>``
    open at it, from properly nested host intervals ``(start, end, name,
    category)`` sorted by start (outer first at equal starts)."""
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        rng = next((s[2] for s in reversed(stack) if s[3] == "user_annotation"), None)
        op = next((s[2] for s in reversed(stack) if s[3] == "cpu_op"), None)
        if rng is None:
            names.append("outside any range")
        else:
            names.append(rng if op is None else f"{rng}/{op}")
    return names


@dataclass
class DeviceTrace:
    """The card over the stretch of traced jobs (times in microseconds)."""

    lo: float
    hi: float
    busy_us: float
    op_us: Dict[str, float]
    idle_us: Dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def op_seconds(self, prefix: str) -> float:
        """Summed time of the device operations whose short name, less its
        namespaces, starts with ``prefix``."""
        return sum(us for name, us in self.op_us.items()
                   if name.rsplit("::", 1)[-1].startswith(prefix)) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        def ranked(table: Dict[str, float]) -> List[List]:
            rows = sorted(table.items(), key=lambda kv: -kv[1])[:top]
            return [[name, us / 1e6] for name, us in rows]

        return {"device_ops": ranked(self.op_us), "idle_gaps": ranked(self.idle_us)}


def read_trace(path: str, job_range: str = JOB_RANGE) -> Optional[DeviceTrace]:
    """The card over the jobs of a Chrome trace; ``None`` when the trace
    has no job range or no device operation inside the stretch."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    jobs = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == job_range]
    if not jobs:
        return None
    lo = min(float(e["ts"]) for e in jobs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in jobs)
    device = []
    op_us: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(lo, float(e["ts"]))
        b = min(hi, float(e["ts"]) + float(e["dur"]))
        if b > a:
            device.append((a, b))
            op_us[short_name(str(e.get("name", "")))] += b - a
    if not device:
        return None
    busy = union(device)
    idle = gaps(busy, lo, hi)
    threads = {(e.get("pid"), e.get("tid")) for e in jobs}
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]), e["cat"])
         for e in events
         if e.get("cat") in HOST_CATS and (e.get("pid"), e.get("tid")) in threads),
        key=lambda h: (h[0], -h[1]),
    )
    idle_us: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, name_points([(a + b) / 2 for a, b in idle], host)):
        idle_us[name] += b - a
    return DeviceTrace(lo, hi, sum(b - a for a, b in busy), dict(op_us), dict(idle_us))


__all__ = ["DeviceTrace", "JOB_RANGE", "gaps", "name_points", "read_trace", "short_name", "union"]
