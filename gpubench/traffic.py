"""The one traffic generator: reads a mix's parameters and hands out jobs.

A mix file (``traffic/<name>.json``) holds:

- ``loop``: ``"closed"``, one client sending its next job when the last
  has returned (the only loop this generator drives);
- ``data``: ``"seed_per_job"``, every job a cohort of its own, drawn from
  the run's seed and the job's index, all of one configuration's sizes;
- ``warm_jobs``: jobs run in set-up, before the window;
- ``checked_jobs``: jobs of the window whose output is judged, drawn from
  the run's seed among those that completed (a reservoir);
- ``trace_jobs``: jobs run under the profiler after the window in a
  ``--trace 1`` run.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Generic, List, Tuple, TypeVar

MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

T = TypeVar("T")


def _mix(x: int) -> int:
    x = (x + _GOLDEN) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


@dataclass(frozen=True)
class Traffic:
    name: str
    loop: str
    data: str
    warm_jobs: int
    checked_jobs: int
    trace_jobs: int

    @classmethod
    def from_doc(cls, name: str, doc: Dict) -> "Traffic":
        traffic = cls(
            name=name,
            loop=str(doc["loop"]),
            data=str(doc["data"]),
            warm_jobs=int(doc["warm_jobs"]),
            checked_jobs=int(doc["checked_jobs"]),
            trace_jobs=int(doc["trace_jobs"]),
        )
        if traffic.loop != "closed" or traffic.data != "seed_per_job":
            raise ValueError(f"traffic {name!r}: the generator drives a closed loop of "
                             "seed_per_job jobs")
        if traffic.warm_jobs < 1 or traffic.checked_jobs < 1 or traffic.trace_jobs < 3:
            raise ValueError(f"traffic {name!r}: needs a warm job, a checked job and "
                             "three traced jobs")
        return traffic

    def job_seed(self, seed: int, index: int) -> int:
        """The data seed of job ``index`` of a run seeded ``seed``: 63 bits,
        the same for the same pair on every machine."""
        return _mix((int(seed) & MASK64) ^ _mix(index + 1)) >> 1


class Reservoir(Generic[T]):
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed) & MASK64)
        self.seen = 0
        self.items: List[Tuple[int, T]] = []

    def offer(self, index: int, item: T) -> None:
        """Keep ``item`` (job ``index``'s) with the chance that keeps the
        sample uniform."""
        slot = self.seen if self.seen < self.size else self.rng.randrange(self.seen + 1)
        if slot >= self.size:
            pass
        elif slot == len(self.items):
            self.items.append((index, item))
        else:
            self.items[slot] = (index, item)
        self.seen += 1


__all__ = ["Reservoir", "Traffic"]
