"""Ingest-worker resolution of the chunk-parallel ingest engine.

The part of ``spark_examples_tpu/sources/files.py`` the packed arm uses:
``--ingest-workers`` decides whether the block stream rides a prefetch
thread and the accumulator double-buffers its feed. The VCF readers wait
for file ingest.
"""

from __future__ import annotations

import os
from typing import Optional


def default_ingest_workers() -> int:
    """Default parse worker count: ``min(8, cpu_count)`` — past ~8 threads
    the native parser is host memory-bandwidth-bound, and tiny containers
    should not oversubscribe."""
    return max(1, min(8, os.cpu_count() or 1))


def _resolve_ingest_workers(ingest_workers: Optional[int]) -> int:
    """``None`` = auto (:func:`default_ingest_workers`), ``0`` = the serial
    oracle path, ``N >= 1`` = exactly N parse threads."""
    if ingest_workers is None:
        return default_ingest_workers()
    workers = int(ingest_workers)
    if workers < 0:
        raise ValueError(f"ingest workers must be >= 0, got {workers}")
    return workers


__all__ = ["default_ingest_workers"]
