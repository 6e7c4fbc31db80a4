"""Shared bounded-backoff arithmetic for transient-failure retries.

The port's copy of ``spark_examples_tpu/utils/retry.py``: one spelling of
the retry delay policy for the network clients (``sources/rest.py`` now;
the serve client when serving is ported), with the reference's arithmetic
on the same ``random.Random``, so a seeded client sleeps the same delays
in both packages. Two rules:

- **full jitter**: delay uniform in ``[0, min(cap, base·2^attempt)]`` —
  the AWS-architecture-blog shape that decorrelates a thundering herd of
  retrying clients while keeping the expected delay half the ceiling;
- **Retry-After**: when the server SAYS when to come back (429/503), the
  client honors it — capped by the same ``cap`` so a hostile or broken
  header can never park a pipeline for an hour.
"""

from __future__ import annotations

import random
from email.utils import parsedate_to_datetime
from typing import Mapping, Optional


def full_jitter_delay(
    attempt: int,
    base: float,
    cap: float,
    rng: Optional[random.Random] = None,
) -> float:
    """Exponential backoff with full jitter: uniform in
    ``[0, min(cap, base * 2**attempt)]``. ``attempt`` is 0-based."""
    ceiling = min(float(cap), float(base) * (2 ** int(attempt)))
    if rng is None:
        rng = random.Random()
    return rng.uniform(0.0, ceiling)


def retry_after_seconds(
    headers: Optional[Mapping], cap: float
) -> Optional[float]:
    """Parse a ``Retry-After`` header (delta-seconds or HTTP-date) into a
    delay in seconds, clamped to ``[0, cap]``; ``None`` when the header is
    absent or unparseable (the caller falls back to jittered backoff)."""
    if headers is None:
        return None
    value = headers.get("Retry-After")
    if value is None:
        return None
    value = str(value).strip()
    try:
        seconds = float(value)
    except ValueError:
        try:
            target = parsedate_to_datetime(value)
        except (TypeError, ValueError):
            return None
        if target is None:
            return None
        import datetime

        now = datetime.datetime.now(
            target.tzinfo if target.tzinfo is not None else None
        )
        seconds = (target - now).total_seconds()
    return max(0.0, min(float(cap), seconds))


__all__ = ["full_jitter_delay", "retry_after_seconds"]
