"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. With
no card present a CUDA request raises: the port never falls back to the CPU
on its own, so a run can never report CPU results as the card's.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device "
            "cpu) to run the plain PyTorch path on the CPU"
        )
    return dev


def synchronizer(device: torch.device) -> Optional[Callable[[], None]]:
    """The call that waits for ``device``'s queued work (a span passes it
    as ``sync`` so its wall-clock ends with the card's work); ``None`` on
    the CPU, whose work is synchronous."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None


#: Device-side sleep queued ahead of a timed loop, per timed call (in clock
#: cycles, about 0.1 ms): the host enqueues the calls while the card
#: sleeps, so the events time the card's work back to back and not the
#: host's launch rate (a 10 µs kernel otherwise times its launch).
SLEEP_CYCLES_PER_CALL = 200_000


def cuda_event_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the current CUDA card over ``iters``
    calls, from CUDA events, after ``warmup`` untimed calls; the timed
    calls are queued behind a device-side sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


__all__ = [
    "DeviceLike",
    "SLEEP_CYCLES_PER_CALL",
    "cuda_event_ms",
    "resolve_device",
    "synchronizer",
]
