"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. With
no card present a CUDA request raises: the port never falls back to the CPU
on its own, so a run can never report CPU results as the card's.
"""

from __future__ import annotations

from typing import Union

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


__all__ = ["DeviceLike", "resolve_device"]
