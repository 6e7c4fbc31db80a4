"""Probe: the largest shared-memory scratch one thread block can use.

The port of ``experiments/vmem_capacity.py``, which bisected the TPU's
kernel scratch memory (VMEM) by compiling ever larger scratch buffers. On
Hopper the counterpart is a block's dynamic shared memory, which above 48
KB needs ``cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, bytes)``.
``scratch_copy_kernel`` (``csrc/probes.cu``) copies an (8, 1024) float32
tile through the last 32 KiB of a scratch of ``nbytes`` with two TMA bulk
copies, counted on an mbarrier in the scratch's first bytes; a size the
runtime refuses is the probe's answer, and the bisection goes on.

    python -m spark_examples_tpu_torch.experiments.vmem_capacity

prints one OK/FAIL line per size tried and the limit found beside the
driver's own figure (``cudaDevAttrMaxSharedMemoryPerBlockOptin``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.devicegen import _require
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device

TILE = (8, 1024)
TILE_BYTES = TILE[0] * TILE[1] * 4
#: The smallest scratch: the kernel's mbarrier (8 bytes, padded to the
#: tile's 16-byte alignment), then the tile.
MIN_BYTES = TILE_BYTES + 16
#: The bisection's range in bytes: the smallest scratch, and 256 KiB (the
#: SM's whole shared memory and L1; Hopper lets a block opt in to 227 KB).
LOW = MIN_BYTES
HIGH = 256 << 10


def _tile_offset(nbytes: int) -> int:
    """Byte offset of the tile in the scratch: the last 32 KiB, aligned down
    to 16 bytes."""
    return (int(nbytes) - TILE_BYTES) & ~15


def scratch_copy_plain(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version of :func:`scratch_copy`: the identity copy through a
    scratch tensor of ``nbytes``."""
    scratch = torch.zeros(int(nbytes) // 4, dtype=torch.float32, device=x.device)
    at = _tile_offset(nbytes) // 4
    scratch[at : at + x.numel()] = x.reshape(-1)
    return scratch[at : at + x.numel()].reshape(x.shape).clone()


@functools.lru_cache(maxsize=None)
def _library():
    lib = _kernels.library("probes.cu")
    if (lib.probes_tile_bytes(), lib.probes_min_scratch_bytes()) != (TILE_BYTES, MIN_BYTES):
        raise RuntimeError("csrc/probes.cu copies a different tile than vmem_capacity.py")
    return lib


def scratch_copy(x: torch.Tensor, nbytes: int) -> Optional[torch.Tensor]:
    """``x`` ((8, 1024) float32) copied through the last 32 KiB of an
    ``nbytes`` shared-memory scratch; ``None`` when the card refuses a
    scratch of that size (the probe's answer, not a fault). Any other CUDA
    error raises. ``nbytes`` is at least ``MIN_BYTES`` (the kernel's
    mbarrier and the tile), on every device.

    Replaces ``experiments/vmem_capacity.py:try_scratch``'s Pallas kernel.
    CPU tensors take :func:`scratch_copy_plain`; CUDA tensors launch
    ``scratch_copy_kernel`` (``csrc/probes.cu``)."""
    _require(x, "x", torch.float32, TILE)
    if int(nbytes) < MIN_BYTES:
        raise ValueError(
            f"the scratch must hold the kernel's barrier and the {TILE_BYTES}-byte tile "
            f"({MIN_BYTES} bytes), got {nbytes}"
        )
    if x.device.type == "cpu":
        return scratch_copy_plain(x, nbytes)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (bulk copies need it)")
    out = torch.empty_like(x)
    refused = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        status = _library().scratch_copy_launch(
            x.data_ptr(), out.data_ptr(), int(nbytes), ctypes.byref(refused),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _kernels.check(status, f"scratch_copy[{nbytes} B]")
    if refused.value:
        return None
    scratch_copy.launches += 1
    return out


scratch_copy.launches = 0  # type: ignore[attr-defined]


def max_shared_memory_optin(device: DeviceLike = None) -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the attribute is a CUDA card's")
    value = _library().max_shared_memory_optin(dev.index or 0)
    if value < 0:
        raise RuntimeError("cudaDeviceGetAttribute failed")
    return value


def _tile(device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return torch.randn(TILE, generator=gen).to(device)


def try_scratch(nbytes: int, device: DeviceLike = None) -> bool:
    """Whether a scratch of ``nbytes`` launched and copied the tile exactly."""
    dev = resolve_device(device)
    x = _tile(dev)
    out = scratch_copy(x, nbytes)
    return out is not None and bool(torch.equal(out, x))


def find_limit(device: DeviceLike = None) -> Tuple[int, List[Tuple[int, bool]]]:
    """Bisect in bytes over [LOW, HIGH] for the largest scratch that
    launched and copied exactly. Returns it and every ``(nbytes, ok)``
    tried, in order."""
    dev = resolve_device(device)
    tried: List[Tuple[int, bool]] = []

    def attempt(nbytes: int) -> bool:
        ok = try_scratch(nbytes, dev)
        tried.append((nbytes, ok))
        return ok

    if not attempt(LOW):
        raise RuntimeError(f"a {LOW}-byte scratch failed: the probe itself is broken")
    if attempt(HIGH):
        return HIGH, tried
    lo, hi = LOW, HIGH  # lo launched, hi was refused
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if attempt(mid):
            lo = mid
        else:
            hi = mid
    return lo, tried


def main() -> int:
    limit, tried = find_limit()
    for nbytes, ok in tried:
        print(f"shared-memory scratch {nbytes} B: {'OK' if ok else 'FAIL'}", flush=True)
    attribute = max_shared_memory_optin()
    print(f"limit {limit} B; cudaDevAttrMaxSharedMemoryPerBlockOptin {attribute} B "
          f"({'equal' if limit == attribute else 'DIFFERENT'})", flush=True)
    return 0 if limit == attribute else 1


__all__ = [
    "HIGH",
    "LOW",
    "MIN_BYTES",
    "TILE",
    "find_limit",
    "main",
    "max_shared_memory_optin",
    "scratch_copy",
    "scratch_copy_plain",
    "try_scratch",
]

if __name__ == "__main__":
    raise SystemExit(main())
