"""Microbenchmark: the cost of one u32 operation on the card.

The port of ``experiments/probe_ops.py`` (a Pallas kernel on the TPU's
vector unit). One op — ``xor``, ``shiftxor``, ``cmp``, ``mul``,
``mul_i32`` or ``fmix32``, with the constants of the reference's ``make`` —
is applied ``R`` = 64 times to every element of a (1024, 2560) u32 tile,
the loop index its second operand; the output is fed back ``REPS`` = 20
times and timed with CUDA events. These are the u32 steps of the genotype
draws in ``gen_genotypes`` (``csrc/devicegen.cu``), priced one by one.

    python -m spark_examples_tpu_torch.experiments.probe_ops

Tensors hold the u32 bits as int32. :func:`probe_op_chain` launches
``probe_op_chain_kernel`` (``csrc/probes.cu``) for CUDA tensors and takes
:func:`probe_op_chain_plain` for CPU tensors: the same chain in int64 with
``& 0xFFFFFFFF`` after every op (PyTorch has no unsigned shift or compare
on the CPU).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.devicegen import _MASK32, _require, fmix32
from spark_examples_tpu_torch.utils.device import DeviceLike, cuda_event_ms, resolve_device

R = 64
SHAPE = (1024, 2560)
REPS = 20
#: The ops, in the reference's order, with their codes in csrc/probes.cu.
OPS = ("xor", "shiftxor", "cmp", "mul", "mul_i32", "fmix32")
_CODES = {op: code for code, op in enumerate(OPS)}
_MUL = 0x85EBCA6B


def _to_bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensors holding the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def probe_op_chain_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version of :func:`probe_op_chain`: the R-step chain in int64."""
    v = x.to(torch.int64) & _MASK32
    for i in range(R):
        if op == "xor":
            v = v ^ ((v + i) & _MASK32)
        elif op == "shiftxor":
            v = ((v ^ (v >> 16)) + i) & _MASK32
        elif op == "cmp":
            v = (v + (v < 0x7FFFFFFF + i).to(torch.int64)) & _MASK32
        elif op in ("mul", "mul_i32"):
            # The int32 product wraps to the same low 32 bits as the u32 one.
            v = (v * _MUL + i) & _MASK32
        elif op == "fmix32":
            v = (fmix32(v) + i) & _MASK32
        else:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    return _to_bits32(v)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _kernels.library("probes.cu")
    if lib.probes_rounds() != R:
        raise RuntimeError("csrc/probes.cu runs a different R than probe_ops.py")
    return lib


def probe_op_chain(x: torch.Tensor, op: str) -> torch.Tensor:
    """``op`` applied R times to every element of ``x`` (int32 holding u32
    bits, contiguous, any length and offset), with the loop index; a new
    tensor of the same shape.

    Replaces ``experiments/probe_ops.py:run``'s Pallas kernel (body
    ``make``). CPU tensors take :func:`probe_op_chain_plain`; CUDA tensors
    launch ``probe_op_chain_kernel`` (``csrc/probes.cu``)."""
    if op not in _CODES:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    _require(x, "x", torch.int32)
    if x.device.type == "cpu":
        return probe_op_chain_plain(x, op)
    # `out` as far past a 16-byte boundary as `x` (a view such as x[1:] is
    # not on one), so the kernel's 16-byte vectors align in both.
    shift = x.data_ptr() % 16 // 4
    out = torch.empty(x.numel() + shift, dtype=torch.int32, device=x.device)[shift:].view(x.shape)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        status = _library().probe_op_chain_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), _CODES[op],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _kernels.check(status, f"probe_op_chain[{op}]")
    probe_op_chain.launches += 1
    return out


probe_op_chain.launches = 0  # type: ignore[attr-defined]


def random_tile(seed: int = 0, shape: Tuple[int, int] = SHAPE) -> np.ndarray:
    """A (rows, cols) u32 tile drawn from ``seed``, as int32 bits."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


def run(
    op: str,
    device: DeviceLike = None,
    x: Optional[torch.Tensor] = None,
    reps: int = REPS,
) -> Tuple[torch.Tensor, Optional[float]]:
    """The reference's ``run(op)``: one warm call, then ``reps`` calls each
    fed the last output. Returns the last output and the milliseconds per
    call from CUDA events (``None`` on the CPU, which has no card time).
    The timed calls queue behind a device-side sleep, so the events time
    the card's work and not the host's launch rate."""
    dev = resolve_device(device)
    if x is None:
        x = torch.from_numpy(random_tile()).to(dev)
    last = [probe_op_chain(x, op)]

    def feed_back() -> None:
        last[0] = probe_op_chain(last[0], op)

    if dev.type != "cuda":
        for _ in range(reps):
            feed_back()
        return last[0], None
    with torch.cuda.device(dev):
        ms = cuda_event_ms(feed_back, reps, warmup=0)
    return last[0], ms


def main() -> int:
    """One line per op, in the reference's format, after one untimed pass
    over every op (the card leaves its idle clocks first)."""
    elements = SHAPE[0] * SHAPE[1]
    for op in OPS:
        run(op)
    for op in OPS:
        _, ms = run(op)
        per_elem_op = ms * 1e-3 / (R * elements)
        print(f"{op:10s}: {ms:7.4f} ms  {per_elem_op * 1e12:7.3f} ps/elem/iter "
              f"({1 / per_elem_op / 1e9:6.1f} Gelem-iter/s)", flush=True)
    return 0


__all__ = [
    "OPS",
    "R",
    "REPS",
    "SHAPE",
    "main",
    "probe_op_chain",
    "probe_op_chain_plain",
    "random_tile",
    "run",
]

if __name__ == "__main__":
    raise SystemExit(main())
