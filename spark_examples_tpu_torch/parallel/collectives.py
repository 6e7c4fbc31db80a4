"""Collectives over the positions of one process's mesh.

The reference runs ``lax.ppermute``, ``psum`` and ``all_gather`` inside
``shard_map``; here one controller drives every position itself:

- :func:`ring_shift` moves each position's buffer to the position that
  receives from it: a ``copy_`` on the receiver's transfer stream, ordered
  by CUDA events on both sides. Between cards it is a peer copy; on one
  card a device copy. On the CPU it is a copy.
- :func:`all_reduce_sum` and :func:`all_gather_rows` are plain torch on the
  gathered tensors, on the current streams: callers hand them tensors
  whose positions have joined (``Mesh.join``).

No NCCL: one process owns every position.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_examples_tpu_torch.parallel.mesh import Position

Event = Optional["torch.cuda.Event"]


def record(position: Position, comm: bool = False) -> Event:
    """An event after the work queued so far on ``position``'s compute (or
    transfer) stream; ``None`` on the CPU."""
    if not position.cuda:
        return None
    event = torch.cuda.Event()
    event.record(position.comm_stream if comm else position.stream)
    return event


def consume(position: Position, tensor: torch.Tensor, ready: Event) -> None:
    """Make ``position``'s compute stream wait for ``ready`` before it reads
    ``tensor`` (on its device), and keep ``tensor``'s memory until that
    stream is done with it (the tensor may have been made on another
    stream)."""
    if position.cuda:
        if ready is not None:
            position.stream.wait_event(ready)
        tensor.record_stream(position.stream)


def fetch(position: Position, tensor: torch.Tensor, ready: Event) -> torch.Tensor:
    """``tensor`` (whole after ``ready``) readable on ``position``'s compute
    stream: itself on the same device, else a copy made after ``ready``
    (PyTorch orders a copy between cards after the current streams of
    both)."""
    if tensor.device == position.device:
        consume(position, tensor, ready)
        return tensor
    if ready is not None:
        position.stream.wait_event(ready)
    with position.run():
        out = tensor.to(position.device)
    if tensor.is_cuda:
        tensor.record_stream(torch.cuda.current_stream(tensor.device))
    return out


def ring_shift(
    tiles: Sequence[torch.Tensor],
    ready: Sequence[Event],
    positions: Sequence[Position],
    source: Sequence[int],
) -> tuple[List[torch.Tensor], List[Event]]:
    """Position ``p`` receives ``tiles[source[p]]``: a new tensor on its
    device, copied on its transfer stream once ``ready[source[p]]`` (the
    event after which the sent tile is whole) has passed. Returns the
    received tiles and the events after which each is whole.

    The copy for a ring's next step is issued before the step's product, so
    on a card the transfer and the product overlap; the events keep every
    read after its write."""
    out: List[torch.Tensor] = []
    events: List[Event] = []
    for p, q in enumerate(source):
        dst, src = positions[p], tiles[q]
        if not dst.cuda:
            out.append(src.to(dst.device, copy=True))
            events.append(None)
            continue
        stream = dst.comm_stream
        with torch.cuda.device(dst.device), torch.cuda.stream(stream):
            if ready[q] is not None:
                stream.wait_event(ready[q])
            received = torch.empty_like(src, device=dst.device)
            received.copy_(src, non_blocking=True)
        # The sent tile lives on another stream: keep it until this copy has
        # read it (a copy between cards runs on the sender's current stream,
        # after the receiver's transfer stream).
        src.record_stream(stream if src.device == dst.device
                          else torch.cuda.current_stream(src.device))
        out.append(received)
        events.append(record(dst, comm=True))
    return out, events


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sum of every position's tensor, on each tensor's
    device (the reference's ``psum``)."""
    total = tensors[0].clone()
    for t in tensors[1:]:
        total += t.to(total.device)
    return [total if t.device == total.device else total.to(t.device) for t in tensors]


def all_gather_rows(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every position's rows, concatenated in position order, on each
    tensor's device (the reference's tiled ``all_gather`` over axis 0)."""
    device = tensors[0].device
    gathered = torch.cat([t.to(device) for t in tensors], dim=0)
    return [gathered if t.device == device else gathered.to(t.device) for t in tensors]


__all__ = ["all_gather_rows", "all_reduce_sum", "consume", "fetch", "record", "ring_shift"]
