"""Collectives over the positions of a mesh, within a process and across
processes.

The reference runs ``lax.ppermute``, ``psum`` and ``all_gather`` inside
``shard_map``; here each process drives its own positions itself and the
hops between processes go through ``torch.distributed``:

- :func:`ring_shift` moves each position's buffer to the position that
  receives from it. Between two positions of one process it is a ``copy_``
  on the receiver's transfer stream, ordered by CUDA events on both sides
  (a peer copy between cards, a device copy on one card, a copy on the
  CPU). A hop whose ends lie in two processes is a paired ``isend`` /
  ``irecv``, every hop of a shift issued together through
  ``batch_isend_irecv`` so the ring cannot deadlock.
- :func:`all_reduce_sum` and :func:`all_gather_rows` are plain torch on the
  tensors this process holds (callers hand them tensors whose positions
  have joined, ``Mesh.join``), then ``all_reduce`` / a broadcast a
  position across processes.

Under gloo (the CPU, or several ranks sharing one card) a tensor crosses
processes through host memory: the sender copies it into pinned memory on
its transfer stream after the event that makes it whole and synchronises
before the send; the receiver copies it back on its transfer stream and
records an event after the copy. Under NCCL (every rank on its own card)
tensors move from the card directly. :data:`TRAFFIC` counts the bytes each
process sent to others and the bytes it staged through host memory.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_examples_tpu_torch.obs import schedule as _schedule
from spark_examples_tpu_torch.parallel.mesh import (
    Position,
    data_group,
    home_device,
    process_backend,
    spans_processes,
)

Event = Optional["torch.cuda.Event"]

#: Bytes this process sent to other processes (``cross_rank_bytes``: its
#: point-to-point payloads, its share of each reduction and the rows it
#: broadcast) and copied between a card and host memory to do so under
#: gloo (``host_staged_bytes``), since the last :func:`reset_traffic`.
TRAFFIC: Dict[str, int] = {"cross_rank_bytes": 0, "host_staged_bytes": 0}


def reset_traffic() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0


def _dist():
    import torch.distributed as dist

    return dist


def _nccl() -> bool:
    return process_backend() == "nccl"


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
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        recording.note("consume", "consume", (tensor,), position=position.index)
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


# ------------------------------------------------------ across processes


def _outgoing(tensor: torch.Tensor, position: Position, ready: Event) -> torch.Tensor:
    """``tensor`` as a process-to-process payload: itself on the CPU and
    under NCCL (after ``ready``), else a pinned host copy made on the
    position's transfer stream after ``ready``, synchronised."""
    tensor = tensor.contiguous()
    TRAFFIC["cross_rank_bytes"] += tensor.numel() * tensor.element_size()
    if not tensor.is_cuda:
        return tensor
    stream = position.comm_stream
    with torch.cuda.device(position.device), torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        if _nccl():
            payload = tensor
        else:
            payload = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            payload.copy_(tensor, non_blocking=True)
            TRAFFIC["host_staged_bytes"] += payload.numel() * payload.element_size()
    tensor.record_stream(stream)
    stream.synchronize()
    return payload


def _incoming(position: Position, like: torch.Tensor) -> torch.Tensor:
    """An empty payload buffer for a tensor shaped as ``like`` arriving at
    ``position``: on its device under NCCL, else in (pinned) host memory."""
    if position.cuda and _nccl():
        with torch.cuda.device(position.device), torch.cuda.stream(position.comm_stream):
            return torch.empty(like.shape, dtype=like.dtype, device=position.device)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=position.cuda)


def _landed(position: Position, payload: torch.Tensor) -> Tuple[torch.Tensor, Event]:
    """A received payload on ``position``'s device (a copy on its transfer
    stream under gloo), with the event after which it is whole."""
    if not position.cuda:
        return payload, None
    stream = position.comm_stream
    if payload.is_cuda:
        # The receive completed on the stream that was current at the wait.
        stream.wait_stream(torch.cuda.current_stream(position.device))
        payload.record_stream(stream)
        return payload, record(position, comm=True)
    with torch.cuda.device(position.device), torch.cuda.stream(stream):
        received = torch.empty(payload.shape, dtype=payload.dtype, device=position.device)
        received.copy_(payload, non_blocking=True)
    TRAFFIC["host_staged_bytes"] += payload.numel() * payload.element_size()
    return received, record(position, comm=True)


def _exchange(ops: list) -> None:
    """Issue a shift's point-to-point operations together and wait for
    them (under NCCL on the current stream of this process's card)."""
    if not ops:
        return
    for work in _dist().batch_isend_irecv(ops):
        work.wait()


def ring_shift(
    tiles: Sequence[Optional[torch.Tensor]],
    ready: Sequence[Event],
    positions: Sequence[Position],
    source: Sequence[int],
) -> Tuple[List[Optional[torch.Tensor]], List[Event]]:
    """Position ``p`` receives ``tiles[source[p]]``: a new tensor on its
    device, copied on its transfer stream once ``ready[source[p]]`` (the
    event after which the sent tile is whole) has passed. Returns the
    received tiles and the events after which each is whole; entries of
    positions another process drives are ``None`` (their tiles are, too).

    Within a process the copy for a ring's next step is issued before the
    step's product, so on a card the transfer and the product overlap; the
    events keep every read after its write. A hop between processes is an
    ``isend`` of the sender's process matched by an ``irecv`` of the
    receiver's (tagged with the receiving position), the shift's hops
    issued together and waited for before the shift returns; every process
    of the ring runs the same shifts in the same order."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.shift(ring_shift, tiles, ready, positions, source)
    dist = _dist() if spans_processes(positions) else None
    out: List[Optional[torch.Tensor]] = [None] * len(positions)
    events: List[Event] = [None] * len(positions)
    ops, arriving = [], []
    for p, q in enumerate(source):
        dst, sender = positions[p], positions[q]
        if not dst.local:
            if sender.local:
                payload = _outgoing(tiles[q], sender, ready[q])
                ops.append(dist.P2POp(dist.isend, payload, dst.rank, group=data_group(), tag=p))
            continue
        if not sender.local:
            payload = _incoming(dst, next(t for t in tiles if t is not None))
            ops.append(dist.P2POp(dist.irecv, payload, sender.rank, group=data_group(), tag=p))
            arriving.append((p, payload))
            continue
        src = tiles[q]
        if not dst.cuda:
            out[p] = src.to(dst.device, copy=True)
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
        out[p] = received
        events[p] = record(dst, comm=True)
    _exchange(ops)
    for p, payload in arriving:
        out[p], events[p] = _landed(positions[p], payload)
    return out, events


def _to_wire(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` where a collective takes it: the card under NCCL, the
    host under gloo (counted as staged when it leaves a card)."""
    if tensor.is_cuda and not _nccl():
        TRAFFIC["host_staged_bytes"] += tensor.numel() * tensor.element_size()
        return tensor.cpu()
    return tensor.contiguous()


def _from_wire(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and not tensor.is_cuda:
        TRAFFIC["host_staged_bytes"] += tensor.numel() * tensor.element_size()
    return tensor.to(device)


def rank_reduce(tensor: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``tensor`` summed (or maxed, ``op="max"``) elementwise over the
    processes of ``group`` (default: every process), on ``tensor``'s
    device. Every process of the group calls it at the same point."""
    dist = _dist()
    wire = _to_wire(tensor)
    TRAFFIC["cross_rank_bytes"] += wire.numel() * wire.element_size()
    reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(wire, op=reduce_op, group=data_group() if group is None else group)
    return _from_wire(wire, tensor.device)


@functools.lru_cache(maxsize=None)
def rank_group(ranks: Tuple[int, ...]):
    """The process group of ``ranks`` (made once; every process of the
    run must ask for the same groups in the same order, as
    ``torch.distributed.new_group`` requires). ``None`` is the default
    group, the answer when ``ranks`` are all the run's processes."""
    dist = _dist()
    if len(ranks) == dist.get_world_size():
        return data_group()
    return dist.new_group(list(ranks), backend="nccl" if _nccl() else "gloo")


def _local_sum(tensors: Sequence[Optional[torch.Tensor]], like) -> torch.Tensor:
    held = [t for t in tensors if t is not None]
    if not held:
        shape, dtype = like
        return torch.zeros(shape, dtype=dtype, device=home_device())
    total = held[0].clone()
    for t in held[1:]:
        total += t.to(total.device)
    return total


def all_reduce_sum(
    tensors: Sequence[Optional[torch.Tensor]],
    shared: bool = False,
    like=None,
) -> List[Optional[torch.Tensor]]:
    """The elementwise sum of every position's tensor, on each tensor's
    device (the reference's ``psum``). On a ``shared`` mesh (the tensors of
    other processes' positions ``None`` here) this process's sum joins an
    ``all_reduce`` over every process; ``like`` (shape, dtype) shapes the
    zero share of a process that holds none of the tensors."""
    total = _local_sum(tensors, like)
    if shared:
        total = rank_reduce(total)
    return [
        None if t is None else (total if t.device == total.device else total.to(t.device))
        for t in tensors
    ]


def all_gather_rows(
    tensors: Sequence[Optional[torch.Tensor]],
    positions: Optional[Sequence[Position]] = None,
    like=None,
) -> List[torch.Tensor]:
    """Every position's rows, concatenated in position order, on each
    tensor's device (the reference's tiled ``all_gather`` over axis 0).
    ``positions`` (given for a shared mesh, whose other processes'
    tensors are ``None`` here) name the process each position's rows are
    broadcast from to every process — the entries of those positions then
    hold the gathered rows on this process's first device; ``like``
    (shape, dtype) is the shape of one position's rows."""
    held = [t for t in tensors if t is not None]
    device = held[0].device if held else home_device()
    if positions is None:
        gathered = torch.cat([t.to(device) for t in tensors], dim=0)
    else:
        dist = _dist()
        shape, dtype = like
        parts = []
        for tensor, position in zip(tensors, positions):
            if position.local:
                wire = _to_wire(tensor)
                TRAFFIC["cross_rank_bytes"] += wire.numel() * wire.element_size()
            else:
                wire = torch.empty(shape, dtype=dtype, device=device if _nccl() else "cpu")
            dist.broadcast(wire, src=position.rank, group=data_group())
            parts.append(tensor.to(device) if position.local else _from_wire(wire, device))
        gathered = torch.cat(parts, dim=0)
    return [
        gathered if t is None or t.device == device else gathered.to(t.device)
        for t in tensors
    ]


__all__ = [
    "TRAFFIC",
    "all_gather_rows",
    "all_reduce_sum",
    "consume",
    "fetch",
    "rank_group",
    "rank_reduce",
    "record",
    "reset_traffic",
    "ring_shift",
]
