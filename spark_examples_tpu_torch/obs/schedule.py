"""The recorded schedule: the port's device program, call by call.

The reference's device program is a jaxpr, which ``graftcheck ir`` walks.
The port's is eager Python that launches hand-written kernels and moves
tiles between positions on streams, so what the card executes is exactly
the sequence of those calls. While a thread records (:func:`recording`),
each kernel wrapper and each ring transfer it calls notes one
:class:`Op` into its :class:`Schedule`:

- ``generate``: ``ops/devicegen.py:gen_genotypes``;
- ``product``: ``gram_accumulate``, ``cross_accumulate``,
  ``ops/batched.py:stacked_gram_accumulate`` (their accumulator operand is
  written in place: ``writes``);
- ``unpack``: ``ops/gramian.py:unpack_rows_t``, ``ops/batched.py:
  stacked_unpack_rows_t`` (``packed`` when the block is bit-packed, not
  count-valued);
- ``pack``: ``ops/gramian.py:pack_rows_t`` (``packed``), and
  ``transpose_rows_t`` (the unpacked wire's rows);
- ``shift``: ``parallel/collectives.py:ring_shift``, one op a hop into a
  position this process drives (the position's transfer stream on a card;
  the hops of one call share its ``call``; ``source`` is the sender's
  mesh index, which places the hop on a link: ``check/sched.py``);
- ``consume``: ``parallel/collectives.py:consume``, a position's compute
  stream taking a received tile.

Each operand and result is a :class:`Tile`: dtype, shape, the identity
of its storage, and where the view lies in it (offset and strides, in
elements: which columns of a row tile a ring step's product writes).
``position`` is the mesh index of the position whose work it is
(``Position.run`` sets it; a shift's is its receiver's, whose transfer
stream it runs on). A wrapper's own body runs with :attr:`Schedule.inside`
raised, so the plain versions' PyTorch ops (on the CPU and ``meta``
tensors) read as that one kernel. While no thread records, :data:`SINK`
is ``None`` and the hot path pays one global read a launch; other
threads' calls are never noted.

A recording of the schedule alone (``recording(shapes_only=True)``:
``check/ir.py``'s recordings without a dispatch watch — the plan's
audits, the schedule prover's rings of 256 positions) runs each
wrapper's body on CPU or ``meta`` operands once for each layout of
them, and answers every later call of that layout with an unwritten
result of the same layout (a product, which writes in place, with
none). The ops it notes are those of a full recording; the values the
program computes are not. A kernel on the card launches every call.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: ``None`` (the default: nothing is noted), or, while some thread records,
#: :func:`current`, which gives the calling thread's recording.
SINK: Optional[Callable[[], Optional["Schedule"]]] = None


class Tile(NamedTuple):
    """One operand or result of an :class:`Op` (a tuple: a pod-sized
    recording notes half a million of them)."""

    dtype: str
    shape: Tuple[int, ...]
    storage: int  #: identity of the storage (shared by every view of it)
    nbytes: int  #: bytes of the elements this tensor spans
    storage_nbytes: int  #: bytes of the whole storage
    offset: int = 0  #: the view's first element in its storage
    strides: Tuple[int, ...] = ()  #: the view's strides, in elements


def storage_key(tensor) -> Tuple[int, int]:
    """``(storage identity, storage bytes)`` of a tensor: its storage's
    address (the same for every view, and for ``meta`` tensors too, whose
    data pointers are all 0) and size."""
    storage = tensor.untyped_storage()
    return storage._cdata, storage.nbytes()


_new_tile = tuple.__new__  # a Tile with every field, without the keyword defaults' cost

#: ``torch.dtype`` → its name without the ``torch.`` prefix.
_DTYPE_NAMES: Dict[object, str] = {}


def tile(tensor) -> Tile:
    dtype = tensor.dtype
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).replace("torch.", "")
    storage = tensor.untyped_storage()
    return _new_tile(Tile, (name, tuple(tensor.shape), storage._cdata,
                            tensor.numel() * tensor.element_size(), storage.nbytes(),
                            tensor.storage_offset(), tensor.stride()))


def _shapes(tiles: Sequence[Tile]) -> tuple:
    return tuple((t.dtype, t.shape) for t in tiles)


class Op(NamedTuple):
    """One call the device program issued, in issue order (``index``)."""

    index: int
    name: str
    role: str
    reads: Tuple[Tile, ...]
    writes: Tuple[Tile, ...]
    results: Tuple[Tile, ...]
    position: Optional[int]
    call: int  #: the wrapper call (the hops of one shift share it)
    ring: Tuple[int, ...] = ()  #: a shift's positions, in ring order
    packed: bool = False  #: reads (unpack) or makes (pack) a bit-packed tile
    events_before: int = 0  #: dispatched operations before this op's own
    #: The sites of the result that may be nonzero (an unpack's rows, a
    #: generated block's sites; the rest is the tiling's zero padding).
    support: Optional[int] = None
    source: Optional[int] = None  #: a shift hop's sending position

    def signature(self) -> tuple:
        """What a card's run and the device-free audit must agree on: the
        call, its position, and each tile's dtype and shape (not where a
        view lies, nor the support, nor a hop's sender)."""
        return (self.name, self.role, self.position, _shapes(self.reads),
                _shapes(self.writes), _shapes(self.results))


class Schedule:
    """The ops one recording noted, and the tensors they name (held until
    the recording is dropped, so no storage identity is reused)."""

    def __init__(self, shapes_only: bool = False) -> None:
        self.ops: List[Op] = []
        #: Run a wrapper's body once a layout of its operands (see above).
        self.shapes_only = shapes_only
        self._layouts: Dict[tuple, Optional[tuple]] = {}
        #: > 0 while a wrapper's own body runs.
        self.inside = 0
        #: Dispatched operations so far (a dispatch mode that watches the
        #: recording counts them here; 0 without one).
        self.events = 0
        self._calls = 0
        self._positions: List[int] = []
        self._held: list = []
        #: Each noted tensor's tile, by the tensor's identity: the recording
        #: holds every tensor it notes, so no identity is reused, and the
        #: device program changes no tensor's shape or storage in place.
        self._tiles: Dict[int, Tile] = {}

    @property
    def position(self) -> Optional[int]:
        return self._positions[-1] if self._positions else None

    def enter(self, index: int) -> None:
        self._positions.append(int(index))

    def leave(self) -> None:
        self._positions.pop()

    def hold(self, tensors: Sequence) -> None:
        self._held.extend(tensors)

    def _run(self, fn: Callable, args, kwargs):
        self.inside += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self.inside -= 1

    def _run_once(self, fn: Callable, args, kwargs):
        """``fn``'s result, its body run for the first call of each layout
        of the operands (arguments of other kinds than tensors and plain
        values run it every call)."""
        key = self._layout_key(fn, args, kwargs)
        if key is None:
            return self._run(fn, args, kwargs)
        if key not in self._layouts:
            result = self._run(fn, args, kwargs)
            self._layouts[key] = None if result is None else (
                tuple(result.shape), result.stride(), result.dtype, result.device)
            return result
        layout = self._layouts[key]
        if layout is None:
            return None
        shape, stride, dtype, device = layout
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)

    def note(self, name: str, role: str, reads=(), writes=(), results=(),
             position: Optional[int] = None, ring: Tuple[int, ...] = (),
             packed: bool = False, call: Optional[int] = None,
             support: Optional[int] = None, source: Optional[int] = None) -> Op:
        if call is None:
            call = self._calls
            self._calls += 1
        reads = [t for t in reads if t is not None]
        held = self._held
        held += reads
        held += writes
        held += results
        tiles = self._tiles_of
        op = Op(
            len(self.ops), name, role,
            tiles(reads), tiles(writes) if writes else (), tiles(results) if results else (),
            (self._positions[-1] if self._positions else None) if position is None
            else int(position),
            call, tuple(ring), bool(packed), self.events,
            None if support is None else int(support),
            None if source is None else int(source),
        )
        self.ops.append(op)
        return op

    def _layout_key(self, fn: Callable, args, kwargs) -> Optional[tuple]:
        """``fn`` and the layout of its arguments: each tensor's dtype,
        shape, strides (from its tile, which the op's note reuses) and
        whether it is a ``meta`` one, every other argument itself;
        ``None`` where an argument is neither, or is a tensor on the card."""
        key: list = [fn, tuple(kwargs)]
        tiles = self._tiles
        for value in (*args, *kwargs.values()):
            if isinstance(value, torch.Tensor):
                if value.is_cuda:
                    return None
                noted = tiles.get(id(value))
                if noted is None:
                    noted = tiles[id(value)] = tile(value)
                key.append((noted.dtype, noted.shape, noted.strides, value.is_meta))
            elif isinstance(value, _PLAIN):
                key.append(value)
            else:
                return None
        return tuple(key)

    def _tiles_of(self, tensors) -> Tuple[Tile, ...]:
        noted, tiles = self._tiles, []
        for tensor in tensors:
            found = noted.get(id(tensor))
            if found is None:
                found = noted[id(tensor)] = tile(tensor)
            tiles.append(found)
        return tuple(tiles)

    def launch(self, fn: Callable, role: str, reads: Sequence, writes: Sequence,
               *args, packed: bool = False, support: Optional[int] = None, **kwargs):
        """Run the wrapper ``fn`` on ``args`` (its body unrecorded) and note
        it: ``reads`` and in-place ``writes`` among its operands, its
        returned tensor as the result (``support``: its sites that may be
        nonzero)."""
        result = (self._run_once(fn, args, kwargs) if self.shapes_only
                  else self._run(fn, args, kwargs))
        self.note(fn.__name__, role, reads, writes, () if result is None else (result,),
                  packed=packed, support=support)
        return result

    def shift(self, fn: Callable, tiles, ready, positions, source):
        """Run ``ring_shift`` and note one op a hop into a position this
        process drives: the sent tile (none where another process sent
        it) and the received one, at the receiver, on its transfer
        stream, with the sender's index."""
        out, events = self._run(fn, (tiles, ready, positions, source), {})
        call = self._calls
        self._calls += 1
        ring = tuple(p.index for p in positions)
        ops, held, tiles_of = self.ops, self._held, self._tiles_of
        for p, q in enumerate(source):
            received, sent = out[p], tiles[q]
            if received is None:
                continue
            sent = () if sent is None else (sent,)
            held += sent
            held.append(received)
            ops.append(Op(len(ops), "ring_shift", "shift", tiles_of(sent), (),
                          tiles_of((received,)), positions[p].index, call, ring, False,
                          self.events, None, positions[q].index))
        return out, events


#: Argument types that :meth:`Schedule._layout_key` keys by value.
_PLAIN = (bool, int, float, str, type(None))


_local = threading.local()
_lock = threading.Lock()
_recordings = 0
#: Blocks inside :func:`collector_paused`, and whether the collector ran
#: before the first of them.
_pauses = 0
_collecting = False


@contextlib.contextmanager
def collector_paused() -> Iterator[None]:
    """Pause Python's cyclic garbage collector for the block (in every
    thread, until the last such block ends): a pod-sized recording and its
    audit make and keep a million objects, each of which every collection
    would scan again."""
    global _pauses, _collecting
    with _lock:
        if not _pauses:
            _collecting = gc.isenabled()
            gc.disable()
        _pauses += 1
    try:
        yield
    finally:
        with _lock:
            _pauses -= 1
            if not _pauses and _collecting:
                gc.enable()


def current() -> Optional[Schedule]:
    """This thread's recording, unless one of its wrappers' bodies is
    running (a body's own calls are that one op)."""
    schedule = getattr(_local, "schedule", None)
    return schedule if schedule is not None and not schedule.inside else None


@contextlib.contextmanager
def recording(shapes_only: bool = False) -> Iterator[Schedule]:
    """Record this thread's calls into a fresh :class:`Schedule` for the
    block (``shapes_only``: the schedule alone, see above); :data:`SINK`
    is :func:`current` while any thread records, so other threads' calls
    run as they do unrecorded."""
    global SINK, _recordings
    if getattr(_local, "schedule", None) is not None:
        raise RuntimeError("this thread is already recording a schedule")
    schedule = Schedule(shapes_only)
    with _lock:
        _recordings += 1
        SINK = current
    _local.schedule = schedule
    try:
        with collector_paused() if shapes_only else contextlib.nullcontext():
            yield schedule
    finally:
        _local.schedule = None
        with _lock:
            _recordings -= 1
            if not _recordings:
                SINK = None


__all__ = ["Op", "SINK", "Schedule", "Tile", "collector_paused", "current", "recording",
           "storage_key", "tile"]
