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
  the hops of one call share its ``call``);
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
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

#: ``None`` (the default: nothing is noted), or, while some thread records,
#: :func:`current`, which gives the calling thread's recording.
SINK: Optional[Callable[[], Optional["Schedule"]]] = None


@dataclass(frozen=True)
class Tile:
    """One operand or result of an :class:`Op`."""

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


def tile(tensor) -> Tile:
    key, size = storage_key(tensor)
    return Tile(
        str(tensor.dtype).replace("torch.", ""),
        tuple(int(s) for s in tensor.shape),
        key,
        int(tensor.numel()) * tensor.element_size(),
        size,
        int(tensor.storage_offset()),
        tuple(int(s) for s in tensor.stride()),
    )


def _shapes(tiles: Sequence[Tile]) -> tuple:
    return tuple((t.dtype, t.shape) for t in tiles)


@dataclass(frozen=True)
class Op:
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

    def signature(self) -> tuple:
        """What a card's run and the device-free audit must agree on: the
        call, its position, and each tile's dtype and shape (not where a
        view lies, nor the support)."""
        return (self.name, self.role, self.position, _shapes(self.reads),
                _shapes(self.writes), _shapes(self.results))


class Schedule:
    """The ops one recording noted, and the tensors they name (held until
    the recording is dropped, so no storage identity is reused)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        #: > 0 while a wrapper's own body runs.
        self.inside = 0
        #: Dispatched operations so far (a dispatch mode that watches the
        #: recording counts them here; 0 without one).
        self.events = 0
        self._calls = 0
        self._positions: List[int] = []
        self._held: list = []

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

    def note(self, name: str, role: str, reads=(), writes=(), results=(),
             position: Optional[int] = None, ring: Tuple[int, ...] = (),
             packed: bool = False, call: Optional[int] = None,
             support: Optional[int] = None) -> Op:
        if call is None:
            call = self._calls
            self._calls += 1
        tensors = [t for t in (*reads, *writes, *results) if t is not None]
        self.hold(tensors)
        op = Op(
            len(self.ops), name, role,
            tuple(tile(t) for t in reads if t is not None),
            tuple(tile(t) for t in writes),
            tuple(tile(t) for t in results),
            self.position if position is None else int(position),
            call, tuple(ring), bool(packed), self.events,
            None if support is None else int(support),
        )
        self.ops.append(op)
        return op

    def launch(self, fn: Callable, role: str, reads: Sequence, writes: Sequence,
               *args, packed: bool = False, support: Optional[int] = None, **kwargs):
        """Run the wrapper ``fn`` on ``args`` (its body unrecorded) and note
        it: ``reads`` and in-place ``writes`` among its operands, its
        returned tensor as the result (``support``: its sites that may be
        nonzero)."""
        result = self._run(fn, args, kwargs)
        self.note(fn.__name__, role, reads, writes, () if result is None else (result,),
                  packed=packed, support=support)
        return result

    def shift(self, fn: Callable, tiles, ready, positions, source):
        """Run ``ring_shift`` and note one op a hop into a position this
        process drives: the sent tile (none where another process sent
        it) and the received one, at the receiver, on its transfer
        stream."""
        out, events = self._run(fn, (tiles, ready, positions, source), {})
        call = self._calls
        self._calls += 1
        ring = tuple(p.index for p in positions)
        for p, q in enumerate(source):
            if out[p] is None:
                continue
            self.note("ring_shift", "shift", (tiles[q],), (), (out[p],),
                      position=positions[p].index, ring=ring, call=call)
        return out, events


_local = threading.local()
_lock = threading.Lock()
_recordings = 0


def current() -> Optional[Schedule]:
    """This thread's recording, unless one of its wrappers' bodies is
    running (a body's own calls are that one op)."""
    schedule = getattr(_local, "schedule", None)
    return schedule if schedule is not None and not schedule.inside else None


@contextlib.contextmanager
def recording() -> Iterator[Schedule]:
    """Record this thread's calls into a fresh :class:`Schedule` for the
    block; :data:`SINK` is :func:`current` while any thread records, so
    other threads' calls run as they do unrecorded."""
    global SINK, _recordings
    if getattr(_local, "schedule", None) is not None:
        raise RuntimeError("this thread is already recording a schedule")
    schedule = Schedule()
    with _lock:
        _recordings += 1
        SINK = current
    _local.schedule = schedule
    try:
        yield schedule
    finally:
        _local.schedule = None
        with _lock:
            _recordings -= 1
            if not _recordings:
                SINK = None


__all__ = ["Op", "SINK", "Schedule", "Tile", "current", "recording", "storage_key", "tile"]
