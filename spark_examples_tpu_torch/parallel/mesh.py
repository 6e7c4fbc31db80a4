"""The device mesh: named axes over positions, its processes, and its
arithmetic.

The port of ``spark_examples_tpu/parallel/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over the global devices of its processes and runs its
collectives inside ``shard_map``. The port keeps that model: a
:class:`Mesh` is a grid of :class:`Position` objects with named axes
(``data``, ``samples``, and ``hosts`` for the hierarchical factorisation),
each position one ``torch.device`` of one process (its ``rank``), with a
CUDA stream for its work and one for its transfers. The collectives are
``parallel/collectives.py``.

- ``data`` axis: the site dimension. Each data slice accumulates a
  different span of the site grid into its own partial Gramian; the
  partials are summed once at finalize (:func:`data_axis_sum` in
  ``ops/gramian.py``, the reference's ``psum`` over ``data``).
  ``--num-reduce-partitions`` caps it (:func:`default_mesh`).
- ``samples`` axis: the cohort dimension. The Gramian lives as row tiles,
  one a position, and each block's column tiles circulate around the ring
  (``ops/gramian.py:ring_pass``).

A position is a place, not a card: a caller may name one device several
times (``make_mesh(shape, [torch.device("cuda", 0)] * 4)``), the counterpart
of the reference tests' virtual CPU devices. Positions on one card run
their work on their own streams, and the ring's transfers become device
copies there. On ``--device cpu`` every position is the CPU.

**Processes** (the reference's ``jax.distributed``): :func:`distributed_init`
joins this process to a ``torch.distributed`` group from the
``--coordinator-address``/``--num-processes``/``--process-id`` flags. Every
process runs the same host program over the same global mesh — each brings
the same number of positions, ranks in order (:func:`global_places`) — and
does the work of its own positions only (``Position.local``); what crosses
processes goes through ``parallel/collectives.py``. The backend follows one
rule, recorded in the manifest (:func:`process_backend`): ``gloo`` on the
CPU and when two ranks share one card (NCCL refuses that), ``nccl`` when
every rank owns its card; a failed NCCL set-up raises.

Beside the mesh, the reference's JAX-free arithmetic: the cohort padding
and ring traffic formulas, the topology and reduction-schedule rules, and
the peak host-memory bound :func:`host_peak_bytes`. The manifest keeps the
reference's field names ``predicted_ici_bytes``/``predicted_dcn_bytes``;
in the port they are the bytes the schedule keeps inside one host and the
bytes that cross hosts. No link bandwidth is carried over: the reference's
defaults are a TPU's.
"""

from __future__ import annotations

import contextlib
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_examples_tpu_torch.obs import schedule as _schedule

DATA_AXIS = "data"
SAMPLES_AXIS = "samples"
#: Outer axis of the hierarchical (two-level) reduction mesh: the samples
#: axis factored host-major into ``hosts x samples``, so the inner ring's
#: neighbours share a host by construction (:func:`hierarchical_mesh`).
HOST_AXIS = "hosts"

#: Rehearsal override of the hierarchical schedule's host factor
#: (:func:`resolve_hier_hosts`): a single-process run exercises a real
#: two-level schedule (2 "hosts" x 2 positions on 4 positions).
HIER_HOSTS_ENV = "SPARK_EXAMPLES_TPU_HIER_HOSTS"

#: Genotypes per byte on the packed ring wire (np.packbits bit order). Every
#: position's column width must be a whole number of bytes.
RING_PACK_MULTIPLE = 8


def padded_cohort(num_columns: int, samples_parallel: int, pack: bool = True) -> int:
    """Column count after cohort padding for the sharded ring Gramian: a
    multiple of the ``samples`` axis (equal column tiles) and, with the
    bit-packed wire, of 8 per position (a packed tile is whole bytes).
    Pad columns are all-zero and finalize trims them."""
    multiple = int(samples_parallel) * (RING_PACK_MULTIPLE if pack else 1)
    return -(-int(num_columns) // multiple) * multiple


def ring_traffic_bytes(rows: int, samples_parallel: int, n_local: int, packed: bool) -> int:
    """Total bytes one ring pass moves for ``rows`` variant rows: each of
    the ``samples_parallel`` positions sends its ``(rows, width)`` column
    tile ``samples_parallel - 1`` times, ``width`` being ``n_local`` bytes
    unpacked or ``n_local / 8`` packed. The one formula behind the
    ``gramian_ring_bytes`` counter and the manifest's ``schedule`` block."""
    width = int(n_local) // RING_PACK_MULTIPLE if packed else int(n_local)
    return int(rows) * int(samples_parallel) * (int(samples_parallel) - 1) * width


#: The link rates a :class:`Topology` declares by default: an H100 fleet's
#: published datasheet figures, not measurements (a single card measures
#: neither link). Intra-host, per device and direction: NVLink 4 on the
#: H100 SXM5, 900 GB/s a GPU both ways. Inter-host, one link shared by a
#: host's devices: an 8-GPU HGX/DGX H100 host's fabric, 8 x 400 Gb/s NDR.
#: The card the port is measured on reports itself as "NVIDIA H100 80GB
#: HBM3, 700.00 W" (nvidia-smi --query-gpu=name,power.limit).
DEFAULT_ICI_BYTES_PER_S = 450 * 10**9
DEFAULT_DCN_BYTES_PER_S = 400 * 10**9


@dataclass(frozen=True)
class Topology:
    """A fleet the schedule is planned against: ``hosts`` machines x
    ``devices_per_host`` devices, intra-host links at ``ici_bytes_per_s``
    a device, one ``dcn_bytes_per_s`` inter-host link shared by a host's
    devices (the reference's names and meaning; an H100 fleet's rates by
    default). Declarative: it is never queried from a runtime."""

    hosts: int
    devices_per_host: int
    ici_bytes_per_s: int = DEFAULT_ICI_BYTES_PER_S
    dcn_bytes_per_s: int = DEFAULT_DCN_BYTES_PER_S

    def __post_init__(self) -> None:
        if self.hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"topology needs hosts >= 1 and devices_per_host >= 1, got "
                f"{self.hosts}x{self.devices_per_host}"
            )
        if self.ici_bytes_per_s <= 0 or self.dcn_bytes_per_s <= 0:
            raise ValueError("topology link bandwidths must be positive")

    @property
    def devices(self) -> int:
        return self.hosts * self.devices_per_host

    def describe(self) -> str:
        return f"{self.hosts}x{self.devices_per_host}"


def parse_topology(spec: str) -> Topology:
    """Parse ``'hosts,devices_per_host'`` (e.g. ``'32,8'``)."""
    parts = [p for p in spec.split(",") if p.strip()]
    if len(parts) != 2:
        raise ValueError(f"--topology expects 'hosts,devices_per_host', got {spec!r}")
    try:
        hosts, per_host = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--topology expects integer 'hosts,devices_per_host', got {spec!r}"
        ) from None
    return Topology(hosts, per_host)


class LevelTraffic(NamedTuple):
    """Bytes of one reduction schedule by link class (whole mesh, one pass
    over ``rows``): ``ici_bytes`` stay inside a host, ``dcn_bytes`` cross
    hosts (the reference's names)."""

    ici_bytes: int
    dcn_bytes: int

    @property
    def total(self) -> int:
        return self.ici_bytes + self.dcn_bytes


def hierarchical_traffic_bytes(
    rows: int, hosts: int, devices_per_host: int, n_local: int, packed: bool
) -> LevelTraffic:
    """Per-level bytes of the two-level schedule: per position and pass,
    the inner ring sends the held tile ``devices_per_host - 1`` times per
    outer step (``hosts`` outer steps) inside the host, and the outer ring
    sends it ``hosts - 1`` times across hosts. The total equals the flat
    ring's."""
    h, d = int(hosts), int(devices_per_host)
    width = int(n_local) // RING_PACK_MULTIPLE if packed else int(n_local)
    per_send = int(rows) * width
    devices = h * d
    return LevelTraffic(
        ici_bytes=per_send * devices * h * (d - 1),
        dcn_bytes=per_send * devices * (h - 1),
    )


def flat_traffic_split(rows: int, topology: Topology, n_local: int, packed: bool) -> LevelTraffic:
    """The flat ring's provable split on ``topology``: on one host every
    byte stays inside it; across hosts no hop is provably intra-host, so
    the whole circulation counts as crossing."""
    total = ring_traffic_bytes(rows, topology.devices, n_local, packed)
    if topology.hosts == 1:
        return LevelTraffic(ici_bytes=total, dcn_bytes=0)
    return LevelTraffic(ici_bytes=0, dcn_bytes=total)


def resolve_reduce_schedule(spec: str, hosts: int) -> str:
    """``--reduce-schedule`` → ``flat`` or ``hier``; ``auto`` is ``hier``
    exactly when the samples axis spans more than one host."""
    if spec not in ("auto", "flat", "hier"):
        raise ValueError(f"--reduce-schedule must be one of auto/flat/hier, got {spec!r}")
    if spec == "auto":
        return "hier" if int(hosts) > 1 else "flat"
    return spec


def resolve_hier_hosts(
    samples_parallel: int, explicit: Optional[int] = None, hosts: Optional[int] = None
) -> int:
    """The host factor of the hierarchical factorisation: ``explicit``, else
    :data:`HIER_HOSTS_ENV`, else ``hosts`` (default: the run's process
    count, :func:`process_count`). It must divide the samples axis."""
    if explicit is None:
        env = os.environ.get(HIER_HOSTS_ENV)
        if env:
            explicit = int(env)
    if explicit is None:
        explicit = process_count() if hosts is None else hosts
    hosts = max(1, int(explicit))
    if int(samples_parallel) % hosts:
        raise ValueError(
            f"hierarchical schedule needs the host factor ({hosts}) to "
            f"divide the samples axis ({samples_parallel}); choose a mesh "
            "whose samples axis is a multiple of the host count"
        )
    return hosts


# ----------------------------------------------------------- processes

#: Seconds a process waits to join its group (and for any collective)
#: unless the caller names a limit: a missing peer or a bad coordinator
#: fails the run instead of hanging it.
DEFAULT_INIT_TIMEOUT = 300.0
#: Environment variable that replaces :data:`DEFAULT_INIT_TIMEOUT`
#: (seconds): how a harness bounds the CLI processes it starts.
DIST_TIMEOUT_ENV = "SPARK_EXAMPLES_TPU_DIST_TIMEOUT"

#: This process's part in a run of several: ``backend`` (``gloo`` or
#: ``nccl``), ``group`` (the group tensors move through: the default gloo
#: group, or the NCCL group over it), ``home`` (the device of this
#: process's positions) and ``rank``/``count``.
_PROCESS: Dict[str, object] = {"backend": None, "group": None, "home": None, "rank": 0, "count": 1}


def _dist():
    import torch.distributed as dist

    return dist


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout: Optional[float] = None,
    device: Union[str, torch.device, None] = None,
) -> None:
    """Join this process to a run of several (``torch.distributed``), the
    reference's ``distributed_init`` (its ``jax.distributed.initialize``).

    A no-op when all three flags are ``None``; a partly given set raises
    the reference's ``ValueError`` (a run over 1/N of the fleet must not
    start silently). ``device`` (``cpu`` or ``cuda``, default ``cuda``)
    names where this process's positions live: on CUDA its card is
    ``cuda:(rank mod device_count)`` (:func:`local_cards`), and a process
    that finds no card raises. ``timeout`` (seconds) bounds the rendezvous
    and every later collective; without it, :data:`DIST_TIMEOUT_ENV` or
    :data:`DEFAULT_INIT_TIMEOUT`.

    The backend rule: the default group is ``gloo``. On CUDA every rank
    publishes ``(hostname, card uuid)``; when two ranks share a card the
    run stays on gloo (tensors staged through host memory,
    ``parallel/collectives.py``), otherwise an NCCL group is made over the
    same ranks and carries the tensors. A failed NCCL set-up raises; it
    never falls back to gloo."""
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return
    if any(v is None for v in given):
        raise ValueError(
            "multi-host init needs --coordinator-address and --num-processes "
            f"(got coordinator_address={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})"
        )
    count, rank = int(num_processes), int(process_id)
    if not 0 <= rank < count:
        raise ValueError(f"--process-id {rank} outside [0, {count})")
    if (_PROCESS["rank"], _PROCESS["count"]) == (rank, count) and count > 1:
        return  # joined already
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"process {rank} was asked for CUDA and has no CUDA device"
            )
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist = _dist()
    if timeout is None:
        timeout = float(os.environ.get(DIST_TIMEOUT_ENV, DEFAULT_INIT_TIMEOUT))
    limit = timedelta(seconds=float(timeout))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=count,
        rank=rank, timeout=limit,
    )
    backend, group = "gloo", None
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        card = (socket.gethostname(), str(getattr(props, "uuid", device.index)))
        cards: List[object] = [None] * count
        dist.all_gather_object(cards, card)
        if len(set(cards)) == count:
            # Every rank owns its card: tensors move over NCCL. Its first
            # collective runs here, on every rank, so a broken NCCL fails
            # the set-up (and later point-to-point batches may involve a
            # subset of ranks).
            group = dist.new_group(backend="nccl", timeout=limit)
            probe = torch.ones(1, device=device)
            dist.all_reduce(probe, group=group)
            torch.cuda.synchronize(device)
            backend = "nccl"
    _PROCESS.update(backend=backend, group=group, home=device, rank=rank, count=count)
    print(
        f"Process {rank} of {count} joined at {coordinator_address} "
        f"({backend} on {device.type})."
    )


def distributed_shutdown() -> None:
    """Leave the run's group (a no-op in a run of one process)."""
    if _PROCESS["count"] > 1:
        _dist().destroy_process_group()
    _PROCESS.update(backend=None, group=None, home=None, rank=0, count=1)


def process_index() -> int:
    """This process's rank (0 in a run of one)."""
    return int(_PROCESS["rank"])


def process_count() -> int:
    """The run's number of processes (1 without :func:`distributed_init`)."""
    return int(_PROCESS["count"])


def process_backend() -> Optional[str]:
    """The backend :func:`distributed_init` chose (``gloo``/``nccl``);
    ``None`` in a run of one process."""
    return _PROCESS["backend"]


def data_group():
    """The group tensors cross processes through (``None``: the default
    group)."""
    return _PROCESS["group"]


def home_device() -> torch.device:
    """The device of this process's positions: the one
    :func:`distributed_init` set up, else the CPU (a process that holds
    no position of a mesh still needs a device for its share of a
    collective)."""
    home = _PROCESS["home"]
    return home if home is not None else torch.device("cpu")


def local_cards() -> List[torch.device]:
    """The cards this process drives: every card in a run of one process;
    in a run of several, ``cuda:(rank mod device_count)`` — one card a
    rank, all ranks on ``cuda:0`` of a one-card host."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass CPU devices to build a mesh on the CPU"
        )
    if process_count() > 1:
        return [torch.device("cuda", process_index() % torch.cuda.device_count())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Place(NamedTuple):
    """A device of the run and the rank of the process that drives it."""

    device: torch.device
    rank: int


def global_places(devices: Sequence, local: bool = False) -> List[Place]:
    """The places a mesh is built over: ``devices`` are this process's; in
    a run of several processes (and unless ``local``) every process brings
    as many, so the run's places are each rank's devices, ranks in order
    (the reference's ``jax.devices()``). Places pass through unchanged."""
    places = [
        d if isinstance(d, Place) else Place(torch.device(d), process_index())
        for d in devices
    ]
    if local or process_count() == 1 or any(isinstance(d, Place) for d in devices):
        return places
    return [Place(p.device, r) for r in range(process_count()) for p in places]


# ---------------------------------------------------------------- the mesh


class Position:
    """One place of a mesh: a ``torch.device`` of the process ranked
    ``rank`` and, on a card, the stream its work runs on and the stream
    its incoming transfers run on (both made at first use, and only by the
    process that drives the position). Positions may share a device."""

    def __init__(self, device: torch.device, index: int, rank: Optional[int] = None):
        self.device = torch.device(device)
        self.index = int(index)
        self.rank = process_index() if rank is None else int(rank)
        self._stream = self._comm = None

    def __repr__(self) -> str:
        return f"Position({self.index}, {self.device}, rank {self.rank})"

    @property
    def local(self) -> bool:
        """Whether this process drives the position."""
        return self.rank == process_index()

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The compute stream (``None`` on the CPU)."""
        if self.cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @property
    def comm_stream(self) -> Optional["torch.cuda.Stream"]:
        """The stream of the transfers into this position (``None`` on the
        CPU)."""
        if self.cuda and self._comm is None:
            self._comm = torch.cuda.Stream(self.device)
        return self._comm

    @contextlib.contextmanager
    def run(self) -> Iterator[None]:
        """Make this position's device and compute stream current; on the
        CPU, nothing. While a schedule is recorded (``obs/schedule.py``)
        the calls made here are this position's."""
        recording = sink() if (sink := _schedule.SINK) is not None else None
        if recording is not None:
            recording.enter(self.index)
        try:
            if not self.cuda:
                yield
                return
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                yield
        finally:
            if recording is not None:
                recording.leave()

    def join(self) -> None:
        """Order the device's current stream after this position's work."""
        if self.cuda:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            current.wait_stream(self.comm_stream)


def run_on(position: Optional[Position]):
    """``position.run()``, or nothing without a position (work on the
    current stream of a device that has no mesh)."""
    return position.run() if position is not None else contextlib.nullcontext()


def spans_processes(positions: Sequence[Position]) -> bool:
    """Whether more than one process drives ``positions`` (the same answer
    in every process)."""
    return len({p.rank for p in positions}) > 1


class Mesh:
    """A grid of :class:`Position` objects with named axes, e.g. ``{"data":
    2, "samples": 4}``: ``positions[d, s]``. The samples axis is the fast
    axis of the grid (position order), as in the reference.

    ``shared``: every process of the run runs this mesh's host program and
    joins its collectives — a mesh over the run's places in a run of
    several processes, even where one of its sums or rings touches the
    positions of one process only. A mesh of one process's own devices
    (host-sharded ingest) is not shared."""

    def __init__(self, positions: np.ndarray, axis_names: Sequence[str], shared: bool = False):
        if positions.ndim != len(axis_names):
            raise ValueError(f"{positions.ndim}-d positions for axes {tuple(axis_names)}")
        self.positions = positions
        self.axis_names = tuple(axis_names)
        self.shared = bool(shared)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.positions.shape))

    @property
    def size(self) -> int:
        return int(self.positions.size)

    def flat(self) -> List[Position]:
        """Every position in grid order."""
        return list(self.positions.reshape(-1))

    @property
    def local(self) -> List[Position]:
        """The positions this process drives, in grid order."""
        return [p for p in self.flat() if p.local]

    @property
    def ranks(self) -> List[int]:
        """The ranks of the processes that drive the mesh, in order."""
        return sorted({p.rank for p in self.flat()})

    @property
    def spans_processes(self) -> bool:
        """Whether more than one process drives the mesh's positions."""
        return spans_processes(self.flat())

    @property
    def home(self) -> torch.device:
        """The device of this process's first position (its home device
        when it drives none)."""
        local = self.local
        return local[0].device if local else home_device()

    def data_slices(self) -> List[List[Position]]:
        """The positions of each data slice, samples-major within it (the
        ring of that slice)."""
        data = self.shape.get(DATA_AXIS, 1)
        return [list(row) for row in self.positions.reshape(data, -1)]

    def join(self, tensors: Sequence[Optional[torch.Tensor]] = ()) -> None:
        """Order each device's current stream after the work of every
        position this process drives, and keep ``tensors`` (made on
        position streams; ``None`` for another process's) alive until that
        stream is done with them."""
        for position in self.local:
            position.join()
        for tensor in tensors:
            if tensor is not None and tensor.is_cuda:
                tensor.record_stream(torch.cuda.current_stream(tensor.device))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(p.device) for p in self.flat()]})"


@dataclass
class RowSharded:
    """A (padded, padded) matrix held as row tiles, one a samples position
    in position order, each on its position's device — the sharded
    strategy's Gramian and centred matrix. Shardedness travels with the
    matrix: ``compute_pca`` takes the sharded centring and eigensolve
    exactly for this type. ``n_true`` is the cohort's width; rows and
    columns past it are padding (zero). ``shared`` as the mesh it came
    from (:class:`Mesh`): then a tile of a position another process
    drives is ``None`` here, ``padded`` and ``dtype`` are given (a process
    may hold none of the tiles), and every process joins the collectives
    that read it."""

    tiles: List[Optional[torch.Tensor]]
    positions: List[Position]
    n_true: int
    padded: int = 0
    dtype: Optional[torch.dtype] = None
    shared: bool = False

    def __post_init__(self) -> None:
        held = [t for t in self.tiles if t is not None]
        if held:
            self.padded = int(held[0].shape[1])
            self.dtype = held[0].dtype
        if not self.padded or self.dtype is None:
            raise ValueError("a RowSharded that holds no tile needs padded and dtype")

    @property
    def rows(self) -> int:
        """Rows of one tile."""
        return self.padded // len(self.positions)

    @property
    def device(self) -> torch.device:
        """Where this process's share lives: its first tile's device, else
        its home device."""
        held = [t for t in self.tiles if t is not None]
        return held[0].device if held else home_device()

    def to_host(self) -> np.ndarray:
        """The whole (padded, padded) matrix on the host, in every process
        (tiles of other processes gathered first, the reference's
        ``host_value`` of a non-addressable array)."""
        from spark_examples_tpu_torch.parallel.collectives import all_gather_rows

        if self.shared:
            return all_gather_rows(
                self.tiles, self.positions, like=((self.rows, self.padded), self.dtype)
            )[0].cpu().numpy()
        return np.concatenate([t.cpu().numpy() for t in self.tiles])


def _devices(devices: Optional[Sequence]) -> List:
    if devices is None:
        return local_cards()
    return [d if isinstance(d, Place) else torch.device(d) for d in devices]


def make_mesh(shape: Dict[str, int], devices: Optional[Sequence] = None, local: bool = False) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"data": 4, "samples": 2})``,
    over the first of the run's places (:func:`global_places` of
    ``devices``, default: this process's cards; with ``local``, this
    process's devices alone). Raises when the places cannot hold the
    shape; a device may repeat."""
    places = global_places(_devices(devices), local=local)
    sizes = [max(1, int(n)) for n in shape.values()]
    total = int(np.prod(sizes))
    if total > len(places):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(places)}")
    grid = np.empty(total, dtype=object)
    for i, place in enumerate(places[:total]):
        grid[i] = Position(place.device, i, place.rank)
    return Mesh(grid.reshape(sizes), tuple(shape.keys()),
                shared=not local and process_count() > 1)


def default_mesh(
    num_reduce_partitions: Optional[int] = None,
    samples_axis: int = 1,
    devices: Optional[Sequence] = None,
    local: bool = False,
) -> Mesh:
    """All the run's places, data-major; ``num_reduce_partitions`` caps the
    data axis (the reference's reduce parallelism), the rest stay unused."""
    places = global_places(_devices(devices), local=local)
    samples_axis = max(1, samples_axis)
    data = len(places) // samples_axis
    if num_reduce_partitions is not None:
        data = max(1, min(data, num_reduce_partitions))
    return make_mesh({DATA_AXIS: data, SAMPLES_AXIS: samples_axis}, places)


def hierarchical_mesh(mesh: Mesh, hosts: int) -> Mesh:
    """Factor a ``data x samples`` mesh host-major into ``data x hosts x
    samples`` (the same positions in the same order): consecutive
    samples positions share a host, so the inner ring stays inside one."""
    if SAMPLES_AXIS not in mesh.shape:
        raise ValueError(f"mesh must have a {SAMPLES_AXIS!r} axis")
    samples = mesh.shape[SAMPLES_AXIS]
    hosts = int(hosts)
    if samples % hosts:
        raise ValueError(f"host factor {hosts} does not divide samples axis {samples}")
    data = mesh.shape.get(DATA_AXIS, 1)
    grid = mesh.positions.reshape(data, hosts, samples // hosts)
    return Mesh(grid, (DATA_AXIS, HOST_AXIS, SAMPLES_AXIS), shared=mesh.shared)


def run_devices(device: Union[str, torch.device]) -> List[torch.device]:
    """The devices of this process a run on ``device`` resolves its mesh
    over: its cards (:func:`local_cards`) for a CUDA device; on the CPU,
    CPU positions, as many as a mesh shape asks for
    (:func:`resolve_run_mesh` takes ``None`` for them)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device]
    return local_cards()


def resolve_run_mesh(
    mesh_shape: Optional[str] = None,
    num_reduce_partitions: Optional[int] = None,
    devices: Optional[Sequence] = None,
    local: bool = False,
) -> Optional[Mesh]:
    """The one run-mesh rule: an explicit ``--mesh-shape``, else every
    place of the run capped by ``--num-reduce-partitions``; ``None`` on one
    place. A CPU device list of one position grows to the shape's size —
    in a run of several processes, each process's to its share (CPU
    positions are places, as the reference's virtual devices are).
    ``local`` keeps the mesh to this process's devices (host-sharded
    ingest)."""
    devices = _devices(devices)
    shares = 1 if local else process_count()
    if mesh_shape:
        shape = parse_mesh_shape(mesh_shape)
        size = int(np.prod([max(1, n) for n in shape.values()]))
        if len(devices) == 1 and not isinstance(devices[0], Place) and devices[0].type == "cpu":
            if size % shares:
                raise ValueError(
                    f"mesh shape {shape} does not divide over {shares} processes"
                )
            devices = devices * (size // shares)
        return make_mesh(shape, devices, local=local)
    places = global_places(devices, local=local)
    if len(places) == 1:
        return None
    return default_mesh(num_reduce_partitions=num_reduce_partitions, devices=places)


def host_value(x) -> np.ndarray:
    """Host copy of a tensor or of a :class:`RowSharded` matrix, valid in
    every process (the tiles of other processes are gathered first)."""
    if isinstance(x, RowSharded):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def local_shard(x) -> np.ndarray:
    """One shard this process holds — a process-local synchronous fetch
    (the reference's ``local_shard``): a :class:`RowSharded`'s first tile
    here, or a tensor whole."""
    if isinstance(x, RowSharded):
        held = [t for t in x.tiles if t is not None]
        return held[0].cpu().numpy() if held else np.zeros((0, x.padded))
    return host_value(x)


def packed_host_fetch(arrays: Sequence[Union[torch.Tensor, Sequence[torch.Tensor]]]) -> np.ndarray:
    """One host transfer for several values: each value (a tensor, or its
    shards in position order) is gathered and flattened onto the first
    value's device, everything is concatenated, and the result comes to
    the host in one copy; the caller slices it apart. A value a mesh holds
    the same on several positions is passed once, not once a position (the
    reference's fetch once came back with counters multiplied by the
    samples-axis size when a replicated value was gathered whole). Values
    should share a dtype (the first one's is used)."""
    parts: List[torch.Tensor] = []
    for value in arrays:
        shards = [value] if isinstance(value, torch.Tensor) else list(value)
        parts.extend(shards)
    if not parts:
        return np.zeros((0,))
    device, dtype = parts[0].device, parts[0].dtype
    flat = torch.cat([p.reshape(-1).to(device=device, dtype=dtype) for p in parts])
    return flat.cpu().numpy()


#: Fixed host-RSS overhead of the process itself (interpreter, runtime,
#: parser library): the constant term of :func:`host_peak_bytes`, the
#: reference's value, deliberately generous. The formula's job is to bound
#: the data-dependent staging terms.
HOST_RUNTIME_BASELINE_BYTES = 4 << 30


def host_peak_bytes(
    num_samples: int,
    block_size: int,
    data_axis: int = 1,
    ingest_workers: int = 0,
    chunk_bytes: int = 0,
    prefetch_depth: int = 0,
    pipeline_depth: int = 0,
    host_accumulator: bool = False,
    grm_finalize: bool = False,
    ld_window_sites: int = 0,
    num_hosts: int = 1,
    wire_table_bytes: int = 0,
    merge_join_bytes: int = 0,
    baseline_bytes: int = HOST_RUNTIME_BASELINE_BYTES,
) -> int:
    """Closed-form peak host-memory bound of one bounded-ingest run — the
    host-RAM sibling of :func:`ring_traffic_bytes`, and the ONE formula
    behind ``graftcheck plan --host-mem-budget``, the driver's
    ``host_static_bound_bytes`` gauge, and the manifest's ``host_memory``
    block (``check/hostmem.py:conf_host_peak_bytes`` resolves a parsed
    configuration into these arguments, so no caller re-derives them).

    Term by term (derivation in DESIGN.md §8.6):

    - **parse window** — ``(ingest_workers + 2) * 2 * chunk_bytes``: the
      order-preserving pool (``sources/files.py:_ordered_pool_map``) holds
      at most ``workers + 2`` chunks in flight, each present as raw text
      AND as its parsed arrays (has-variation bytes <= text bytes: one
      int8 per genotype vs >= 2 text chars per GT column, plus
      positions/ends/AF at ~20 bytes/row against ~60+ text bytes/row).
    - **prefetch queue** — ``prefetch_depth`` parsed blocks of
      ``block_size * num_samples`` uint8 waiting for the device feeder
      (``pipeline/datasets.py:PrefetchIterator``).
    - **accumulator staging** — the ``(data_axis * block_size,
      num_samples)`` uint8 staging buffer plus one flush copy (packed
      ``ceil(N/8)`` or the full-width counts copy — bound with the full
      width so count-valued joins stay inside the bound).
    - **flush in-flight** — ``pipeline_depth`` flush copies pinned on host
      while their transfers overlap compute (``ops/gramian.py``).
    - **host accumulator** — the ``--pca-backend host`` oracle's int64
      N x N matrix (+ its f64 centering copy), zero on the device path.
    - **GRM finalize** — ``21 * N * N``: the kinship close-out
      (``analyses/grm.py:grm_finalize`` + its summary) holds the fetched
      f32 Gramian (4 N²), EITHER the int64 working copy OR the summary's
      off-diagonal float64 extraction (8 N² — they never overlap), the
      float64 kinship itself (8 N²), and the off-diagonal bool mask
      (1 N²) simultaneously on host; zero for every other analysis.
    - **LD window** — ``56 * W² + W * N``: each flush fetches the W×W
      int32 co-carrier matrix and closes r² on host
      (``ops/ld.py:r2_from_counts`` holds up to seven 8-byte W×W working
      matrices — the int64 copy, cov, the variance outer product, the
      squared numerator and its cast temp, the r² result — next to the
      fetched int32 stats; 56 W² bounds the lot) plus the (W, N) uint8
      window buffer; zero when the run has no LD window.
    - **pod merge** — ``(num_hosts + 1) * 8 * N²`` when ``num_hosts > 1``:
      host-sharded ingest closes out by all-gathering every process's
      dense N×N partial Gramian onto each host and summing them exactly
      (``pipeline/pca_driver.py:_merge_host_partials``) — the gathered
      stack (``num_hosts`` partials) plus the 8-byte exact-sum working
      copy sit on host simultaneously. This is a PER-HOST bound: each
      process pays it locally, so the pod-wide peak is ``num_hosts``
      times this formula while each host stays within it. Zero for
      single-process runs.
    - **wire table** — ``wire_table_bytes``: the resolved residency of
      wire-mode ingest tables (spool index + decoded records + stream
      windows) or the packed columns' build/hand-off co-residency; the
      caller (``check/hostmem.py:conf_host_peak_bytes``) derives it from
      the bytes on disk via ``sources/stream.py:wire_rows_bound`` so the
      formula stays TOTAL across JSONL/SAM/REST/checkpoint-resume inputs.
    - **merge join** — ``merge_join_bytes``: the k-way streaming join's
      tracked-group working set, ``n_sets x 64 x record_bytes``
      (``sources/stream.py:merge_join`` holds at most the records of the
      current group key per stream; 64 is the accounted per-stream group
      ceiling its ``MergeJoinStats.peak_tracked`` gauge is asserted
      against). Zero for single-set runs.
    - **baseline** — :data:`HOST_RUNTIME_BASELINE_BYTES`.
    """
    n = int(num_samples)
    block_bytes = int(block_size) * n
    staging = int(data_axis) * block_bytes
    parse_window = (int(ingest_workers) + 2) * 2 * int(chunk_bytes)
    prefetch = int(prefetch_depth) * block_bytes
    flush_copies = (1 + int(pipeline_depth)) * staging
    host_matrix = 2 * n * n * 8 if host_accumulator else 0
    grm_term = 21 * n * n if grm_finalize else 0
    w = int(ld_window_sites)
    ld_term = 56 * w * w + w * n if w > 0 else 0
    hosts = int(num_hosts)
    merge_term = (hosts + 1) * 8 * n * n if hosts > 1 else 0
    return int(
        baseline_bytes
        + parse_window
        + prefetch
        + staging
        + flush_copies
        + host_matrix
        + grm_term
        + ld_term
        + merge_term
        + int(wire_table_bytes)
        + int(merge_join_bytes)
    )


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse the ``--mesh-shape`` flag: ``'data,samples'`` e.g. ``'4,2'``."""
    parts = [int(p) for p in spec.split(",")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2:
        raise ValueError(f"--mesh-shape expects 'data,samples', got {spec!r}")
    return {DATA_AXIS: parts[0], SAMPLES_AXIS: parts[1]}


# ------------------------------------------------------------ executor slices
# The serve daemon's concurrency unit: one process's device positions cut
# into independent ranges, each with its own worker. Pure index arithmetic,
# the reference's (``spark_examples_tpu/parallel/mesh.py:ExecutorSlice``),
# so the daemon, admission and tests agree without a device.

#: Job classes a slice may serve (the admission classes of ``serve/queue.py``).
SLICE_SMALL = "small"
SLICE_LARGE = "large"


@dataclass(frozen=True)
class ExecutorSlice:
    """One executor: a contiguous range of the daemon's device positions.
    Slices never share a position, so a large job on one slice cannot
    head-block a small job on another; two slices may still name one card
    (positions of ``cuda:0``), each worker then on its own stream."""

    name: str
    job_classes: Tuple[str, ...]
    device_start: int
    device_count: int

    def __post_init__(self) -> None:
        if self.device_count < 1:
            raise ValueError(
                f"slice {self.name!r} needs >= 1 device, got {self.device_count}"
            )
        if not self.job_classes:
            raise ValueError(f"slice {self.name!r} serves no job class")

    def device_indices(self) -> Tuple[int, ...]:
        return tuple(range(self.device_start, self.device_start + self.device_count))


def resolve_small_slices(spec, device_count: int) -> int:
    """The ``--executor-slices`` rule: ``'auto'`` (or ``None``) is one small
    slice when a device can be spared (two or more), none on one device (the
    ``shared`` topology, as on the reference's single device); an integer
    passes through."""
    if spec is None or spec == "auto":
        return 1 if int(device_count) >= 2 else 0
    count = int(spec)
    if count < 0:
        raise ValueError(f"--executor-slices must be >= 0, got {spec!r}")
    return count


def plan_executor_slices(
    device_count: int,
    small_slices: int = 0,
    small_slice_devices: int = 1,
) -> Tuple[ExecutorSlice, ...]:
    """Cut ``device_count`` positions into slices, as the reference does:
    with no small slice, one ``shared`` slice over every position serving
    both classes; otherwise ``small_slices`` slices of
    ``small_slice_devices`` positions off the end of the list, and the rest
    (at least one position) the ``large`` slice."""
    devices = int(device_count)
    small = int(small_slices)
    per_small = int(small_slice_devices)
    if devices < 1:
        raise ValueError(f"device_count must be >= 1, got {device_count}")
    if small < 0:
        raise ValueError(f"small_slices must be >= 0, got {small_slices}")
    if per_small < 1:
        raise ValueError(f"small_slice_devices must be >= 1, got {small_slice_devices}")
    if small == 0:
        return (
            ExecutorSlice(
                name="shared",
                job_classes=(SLICE_SMALL, SLICE_LARGE),
                device_start=0,
                device_count=devices,
            ),
        )
    reserved = small * per_small
    if devices - reserved < 1:
        raise ValueError(
            f"{small} small slice(s) x {per_small} device(s) reserve "
            f"{reserved} of {devices} devices, leaving none for the large "
            "slice; shrink --executor-slices/--small-slice-devices or add "
            "devices"
        )
    slices = [
        ExecutorSlice(
            name="large",
            job_classes=(SLICE_LARGE,),
            device_start=0,
            device_count=devices - reserved,
        )
    ]
    for i in range(small):
        slices.append(
            ExecutorSlice(
                name=f"small-{i}",
                job_classes=(SLICE_SMALL,),
                device_start=devices - reserved + i * per_small,
                device_count=per_small,
            )
        )
    return tuple(slices)


__all__ = [
    "DATA_AXIS",
    "DEFAULT_DCN_BYTES_PER_S",
    "DEFAULT_ICI_BYTES_PER_S",
    "ExecutorSlice",
    "SLICE_LARGE",
    "SLICE_SMALL",
    "DEFAULT_INIT_TIMEOUT",
    "DIST_TIMEOUT_ENV",
    "HIER_HOSTS_ENV",
    "HOST_AXIS",
    "HOST_RUNTIME_BASELINE_BYTES",
    "LevelTraffic",
    "Mesh",
    "Position",
    "RING_PACK_MULTIPLE",
    "RowSharded",
    "SAMPLES_AXIS",
    "Topology",
    "Place",
    "data_group",
    "default_mesh",
    "distributed_init",
    "distributed_shutdown",
    "flat_traffic_split",
    "global_places",
    "hierarchical_mesh",
    "hierarchical_traffic_bytes",
    "host_peak_bytes",
    "home_device",
    "host_value",
    "local_cards",
    "local_shard",
    "make_mesh",
    "packed_host_fetch",
    "padded_cohort",
    "parse_mesh_shape",
    "parse_topology",
    "plan_executor_slices",
    "process_backend",
    "process_count",
    "process_index",
    "resolve_hier_hosts",
    "resolve_reduce_schedule",
    "resolve_run_mesh",
    "resolve_small_slices",
    "ring_traffic_bytes",
    "run_devices",
    "run_on",
    "spans_processes",
]
