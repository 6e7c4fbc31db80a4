"""The device mesh of one process: named axes over positions, and its
arithmetic.

The port of ``spark_examples_tpu/parallel/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over the devices of its process (one controller) and
runs its collectives inside ``shard_map``. The port keeps that model: a
:class:`Mesh` is a grid of :class:`Position` objects with named axes
(``data``, ``samples``, and ``hosts`` for the hierarchical factorisation),
each position one ``torch.device`` with a CUDA stream for its work and one
for its transfers. The collectives are ``parallel/collectives.py``.

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
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

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


@dataclass(frozen=True)
class Topology:
    """A fleet the schedule is planned against: ``hosts`` machines x
    ``devices_per_host`` devices. Declarative: it is never queried from a
    runtime. (The reference's link bandwidths, a TPU's, are not carried.)"""

    hosts: int
    devices_per_host: int

    def __post_init__(self) -> None:
        if self.hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"topology needs hosts >= 1 and devices_per_host >= 1, got "
                f"{self.hosts}x{self.devices_per_host}"
            )

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


def resolve_hier_hosts(samples_parallel: int, explicit: Optional[int] = None) -> int:
    """The host factor of the hierarchical factorisation: ``explicit``, else
    :data:`HIER_HOSTS_ENV`, else this process's count (one: the port runs
    one process). It must divide the samples axis."""
    if explicit is None:
        env = os.environ.get(HIER_HOSTS_ENV)
        if env:
            explicit = int(env)
    hosts = max(1, int(explicit) if explicit is not None else 1)
    if int(samples_parallel) % hosts:
        raise ValueError(
            f"hierarchical schedule needs the host factor ({hosts}) to "
            f"divide the samples axis ({samples_parallel}); choose a mesh "
            "whose samples axis is a multiple of the host count"
        )
    return hosts


# ---------------------------------------------------------------- the mesh


class Position:
    """One place of a mesh: a ``torch.device`` and, on a card, the stream
    its work runs on and the stream its incoming transfers run on (both
    made at first use). Positions may share a device."""

    def __init__(self, device: torch.device, index: int):
        self.device = torch.device(device)
        self.index = int(index)
        self._stream = self._comm = None

    def __repr__(self) -> str:
        return f"Position({self.index}, {self.device})"

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
        CPU, nothing."""
        if not self.cuda:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

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


class Mesh:
    """A grid of :class:`Position` objects with named axes, e.g. ``{"data":
    2, "samples": 4}``: ``positions[d, s]``. The samples axis is the fast
    axis of the grid (position order), as in the reference."""

    def __init__(self, positions: np.ndarray, axis_names: Sequence[str]):
        if positions.ndim != len(axis_names):
            raise ValueError(f"{positions.ndim}-d positions for axes {tuple(axis_names)}")
        self.positions = positions
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.positions.shape))

    @property
    def size(self) -> int:
        return int(self.positions.size)

    def flat(self) -> List[Position]:
        """Every position in grid order."""
        return list(self.positions.reshape(-1))

    def data_slices(self) -> List[List[Position]]:
        """The positions of each data slice, samples-major within it (the
        ring of that slice)."""
        data = self.shape.get(DATA_AXIS, 1)
        return [list(row) for row in self.positions.reshape(data, -1)]

    def join(self, tensors: Sequence[torch.Tensor] = ()) -> None:
        """Order each device's current stream after every position's work,
        and keep ``tensors`` (made on position streams) alive until that
        stream is done with them."""
        for position in self.flat():
            position.join()
        for tensor in tensors:
            if tensor.is_cuda:
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
    columns past it are padding (zero)."""

    tiles: List[torch.Tensor]
    positions: List[Position]
    n_true: int

    @property
    def padded(self) -> int:
        return int(self.tiles[0].shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[0].dtype

    def to_host(self) -> np.ndarray:
        """The whole (padded, padded) matrix on the host."""
        return np.concatenate([t.cpu().numpy() for t in self.tiles])


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass CPU devices to build a mesh on the CPU"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(shape: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"data": 4, "samples": 2})``,
    over the first positions of ``devices`` (default: every card). Raises
    when the devices cannot hold the shape; a device may repeat."""
    devices = _devices(devices)
    sizes = [max(1, int(n)) for n in shape.values()]
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(devices)}")
    grid = np.empty(total, dtype=object)
    for i, device in enumerate(devices[:total]):
        grid[i] = Position(device, i)
    return Mesh(grid.reshape(sizes), tuple(shape.keys()))


def default_mesh(
    num_reduce_partitions: Optional[int] = None,
    samples_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """All devices, data-major; ``num_reduce_partitions`` caps the data
    axis (the reference's reduce parallelism), the rest stay unused."""
    devices = _devices(devices)
    samples_axis = max(1, samples_axis)
    data = len(devices) // samples_axis
    if num_reduce_partitions is not None:
        data = max(1, min(data, num_reduce_partitions))
    return make_mesh({DATA_AXIS: data, SAMPLES_AXIS: samples_axis}, devices)


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
    return Mesh(grid, (DATA_AXIS, HOST_AXIS, SAMPLES_AXIS))


def run_devices(device: Union[str, torch.device]) -> List[torch.device]:
    """The devices a run on ``device`` resolves its mesh over: every card
    (``cuda:0 .. device_count() - 1``) for a CUDA device; on the CPU, CPU
    positions, as many as a mesh shape asks for (:func:`resolve_run_mesh`
    takes ``None`` for them)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device]
    return _devices(None)


def resolve_run_mesh(
    mesh_shape: Optional[str] = None,
    num_reduce_partitions: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Optional[Mesh]:
    """The one run-mesh rule: an explicit ``--mesh-shape``, else every
    device capped by ``--num-reduce-partitions``; ``None`` on one device.
    A CPU device list of one position grows to the shape's size (CPU
    positions are places, as the reference's virtual devices are)."""
    devices = _devices(devices)
    if mesh_shape:
        shape = parse_mesh_shape(mesh_shape)
        if all(d.type == "cpu" for d in devices) and len(devices) == 1:
            devices = devices * int(np.prod([max(1, n) for n in shape.values()]))
        return make_mesh(shape, devices)
    if len(devices) == 1:
        return None
    return default_mesh(num_reduce_partitions=num_reduce_partitions, devices=devices)


def host_value(x) -> np.ndarray:
    """Host copy of a tensor or of a :class:`RowSharded` matrix."""
    if isinstance(x, RowSharded):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


__all__ = [
    "DATA_AXIS",
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
    "default_mesh",
    "flat_traffic_split",
    "hierarchical_mesh",
    "hierarchical_traffic_bytes",
    "host_peak_bytes",
    "host_value",
    "make_mesh",
    "packed_host_fetch",
    "padded_cohort",
    "parse_mesh_shape",
    "parse_topology",
    "resolve_hier_hosts",
    "resolve_reduce_schedule",
    "resolve_run_mesh",
    "ring_traffic_bytes",
    "run_devices",
    "run_on",
]
