"""Time the ring's two kernels, ``cross_accumulate`` and ``pack_rows_t``,
against the designs they were chosen over.

    python -m spark_examples_tpu_torch.experiments.ring_variants

``cross_accumulate`` (``csrc/devicegen.cu``) at the ring's step shapes:
632 × 632 and 6,250 × 6,250 × 1,024 and 16,384 sites (2,504 and 25,000
samples over 4 positions), and 6,256 × 6,256 × 16,384 (the large cohort's
packed tiles, whose rows take whole bulk reductions), each into a column
slice of a row tile 4 positions wide. The variants are the package's
source built again with other values of its design switches (``-D``):

- "kept": the package's ``cross_accumulate``. Unsplit (6,250 and 6,256
  rows): persistent clusters of two blocks that share B's column group
  through multicast loads, walking items from a device counter, the
  epilogue in a buffer of its own, m64n128k32 for a group of one box;
  items of 32 steps or more keep 4 stages and leave in 32-column chunks,
  shorter ones 3 stages, 128-column chunks and C prefetched into L2.
  Split (632 rows): a 64-row block an item, the items part by part;
- "no multicast": each block loads both of B's boxes itself;
- "static walk": cluster c takes items c, c + clusters, ... (no counter);
- "one box at m64n256k32": a group of one box multiplies the whole stage;
- "cluster-scope release": a consumer hands a stage to its peer block
  with mbarrier.arrive.release.cluster;
- "no C prefetch": short unsplit items leave C to the epilogue's
  reductions;
- "split blocks walking in clusters of two": a split launch as the
  unsplit one (its row tile's halves share B, persistent);
- "split halves in a cluster sharing B": a tile's two 64-row halves form
  a cluster and multicast B's boxes, an item each;
- "split items tile by tile", "lone blocks launched as clusters of one"
  and both: other placements of the split launch's blocks;
- "split blocks with 5 stages" and "with 3 stages" (4 kept);
- "64-row blocks load A's whole box": the first port's 128-row load, half
  used;
- "3 stages, 128-column chunks at every depth" and "4 stages, 32-column
  chunks at every depth": one unsplit shape for both depths;
- at 632 × 632 also splits 2, 3, 4 and 8 and "unsplit" (128-row blocks)
  beside the kept split (2 at 1,024 sites, 4 at 16,384).

Each is timed alone and as four launches at once on four streams of the
card (the ring's four positions' products of one step), where a walk
whose blocks cannot all be resident leaves a tail.

``pack_rows_t`` (``csrc/gramian.cu``) of a 632- and a 6,256-column Xᵀ ×
16,384 sites: "kept" (a warp vote a site, whole rows a block, 16-byte
stores, loads asking L2 for whole lines, two groups' loads in flight on
wide rows) against "the first port's" (16-byte loads into shared memory,
eight byte loads and one byte store an output byte, blocks of 128 sites ×
128 columns), "one group in flight at every width", "four groups in
flight on wide rows" and "no L2 line hint".

Every design is held exactly against the plain version at each timed
shape, then timed with CUDA events in turns (forward and backward).
Prints the card line and one JSON object. Runs on a CUDA card only.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from spark_examples_tpu_torch.ops import _kernels, devicegen, gramian
from spark_examples_tpu_torch.utils.device import cuda_event_ms

BUILD_DIR = _kernels.BUILD_DIR / "ring_variants"
#: (m, n, sites) of the timed ring steps.
CROSS_SHAPES = ((632, 632, 1024), (632, 632, 16384), (6250, 6250, 1024), (6250, 6250, 16384),
                (6256, 6256, 16384))
#: Columns of the timed packs (a position's tile at 2,504 and 25,000
#: samples) and their sites.
PACK_COLUMNS = (632, 6256)
PACK_SITES = 16384
#: The designs not kept: -D switches of csrc/devicegen.cu.
CROSS_VARIANTS = {
    "no multicast": ("-DCROSS_MULTICAST=0",),
    "static walk": ("-DCROSS_DYNAMIC=0",),
    "one box at m64n256k32": ("-DCROSS_NARROW_ONE_BOX=0",),
    "cluster-scope release": ("-DCROSS_RELEASE_CLUSTER=1",),
    "no C prefetch": ("-DCROSS_PREFETCH_C=0",),
    "split blocks walking in clusters of two": ("-DCROSS_SPLIT_WALK=1",),
    "split halves in a cluster sharing B": ("-DCROSS_SPLIT_PAIR=1",),
    "split items tile by tile": ("-DCROSS_PART_MAJOR=0",),
    "lone blocks launched as clusters of one": ("-DCROSS_LONE_CLUSTER_ATTR=1",),
    "split items tile by tile, launched as clusters of one": (
        "-DCROSS_PART_MAJOR=0", "-DCROSS_LONE_CLUSTER_ATTR=1"),
    "split blocks with 5 stages": ("-DCROSS_STAGES_HALF=5",),
    "split blocks with 3 stages": ("-DCROSS_STAGES_HALF=3",),
    "64-row blocks load A's whole box": ("-DCROSS_HALF_WHOLE_A=1",),
    "3 stages, 128-column chunks at every depth": ("-DCROSS_DEEP_STEPS=1000000",),
    "4 stages, 32-column chunks at every depth": ("-DCROSS_DEEP_STEPS=1",),
}
#: The pack's designs not kept: -D switches of csrc/gramian.cu.
PACK_VARIANTS = {
    "one group in flight at every width": ("-DPACK_DEEP=1",),
    "four groups in flight on wide rows": ("-DPACK_DEEP=4",),
    "no L2 line hint": ("-DPACK_L2_HINT=0",),
}
#: Splits timed beside the kept one at 632 × 632.
SMALL_SPLITS = {"split 2": 2, "split 3": 3, "split 4": 4, "split 8": 8, "unsplit": 1}

#: The first port's pack (its first ``pack_rows_t_kernel``) with its launcher.
PACK_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int TILE_SITES = 128, TILE_COLS = 128, THREADS = 256;
constexpr int SEGMENTS = TILE_SITES / 16;
constexpr int PACK_STRIDE = TILE_SITES + 16;

__global__ void __launch_bounds__(THREADS)
first_pack_kernel(const int8_t* __restrict__ xt, int ld, int rows, int out_width,
                  uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[TILE_COLS * PACK_STRIDE];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * TILE_SITES;
  const int c0 = blockIdx.y * TILE_COLS;
#pragma unroll
  for (int i = 0; i < TILE_COLS * SEGMENTS / THREADS; ++i) {
    const int u = tid + i * THREADS;
    const int seg = u % SEGMENTS, c = u / SEGMENTS;
    *reinterpret_cast<uint4*>(&tile[c * PACK_STRIDE + 16 * seg]) =
        *reinterpret_cast<const uint4*>(xt + static_cast<int64_t>(c0 + c) * ld + s0 + 16 * seg);
  }
  __syncthreads();
  const int site = tid % TILE_SITES, group = tid / TILE_SITES;
  const int s = s0 + site;
  if (s >= rows) return;
  uint8_t* row = out + static_cast<int64_t>(s) * out_width;
#pragma unroll
  for (int j = 8 * group; j < 8 * group + 8; ++j) {
    const int byte = c0 / 8 + j;
    if (byte >= out_width) break;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= (tile[(8 * j + k) * PACK_STRIDE + site] != 0 ? 1u : 0u) << (7 - k);
    row[byte] = static_cast<uint8_t>(v);
  }
}
}  // namespace

extern "C" int first_pack(const int8_t* xt, int ld, int n_cols, int rows, uint8_t* out,
                          void* stream) {
  const dim3 grid((rows + TILE_SITES - 1) / TILE_SITES, (n_cols + TILE_COLS - 1) / TILE_COLS);
  first_pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(xt, ld, rows,
                                                                            n_cols / 8, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def _compile(name: str, source_path, flags, extra: bytes = b""):
    """Start nvcc for one variant library unless it exists; returns (path,
    process or None)."""
    digest = hashlib.sha256(source_path.read_bytes() + extra + " ".join(
        (*_kernels.NVCC_FLAGS, *flags)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out, None
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags, "-I", str(_kernels.CSRC_DIR),
           "-o", str(out), str(source_path)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> dict:
    """Every variant library, one nvcc each, all started together: name →
    ctypes library (the cross_accumulate variants with devicegen.cu's
    signatures, "first pack" with ``first_pack``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = b"".join(h.read_bytes() for h in sorted(_kernels.CSRC_DIR.glob("*.cuh")))
    pack_src = BUILD_DIR / "first_pack.cu"
    pack_src.write_text(PACK_SOURCE)
    jobs = {name: _compile(f"devicegen-{i}", _kernels.CSRC_DIR / "devicegen.cu", flags, headers)
            for i, (name, flags) in enumerate(CROSS_VARIANTS.items())}
    jobs.update({name: _compile(f"gramian-{i}", _kernels.CSRC_DIR / "gramian.cu", flags, headers)
                 for i, (name, flags) in enumerate(PACK_VARIANTS.items())})
    jobs["first pack"] = _compile("first_pack", pack_src, ())
    libs = {}
    for name, (path, proc) in jobs.items():
        if proc is not None:
            report, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{report}")
            # ptxas's performance warnings (C75xx: serialized wgmma, ...).
            for line in report.splitlines():
                if "Performance" in line:
                    print(f"build: {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(path))
        if name == "first pack":
            lib.first_pack.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
            lib.first_pack.restype = ctypes.c_int
        else:
            source = "gramian.cu" if name in PACK_VARIANTS else "devicegen.cu"
            for fn_name, argtypes in _kernels._SIGNATURES[source].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


#: Each variant library's item counter per stream (zero between launches).
_COUNTERS: dict = {}


def cross_variant(lib, name: str):
    """``fn(C, a, b, split=None)``: the variant's launcher, as the package's
    wrapper calls its own."""

    def run(C, a, b, split=None):
        m, n = C.shape
        m_pad, n_pad = -(-m // 128) * 128, -(-n // 128) * 128
        ld = a.shape[1]
        sms = torch.cuda.get_device_properties(C.device).multi_processor_count
        if split is None:
            split = devicegen.cross_split(m_pad, n_pad, ld, sms)
        key = (name, _stream())
        if key not in _COUNTERS:
            _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=C.device)
        _kernels.check(lib.cross_accumulate_launch(
            C.data_ptr(), C.stride(0), m, n, a.data_ptr(), m_pad, b.data_ptr(), n_pad, ld, split,
            _COUNTERS[key].data_ptr(), _stream()), name)

    return run


def cross_designs(libs, m: int) -> dict:
    """name → fn(C, a, b) for the step shape of ``m`` rows."""
    designs = {"kept": devicegen.cross_accumulate}
    designs.update({name: cross_variant(libs[name], name) for name in CROSS_VARIANTS})
    if m == 632:
        designs.update({name: (lambda s: lambda C, a, b: devicegen.cross_accumulate(C, a, b, s))(s)
                        for name, s in SMALL_SPLITS.items()})
    return designs


def _in_turns(fns: dict, iters: int) -> dict:
    """Mean ms of each ``fns`` entry, timed forward then backward."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(cuda_event_ms(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def four_streams(fn, jobs, streams):
    """``fn`` on each of four (C, a, b) at once, one stream each, joined
    into the current stream."""
    main = torch.cuda.current_stream()
    for stream, (C, a, b) in zip(streams, jobs):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            fn(C, a, b)
    for stream in streams:
        main.wait_stream(stream)


def measure_cross(libs) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    streams = [torch.cuda.Stream() for _ in range(4)]
    out = {}
    for m, n, sites in CROSS_SHAPES:
        pad_m, pad_n = -(-m // 128) * 128, -(-n // 128) * 128
        a = (torch.rand((pad_m, sites), device=dev, generator=gen) < 0.3).to(torch.int8)
        b = (torch.rand((pad_n, sites), device=dev, generator=gen) < 0.3).to(torch.int8)
        start = torch.randint(-9, 9, (m, 4 * n), device=dev, generator=gen, dtype=torch.int32)
        want = start.clone()
        devicegen.cross_accumulate_plain(want[:, n : 2 * n], a, b)
        designs = cross_designs(libs, m)
        for name, fn in designs.items():
            tile = start.clone()
            fn(tile[:, n : 2 * n], a, b)
            torch.cuda.synchronize()
            if not torch.equal(tile, want):
                raise AssertionError(f"cross_accumulate design {name!r} != plain at {m} x {n} x {sites}")
        del want, start
        iters = 10 if m * sites > 10**8 else 50
        tiles = [torch.zeros((m, 4 * n), dtype=torch.int32, device=dev) for _ in range(4)]
        jobs = [(t[:, n : 2 * n], a, b) for t in tiles]
        alone = _in_turns({name: (lambda fn: lambda: fn(*jobs[0]))(fn)
                           for name, fn in designs.items()}, iters)
        four = _in_turns({name: (lambda fn: lambda: four_streams(fn, jobs, streams))(fn)
                          for name, fn in designs.items()}, max(2, iters // 4))
        out[f"{m}x{n}x{sites}"] = {"alone": alone, "four streams": four}
        del tiles, jobs, a, b
    return out


def measure_pack(libs) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    out = {}
    for cols in PACK_COLUMNS:
        xt = (torch.rand((-(-cols // 128) * 128, PACK_SITES), device=dev, generator=gen)
              < 0.3).to(torch.int8)
        want = gramian.pack_rows_t_plain(xt, cols)

        def first(xt=xt, cols=cols):
            packed = torch.empty((PACK_SITES, cols // 8), dtype=torch.uint8, device=dev)
            _kernels.check(libs["first pack"].first_pack(
                xt.data_ptr(), xt.shape[1], cols, PACK_SITES, packed.data_ptr(), _stream()),
                "first pack")
            return packed

        def variant(lib, xt=xt, cols=cols):
            packed = torch.empty((PACK_SITES, cols // 8), dtype=torch.uint8, device=dev)
            _kernels.check(lib.pack_rows_t_launch(xt.data_ptr(), xt.shape[0], xt.shape[1], cols,
                                                  PACK_SITES, packed.data_ptr(), _stream()), "pack")
            return packed

        designs = {"kept": lambda xt=xt, cols=cols: gramian.pack_rows_t(xt, cols),
                   "the first port's": first}
        designs.update({name: (lambda lib: lambda: variant(lib))(libs[name])
                        for name in PACK_VARIANTS})
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pack_rows_t design {name!r} != plain at {cols} columns")
        out[f"{cols}x{PACK_SITES}"] = _in_turns(designs, 50)
    return out


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build()
    result = {"cross_accumulate": measure_cross(libs), "pack_rows_t": measure_pack(libs)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
