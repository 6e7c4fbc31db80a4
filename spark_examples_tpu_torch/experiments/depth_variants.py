"""Time ``depth_counts`` against the designs it was chosen over.

    python -m spark_examples_tpu_torch.experiments.depth_variants

At a whole-chr21 shard of example 3 (26,194 reads of the synthetic
geometry, W = 327,542), four designs of the same function:

- "tile totals": the package's ``depth_counts`` (``csrc/depth.cu``): an
  adds kernel (a thread a read) into a difference buffer kept per stream
  and into the totals of the tiles of 1,024 positions, then a scan kernel
  (a tile a block, offset by the totals before it): two launches, no
  memset, no look-back;
- "two launches": a zeroed window (``torch.zeros``), a kernel adding each
  read's +1 and -1 into it (a thread a read, which also clears the scan's
  status words), then a single-pass scan in place with decoupled
  look-back (tiles of 2,048, one warp reading 32 status words a round);
- "cluster": the difference array in the distributed shared memory of a
  thread block cluster of 8 blocks of 1,024 threads (a segment of the
  window each), the bounds added by atomics across the cluster, each
  segment scanned in place, the segments' totals exchanged, one launch;
- "warp a read": a zeroed window and one kernel adding every (read,
  offset) pair with an int32 atomic, a warp a read (the first port of the
  function).

Each is held exactly against ``depth_counts_plain`` at the shard and at an
edge shape, then timed with CUDA events in turns (forward and backward,
twice), and each design's kernels (and the zeroing fill) are timed apart
from one ``torch.profiler`` window: what a call takes beyond their sum is
the gaps between them. Prints
the card line and one JSON object. Runs on a CUDA card only.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from spark_examples_tpu_torch.ops import _kernels, depth
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.device import cuda_event_ms

WINDOW_START = 1_000_000
SPAN = 327_414
READ_PAD = 128
ROUNDS = 2
BUILD_DIR = _kernels.BUILD_DIR / "depth_variants"

#: The three alternatives, with a launcher each.
SOURCE = r"""
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long TILE_TOTAL = 1ull << 32;
constexpr unsigned long long TILE_PREFIX = 2ull << 32;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__global__ void __launch_bounds__(THREADS)
pairs_kernel(const int32_t* positions, const int32_t* lengths, int rows, int64_t window_start,
             int window_size, int max_read_length, int32_t* out) {
  const int r = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  const int64_t n = min64(lengths[r], max_read_length);
  const int64_t lo = max64(0, -rel);
  const int64_t hi = min64(n, window_size - rel);
  for (int64_t off = lo + lane; off < hi; off += 32) atomicAdd(out + rel + off, 1);
}

__global__ void __launch_bounds__(THREADS)
diff_kernel(const int32_t* positions, const int32_t* lengths, int rows, int64_t window_start,
            int window_size, int max_read_length, int32_t* out, unsigned long long* status,
            int status_words) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  for (int w = r; w < status_words; w += gridDim.x * THREADS) status[w] = 0;
  if (r >= rows) return;
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  const int64_t n = min64(lengths[r], max_read_length);
  const int64_t lo = max64(0, -rel);
  const int64_t hi = min64(n, window_size - rel);
  if (lo >= hi) return;
  atomicAdd(out + rel + lo, 1);
  if (rel + hi < window_size) atomicAdd(out + rel + hi, -1);
}

__device__ __forceinline__ unsigned long long tile_status(const unsigned long long* status,
                                                          int tile) {
  return tile < 0 ? TILE_PREFIX
                  : *reinterpret_cast<const volatile unsigned long long*>(status + tile);
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(int32_t* data, int n, unsigned long long* status, int tiles) {
  __shared__ int tile_index, tile_prefix;
  __shared__ int warp_totals[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) tile_index = static_cast<int>(atomicAdd(status + tiles, 1ull));
  __syncthreads();
  const int tile = tile_index;
  const int64_t base = static_cast<int64_t>(tile) * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  const bool whole = base + SCAN_ITEMS <= n;
  int v[SCAN_ITEMS];
  if (whole) {
    const int4 a = reinterpret_cast<const int4*>(data + base)[0];
    const int4 b = reinterpret_cast<const int4*>(data + base)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    for (int j = 0; j < SCAN_ITEMS; ++j) v[j] = base + j < n ? data[base + j] : 0;
  }
  for (int j = 1; j < SCAN_ITEMS; ++j) v[j] += v[j - 1];
  int sum = v[SCAN_ITEMS - 1];
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(FULL, sum, d);
    if (lane >= d) sum += up;
  }
  if (lane == 31) warp_totals[warp] = sum;
  __syncthreads();
  int before = sum - v[SCAN_ITEMS - 1], total = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += warp_totals[w];
    total += warp_totals[w];
  }
  if (warp == 0) {
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, TILE_PREFIX | static_cast<uint32_t>(total));
    } else {
      if (lane == 0) atomicExch(status + tile, TILE_TOTAL | static_cast<uint32_t>(total));
      for (int last = tile - 1;; last -= 32) {
        unsigned long long s;
        do {
          s = tile_status(status, last - lane);
        } while (__any_sync(FULL, (s >> 32) == 0));
        const unsigned prefixes = __ballot_sync(FULL, (s >> 32) == (TILE_PREFIX >> 32));
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        int part = lane <= stop ? static_cast<int>(static_cast<uint32_t>(s)) : 0;
        for (int d = 16; d > 0; d /= 2) part += __shfl_xor_sync(FULL, part, d);
        prefix += part;
        if (prefixes) break;
      }
      if (lane == 0) atomicExch(status + tile, TILE_PREFIX | static_cast<uint32_t>(prefix + total));
    }
    if (lane == 0) tile_prefix = prefix;
  }
  __syncthreads();
  const int offset = tile_prefix + before;
  for (int j = 0; j < SCAN_ITEMS; ++j) v[j] += offset;
  if (whole) {
    reinterpret_cast<int4*>(data + base)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(data + base)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < SCAN_ITEMS; ++j)
      if (base + j < n) data[base + j] = v[j];
  }
}

namespace cluster_design {

namespace cg = cooperative_groups;

constexpr int DEPTH_CLUSTER = 8;     // blocks a cluster: its window's segments
constexpr int DEPTH_THREADS = 1024;
constexpr int DEPTH_MAX_SEGMENT = 48 * 1024;  // positions a block holds
constexpr int DEPTH_MAX_DEVICES = 64;         // devices whose kernel attribute is set
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// A segment position's shared-memory word: one word of padding every 32,
// so a thread's run of neighbouring positions and its neighbours' runs
// fall in different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// One cluster per DEPTH_CLUSTER segments of `segment` positions; block
// `rank` of a cluster holds positions [lo, lo + segment) in shared memory.
__global__ void __cluster_dims__(DEPTH_CLUSTER, 1, 1) __launch_bounds__(DEPTH_THREADS)
depth_counts_kernel(const int32_t* __restrict__ positions, const int32_t* __restrict__ lengths,
                    int rows, int64_t window_start, int window_size, int max_read_length,
                    int segment, int32_t* __restrict__ out) {
  extern __shared__ int32_t diff[];  // padded(segment) words
  __shared__ int warp_sums[DEPTH_THREADS / 32];
  // The segment's total; the block's reads' net count before the cluster.
  __shared__ int exchange[2];
  __shared__ int block_offset;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t span = static_cast<int64_t>(DEPTH_CLUSTER) * segment;
  const int64_t cluster_lo = static_cast<int64_t>(blockIdx.x / DEPTH_CLUSTER) * span;
  const int64_t cluster_hi = min64(cluster_lo + span, window_size);
  const int64_t lo = cluster_lo + static_cast<int64_t>(rank) * segment;
  for (int i = tid; i < padded(segment); i += DEPTH_THREADS) diff[i] = 0;
  cluster.sync();

  // A read covers [first, end) of the window: +1 at first, -1 at end when
  // end < W, each into the segment that holds it (any block's of the
  // cluster, through distributed shared memory). A bound before the
  // cluster's first position counts toward the cluster's prefix instead.
  int before = 0;
  for (int64_t r = static_cast<int64_t>(rank) * DEPTH_THREADS + tid; r < rows;
       r += static_cast<int64_t>(DEPTH_CLUSTER) * DEPTH_THREADS) {
    const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
    const int64_t first = max64(rel, 0);
    const int64_t end = min64(rel + min64(lengths[r], max_read_length), window_size);
    if (first >= end) continue;
    for (int bound = 0; bound < 2; ++bound) {
      const int64_t p = bound ? end : first;
      if (bound && p >= window_size) break;
      if (p < cluster_lo) {
        before += bound ? -1 : 1;
      } else if (p < cluster_hi) {
        const int at = static_cast<int>(p - cluster_lo);
        int32_t* owner = cluster.map_shared_rank(diff, at / segment);
        atomicAdd(owner + padded(at % segment), bound ? -1 : 1);
      }
    }
  }
  before = warp_sum(before);
  if (lane == 0) warp_sums[warp] = before;
  __syncthreads();
  if (warp == 0) {
    const int b = warp_sum(warp_sums[lane]);
    if (lane == 0) exchange[1] = b;
  }
  cluster.sync();  // every add has landed

  // The segment's inclusive scan in place: a run of `k` positions a
  // thread, then the runs' totals scanned across the block.
  const int k = (segment + DEPTH_THREADS - 1) / DEPTH_THREADS;
  const int run_lo = min(tid * k, segment), run_hi = min(run_lo + k, segment);
  int sum = 0;
  for (int i = run_lo; i < run_hi; ++i) sum += diff[padded(i)];
  int inclusive = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(FULL, inclusive, d);
    if (lane >= d) inclusive += up;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += up;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int running = inclusive - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = run_lo; i < run_hi; ++i) {
    running += diff[padded(i)];
    diff[padded(i)] = running;
  }
  if (tid == 0) exchange[0] = warp_sums[DEPTH_THREADS / 32 - 1];
  cluster.sync();  // every segment's total is visible

  // The segment's offset: the cluster's net count before it and the
  // totals of the segments before this one.
  if (warp == 0) {
    int part = 0;
    if (lane < DEPTH_CLUSTER) {
      const int* peer = cluster.map_shared_rank(exchange, lane);
      part = peer[1] + (lane < rank ? peer[0] : 0);
    }
    part = warp_sum(part);
    if (lane == 0) block_offset = part;
  }
  cluster.sync();  // no block leaves while a peer may still read its totals
  const int offset = block_offset;
  for (int i = tid; i < segment && lo + i < window_size; i += DEPTH_THREADS)
    out[lo + i] = diff[padded(i)] + offset;
}

}  // namespace cluster_design

}  // namespace

namespace cd = cluster_design;

extern "C" {

int two_launches_tiles(int window_size) { return (window_size + SCAN_TILE - 1) / SCAN_TILE; }

int two_launches(const int32_t* positions, const int32_t* lengths, int rows,
                 int64_t window_start, int window_size, int max_read_length, int32_t* out,
                 unsigned long long* status, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (window_size + SCAN_TILE - 1) / SCAN_TILE;
  diff_kernel<<<(rows + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      positions, lengths, rows, window_start, window_size, max_read_length, out, status,
      tiles + 1);
  scan_kernel<<<tiles, THREADS, 0, s>>>(out, window_size, status, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Words of the zeroed scratch one depth_counts launch over a window of
// window_size positions needs (the launch leaves it zeroed).
// out = the depth over the window (any contents before).
// Words of the scratch one depth_counts launch over a window of
// window_size positions needs: zeroed before the first launch, every launch
// leaves it zeroed.
int cluster(const int32_t* positions, const int32_t* lengths, int rows, int64_t window_start,
            int window_size, int max_read_length, int32_t* out, void* stream) {
  static std::atomic<bool> ready[cd::DEPTH_MAX_DEVICES];
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device >= cd::DEPTH_MAX_DEVICES || !ready[device]) {
    status = cudaFuncSetAttribute(cd::depth_counts_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  cd::padded(cd::DEPTH_MAX_SEGMENT) * 4);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (device < cd::DEPTH_MAX_DEVICES) ready[device] = true;
  }
  const int64_t per_cluster = static_cast<int64_t>(cd::DEPTH_CLUSTER) * cd::DEPTH_MAX_SEGMENT;
  const int clusters = static_cast<int>((window_size + per_cluster - 1) / per_cluster);
  const int64_t blocks = static_cast<int64_t>(cd::DEPTH_CLUSTER) * clusters;
  const int segment = static_cast<int>((window_size + blocks - 1) / blocks);
  cd::depth_counts_kernel<<<static_cast<int>(blocks), cd::DEPTH_THREADS, cd::padded(segment) * 4,
                            static_cast<cudaStream_t>(stream)>>>(
      positions, lengths, rows, window_start, window_size, max_read_length, segment, out);
  return static_cast<int>(cudaGetLastError());
}

int warp_a_read(const int32_t* positions, const int32_t* lengths, int rows,
                int64_t window_start, int window_size, int max_read_length, int32_t* out,
                void* stream) {
  pairs_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      positions, lengths, rows, window_start, window_size, max_read_length, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
"""


def build() -> ctypes.CDLL:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(SOURCE.encode() + " ".join(_kernels.NVCC_FLAGS).encode()).hexdigest()
    src, out = BUILD_DIR / "variants.cu", BUILD_DIR / f"variants-{digest[:16]}.so"
    if not out.exists():
        src.write_text(SOURCE)
        proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.two_launches.argtypes = [P, P, I32, I64, I32, I32, P, P, P]
    lib.cluster.argtypes = [P, P, I32, I64, I32, I32, P, P]
    lib.warp_a_read.argtypes = [P, P, I32, I64, I32, I32, P, P]
    lib.two_launches_tiles.argtypes = [I32]
    for fn in (lib.two_launches, lib.cluster, lib.warp_a_read, lib.two_launches_tiles):
        fn.restype = ctypes.c_int
    return lib


def designs(lib):
    """name → fn(positions, lengths, window, max_read_length) → depth."""

    def two_launches(pos, lens, window, max_len):
        out = torch.zeros(window, dtype=torch.int32, device=pos.device)
        status = torch.empty(lib.two_launches_tiles(window) + 1, dtype=torch.int64,
                             device=pos.device)
        _kernels.check(lib.two_launches(
            pos.data_ptr(), lens.data_ptr(), len(pos), WINDOW_START, window, max_len,
            out.data_ptr(), status.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "two launches")
        return out

    def cluster(pos, lens, window, max_len):
        out = torch.empty(window, dtype=torch.int32, device=pos.device)
        _kernels.check(lib.cluster(
            pos.data_ptr(), lens.data_ptr(), len(pos), WINDOW_START, window, max_len,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "cluster")
        return out

    def warp_a_read(pos, lens, window, max_len):
        out = torch.zeros(window, dtype=torch.int32, device=pos.device)
        _kernels.check(lib.warp_a_read(
            pos.data_ptr(), lens.data_ptr(), len(pos), WINDOW_START, window, max_len,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "warp a read")
        return out

    return {
        "tile totals": lambda pos, lens, window, max_len: depth.depth_counts(
            pos, lens, WINDOW_START, window, max_len),
        "two launches": two_launches,
        "cluster": cluster,
        "warp a read": warp_a_read,
    }


def kernel_times(fn, calls: int = 20) -> dict:
    """Mean device microseconds of each kernel ``fn`` launches (the
    zeroing fill among them), from one ``torch.profiler`` window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]:
            e.self_device_time_total / e.count
            for e in prof.key_averages() if e.device_type.name == "CUDA" and e.count}


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    starts = np.array(sorted(p for p, _ in SyntheticGenomicsSource(num_samples=1).read_starts(
        WINDOW_START, WINDOW_START + SPAN)), dtype=np.int32)
    window = SPAN + READ_PAD
    pos = torch.from_numpy(starts).to(dev)
    lens = torch.full((len(starts),), 100, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    edge_pos = torch.from_numpy(rng.integers(WINDOW_START - 300, WINDOW_START + 5050, 997)
                                .astype(np.int32)).to(dev)
    edge_lens = torch.from_numpy(rng.integers(-3, 512, 997).astype(np.int32)).to(dev)
    found = designs(build())
    for name, fn in found.items():
        for p, l, w, m in ((pos, lens, window, READ_PAD), (edge_pos, edge_lens, 5000, 256)):
            got = fn(p, l, w, m)
            want = depth.depth_counts_plain(p, l, WINDOW_START, w, m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != depth_counts_plain at W {w}")
    times = {name: [] for name in found}
    for _ in range(ROUNDS):
        for order in (list(found), list(found)[::-1]):
            for name in order:
                times[name].append(cuda_event_ms(
                    lambda: found[name](pos, lens, window, READ_PAD), 50))
    print(json.dumps({
        "reads": len(starts), "window": window,
        "ms": {name: sum(t) / len(t) for name, t in times.items()},
        "ms_each": times,
        "profile": {name: kernel_times(lambda: fn(pos, lens, window, READ_PAD))
                    for name, fn in found.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
