// Read depth and base counts for Hopper (sm_90a): the device half of the
// reads examples (search-reads-example-3 and -4).
//
// Replaces the device programs spark_examples_tpu/ops/depth.py:depth_counts
// and :base_counts (jitted scatter-adds, not Pallas). Both count, into a
// dense int32 window that starts at reference position `window_start`,
// the (read, offset) pairs of a shard's reads:
//
//   depth_counts: out[rel + off] += 1 for off < min(length, max_read_length)
//                 and 0 <= rel + off < W, rel = position - window_start
//                 (the reference's offsets stop at its static
//                 max_read_length even where a length is larger, and a
//                 length <= 0 counts nothing);
//   base_counts:  out[rel + off][min(code, 3)] += 1 for off < L where
//                 quality_ok[r][off] != 0, code = codes[r][off] >= 0 and
//                 0 <= rel + off < W (codes are (R, L) int8, -1 past each
//                 read; the reference clips a code above 3 to 3).
//
// depth_adds_kernel + depth_scan_kernel — read depth as a difference array
//   and its prefix sum. A read covers one interval of the window,
//   [first, end) after the clipping above, so depth is the inclusive prefix
//   sum of +1 at each first and -1 at each end inside the window: 2 atomics
//   a read (52 K at a whole-chr21 shard of 26,194 reads) in place of one a
//   (read, offset) pair (2.62 M onto 327,542 counters, 8 deep a counter, in
//   the warp-a-read kernel this replaces), and O(R + W) work. Bound: bytes
//   (positions and lengths read, the window written once).
//   depth_adds_kernel, a thread a read, adds the two bounds into the
//   difference array and, aggregated over the warp's lanes that fall in
//   the same tile (match.any), into the totals of the tiles of SCAN_TILE
//   positions they fall in. depth_scan_kernel, a tile a block, loads its
//   differences (16-byte loads, 8 a thread), sums the totals of the tiles
//   before it, scans the tile (registers, warp shuffles, the 4 warp
//   totals) and writes it once. Tiles of 1,024 (320 at a chr21 shard)
//   spread the scan's loads and stores over every SM. No block waits on another: the tile
//   totals replace a look-back over status words.
//   At a shard's size the work is a few microseconds, so launches, memsets
//   and dependent trips to L2 set the pace. So the difference buffer and
//   the two tile-totals buffers are kept per device and stream by the
//   wrapper, zeroed once: the scan clears the differences it reads, and
//   each launch clears the other totals buffer for the next launch, which
//   takes them in turns. Measured against a zeroed window with a look-back
//   scan, a thread block cluster holding the window in distributed shared
//   memory, and the warp-a-read kernel (experiments/depth_variants.py).
//   Every sum is an int32 count, so the result equals the reference's
//   exactly in any order.
//
// base_counts_kernel — a warp a read, lane l taking the read's offsets
//   l, l + 32, ...: its position, then the code and mask bytes of up to
//   BASE_UNROLL offsets a lane loaded together (one trip for a read of up
//   to 128 bases), then their bases added with int32 atomics into the
//   (W, 4) window; a warp's atomics land on 32 neighbouring positions. At
//   an example-4 shard (4,210 reads × 100 bases into a 52,759-position
//   window, 219 K counted bases) the bytes take 0.6 µs, so the time is
//   launches, trips to memory and the atomics. The first port spent a
//   launch of its own zero-filling the window (torch.zeros) and its loop
//   loaded each offset's bytes after the atomics before them. Here the
//   window a launch adds into was zeroed by the launch before it on the
//   same stream: the wrapper keeps one zeroed buffer per device and stream
//   (ops/depth.py:_BASE_SPARE), hands it out as this call's result and
//   passes a fresh one as `next`, which this launch's threads zero with
//   16-byte stores beside their adds. One launch a call. A block-private
//   histogram would not cut the atomics (a window counter takes about one
//   base at depth 8). Integer atomics give the same sums in any order of
//   reads, sorted or not, so the counts equal the reference exactly.
//   Measured against the first port's kernel, a thread a 32-bit word,
//   16-byte vectors, a zero-fill by torch.zeros or cudaMemsetAsync, one
//   launch zeroing the window behind a grid barrier, and two tile kernels
//   in which a block owns a tile of the window
//   (experiments/count_variants.py).
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launchers
// return cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BASE_THREADS = 256;
constexpr int BASE_UNROLL = 4;  // a lane's offsets of a read loaded together: 128 a warp
constexpr int DEPTH_THREADS = 128;  // the depth kernels
constexpr int SCAN_ITEMS = 8;       // two 16-byte vectors a thread
constexpr int SCAN_TILE = DEPTH_THREADS * SCAN_ITEMS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// Adds `sign` × (the lanes holding `tile`) to totals[tile], once for each
// distinct tile in the warp (tile < 0: nothing).
__device__ __forceinline__ void add_to_tile(int32_t* totals, int tile, int sign) {
  const unsigned same = __match_any_sync(FULL, tile);
  if (tile >= 0 && threadIdx.x % 32 == __ffs(same) - 1)
    atomicAdd(totals + tile, sign * __popc(same));
}

// +1 at each read's first covered position, -1 at its end inside the
// window, into the zeroed difference array, and the same into the totals
// of the tiles they fall in; the grid also clears the other totals buffer
// (the next launch's).
__global__ void __launch_bounds__(DEPTH_THREADS)
depth_adds_kernel(const int32_t* __restrict__ positions, const int32_t* __restrict__ lengths,
                  int rows, int64_t window_start, int window_size, int max_read_length,
                  int32_t* __restrict__ diff, int32_t* __restrict__ totals,
                  int32_t* __restrict__ next_totals, int totals_words) {
  const int r = blockIdx.x * DEPTH_THREADS + threadIdx.x;
  for (int w = r; w < totals_words; w += gridDim.x * DEPTH_THREADS) next_totals[w] = 0;
  int first_tile = -1, end_tile = -1;
  if (r < rows) {
    const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
    const int64_t first = max64(rel, 0);
    const int64_t end = min64(rel + min64(lengths[r], max_read_length), window_size);
    if (first < end) {
      atomicAdd(diff + first, 1);
      first_tile = static_cast<int>(first / SCAN_TILE);
      if (end < window_size) {
        atomicAdd(diff + end, -1);
        end_tile = static_cast<int>(end / SCAN_TILE);
      }
    }
  }
  add_to_tile(totals, first_tile, 1);
  add_to_tile(totals, end_tile, -1);
}

// out = the inclusive prefix sum of diff, a tile of SCAN_TILE positions a
// block: the tile's own scan plus the totals of the tiles before it. Each
// block clears the differences it read.
__global__ void __launch_bounds__(DEPTH_THREADS)
depth_scan_kernel(int32_t* __restrict__ diff, int window_size,
                  const int32_t* __restrict__ totals, int32_t* __restrict__ out) {
  __shared__ int warp_totals[DEPTH_THREADS / 32], warp_before[DEPTH_THREADS / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x;
  const int64_t base = static_cast<int64_t>(tile) * SCAN_TILE + tid * SCAN_ITEMS;
  const bool whole = base + SCAN_ITEMS <= window_size;
  int v[SCAN_ITEMS];
  if (whole) {
    int4* vec = reinterpret_cast<int4*>(diff + base);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 x = vec[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) vec[q] = make_int4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = base + j < window_size ? diff[base + j] : 0;
      if (base + j < window_size) diff[base + j] = 0;
    }
  }
  int prior = 0;  // this thread's share of the totals of the tiles before
  for (int t = tid; t < tile; t += DEPTH_THREADS) prior += totals[t];
#pragma unroll
  for (int j = 1; j < SCAN_ITEMS; ++j) v[j] += v[j - 1];
  int sum = v[SCAN_ITEMS - 1];  // becomes the inclusive scan of the warp's thread totals
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(FULL, sum, d);
    if (lane >= d) sum += up;
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) prior += __shfl_xor_sync(FULL, prior, d);
  if (lane == 31) warp_totals[warp] = sum;
  if (lane == 0) warp_before[warp] = prior;
  __syncthreads();
  int offset = sum - v[SCAN_ITEMS - 1];
#pragma unroll
  for (int w = 0; w < DEPTH_THREADS / 32; ++w) offset += (w < warp ? warp_totals[w] : 0) + warp_before[w];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) v[j] += offset;
  if (whole) {
    int4* vec = reinterpret_cast<int4*>(out + base);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q)
      vec[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j)
      if (base + j < window_size) out[base + j] = v[j];
  }
}

__global__ void __launch_bounds__(BASE_THREADS)
base_counts_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out,
                   int4* __restrict__ next, int64_t next_vectors) {
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * BASE_THREADS + threadIdx.x;
  if (thread < next_vectors) next[thread] = make_int4(0, 0, 0, 0);
  const int r = static_cast<int>(thread / 32), lane = threadIdx.x % 32;
  if (r >= rows) return;  // warp-uniform
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  const int8_t* row_codes = codes + static_cast<int64_t>(r) * read_len;
  const uint8_t* row_ok = quality_ok + static_cast<int64_t>(r) * read_len;
  for (int first = 0; first < read_len; first += 32 * BASE_UNROLL) {
    int code[BASE_UNROLL], ok[BASE_UNROLL];
#pragma unroll
    for (int u = 0; u < BASE_UNROLL; ++u) {
      const int off = first + 32 * u + lane;
      code[u] = off < read_len ? row_codes[off] : -1;
      ok[u] = off < read_len ? row_ok[off] : 0;
    }
#pragma unroll
    for (int u = 0; u < BASE_UNROLL; ++u) {
      const int64_t p = rel + first + 32 * u + lane;
      if (ok[u] && code[u] >= 0 && p >= 0 && p < window_size)
        atomicAdd(out + 4 * p + min(code[u], 3), 1);
    }
  }
}

}  // namespace

extern "C" {

// The scan's tile: a window of W positions has ceil(W / tile) tiles.
int depth_scan_tile() { return SCAN_TILE; }

// out (16-byte aligned, any contents) = the depth over the window. diff: W
// zeroed int32, 16-byte aligned, left zeroed; totals and next_totals:
// totals_words int32 each (at least the window's tiles), totals zeroed,
// next_totals left zeroed for the next launch (which passes them swapped).
// Two launches on `stream`, which no other launch using these buffers may
// overlap.
int depth_counts_launch(const int32_t* positions, const int32_t* lengths, int rows,
                        int64_t window_start, int window_size, int max_read_length,
                        int32_t* out, int32_t* diff, int32_t* totals, int32_t* next_totals,
                        int totals_words, void* stream) {
  const int tiles = (window_size + SCAN_TILE - 1) / SCAN_TILE;
  if (rows < 1 || window_size < 1 || max_read_length < 0 || totals_words < tiles ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(diff) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  depth_adds_kernel<<<(rows + DEPTH_THREADS - 1) / DEPTH_THREADS, DEPTH_THREADS, 0, s>>>(
      positions, lengths, rows, window_start, window_size, max_read_length, diff, totals,
      next_totals, totals_words);
  const cudaError_t adds = cudaGetLastError();
  if (adds != cudaSuccess) return static_cast<int>(adds);
  depth_scan_kernel<<<tiles, DEPTH_THREADS, 0, s>>>(diff, window_size, totals, out);
  return static_cast<int>(cudaGetLastError());
}

// out: the (window_size, 4) int32 counts, zeroed (by the previous launch
// on this stream, as `next`). next: next_vectors int4 (16-byte aligned)
// that this launch zeroes, the next launch's `out` (may be 0).
int base_counts_launch(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok,
                       int rows, int read_len, int64_t window_start, int window_size,
                       int32_t* out, int4* next, int64_t next_vectors, void* stream) {
  if (rows < 1 || read_len < 0 || window_size < 1 || next_vectors < 0 ||
      reinterpret_cast<uintptr_t>(next) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t reads = static_cast<int64_t>(rows) * 32;
  const int64_t threads = reads > next_vectors ? reads : next_vectors;
  base_counts_kernel<<<static_cast<int>((threads + BASE_THREADS - 1) / BASE_THREADS),
                       BASE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out, next,
      next_vectors);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
