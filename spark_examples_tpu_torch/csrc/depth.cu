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
// depth_counts_kernel / base_counts_kernel — one warp per read, 8 reads a
//   block of 256 threads. A warp loads its read's position (and length)
//   once, clips the offsets to the window and to the read, and its lanes
//   walk the offsets 32 apart, so the atomics of a warp land on 32
//   neighbouring counters (base_counts: 32 neighbouring positions, each
//   one of 4 counters) and the code and mask bytes load coalesced.
//   Bound: bytes at these shapes (a whole-chr21 shard: 26,193 reads into
//   a 1.3 MB window; the pairs' 32-bit atomics are below the integer
//   rate), so the kernel reads each input once and the window takes the
//   atomics in L2. Integer atomics give the same sums in any order, so the
//   result equals the reference's exactly.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launchers
// return cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int READS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__global__ void __launch_bounds__(THREADS)
depth_counts_kernel(const int32_t* __restrict__ positions, const int32_t* __restrict__ lengths,
                    int rows, int64_t window_start, int window_size, int max_read_length,
                    int32_t* __restrict__ out) {
  const int r = blockIdx.x * READS_PER_BLOCK + threadIdx.x / 32;
  if (r >= rows) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  const int64_t n = min64(lengths[r], max_read_length);
  const int64_t lo = max64(0, -rel);
  const int64_t hi = min64(n, window_size - rel);
  for (int64_t off = lo + lane; off < hi; off += 32) atomicAdd(out + rel + off, 1);
}

__global__ void __launch_bounds__(THREADS)
base_counts_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out) {
  const int r = blockIdx.x * READS_PER_BLOCK + threadIdx.x / 32;
  if (r >= rows) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  const int64_t lo = max64(0, -rel);
  const int64_t hi = min64(read_len, window_size - rel);
  const int8_t* row_codes = codes + static_cast<int64_t>(r) * read_len;
  const uint8_t* row_ok = quality_ok + static_cast<int64_t>(r) * read_len;
  for (int64_t off = lo + lane; off < hi; off += 32) {
    const int code = row_codes[off];
    if (row_ok[off] && code >= 0) atomicAdd(out + 4 * (rel + off) + min(code, 3), 1);
  }
}

}  // namespace

extern "C" {

int depth_counts_launch(const int32_t* positions, const int32_t* lengths, int rows,
                        int64_t window_start, int window_size, int max_read_length,
                        int32_t* out, void* stream) {
  if (rows < 1 || window_size < 1 || max_read_length < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + READS_PER_BLOCK - 1) / READS_PER_BLOCK;
  depth_counts_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, lengths, rows, window_start, window_size, max_read_length, out);
  return static_cast<int>(cudaGetLastError());
}

int base_counts_launch(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok,
                       int rows, int read_len, int64_t window_start, int window_size,
                       int32_t* out, void* stream) {
  if (rows < 1 || read_len < 0 || window_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + READS_PER_BLOCK - 1) / READS_PER_BLOCK;
  base_counts_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
