// Association carrier counts for Hopper (sm_90a): the device half of the
// assoc-scan verb.
//
// Replaces the device program spark_examples_tpu/ops/ld.py:build_case_counts
// (jitted, not Pallas): for each site s of a block of B has-variation rows,
// the carriers among the cases a[s] = Σ_j X[s, j]·case[j] and the carriers
// in all t[s] = Σ_j X[s, j], int32 (each at most N). The reference
// multiplies the (B, N) uint8 block by the case vector. Here the block
// arrives bit-packed, as the packed arm ships it: (B, ceil(N/8)) uint8 in
// np.packbits' big-endian order (bit 7 of byte c is column 8c), rows
// `pitch` bytes apart, and the case mask packed the same way, so
//
//   a[s] = Σ popc(row bits & case bits),   t[s] = Σ popc(row bits).
//
// case_counts_kernel — `lanes` lanes a row (a power of two up to 32, from
//   ops/ld.py:case_counts_lanes: enough lanes to give the launch half the
//   card's threads, at most four 16-byte vectors a lane; 32 lanes a row of
//   2,504 samples, 20 vectors, at the CLI's 1,024 rows, 8 at 16,384), 128
//   threads a block.
//   Bound: bytes. It reads each packed row once (313 bytes at 2,504
//   samples, an eighth of the reference's uint8 row) and writes 8 bytes a
//   row; an and and two popc per 32 columns are far below the integer rate.
//   At the CLI's block of 1,024 rows the bytes take 0.1 µs, so the time is
//   the launch and the trips to memory: a lane issues its row vectors and
//   the matching case vectors (read-only path, no staging, no barrier)
//   together, one trip, then a shuffle sum over the row's lanes. The last
//   vector of a row is masked to the columns below N, so neither the unused
//   low bits of the last byte nor the pitch's padding count.
//   case_counts_bytes_kernel is the same walk with each vector assembled
//   from the row's `width` bytes, for views whose pitch, pointers or
//   storage do not allow 16-byte loads (ops/ld.py:case_counts_vector_path).
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Bytes 16v .. 16v + 15 of p as four little-endian words, zero from byte
// `width` on.
__device__ __forceinline__ uint4 byte_vector(const uint8_t* p, int v, int width) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (16 * v + b < width) w[b / 4] |= static_cast<uint32_t>(p[16 * v + b]) << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVectors>
__device__ __forceinline__ uint4 row_vector(const uint8_t* p, int v, int width) {
  if constexpr (kVectors) return __ldg(reinterpret_cast<const uint4*>(p) + v);
  return byte_vector(p, v, width);
}

template <bool kVectors>
__device__ __forceinline__ void count_rows(const uint8_t* __restrict__ in, int rows, int width,
                                           int64_t pitch, const uint8_t* __restrict__ case_mask,
                                           int n_cols, int lanes, int32_t* __restrict__ a,
                                           int32_t* __restrict__ t) {
  const int vectors = (width + 15) / 16;
  const int last = vectors - 1;
  // The last vector's columns below N: byte b holds columns
  // 8(16·last + b) .. + 7, the first of them in bit 7.
  uint32_t last_mask[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int valid = min(max(n_cols - 8 * (16 * last + b), 0), 8);
    last_mask[b / 4] |= ((0xFF00u >> valid) & 0xFFu) << (8 * (b % 4));
  }
  const int thread = blockIdx.x * THREADS + threadIdx.x;
  const int s = thread / lanes, g = thread % lanes;
  int carriers_case = 0, carriers = 0;
  if (s < rows) {
    const uint8_t* row = in + s * pitch;
#pragma unroll 4
    for (int v = g; v < vectors; v += lanes) {
      uint4 x = row_vector<kVectors>(row, v, width);
      const uint4 c = row_vector<kVectors>(case_mask, v, width);
      if (v == last) {
        x.x &= last_mask[0];
        x.y &= last_mask[1];
        x.z &= last_mask[2];
        x.w &= last_mask[3];
      }
      carriers_case += __popc(x.x & c.x) + __popc(x.y & c.y) + __popc(x.z & c.z) +
                       __popc(x.w & c.w);
      carriers += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
  }
  // The row's lanes are `lanes` neighbours of one warp; every lane of the
  // warp shuffles, so rows past the block's end add zeros.
  for (int offset = lanes / 2; offset > 0; offset >>= 1) {
    carriers_case += __shfl_xor_sync(FULL, carriers_case, offset);
    carriers += __shfl_xor_sync(FULL, carriers, offset);
  }
  if (s < rows && g == 0) {
    a[s] = carriers_case;
    t[s] = carriers;
  }
}

__global__ void __launch_bounds__(THREADS)
case_counts_kernel(const uint8_t* __restrict__ in, int rows, int width, int64_t pitch,
                   const uint8_t* __restrict__ case_mask, int n_cols, int lanes,
                   int32_t* __restrict__ a, int32_t* __restrict__ t) {
  count_rows<true>(in, rows, width, pitch, case_mask, n_cols, lanes, a, t);
}

__global__ void __launch_bounds__(THREADS)
case_counts_bytes_kernel(const uint8_t* __restrict__ in, int rows, int width, int64_t pitch,
                         const uint8_t* __restrict__ case_mask, int n_cols, int lanes,
                         int32_t* __restrict__ a, int32_t* __restrict__ t) {
  count_rows<false>(in, rows, width, pitch, case_mask, n_cols, lanes, a, t);
}

}  // namespace

extern "C" {

// vectors: every row's and the case mask's first round_up(width, 16) bytes
// may be read as aligned 16-byte vectors (the wrapper checks pitch,
// alignment and the storages' ends). lanes: a power of two up to 32.
int case_counts_launch(const uint8_t* in, int rows, int width, int64_t pitch, int vectors,
                       const uint8_t* case_mask, int n_cols, int lanes, int32_t* a, int32_t* t,
                       void* stream) {
  if (rows < 1 || width < 1 || pitch < width || n_cols < 1 || (n_cols + 7) / 8 != width ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (vectors && (pitch % 16 || reinterpret_cast<uintptr_t>(in) % 16 ||
                   reinterpret_cast<uintptr_t>(case_mask) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t threads = static_cast<int64_t>(rows) * lanes;
  const int blocks = static_cast<int>((threads + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectors) {
    case_counts_kernel<<<blocks, THREADS, 0, s>>>(in, rows, width, pitch, case_mask, n_cols,
                                                  lanes, a, t);
  } else {
    case_counts_bytes_kernel<<<blocks, THREADS, 0, s>>>(in, rows, width, pitch, case_mask,
                                                        n_cols, lanes, a, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
