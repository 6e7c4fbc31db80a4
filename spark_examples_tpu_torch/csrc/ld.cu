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
//   a[s] = Σ popc(row word & case word),   t[s] = Σ popc(row word).
//
// case_counts_kernel — one warp per site row, 8 rows a block of 256 threads.
//   Bound: bytes. It reads each packed row once (313 bytes at 2,504
//   samples, an eighth of the reference's uint8 row) and writes 8 bytes a
//   row; an and and two popc per 32 columns are far below the integer rate.
//   Lane l takes the row's 32-bit words l, l + 32, ..., so a warp's loads
//   cover 128 neighbouring bytes. Where the pitch or the pointer is not
//   4-byte aligned (or the last row's words would pass the buffer) a word
//   is assembled from byte loads of the row's `width` bytes. Each block
//   first stages the case mask in shared memory as words. The last word of
//   a row is masked to the columns below N, so neither the unused low bits
//   of the last byte nor the pitch's padding count. A shuffle sum over the
//   warp; lane 0 writes a[s] and t[s].
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
// Static limit of the staged case mask: 48 KB of words, 393,216 samples.
constexpr int MAX_CASE_BYTES = 48 * 1024;

// Little-endian word of bytes 4j..4j+3 of p, zero from byte `width` on.
__device__ __forceinline__ uint32_t byte_word(const uint8_t* p, int j, int width) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * j + b < width) w |= static_cast<uint32_t>(p[4 * j + b]) << (8 * b);
  return w;
}

template <bool kWords>
__global__ void __launch_bounds__(THREADS)
case_counts_kernel(const uint8_t* __restrict__ in, int rows, int width, int64_t pitch,
                   const uint8_t* __restrict__ case_mask, int n_cols, int32_t* __restrict__ a,
                   int32_t* __restrict__ t) {
  extern __shared__ uint32_t case_words[];
  const int n_words = (width + 3) / 4;
  const int last = n_words - 1;
  // The last word's columns below N: byte b holds columns 8(4·last + b) ..
  // + 7, the first of them in bit 7.
  uint32_t last_mask = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int valid = min(max(n_cols - 8 * (4 * last + b), 0), 8);
    last_mask |= ((0xFF00u >> valid) & 0xFFu) << (8 * b);
  }
  for (int j = threadIdx.x; j < n_words; j += THREADS) {
    const uint32_t w = byte_word(case_mask, j, width);
    case_words[j] = j == last ? w & last_mask : w;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (s >= rows) return;  // warp-uniform
  const uint8_t* row = in + s * pitch;
  int carriers_case = 0, carriers = 0;
  for (int j = lane; j < n_words; j += 32) {
    uint32_t w = kWords ? reinterpret_cast<const uint32_t*>(row)[j] : byte_word(row, j, width);
    if (j == last) w &= last_mask;
    carriers_case += __popc(w & case_words[j]);
    carriers += __popc(w);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    carriers_case += __shfl_down_sync(0xFFFFFFFFu, carriers_case, offset);
    carriers += __shfl_down_sync(0xFFFFFFFFu, carriers, offset);
  }
  if (lane == 0) {
    a[s] = carriers_case;
    t[s] = carriers;
  }
}

}  // namespace

extern "C" {

// The most packed bytes a case mask may have (the staged words' limit).
int case_counts_max_width() { return MAX_CASE_BYTES; }

// words: every row's first round_up(width, 4) bytes may be read as aligned
// 32-bit words (the wrapper checks pitch, alignment and the buffer's end).
int case_counts_launch(const uint8_t* in, int rows, int width, int64_t pitch, int words,
                       const uint8_t* case_mask, int n_cols, int32_t* a, int32_t* t,
                       void* stream) {
  if (rows < 1 || width < 1 || pitch < width || n_cols < 1 || (n_cols + 7) / 8 != width ||
      width > MAX_CASE_BYTES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const size_t smem = static_cast<size_t>((width + 3) / 4) * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words) {
    case_counts_kernel<true><<<blocks, THREADS, smem, s>>>(in, rows, width, pitch, case_mask,
                                                          n_cols, a, t);
  } else {
    case_counts_kernel<false><<<blocks, THREADS, smem, s>>>(in, rows, width, pitch, case_mask,
                                                           n_cols, a, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
