// Unpack of host-fed genotype blocks for Hopper (sm_90a): the packed and
// wire arms of variants-pca's dense ingest.
//
// Replaces the unpack half of the device program
// spark_examples_tpu/ops/gramian.py:_dense_update (its _unpack_bits and the
// cast to the matrix-unit operand type) and the cast of _dense_update_counts.
// The host ships each flushed block of B variant rows either bit-packed,
// (B, ceil(N/8)) uint8 in np.packbits' big-endian order (bit 7 of byte j is
// column 8j), or count-valued, (B, N) uint8 (same-set joins; the wrapper
// has checked every count fits int8). The kernel writes the block as the
// int8 Xᵀ that gram_accumulate (csrc/devicegen.cu) takes: n_pad rows of ld
// sites, both padded with zeros (n_pad a multiple of 128 ≥ N, ld a multiple
// of 128 ≥ B), so the product needs no masking.
//
// unpack_rows_t_kernel — one 32×32-thread block per tile of 32 sites × 256
//   columns. Each thread reads along the block's rows (one packed byte, or
//   eight count bytes 32 apart), writes the values into a shared-memory
//   tile indexed [column][site], and after the barrier stores the tile
//   transposed: a warp writes 32 consecutive sites of one Xᵀ row, so the
//   stores are coalesced along sites. Columns past N and sites past B come
//   out zero, including the unused low bits of the last packed byte.
//   Bound: bytes — it reads the block once and writes n_pad × ld int8;
//   the shifts and masks are a few operations per output byte.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_SITES = 32;   // sites per tile (threadIdx.x on the store)
constexpr int TILE_COLS = 256;   // columns per tile
constexpr int TILE_STRIDE = TILE_SITES + 1;

template <bool kPacked>
__global__ void __launch_bounds__(TILE_SITES * 32)
unpack_rows_t_kernel(const uint8_t* __restrict__ in, int rows, int in_width,
                     int n_cols, int8_t* __restrict__ xt, int n_pad, int ld) {
  __shared__ int8_t tile[TILE_COLS * TILE_STRIDE];  // [column][site]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int s0 = blockIdx.x * TILE_SITES;
  const int c0 = blockIdx.y * TILE_COLS;
  const int s = s0 + ty;  // this thread's site on the load
  const bool row_ok = s < rows;

  if (kPacked) {
    // Byte tx of the tile's row holds columns c0 + 8·tx … c0 + 8·tx + 7.
    const int byte = c0 / 8 + tx;
    uint32_t v = 0;
    if (row_ok && byte < in_width) v = in[static_cast<int64_t>(s) * in_width + byte];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + 8 * tx + k;
      const uint32_t bit = (v >> (7 - k)) & 1u;
      tile[(8 * tx + k) * TILE_STRIDE + ty] = static_cast<int8_t>(c < n_cols ? bit : 0u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < TILE_COLS / 32; ++k) {
      const int c = c0 + tx + 32 * k;
      uint8_t v = 0;
      if (row_ok && c < n_cols) v = in[static_cast<int64_t>(s) * in_width + c];
      tile[(tx + 32 * k) * TILE_STRIDE + ty] = static_cast<int8_t>(v);
    }
  }
  __syncthreads();

  // Store: warp ty writes columns ty, ty + 32, …; lane tx one site each.
#pragma unroll
  for (int k = 0; k < TILE_COLS / 32; ++k) {
    const int r = ty + 32 * k;
    const int c = c0 + r;
    if (c < n_pad) {
      xt[static_cast<int64_t>(c) * ld + s0 + tx] = tile[r * TILE_STRIDE + tx];
    }
  }
}

}  // namespace

extern "C" {

// The site granularity the Python side pads ld to, checked at load.
int gramian_tile_sites() { return TILE_SITES; }

int unpack_rows_t_launch(const uint8_t* in, int rows, int in_width, int n_cols,
                         int packed, int8_t* xt, int n_pad, int ld, void* stream) {
  if (ld % TILE_SITES != 0 || rows > ld || n_cols > n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(ld / TILE_SITES, (n_pad + TILE_COLS - 1) / TILE_COLS);
  const dim3 block(TILE_SITES, 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    unpack_rows_t_kernel<true><<<grid, block, 0, s>>>(in, rows, in_width, n_cols, xt, n_pad, ld);
  } else {
    unpack_rows_t_kernel<false><<<grid, block, 0, s>>>(in, rows, in_width, n_cols, xt, n_pad, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
