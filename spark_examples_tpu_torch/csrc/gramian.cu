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
// unpack_rows_t_kernel — one block of 256 threads per tile of 128 sites ×
//   128 columns of Xᵀ.
//   Bound: bytes. It reads the block once and writes n_pad × ld int8; in
//   packed mode the write is 8/9 of them, so the stores are what matter.
//   Stores: every lane writes 16 consecutive sites of one Xᵀ row with one
//   16-byte store, eight lanes a row, so a warp instruction writes four
//   rows of 128 contiguous bytes. The tile is staged in shared memory as
//   32-bit words that already hold four consecutive sites of one row (row
//   s in the low byte), 32 words a row, their 16-byte slots XOR-swizzled by
//   the row so that both the word writes and the 16-byte reads spread over
//   the banks.
//   Packed mode: a staged word is byte j of rows s..s+3 (byte loads: packed
//   rows are ceil(N/8) bytes apart, 313 at 2,504 samples, so neither TMA
//   nor vector loads take them, and they are 1/9 of the traffic). Then
//   (w >> (7 − k)) & 0x01010101 is the Xᵀ word of column 8j + k at those
//   sites: one shift and one mask per four output bytes, no bit loop.
//   Counts mode: a lane loads one 32-bit word (four columns) from each of
//   four rows, byte by byte where the rows are not 4-byte aligned, and
//   transposes the 4 × 4 bytes with eight byte permutes (PRMT) into four
//   staged words, one a column.
//   A tile that lies wholly inside the block (every tile at 2,504 samples
//   but the last column tile) loads without bounds checks, so all of a
//   thread's loads are in flight at once.
//   Columns past N (the unused low bits of the last packed byte included)
//   and sites past B come out zero.
//
// pack_rows_t_kernel — the exact inverse of the packed mode: an int8 {0,1}
//   Xᵀ (rows × sites, sites innermost, n_pad × ld) back into bit-packed
//   rows, (B, n_cols / 8) uint8 in np.packbits' big-endian order (bit 7 of
//   byte j is column 8j), a nonzero byte a 1 as np.packbits takes it.
//   Replaces spark_examples_tpu/ops/gramian.py:_pack_bits_device, which the
//   device-generation ring runs on its generated columns before the first
//   transfer, so the ring circulates ⅛ of the bytes.
//   Bound: bytes (it reads n_cols × B int8 and writes an eighth of that).
//   One block of 256 threads a tile of 128 sites × 128 columns: 16-byte
//   loads of the tile's rows into shared memory (a row padded by 16 bytes,
//   so a warp's column-wise reads of one site meet distinct banks), then a
//   thread packs 8 output bytes of one site, reading its 64 columns, and
//   stores them; sites past B and bytes past n_cols / 8 are not written.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_SITES = 128;  // sites per tile: one row segment of 128 bytes
constexpr int TILE_COLS = 128;   // columns per tile
constexpr int THREADS = 256;
constexpr int QUADS = TILE_SITES / 4;  // staged words a row
constexpr int SEGMENTS = TILE_SITES / 16;  // 16-byte stores a row

// The staged word of site quad `quad` in row `r`: 16-byte slots swizzled
// by the row.
__device__ __forceinline__ int staged(int r, int quad) {
  const int slot = (quad >> 2) ^ ((r ^ (r >> 2)) & 7);
  return r * QUADS + slot * 4 + (quad & 3);
}

// Bytes c..c+3 of a count row (little-endian), zero past n_cols.
__device__ __forceinline__ uint32_t count_word(const uint8_t* row, int c, int n_cols, bool words) {
  if (words && c + 3 < n_cols) return *reinterpret_cast<const uint32_t*>(row + c);
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c + b < n_cols) w |= static_cast<uint32_t>(row[c + b]) << (8 * b);
  return w;
}

// Stage the tile's words. kInterior: every row, column and byte of the tile
// lies inside the block (and count rows take 32-bit loads), so the loads
// carry no bounds checks and all issue before the first is used.
template <bool kPacked, bool kInterior>
__device__ __forceinline__ void stage_tile(uint32_t* tile, const uint8_t* __restrict__ in, int rows,
                                           int in_width, int n_cols, bool words, int s0, int c0) {
  const int tid = threadIdx.x;
  if (kPacked) {
    // Word (j, quad): byte c0/8 + j of rows s0 + 4·quad .. + 3; a warp
    // reads 16 neighbouring bytes of each of two rows an instruction.
    constexpr int BYTES = TILE_COLS / 8;
#pragma unroll
    for (int i = 0; i < BYTES * QUADS / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int j = u % BYTES, quad = u / BYTES;
      const int byte = c0 / 8 + j;
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + 4 * quad + k;
        if (kInterior || (byte < in_width && s < rows))
          w |= static_cast<uint32_t>(in[static_cast<int64_t>(s) * in_width + byte]) << (8 * k);
      }
      tile[staged(j, quad)] = w;
    }
  } else {
    // Unit (column quad cq, site quad): a warp's lanes read 128 neighbouring
    // bytes of a row an instruction.
    constexpr int CQUADS = TILE_COLS / 4;
#pragma unroll
    for (int i = 0; i < CQUADS * QUADS / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int cq = u % CQUADS, quad = u / CQUADS;
      uint32_t a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + 4 * quad + k;
        const uint8_t* row = in + static_cast<int64_t>(s) * in_width;
        if (kInterior)
          a[k] = *reinterpret_cast<const uint32_t*>(row + c0 + 4 * cq);
        else
          a[k] = s < rows ? count_word(row, c0 + 4 * cq, n_cols, words) : 0u;
      }
      // 4 × 4 byte transpose: word i holds column 4·cq + i of the four rows.
      const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
      const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
      tile[staged(4 * cq, quad)] = __byte_perm(t0, t2, 0x5410);
      tile[staged(4 * cq + 1, quad)] = __byte_perm(t0, t2, 0x7632);
      tile[staged(4 * cq + 2, quad)] = __byte_perm(t1, t3, 0x5410);
      tile[staged(4 * cq + 3, quad)] = __byte_perm(t1, t3, 0x7632);
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(THREADS)
unpack_rows_t_kernel(const uint8_t* __restrict__ in, int rows, int in_width, int n_cols,
                     int words, int8_t* __restrict__ xt, int ld) {
  __shared__ __align__(16) uint32_t tile[TILE_COLS * QUADS];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * TILE_SITES;
  const int c0 = blockIdx.y * TILE_COLS;
  const bool interior = s0 + TILE_SITES <= rows &&
                        (kPacked ? c0 / 8 + TILE_COLS / 8 <= in_width
                                 : words && c0 + TILE_COLS <= n_cols);
  if (interior)
    stage_tile<kPacked, true>(tile, in, rows, in_width, n_cols, words, s0, c0);
  else
    stage_tile<kPacked, false>(tile, in, rows, in_width, n_cols, words, s0, c0);
  __syncthreads();

  if (kPacked) {
    // Thread (half, j, segment): four of the eight columns of byte j at 16
    // sites.
    const int seg = tid % SEGMENTS, j = tid / SEGMENTS % (TILE_COLS / 8);
    const int half = tid / (SEGMENTS * TILE_COLS / 8);
    const uint4 w = *reinterpret_cast<const uint4*>(&tile[staged(j, 4 * seg)]);
#pragma unroll
    for (int k = 4 * half; k < 4 * half + 4; ++k) {
      const int c = c0 + 8 * j + k;
      const int shift = 7 - k;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (c < n_cols) {
        out.x = (w.x >> shift) & 0x01010101u;
        out.y = (w.y >> shift) & 0x01010101u;
        out.z = (w.z >> shift) & 0x01010101u;
        out.w = (w.w >> shift) & 0x01010101u;
      }
      *reinterpret_cast<uint4*>(xt + static_cast<int64_t>(c) * ld + s0 + 16 * seg) = out;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TILE_COLS * SEGMENTS / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int seg = u % SEGMENTS, c = u / SEGMENTS;
      *reinterpret_cast<uint4*>(xt + static_cast<int64_t>(c0 + c) * ld + s0 + 16 * seg) =
          *reinterpret_cast<const uint4*>(&tile[staged(c, 4 * seg)]);
    }
  }
}

constexpr int PACK_STRIDE = TILE_SITES + 16;  // a staged column row, bytes

__global__ void __launch_bounds__(THREADS)
pack_rows_t_kernel(const int8_t* __restrict__ xt, int ld, int rows, int out_width,
                   uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[TILE_COLS * PACK_STRIDE];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * TILE_SITES;
  const int c0 = blockIdx.y * TILE_COLS;
  // Loads: column row c, 16 sites a lane (the tile lies inside Xᵀ: both
  // of its dimensions are multiples of 128).
#pragma unroll
  for (int i = 0; i < TILE_COLS * SEGMENTS / THREADS; ++i) {
    const int u = tid + i * THREADS;
    const int seg = u % SEGMENTS, c = u / SEGMENTS;
    *reinterpret_cast<uint4*>(&tile[c * PACK_STRIDE + 16 * seg]) =
        *reinterpret_cast<const uint4*>(xt + static_cast<int64_t>(c0 + c) * ld + s0 + 16 * seg);
  }
  __syncthreads();
  // Thread (group, site): output bytes 8·group .. 8·group + 7 of the tile's
  // 16 at one site.
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

extern "C" {

// The site granularity the Python side pads ld to, checked at load.
int gramian_tile_sites() { return TILE_SITES; }

int unpack_rows_t_launch(const uint8_t* in, int rows, int in_width, int n_cols,
                         int packed, int8_t* xt, int n_pad, int ld, void* stream) {
  if (ld % TILE_SITES != 0 || n_pad % TILE_COLS != 0 || rows > ld || n_cols > n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(ld / TILE_SITES, n_pad / TILE_COLS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    unpack_rows_t_kernel<true><<<grid, THREADS, 0, s>>>(in, rows, in_width, n_cols, 0, xt, ld);
  } else {
    // Whole 32-bit loads where every row starts on a 4-byte boundary.
    const int words = in_width % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 4 == 0;
    unpack_rows_t_kernel<false><<<grid, THREADS, 0, s>>>(in, rows, in_width, n_cols, words, xt, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (rows, n_cols / 8) uint8 = the bit-packed rows of the int8 Xᵀ
// (n_pad, ld) at `xt` (16-byte aligned; n_pad and ld multiples of 128,
// n_cols a multiple of 8 and at most n_pad, rows at most ld).
int pack_rows_t_launch(const int8_t* xt, int n_pad, int ld, int n_cols, int rows, uint8_t* out,
                       void* stream) {
  if (ld % TILE_SITES != 0 || n_pad % TILE_COLS != 0 || n_cols % 8 != 0 || n_cols > n_pad ||
      rows > ld || reinterpret_cast<uintptr_t>(xt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n_cols == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rows + TILE_SITES - 1) / TILE_SITES, (n_cols + TILE_COLS - 1) / TILE_COLS);
  pack_rows_t_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(xt, ld, rows,
                                                                             n_cols / 8, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
