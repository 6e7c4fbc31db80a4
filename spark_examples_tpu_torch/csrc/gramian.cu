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
// stacked_unpack_rows_t_kernel — the packed mode for K stacked jobs at
//   once: the unpack half of spark_examples_tpu/ops/batched.py:
//   StackedJobsAccumulator._drain, which runs _dense_update with the jobs
//   axis in the leading slot. The input is (K, B, ceil(N/8)) bit-packed
//   rows, the output one (K·n_pad, ld) Xᵀ whose lane k starts at row
//   k·n_pad, a multiple of 128, so the stacked product's 128-row boxes
//   never straddle two lanes. The lane is gridDim.z (csrc/stacked.cuh:
//   every lane, or the lanes the launcher lists, those with a block this
//   step); each block runs unpack_rows_t_kernel's tile body unchanged.
//
// pack_rows_t_kernel — the exact inverse of the packed mode: an int8 {0,1}
//   Xᵀ (rows × sites, sites innermost, n_pad × ld) back into bit-packed
//   rows, (B, n_cols / 8) uint8 in np.packbits' big-endian order (bit 7 of
//   byte j is column 8j), a nonzero byte a 1 as np.packbits takes it.
//   Replaces spark_examples_tpu/ops/gramian.py:_pack_bits_device, which the
//   device-generation ring runs on its generated columns before the first
//   transfer, so the ring circulates ⅛ of the bytes.
//   Bound: bytes (it reads n_cols × B int8 and writes an eighth of that).
//   The first version built each output byte from eight shared-memory
//   byte loads and stored it alone: a warp's stores touched 32 rows
//   out_width bytes apart. Now a block takes PACK_SITES sites × every
//   column (up to PACK_MAX_BYTES of a row; wider rows take more blocks
//   along y): warp w takes the 32-column groups w, w + 8, ..., a lane a
//   column, and loads its 32 sites as one 32-byte sector (two 16-byte
//   loads, each asking L2 for the whole 128-byte line, which the blocks of
//   the next sites read; a warp of many groups keeps PACK_DEEP groups'
//   loads in flight). A warp vote per site,
//   __ballot_sync(byte != 0), is that site's 32 columns as one word (bit
//   l: column 32·group + l); lane i keeps site i's, and __brev then a
//   byte swap put it in np.packbits' order (byte j holds columns 8j..8j+7, the
//   first in bit 7). The block's output is then one contiguous range of
//   sites × out_width bytes (staged in shared memory as in the output)
//   and leaves in 16-byte stores; where a row is wider than a block's
//   share, each site's segment leaves byte by byte.
//
// transpose_rows_t_kernel — the unpacked ring wire's rows: the first n_cols
//   columns of an int8 Xᵀ (n_pad × ld, sites innermost) as (rows, n_cols)
//   uint8 rows, row s holding site s's columns, the bytes as they are.
//   Replaces the cast the reference's device-generation ring ships on its
//   unpacked wire (spark_examples_tpu/ops/devicegen.py:1082,
//   hv.astype(operand_dtype), whose hv is already rows); the port generates
//   Xᵀ, so its rows are a transpose.
//   Bound: bytes (it reads and writes n_cols × rows bytes). One block of
//   256 threads a tile of 64 sites × 64 columns staged in shared memory, a
//   column 68 bytes apart (17 words: the stores' column reads fall on 32
//   banks). A load takes four sites of one column as one 32-bit word (ld
//   is a multiple of 128 and Xᵀ 4-byte aligned, so a word never leaves its
//   row); a warp's stores write 32 consecutive bytes of one output row.
//   The first version: no vector stores (n_cols is any width, 626 at 2,504
//   samples over 4 positions, so rows are not 4-byte aligned).
//
// Plain C interface, bound with ctypes (ops/_kernels.py). The launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "stacked.cuh"

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

// The tile (blockIdx.x: sites, blockIdx.y: columns) of one block of rows:
// the body of unpack_rows_t_kernel and of each lane of
// stacked_unpack_rows_t_kernel.
template <bool kPacked>
__device__ __forceinline__ void unpack_tile(const uint8_t* __restrict__ in, int rows,
                                            int in_width, int n_cols, int words,
                                            int8_t* __restrict__ xt, int ld) {
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

template <bool kPacked>
__global__ void __launch_bounds__(THREADS)
unpack_rows_t_kernel(const uint8_t* __restrict__ in, int rows, int in_width, int n_cols,
                     int words, int8_t* __restrict__ xt, int ld) {
  unpack_tile<kPacked>(in, rows, in_width, n_cols, words, xt, ld);
}

// Lane k (stack_lane) of the stacked jobs: its bit-packed rows start at
// k·rows·in_width bytes, its Xᵀ at row k·n_pad of the stacked Xᵀ.
__global__ void __launch_bounds__(THREADS)
stacked_unpack_rows_t_kernel(const uint8_t* __restrict__ in, int rows, int in_width, int n_cols,
                             int8_t* __restrict__ xt, int n_pad, int ld,
                             const __grid_constant__ StackLanes lanes) {
  const int64_t k = stack_lane(lanes);
  unpack_tile<true>(in + k * rows * in_width, rows, in_width, n_cols, 0, xt + k * n_pad * ld, ld);
}

constexpr int PACK_SITES = 32;         // sites a block: one 32-byte sector of a column row
constexpr int PACK_WARPS = 8;
constexpr int PACK_MAX_BYTES = 1536;   // bytes of a row a block stages: 48 KiB over its sites
static_assert(PACK_MAX_BYTES % 4 == 0, "a block's share of a row is whole 32-column groups");
// A warp whose groups number at least this keeps PACK_DEEP groups' loads
// in flight; one otherwise (ops/gramian.py:pack_schedule mirrors it).
constexpr int PACK_DEEP_GROUPS = 4;
// The kept design's switches: experiments/ring_variants.py builds this
// source with others (-D) to time the designs it was chosen over.
#ifndef PACK_DEEP
#define PACK_DEEP 2
#endif
#ifndef PACK_L2_HINT
#define PACK_L2_HINT 1  // loads ask L2 for the whole 128-byte line (the next blocks' sites)
#endif

// 16 bytes of a column row, read-only.
__device__ __forceinline__ uint4 load_sites(const int8_t* p) {
  uint4 v;
#if PACK_L2_HINT
  asm volatile("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
#else
  v = __ldg(reinterpret_cast<const uint4*>(p));
#endif
  return v;
}

template <int DEPTH>
__global__ void __launch_bounds__(PACK_WARPS * 32)
pack_rows_t_kernel(const int8_t* __restrict__ xt, int ld, int rows, int n_cols, int out_width,
                   int share, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t packed[];  // [site][share], as in the output
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * PACK_SITES;
  const int sites = min(PACK_SITES, rows - s0);
  const int b0 = blockIdx.y * share;  // the block's first byte of a row
  const int width = min(share, out_width - b0);
  const int groups = (width + 3) / 4;
  const bool words = share % 4 == 0;  // a group's word lands on a 4-byte boundary
  // Group g's 32 sites of this lane's column (zeros past the columns).
  auto load = [&](int group, uint4 (&v)[2]) {
    const int col = 8 * b0 + 32 * group + lane;
    v[0] = v[1] = make_uint4(0, 0, 0, 0);
    if (group < groups && col < n_cols) {
      const int8_t* src = xt + static_cast<int64_t>(col) * ld + s0;
      v[0] = load_sites(src);
      v[1] = load_sites(src + 16);
    }
  };
  uint4 ring[DEPTH][2];
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) load(warp + i * PACK_WARPS, ring[i]);
  for (int base = warp; base < groups; base += DEPTH * PACK_WARPS) {
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int group = base + i * PACK_WARPS;
      if (group >= groups) break;
      const uint32_t v[8] = {ring[i][0].x, ring[i][0].y, ring[i][0].z, ring[i][0].w,
                             ring[i][1].x, ring[i][1].y, ring[i][1].z, ring[i][1].w};
      load(group + DEPTH * PACK_WARPS, ring[i]);
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < PACK_SITES; ++k) {
        const uint32_t vote = __ballot_sync(0xFFFFFFFFu, (v[k / 4] & (0xFFu << (8 * (k % 4)))) != 0);
        if (lane == k) mine = vote;
      }
      // Bit l is column 32·group + l; np.packbits wants byte j to hold
      // columns 8j..8j+7 with the first in bit 7.
      const uint32_t word = __byte_perm(__brev(mine), 0, 0x0123);
      if (lane < sites) {
        uint8_t* dst = packed + lane * share + 4 * group;
        const int bytes = min(4, width - 4 * group);
        if (words && bytes == 4) {
          *reinterpret_cast<uint32_t*>(dst) = word;
        } else {
          for (int q = 0; q < bytes; ++q) dst[q] = static_cast<uint8_t>(word >> (8 * q));
        }
      }
    }
  }
  __syncthreads();
  if (gridDim.y == 1) {
    // share == out_width: sites × out_width contiguous bytes, starting on
    // a 16-byte boundary (PACK_SITES is a multiple of 16).
    const int total = sites * out_width;
    uint8_t* dst = out + static_cast<int64_t>(s0) * out_width;
    for (int off = 16 * threadIdx.x; off < total; off += 16 * PACK_WARPS * 32) {
      if (off + 16 <= total) {
        *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(packed + off);
      } else {
        for (int e = off; e < total; ++e) dst[e] = packed[e];
      }
    }
  } else {
    for (int e = threadIdx.x; e < sites * width; e += PACK_WARPS * 32) {
      const int i = e / width, j = e % width;
      out[static_cast<int64_t>(s0 + i) * out_width + b0 + j] = packed[i * share + j];
    }
  }
}

constexpr int ROWS_T_TILE = 64;      // sites and columns of a transpose tile
constexpr int ROWS_T_PITCH = 68;     // staged bytes a column: 17 words

__global__ void __launch_bounds__(256)
transpose_rows_t_kernel(const int8_t* __restrict__ xt, int ld, int rows, int n_cols,
                        uint8_t* __restrict__ out) {
  __shared__ __align__(4) uint8_t tile[ROWS_T_TILE * ROWS_T_PITCH];  // [column][site]
  const int s0 = blockIdx.x * ROWS_T_TILE, c0 = blockIdx.y * ROWS_T_TILE;
  const int t = threadIdx.x;
  const int quad = t % (ROWS_T_TILE / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = t / (ROWS_T_TILE / 4) + 16 * i;
    uint32_t word = 0;
    if (c0 + c < n_cols) {
      word = *reinterpret_cast<const uint32_t*>(xt + static_cast<int64_t>(c0 + c) * ld + s0 +
                                                4 * quad);
    }
    *reinterpret_cast<uint32_t*>(tile + c * ROWS_T_PITCH + 4 * quad) = word;
  }
  __syncthreads();
  const int c = t % ROWS_T_TILE;
  if (c0 + c >= n_cols) return;
#pragma unroll
  for (int i = 0; i < ROWS_T_TILE / 4; ++i) {
    const int s = t / ROWS_T_TILE + 4 * i;
    if (s0 + s < rows) {
      out[static_cast<int64_t>(s0 + s) * n_cols + c0 + c] = tile[c * ROWS_T_PITCH + s];
    }
  }
}

}  // namespace

extern "C" {

// The site granularity the Python side pads ld to, checked at load.
int gramian_tile_sites() { return TILE_SITES; }

// The most lanes a stacked launch lists (csrc/stacked.cuh), checked at load.
int gramian_stack_list() { return STACK_LIST; }

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

// The stacked jobs' unpack: `in` holds `total` lanes of (rows, in_width)
// bit-packed rows one after another, `xt` the (total·n_pad, ld) stacked Xᵀ;
// only the `count` lanes listed in `lanes` are unpacked (count 0: every
// lane), the other lanes' rows of Xᵀ are left as they are.
int stacked_unpack_rows_t_launch(const uint8_t* in, int total, int rows, int in_width,
                                 int n_cols, int8_t* xt, int n_pad, int ld, const int* lanes,
                                 int count, void* stream) {
  StackLanes list;
  int z = 0;
  if (ld % TILE_SITES != 0 || n_pad % TILE_COLS != 0 || rows > ld || n_cols > n_pad ||
      in_width != (n_cols + 7) / 8 || !stack_lanes(&list, total, lanes, count, &z) ||
      z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (z == 0) return static_cast<int>(cudaSuccess);
  stacked_unpack_rows_t_kernel<<<dim3(ld / TILE_SITES, n_pad / TILE_COLS, z), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(in, rows, in_width, n_cols,
                                                                      xt, n_pad, ld, list);
  return static_cast<int>(cudaGetLastError());
}

// A pack's launch: blocks along sites (grid[0]) and along a row
// (grid[1]), the bytes of a row a block takes (grid[2]), and the groups
// whose loads a warp keeps in flight (grid[4]).
void pack_rows_t_shape(int rows, int out_width, int* grid) {
  grid[2] = out_width <= PACK_MAX_BYTES ? out_width : PACK_MAX_BYTES;
  grid[0] = (rows + PACK_SITES - 1) / PACK_SITES;
  grid[1] = grid[2] > 0 ? (out_width + grid[2] - 1) / grid[2] : 0;
  const int groups = (grid[2] + 3) / 4;
  grid[4] = (groups + PACK_WARPS - 1) / PACK_WARPS >= PACK_DEEP_GROUPS ? PACK_DEEP : 1;
}

// out (rows, n_cols / 8) uint8 = the bit-packed rows of the int8 Xᵀ
// (n_pad, ld) at `xt` (16-byte aligned; n_pad and ld multiples of 128,
// n_cols a multiple of 8 and at most n_pad, rows at most ld; `out`
// 16-byte aligned).
int pack_rows_t_launch(const int8_t* xt, int n_pad, int ld, int n_cols, int rows, uint8_t* out,
                       void* stream) {
  if (ld % TILE_SITES != 0 || n_pad % TILE_COLS != 0 || n_cols % 8 != 0 || n_cols > n_pad ||
      rows > ld || reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n_cols == 0) return static_cast<int>(cudaSuccess);
  int grid[5];
  pack_rows_t_shape(rows, n_cols / 8, grid);
  auto kernel = grid[4] == 1 ? pack_rows_t_kernel<1> : pack_rows_t_kernel<PACK_DEEP>;
  kernel<<<dim3(grid[0], grid[1]), PACK_WARPS * 32, PACK_SITES * grid[2],
           static_cast<cudaStream_t>(stream)>>>(xt, ld, rows, n_cols, n_cols / 8, grid[2], out);
  return static_cast<int>(cudaGetLastError());
}

// pack_rows_t's launch shape for `rows` sites of `n_cols` columns:
// grid[0] blocks along the sites, grid[1] along a row, grid[2] the bytes of
// a row a block takes, grid[3] sites a block, grid[4] groups in flight a
// warp.
int pack_rows_t_grid(int rows, int n_cols, int* grid) {
  pack_rows_t_shape(rows, n_cols / 8, grid);
  grid[3] = PACK_SITES;
  return 0;
}

// out (rows, n_cols) uint8 = rows 0..rows-1 of the transposed first n_cols
// columns of the int8 Xᵀ (n_pad, ld) at `xt` (4-byte aligned; n_pad and
// ld multiples of 128, n_cols at most n_pad, rows at most ld).
int transpose_rows_t_launch(const int8_t* xt, int n_pad, int ld, int n_cols, int rows,
                            uint8_t* out, void* stream) {
  if (ld % TILE_SITES != 0 || n_pad % TILE_COLS != 0 || n_cols > n_pad || rows > ld ||
      reinterpret_cast<uintptr_t>(xt) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n_cols == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rows + ROWS_T_TILE - 1) / ROWS_T_TILE, (n_cols + ROWS_T_TILE - 1) / ROWS_T_TILE);
  transpose_rows_t_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(xt, ld, rows,
                                                                               n_cols, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
