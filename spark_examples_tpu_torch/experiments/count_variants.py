"""Time ``case_counts`` and ``base_counts`` against the designs they were
chosen over.

    python -m spark_examples_tpu_torch.experiments.count_variants

``case_counts`` at the CLI's block (1,024 rows × 2,504 samples, shipped by
``ld.pack_rows`` with its 16-byte pitch) and at 16,384 rows:

- "16-byte vectors" (kept): the package's ``case_counts``
  (``csrc/ld.cu``): the row's and the case mask's vectors loaded
  together, no staging, ``ld.case_counts_lanes`` lanes a row (32 at
  1,024 rows, 8 at 16,384 on 132 SMs);
- "vectors, 32 lanes", "vectors, 16 lanes" and "vectors, 8 lanes": the
  same kernel launched with a fixed number of lanes a row;
- "warp a row": the first port's kernel: every block stages the
  case mask in shared memory behind a barrier, then a warp a row loads
  32-bit words.

``base_counts`` at an example-4 shard (4,210 reads, W = 52,631 + 128),
its codes and mask 128 wide (the kernels phase's shape) and 100 wide (the
synthetic read length, what the example ships):

- "kept zeroed buffer, one launch" (kept): the package's ``base_counts``:
  a warp a read, each lane's code and mask bytes loaded together, int32
  atomics into the buffer the previous launch zeroed, which zeroes the
  next one;
- "torch.zeros + the kernel" and "cudaMemsetAsync + the kernel": the
  same kernel into a window zero-filled by a launch of its own;
- "warp a read": the first port's kernel behind ``torch.zeros``:
  a warp a read, each offset's bytes loaded after the atomics before it;
- "a thread a word": ``torch.zeros``, then a thread a 32-bit word of the
  flat codes and mask (a warp's atomics 64 bytes apart);
- "(a) 16-byte vectors + atomics": ``torch.zeros``, then a thread per
  16 bytes of the flat codes and mask, its bases added with atomics;
- "(c) one launch, grid barrier": a cooperative launch that zeroes the
  window, waits on a grid barrier, then adds each word's bases with
  atomics;
- "(b) tiles, shared-memory atomics": a block a tile of 512 positions
  lists the reads that overlap it (a shared-memory atomic a warp and a
  screened position) and adds their words' bases into a shared-memory
  histogram, then stores the tile (the compiler turns each +1 into a loop
  over a warp's distinct addresses);
- "(b) tiles, a position a thread": a block a tile of 256 positions lists
  its reads (a scan of the threads' hit counts), then each thread counts
  its position against the listed reads in registers and stores it once:
  no zero-fill and no atomics.

A block-private histogram over the span of a block's reads, flushed with
atomics into a zeroed window, is not among them: at depth 8 a window
counter takes about one base, so the flush would add as many atomics as
it saves; the tile designs are that idea turned round, a block owning a
span of the window.

Every design is held exactly against the plain version at each timed
shape, then timed with CUDA events in turns (forward and backward). Prints
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

from spark_examples_tpu_torch.ops import _kernels, depth, ld
from spark_examples_tpu_torch.utils.device import cuda_event_ms

N_SAMPLES = 2504
CASE_ROWS = (1024, 16384)
EX4_READS = 4210
EX4_WINDOW = 52_631 + 128
READ_WIDTHS = (128, 100)
WINDOW_START = 1_000_000
BUILD_DIR = _kernels.BUILD_DIR / "count_variants"

#: The designs not kept, with a launcher each.
SOURCE = r"""
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CASE_BYTES = 48 * 1024;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// ---------------------------- case_counts: warp a row (the first port)

__device__ __forceinline__ uint32_t byte_word(const uint8_t* p, int j, int width) {
  uint32_t w = 0;
  for (int b = 0; b < 4; ++b)
    if (4 * j + b < width) w |= static_cast<uint32_t>(p[4 * j + b]) << (8 * b);
  return w;
}

__global__ void __launch_bounds__(THREADS)
warp_a_row_kernel(const uint8_t* __restrict__ in, int rows, int width, int64_t pitch,
                  const uint8_t* __restrict__ case_mask, int n_cols, int32_t* __restrict__ a,
                  int32_t* __restrict__ t) {
  extern __shared__ uint32_t case_words[];
  const int n_words = (width + 3) / 4;
  const int last = n_words - 1;
  uint32_t last_mask = 0;
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
  const int s = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (s >= rows) return;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(in + s * pitch);
  int carriers_case = 0, carriers = 0;
  for (int j = lane; j < n_words; j += 32) {
    uint32_t w = row[j];
    if (j == last) w &= last_mask;
    carriers_case += __popc(w & case_words[j]);
    carriers += __popc(w);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    carriers_case += __shfl_down_sync(0xFFFFFFFFu, carriers_case, offset);
    carriers += __shfl_down_sync(0xFFFFFFFFu, carriers, offset);
  }
  if (lane == 0) {
    a[s] = carriers_case;
    t[s] = carriers;
  }
}

// --------------------------- base_counts: warp a read (the first port)

__global__ void __launch_bounds__(THREADS)
warp_a_read_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out) {
  const int r = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
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

__device__ __forceinline__ void add_base(int32_t* out, int64_t p, int window_size, int code,
                                         int ok) {
  if (ok && code >= 0 && p >= 0 && p < window_size) atomicAdd(out + 4 * p + min(code, 3), 1);
}

// ------------------------------- base_counts (a): 16-byte vectors + atomics

// A thread takes 16 bytes of the flat (R, L) codes and mask (16-byte
// aligned): two vector loads and the positions of the reads they span.
__global__ void __launch_bounds__(THREADS)
vectors_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
               const uint8_t* __restrict__ quality_ok, int rows, int read_len,
               int64_t window_start, int window_size, int32_t* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(rows) * read_len;
  const int64_t f0 = 16 * (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x);
  if (f0 >= total) return;
  union Bytes {
    uint4 v;
    uint8_t b[16];
  } c, q;
  if (f0 + 16 <= total) {
    c.v = *reinterpret_cast<const uint4*>(codes + f0);
    q.v = *reinterpret_cast<const uint4*>(quality_ok + f0);
  } else {
    for (int j = 0; j < 16; ++j) {
      c.b[j] = f0 + j < total ? codes[f0 + j] : 0xFF;
      q.b[j] = f0 + j < total ? quality_ok[f0 + j] : 0;
    }
  }
  int r = static_cast<int>(f0 / read_len);
  int off = static_cast<int>(f0 % read_len);
  const int r_last = static_cast<int>(min64((f0 + 15) / read_len, rows - 1));
  const int64_t rel_last = static_cast<int64_t>(positions[r_last]) - window_start;
  int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (off == read_len) {
      off = 0;
      ++r;
      rel = r == r_last ? rel_last : static_cast<int64_t>(positions[r]) - window_start;
    }
    if (r < rows) add_base(out, rel + off, window_size, static_cast<int8_t>(c.b[j]), q.b[j]);
    ++off;
  }
}

// ------------------------ base_counts (c): one launch behind a grid barrier

__global__ void __launch_bounds__(THREADS)
barrier_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
               const uint8_t* __restrict__ quality_ok, int rows, int read_len,
               int64_t window_start, int window_size, int32_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(grid.size());
  for (int64_t i = grid.thread_rank(); i < window_size; i += stride)
    reinterpret_cast<int4*>(out)[i] = make_int4(0, 0, 0, 0);
  grid.sync();
  const int per_read = read_len / 4;
  const int64_t items = static_cast<int64_t>(rows) * per_read;
  for (int64_t k = grid.thread_rank(); k < items; k += stride) {
    const int r = static_cast<int>(k / per_read), w = static_cast<int>(k % per_read);
    const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
    const uint32_t cw = reinterpret_cast<const uint32_t*>(codes)[k];
    const uint32_t qw = reinterpret_cast<const uint32_t*>(quality_ok)[k];
    for (int b = 0; b < 4; ++b)
      add_base(out, rel + 4 * w + b, window_size, static_cast<int8_t>(cw >> (8 * b)),
               (qw >> (8 * b)) & 0xFF);
  }
}

// ----------------- base_counts: tiles counted by shared-memory atomics

constexpr int HIST_THREADS = 256;
constexpr int HIST_TILE = 512;
constexpr int HIST_SCREEN = 32;
constexpr int HIST_CHUNK = HIST_THREADS * HIST_SCREEN;
constexpr int HIST_BATCH = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Adds the bases of bytes [unit·w, unit·w + unit) of a read at window
// offset rel into counts[(p - lo)·4 + base] for the positions p in [lo, hi).
template <int kUnit, typename Add>
__device__ __forceinline__ void hist_add_bases(uint32_t code_word, uint32_t ok_word, int64_t rel,
                                          int w, int read_len, int64_t lo, int64_t hi, Add add) {
#pragma unroll
  for (int q = 0; q < kUnit; ++q) {
    const int off = kUnit * w + q;
    const int64_t p = rel + off;
    const int code = static_cast<int8_t>(code_word >> (8 * q));
    if (off < read_len && p >= lo && p < hi && ((ok_word >> (8 * q)) & 0xFF) && code >= 0)
      add(4 * (p - lo) + min(code, 3));
  }
}

template <int kUnit>
__device__ __forceinline__ uint32_t hist_load_unit(const uint8_t* p, int64_t i) {
  if constexpr (kUnit == 4) return reinterpret_cast<const uint32_t*>(p)[i];
  return p[i];
}

template <int kUnit>
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out) {
  __shared__ int hist[4 * HIST_TILE];
  __shared__ int listed[HIST_CHUNK];
  __shared__ int n_listed;
  const int tid = threadIdx.x, lane = tid % 32;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * HIST_TILE;
  const int64_t hi = min64(lo + HIST_TILE, window_size);
  const int per_read = (read_len + kUnit - 1) / kUnit;
  const uint8_t* code_bytes = reinterpret_cast<const uint8_t*>(codes);
  for (int i = tid; i < 4 * HIST_TILE; i += HIST_THREADS) hist[i] = 0;
  for (int first = 0; first < rows; first += HIST_CHUNK) {
    if (tid == 0) n_listed = 0;
    __syncthreads();  // the histogram zeroed, the list empty
    int pos[HIST_SCREEN];
#pragma unroll
    for (int i = 0; i < HIST_SCREEN; ++i) {
      const int r = first + i * HIST_THREADS + tid;
      pos[i] = r < rows ? positions[r] : 0;
    }
#pragma unroll
    for (int i = 0; i < HIST_SCREEN; ++i) {
      const int r = first + i * HIST_THREADS + tid;
      const int64_t rel = static_cast<int64_t>(pos[i]) - window_start;
      const bool hit = r < rows && rel < hi && rel + read_len > lo;
      const unsigned hits = __ballot_sync(FULL, hit);
      if (hits) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&n_listed, __popc(hits));
        base = __shfl_sync(FULL, base, 0);
        if (hit) listed[base + __popc(hits & ((1u << lane) - 1))] = r;
      }
    }
    __syncthreads();
    const int items = n_listed * per_read;
    for (int k0 = 0; k0 < items; k0 += HIST_THREADS * HIST_BATCH) {
      uint32_t code_word[HIST_BATCH], ok_word[HIST_BATCH];
      int64_t rel[HIST_BATCH];
      int word[HIST_BATCH];
#pragma unroll
      for (int b = 0; b < HIST_BATCH; ++b) {
        const int k = k0 + b * HIST_THREADS + tid;
        code_word[b] = ok_word[b] = 0;
        rel[b] = 0;
        word[b] = 0;
        if (k < items) {
          const int r = listed[k / per_read];
          word[b] = k % per_read;
          const int64_t at = static_cast<int64_t>(r) * per_read + word[b];
          rel[b] = static_cast<int64_t>(positions[r]) - window_start;
          code_word[b] = hist_load_unit<kUnit>(code_bytes, at);
          ok_word[b] = hist_load_unit<kUnit>(quality_ok, at);
        }
      }
#pragma unroll
      for (int b = 0; b < HIST_BATCH; ++b)
        hist_add_bases<kUnit>(code_word[b], ok_word[b], rel[b], word[b], read_len, lo, hi,
                         [&](int64_t i) { atomicAdd(hist + i, 1); });
    }
    __syncthreads();  // every add landed; the list and its length read
  }
  int4* tile = reinterpret_cast<int4*>(out) + lo;
  for (int i = tid; i < hi - lo; i += HIST_THREADS)
    tile[i] = make_int4(hist[4 * i], hist[4 * i + 1], hist[4 * i + 2], hist[4 * i + 3]);
}

// ------------------- base_counts: tiles, a position a thread (a gather)

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_TILE = GATHER_THREADS;
constexpr int GATHER_SCREEN = 20;
constexpr int GATHER_CHUNK = GATHER_THREADS * GATHER_SCREEN;
constexpr int GATHER_UNROLL = 8;

__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out) {
  __shared__ int listed_read[GATHER_CHUNK], listed_start[GATHER_CHUNK];
  __shared__ int warp_counts[GATHER_THREADS / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * GATHER_TILE;
  const int64_t hi = min64(lo + GATHER_TILE, window_size);
  const bool mine = lo + tid < hi;  // this thread's position lo + tid is in the window
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int first = 0; first < rows; first += GATHER_CHUNK) {
    // Screen: this thread's reads of the round that overlap [lo, hi).
    int pos[GATHER_SCREEN];
#pragma unroll
    for (int i = 0; i < GATHER_SCREEN; ++i) {
      const int r = first + i * GATHER_THREADS + tid;
      pos[i] = r < rows ? positions[r] : 0;
    }
    unsigned hits = 0;
#pragma unroll
    for (int i = 0; i < GATHER_SCREEN; ++i) {
      const int64_t rel = static_cast<int64_t>(pos[i]) - window_start;
      const bool hit = first + i * GATHER_THREADS + tid < rows && rel < hi && rel + read_len > lo;
      hits |= static_cast<unsigned>(hit) << i;
    }
    // List them: an exclusive scan of the threads' hit counts.
    const int count = __popc(hits);
    int before = count;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(FULL, before, d);
      if (lane >= d) before += up;
    }
    if (lane == 31) warp_counts[warp] = before;
    __syncthreads();
    int listed = 0;
    before -= count;
#pragma unroll
    for (int w = 0; w < GATHER_THREADS / 32; ++w) {
      before += w < warp ? warp_counts[w] : 0;
      listed += warp_counts[w];
    }
#pragma unroll
    for (int i = 0; i < GATHER_SCREEN; ++i) {
      if (hits >> i & 1) {
        listed_read[before] = first + i * GATHER_THREADS + tid;
        // The read's start from the tile's, within (-read_len, GATHER_TILE).
        listed_start[before++] = static_cast<int>(pos[i] - window_start - lo);
      }
    }
    __syncthreads();
    // Count: this thread's position against each listed read, the bytes
    // of GATHER_UNROLL reads loaded together.
    for (int j0 = 0; j0 < listed; j0 += GATHER_UNROLL) {
      int code[GATHER_UNROLL], ok[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const int j = j0 + u;
        const int off = j < listed ? tid - listed_start[j] : -1;
        const bool in_read = mine && off >= 0 && off < read_len;
        const int64_t at = static_cast<int64_t>(in_read ? listed_read[j] : 0) * read_len + off;
        code[u] = in_read ? codes[at] : -1;
        ok[u] = in_read ? quality_ok[at] : 0;
      }
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const int base = ok[u] && code[u] >= 0 ? min(code[u], 3) : -1;
        c0 += base == 0;
        c1 += base == 1;
        c2 += base == 2;
        c3 += base == 3;
      }
    }
    __syncthreads();  // the list read before the next round refills it
  }
  if (mine) reinterpret_cast<int4*>(out)[lo + tid] = make_int4(c0, c1, c2, c3);
}

// -------------------------------------- base_counts: a thread a 32-bit word

// Adds the bases of bytes [unit·w, unit·w + unit) of a read at window
// offset rel into out[4p + base] for the window's positions p.
template <int kUnit>
__device__ __forceinline__ void words_add_bases(uint32_t code_word, uint32_t ok_word, int64_t rel,
                                          int w, int window_size, int32_t* out) {
#pragma unroll
  for (int q = 0; q < kUnit; ++q) {
    const int64_t p = rel + kUnit * w + q;
    const int code = static_cast<int8_t>(code_word >> (8 * q));
    if (p >= 0 && p < window_size && ((ok_word >> (8 * q)) & 0xFF) && code >= 0)
      atomicAdd(out + 4 * p + min(code, 3), 1);
  }
}

template <int kUnit>
__device__ __forceinline__ uint32_t words_load_unit(const uint8_t* p, int64_t i) {
  if constexpr (kUnit == 4) return reinterpret_cast<const uint32_t*>(p)[i];
  return p[i];
}

template <int kUnit>
__global__ void __launch_bounds__(THREADS)
words_kernel(const int32_t* __restrict__ positions, const int8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quality_ok, int rows, int read_len,
                   int64_t window_start, int window_size, int32_t* __restrict__ out,
                   int4* __restrict__ next, int64_t next_vectors) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (k < next_vectors) next[k] = make_int4(0, 0, 0, 0);
  const int per_read = (read_len + kUnit - 1) / kUnit;
  if (k >= static_cast<int64_t>(rows) * per_read) return;
  const int r = static_cast<int>(k / per_read), w = static_cast<int>(k % per_read);
  const int64_t rel = static_cast<int64_t>(positions[r]) - window_start;
  words_add_bases<kUnit>(words_load_unit<kUnit>(reinterpret_cast<const uint8_t*>(codes), k),
                   words_load_unit<kUnit>(quality_ok, k), rel, w, window_size, out);
}

}  // namespace

extern "C" {

int warp_a_row(const uint8_t* in, int rows, int width, int64_t pitch, const uint8_t* case_mask,
               int n_cols, int32_t* a, int32_t* t, void* stream) {
  if (width > MAX_CASE_BYTES || pitch % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  warp_a_row_kernel<<<blocks, THREADS, (width + 3) / 4 * 4, static_cast<cudaStream_t>(stream)>>>(
      in, rows, width, pitch, case_mask, n_cols, a, t);
  return static_cast<int>(cudaGetLastError());
}

// out zeroed by the caller.
int warp_a_read(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok,
                int rows, int read_len, int64_t window_start, int window_size, int32_t* out,
                void* stream) {
  const int blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  warp_a_read_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out);
  return static_cast<int>(cudaGetLastError());
}

// out zeroed by the caller; codes and quality_ok 16-byte aligned.
int vectors(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok, int rows,
            int read_len, int64_t window_start, int window_size, int32_t* out, void* stream) {
  if (read_len < 1 || reinterpret_cast<uintptr_t>(codes) % 16 ||
      reinterpret_cast<uintptr_t>(quality_ok) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t vectors = (static_cast<int64_t>(rows) * read_len + 15) / 16;
  vectors_kernel<<<static_cast<int>((vectors + THREADS - 1) / THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out);
  return static_cast<int>(cudaGetLastError());
}

// out 16-byte aligned, any contents.
int gather(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok, int rows,
           int read_len, int64_t window_start, int window_size, int32_t* out, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<(window_size + GATHER_TILE - 1) / GATHER_TILE, GATHER_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out);
  return static_cast<int>(cudaGetLastError());
}

// out zeroed by the caller; read_len % 4 == 0, word-aligned rows.
int words(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok, int rows,
          int read_len, int64_t window_start, int window_size, int32_t* out, void* stream) {
  if (read_len % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(rows) * (read_len / 4);
  words_kernel<4><<<static_cast<int>((items + THREADS - 1) / THREADS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

int memset_window(int32_t* out, int window_size, void* stream) {
  return static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(window_size) * 16,
                                          static_cast<cudaStream_t>(stream)));
}

// out 16-byte aligned, any contents; read_len % 4 == 0, word-aligned rows.
int histogram(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok, int rows,
              int read_len, int64_t window_start, int window_size, int32_t* out, void* stream) {
  if (read_len % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  histogram_kernel<4><<<(window_size + HIST_TILE - 1) / HIST_TILE, HIST_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      positions, codes, quality_ok, rows, read_len, window_start, window_size, out);
  return static_cast<int>(cudaGetLastError());
}

// out 16-byte aligned, any contents; read_len % 4 == 0, word-aligned rows.
int barrier(const int32_t* positions, const int8_t* codes, const uint8_t* quality_ok, int rows,
            int read_len, int64_t window_start, int window_size, int32_t* out, void* stream) {
  if (read_len % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_kernel, THREADS, 0);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int64_t work = static_cast<int64_t>(rows) * (read_len / 4) + window_size;
  const int blocks = static_cast<int>(min64((work + THREADS - 1) / THREADS,
                                            static_cast<int64_t>(sms) * per_sm));
  void* args[] = {&positions, &codes, &quality_ok, &rows, &read_len, &window_start,
                  &window_size, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_kernel), blocks, THREADS, args, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
"""


def build() -> ctypes.CDLL:
    """The designs' library, built with the package's flags."""
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
    lib.warp_a_row.argtypes = [P, I32, I32, I64, P, I32, P, P, P]
    for fn in (lib.warp_a_read, lib.vectors, lib.barrier, lib.histogram, lib.gather,
               lib.words):
        fn.argtypes = [P, P, P, I32, I32, I64, I32, P, P]
    lib.memset_window.argtypes = [P, I32, P]
    for fn in (lib.warp_a_row, lib.warp_a_read, lib.vectors, lib.barrier, lib.histogram,
               lib.gather, lib.words, lib.memset_window):
        fn.restype = ctypes.c_int
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def case_designs(lib):
    """name → fn(block, case, n) → (a, t)."""

    def lanes(count):
        def run(block, case, n):
            a = torch.empty(block.shape[0], dtype=torch.int32, device=block.device)
            t = torch.empty_like(a)
            _kernels.check(ld._library().case_counts_launch(
                block.data_ptr(), block.shape[0], block.shape[1], block.stride(0), 1,
                case.data_ptr(), n, count, a.data_ptr(), t.data_ptr(), _stream()),
                f"case_counts, {count} lanes")
            return a, t
        return run

    def warp_a_row(block, case, n):
        a = torch.empty(block.shape[0], dtype=torch.int32, device=block.device)
        t = torch.empty_like(a)
        _kernels.check(lib.warp_a_row(
            block.data_ptr(), block.shape[0], block.shape[1], block.stride(0), case.data_ptr(),
            n, a.data_ptr(), t.data_ptr(), _stream()), "warp a row")
        return a, t

    return {
        "16-byte vectors": ld.case_counts,
        "vectors, 32 lanes": lanes(32),
        "vectors, 16 lanes": lanes(16),
        "vectors, 8 lanes": lanes(8),
        "warp a row": warp_a_row,
    }


def kernel_alone(pos, codes, ok, out) -> int:
    """The package's ``base_counts_kernel`` into ``out`` (zeroed), zeroing
    no next buffer; returns the launcher's status."""
    return depth._library().base_counts_launch(
        pos.data_ptr(), codes.data_ptr(), ok.data_ptr(), len(pos), codes.shape[1], WINDOW_START,
        out.shape[0], out.data_ptr(), None, 0, _stream())


def base_designs(lib):
    """name → fn(positions, codes, ok (uint8), window) → (W, 4) counts."""

    def zeroed(name, fn, zero="torch.zeros"):
        def run(pos, codes, ok, window):
            if zero == "torch.zeros":
                out = torch.zeros((window, 4), dtype=torch.int32, device=pos.device)
            else:
                out = torch.empty((window, 4), dtype=torch.int32, device=pos.device)
                _kernels.check(lib.memset_window(out.data_ptr(), window, _stream()), "memset")
            _kernels.check(fn(pos, codes, ok, out), name)
            return out
        return run

    def variant(fn):
        return lambda pos, codes, ok, out: fn(
            pos.data_ptr(), codes.data_ptr(), ok.data_ptr(), len(pos), codes.shape[1],
            WINDOW_START, out.shape[0], out.data_ptr(), _stream())

    def one_launch(name, fn):
        def run(pos, codes, ok, window):
            out = torch.empty((window, 4), dtype=torch.int32, device=pos.device)
            _kernels.check(variant(fn)(pos, codes, ok, out), name)
            return out
        return run

    return {
        "kept zeroed buffer, one launch": lambda pos, codes, ok, window: depth.base_counts(
            pos, codes, ok, WINDOW_START, window),
        "torch.zeros + the kernel": zeroed("the kernel", kernel_alone),
        "cudaMemsetAsync + the kernel": zeroed("the kernel", kernel_alone, "memset"),
        "warp a read": zeroed("warp a read", variant(lib.warp_a_read)),
        "a thread a word": zeroed("a thread a word", variant(lib.words)),
        "(a) 16-byte vectors + atomics": zeroed("16-byte vectors", variant(lib.vectors)),
        "(c) one launch, grid barrier": one_launch("grid barrier", lib.barrier),
        "(b) tiles, shared-memory atomics": one_launch("histogram", lib.histogram),
        "(b) tiles, a position a thread": one_launch("gather", lib.gather),
    }


def case_inputs(rows: int, seed: int = 11):
    """A block of ``rows`` × 2,504 has-variation rows (30 % carriers) as
    ``ld.pack_rows`` ships it, and the packed case mask (odd callsets)."""
    rng = np.random.default_rng(seed + rows)
    values = (rng.random((rows, N_SAMPLES)) < 0.3).astype(np.uint8)
    case = (np.arange(N_SAMPLES) % 2).astype(np.uint8)
    return ld.pack_rows(values, "cuda"), ld.pack_case(case, "cuda")


def base_inputs(width: int, seed: int = 21):
    """An example-4 shard's reads: 4,210 starts from a read before the
    window to past its end, 100-base reads (codes -1 past them) in rows of
    ``width``, the mask at the synthetic qualities' pass share (11 of 21)."""
    rng = np.random.default_rng(seed + width)
    starts = rng.integers(WINDOW_START - 100, WINDOW_START + EX4_WINDOW + 50,
                          EX4_READS).astype(np.int32)
    codes = rng.integers(0, 4, (EX4_READS, width)).astype(np.int8)
    codes[:, 100:] = -1
    ok = (rng.random((EX4_READS, width)) < 11 / 21).astype(np.uint8)
    return tuple(torch.from_numpy(x).to("cuda") for x in (starts, codes, ok))


def _in_turns(fns: dict, iters: int = 50) -> dict:
    """Mean ms of each ``fns`` entry, timed forward then backward."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(cuda_event_ms(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def measure(lib) -> dict:
    """Every design checked ``==`` the plain version at each timed shape,
    then timed in turns: ``{"case_counts": {rows: {design: ms}},
    "base_counts": {width: {design: ms}}, "pieces": {...}}``. The pieces
    are the zero-fills alone (``torch.zeros`` and ``cudaMemsetAsync`` of
    the (W, 4) window) and the first port's and the package's kernels
    alone, into a zeroed window, at width 128."""
    result = {"case_counts": {}, "base_counts": {}}
    for rows in CASE_ROWS:
        block, case = case_inputs(rows)
        want = ld.case_counts_plain(block, case, N_SAMPLES)
        fns = {}
        for name, fn in case_designs(lib).items():
            got = fn(block, case, N_SAMPLES)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"case_counts design {name!r} != plain at {rows} rows")
            fns[name] = (lambda fn: lambda: fn(block, case, N_SAMPLES))(fn)
        result["case_counts"][rows] = _in_turns(fns)
    for width in READ_WIDTHS:
        pos, codes, ok = base_inputs(width)
        want = depth.base_counts_plain(pos, codes, ok, WINDOW_START, EX4_WINDOW)
        fns = {}
        for name, fn in base_designs(lib).items():
            got = fn(pos, codes, ok, EX4_WINDOW)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"base_counts design {name!r} != plain at width {width}")
            fns[name] = (lambda fn: lambda: fn(pos, codes, ok, EX4_WINDOW))(fn)
        result["base_counts"][width] = _in_turns(fns)
    pos, codes, ok = base_inputs(READ_WIDTHS[0])
    out = torch.zeros((EX4_WINDOW, 4), dtype=torch.int32, device="cuda")
    result["pieces"] = _in_turns({
        "zero-fill (torch.zeros)": lambda: torch.zeros(
            (EX4_WINDOW, 4), dtype=torch.int32, device="cuda"),
        "zero-fill (cudaMemsetAsync)": lambda: lib.memset_window(
            out.data_ptr(), EX4_WINDOW, _stream()),
        "warp a read, kernel alone": lambda: lib.warp_a_read(
            pos.data_ptr(), codes.data_ptr(), ok.data_ptr(), EX4_READS, codes.shape[1],
            WINDOW_START, EX4_WINDOW, out.data_ptr(), _stream()),
        "the kernel alone, no next buffer": lambda: kernel_alone(pos, codes, ok, out),
    })
    return result


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    floor = cuda_event_ms(lambda: torch.cuda._sleep(0), 50)
    print(json.dumps({"launch_floor_ms": floor, **measure(build())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
