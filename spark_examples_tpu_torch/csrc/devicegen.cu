// Fused synthetic-genotype generation and Gramian accumulation for Hopper
// (sm_90a): the hot path of variants-pca's device-generation ingest.
//
// Replaces the TPU kernel experiments/pallas_fused_gramian.py:pallas_gram
// (body make_kernel + tile_hv), which computes the same function as the
// main path's XLA program spark_examples_tpu/ops/devicegen.py:_fused_update:
// from two scalars per block of sites (grid offset, valid count) it rebuilds
// the per-site metadata, draws the {0,1} genotype matrix X and accumulates
// G += XᵀX, plus the kept-site and per-set variant-row counters.
//
// Two kernels per block of B sites. X is materialised once per block
// (N_pad × B bytes, within the 50 MB L2 at B = 16384) because generation
// fused into the product's tiles is recomputed per output tile.
//
// gen_genotypes_kernel — 128 sites per thread block. The per-site u64 work
//   (splitmix64 streams: ref-block drop, Q32 allele frequency, the
//   micro-unit --min-allele-frequency rule, per-population thresholds, the
//   per-set genotype state) runs once per site into shared memory. The
//   per-(site, column) work stays in u32 through the fold identity the
//   Pallas kernel used: fold(h2 ^ s·P4) = fold(h2) ^ fold(s·P4), with
//   fold(s·P4) precomputed per column on the host. Column tables are staged
//   through shared memory in chunks, so the column loop never waits on a
//   global load. Each thread draws four consecutive sites of one column and
//   stores them as one 32-bit word of Xᵀ (columns × sites, int8, sites
//   contiguous), so both operands of the product read along K. Counters:
//   warp ballots and one atomic per warp.
//   Bound: its u32 operations, about 14 per genotype at the integer rate of
//   64 per SM per clock, take longer than writing Xᵀ; the u64 site work is
//   O(sites) and amortised over every column.
//
// gram_accumulate_kernel — G[i, j] += Σ_s Xᵀ[i, s]·Xᵀ[j, s] into the
//   resident int32 G. Bound: the int8 tensor-core rate (N·(N+1)·sites
//   operations, the symmetric product). Int8 tensor-core products (mma.sync m16n8k32, s8·s8 → s32,
//   exact) on 128×128 output tiles, 8 warps each owning 64×32; operands
//   double-buffered through padded shared memory (conflict-free fragment
//   loads) by cp.async. G is symmetric, so only tiles on and above the
//   diagonal are computed and an off-diagonal tile is written to both of
//   its places: half the products. wgmma and TMA are the next steps.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). Each launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// splitmix64 constants (sources/synthetic.py).
constexpr uint64_t P1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t M1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t M2 = 0x94D049BB133111EBull;
// Draw-stream tags.
constexpr uint64_t S_REF_BLOCK = 1;
constexpr uint64_t S_AF = 2;
constexpr uint64_t S_POP_BASE = 3;
constexpr uint64_t S_GENOTYPE = 100;
// Fixed-point site-field constants.
constexpr uint64_t AF_BASE_Q32 = 42949673;
constexpr uint64_t AF_SPAN_Q16 = 32113;
constexpr uint64_t POP_BASE_Q16 = 16384;
constexpr uint64_t POP_SPAN_Q17 = 98304;
constexpr uint64_t POP_LO_Q32 = 8589935;
constexpr uint64_t POP_HI_Q32 = 4080218931;

// Tiling; ops/devicegen.py pads Xᵀ to these multiples.
constexpr int GEN_SITES = 128;    // sites per generation block
constexpr int GEN_THREADS = 512;
constexpr int GEN_COL_CHUNK = GEN_THREADS;  // columns staged per chunk
constexpr int MAX_POPS = 16;
constexpr int MAX_SETS = 8;
constexpr int GT = 128;           // Gramian output tile edge
constexpr int GK = 64;            // sites (bytes) per shared-memory stage
constexpr int G_STRIDE = GK + 16; // padded row: 20 words, conflict-free
constexpr int GRAM_THREADS = 256;

struct GenParams {
  int64_t grid_offset;
  int64_t n_valid;
  int64_t spacing;
  uint64_t site_key;
  uint64_t ref_thresh;
  uint64_t min_af_micro;
  int has_min_af;
  int n_pops;
  int n_sets;
  int n_cols;
  int n_cols_pad;
  int ld;  // sites per Xᵀ row (the padded block size)
};

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x += P1;
  x = (x ^ (x >> 30)) * M1;
  x = (x ^ (x >> 27)) * M2;
  return x ^ (x >> 31);
}

// sources/synthetic.py:_u64 with sample = allele = 0 (their terms still mix).
__device__ __forceinline__ uint64_t u64_stream(uint64_t key, uint64_t pos_term,
                                               uint64_t stream) {
  uint64_t h = mix64(key ^ pos_term);
  h = mix64(h ^ (stream * P3));
  h = mix64(h);
  return mix64(h);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// One genotype: the two allele draws against the Q32 threshold.
__device__ __forceinline__ uint32_t has_variation(uint32_t x32, uint32_t t) {
  const uint32_t d1 = fmix32(x32);
  const uint32_t d2 = (d1 * 0x9E3779B9u) ^ 0x85EBCA6Bu;
  return static_cast<uint32_t>(d1 < t) | static_cast<uint32_t>(d2 < t);
}

__global__ void __launch_bounds__(GEN_THREADS)
gen_genotypes_kernel(GenParams p, const uint64_t* __restrict__ vs_keys,
                     const uint32_t* __restrict__ col_fsamp,
                     const int32_t* __restrict__ col_set,
                     const int32_t* __restrict__ col_pop,
                     int8_t* __restrict__ xt,
                     unsigned long long* __restrict__ kept,
                     unsigned long long* __restrict__ rows) {
  __shared__ __align__(16) uint32_t s_thr[MAX_POPS][GEN_SITES];
  __shared__ __align__(16) uint32_t s_fsite[MAX_SETS][GEN_SITES];
  __shared__ uint32_t s_any[GEN_SITES];
  __shared__ uint32_t s_kept[GEN_SITES];
  __shared__ uint32_t s_cfs[GEN_COL_CHUNK];  // fold(s·P4) of the chunk's columns
  __shared__ int32_t s_cset[GEN_COL_CHUNK];
  __shared__ int32_t s_cpop[GEN_COL_CHUNK];

  const int tid = threadIdx.x;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * GEN_SITES;
  const int local = tid % GEN_SITES;
  const int64_t site = tile0 + local;
  const uint64_t pos_term =
      static_cast<uint64_t>((p.grid_offset + site) * p.spacing) * P2;

  // Per-site metadata: threads 0..127 the thresholds, 128..255 the
  // per-set genotype state, one site each.
  if (tid < GEN_SITES) {
    const bool valid = site < p.n_valid;
    const bool is_ref =
        (u64_stream(p.site_key, pos_term, S_REF_BLOCK) >> 11) < p.ref_thresh;
    const uint64_t u_af = u64_stream(p.site_key, pos_term, S_AF) >> 48;
    const uint64_t af_q32 = AF_BASE_Q32 + ((u_af * u_af * AF_SPAN_Q16) >> 16);
    bool keep = valid && !is_ref;
    if (p.has_min_af) {
      // round-half-even(af_q32 · 1e6 / 2^32) > floor(threshold · 1e6).
      const uint64_t x = af_q32 * 1000000ull;
      const uint64_t q = x >> 32;
      const uint64_t frac = x & 0xFFFFFFFFull;
      const uint64_t half = 1ull << 31;
      const uint64_t r = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
      keep = keep && r > p.min_af_micro;
    }
    uint32_t any_thr = 0;
    for (int pop = 0; pop < p.n_pops; ++pop) {
      const uint64_t u_p = u64_stream(p.site_key, pos_term, S_POP_BASE + pop) >> 48;
      const uint64_t factor = POP_BASE_Q16 + ((u_p * POP_SPAN_Q17) >> 16);
      uint64_t af_pop = (af_q32 * factor) >> 16;
      af_pop = af_pop < POP_LO_Q32 ? POP_LO_Q32 : af_pop;
      af_pop = af_pop > POP_HI_Q32 ? POP_HI_Q32 : af_pop;
      const uint32_t t = keep ? static_cast<uint32_t>(af_pop) : 0u;
      s_thr[pop][local] = t;
      any_thr |= t;
    }
    s_kept[local] = any_thr != 0u;
    s_any[local] = 0u;
  } else if (tid < 2 * GEN_SITES) {
    for (int s = 0; s < p.n_sets; ++s) {
      const uint64_t h2 = mix64(mix64(vs_keys[s] ^ pos_term) ^ (S_GENOTYPE * P3));
      s_fsite[s][local] = static_cast<uint32_t>(h2 >> 32) ^ static_cast<uint32_t>(h2);
    }
  }

  // Genotypes: warp w draws the chunk's columns w, w+16, ...; lane l sites
  // 4l..4l+3.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sl = lane * 4;
  uint32_t any0 = 0, any1 = 0, any2 = 0, any3 = 0;
  for (int c0 = 0; c0 < p.n_cols_pad; c0 += GEN_COL_CHUNK) {
    __syncthreads();  // the metadata is written / the last chunk is drawn
    const int mine = c0 + tid;
    s_cfs[tid] = mine < p.n_cols ? col_fsamp[mine] : 0u;
    s_cset[tid] = mine < p.n_cols ? col_set[mine] : -1;
    s_cpop[tid] = mine < p.n_cols ? col_pop[mine] : 0;
    __syncthreads();
    const int chunk = min(GEN_COL_CHUNK, p.n_cols_pad - c0);
    for (int j = warp; j < chunk; j += GEN_THREADS / 32) {
      const int set = s_cset[j];
      uint32_t packed = 0;
      if (set >= 0) {
        const uint32_t fs = s_cfs[j];
        const uint4 t = *reinterpret_cast<const uint4*>(&s_thr[s_cpop[j]][sl]);
        const uint4 f = *reinterpret_cast<const uint4*>(&s_fsite[set][sl]);
        const uint32_t h0 = has_variation(f.x ^ fs, t.x);
        const uint32_t h1 = has_variation(f.y ^ fs, t.y);
        const uint32_t h2 = has_variation(f.z ^ fs, t.z);
        const uint32_t h3 = has_variation(f.w ^ fs, t.w);
        packed = h0 | (h1 << 8) | (h2 << 16) | (h3 << 24);
        any0 |= h0 << set;
        any1 |= h1 << set;
        any2 |= h2 << set;
        any3 |= h3 << set;
      }
      *reinterpret_cast<uint32_t*>(xt + static_cast<int64_t>(c0 + j) * p.ld + tile0 + sl) =
          packed;
    }
  }
  if (any0) atomicOr(&s_any[sl], any0);
  if (any1) atomicOr(&s_any[sl + 1], any1);
  if (any2) atomicOr(&s_any[sl + 2], any2);
  if (any3) atomicOr(&s_any[sl + 3], any3);
  __syncthreads();

  // Counters: warps 0..3 hold one site per lane.
  if (tid < GEN_SITES) {
    const unsigned kept_mask = __ballot_sync(0xFFFFFFFFu, s_kept[tid] != 0u);
    if (lane == 0 && kept_mask) atomicAdd(kept, static_cast<unsigned long long>(__popc(kept_mask)));
    const uint32_t any = s_any[tid];
    for (int s = 0; s < p.n_sets; ++s) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, (any >> s) & 1u);
      if (lane == 0 && m) atomicAdd(rows + s, static_cast<unsigned long long>(__popc(m)));
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: rows [r0, r0+128) of Xᵀ, sites [k0, k0+GK), 16 bytes a copy.
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* __restrict__ xt,
                                           int r0, int64_t ldx, int k0, int tid) {
  for (int l = tid; l < GT * (GK / 16); l += GRAM_THREADS) {
    const int r = l / (GK / 16);
    const int c = (l % (GK / 16)) * 16;
    cp_async16(dst + r * G_STRIDE + c, xt + static_cast<int64_t>(r0 + r) * ldx + k0 + c);
  }
}

__global__ void __launch_bounds__(GRAM_THREADS)
gram_accumulate_kernel(int32_t* __restrict__ g, int n,
                       const int8_t* __restrict__ xt, int ldx, int n_tiles) {
  __shared__ __align__(16) int8_t As[2][GT * G_STRIDE];
  __shared__ __align__(16) int8_t Bs[2][GT * G_STRIDE];

  // Upper-triangular tile (bi ≤ bj) of this block.
  int bi = 0, idx = blockIdx.x;
  while (idx >= n_tiles - bi) {
    idx -= n_tiles - bi;
    ++bi;
  }
  const int bj = bi + idx;
  const int i0 = bi * GT, j0 = bj * GT;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64;  // warp rows within the tile
  const int wn = (warp & 3) * 32;   // warp columns within the tile

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  const int n_k = ldx / GK;
  load_stage(As[0], xt, i0, ldx, 0, tid);
  load_stage(Bs[0], xt, j0, ldx, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {
      load_stage(As[cur ^ 1], xt, i0, ldx, (kt + 1) * GK, tid);
      load_stage(Bs[cur ^ 1], xt, j0, ldx, (kt + 1) * GK, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const uint32_t* a_w = reinterpret_cast<const uint32_t*>(As[cur]);
    const uint32_t* b_w = reinterpret_cast<const uint32_t*>(Bs[cur]);
    constexpr int W = G_STRIDE / 4;  // words per padded row
#pragma unroll
    for (int ks = 0; ks < GK / 32; ++ks) {
      const int kw = ks * 8 + tig;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + grp;
        a[mi][0] = a_w[r * W + kw];
        a[mi][1] = a_w[(r + 8) * W + kw];
        a[mi][2] = a_w[r * W + kw + 4];
        a[mi][3] = a_w[(r + 8) * W + kw + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + grp;
        b[ni][0] = b_w[c * W + kw];
        b[ni][1] = b_w[c * W + kw + 4];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // C fragment: c0/c1 at row grp, columns 2·tig + {0, 1}; c2/c3 at row grp+8.
  const bool mirror = bi != bj;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wm + mi * 16 + grp + (q >> 1) * 8;
        const int j = j0 + wn + ni * 8 + tig * 2 + (q & 1);
        if (i < n && j < n) {
          g[static_cast<int64_t>(i) * n + j] += acc[mi][ni][q];
          if (mirror) g[static_cast<int64_t>(j) * n + i] += acc[mi][ni][q];
        }
      }
}

}  // namespace

extern "C" {

// The tile constants the Python side pads to, checked at load.
int devicegen_site_tile() { return GEN_SITES; }
int devicegen_col_tile() { return GT; }
int devicegen_max_pops() { return MAX_POPS; }
int devicegen_max_sets() { return MAX_SETS; }

int gen_genotypes_launch(int8_t* xt, int64_t* kept, int64_t* rows,
                         const uint64_t* vs_keys, const uint32_t* col_fsamp,
                         const int32_t* col_set, const int32_t* col_pop,
                         int64_t grid_offset, int64_t n_valid, int64_t spacing,
                         uint64_t site_key, uint64_t ref_thresh, int has_min_af,
                         uint64_t min_af_micro, int n_pops, int n_sets, int n_cols,
                         int n_cols_pad, int ld, void* stream) {
  GenParams p;
  p.grid_offset = grid_offset;
  p.n_valid = n_valid;
  p.spacing = spacing;
  p.site_key = site_key;
  p.ref_thresh = ref_thresh;
  p.min_af_micro = min_af_micro;
  p.has_min_af = has_min_af;
  p.n_pops = n_pops;
  p.n_sets = n_sets;
  p.n_cols = n_cols;
  p.n_cols_pad = n_cols_pad;
  p.ld = ld;
  gen_genotypes_kernel<<<ld / GEN_SITES, GEN_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, vs_keys, col_fsamp, col_set, col_pop, xt,
      reinterpret_cast<unsigned long long*>(kept),
      reinterpret_cast<unsigned long long*>(rows));
  return static_cast<int>(cudaGetLastError());
}

int gram_accumulate_launch(int32_t* g, int n, const int8_t* xt, int n_pad,
                           int ldx, void* stream) {
  const int n_tiles = n_pad / GT;
  gram_accumulate_kernel<<<n_tiles * (n_tiles + 1) / 2, GRAM_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(g, n, xt, ldx, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
