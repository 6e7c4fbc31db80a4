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
// (N_pad × B bytes, within the 50 MB L2 at B = 16384). Generation fused into
// the product's producer was rejected: each of the product's 110 units
// (128 × 256 of G at 2,504 samples) would regenerate its 384 rows of X,
// about 17 times the generation work.
//
// gen_genotypes_kernel — Xᵀ (columns × sites, int8, sites contiguous, so
//   both operands of the product read along K) and the counters.
//   Bound: its u32 operations, 12 per genotype of a kept site (fmix32's
//   first shift-xor distributes over the fold's xor, so it is applied once
//   per site and once per column), take longer than writing Xᵀ.
//   Grid: a thread block cluster of S blocks per tile of 64 sites; block r
//   draws the tile's 64-column chunks r, r + S, ... S divides the chunks
//   (every block draws as many) and is the least divisor that gives every
//   SM two blocks, or the largest up to 16 (a non-portable cluster size):
//   at 2,504 samples 160 blocks (S = 10) at the CLI's 1,024 sites and 512
//   (S = 2) at 16,384. One block per 128 sites over every column left 8
//   blocks for 132 SMs at 1,024 sites. 256 threads, at most 64 registers,
//   so 4 or more blocks are resident an SM.
//   Site metadata (the splitmix64 streams: ref-block drop, Q32 allele
//   frequency, the micro-unit --min-allele-frequency rule, per-population
//   thresholds, per-set genotype state) is computed in every block of the
//   cluster, one (site, population) or (site, set) pair a thread, so no
//   thread waits on another. Sharing it through distributed shared memory
//   (each block computing 64/S sites, a cluster barrier, then a gather;
//   experiments/gen_variants.py) measured 1 % faster at 16,384 sites and
//   3 % slower at the CLI's 1,024, the block size of most launches: there
//   the barrier and the gather cost more than the recomputation, which is
//   O(sites) against the O(sites × columns) draws.
//   Draws: the fold identity of the Pallas kernel keeps them in u32,
//   fold(h2 ^ s·P4) = fold(h2) ^ fold(s·P4), with fold(s·P4) precomputed
//   per column on the host. A thread draws 4 sites × 4 columns of a chunk
//   as 16 independent chains, all shared-memory loads issued first; a
//   thread whose four sites are dropped stores zeros without drawing. The
//   next chunk's column table loads while this one is drawn. Each chunk is
//   staged in shared memory (two buffers, one barrier a chunk) and leaves
//   as 16-byte stores, a thread's 16 sites of one Xᵀ row; a TMA tensor
//   store of the staged chunk measured 1–2 % slower (gen_variants.py).
//   Counters: a site counts in rows[s] if any column of set s in any block
//   drew a variant, so the blocks OR their per-site set bits into the
//   leader block's (atomicOr through the cluster) before the leader counts
//   them; it also counts kept sites. A split cluster barrier (arrive at the
//   start, wait before the ORs) orders the leader's zeroing before them at
//   no cost, and a last cluster barrier keeps the leader alive until its
//   peers are done. No mbarrier is used, so hopper.cuh's no-cluster
//   assumption holds.
//   Any number of sets, populations and sites: the stream keys are read
//   from device memory, and a block's tables ((populations + 1 + sets)
//   rows of 64 words, and the set-bit rows) are sized at launch (GenPath).
//   The set flags meet in bit rows of 32 sets a site word, and the
//   leader's warps count a word each, one ballot a set. Up to 8 sets a
//   thread gathers its sites' flags in a register, a byte a site and a bit
//   a set (the one-set main path); past 8 a thread's columns come in set
//   order, so it ORs its sites' flags into the rows when its set changes.
//   That general path, run at one set, measured 8 % slower at 16,384 sites
//   and 4 % at 1,024 on an H100 SXM (gen_variants.py), so the register
//   path stays. A cluster of blocks too large to share an SM holds fewer
//   blocks where the card cannot place it.
//   Tables that do not fit shared memory (1,000 sets) live in a device
//   buffer the wrapper allocates, a block's own slice, and the grid then
//   holds no more clusters than the card runs at once, each walking tiles.
//   Tiles lie along gridDim.x (2^31 − 1 blocks), so a block may hold any
//   site count an int32 ld takes.
//
// gram_accumulate_kernel — G[i, j] += Σ_s Xᵀ[i, s]·Xᵀ[j, s] into the
//   resident int32 G: the product half of pallas_gram
//   (experiments/pallas_fused_gramian.py:151). G is symmetric, so only the
//   128×128 tiles on and above the diagonal are computed (half the
//   products) and an off-diagonal tile is added to both of its places.
//   Bound: the int8 tensor-core rate (N·(N+1)·sites operations) at 16,384
//   sites; at the CLI's 1,024 sites the read-modify-write of the int32 G
//   (8·N² bytes) takes longer than the products.
//   Design: Hopper's warpgroup MMA (wgmma m64n256k32 s8·s8 → s32, exact),
//   its operands fed by TMA. A block computes 128 rows × 256 columns of G
//   (two tiles of one tile row): 128×128 tiles read their operands from L2
//   at about 8 TB/s on this card and starved the tensor cores, and the
//   wider unit reads a quarter less per product. One 2-D tensor map over
//   Xᵀ (128 sites × 128 rows a box, 128-byte swizzle) loads A's box and
//   B's two into a ring of G_STAGES stages with full/empty mbarriers; where
//   A's rows are one of B's boxes (the diagonal) A is not loaded and its
//   descriptors point into B. One producer thread keeps the loads in
//   flight; two consumer warpgroups own 64 rows each (128 int32
//   accumulators a thread, no spills). One block per unit walks every
//   site: at 2,504 samples the 110 units fill 110 of 132 SMs, and splitting
//   the sites measured slower at both depths, as each split adds a whole
//   epilogue into G. The epilogue stages
//   the block's output in shared memory (reusing the ring) and adds it to
//   G with red.global.add, a warp on 32 neighbouring int32 of a row of G,
//   for each tile and for the transpose of each tile above the diagonal;
//   the L2 does the adds, so no load waits in the SM.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). Each launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch;
// gram_accumulate_launch returns minus the CUresult when the CUDA driver
// refuses to encode its tensor map.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// Tiling; ops/devicegen.py pads Xᵀ to multiples of GT (rows and sites).
constexpr int GEN_SITES = 64;     // sites per generation tile (one cluster)
constexpr int GEN_MAX_CLUSTER = 16;  // blocks per tile: 16 needs the non-portable size
constexpr int GEN_THREADS = 256;
constexpr int GEN_FEW_SETS = 8;   // sets whose flags fit a byte: the register path
constexpr int GEN_COLS = 64;      // columns per chunk: one staged piece of Xᵀ
constexpr int GEN_QUADS = GEN_SITES / 4;               // a thread's 4 sites ...
constexpr int GEN_GROUPS = GEN_THREADS / GEN_QUADS;    // ... and column group
constexpr int GEN_COLS_PER_THREAD = GEN_COLS / GEN_GROUPS;
// The most device memory one launch's tables may take where they do not
// fit shared memory (the grid shrinks to fit, its clusters walking tiles).
constexpr int64_t GEN_TABLE_BYTES = 256ll << 20;
constexpr int GT = 128;           // Gramian tile edge: rows of Xᵀ in one TMA box
constexpr int GK = 128;           // sites per stage: one 128-byte swizzle row
constexpr int G_BOX_BYTES = GT * GK;                 // 16 KiB
constexpr int G_BOXES = 2;                           // tiles (B boxes) in a block's row
constexpr int G_BN = G_BOXES * GT;                   // a block's output: 128 × 256 of G
constexpr int G_STAGES = 4;
constexpr int G_STAGE_BYTES = (1 + G_BOXES) * G_BOX_BYTES;  // the A box, then B's
constexpr int G_CONSUMERS = 256;                     // two warpgroups
constexpr int GRAM_THREADS = G_CONSUMERS + 32;       // and one producer warp
constexpr int G_STRIDE = G_BN + 1;  // staged int32 row: odd, so columns read conflict-free
// Ring (1024-byte aligned for the swizzle, hence the slack), then the
// full and empty barriers.
constexpr int G_SMEM_BYTES = 1024 + G_STAGES * G_STAGE_BYTES + 2 * G_STAGES * 8;
static_assert(GT * G_STRIDE * 4 <= G_STAGES * G_STAGE_BYTES, "the staged tile reuses the ring");
constexpr int G_MAX_DEVICES = 64;  // devices whose kernel attributes are cached

// Where a launch keeps each block's tables (GEN_SITES words a row: n_pops
// threshold rows and a zero row for padding columns, n_sets rows of
// xorshift16(fold(h2)), set_words rows of per-site set bits).
enum GenPath {
  GEN_FEW = 0,     // shared memory; at most GEN_FEW_SETS sets, flags gathered in registers
  GEN_MANY = 1,    // shared memory; any sets, flags ORed into the bit rows on a set change
  GEN_GLOBAL = 2,  // as GEN_MANY, the tables in a device buffer (a slice per block)
};

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
  int ld;           // sites per Xᵀ row (the padded block size)
  int set_words;    // rows of per-site set bits: 32 sets a row
  int table_words;  // a block's tables
};

int gen_table_words(int n_pops, int n_sets) {
  return GEN_SITES * (n_pops + 1 + n_sets + (n_sets + 31) / 32);
}

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

// fmix32's first step, x ^ (x >> 16). It distributes over the fold's xor,
// so the kernel applies it once per site and once per column.
__device__ __forceinline__ uint32_t xorshift16(uint32_t x) { return x ^ (x >> 16); }

// One genotype from x = xorshift16(fold(h2) ^ fold(s·P4)): the rest of
// fmix32 gives the first allele draw, a multiply and xor the second; either
// below the Q32 threshold is a variant.
__device__ __forceinline__ bool has_variation(uint32_t x, uint32_t t) {
  x *= 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  const uint32_t d1 = xorshift16(x);
  const uint32_t d2 = (d1 * 0x9E3779B9u) ^ 0x85EBCA6Bu;
  return min(d1, d2) < t;
}

// The Xᵀ word of one column at four sites: their xorshift16(fold(h2)) `f`
// and thresholds `t`, the column's xorshift16(fold(s·P4)) `s`.
__device__ __forceinline__ uint32_t draw4(uint4 f, uint32_t s, uint4 t) {
  return (has_variation(f.x ^ s, t.x) ? 0x1u : 0u) | (has_variation(f.y ^ s, t.y) ? 0x100u : 0u) |
         (has_variation(f.z ^ s, t.z) ? 0x10000u : 0u) |
         (has_variation(f.w ^ s, t.w) ? 0x1000000u : 0u);
}

// Bit `set` of the set-bit rows at the sites sl + i whose byte i of `any`
// is set.
__device__ __forceinline__ void or_set_bits(uint32_t* bits, int sl, int set, uint32_t any) {
  if (any == 0u) return;
  uint32_t* word = bits + (set / 32) * GEN_SITES + sl;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if ((any >> (8 * i)) & 0xFFu) atomicOr(word + i, 1u << (set % 32));
}

// Split cluster barrier: arrive now, wait later (release / acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One cluster of S blocks (S chosen at launch) per tile of GEN_SITES
// sites, clusters side by side along gridDim.x; where there are fewer
// clusters than tiles (GEN_GLOBAL) each walks tiles. Block `rank` of a
// cluster draws the chunks rank, rank + S, ... of GEN_COLS columns.
template <GenPath PATH>
__global__ void __launch_bounds__(GEN_THREADS, 4)
gen_genotypes_kernel(GenParams p, const uint64_t* __restrict__ vs_keys,
                     const uint32_t* __restrict__ col_fsamp, const int32_t* __restrict__ col_set,
                     const int32_t* __restrict__ col_pop, int8_t* __restrict__ xt,
                     unsigned long long* __restrict__ kept, unsigned long long* __restrict__ rows,
                     uint32_t* __restrict__ tables) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  constexpr bool FEW = PATH == GEN_FEW;
  extern __shared__ __align__(16) uint32_t gen_smem[];
  // The tile's tables (GenPath), and the kept flags.
  uint32_t* const s_tab =
      PATH == GEN_GLOBAL ? tables + static_cast<int64_t>(blockIdx.x) * p.table_words : gen_smem;
  uint32_t* const s_bits = s_tab + (p.n_pops + 1 + p.n_sets) * GEN_SITES;  // [set word][site]
  // This block's set bits, then the cluster's in the leader's.
  uint32_t* const leader_bits = PATH == GEN_GLOBAL
                                    ? s_bits - static_cast<int64_t>(rank) * p.table_words
                                    : cluster.map_shared_rank(s_bits, 0);
  __shared__ uint32_t s_kept[GEN_SITES];
  __shared__ __align__(16) uint32_t s_out[2][GEN_COLS * GEN_QUADS];  // [column][site quad]
  // A chunk's columns: threshold row and xorshift16(fold(h2)) row (word
  // offsets into the tables), set, and xorshift16(fold(s·P4)).
  __shared__ uint4 s_col[2][GEN_COLS];

  const int tid = threadIdx.x;
  const int chunks = p.n_cols_pad / GEN_COLS;
  const uint32_t zero_row = p.n_pops * GEN_SITES;
  const uint32_t fsite_rows = (p.n_pops + 1) * GEN_SITES;
  // Column c as the draws read it (s_col); padding columns read the zero
  // threshold row.
  auto column = [&](int c) {
    if (c >= p.n_cols) return make_uint4(zero_row, fsite_rows, 0u, 0u);
    const uint32_t set = __ldg(col_set + c);
    return make_uint4(__ldg(col_pop + c) * GEN_SITES, fsite_rows + set * GEN_SITES, set,
                      xorshift16(__ldg(col_fsamp + c)));
  };
  const int q = tid % GEN_QUADS;
  const int g = tid / GEN_QUADS;
  const int sl = 4 * q;
  const int64_t first = blockIdx.x / blocks;
  for (int64_t tile = first; tile < p.ld / GEN_SITES; tile += gridDim.x / blocks) {
    const int64_t tile0 = tile * GEN_SITES;
    if (tile != first) __syncthreads();  // the last tile's counters have read the tables
    // The first chunk's columns load while the metadata is computed.
    uint4 next = make_uint4(zero_row, fsite_rows, 0u, 0u);
    if (tid < GEN_COLS && rank < chunks) next = column(rank * GEN_COLS + tid);
    for (int i = tid; i < p.set_words * GEN_SITES; i += GEN_THREADS) s_bits[i] = 0u;
    if (tid < GEN_SITES) s_tab[zero_row + tid] = 0u;
    // The leader's set bits must be zero before a peer ORs into them:
    // arrive now, wait just before the ORs.
    cluster_arrive();

    // Site metadata, one (site, population) or (site, set) pair a thread. A
    // population's threshold needs three independent streams (ref-block
    // flag, AF, the population's factor), so no thread waits for another.
    for (int i = tid; i < GEN_SITES * (p.n_pops + p.n_sets); i += GEN_THREADS) {
      const int site = i % GEN_SITES, item = i / GEN_SITES;
      const uint64_t pos_term =
          static_cast<uint64_t>((p.grid_offset + tile0 + site) * p.spacing) * P2;
      if (item < p.n_pops) {
        const bool is_ref = (u64_stream(p.site_key, pos_term, S_REF_BLOCK) >> 11) < p.ref_thresh;
        const uint64_t u_af = u64_stream(p.site_key, pos_term, S_AF) >> 48;
        const uint64_t u_p = u64_stream(p.site_key, pos_term, S_POP_BASE + item) >> 48;
        const uint64_t af_q32 = AF_BASE_Q32 + ((u_af * u_af * AF_SPAN_Q16) >> 16);
        bool keep = tile0 + site < p.n_valid && !is_ref;
        if (p.has_min_af) {
          // round-half-even(af_q32 · 1e6 / 2^32) > floor(threshold · 1e6).
          const uint64_t x = af_q32 * 1000000ull;
          const uint64_t q = x >> 32;
          const uint64_t frac = x & 0xFFFFFFFFull;
          const uint64_t half = 1ull << 31;
          const uint64_t r = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
          keep = keep && r > p.min_af_micro;
        }
        const uint64_t factor = POP_BASE_Q16 + ((u_p * POP_SPAN_Q17) >> 16);
        uint64_t af_pop = (af_q32 * factor) >> 16;
        af_pop = af_pop < POP_LO_Q32 ? POP_LO_Q32 : af_pop;
        af_pop = af_pop > POP_HI_Q32 ? POP_HI_Q32 : af_pop;
        s_tab[item * GEN_SITES + site] = keep ? static_cast<uint32_t>(af_pop) : 0u;
        // A kept site's thresholds are all at least POP_LO_Q32, so it is kept
        // exactly when it is not dropped.
        if (item == 0) s_kept[site] = keep;
      } else {
        const uint64_t h2 =
            mix64(mix64(__ldg(reinterpret_cast<const unsigned long long*>(vs_keys) + item -
                              p.n_pops) ^
                        pos_term) ^
                  (S_GENOTYPE * P3));
        s_tab[fsite_rows + (item - p.n_pops) * GEN_SITES + site] =
            xorshift16(static_cast<uint32_t>(h2 >> 32) ^ static_cast<uint32_t>(h2));
      }
    }
    if (tid < GEN_COLS) s_col[0][tid] = next;
    __syncthreads();

    // Draws: thread (quad q, group g) takes sites 4q..4q+3 of the chunk's
    // columns g, g + 16, g + 32, g + 48 (a warp's 32 words land in 32 banks).
    // A thread whose four sites are all dropped stores zeros without drawing.
    // Each chunk is staged in one of two buffers and leaves as 16-byte
    // stores, a thread's 16 sites of one Xᵀ row, after one barrier.
    const bool live = (s_kept[sl] | s_kept[sl + 1] | s_kept[sl + 2] | s_kept[sl + 3]) != 0u;
    // GEN_FEW: byte i holds the sets in which site sl + i drew a variant.
    // Otherwise byte i is set where it did in set `set`; a thread's columns
    // come in set order, so it ORs them into the bit rows when its set
    // changes.
    uint32_t any = 0;
    int set = 0;
    int buf = 0;
    for (int chunk = rank; chunk < chunks; chunk += blocks, buf ^= 1) {
      // The next chunk's columns load while this one is drawn.
      if (tid < GEN_COLS && chunk + blocks < chunks) next = column((chunk + blocks) * GEN_COLS + tid);
      // All loads first, then the 16 draws as independent chains.
      uint32_t packed[GEN_COLS_PER_THREAD] = {};
      if (live) {
        uint4 col[GEN_COLS_PER_THREAD], t[GEN_COLS_PER_THREAD], f[GEN_COLS_PER_THREAD];
#pragma unroll
        for (int k = 0; k < GEN_COLS_PER_THREAD; ++k) col[k] = s_col[buf][g + GEN_GROUPS * k];
#pragma unroll
        for (int k = 0; k < GEN_COLS_PER_THREAD; ++k) {
          t[k] = *reinterpret_cast<const uint4*>(s_tab + col[k].x + sl);
          f[k] = *reinterpret_cast<const uint4*>(s_tab + col[k].y + sl);
        }
#pragma unroll
        for (int k = 0; k < GEN_COLS_PER_THREAD; ++k) {
          packed[k] = draw4(f[k], col[k].w, t[k]);
          if constexpr (FEW) {
            any |= packed[k] << col[k].z;  // bytes are 0 or 1, so each stays inside its byte
          } else {
            if (static_cast<int>(col[k].z) != set) {
              or_set_bits(s_bits, sl, set, any);
              set = static_cast<int>(col[k].z);
              any = 0;
            }
            any |= packed[k];
          }
        }
      }
      uint32_t* out = s_out[buf];
#pragma unroll
      for (int k = 0; k < GEN_COLS_PER_THREAD; ++k) out[(g + GEN_GROUPS * k) * GEN_QUADS + q] = packed[k];
      if (tid < GEN_COLS) s_col[buf ^ 1][tid] = next;
      __syncthreads();
      const int row = tid / (GEN_QUADS / 4), seg = tid % (GEN_QUADS / 4);
      *reinterpret_cast<uint4*>(xt + static_cast<int64_t>(chunk * GEN_COLS + row) * p.ld + tile0 +
                                16 * seg) = *reinterpret_cast<const uint4*>(out + row * GEN_QUADS + 4 * seg);
    }

    // The block's set bits, then the cluster's in the leader's.
    if constexpr (FEW) {
      // Lanes l and l ^ 16 hold the same sites.
      any |= __shfl_xor_sync(0xFFFFFFFFu, any, 16);
      if ((tid & 31) < 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((any >> (8 * i)) & 0xFFu) atomicOr(&s_bits[sl + i], (any >> (8 * i)) & 0xFFu);
      }
    } else {
      or_set_bits(s_bits, sl, set, any);
    }
    __syncthreads();
    cluster_wait();
    if (rank != 0)
      for (int i = tid; i < p.set_words * GEN_SITES; i += GEN_THREADS)
        if (s_bits[i] != 0u) atomicOr(leader_bits + i, s_bits[i]);
    cluster.sync();  // the leader holds the tile's bits; no block touches a peer after this

    // Counters, by the leader: warps 0 and 1 hold one site a lane for the
    // kept sites; warp w counts the set words w, w + 8, ..., a lane holding
    // sites lane and lane + 32, one ballot a set.
    if (rank == 0) {
      const int lane = tid & 31;
      if (tid < GEN_SITES) {
        const unsigned kept_mask = __ballot_sync(0xFFFFFFFFu, s_kept[tid] != 0u);
        if (lane == 0 && kept_mask) atomicAdd(kept, static_cast<unsigned long long>(__popc(kept_mask)));
      }
      for (int w = tid / 32; w < p.set_words; w += GEN_THREADS / 32) {
        const uint32_t lo = s_bits[w * GEN_SITES + lane], hi = s_bits[w * GEN_SITES + 32 + lane];
        const int sets = min(32, p.n_sets - 32 * w);
        for (int b = 0; b < sets; ++b) {
          const int m = __popc(__ballot_sync(0xFFFFFFFFu, (lo >> b) & 1u)) +
                        __popc(__ballot_sync(0xFFFFFFFFu, (hi >> b) & 1u));
          if (lane == 0 && m) atomicAdd(rows + 32 * w + b, static_cast<unsigned long long>(m));
        }
      }
    }
  }
}

// A TMA load of one box (128 sites × 128 rows of Xᵀ at (k, row)), counted
// on `bar`.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major operand as the tensor map's 128-byte
// swizzle lays it out: rows of 128 bytes, 8-row atoms 1,024 bytes apart
// (stride byte offset), leading byte offset unused (1), layout 1 = 128B.
// A k-slice of 32 bytes starts 2 units (of 16 bytes) further on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The accumulator operands of one wgmma: d[i .. i+3], d[i+4 ..], ...
#define G_ACC4(i) "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define G_ACC16(i) G_ACC4(i), G_ACC4((i) + 4), G_ACC4((i) + 8), G_ACC4((i) + 12)
#define G_ACC64(i) G_ACC16(i), G_ACC16((i) + 16), G_ACC16((i) + 32), G_ACC16((i) + 48)

// d (64 × 256 int32, the warpgroup's registers: 128 a thread) +=
// A (64 × 32) · B (256 × 32)ᵀ, int8, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : G_ACC64(0), G_ACC64(64)
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs (it cannot see that they use the registers).
__device__ __forceinline__ void fence_accumulators(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// G[gi0 + i, gj0 + j] += src[i·si + j·sj] for i < rows, j < cols, both
// inside G, with red.global.add (the L2 adds; no load waits in the SM):
// consumer warp w takes rows w, w + 8, ..., a lane 32 neighbouring int32
// of a row an instruction.
__device__ __forceinline__ void red_rows(int32_t* __restrict__ g, int n, int gi0, int gj0,
                                         const int32_t* src, int si, int sj, int rows,
                                         int cols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < rows && gi0 + i < n; i += G_CONSUMERS / 32) {
    int32_t* row = g + static_cast<int64_t>(gi0 + i) * n + gj0;
    for (int j = lane; j < cols && gj0 + j < n; j += 32)
      atomicAdd(row + j, src[i * si + j * sj]);  // result unused: red.global.add.s32
  }
}

// Work units, row-major: tile row bi takes the column groups (of G_BOXES
// tiles) from the one holding its diagonal tile on. Where bi is the
// group's second tile row, the unit also computes the tile left of the
// diagonal and drops it.
int gram_units(int n_tiles) {
  const int groups = (n_tiles + G_BOXES - 1) / G_BOXES;
  int units = 0;
  for (int bi = 0; bi < n_tiles; ++bi) units += groups - bi / G_BOXES;
  return units;
}

// One block per work unit (tile row bi, column group), over every site.
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_accumulate_kernel(const __grid_constant__ CUtensorMap xt_map, int32_t* __restrict__ g,
                       int n, int n_tiles, int steps) {
  constexpr int W = G_BOXES;
  extern __shared__ unsigned char g_smem[];
  const uint32_t raw = smem_u32(g_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + G_STAGES * G_STAGE_BYTES;  // full[s] at full + 8·s
  const uint32_t empty = full + G_STAGES * 8;

  const int groups = (n_tiles + W - 1) / W;
  int bi = 0, idx = blockIdx.x;
  while (idx >= groups - bi / W) {
    idx -= groups - bi / W;
    ++bi;
  }
  const int b0 = (bi / W + idx) * W;  // the group's first column tile
  const bool a_in_b = bi >= b0;       // A's rows are one of B's boxes (the diagonal)
  const int b_boxes = n_tiles - b0 < W ? n_tiles - b0 : W;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, G_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {
    // Producer: one thread keeps up to G_STAGES stages in flight. B's boxes
    // past the last tile are not loaded; their columns are never stored.
    if (tid == G_CONSUMERS) {
      const uint32_t bytes = (b_boxes + (a_in_b ? 0 : 1)) * G_BOX_BYTES;
      for (int t = 0; t < steps; ++t) {
        const int s = t % G_STAGES;
        const uint32_t round = t / G_STAGES;
        if (t >= G_STAGES) mbar_wait(empty + 8 * s, (round & 1) ^ 1);
        const uint32_t stage = ring + s * G_STAGE_BYTES;
        const int k = t * GK;
        mbar_expect_tx(full + 8 * s, bytes);
        if (!a_in_b) tma_load_box(stage, &xt_map, full + 8 * s, k, bi * GT);
        for (int w = 0; w < b_boxes; ++w)
          tma_load_box(stage + (1 + w) * G_BOX_BYTES, &xt_map, full + 8 * s, k, (b0 + w) * GT);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64·wg.. of the block's output.
  const int wg = tid / 128;
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  fence_accumulators(d);
  for (int t = 0; t < steps; ++t) {
    const int s = t % G_STAGES;
    mbar_wait(full + 8 * s, (t / G_STAGES) & 1);
    const uint32_t stage = ring + s * G_STAGE_BYTES;
    const uint32_t a = a_in_b ? stage + (1 + bi - b0) * G_BOX_BYTES : stage;
    const uint64_t da = sw128_desc(a + wg * 64 * GK);
    const uint64_t db = sw128_desc(stage + G_BOX_BYTES);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < GK / 32; ++kk) wgmma_m64n256k32_s8(d, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (t > 0) {
      // The previous stage's MMAs are done: hand its buffers back.
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if ((tid & 31) == 0) mbar_arrive(empty + 8 * ((t - 1) % G_STAGES));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_accumulators(d);

  // Epilogue. Both warpgroups' MMAs are done before the ring is reused.
  asm volatile("bar.sync 1, %0;" ::"n"(G_CONSUMERS) : "memory");
  int32_t* staged = reinterpret_cast<int32_t*>(g_smem + (ring - raw));
  const int warp = tid / 32, lane = tid & 31;
  // Accumulator layout: register 4j+q of lane l in warp w holds row
  // 16·(w % 4) + l/4 + 8·(q/2), column 8j + 2·(l % 4) + q % 2.
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < G_BN / 8; ++j) {
    staged[r0 * G_STRIDE + 8 * j + c0] = d[4 * j];
    staged[r0 * G_STRIDE + 8 * j + c0 + 1] = d[4 * j + 1];
    staged[(r0 + 8) * G_STRIDE + 8 * j + c0] = d[4 * j + 2];
    staged[(r0 + 8) * G_STRIDE + 8 * j + c0 + 1] = d[4 * j + 3];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(G_CONSUMERS) : "memory");

  // The rows of the tiles on and above the diagonal, then the columns of
  // those above it as rows of their mirror.
  const int i0 = bi * GT, j0 = b0 * GT;
  const int direct = (bi > b0 ? bi - b0 : 0) * GT;          // first staged column stored
  const int mirror = (bi + 1 > b0 ? bi + 1 - b0 : 0) * GT;  // first staged column mirrored
  red_rows(g, n, i0, j0 + direct, staged + direct, G_STRIDE, 1, GT, G_BN - direct);
  red_rows(g, n, j0 + mirror, i0, staged + mirror, 1, G_STRIDE, G_BN - mirror, GT);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a CUDA driver function; the runtime hands out its
// address, so the library links no more than the runtime.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult query;
#if CUDART_VERSION >= 12050
    cudaError_t status = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                          cudaEnableDefault, &query);
#else
    cudaError_t status =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &query);
#endif
    if (status != cudaSuccess) return status;
    if (query != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// Sets gram_accumulate_kernel's dynamic shared-memory size on the current
// device, once per device; writes the device's ordinal.
cudaError_t gram_prepare(int* device) {
  static std::atomic<bool> ready[G_MAX_DEVICES];
  cudaError_t status = cudaGetDevice(device);
  if (status != cudaSuccess || (*device < G_MAX_DEVICES && ready[*device])) return status;
  status = cudaFuncSetAttribute(gram_accumulate_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM_BYTES);
  if (status == cudaSuccess && *device < G_MAX_DEVICES) ready[*device] = true;
  return status;
}

using GenKernel = void (*)(GenParams, const uint64_t*, const uint32_t*, const int32_t*,
                           const int32_t*, int8_t*, unsigned long long*, unsigned long long*,
                           uint32_t*);

GenKernel gen_kernel(int path) {
  return path == GEN_FEW ? gen_genotypes_kernel<GEN_FEW>
         : path == GEN_MANY ? gen_genotypes_kernel<GEN_MANY>
                            : gen_genotypes_kernel<GEN_GLOBAL>;
}

// Once per device: allows the non-portable cluster size and, on the
// shared-memory paths, all the dynamic shared memory a block may opt in to.
// Writes the device's SMs and that shared-memory size.
cudaError_t gen_prepare(int* sms, int* max_dynamic) {
  static std::atomic<int> cached_sms[G_MAX_DEVICES], cached_dynamic[G_MAX_DEVICES];
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return status;
  if (device < G_MAX_DEVICES && cached_sms[device] > 0) {
    *sms = cached_sms[device];
    *max_dynamic = cached_dynamic[device];
    return cudaSuccess;
  }
  int optin = 0;
  cudaFuncAttributes attributes{};
  status = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (status == cudaSuccess)
    status = cudaFuncGetAttributes(&attributes, gen_kernel(GEN_MANY));
  *max_dynamic = optin - static_cast<int>(attributes.sharedSizeBytes);
  for (int path = GEN_FEW; path <= GEN_GLOBAL && status == cudaSuccess; ++path) {
    status = cudaFuncSetAttribute(gen_kernel(path), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (status == cudaSuccess && path != GEN_GLOBAL)
      status = cudaFuncSetAttribute(gen_kernel(path),
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, *max_dynamic);
  }
  if (status == cudaSuccess && device < G_MAX_DEVICES) {
    cached_dynamic[device] = *max_dynamic;
    cached_sms[device] = *sms;
  }
  return status;
}

// The launch of one generation. The tables live in shared memory where
// they fit (GEN_FEW up to GEN_FEW_SETS sets, else GEN_MANY), else in a
// device buffer of `*table_words` words (GEN_GLOBAL). One cluster of S
// blocks per tile of GEN_SITES sites: S divides the chunks of columns, so
// every block draws as many; it is the least such divisor that gives every
// SM two blocks, or the largest up to GEN_MAX_CLUSTER when none does (10 at
// 2,504 samples and the CLI's 1,024 sites: 160 blocks; 2 at 16,384 sites:
// 512 blocks). Tables above a third
// of the shared memory a block may take leave an SM room for one or two
// such blocks, so S shrinks to the next divisor until the card can place a
// cluster (the query costs host time, so smaller tables skip it).
// GEN_GLOBAL launches no more clusters than the card holds at once and
// than GEN_TABLE_BYTES of tables allow; they walk the tiles.
struct GenLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute cluster;
  GenParams params;
  int path;
  int sms;
  int64_t table_words;  // the device buffer GEN_GLOBAL needs; 0 on the other paths
};

cudaError_t gen_config(int ld, int n_cols_pad, int n_pops, int n_sets, cudaStream_t stream,
                       GenLaunch* launch) {
  if (ld % GT || n_cols_pad % GT || n_pops < 1 || n_sets < 1) return cudaErrorInvalidValue;
  int max_dynamic = 0;
  cudaError_t status = gen_prepare(&launch->sms, &max_dynamic);
  if (status != cudaSuccess) return status;
  GenParams& p = launch->params;
  p.n_pops = n_pops;
  p.n_sets = n_sets;
  p.n_cols_pad = n_cols_pad;
  p.ld = ld;
  p.set_words = (n_sets + 31) / 32;
  p.table_words = gen_table_words(n_pops, n_sets);
  const int64_t table_bytes = 4ll * p.table_words;
  launch->path = table_bytes > max_dynamic       ? GEN_GLOBAL
                 : n_sets <= GEN_FEW_SETS ? GEN_FEW
                                          : GEN_MANY;
  const int64_t tiles = ld / GEN_SITES;
  const int chunks = n_cols_pad / GEN_COLS;
  int blocks = 1;
  for (int d = 2; d <= GEN_MAX_CLUSTER && d <= chunks && tiles * blocks < 2 * launch->sms; ++d)
    if (chunks % d == 0) blocks = d;
  cudaLaunchConfig_t& config = launch->config;
  config = cudaLaunchConfig_t{};
  config.blockDim = dim3(GEN_THREADS);
  config.dynamicSmemBytes = launch->path == GEN_GLOBAL ? 0 : table_bytes;
  config.stream = stream;
  config.attrs = &launch->cluster;
  config.numAttrs = 1;
  launch->cluster.id = cudaLaunchAttributeClusterDimension;
  launch->cluster.val.clusterDim.y = 1;
  launch->cluster.val.clusterDim.z = 1;
  auto shape = [&](int64_t clusters) {
    config.gridDim = dim3(static_cast<unsigned>(blocks * clusters));
    launch->cluster.val.clusterDim.x = blocks;
  };
  shape(tiles);
  launch->table_words = 0;
  const void* kernel = reinterpret_cast<const void*>(gen_kernel(launch->path));
  int resident = 0;
  if (launch->path != GEN_GLOBAL && 3 * table_bytes > max_dynamic) {
    while ((status = cudaOccupancyMaxActiveClusters(&resident, kernel, &config)) == cudaSuccess &&
           resident == 0 && blocks > 1) {
      do --blocks; while (blocks > 1 && chunks % blocks);
      shape(tiles);
    }
  } else if (launch->path == GEN_GLOBAL) {
    status = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
    const int64_t affordable = GEN_TABLE_BYTES / (4ll * blocks * p.table_words);
    int64_t clusters = tiles < resident ? tiles : resident;
    clusters = clusters < affordable ? clusters : affordable;
    shape(clusters > 1 ? clusters : 1);
    launch->table_words = static_cast<int64_t>(config.gridDim.x) * p.table_words;
  }
  return status;
}

}  // namespace

extern "C" {

// The tile constants the Python side pads to, checked at load: Xᵀ's sites
// (ld) and rows are multiples of the product's 128-wide TMA box.
int devicegen_site_tile() { return GT; }
int devicegen_col_tile() { return GT; }

// The device buffer, in 32-bit words, that gen_genotypes_launch needs for
// these shapes on the current card (its tables): 0 when they fit shared
// memory.
int gen_genotypes_table_words(int ld, int n_cols_pad, int n_pops, int n_sets, int64_t* words) {
  GenLaunch launch{};
  const cudaError_t status = gen_config(ld, n_cols_pad, n_pops, n_sets, nullptr, &launch);
  *words = launch.table_words;
  return static_cast<int>(status);
}

// Xᵀ (n_cols_pad, ld) at `xt` (16-byte aligned, both multiples of 128) for
// the sites at grid_offset + [0, ld), the first n_valid real; `vs_keys`
// holds the n_sets stream keys on the device, `tables` (16-byte aligned)
// the `table_words` words gen_genotypes_table_words asks for.
int gen_genotypes_launch(int8_t* xt, int64_t* kept, int64_t* rows, const uint64_t* vs_keys,
                         const uint32_t* col_fsamp, const int32_t* col_set,
                         const int32_t* col_pop, uint32_t* tables, int64_t table_words,
                         int64_t grid_offset, int64_t n_valid, int64_t spacing,
                         uint64_t site_key, uint64_t ref_thresh, int has_min_af,
                         uint64_t min_af_micro, int n_pops, int n_sets, int n_cols,
                         int n_cols_pad, int ld, void* stream) {
  GenLaunch launch{};
  cudaError_t status =
      gen_config(ld, n_cols_pad, n_pops, n_sets, static_cast<cudaStream_t>(stream), &launch);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (table_words < launch.table_words || (launch.table_words > 0 && tables == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  GenParams& p = launch.params;
  p.grid_offset = grid_offset;
  p.n_valid = n_valid;
  p.spacing = spacing;
  p.site_key = site_key;
  p.ref_thresh = ref_thresh;
  p.min_af_micro = min_af_micro;
  p.has_min_af = has_min_af;
  p.n_cols = n_cols;
  status = cudaLaunchKernelEx(&launch.config, gen_kernel(launch.path), p, vs_keys, col_fsamp,
                              col_set, col_pop, xt, reinterpret_cast<unsigned long long*>(kept),
                              reinterpret_cast<unsigned long long*>(rows), tables);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of one generation on the current card: grid[0] blocks,
// grid[1] blocks resident at once (the clusters the card holds × the
// cluster size), grid[2] the card's SMs, grid[3] the cluster size, grid[4]
// where the tables live (GenPath). A diagnostic: the launcher does not
// need it.
int gen_genotypes_grid(int ld, int n_cols_pad, int n_pops, int n_sets, int* grid) {
  GenLaunch launch{};
  int clusters = 0;
  cudaError_t status = gen_config(ld, n_cols_pad, n_pops, n_sets, nullptr, &launch);
  if (status == cudaSuccess)
    status = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(gen_kernel(launch.path)), &launch.config);
  const int blocks = static_cast<int>(launch.cluster.val.clusterDim.x);
  grid[0] = static_cast<int>(launch.config.gridDim.x);
  grid[1] = clusters * blocks;
  grid[2] = launch.sms;
  grid[3] = blocks;
  grid[4] = launch.path;
  return static_cast<int>(status);
}

// The launch shape of one product over Xᵀ with n_pad rows on the current
// card: grid[0] blocks (one per unit), grid[1] blocks resident at once
// (SMs × blocks an SM holds). A diagnostic: the launcher does not need it.
int gram_accumulate_grid(int n_pad, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t status = gram_prepare(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_accumulate_kernel,
                                                           GRAM_THREADS, G_SMEM_BYTES);
  grid[0] = gram_units(n_pad / GT);
  grid[1] = sms * per_sm;
  return static_cast<int>(status);
}

// G[:n, :n] += (Xᵀ·X)[:n, :n] for the (n_pad, ldx) int8 Xᵀ at `xt`
// (n_pad and ldx multiples of 128, `xt` 16-byte aligned).
int gram_accumulate_launch(int32_t* g, int n, const int8_t* xt, int n_pad, int ldx,
                           void* stream) {
  int device = 0;
  const cudaError_t prepared = gram_prepare(&device);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  EncodeTiled encode = nullptr;
  const cudaError_t found = encoder(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  // Xᵀ as a 2-D tensor: sites innermost, rows ldx bytes apart. There is no
  // signed 8-bit map type; the bytes are the same.
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldx), static_cast<cuuint64_t>(n_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldx)};
  const cuuint32_t box[2] = {GK, GT};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult encoded = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(xt), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (encoded != CUDA_SUCCESS) return -static_cast<int>(encoded);
  gram_accumulate_kernel<<<gram_units(n_pad / GT), GRAM_THREADS, G_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(map, g, n, n_pad / GT, ldx / GK);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
