// Two hardware probes for Hopper (sm_90a), the counterparts of the TPU
// microbenchmarks under experiments/.
//
// probe_op_chain_kernel — replaces experiments/probe_ops.py:run (Pallas body
//   make): one u32 operation applied R = 64 times to every element of a
//   (1024, 2560) tile, with the loop index as its second operand, constants
//   as in probe_ops.py:14-32. The op is a template parameter, so each of the
//   six compiles to its own straight-line chain. It prices the u32 work of
//   gen_genotypes (csrc/devicegen.cu) op by op.
//   Bound: the 32-bit operations each op needs per element per iteration
//   (xor 2, shiftxor 3, cmp 2, mul 1, mul_i32 1, fmix32 9) at 128 an SM a
//   clock, against 8 bytes per element of device memory. An SM issues
//   logic, shifts, compares and selects on one 64-lane pipe (ALU) and
//   integer multiply-adds on another (FMA), so the rate is reached only
//   where an op's instructions split evenly between the two.
//   Design, for both of those:
//   - A persistent grid (the card's SMs × the blocks an SM holds, from the
//     occupancy calculator) walks the elements as 16-byte vectors: a
//     thread loads a uint4 (LDG.E.128), runs its four elements' chains
//     interleaved (four independent chains hide the pipes' latency with
//     few warps), stores it (STG.E.128), and has the next vector's load in
//     flight while it computes, so the bytes overlap the chains instead of
//     preceding and following them (the launch of one thread per element
//     ran its load, chain and store in series, about 6 µs of the 21 MB a
//     call moves on every op).
//   - Adds issue as IMAD (x · one + i, `one` a kernel argument nvcc cannot
//     fold) on the FMA pipe, beside the logic and shifts on the ALU pipe:
//     xor is one IMAD and one LOP3, cmp one ISETP and one predicated IMAD,
//     shiftxor SHF and LOP3 and one IMAD, fmix32 three SHF, three LOP3 and
//     three IMAD; mul and mul_i32 are one IMAD each, so the FMA pipe bounds
//     them above their bytes. PERF.md has each op's SASS split.
//   - The elements before the first 16-byte boundary and after the last
//     whole vector run as scalar chains in the kernel. The wrapper gives
//     `out` the same offset from a 16-byte boundary as `in`, so one set of
//     vector indices is aligned in both.
//   The loop index starts from a kernel argument (0): with a literal start
//   nvcc folds the xor chain to a constant (x ^ (x + 0) is 0) and composes
//   the 64 multiply-adds into one, and the probe would time a store. The
//   multiplies are inline PTX mad.lo for the same reason.
//   mul_i32 is the reference's wrapping int32 product. Signed overflow is
//   undefined in C++, so it is PTX mad.lo.s32, whose low 32 bits wrap by
//   definition — never an int32 multiply in C++.
//   Measured and not kept (experiments/probe_variants.py; PERF.md has the
//   times): one thread keeping cp.async.bulk loads in flight into a
//   shared ring on mbarriers; the loop indices as a kernel-parameter table
//   (nvcc loads all 64 into registers); plain C adds (nvcc's VIADD, and a
//   SEL in cmp); shifts as IMAD.HI; the next vector's load as volatile
//   PTX ahead of the chains (no faster than nvcc's late load).
//
// scratch_copy_kernel — replaces experiments/vmem_capacity.py:5 try_scratch
//   (its pallas_call at :11): copy an (8, 1024) float32 tile through the last
//   32 KiB of a dynamic shared-memory scratch of `nbytes` bytes, so the end
//   of the whole allocation is touched. On Hopper a block's shared memory
//   above 48 KB needs cudaFuncSetAttribute(MaxDynamicSharedMemorySize); the
//   launcher sets it to `nbytes`. A refused size (cudaErrorInvalidValue) is
//   the probe's result, not a fault: the launcher clears the error with
//   cudaGetLastError() and says so through an out-parameter; every other
//   error is returned, and the Python side raises on it.
//   Bound: 64 KiB of device memory, far under a microsecond at 3.35 TB/s,
//   so its time is a launch and two transfers' latency. One thread moves
//   the tile as two TMA bulk copies of one instruction each: global →
//   shared counted on an mbarrier (complete_tx), then shared → global in a
//   bulk group. The mbarrier lives in the scratch's first 8 bytes (a static
//   __shared__ one would count against the opt-in limit and move the
//   bisected size), so the tile must start past it: the smallest scratch
//   is TILE_BYTES + 16, the tile's offset being aligned down to 16 bytes.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). Each launcher
// returns a cudaError_t value, 0 on success.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int R = 64;                     // iterations per element (probe_ops.py:9)
constexpr int PROBE_THREADS = 256;
constexpr int MAX_DEVICES = 64;           // devices whose grid size is cached
constexpr int TILE_FLOATS = 8 * 1024;     // the (8, 1024) f32 tile
constexpr int TILE_BYTES = TILE_FLOATS * 4;
constexpr int MIN_SCRATCH_BYTES = TILE_BYTES + 16;  // the mbarrier, then the tile

enum Op { XOR = 0, SHIFTXOR = 1, CMP = 2, MUL = 3, MUL_I32 = 4, FMIX32 = 5 };

// -2048144789 == int32(0x85EBCA6B), the reference's int32 multiplier.
constexpr int32_t MUL_I32_FACTOR = -2048144789;

// a · b + c, low 32 bits, as one IMAD that nvcc cannot fold or move to
// another pipe.
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One step of the chain; `one` is 1, from a kernel argument.
template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t i, uint32_t one) {
  if constexpr (OP == XOR) {
    return x ^ mad(x, one, i);
  } else if constexpr (OP == SHIFTXOR) {
    return mad(x ^ (x >> 16), one, i);
  } else if constexpr (OP == CMP) {
    // x + (x < 0x7FFFFFFF + i): the compare, then x · one + 1 under it.
    uint32_t y = x;
    asm("{\n"
        ".reg .pred p;\n"
        "setp.lt.u32 p, %1, %2;\n"
        "@p mad.lo.u32 %0, %1, %3, 1;\n"
        "}\n"
        : "+r"(y)
        : "r"(x), "r"(0x7FFFFFFFu + i), "r"(one));
    return y;
  } else if constexpr (OP == MUL) {
    return mad(x, 0x85EBCA6Bu, i);
  } else if constexpr (OP == MUL_I32) {
    int32_t y;
    asm("mad.lo.s32 %0, %1, %2, %3;"
        : "=r"(y)
        : "r"(static_cast<int32_t>(x)), "r"(MUL_I32_FACTOR), "r"(static_cast<int32_t>(i)));
    return static_cast<uint32_t>(y);
  } else {
    uint32_t y = (x ^ (x >> 16)) * 0x85EBCA6Bu;
    y = (y ^ (y >> 13)) * 0xC2B2AE35u;
    return mad(y ^ (y >> 16), one, i);
  }
}

template <int OP>
__device__ __forceinline__ uint32_t chain(uint32_t x, uint32_t i0, uint32_t one) {
#pragma unroll
  for (int k = 0; k < R; ++k) x = step<OP>(x, i0 + static_cast<uint32_t>(k), one);
  return x;
}

// The four elements' chains, step by step, so they interleave.
template <int OP>
__device__ __forceinline__ uint4 chain4(uint4 v, uint32_t i0, uint32_t one) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const uint32_t i = i0 + static_cast<uint32_t>(k);
    v.x = step<OP>(v.x, i, one);
    v.y = step<OP>(v.y, i, one);
    v.z = step<OP>(v.z, i, one);
    v.w = step<OP>(v.w, i, one);
  }
  return v;
}

// `head` scalar elements, then `vecs` 16-byte vectors (16-byte aligned in
// `in` and `out`), then the scalar rest up to n.
template <int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_op_chain_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n,
                      int64_t head, int64_t vecs, uint32_t i0, uint32_t one) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * PROBE_THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  // The ragged head and tail, at most 3 + 3 elements, a thread each.
  const int64_t rest = head + 4 * vecs;
  if (first < head + n - rest) {
    const int64_t e = first < head ? first : rest + first - head;
    out[e] = chain<OP>(in[e], i0, one);
  }
  const uint4* __restrict__ vin = reinterpret_cast<const uint4*>(in + head);
  uint4* __restrict__ vout = reinterpret_cast<uint4*>(out + head);
  int64_t v = first;
  uint4 cur = v < vecs ? __ldg(vin + v) : make_uint4(0u, 0u, 0u, 0u);
  while (v < vecs) {
    // The next vector's load is in flight while this one's chains run.
    const int64_t ahead = v + stride;
    const uint4 next = ahead < vecs ? __ldg(vin + ahead) : make_uint4(0u, 0u, 0u, 0u);
    vout[v] = chain4<OP>(cur, i0, one);
    cur = next;
    v = ahead;
  }
}

// Blocks of the persistent grid: the card's SMs × the blocks of OP's
// kernel an SM holds, asked once per device.
template <int OP>
cudaError_t chain_blocks(int* blocks) {
  static std::atomic<int> cached[MAX_DEVICES];
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return status;
  if (device < MAX_DEVICES && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_op_chain_kernel<OP>,
                                                           PROBE_THREADS, 0);
  *blocks = sms * per_sm;
  if (status == cudaSuccess && device < MAX_DEVICES) cached[device] = *blocks;
  return status;
}

template <int OP>
int launch_chain(const uint32_t* in, uint32_t* out, int64_t n, cudaStream_t s) {
  const int64_t to_boundary = (16 - reinterpret_cast<uintptr_t>(in) % 16) % 16 / 4;
  const int64_t head = to_boundary < n ? to_boundary : n;
  const int64_t vecs = (n - head) / 4;
  int blocks = 0;
  const cudaError_t status = chain_blocks<OP>(&blocks);
  if (status != cudaSuccess) return static_cast<int>(status);
  // Enough threads for the scalar elements (at most 6) and, up to the
  // persistent grid, one a vector.
  const int64_t wanted = (vecs > 6 ? vecs : 6) + PROBE_THREADS - 1;
  const int64_t grid = wanted / PROBE_THREADS < blocks ? wanted / PROBE_THREADS : blocks;
  probe_op_chain_kernel<OP><<<static_cast<int>(grid), PROBE_THREADS, 0, s>>>(in, out, n, head, vecs,
                                                                           0u, 1u);
  return static_cast<int>(cudaGetLastError());
}

// One thread: `in` and `out` 16-byte aligned, nbytes ≥ MIN_SCRATCH_BYTES.
__global__ void __launch_bounds__(1)
scratch_copy_kernel(const float* __restrict__ in, float* __restrict__ out, int nbytes) {
  extern __shared__ __align__(16) unsigned char scratch[];
  const uint32_t bar = smem_u32(scratch);
  // The last TILE_BYTES of the allocation, aligned down to 16 bytes.
  const uint32_t tile = smem_u32(scratch + ((nbytes - TILE_BYTES) & ~15));
  mbar_init(bar, 1);
  mbar_expect_tx(bar, TILE_BYTES);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(tile), "l"(in), "r"(TILE_BYTES), "r"(bar)
      : "memory");
  mbar_wait(bar, 0);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(out), "r"(tile), "r"(TILE_BYTES)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  // Until the tile has been read out of the scratch; the writes to `out`
  // are complete when the kernel is.
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace

extern "C" {

int probes_rounds() { return R; }
int probes_tile_bytes() { return TILE_BYTES; }
int probes_min_scratch_bytes() { return MIN_SCRATCH_BYTES; }

// `out` must lie as far past a 16-byte boundary as `in` (both 4-byte
// aligned).
int probe_op_chain_launch(const uint32_t* in, uint32_t* out, int64_t n, int op,
                          void* stream) {
  if ((reinterpret_cast<uintptr_t>(in) - reinterpret_cast<uintptr_t>(out)) % 16 ||
      reinterpret_cast<uintptr_t>(in) % 4 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case XOR: return launch_chain<XOR>(in, out, n, s);
    case SHIFTXOR: return launch_chain<SHIFTXOR>(in, out, n, s);
    case CMP: return launch_chain<CMP>(in, out, n, s);
    case MUL: return launch_chain<MUL>(in, out, n, s);
    case MUL_I32: return launch_chain<MUL_I32>(in, out, n, s);
    case FMIX32: return launch_chain<FMIX32>(in, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// *refused is 1 when cudaFuncSetAttribute refused `nbytes` (the probe's
// answer; the call returns 0 and launches nothing), else 0. Any other error,
// a sticky one left by an earlier kernel included, is returned.
int scratch_copy_launch(const float* in, float* out, int nbytes, int* refused,
                        void* stream) {
  *refused = 0;
  if (nbytes < MIN_SCRATCH_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status = cudaFuncSetAttribute(
      scratch_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (status == cudaErrorInvalidValue) {
    cudaGetLastError();  // a refused size is the probe's answer; clear it
    *refused = 1;
    return 0;
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  scratch_copy_kernel<<<1, 1, nbytes, static_cast<cudaStream_t>(stream)>>>(in, out, nbytes);
  return static_cast<int>(cudaGetLastError());
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`: the driver's own
// figure for the largest dynamic shared memory a block may opt in to.
int max_shared_memory_optin(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return value;
}

}  // extern "C"
