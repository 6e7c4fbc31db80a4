// Two hardware probes for Hopper (sm_90a), the counterparts of the TPU
// microbenchmarks under experiments/.
//
// probe_op_chain_kernel — replaces experiments/probe_ops.py:run (Pallas body
//   make): one u32 operation applied R = 64 times to every element of a
//   (1024, 2560) tile, with the loop index as its second operand, constants
//   as in probe_ops.py:14-32. The op is a template parameter, so each of the
//   six compiles to its own straight-line loop; one thread per element.
//   It prices the u32 work of gen_genotypes (csrc/devicegen.cu) op by op.
//   The loop index starts from a kernel argument (0): with a literal start
//   nvcc folds the xor chain to a constant (x ^ (x + 0) is 0) and composes
//   the 64 multiply-adds into one, and the probe would time a store. The
//   multiplies are inline PTX mad.lo for the same reason.
//   Bound: the 32-bit operations each op needs per element per iteration
//   (xor 2, shiftxor 3, cmp 2, mul 1, mul_i32 1, fmix32 9) at the SM's
//   issue rate, against 8 bytes per element of device memory.
//   mul_i32 is the reference's wrapping int32 product. Signed overflow is
//   undefined in C++, so it is PTX mad.lo.s32, whose low 32 bits wrap by
//   definition — never an int32 multiply in C++.
//
// scratch_copy_kernel — replaces experiments/vmem_capacity.py:try_scratch:
//   copy an (8, 1024) float32 tile through the last 32 KiB of a dynamic
//   shared-memory scratch of `nbytes` bytes, so the end of the whole
//   allocation is touched. On Hopper a block's shared memory above 48 KB
//   needs cudaFuncSetAttribute(MaxDynamicSharedMemorySize); the launcher
//   sets it to `nbytes`. A refused size (cudaErrorInvalidValue) is the
//   probe's result, not a fault: the launcher clears the error with
//   cudaGetLastError() and says so through an out-parameter; every other
//   error is returned, and the Python side raises on it.
//
// Plain C interface, bound with ctypes (ops/_kernels.py). Each launcher
// returns a cudaError_t value, 0 on success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 64;                     // iterations per element (probe_ops.py:9)
constexpr int PROBE_THREADS = 256;
constexpr int TILE_FLOATS = 8 * 1024;     // the (8, 1024) f32 tile
constexpr int TILE_BYTES = TILE_FLOATS * 4;
constexpr int COPY_THREADS = 256;

enum Op { XOR = 0, SHIFTXOR = 1, CMP = 2, MUL = 3, MUL_I32 = 4, FMIX32 = 5 };

// -2048144789 == int32(0x85EBCA6B), the reference's int32 multiplier.
constexpr int32_t MUL_I32_FACTOR = -2048144789;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t i) {
  if constexpr (OP == XOR) {
    return x ^ (x + i);
  } else if constexpr (OP == SHIFTXOR) {
    return (x ^ (x >> 16)) + i;
  } else if constexpr (OP == CMP) {
    return x + (x < 0x7FFFFFFFu + i ? 1u : 0u);
  } else if constexpr (OP == MUL) {
    uint32_t y;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(y) : "r"(x), "r"(0x85EBCA6Bu), "r"(i));
    return y;
  } else if constexpr (OP == MUL_I32) {
    int32_t y;
    asm("mad.lo.s32 %0, %1, %2, %3;"
        : "=r"(y)
        : "r"(static_cast<int32_t>(x)), "r"(MUL_I32_FACTOR), "r"(static_cast<int32_t>(i)));
    return static_cast<uint32_t>(y);
  } else {
    uint32_t y = (x ^ (x >> 16)) * 0x85EBCA6Bu;
    y = (y ^ (y >> 13)) * 0xC2B2AE35u;
    return (y ^ (y >> 16)) + i;
  }
}

template <int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_op_chain_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                      int64_t n, uint32_t i0) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * PROBE_THREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
       e < n; e += stride) {
    uint32_t x = in[e];
#pragma unroll
    for (int k = 0; k < R; ++k) x = step<OP>(x, i0 + static_cast<uint32_t>(k));
    out[e] = x;
  }
}

template <int OP>
int launch_chain(const uint32_t* in, uint32_t* out, int64_t n, cudaStream_t s) {
  const int64_t blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  const int grid = static_cast<int>(blocks < 65535 * 32 ? blocks : 65535 * 32);
  probe_op_chain_kernel<OP><<<grid, PROBE_THREADS, 0, s>>>(in, out, n, 0u);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(COPY_THREADS)
scratch_copy_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                    int nbytes) {
  extern __shared__ __align__(16) unsigned char scratch[];
  // The last TILE_BYTES of the allocation, aligned down to 16 bytes.
  float4* tile = reinterpret_cast<float4*>(scratch + ((nbytes - TILE_BYTES) & ~15));
  for (int i = threadIdx.x; i < TILE_FLOATS / 4; i += COPY_THREADS) tile[i] = in[i];
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_FLOATS / 4; i += COPY_THREADS) out[i] = tile[i];
}

}  // namespace

extern "C" {

int probes_rounds() { return R; }
int probes_tile_bytes() { return TILE_BYTES; }

int probe_op_chain_launch(const uint32_t* in, uint32_t* out, int64_t n, int op,
                          void* stream) {
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
  if (nbytes < TILE_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status = cudaFuncSetAttribute(
      scratch_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (status == cudaErrorInvalidValue) {
    cudaGetLastError();  // a refused size is the probe's answer; clear it
    *refused = 1;
    return 0;
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  scratch_copy_kernel<<<1, COPY_THREADS, nbytes, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), nbytes);
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
