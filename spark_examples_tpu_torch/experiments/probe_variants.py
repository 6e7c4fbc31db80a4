"""Measure ``probe_op_chain_kernel`` against the designs it was chosen over.

    python -m spark_examples_tpu_torch.experiments.probe_variants

Builds ``csrc/probes.cu`` as it is ("kept") and variants of it, each one
design decision of the op-chain kernel turned another way:

- "index-table": the 64 loop indices (and cmp's bounds) as a table in the
  kernel's parameters, for the steps to read as constant-bank operands
  instead of building each from the start;
- "early-load": the next vector's load as volatile inline PTX ahead of
  the chains (nvcc otherwise issues it late, in fmix32 after the store);
- "alu-adds": the adds as plain C (``x + i``, ``x + (x < t)``), which nvcc
  issues on the ALU pipe beside the logic and shifts (IADD3, or a SEL);
- "imad-hi": as kept, and the right shifts by 16 of shiftxor and fmix32
  as the high half of a multiply by 2^16 (IMAD.HI, on the FMA pipe);
- "bulk": as kept, but a block's vectors come through a ring of shared
  memory in tiles of one vector a thread, which one thread fills with
  ``cp.async.bulk`` copies counted on an mbarrier, ``BULK_STAGES`` tiles
  ahead of the chains.

Each build is held bit for bit against ``probe_op_chain_plain`` on the
(1024, 2560) tile and on ragged, misaligned views, then timed with CUDA
events per op, the builds in turns, forward and backward, twice. For each
build and op it also counts the chain's SASS instructions by pipe (ALU:
logic, shifts, compares, selects, adds; FMA: IMAD and IMUL) per element
per iteration, from ``cuobjdump -sass``. Prints the card line and one JSON
object. Runs on a CUDA card only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from spark_examples_tpu_torch.experiments import probe_ops
from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.utils.device import cuda_event_ms
from spark_examples_tpu_torch.utils.sass import pipe_split

ROUNDS = 2
BUILD_DIR = _kernels.BUILD_DIR / "probe_variants"
#: Scalar chains compiled into the kernel besides the four of the vector
#: loop: the ragged head and tail share one.
CHAINS = 5

_STEP_START = "template <int OP>\n__device__ __forceinline__ uint32_t step("
_STEP_END = "template <int OP>\n__device__ __forceinline__ uint32_t chain("
_KERNEL_START = "// `head` scalar elements, then `vecs` 16-byte vectors"
_CHAIN_START = "// One step of the chain; `one` is 1, from a kernel argument."
_KERNEL_END = "// Blocks of the persistent grid"

INDEX_TABLE_CHAIN = r"""// The chain's loop indices, a kernel parameter: in the constant bank, so a
// step takes its index (and cmp its bound) as an operand and no
// instruction builds it. They start from 0 as the reference's do, but nvcc
// cannot see that: with literal indices it folds the xor chain to a
// constant (x ^ (x + 0) is 0) and would time a store.
struct Indices {
  uint32_t i[R];    // step k's index
  uint32_t cmp[R];  // 0x7FFFFFFF + i, cmp's bound
};

// Step k of the chain; `one` is 1, from a kernel argument.
template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, const Indices& idx, int k, uint32_t one) {
  const uint32_t i = idx.i[k];
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
        : "r"(x), "r"(idx.cmp[k]), "r"(one));
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
__device__ __forceinline__ uint32_t chain(uint32_t x, const Indices& idx, uint32_t one) {
#pragma unroll
  for (int k = 0; k < R; ++k) x = step<OP>(x, idx, k, one);
  return x;
}

// The four elements' chains, step by step, so they interleave.
template <int OP>
__device__ __forceinline__ uint4 chain4(uint4 v, const Indices& idx, uint32_t one) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    v.x = step<OP>(v.x, idx, k, one);
    v.y = step<OP>(v.y, idx, k, one);
    v.z = step<OP>(v.z, idx, k, one);
    v.w = step<OP>(v.w, idx, k, one);
  }
  return v;
}

// The table's values: index k, and 0x7FFFFFFF + k.
__host__ Indices table() {
  Indices idx;
  for (int k = 0; k < R; ++k) {
    idx.i[k] = static_cast<uint32_t>(k);
    idx.cmp[k] = 0x7FFFFFFFu + static_cast<uint32_t>(k);
  }
  return idx;
}

"""

ALU_ADDS_STEP = r"""template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t i, uint32_t one) {
  if constexpr (OP == XOR) {
    return x ^ (x + i);
  } else if constexpr (OP == SHIFTXOR) {
    return (x ^ (x >> 16)) + i;
  } else if constexpr (OP == CMP) {
    return x + (x < 0x7FFFFFFFu + i ? 1u : 0u);
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
    return (y ^ (y >> 16)) + i;
  }
}

"""

IMAD_HI_STEP = r"""// x >> 16 as the high half of x · 2^16 (IMAD.HI); `one` keeps it a multiply.
__device__ __forceinline__ uint32_t shr16(uint32_t x, uint32_t one) {
  uint32_t d;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(one << 16));
  return d;
}

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t i, uint32_t one) {
  if constexpr (OP == XOR) {
    return x ^ mad(x, one, i);
  } else if constexpr (OP == SHIFTXOR) {
    return mad(x ^ shr16(x, one), one, i);
  } else if constexpr (OP == CMP) {
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
    uint32_t y = (x ^ shr16(x, one)) * 0x85EBCA6Bu;
    y = (y ^ (y >> 13)) * 0xC2B2AE35u;
    return mad(y ^ shr16(y, one), one, i);
  }
}

"""

BULK_KERNEL = r"""constexpr int BULK_STAGES = 4;
constexpr int BULK_VECS = PROBE_THREADS;  // a tile: one vector a thread

// As the kept kernel, with a block's vectors through a shared ring that
// thread 0 fills by bulk copies BULK_STAGES tiles ahead.
template <int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_op_chain_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n,
                      int64_t head, int64_t vecs, uint32_t i0, uint32_t one) {
  __shared__ __align__(16) uint4 ring[BULK_STAGES][BULK_VECS];
  __shared__ __align__(8) uint64_t full[BULK_STAGES];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  const int64_t rest = head + 4 * vecs;
  if (first < head + n - rest) {
    const int64_t e = first < head ? first : rest + first - head;
    out[e] = chain<OP>(in[e], i0, one);
  }
  const uint4* vin = reinterpret_cast<const uint4*>(in + head);
  uint4* __restrict__ vout = reinterpret_cast<uint4*>(out + head);
  const int64_t tiles = (vecs + BULK_VECS - 1) / BULK_VECS;
  const int64_t mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto issue = [&](int64_t t) {
    const int s = static_cast<int>(t % BULK_STAGES);
    const int64_t tile = blockIdx.x + t * gridDim.x;
    const int64_t left = vecs - tile * BULK_VECS;
    const uint32_t bytes = static_cast<uint32_t>((left < BULK_VECS ? left : BULK_VECS) * 16);
    mbar_expect_tx(smem_u32(&full[s]), bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(ring[s])), "l"(vin + tile * BULK_VECS), "r"(bytes), "r"(smem_u32(&full[s]))
        : "memory");
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < BULK_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    for (int64_t t = 0; t < mine && t < BULK_STAGES; ++t) issue(t);
  }
  __syncthreads();
  for (int64_t t = 0; t < mine; ++t) {
    const int s = static_cast<int>(t % BULK_STAGES);
    const int64_t v = (blockIdx.x + t * gridDim.x) * BULK_VECS + threadIdx.x;
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>(t / BULK_STAGES) & 1);
    const uint4 cur = v < vecs ? ring[s][threadIdx.x] : make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // every thread has read stage s: refill it
    if (threadIdx.x == 0 && t + BULK_STAGES < mine) issue(t + BULK_STAGES);
    if (v < vecs) vout[v] = chain4<OP>(cur, i0, one);
  }
}

"""


def _replace_between(text: str, start: str, end: str, new: str) -> str:
    if text.count(start) != 1 or text.count(end) != 1:
        raise RuntimeError(f"csrc/probes.cu no longer holds {start[:50]!r} or {end[:50]!r}")
    a, b = text.index(start), text.index(end)
    return text[:a] + new + text[b:]


def index_table(kept: str) -> str:
    """The loop indices and cmp's bounds as a kernel-parameter table."""
    text = _replace_between(kept, _CHAIN_START, _KERNEL_START, INDEX_TABLE_CHAIN)
    for old, new in (
        ("int64_t head, int64_t vecs, uint32_t i0, uint32_t one) {",
         "int64_t head, int64_t vecs, const Indices idx, uint32_t one) {"),
        ("out[e] = chain<OP>(in[e], i0, one);", "out[e] = chain<OP>(in[e], idx, one);"),
        ("vout[v] = chain4<OP>(cur, i0, one);", "vout[v] = chain4<OP>(cur, idx, one);"),
        ("(in, out, n, head, vecs,\n", "(in, out, n, head, vecs, table(),\n"),
        ("0u, 1u);", "1u);"),
    ):
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/probes.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def early_load(kept: str) -> str:
    """The next vector's load as volatile inline PTX, issued before the
    chains in program order (nvcc schedules the plain load late)."""
    old = "    const uint4 next = ahead < vecs ? __ldg(vin + ahead) : make_uint4(0u, 0u, 0u, 0u);\n"
    new = ("    uint4 next = make_uint4(0u, 0u, 0u, 0u);\n"
           "    if (ahead < vecs)\n"
           "      asm volatile(\"ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
           "                   : \"=r\"(next.x), \"=r\"(next.y), \"=r\"(next.z), \"=r\"(next.w)\n"
           "                   : \"l\"(vin + ahead));\n")
    if kept.count(old) != 1:
        raise RuntimeError(f"csrc/probes.cu no longer holds {old!r}")
    return kept.replace(old, new)


def variants(kept: str) -> dict:
    """Build name → source text."""
    return {
        "kept": kept,
        "index-table": index_table(kept),
        "early-load": early_load(kept),
        "alu-adds": _replace_between(kept, _STEP_START, _STEP_END, ALU_ADDS_STEP),
        "imad-hi": _replace_between(kept, _STEP_START, _STEP_END, IMAD_HI_STEP),
        "bulk": _replace_between(kept, _KERNEL_START, _KERNEL_END, BULK_KERNEL),
    }


def build(name: str, text: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, out = BUILD_DIR / f"{name}.cu", BUILD_DIR / f"{name}.so"
    src.write_text(text)
    return subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC_DIR), "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ), out


def load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _kernels._SIGNATURES["probes.cu"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kept = (_kernels.CSRC_DIR / "probes.cu").read_text()
    procs = {name: build(name, text) for name, text in variants(kept).items()}
    libs, paths = {}, {}
    for name, (proc, path) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name], paths[name] = load(path), path

    dev = torch.device("cuda")
    x = torch.from_numpy(probe_ops.random_tile(0)).to(dev)
    base = torch.from_numpy(probe_ops.random_tile(3, (1, 4099))).to(dev).view(-1)
    checks = [x, base[:1], base[:3], base[1:], base[2:4099], base[3:10]]

    def use(name):
        probe_ops._library = lambda: libs[name]

    for name in libs:
        use(name)
        for op in probe_ops.OPS:
            for t in checks:
                got = probe_ops.probe_op_chain(probe_ops.probe_op_chain(t, op), op)
                want = probe_ops.probe_op_chain_plain(probe_ops.probe_op_chain_plain(t, op), op)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}[{op}] != plain at {t.numel()} elements, "
                                         f"offset {t.storage_offset()}")
        print(f"probe_variants: {name} == plain, every op, at {len(checks)} shapes", flush=True)

    times = {name: {op: [] for op in probe_ops.OPS} for name in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(ROUNDS):
        for name in order:
            use(name)
            for op in probe_ops.OPS:
                last = [x]

                def feed_back():
                    last[0] = probe_ops.probe_op_chain(last[0], op)

                times[name][op].append(cuda_event_ms(feed_back, probe_ops.REPS))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    result = {}
    for name in libs:
        split = pipe_split(paths[name], "probe_op_chain_kernel", probe_ops.OPS, CHAINS * probe_ops.R)
        ops = {op: {"mean_ms": sum(v) / len(v), "min_ms": min(v), "max_ms": max(v), **split[op]}
               for op, v in times[name].items()}
        result[name] = {"suite_ms": sum(o["mean_ms"] for o in ops.values()), "ops": ops}
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
