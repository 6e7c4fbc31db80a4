"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Libraries build at first use
into ``build/torch_kernels/`` at the repository root, named by a content
hash of the source and the flags, so an edited source rebuilds. The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>.log``.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("depth.cu", "devicegen.cu", "gramian.cu", "ld.cu", "probes.cu")

#: Where the Gramian kernels' wrappers take their plain versions: CPU
#: tensors, and ``meta`` tensors (shapes and dtypes alone, as ``graftcheck``
#: evaluates the device program at a run's geometry). A CUDA tensor
#: launches the kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

#: C signatures of each source's functions: source → name → argtypes.
_SIGNATURES = {
    "depth.cu": {
        # positions, lengths, rows, window_start, window_size, max_read_length, out,
        # zeroed difference buffer, zeroed tile totals, the next launch's, their words, stream
        "depth_counts_launch": (_P, _P, _I32, _I64, _I32, _I32, _P, _P, _P, _P, _I32, _P),
        "depth_scan_tile": (),
        # positions, codes, quality_ok, rows, read_len, window_start, window_size,
        # zeroed out, next out (zeroed here), its 16-byte vectors, stream
        "base_counts_launch": (_P, _P, _P, _I32, _I32, _I64, _I32, _P, _P, _I64, _P),
    },
    "devicegen.cu": {
        "gen_genotypes_launch": (
            _P, _P, _P, _P, _P, _P, _P,  # xt, kept, rows, vs_keys, fsamp, set, pop
            _P, _I64,  # tables, table_words
            _I64, _I64, _I64,  # grid_offset, n_valid, spacing
            _U64, _U64, _I32, _U64,  # site_key, ref_thresh, has_min_af, min_af
            _I32, _I32, _I32, _I32, _I32,  # n_pops, n_sets, n_cols, n_cols_pad, ld
            _P,  # stream
        ),
        "gram_accumulate_launch": (_P, _I32, _P, _I32, _I32, _I32, _P),  # ..., ldx, split, stream
        # g, n, xt, lanes in the stack, n_pad, ldx, split, listed lanes, their count, stream
        "stacked_gram_accumulate_launch": (_P, _I32, _P, _I32, _I32, _I32, _I32, _P, _I32, _P),
        # c, ldc, m, n, a, m_pad, b, n_pad, ld, split, counter, stream
        "cross_accumulate_launch": (_P, _I64, _I32, _I32, _P, _I32, _P, _I32, _I32, _I32, _P, _P),
        "cross_accumulate_grid": (_I32, _I32, _I32, _I32, _P),  # m_pad, n_pad, ld, split, grid (7 ints)
        "gen_genotypes_table_words": (_I32, _I32, _I32, _I32, _P),  # ld, n_cols_pad, pops, sets, words
        "gen_genotypes_grid": (_I32, _I32, _I32, _I32, _P),  # ld, n_cols_pad, pops, sets, grid (5 ints)
        "gram_accumulate_grid": (_I32, _P),  # n_pad, grid (3 ints)
        "devicegen_site_tile": (),
        "devicegen_col_tile": (),
        "devicegen_stack_list": (),
    },
    "gramian.cu": {
        # in, rows, in_width, n_cols, packed, xt, n_pad, ld, stream
        "unpack_rows_t_launch": (_P, _I32, _I32, _I32, _I32, _P, _I32, _I32, _P),
        "gramian_tile_sites": (),
        "gramian_stack_list": (),
        # in, lanes in the stack, rows, in_width, n_cols, xt, n_pad, ld, listed lanes,
        # their count, stream
        "stacked_unpack_rows_t_launch": (_P, _I32, _I32, _I32, _I32, _P, _I32, _I32, _P, _I32, _P),
        "pack_rows_t_launch": (_P, _I32, _I32, _I32, _I32, _P, _P),  # xt, n_pad, ld, n_cols, rows, out, stream
        "pack_rows_t_grid": (_I32, _I32, _P),  # rows, n_cols, grid (5 ints)
        "transpose_rows_t_launch": (_P, _I32, _I32, _I32, _I32, _P, _P),  # xt, n_pad, ld, n_cols, rows, out, stream
    },
    "ld.cu": {
        # in, rows, width, pitch, vectors, case, n_cols, lanes, a, t, stream
        "case_counts_launch": (_P, _I32, _I32, _I64, _I32, _P, _I32, _I32, _P, _P, _P),
    },
    "probes.cu": {
        "probe_op_chain_launch": (_P, _P, _I64, _I32, _P),  # in, out, n, op, stream
        "scratch_copy_launch": (_P, _P, _I32, _P, _P),  # in, out, nbytes, refused, stream
        "max_shared_memory_optin": (_I32,),  # device
        "probes_rounds": (),
        "probes_tile_bytes": (),
        "probes_min_scratch_bytes": (),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build from csrc/ with the CUDA toolkit"
        )
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: ``<stem>-<content hash>.so``, the
    hash over the source, the shared headers (``csrc/*.cuh``) and the
    flags."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile each of ``sources`` whose library is missing, one ``nvcc``
    per source, all started together; raises with the compiler's output
    when a build fails. Returns source → library path."""
    out = {source: library_path(source) for source in sources}
    builds = {}
    for source, path in out.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        builds[source] = (proc, tmp, path)
    failed = []
    for source, (proc, tmp, path) in builds.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{report}")
            continue
        path.with_suffix(".log").write_text(report)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_all() -> Dict[str, Path]:
    """:func:`build` of every source in ``SOURCES``."""
    return build(SOURCES)


def build_log(source: str = "devicegen.cu") -> str:
    """The ``-Xptxas -v`` report of ``source``'s current build."""
    return library_path(source).with_suffix(".log").read_text()


def library(source: str = "devicegen.cu") -> ctypes.CDLL:
    """Load ``source``'s library, built first when missing (only that
    source), with the C signatures of its functions declared."""
    lib = ctypes.CDLL(str(build((source,))[source]))
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, kernel: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it); a negative status is
    a CUDA driver ``CUresult`` from encoding a TMA tensor map."""
    if status < 0:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled failed: CUresult {-status}")
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")


__all__ = ["BUILD_DIR", "PLAIN_DEVICES", "SOURCES", "build", "build_all", "build_log", "check", "library"]
