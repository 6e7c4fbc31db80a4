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
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("devicegen.cu",)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

#: C signatures of every launcher: name → (argtypes).
_SIGNATURES = {
    "gen_genotypes_launch": (
        _P, _P, _P, _P, _P, _P, _P,  # xt, kept, rows, vs_keys, fsamp, set, pop
        _I64, _I64, _I64,  # grid_offset, n_valid, spacing
        _U64, _U64, _I32, _U64,  # site_key, ref_thresh, has_min_af, min_af
        _I32, _I32, _I32, _I32, _I32,  # n_pops, n_sets, n_cols, n_cols_pad, ld
        _P,  # stream
    ),
    "gram_accumulate_launch": (_P, _I32, _P, _I32, _I32, _P),
    "devicegen_site_tile": (),
    "devicegen_col_tile": (),
    "devicegen_max_pops": (),
    "devicegen_max_sets": (),
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
    """Where ``source``'s library lives: ``<stem>-<content hash>.so``."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; raises with the
    compiler's output when a build fails. Returns source → library path."""
    out = {source: library_path(source) for source in SOURCES}
    for source, path in out.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}")
        path.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, path)
    return out


def build_log(source: str = "devicegen.cu") -> str:
    """The ``-Xptxas -v`` report of ``source``'s current build."""
    return library_path(source).with_suffix(".log").read_text()


def library(source: str = "devicegen.cu") -> ctypes.CDLL:
    """Load ``source``'s library, built first when missing, with the C
    signatures of its functions declared."""
    lib = ctypes.CDLL(str(build_all()[source]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, kernel: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")


__all__ = ["BUILD_DIR", "SOURCES", "build_all", "build_log", "check", "library"]
