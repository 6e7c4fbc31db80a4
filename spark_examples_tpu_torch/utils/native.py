"""Build and bind the repository's native VCF parser (``native/vcfparse.cpp``).

The port's copy of the VCF half of ``spark_examples_tpu/utils/native.py``:
the C-ABI shared object is compiled at first use with the system C++
compiler and loaded with :mod:`ctypes`. Without a compiler every caller
takes the pure-Python parser of ``sources/files.py``, which gives the same
arrays.

The library lands in ``build/torch_kernels/`` at the repository root, beside
the CUDA libraries, named ``vcfparse-<hash>.so`` by a hash of the source,
the compiler, the flags and the Python version, so an edited source
rebuilds. It never shares the JAX package's cache. A build writes a
per-process temporary file and renames it into place, so concurrent
builders (test workers) race benignly. The parser's sanitizer harness
(``native/sanitize_harness.cpp``) is not built here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

from spark_examples_tpu_torch.ops._kernels import BUILD_DIR

_REPO_NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


class MalformedVcfLine(ValueError):
    """A malformed VCF data line. ``ordinal`` is the 1-based position among
    the data lines of the buffer (or span) that was being parsed; the
    chunk-parallel merge (``sources/files.py``) translates a span-relative
    ordinal to the file-level one the serial parse reports."""

    def __init__(self, ordinal: int):
        super().__init__(f"malformed VCF data line #{int(ordinal)}")
        self.ordinal = int(ordinal)


def _compiler() -> Optional[str]:
    for name in ("g++", "clang++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    return None


def _build(source_path: str, flags: Tuple[str, ...] = ("-O3", "-shared", "-fPIC")) -> str:
    """Compile ``source_path`` to a content-addressed library under
    ``BUILD_DIR`` and return its path, reusing an identical earlier build."""
    compiler = _compiler()
    if compiler is None:
        raise RuntimeError("no C++ compiler on PATH")
    digest = hashlib.sha256()
    with open(source_path, "rb") as f:
        digest.update(f.read())
    digest.update(compiler.encode())
    digest.update(" ".join(flags).encode())
    digest.update(sys.version.encode())
    stem = os.path.splitext(os.path.basename(source_path))[0]
    out = os.path.join(str(BUILD_DIR), f"{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(str(BUILD_DIR), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-std=c++17", "-o", tmp, source_path]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stderr[-2000:]}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return out


def vcf_library() -> Optional[ctypes.CDLL]:
    """The compiled VCF parser, or ``None`` (with the reason recorded) when
    it cannot be built — callers fall back to pure Python."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        path = _build(os.path.join(_REPO_NATIVE, "vcfparse.cpp"))
        # CDLL, never PyDLL: ctypes releases the GIL around CDLL foreign
        # calls, which is what lets the chunk-parallel ingest engine
        # (sources/files.py) run vcf_parse_span concurrently on a thread
        # pool. PyDLL would hold the GIL and serialize every worker.
        lib = ctypes.CDLL(path)
        lib.vcf_scan.restype = ctypes.c_int
        lib.vcf_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.vcf_parse.restype = ctypes.c_int64
        lib.vcf_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.vcf_count_data_lines.restype = ctypes.c_int64
        lib.vcf_count_data_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.vcf_count_data_lines_span.restype = ctypes.c_int64
        lib.vcf_count_data_lines_span.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.vcf_parse_span.restype = ctypes.c_int64
        lib.vcf_parse_span.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.vcf_scan_sites.restype = ctypes.c_int64
        lib.vcf_scan_sites.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.vcf_mark_contig_changes.restype = None
        lib.vcf_mark_contig_changes.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
    except Exception as e:  # no compiler / build failure: fall back
        _lib_error = str(e)
        return None
    return _lib


def native_unavailable_reason() -> Optional[str]:
    vcf_library()
    return _lib_error


def parse_vcf_arrays(text: bytes) -> Optional[Tuple[np.ndarray, ...]]:
    """One native pass over decompressed VCF text.

    Returns ``(contigs (L,) object, positions (L,) i64, ends (L,) i64,
    af (L,) f64 — NaN where INFO has no AF, has_variation (L, N) i8)``, or
    ``None`` when the native library is unavailable. Raises ``ValueError``
    on malformed input (the Python parser raises too — parity includes the
    failure mode).
    """
    lib = vcf_library()
    if lib is None:
        return None
    n_lines = ctypes.c_int64()
    n_samples = ctypes.c_int64()
    # A headerless (sites-only) VCF scans as an empty cohort — the wire
    # parser's behavior; malformed data lines still raise from vcf_parse.
    lib.vcf_scan(
        text, len(text), ctypes.byref(n_lines), ctypes.byref(n_samples)
    )
    L, N = n_lines.value, n_samples.value
    positions = np.empty(L, dtype=np.int64)
    ends = np.empty(L, dtype=np.int64)
    af = np.empty(L, dtype=np.float64)
    has_variation = np.zeros((L, max(N, 1)), dtype=np.int8)
    contig_off = np.empty(L, dtype=np.int64)
    contig_len = np.empty(L, dtype=np.int64)
    parsed = lib.vcf_parse(
        text, len(text), N, positions, ends, af, has_variation,
        contig_off, contig_len,
    )
    if parsed < 0:
        raise MalformedVcfLine(-parsed)
    if parsed != L:
        raise ValueError(f"parsed {parsed} of {L} VCF data lines")
    contigs = np.empty(L, dtype=object)
    for i in range(L):
        contigs[i] = text[
            contig_off[i] : contig_off[i] + contig_len[i]
        ].decode("utf-8")
    return contigs, positions, ends, af, has_variation[:, :N]


def _contig_strings(text: bytes, contig_off, contig_len, rows: int):
    """Per-row contig names decoded run-wise: the native
    ``vcf_mark_contig_changes`` finds run boundaries in C (one memcmp per
    row), so the Python side decodes ONE string per run and ``np.repeat``s
    it — no per-row interpreter work on the streaming hot path. Falls back
    to a per-row loop when the library is unavailable (callers on the
    native path always have it)."""
    contigs = np.empty(rows, dtype=object)
    if rows == 0:
        return contigs
    lib = vcf_library()
    if lib is not None:
        flags = np.empty(rows, dtype=np.int8)
        lib.vcf_mark_contig_changes(text, contig_off, contig_len, rows, flags)
        starts = np.flatnonzero(flags)
        names = np.array(
            [
                text[contig_off[i] : contig_off[i] + contig_len[i]].decode(
                    "utf-8"
                )
                for i in starts
            ],
            dtype=object,
        )
        reps = np.diff(np.append(starts, rows))
        contigs[:] = np.repeat(names, reps)
        return contigs
    current_bytes: bytes = b""
    current_str = ""
    for i in range(rows):
        raw = text[contig_off[i] : contig_off[i] + contig_len[i]]
        if raw != current_bytes:
            current_bytes = raw
            current_str = raw.decode("utf-8")
        contigs[i] = current_str
    return contigs


def parse_vcf_chunk(text: bytes, n_samples: int):
    """Native parse of ONE streamed chunk (no #CHROM header needed: the
    caller learned ``n_samples`` from the header chunk; the chunk must end
    at a line boundary — the streaming reader carries partial lines).

    Returns the same array tuple as :func:`parse_vcf_arrays`, or ``None``
    when the native library is unavailable. Raises ``ValueError`` on a
    malformed data line (1-based ordinal WITHIN the chunk).
    """
    lib = vcf_library()
    if lib is None:
        return None
    L = int(lib.vcf_count_data_lines(text, len(text)))
    positions = np.empty(L, dtype=np.int64)
    ends = np.empty(L, dtype=np.int64)
    af = np.empty(L, dtype=np.float64)
    has_variation = np.zeros((L, max(n_samples, 1)), dtype=np.int8)
    contig_off = np.empty(L, dtype=np.int64)
    contig_len = np.empty(L, dtype=np.int64)
    parsed = lib.vcf_parse(
        text, len(text), n_samples, positions, ends, af, has_variation,
        contig_off, contig_len,
    )
    if parsed < 0:
        raise MalformedVcfLine(-parsed)
    if parsed != L:
        raise ValueError(f"parsed {parsed} of {L} VCF data lines")
    contigs = _contig_strings(text, contig_off, contig_len, L)
    return contigs, positions, ends, af, has_variation[:, :n_samples]


def scan_vcf_counts(text: bytes) -> Optional[Tuple[int, int]]:
    """One native header/line scan: ``(n_data_lines, n_samples)`` for the
    whole buffer (the serial pass the chunk-parallel parse shares with
    :func:`parse_vcf_arrays`, so both resolve the cohort identically —
    including the headerless and repeated-``#CHROM`` edge cases). ``None``
    when the native library is unavailable."""
    lib = vcf_library()
    if lib is None:
        return None
    n_lines = ctypes.c_int64()
    n_samples = ctypes.c_int64()
    lib.vcf_scan(
        text, len(text), ctypes.byref(n_lines), ctypes.byref(n_samples)
    )
    return n_lines.value, n_samples.value


def parse_vcf_span(text: bytes, begin: int, end: int, n_samples: int):
    """Native parse of ONE line-aligned span ``[begin, end)`` of ``text`` —
    the chunk-parallel worker body (``sources/files.py``). No bytes are
    copied: the span is addressed by offset into the shared buffer, and the
    two foreign calls (count + parse) both release the GIL, so N workers
    parse N spans on N cores concurrently.

    Returns the same array tuple as :func:`parse_vcf_chunk`, rows in span
    order. Raises ``ValueError`` on a malformed data line (1-based ordinal
    within the span). ``None`` when the native library is unavailable.
    """
    lib = vcf_library()
    if lib is None:
        return None
    begin, end = int(begin), int(end)
    if not 0 <= begin <= end <= len(text):
        raise ValueError(f"span [{begin}, {end}) outside text of {len(text)}")
    L = int(lib.vcf_count_data_lines_span(text, begin, end))
    positions = np.empty(L, dtype=np.int64)
    ends = np.empty(L, dtype=np.int64)
    af = np.empty(L, dtype=np.float64)
    has_variation = np.zeros((L, max(n_samples, 1)), dtype=np.int8)
    contig_off = np.empty(L, dtype=np.int64)
    contig_len = np.empty(L, dtype=np.int64)
    parsed = lib.vcf_parse_span(
        text, begin, end, n_samples, positions, ends, af, has_variation,
        contig_off, contig_len,
    )
    if parsed < 0:
        raise MalformedVcfLine(-parsed)
    if parsed != L:
        raise ValueError(f"parsed {parsed} of {L} VCF data lines")
    contigs = _contig_strings(text, contig_off, contig_len, L)
    return contigs, positions, ends, af, has_variation[:, :n_samples]


def scan_vcf_sites_chunk(text: bytes):
    """Native site-only scan of one streamed chunk: ``(contigs, positions,
    ends)`` without the per-sample genotype walk — the cheap pass behind
    lazy contig discovery. ``None`` when the native library is unavailable.
    """
    lib = vcf_library()
    if lib is None:
        return None
    L = int(lib.vcf_count_data_lines(text, len(text)))
    positions = np.empty(L, dtype=np.int64)
    ends = np.empty(L, dtype=np.int64)
    contig_off = np.empty(L, dtype=np.int64)
    contig_len = np.empty(L, dtype=np.int64)
    parsed = lib.vcf_scan_sites(
        text, len(text), positions, ends, contig_off, contig_len
    )
    if parsed < 0:
        raise MalformedVcfLine(-parsed)
    contigs = _contig_strings(text, contig_off, contig_len, L)
    return contigs, positions, ends


__all__ = [
    "MalformedVcfLine",
    "vcf_library",
    "native_unavailable_reason",
    "parse_vcf_arrays",
    "parse_vcf_chunk",
    "parse_vcf_span",
    "scan_vcf_counts",
    "scan_vcf_sites_chunk",
]
