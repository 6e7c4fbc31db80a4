"""Sanitizer replay of the native parser (``graftcheck sanitize``).

The port's copy of ``spark_examples_tpu/check/sanitize.py``. The native
VCF parser (``native/vcfparse.cpp``) runs its span entry points with the
GIL released on a thread pool over one shared buffer (the chunk-parallel
parse of ``sources/files.py``). Its safety claims — no out-of-bounds
writes sizing arrays from the pre-scan, no undefined behaviour in the
integer and float parsing, no data races between span workers — are the
claims compilers can instrument. This module builds the standalone
harness (``utils/native.py:build_sanitizer_harness``) under each requested
sanitizer and replays the deterministic fuzz corpus (``check/corpus.py``)
through it, with the reference's outcomes, lines and exit codes.

A missing toolchain degrades gracefully: no compiler → the run reports a
SKIP and exits 0, unless ``--strict`` says the machine is supposed to have
one (exit 2), so a missing toolchain cannot pass for a clean replay.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

from spark_examples_tpu_torch.check.corpus import corpus_documents

#: Per-mode runtime options: deterministic, fail-fast, and quiet enough to
#: read. Leak checking stays off — the harness frees everything it owns,
#: but the one-time C runtime and locale allocations below it are not ours
#: to assert on, and the replay's subject is overflows and races, not leaks.
_SANITIZER_ENV: Dict[str, Dict[str, str]] = {
    "asan": {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=0:exitcode=99"},
    "ubsan": {"UBSAN_OPTIONS": "print_stacktrace=1"},
    "tsan": {"TSAN_OPTIONS": "halt_on_error=1:exitcode=99"},
}

DEFAULT_MODES = ("asan", "ubsan", "tsan")


def replay_corpus(
    mode: str, corpus: Optional[Sequence[bytes]] = None, timeout: float = 300.0
) -> subprocess.CompletedProcess:
    """Build the ``mode`` harness and replay the corpus through it in one
    subprocess. Raises ``RuntimeError`` when the harness cannot build and
    ``subprocess.TimeoutExpired`` when it runs past ``timeout`` seconds."""
    from spark_examples_tpu_torch.utils.native import build_sanitizer_harness

    harness = build_sanitizer_harness(mode)
    docs = corpus_documents() if corpus is None else list(corpus)
    with tempfile.TemporaryDirectory(prefix=f"graftcheck-{mode}-") as d:
        paths: List[str] = []
        for i, doc in enumerate(docs):
            path = os.path.join(d, f"corpus-{i:03d}.vcf")
            with open(path, "wb") as f:
                f.write(doc)
            paths.append(path)
        env = dict(os.environ)
        env.update(_SANITIZER_ENV.get(mode, {}))
        return subprocess.run(
            [harness, *paths],
            capture_output=True,
            text=True,
            timeout=timeout,
            env=env,
        )


def run_sanitize(
    modes: Sequence[str] = DEFAULT_MODES, strict: bool = False
) -> int:
    """Replay the corpus under each sanitizer mode and print one line a
    mode; returns the CLI's exit code (0 clean or skipped, 1 a violation,
    2 no compiler under ``strict``)."""
    from spark_examples_tpu_torch.utils.native import _compiler

    if _compiler() is None:
        message = (
            "graftcheck sanitize: SKIP (no C++ compiler on PATH; the "
            "native layer itself falls back to pure Python on this image)"
        )
        print(message)
        return 2 if strict else 0
    n_docs = len(corpus_documents())
    failures = 0
    for mode in modes:
        try:
            proc = replay_corpus(mode)
        except subprocess.TimeoutExpired as e:
            # A hung harness is the bug class this stage hunts (a
            # lock-order deadlock in the span entry points): a per-mode
            # FAIL, never a traceback that aborts the remaining modes.
            failures += 1
            print(
                f"graftcheck sanitize[{mode}]: FAIL (harness hung past "
                f"{e.timeout:.0f}s — deadlock suspected)"
            )
            continue
        except RuntimeError as e:
            # A present compiler that cannot produce this mode (no tsan
            # runtime, say) is a per-mode skip, not a failure — unless the
            # operator demanded the full matrix.
            print(f"graftcheck sanitize[{mode}]: SKIP ({e})")
            if strict:
                failures += 1
            continue
        if proc.returncode == 0:
            print(
                f"graftcheck sanitize[{mode}]: OK — {n_docs} corpus "
                "documents replayed clean"
            )
        else:
            failures += 1
            print(
                f"graftcheck sanitize[{mode}]: FAIL "
                f"(exit {proc.returncode})"
            )
            tail = (proc.stderr or proc.stdout or "").strip()
            if tail:
                print(tail[-4000:])
    return 1 if failures else 0


__all__ = ["DEFAULT_MODES", "replay_corpus", "run_sanitize"]
