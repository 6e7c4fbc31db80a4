"""Baseline-gated static typing (``graftcheck typecheck``).

The port's copy of ``spark_examples_tpu/check/typecheck.py``, over the
port's typed core. ``mypy`` runs gated by a COMMITTED baseline
(``check/mypy_baseline.txt``, the port's own): errors present in the
baseline are existing debt and pass; any error NOT in the baseline fails
the gate. The baseline stores normalized lines (``path: severity: message
[code]`` — no line numbers, so unrelated edits that shift lines don't
invalidate it). Shrink the baseline as debt is paid by re-running with
``--update-baseline``.

Two tiers, one gate:

- ``TARGETS`` (``config.py``) run with the permissive flag set — the
  user-facing flag contract, annotated but not yet strict;
- ``STRICT_TARGETS`` (the whole ``check/`` subsystem and ``obs/``) run
  under ``--strict``: the checker that gates everyone else's code and the
  telemetry layer hold themselves to the highest tier.

Where ``mypy`` is not installed the gate prints the reference's skip
notice and exits 0 — a missing optional tool fails nothing — unless
``--strict`` says the environment is supposed to have it (exit 2). The
gate never installs anything.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple  # noqa: F401

_CHECK_DIR = os.path.dirname(os.path.abspath(__file__))
_PACKAGE_DIR = os.path.dirname(_CHECK_DIR)
BASELINE_PATH = os.path.join(_CHECK_DIR, "mypy_baseline.txt")

#: The permissive tier: config parsing (the user-facing contract); the
#: numerics modules earn coverage as annotations land.
TARGETS = (
    os.path.join(_PACKAGE_DIR, "config.py"),
    os.path.join(_PACKAGE_DIR, "parallel", "mesh.py"),
)

#: The ``--strict`` tier: the checker itself (it gates everyone else's
#: code, so it holds itself to the highest standard — ``check/hostmem.py``
#: rides in with the directory), the telemetry subsystem (its
#: registry/manifest types ARE its wire contract), and the ONE windowed
#: stream abstraction (``sources/stream.py`` — every ingest path's
#: residency proof rests on it, so its types are load-bearing).
#: ``parallel/mesh.py`` joins the permissive tier below for its two
#: audited formulas (``ring_traffic_bytes``, ``host_peak_bytes``) whose
#: argument types are plan-validator contract.
STRICT_TARGETS = (
    _CHECK_DIR,
    os.path.join(_PACKAGE_DIR, "obs"),
    os.path.join(_PACKAGE_DIR, "sources", "stream.py"),
)

_MYPY_FLAGS = (
    "--ignore-missing-imports",
    "--no-error-summary",
    "--no-color-output",
    "--hide-error-context",
)

#: ``--strict`` minus the follow-imports noise: strict targets import the
#: (unannotated) numerics modules, whose debt belongs to THEIR tier, not
#: this one.
_STRICT_FLAGS = _MYPY_FLAGS + (
    "--strict",
    "--follow-imports=silent",
)

_LINE_RE = re.compile(r"^(?P<path>[^:]+):(?P<line>\d+):(?:\d+:)?\s*(?P<rest>.*)$")


def _normalize(raw_line: str) -> Optional[str]:
    """``path:123: error: msg [code]`` → ``path: error: msg [code]`` with
    the path made repo-relative (so the committed baseline matches across
    checkouts); None for non-diagnostic lines."""
    m = _LINE_RE.match(raw_line.strip())
    if not m:
        return None
    path = m.group("path")
    if os.path.isabs(path):
        # mypy echoes the absolute TARGETS verbatim; anchor to the repo
        # root (the package's parent) so baselines are machine-portable.
        repo_root = os.path.dirname(_PACKAGE_DIR)
        try:
            path = os.path.relpath(path, repo_root)
        except ValueError:
            pass  # different drive (Windows); keep as-is
    path = path.replace(os.sep, "/")
    if path.startswith("./"):
        path = path[2:]
    return f"{path}: {m.group('rest')}"


def _load_baseline() -> List[str]:
    if not os.path.exists(BASELINE_PATH):
        return []
    with open(BASELINE_PATH, "r", encoding="utf-8") as f:
        return [
            line.strip()
            for line in f
            if line.strip() and not line.startswith("#")
        ]


def _mypy_invocation(
    flags: Sequence[str], targets: Sequence[str]
) -> Optional[Tuple[List[str], str]]:
    cmd = [sys.executable, "-m", "mypy", *flags, *targets]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=600
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"<mypy invocation failed: {e}>"], str(e)
    if "No module named mypy" in (proc.stderr or ""):
        return None  # not installed (CPython reports it with rc=1)
    if proc.returncode not in (0, 1):
        return (
            [f"<mypy crashed rc={proc.returncode}>"],
            (proc.stderr or proc.stdout or "")[-2000:],
        )
    diagnostics = []
    for line in (proc.stdout or "").splitlines():
        norm = _normalize(line)
        if norm is not None and ": error:" in norm:
            diagnostics.append(norm)
    return diagnostics, proc.stdout or ""


def _run_mypy() -> Optional[Tuple[List[str], str]]:
    """→ (normalized diagnostics from both tiers, raw output), or None when
    mypy is not installed. The strict tier's diagnostics merge into the one
    baseline — a single gate, two strictness levels."""
    base = _mypy_invocation(_MYPY_FLAGS, TARGETS)
    if base is None:
        return None
    strict = _mypy_invocation(_STRICT_FLAGS, STRICT_TARGETS)
    if strict is None:
        return base
    return base[0] + strict[0], base[1] + strict[1]


def run_typecheck(strict: bool = False, update_baseline: bool = False) -> int:
    result = _run_mypy()
    if result is None:
        print(
            "graftcheck typecheck: SKIP (mypy not installed; "
            "`pip install mypy` to enable the gate)"
        )
        return 2 if strict else 0
    diagnostics, _raw = result
    if update_baseline:
        with open(BASELINE_PATH, "w", encoding="utf-8") as f:
            f.write(
                "# mypy baseline for graftcheck typecheck — existing debt,\n"
                "# line-number-free (see check/typecheck.py). Regenerate\n"
                "# with: python -m spark_examples_tpu_torch graftcheck typecheck "
                "--update-baseline\n"
            )
            for line in sorted(set(diagnostics)):
                f.write(line + "\n")
        print(
            f"graftcheck typecheck: baseline updated "
            f"({len(set(diagnostics))} entries)"
        )
        return 0
    baseline = set(_load_baseline())
    new = [d for d in diagnostics if d not in baseline]
    fixed = sorted(baseline - set(diagnostics))
    if fixed:
        print(
            f"graftcheck typecheck: {len(fixed)} baseline entr"
            f"{'y is' if len(fixed) == 1 else 'ies are'} fixed — shrink "
            "check/mypy_baseline.txt (--update-baseline)"
        )
    if new:
        print(f"graftcheck typecheck: {len(new)} NEW error(s):")
        for line in new:
            print(f"  {line}")
        return 1
    print(
        f"graftcheck typecheck: OK ({len(diagnostics)} diagnostic(s), "
        f"all in baseline)"
    )
    return 0


__all__ = ["BASELINE_PATH", "STRICT_TARGETS", "TARGETS", "run_typecheck"]
