"""Deterministic fault-injection harness.

The port's copy of ``spark_examples_tpu/utils/faults.py``: the same plan
grammar, the same environment variable (``SPARK_EXAMPLES_TPU_FAULTS``) and
the same closed catalogues of sites, key for key, so one plan string
parses and fires identically in both packages. The ``serve.*`` and
``analysis.*`` points keep their reference keys; the port fires those
whose code it has (``analysis.pre-manifest`` in ``analyses/base.py``).

A **fault plan** — a short spec string, activated by the environment
variable or ``--fault-plan`` — names exactly which registered site fires
which fault on which occurrence, and nothing else in the process changes.
With no plan configured every hook is a cheap no-op (one dict lookup on a
``None``), so the hooks stay in production code paths permanently.

Spec grammar (comma-separated entries)::

    action@site[#nth][=arg]

    kill@driver.post-flush            # SIGKILL self at the 1st hit
    kill@checkpoint.mid-write#2       # ... at the 2nd hit of that site
    raise@driver.pre-finalize         # raise InjectedFault (an Exception)
    crash@serve.worker.mid-job        # raise InjectedWorkerCrash (a
                                      #   BaseException: escapes `except
                                      #   Exception` — a dead thread)
    ioerror@files.read#3              # raise OSError at an IO boundary
    truncate@files.read=4096          # truncate that read to 4096 bytes
    slow@rest.post=0.05               # sleep 0.05s at that boundary

Each entry fires exactly once, at the ``nth`` (default 1st) hit of its
site — the plan is a deterministic schedule, not a probability. Sites are
**registered**: :data:`KILL_POINTS` and :data:`IO_POINTS` are the closed
catalogues (a typo'd site name in a plan raises at configure time, and a
typo'd site name in code raises at the hook call), so the chaos test
matrix in ``tests/test_faults.py`` can enumerate every kill-point and
know the list is complete.

Two hook shapes:

- :func:`kill_point(site)` — control-flow points (the driver's
  checkpoint/finalize seams, the serve worker's claim/mid-job seams).
  Supports ``kill`` / ``raise`` / ``crash``.
- :func:`io_point(site, data=None)` — data-plane boundaries (source
  reads, REST posts). Supports ``ioerror`` / ``truncate`` / ``slow``
  (plus ``kill``), and returns the possibly-truncated payload.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

#: Registered control-flow kill-points (site → where it lives). The chaos
#: matrix (``tests/test_torch_gramian_checkpoint.py``) iterates the
#: driver.* and checkpoint.* entries and asserts kill + resume parity at
#: each. The six serve.* sites fire in ``serve/daemon.py`` at the
#: reference's places; ``tests/test_torch_serve_replicas_chaos.py`` kills a
#: replica daemon at ``serve.worker.claim`` and ``serve.lease.pre-renew``
#: and holds the survivor's outcome to a clean run's.
KILL_POINTS: Dict[str, str] = {
    "driver.post-flush": (
        "pipeline/checkpoint.py:GramianFeeder.save — after the accumulator "
        "flushed and synced, before the checkpoint artifact write begins"
    ),
    "checkpoint.mid-write": (
        "pipeline/checkpoint.py:save_gramian_checkpoint — after the temp "
        "file is fully written, before the atomic os.replace publish"
    ),
    "checkpoint.post-save": (
        "pipeline/checkpoint.py:save_gramian_checkpoint — after the atomic "
        "publish, before the feeder records the new cursor"
    ),
    "driver.pre-finalize": (
        "pipeline/pca_driver.py:_finish_checkpointing — every ingested row accumulated (final "
        "checkpoint written when enabled), before the finalize reduce"
    ),
    "serve.worker.claim": (
        "serve/daemon.py:_run_job — job claimed and flipped to running, "
        "BEFORE any device work (the requeue-eligible window)"
    ),
    "serve.worker.mid-job": (
        "serve/daemon.py:_run_job — device work marked begun, executor "
        "about to run (a crash here must NOT be requeued)"
    ),
    "serve.lease.pre-renew": (
        "serve/daemon.py:_lease_tick — this replica owns >= 1 job lease "
        "and is about to renew them (a kill here is the canonical host "
        "loss: every lease expires unrenewed and a peer replica steals "
        "the jobs)"
    ),
    "serve.steal.pre-claim": (
        "serve/daemon.py:_steal_expired — an expired foreign lease was "
        "identified and the fencing epoch is about to be link-claimed "
        "(a kill here must leave the job claimable by any other replica "
        "— no half-taken lease)"
    ),
    "serve.submit.post-accept": (
        "serve/daemon.py:submit — the accepted record is durably "
        "journaled, the lease NOT yet claimed (a kill here strands an "
        "accepted-but-never-leased job: the orphan-adoption branch of "
        "the steal scan must reclaim it via the dead owner's stale "
        "heartbeat)"
    ),
    "serve.lease.post-claim": (
        "serve/daemon.py:submit/_replay_journal/_steal_one — a lease "
        "epoch was link-claimed on disk, its journal `lease` record NOT "
        "yet appended (a kill here leaves an unjournaled lease file: "
        "the fold's fence stays below the claimed epoch until a later "
        "claimant re-journals above it, and the expired file itself "
        "makes the job stealable)"
    ),
    "analysis.pre-manifest": (
        "analyses/base.py:finish_analysis_run — every site streamed and "
        "every per-site output published, before the warm-ledger record "
        "and the manifest write (a kill here must leave the atomic "
        "outputs complete and the manifest absent, never half-written)"
    ),
}

#: Registered IO-boundary fault sites.
IO_POINTS: Dict[str, str] = {
    "files.read": (
        "sources/stream.py:iter_byte_windows — one streamed read window, "
        "EVERY file ingest path (wire tables, packed staging, streaming; "
        "truncate simulates a truncated file; ioerror a failing disk)"
    ),
    "rest.post": (
        "sources/rest.py:RestClient._post — one transport attempt "
        "(ioerror exercises the retry/backoff loop)"
    ),
}

#: IO points whose hook carries a byte payload ``truncate`` can shorten.
#: ``rest.post`` passes no data — a truncate there would be a silent no-op
#: that still counts as fired, so the grammar rejects it.
TRUNCATE_IO_POINTS = ("files.read",)

_ACTIONS = ("kill", "raise", "crash", "ioerror", "truncate", "slow")
_KILL_ACTIONS = ("kill", "raise", "crash")
_IO_ACTIONS = ("kill", "ioerror", "truncate", "slow")

ENV_VAR = "SPARK_EXAMPLES_TPU_FAULTS"


class FaultSpecError(ValueError):
    """A malformed fault-plan spec (bad grammar, unknown site/action)."""


class InjectedFault(RuntimeError):
    """The ``raise`` action: an ordinary exception a driver run surfaces
    as a failed run (normal error handling applies)."""


class InjectedWorkerCrash(BaseException):
    """The ``crash`` action: deliberately NOT an :class:`Exception`, so it
    escapes ``except Exception`` job-failure handling and kills the thread
    it fires on — the reproducible stand-in for a worker thread dying."""


@dataclass
class _Entry:
    action: str
    site: str
    nth: int
    arg: Optional[str]
    fired: bool = False


def parse_plan(spec: str) -> List[_Entry]:
    """Parse one plan spec; raises :class:`FaultSpecError` on bad grammar,
    unknown sites, unknown actions, or an action/site shape mismatch."""
    entries: List[_Entry] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        body, arg = (raw.split("=", 1) + [None])[:2] if "=" in raw else (raw, None)
        head, nth_text = (
            body.split("#", 1) if "#" in body else (body, "1")
        )
        if "@" not in head:
            raise FaultSpecError(
                f"fault entry {raw!r} is not action@site[#nth][=arg]"
            )
        action, site = head.split("@", 1)
        if action not in _ACTIONS:
            raise FaultSpecError(
                f"unknown fault action {action!r} (one of {_ACTIONS})"
            )
        if site in KILL_POINTS:
            if action not in _KILL_ACTIONS:
                raise FaultSpecError(
                    f"action {action!r} is not valid at kill-point {site!r} "
                    f"(one of {_KILL_ACTIONS})"
                )
        elif site in IO_POINTS:
            if action not in _IO_ACTIONS:
                raise FaultSpecError(
                    f"action {action!r} is not valid at IO point {site!r} "
                    f"(one of {_IO_ACTIONS})"
                )
        else:
            raise FaultSpecError(
                f"unknown fault site {site!r}; registered sites: "
                f"{sorted(KILL_POINTS) + sorted(IO_POINTS)}"
            )
        try:
            nth = int(nth_text)
        except ValueError:
            raise FaultSpecError(f"bad occurrence count in {raw!r}") from None
        if nth < 1:
            raise FaultSpecError(f"occurrence count must be >= 1 in {raw!r}")
        if action == "truncate":
            if arg is None or not arg.isdigit():
                raise FaultSpecError(
                    f"truncate needs =BYTES, got {raw!r}"
                )
            if site not in TRUNCATE_IO_POINTS:
                raise FaultSpecError(
                    f"truncate has no payload to shorten at {site!r} "
                    f"(valid at {TRUNCATE_IO_POINTS})"
                )
        if action == "slow":
            try:
                float(arg if arg is not None else "")
            except ValueError:
                raise FaultSpecError(
                    f"slow needs =SECONDS, got {raw!r}"
                ) from None
        entries.append(_Entry(action=action, site=site, nth=nth, arg=arg))
    return entries


# lock order: fault-plan lock is a leaf — nothing else is acquired while
# holding it (hit counting and entry matching only; actions fire OUTSIDE).
_lock = threading.Lock()
_UNSET = object()
_plan_entries: object = _UNSET  # _UNSET | None | List[_Entry]
_hits: Dict[str, int] = {}
_injected = 0

#: Pre-fire flush hooks: every registered hook runs IMMEDIATELY BEFORE a
#: matched fault fires — for the ``kill`` action that is the last Python
#: the process executes, so telemetry that must survive the crash (the
#: reference's flight recorder) reaches disk before the SIGKILL the chaos
#: harness is about to assert recovery from. Hooks must be cheap, must
#: not raise (exceptions are swallowed: a telemetry bug must not turn a
#: deterministic kill-point into a different crash), and run on the
#: faulting thread.
_flush_hooks: List[Callable[[], None]] = []


def add_flush_hook(fn: Callable[[], None]) -> None:
    """Register a pre-fire flush hook (idempotent per callable)."""
    with _lock:
        if fn not in _flush_hooks:
            _flush_hooks.append(fn)


def remove_flush_hook(fn: Callable[[], None]) -> None:
    with _lock:
        if fn in _flush_hooks:
            _flush_hooks.remove(fn)


def _run_flush_hooks() -> None:
    with _lock:
        hooks = list(_flush_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:
            pass


def configure(spec: Optional[str]) -> None:
    """(Re)configure the process-wide fault plan. ``None``/empty disables.
    Resets per-site hit counts and the injected-fault counter — each
    configure starts a fresh deterministic schedule."""
    global _plan_entries, _injected
    entries = parse_plan(spec) if spec else None
    with _lock:
        _plan_entries = entries
        _hits.clear()
        _injected = 0


def _entries() -> Optional[List[_Entry]]:
    """The active plan, lazily parsed from the environment on first use."""
    global _plan_entries
    with _lock:
        if _plan_entries is _UNSET:
            spec = os.environ.get(ENV_VAR)
            _plan_entries = parse_plan(spec) if spec else None
        return _plan_entries  # type: ignore[return-value]


def active() -> bool:
    """Whether a non-empty fault plan is configured."""
    entries = _entries()
    return bool(entries)


def injected_count() -> int:
    """How many faults actually fired in this process so far — recorded in
    the run manifest's ``resume.faults_injected`` field."""
    with _lock:
        return _injected


def _match(site: str) -> Optional[_Entry]:
    """Count one hit of ``site``; return the entry that fires now, if any.
    Pure bookkeeping under the leaf lock — the action runs at the caller."""
    global _injected
    entries = _entries()
    if not entries:
        return None
    with _lock:
        count = _hits.get(site, 0) + 1
        _hits[site] = count
        for entry in entries:
            if entry.site == site and not entry.fired and entry.nth == count:
                entry.fired = True
                _injected += 1
                return entry
    return None


def _fire_control(entry: _Entry) -> None:
    if entry.action == "kill":
        # A real crash: no atexit, no finally blocks, no flushes — the
        # exact shape of an OOM-kill or a preemption. The chaos matrix
        # asserts recovery from THIS, not from polite exceptions.
        os.kill(os.getpid(), signal.SIGKILL)
    if entry.action == "crash":
        raise InjectedWorkerCrash(f"injected worker crash at {entry.site}")
    raise InjectedFault(f"injected fault at {entry.site}")


def kill_point(site: str) -> None:
    """One registered control-flow kill-point. No-op without a matching
    plan entry; fires ``kill``/``raise``/``crash`` when one matches."""
    if site not in KILL_POINTS:
        raise KeyError(f"unregistered kill-point {site!r}")
    entry = _match(site)
    if entry is not None:
        _run_flush_hooks()
        _fire_control(entry)


def io_point(site: str, data: Optional[bytes] = None) -> Optional[bytes]:
    """One registered IO-boundary site; returns ``data`` (possibly
    truncated). ``ioerror`` raises :class:`OSError`, ``slow`` sleeps,
    ``truncate`` shortens the payload, ``kill`` SIGKILLs."""
    if site not in IO_POINTS:
        raise KeyError(f"unregistered IO point {site!r}")
    entry = _match(site)
    if entry is None:
        return data
    if entry.action == "kill":
        _run_flush_hooks()
        os.kill(os.getpid(), signal.SIGKILL)
    if entry.action == "ioerror":
        raise OSError(f"injected IO error at {site}")
    if entry.action == "slow":
        time.sleep(float(entry.arg or 0))
        return data
    # truncate
    limit = int(entry.arg or 0)
    return data[:limit] if data is not None else data


def snapshot() -> Tuple[int, Dict[str, int]]:
    """(injected_count, per-site hit counts) — test introspection."""
    with _lock:
        return _injected, dict(_hits)


__all__ = [
    "ENV_VAR",
    "KILL_POINTS",
    "IO_POINTS",
    "TRUNCATE_IO_POINTS",
    "FaultSpecError",
    "InjectedFault",
    "InjectedWorkerCrash",
    "parse_plan",
    "configure",
    "active",
    "injected_count",
    "add_flush_hook",
    "remove_flush_hook",
    "kill_point",
    "io_point",
    "snapshot",
]
