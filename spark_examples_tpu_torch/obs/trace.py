"""End-to-end distributed tracing: trace ids + the merged Chrome trace.

The port's copy of ``spark_examples_tpu/obs/trace.py``. Per-process spans
(``obs/spans.py``) die with their process, and one run (or one served
job) may cross several processes. This module is the fleet-level view:

- **trace context**: a :func:`mint_trace_id` hex id is minted where a
  job enters the system (the serve daemon's submit client — or at
  admission for clients that send none), carried as the ``X-Trace-Id`` HTTP header
  (the daemon's HTTP front end), stamped on the job and its journal ``accepted``
  record (``serve/journal.py``), and therefore onto every flight-recorder
  event and across every replica steal: one job = one trace id = one
  span tree, no matter which replicas touched it;
- **the merged trace** (:func:`merge_run_trace`): journals + flight-
  recorder segments (``obs/recorder.py``) from one shared run directory
  become a single Chrome-trace/Perfetto JSON — replicas as processes,
  executor slices as threads, job spans as complete ``X`` events, steals
  as ``s``/``f`` flow arrows from the dead owner's last recorded event to
  the stealer's claim. A span whose ``E`` died with its process (the
  ``kill -9`` the chaos harness loves) is closed at its replica's last
  recorded instant and marked ``truncated`` — the export never contains
  an orphan span;
- **the validator** (:func:`validate_chrome_trace`): the structural
  contract CI enforces on every exported trace — every ``B`` paired with
  a matching ``E``, every flow ``s`` paired with exactly one ``f`` (no
  orphan arrows), sane phases/timestamps throughout;
- **the CLI** (:func:`export_main`): ``python -m
  spark_examples_tpu_torch trace export --run-dir DIR [--out FILE]`` — load the result into
  ``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from spark_examples_tpu_torch.obs.recorder import read_segments, trace_dir

#: The propagation header (the daemon's client sends it, its HTTP front end
#: reads it). A simple hex id, not W3C traceparent: there is exactly one
#: hop and no sampling flags to carry.
TRACE_HEADER = "X-Trace-Id"

#: Accepted trace-id grammar (client-sent ids are untrusted input that
#: ends up in journal records and file contents — bounded hex only).
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")

#: Chrome-trace phases the validator accepts.
_KNOWN_PHASES = frozenset({"X", "B", "E", "i", "I", "s", "t", "f", "M"})


def mint_trace_id() -> str:
    """A fresh 128-bit lowercase-hex trace id."""
    return os.urandom(16).hex()


def normalize_trace_id(value) -> Optional[str]:
    """A validated, lowercased trace id, or ``None`` when the input is
    absent or violates the grammar (the caller then mints a fresh one —
    a malformed header must never abort an admission)."""
    if not isinstance(value, str):
        return None
    value = value.strip().lower()
    return value if _TRACE_ID_RE.match(value) else None


# ------------------------------------------------------------------ merge


def _micros(ts: float, origin: float) -> int:
    return int(round((ts - origin) * 1e6))


def _journal_facts(run_dir: str) -> Dict[str, Dict]:
    """Fold the shared journal's raw records into per-job correlation
    facts: trace id, highest lease epoch per replica, stolen flags, and
    the fenced terminal status (mirroring ``replay_journal``'s epoch
    fencing so the summary's "final state" is the one the fleet honors)."""
    from spark_examples_tpu_torch.serve.journal import (
        iter_journal_records,
        journal_path,
    )

    jobs: Dict[str, Dict] = {}
    for record in iter_journal_records(journal_path(run_dir)):
        job_id = record.get("id")
        if not isinstance(job_id, str):
            continue
        job = jobs.setdefault(
            job_id,
            {
                "trace": None,
                "lease_epoch": 0,
                "leases": [],
                "stolen": False,
                "began": False,
                "terminals": [],
                "status": None,
            },
        )
        event = record.get("event")
        if event == "accepted":
            trace = record.get("trace")
            if isinstance(trace, str):
                job["trace"] = trace
        elif event == "began":
            job["began"] = True
        elif event == "lease":
            epoch = record.get("epoch")
            if isinstance(epoch, int):
                job["lease_epoch"] = max(job["lease_epoch"], epoch)
                job["leases"].append(
                    {
                        "epoch": epoch,
                        "replica": record.get("replica"),
                        "stolen": bool(record.get("stolen")),
                    }
                )
                if record.get("stolen"):
                    job["stolen"] = True
        elif event == "terminal":
            epoch = record.get("epoch")
            job["terminals"].append(
                (
                    epoch if isinstance(epoch, int) else None,
                    record.get("status"),
                )
            )
    for job in jobs.values():
        fence = job["lease_epoch"]
        for epoch, status in job["terminals"]:
            if epoch is None or epoch >= fence:
                job["status"] = status
        del job["terminals"]
    return jobs


def merge_run_trace(run_dir: str) -> Dict:
    """One Chrome-trace document from a run directory's flight-recorder
    segments + shared journal; see the module docstring for the mapping.
    Raises ``FileNotFoundError`` when the run dir has neither a trace
    directory nor a journal to merge."""
    events = read_segments(run_dir)
    from spark_examples_tpu_torch.serve.journal import journal_path

    have_journal = os.path.exists(journal_path(run_dir))
    if not events and not have_journal:
        raise FileNotFoundError(
            f"nothing to merge: no segments under {trace_dir(run_dir)!r} "
            f"and no journal at {journal_path(run_dir)!r}"
        )
    facts = _journal_facts(run_dir) if have_journal else {}

    origin = min((e["ts"] for e in events), default=0.0)
    replicas = sorted({e["replica"] for e in events})
    pid_of = {replica: i + 1 for i, replica in enumerate(replicas)}
    tid_of: Dict[Tuple[str, str], int] = {}
    for replica in replicas:
        names = sorted(
            {e.get("tid", "control") for e in events if e["replica"] == replica}
        )
        for i, tid_name in enumerate(names):
            tid_of[(replica, tid_name)] = i + 1

    out: List[Dict] = []
    for replica in replicas:
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid_of[replica],
                "tid": 0,
                "args": {"name": f"replica {replica}"},
            }
        )
        for (rep, tid_name), tid in tid_of.items():
            if rep == replica:
                out.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": pid_of[replica],
                        "tid": tid,
                        "args": {"name": tid_name},
                    }
                )

    # Span pairing: B/E matched per (replica, job, name) in timestamp
    # order; a B whose E died with its process closes at the replica's
    # last recorded timestamp, marked truncated — no orphan spans leave
    # this function (the acceptance contract of the chaos export).
    last_ts: Dict[str, float] = {}
    for event in events:
        last_ts[event["replica"]] = max(
            last_ts.get(event["replica"], event["ts"]), event["ts"]
        )
    open_spans: Dict[Tuple[str, str, str], List[Dict]] = {}
    #: Every event per (replica, job) in timestamp order — the steal
    #: arrows below anchor on the owner's last event AT OR BEFORE the
    #: steal, not its globally-last one (a deposed-but-alive zombie
    #: keeps recording after the steal).
    job_events: Dict[Tuple[str, str], List[Dict]] = {}

    def _common(event: Dict) -> Dict:
        entry: Dict = {
            "name": event["name"],
            "pid": pid_of[event["replica"]],
            "tid": tid_of[(event["replica"], event.get("tid", "control"))],
            "ts": _micros(event["ts"], origin),
        }
        args = dict(event.get("args") or {})
        for key in ("trace", "job"):
            if event.get(key) is not None:
                args[key] = event[key]
        args["replica"] = event["replica"]
        entry["args"] = args
        return entry

    steal_events: List[Dict] = []
    for event in events:
        key = (event["replica"], event.get("job") or "", event["name"])
        if event.get("job") is not None:
            job_events.setdefault(
                (event["replica"], event["job"]), []
            ).append(event)
        if event["ph"] == "B":
            open_spans.setdefault(key, []).append(event)
            continue
        if event["ph"] == "E":
            stack = open_spans.get(key)
            if stack:
                begin = stack.pop()
                entry = _common(begin)
                entry["ph"] = "X"
                entry["dur"] = max(
                    0, _micros(event["ts"], origin) - entry["ts"]
                )
                entry["args"].update(dict(event.get("args") or {}))
                out.append(entry)
            else:
                # An end whose begin predates the recorder (or was dropped
                # by the ring): surfaced as an instant, never invented as
                # a span.
                entry = _common(event)
                entry["ph"] = "i"
                entry["s"] = "t"
                entry["args"]["unmatched_end"] = True
                out.append(entry)
            continue
        # Instants.
        entry = _common(event)
        entry["ph"] = "i"
        entry["s"] = "t"
        out.append(entry)
        if event["name"] == "steal":
            steal_events.append(event)

    truncated = 0
    for (replica, _job, _name), stack in open_spans.items():
        for begin in stack:
            entry = _common(begin)
            entry["ph"] = "X"
            entry["dur"] = max(
                0, _micros(last_ts[replica], origin) - entry["ts"]
            )
            entry["args"]["truncated"] = True
            out.append(entry)
            truncated += 1

    # Steal edges: a flow arrow from the dead owner's last recorded event
    # for the job to the stealer's claim. The anchor is the owner's last
    # event AT OR BEFORE the steal (a deposed-but-alive zombie may keep
    # recording after it); under cross-host clock skew where EVERY owner
    # event postdates the steal, the earliest one anchors — a skewed
    # arrow beats a missing edge. A replica whose recorder never reached
    # disk contributes no arrow (the journal summary still names the
    # steal).
    arrows = 0
    for event in steal_events:
        job_id = event.get("job")
        owner = (event.get("args") or {}).get("from")
        if not job_id or not isinstance(owner, str) or owner not in pid_of:
            continue
        candidates = job_events.get((owner, job_id))
        if not candidates:
            continue
        anchor = next(
            (
                e
                for e in reversed(candidates)
                if e["ts"] <= event["ts"]
            ),
            candidates[0],
        )
        arrows += 1
        flow_name = f"steal {job_id}"
        out.append(
            {
                "ph": "s",
                "cat": "steal",
                "name": flow_name,
                "id": arrows,
                "pid": pid_of[owner],
                "tid": tid_of[(owner, anchor.get("tid", "control"))],
                "ts": _micros(anchor["ts"], origin),
            }
        )
        out.append(
            {
                "ph": "f",
                "bp": "e",
                "cat": "steal",
                "name": flow_name,
                "id": arrows,
                "pid": pid_of[event["replica"]],
                "tid": tid_of[(event["replica"], event.get("tid", "control"))],
                "ts": _micros(event["ts"], origin),
            }
        )

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_dir": os.path.abspath(run_dir),
            "origin_unix": origin,
            "replicas": replicas,
            "recorder_events": len(events),
            "truncated_spans": truncated,
            "steal_arrows": arrows,
            "jobs": facts,
        },
    }


# --------------------------------------------------------------- validate


def validate_chrome_trace(doc) -> List[str]:
    """Structural validation of a Chrome-trace document; returns the list
    of problems (empty = well-formed). The contract CI enforces on every
    exported trace: known phases, numeric timestamps, every ``B`` closed
    by a matching ``E`` in order (durations ``X`` need no pairing), and
    every flow arrow whole — exactly one ``s`` and one ``f`` per id."""
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return ["trace is not an object with a 'traceEvents' list"]
    stacks: Dict[Tuple, List[str]] = {}
    flows: Dict[object, Dict[str, int]] = {}
    for i, event in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(event, dict):
            errors.append(f"{where} is not an object")
            continue
        ph = event.get("ph")
        if ph not in _KNOWN_PHASES:
            errors.append(f"{where} has unknown phase {ph!r}")
            continue
        if not isinstance(event.get("name"), str) or not event["name"]:
            errors.append(f"{where} ({ph}) missing string 'name'")
        if ph == "M":
            continue
        if not isinstance(event.get("ts"), (int, float)):
            errors.append(f"{where} ({event.get('name')!r}) missing numeric 'ts'")
        key = (event.get("pid"), event.get("tid"))
        if ph == "X":
            dur = event.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"{where} ({event.get('name')!r}) X event has bad "
                    f"dur {dur!r}"
                )
        elif ph == "B":
            stacks.setdefault(key, []).append(event.get("name") or "")
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(
                    f"{where}: E {event.get('name')!r} on pid/tid {key} "
                    "with no open B (orphan end)"
                )
            else:
                opened = stack.pop()
                name = event.get("name")
                if name and name != opened:
                    errors.append(
                        f"{where}: E {name!r} closes B {opened!r} on "
                        f"pid/tid {key} (mismatched nesting)"
                    )
        elif ph in ("s", "t", "f"):
            flow_id = event.get("id")
            if flow_id is None:
                errors.append(f"{where}: flow {ph} event missing 'id'")
                continue
            counts = flows.setdefault(flow_id, {"s": 0, "t": 0, "f": 0})
            counts[ph] += 1
    for key, stack in stacks.items():
        for name in stack:
            errors.append(
                f"unclosed B {name!r} on pid/tid {key} (orphan span)"
            )
    for flow_id, counts in flows.items():
        if counts["s"] != 1 or counts["f"] != 1:
            errors.append(
                f"flow id {flow_id!r} is not a whole arrow "
                f"(s={counts['s']}, f={counts['f']}; need exactly one "
                "each — orphan flow arrow)"
            )
    return errors


# -------------------------------------------------------------------- CLI


def export_main(argv: Optional[Sequence[str]] = None) -> int:
    """The ``trace`` CLI verb: ``trace export --run-dir DIR [--out F]``.
    Exit 0 on a validated export, 1 when the merge has nothing to read or
    the result fails validation, 2 on usage errors."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not argv or argv[0] != "export":
        print(
            "usage: python -m spark_examples_tpu_torch trace export "
            "--run-dir DIR [--out FILE]",
            file=sys.stderr,
        )
        return 2
    parser = argparse.ArgumentParser(prog="spark_examples_tpu_torch trace export")
    parser.add_argument(
        "--run-dir",
        required=True,
        help="The serve fleet's shared run directory (journal + trace/).",
    )
    parser.add_argument(
        "--out",
        default=None,
        metavar="FILE",
        help=(
            "Where the merged Chrome-trace JSON lands ('-' = stdout; "
            "default <run-dir>/trace/merged.trace.json). Load it in "
            "chrome://tracing or https://ui.perfetto.dev."
        ),
    )
    ns = parser.parse_args(argv[1:])
    if not os.path.isdir(ns.run_dir):
        print(f"trace export: no run dir {ns.run_dir!r}", file=sys.stderr)
        return 2
    try:
        doc = merge_run_trace(ns.run_dir)
    except FileNotFoundError as e:
        print(f"trace export: {e}", file=sys.stderr)
        return 1
    errors = validate_chrome_trace(doc)
    if errors:
        print(
            "trace export: merged trace FAILED validation:\n  "
            + "\n  ".join(errors),
            file=sys.stderr,
        )
        return 1
    summary = doc["otherData"]
    out_path = ns.out or os.path.join(
        trace_dir(ns.run_dir), "merged.trace.json"
    )
    if out_path == "-":
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        tmp = f"{out_path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, out_path)
        print(
            f"trace export: {summary['recorder_events']} events from "
            f"{len(summary['replicas'])} replica(s), "
            f"{summary['steal_arrows']} steal arrow(s), "
            f"{summary['truncated_spans']} truncated span(s), "
            f"{len(summary['jobs'])} journaled job(s) -> {out_path}",
            file=sys.stderr,
        )
    return 0


__all__ = [
    "TRACE_HEADER",
    "export_main",
    "merge_run_trace",
    "mint_trace_id",
    "normalize_trace_id",
    "validate_chrome_trace",
]
