"""Post-mortem fleet report: the cost observatory's offline reader.

The port's copy of ``spark_examples_tpu/obs/report.py``: it reads the
port's journal, calibration ledger and recorder segments, whose formats
are the reference's, so over one run directory both packages print the
same report, byte for byte, text and ``--json``.

``python -m spark_examples_tpu_torch obs report --run-dir DIR [--json]`` folds
a serve fleet's run-directory artifacts — the shared job journal
(``serve/journal.py``), the calibration ledger (``obs/calibration.py``),
and the flight-recorder segments (``obs/recorder.py``) — into one
report: per-job predicted-vs-measured cost under the job's trace id,
per-class latency quantiles, the fleet calibration fold, and
steal/replay accounting. Every input is an append-only, torn-tail-
tolerant file, so the report works on a DEAD fleet: the chaos harness's
``kill -9``'d replicas leave exactly the artifacts this reads.

The join key is the job id; the correlation key shown to the operator is
the trace id — the same id the submit carried, the journal persisted
across steals, and the flight recorder stamped on every event, so one
report line names a job's whole fleet-side life.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from spark_examples_tpu_torch.obs.calibration import calibration_path, fold_calibration


def _quantile(ordered: List[float], q: float) -> Optional[float]:
    """Exact linear-interpolation quantile over a SORTED sample list —
    offline reports read full ledgers, so no reservoir is needed."""
    if not ordered:
        return None
    rank = min(max(float(q), 0.0), 1.0) * (len(ordered) - 1)
    low = int(rank)
    high = min(low + 1, len(ordered) - 1)
    fraction = rank - low
    return ordered[low] * (1.0 - fraction) + ordered[high] * fraction


def _iter_ledger_records(path: str):
    """Raw calibration-ledger records, torn-tail-tolerant (the same skip
    contract as ``fold_calibration`` — an unparseable line can only be a
    crashed writer's last)."""
    try:
        f = open(path, "r", encoding="utf-8")
    except FileNotFoundError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(record, dict):
                yield record


def _journal_jobs(run_dir: str) -> Dict[str, Dict]:
    """Per-job admission facts from the shared journal, epoch-fenced the
    way ``replay_journal`` fences terminals (mirroring
    ``obs/trace.py:_journal_facts``, plus the ``cost`` block and request
    kind the cost report needs)."""
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
                "kind": None,
                "class": None,
                "submitted_unix": None,
                "deadline_unix": None,
                "predicted_seconds": None,
                "cost": None,
                "began": False,
                "stolen": False,
                "lease_epoch": 0,
                "replicas": [],
                "terminals": [],
                "status": None,
            },
        )
        replica = record.get("replica")
        if isinstance(replica, str) and replica not in job["replicas"]:
            job["replicas"].append(replica)
        event = record.get("event")
        if event == "accepted":
            trace = record.get("trace")
            if isinstance(trace, str):
                job["trace"] = trace
            request = record.get("request")
            if isinstance(request, dict):
                kind = request.get("kind")
                if isinstance(kind, str):
                    job["kind"] = kind
            job_class = record.get("job_class")
            if isinstance(job_class, str):
                job["class"] = job_class
            job["submitted_unix"] = record.get("submitted_unix")
            job["deadline_unix"] = record.get("deadline_unix")
            cost = record.get("cost")
            if isinstance(cost, dict):
                job["cost"] = cost
                predicted = cost.get("predicted_seconds")
                if isinstance(predicted, (int, float)) and not isinstance(
                    predicted, bool
                ):
                    job["predicted_seconds"] = float(predicted)
        elif event == "began":
            job["began"] = True
        elif event == "lease":
            epoch = record.get("epoch")
            if isinstance(epoch, int):
                job["lease_epoch"] = max(job["lease_epoch"], epoch)
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


def _recorder_events(run_dir: str) -> List[Dict]:
    """Flight-recorder events, ``[]`` when no segments reached disk —
    the report degrades, never fails, on a fleet whose rings were
    lost."""
    try:
        from spark_examples_tpu_torch.obs.recorder import read_segments

        return read_segments(run_dir)
    except Exception:
        return []


def build_fleet_report(run_dir: str) -> Dict:
    """The whole report as one JSON-safe document (the ``--json`` body;
    the text renderer reads the same dict). Raises ``FileNotFoundError``
    when the run dir holds neither a journal nor a calibration ledger."""
    from spark_examples_tpu_torch.serve.journal import journal_path

    have_journal = os.path.exists(journal_path(run_dir))
    ledger_path = calibration_path(run_dir)
    have_ledger = os.path.exists(ledger_path)
    if not have_journal and not have_ledger:
        raise FileNotFoundError(
            f"nothing to report: no journal at {journal_path(run_dir)!r} "
            f"and no calibration ledger at {ledger_path!r}"
        )
    jobs = _journal_jobs(run_dir) if have_journal else {}

    # Join the ledger's measured truth onto the journal's admission
    # facts; ledger rows for jobs the journal compacted away (or a
    # journal lost to the crash) still count in the class quantiles.
    by_class: Dict[str, Dict[str, List[float]]] = {}
    ledger_samples = 0
    for record in _iter_ledger_records(ledger_path):
        measured = record.get("measured_seconds")
        if isinstance(measured, bool) or not isinstance(
            measured, (int, float)
        ):
            continue
        ledger_samples += 1
        # Class quantiles stay done-only (a failed row's wall measures
        # the failure path); the per-job join below takes every row.
        job_class = record.get("job_class")
        if record.get("status") in (None, "done") and isinstance(
            job_class, str
        ):
            lanes = by_class.setdefault(
                job_class, {"wall": [], "queue_wait": []}
            )
            lanes["wall"].append(float(measured))
            queue_wait = record.get("queue_wait_seconds")
            if isinstance(queue_wait, (int, float)) and not isinstance(
                queue_wait, bool
            ):
                lanes["queue_wait"].append(float(queue_wait))
        job = jobs.get(record.get("id") or "")
        if job is not None:
            job["measured_seconds"] = float(measured)
            queue_wait = record.get("queue_wait_seconds")
            if isinstance(queue_wait, (int, float)) and not isinstance(
                queue_wait, bool
            ):
                job["queue_wait_seconds"] = float(queue_wait)
            compile_disposition = record.get("compile")
            if isinstance(compile_disposition, str):
                job["compile"] = compile_disposition

    classes: Dict[str, Dict] = {}
    for job_class, lanes in sorted(by_class.items()):
        block: Dict[str, Dict] = {}
        for lane_name, values in lanes.items():
            ordered = sorted(values)
            if not ordered:
                continue
            block[f"{lane_name}_seconds"] = {
                "count": len(ordered),
                "mean": sum(ordered) / len(ordered),
                "p50": _quantile(ordered, 0.50),
                "p95": _quantile(ordered, 0.95),
                "p99": _quantile(ordered, 0.99),
            }
        classes[job_class] = block

    # The flight recorder fills what the ledger cannot know: a stolen
    # job's queue wait was observed (and durably flushed, pre-kill-point)
    # by the owner that dequeued it, even when that owner died before
    # any terminal row — the job-begin event carries it.
    events = _recorder_events(run_dir)
    for event in events:
        job = jobs.get(event.get("job") or "")
        if job is None or job.get("queue_wait_seconds") is not None:
            continue
        if event.get("name") == "job" and event.get("ph") == "B":
            queue_wait = (event.get("args") or {}).get("queue_wait")
            if isinstance(queue_wait, (int, float)) and not isinstance(
                queue_wait, bool
            ):
                job["queue_wait_seconds"] = float(queue_wait)
    recorder = (
        {
            "events": len(events),
            "replicas": sorted({e["replica"] for e in events}),
        }
        if events
        else None
    )

    statuses: Dict[str, int] = {}
    for job in jobs.values():
        statuses[job["status"] or "unsettled"] = (
            statuses.get(job["status"] or "unsettled", 0) + 1
        )

    # The protocol post-mortem: the SAME protocol_summary fold
    # `graftcheck proto` asserts GP001-GP006 over, run on this fleet's
    # real journal — fence epochs, fenced-vs-effective terminal
    # verdicts, steal counts. One code path for the proof and the
    # report.
    protocol = None
    if have_journal:
        from spark_examples_tpu_torch.serve.journal import (
            iter_journal_records,
            protocol_summary,
        )

        protocol = protocol_summary(
            iter_journal_records(journal_path(run_dir))
        )

    return {
        "run_dir": os.path.abspath(run_dir),
        "jobs": jobs,
        "totals": {
            "journaled": len(jobs),
            "statuses": statuses,
            "stolen": sum(1 for j in jobs.values() if j["stolen"]),
            "began": sum(1 for j in jobs.values() if j["began"]),
            "with_prediction": sum(
                1
                for j in jobs.values()
                if j["predicted_seconds"] is not None
            ),
            "ledger_samples": ledger_samples,
        },
        "classes": classes,
        "calibration": fold_calibration(ledger_path).summary(),
        "recorder": recorder,
        "protocol": protocol,
    }


def _seconds(value) -> str:
    return f"{value:.3f}s" if isinstance(value, (int, float)) else "-"


def render_fleet_report(doc: Dict) -> str:
    """The human form of :func:`build_fleet_report` (stderr-free: the
    report IS the output)."""
    lines: List[str] = [f"fleet report: {doc['run_dir']}"]
    totals = doc["totals"]
    status_text = ", ".join(
        f"{status} {count}"
        for status, count in sorted(totals["statuses"].items())
    )
    lines.append(
        f"journaled jobs: {totals['journaled']}"
        + (f" ({status_text})" if status_text else "")
        + f"; stolen {totals['stolen']}; device-began {totals['began']}; "
        f"predictions {totals['with_prediction']}; "
        f"ledger samples {totals['ledger_samples']}"
    )
    recorder = doc.get("recorder")
    if recorder:
        lines.append(
            f"flight recorder: {recorder['events']} events from "
            f"{len(recorder['replicas'])} replica(s): "
            + ", ".join(recorder["replicas"])
        )
    protocol = doc.get("protocol")
    if protocol:
        proto_totals = protocol["totals"]
        lines.append(
            f"protocol: accepted {proto_totals['accepted']}, settled "
            f"{proto_totals['settled']}, pending "
            f"{proto_totals['pending']}; terminals "
            f"{proto_totals['terminals']} "
            f"({proto_totals['effective_terminals']} effective, "
            f"{proto_totals['fenced_terminals']} fenced); steals "
            f"{proto_totals['steals']}; max lease epoch "
            f"{proto_totals['max_lease_epoch']}"
        )
        for job_id, info in sorted(protocol["jobs"].items()):
            fenced = [t for t in info["terminals"] if not t["effective"]]
            if not fenced and not info["steals"]:
                continue
            # Only the jobs with protocol drama get a line: a fenced
            # terminal is a zombie write the fold absorbed, a steal is
            # a replica takeover — both are what a post-mortem reads
            # this block for.
            fence_text = ", ".join(
                f"{t['status']}@e{t['epoch']}" for t in fenced
            )
            lines.append(
                f"  job {job_id}: fence e{info['fence']} "
                f"owner {info['owner'] or '-'}; steals {info['steals']}"
                + (f"; fenced terminals: {fence_text}" if fenced else "")
            )
    calibration = doc.get("calibration") or {}
    if calibration.get("samples"):
        ratio = calibration.get("ratio")
        lines.append(
            f"calibration: n={calibration['samples']}, ratio "
            + (f"{ratio:.3f}" if isinstance(ratio, (int, float)) else "-")
            + f", predicted mean "
            f"{_seconds(calibration.get('predicted_mean_seconds'))}, "
            f"measured mean "
            f"{_seconds(calibration.get('measured_mean_seconds'))}, "
            f"geometries {len(calibration.get('geometries') or {})}"
        )
    for job_class, block in sorted((doc.get("classes") or {}).items()):
        for lane, label in (
            ("wall_seconds", "wall"),
            ("queue_wait_seconds", "queue wait"),
        ):
            stats = block.get(lane)
            if not stats:
                continue
            lines.append(
                f"class {job_class} {label}: p50 {_seconds(stats['p50'])} "
                f"p95 {_seconds(stats['p95'])} p99 {_seconds(stats['p99'])}"
                f" (n={stats['count']})"
            )
    for job_id, job in sorted((doc.get("jobs") or {}).items()):
        flags = []
        if job["stolen"]:
            flags.append("stolen")
        if job.get("compile"):
            flags.append(job["compile"])
        detail = [
            f"predicted {_seconds(job.get('predicted_seconds'))}",
            f"measured {_seconds(job.get('measured_seconds'))}",
            f"queue wait {_seconds(job.get('queue_wait_seconds'))}",
        ]
        predicted = job.get("predicted_seconds")
        measured = job.get("measured_seconds")
        if (
            isinstance(predicted, (int, float))
            and predicted > 0
            and isinstance(measured, (int, float))
        ):
            detail.append(f"ratio {measured / predicted:.2f}")
        lines.append(
            f"job {job_id} [{job.get('class') or '?'}/"
            f"{job.get('kind') or '?'}] {job.get('status') or 'unsettled'}"
            + (f" ({', '.join(flags)})" if flags else "")
            + f" trace={job.get('trace') or '-'}: "
            + ", ".join(detail)
        )
    return "\n".join(lines)


def report_main(argv: Optional[Sequence[str]] = None) -> int:
    """The ``obs`` CLI verb: ``obs report --run-dir DIR [--json]``.
    Exit 0 on a rendered report, 1 when the run dir has nothing to
    report, 2 on usage errors. Reads only on-disk artifacts — the fleet
    may be long dead."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not argv or argv[0] != "report":
        print(
            "usage: python -m spark_examples_tpu_torch obs report "
            "--run-dir DIR [--json]",
            file=sys.stderr,
        )
        return 2
    parser = argparse.ArgumentParser(prog="spark_examples_tpu_torch obs report")
    parser.add_argument(
        "--run-dir",
        required=True,
        help=(
            "The serve fleet's shared run directory (journal + "
            "calibration.jsonl + trace/)."
        ),
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="Emit the structured report document instead of text.",
    )
    ns = parser.parse_args(argv[1:])
    if not os.path.isdir(ns.run_dir):
        print(f"obs report: no run dir {ns.run_dir!r}", file=sys.stderr)
        return 2
    try:
        doc = build_fleet_report(ns.run_dir)
    except FileNotFoundError as e:
        print(f"obs report: {e}", file=sys.stderr)
        return 1
    if ns.json:
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(render_fleet_report(doc))
    return 0


__all__ = [
    "build_fleet_report",
    "render_fleet_report",
    "report_main",
]
