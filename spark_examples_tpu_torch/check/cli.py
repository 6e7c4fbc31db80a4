"""The ``graftcheck`` CLI front-end of the port.

Dispatched from the package CLI (``python -m spark_examples_tpu_torch
graftcheck <sub> ...``), as ``spark_examples_tpu/check/cli.py`` is from the
reference's, with the reference's flags and exit codes; subcommand exit
codes propagate:

    graftcheck lint [PATH...] [--json]        0 clean / 1 findings
    graftcheck ir [--json] [--mesh D,S]... [--topology H,D]...
                  [--num-samples N] [--block-size B]
                                              0 clean / 1 findings /
                                              2 grammar error
    graftcheck ranges [--json] [--mesh D,S]... [--topology H,D]...
                  [--num-samples N] [--block-size B]
                                              0 clean / 1 findings /
                                              2 grammar error
    graftcheck sched [--json] [--topology H,D]... [--num-samples N]
                  [--block-size B] [--reduce-schedule auto|flat|hier]
                  [--sched-budget-seconds S]  0 proven / 1 findings /
                                              2 grammar error
    graftcheck lockgraph [PATH...] [--json] [--dot FILE]
                                              0 acyclic+clean / 1 findings
    graftcheck hostmem [PATH...] [--json]     0 clean / 1 findings
    graftcheck plan [--analysis pca|grm|ld|assoc] <verb flags>
                  [--plan-devices N] [--topology H,D]
                  [--sched-budget-seconds S]
                  [--host-mem-budget BYTES]
                  [--device-memory-bytes BYTES] [--json]
                                              0 plan OK / 2 rejected
    graftcheck proto [--replicas N] [--jobs N] [--crashes N]
                  [--stalls N] [--max-states N] [--mutations] [--json]
                                              0 clean (or every planted
                                              bug caught) / 1 findings
    graftcheck sanitize [--modes m1,m2] [--strict]
                                              0 clean or skipped / 1 FAIL
    graftcheck typecheck [--strict] [--update-baseline]
                                              0 ok or skipped / 1 new errors

``lint``, ``lockgraph`` and ``hostmem`` read this package's source by
default, wherever they are run from (a missing path exits 2);
``proto`` checks the replica protocol over this package's journal fold;
``sanitize`` builds the native parser's harness under each sanitizer into
``build/torch_kernels/`` and replays the fuzz corpus through it (no
compiler: SKIP, exit 0; ``--strict``: 2);
``typecheck`` skips with exit 0 where ``mypy`` is not installed;
``ir`` records the Gramian updates' schedule on CPU positions
(``check/ir.py``), ``ranges`` proves their range and exactness
contracts over it (``check/ranges.py``) and ``sched`` proves the rings'
collective schedule on declared topologies, each hop on its link class
(``check/sched.py``); none touches a card. ``--device-memory-bytes`` is
the HBM budget of the plan's memory rules (default the reference's
device-free 16 GiB; an H100's is ``torch.cuda.mem_get_info()[1]``). Every
subcommand of the reference runs.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

#: The reference's subcommands the port does not run yet, each with the
#: ROADMAP.md §1 step that brings it (none since the schedule prover).
NOT_PORTED: dict = {}


def _default_lint_root() -> str:
    """The installed package directory — so ``graftcheck lint`` with no
    argument lints this package regardless of the working directory."""
    import spark_examples_tpu_torch

    return os.path.dirname(os.path.abspath(spark_examples_tpu_torch.__file__))


def _cmd_lint(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.linter import json_report, lint_paths

    parser = argparse.ArgumentParser(prog="graftcheck lint")
    parser.add_argument(
        "paths",
        nargs="*",
        help="Files or package trees to lint (default: this package).",
    )
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    ns = parser.parse_args(list(argv))
    paths = ns.paths or [_default_lint_root()]
    for path in paths:
        if not os.path.exists(path):
            print(f"graftcheck lint: no such path {path!r}", file=sys.stderr)
            return 2
    findings, checked = lint_paths(paths)
    if ns.json:
        print(json_report(findings, checked))
    else:
        for f in findings:
            print(f.format())
        verdict = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"graftcheck lint: {checked} file(s), {verdict}")
    return 1 if findings else 0


def _parse_audit_args(prog: str, argv: Sequence[str], extra=None):
    """The shared ``--json/--mesh/--topology/--num-samples/--block-size``
    surface of the kernel-audit subcommands (``ir``, ``ranges``,
    ``sched``) — ONE parser, ONE mesh-pair validation, and ONE
    ``--topology hosts,devices_per_host`` spelling, with the reference's
    messages. ``extra`` (a callback receiving the parser) registers a
    subcommand's own flags. Returns ``(ns, meshes, topologies)`` or
    ``None`` after printing the grammar error."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    parser.add_argument(
        "--mesh",
        action="append",
        default=None,
        metavar="D,S",
        help=(
            "Mesh shape(s) to audit, as CPU positions (repeatable, e.g. "
            "--mesh 1,4 --mesh 2,2). Default: the shipped matrix (1,2), "
            "(1,4), (2,2)."
        ),
    )
    parser.add_argument(
        "--topology",
        action="append",
        default=None,
        metavar="H,D",
        help=(
            "Declared topology (hosts,devices_per_host — repeatable, e.g. "
            "--topology 2,4) to audit the two-level ring on; the topology "
            "never has to exist. ir and ranges append the two-level "
            "kernels per topology; sched proves its schedule matrix on "
            "these topologies (default: 1,2 1,4 2,4 4,8 32,8)."
        ),
    )
    parser.add_argument(
        "--num-samples",
        type=int,
        default=64,
        help="Aligned cohort width for the audit geometry (default 64).",
    )
    parser.add_argument(
        "--block-size",
        type=int,
        default=8,
        help="Variant block size for the audit geometry (default 8).",
    )
    if extra is not None:
        extra(parser)
    ns = parser.parse_args(list(argv))
    meshes = None
    if ns.mesh:
        try:
            meshes = tuple(
                tuple(int(p) for p in spec.split(",")) for spec in ns.mesh
            )
            if any(len(m) != 2 or m[0] < 1 or m[1] < 1 for m in meshes):
                raise ValueError(meshes)
        except ValueError:
            print(
                f"{prog}: --mesh expects positive 'data,samples' "
                f"pairs, got {ns.mesh}",
                file=sys.stderr,
            )
            return None
    topologies = None
    if ns.topology:
        from spark_examples_tpu_torch.parallel.mesh import parse_topology

        topologies = []
        for spec in ns.topology:
            try:
                topo = parse_topology(spec)
            except ValueError as e:
                print(f"{prog}: {e}", file=sys.stderr)
                return None
            topologies.append((topo.hosts, topo.devices_per_host))
        topologies = tuple(topologies)
    return ns, meshes, topologies


def _cmd_ir(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.ir import default_specs, run_audit

    parsed = _parse_audit_args("graftcheck ir", argv)
    if parsed is None:
        return 2
    ns, meshes, topologies = parsed
    specs = default_specs(
        num_samples=ns.num_samples,
        ragged_samples=ns.num_samples + 36,
        block_size=ns.block_size,
        **({"meshes": meshes} if meshes is not None else {}),
        **({"topologies": topologies} if topologies is not None else {}),
    )
    report = run_audit(specs)
    print(report.to_json() if ns.json else report.format())
    return 0 if report.ok else 1


def _cmd_ranges(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.ranges import default_specs, run_audit

    parsed = _parse_audit_args("graftcheck ranges", argv)
    if parsed is None:
        return 2
    ns, meshes, topologies = parsed
    specs = default_specs(
        num_samples=ns.num_samples,
        block_size=ns.block_size,
        **({"meshes": meshes} if meshes is not None else {}),
        **({"topologies": topologies} if topologies is not None else {}),
    )
    report = run_audit(specs)
    print(report.to_json() if ns.json else report.format())
    return 0 if report.ok else 1


def _cmd_sched(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.sched import run_audit

    def extra(parser):
        parser.add_argument(
            "--reduce-schedule",
            choices=["auto", "flat", "hier"],
            default="auto",
            help=(
                "Which schedule selection to prove per topology (the "
                "runtime flag's resolution rule; auto = hier iff hosts "
                "> 1). Forcing flat on a multi-host topology demonstrates "
                "GS001."
            ),
        )
        parser.add_argument(
            "--sched-budget-seconds",
            type=float,
            default=None,
            metavar="S",
            help=(
                "Declared critical-path budget per flush: a topology "
                "whose predicted schedule-limited time exceeds it is a "
                "GS005 finding."
            ),
        )

    parsed = _parse_audit_args("graftcheck sched", argv, extra=extra)
    if parsed is None:
        return 2
    ns, meshes, topologies = parsed
    if meshes is not None:
        # A silently-ignored flag would let the user believe they
        # constrained the audit matrix; sched audits topologies, not
        # data x samples meshes.
        print(
            "graftcheck sched: --mesh does not apply here — the schedule "
            "matrix is selected with --topology hosts,devices_per_host",
            file=sys.stderr,
        )
        return 2
    if ns.sched_budget_seconds is not None and ns.sched_budget_seconds <= 0:
        # Same positivity contract graftcheck plan enforces for the flag:
        # a non-positive budget is a usage error, not a GS005 finding on
        # every topology.
        print(
            f"graftcheck sched: --sched-budget-seconds must be positive, "
            f"got {ns.sched_budget_seconds}",
            file=sys.stderr,
        )
        return 2
    report = run_audit(
        topologies=topologies,
        num_samples=ns.num_samples,
        block_size=ns.block_size,
        reduce_schedule=ns.reduce_schedule,
        budget_seconds=ns.sched_budget_seconds,
    )
    print(report.to_json() if ns.json else report.format())
    return 0 if report.ok else 1


def _cmd_plan(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.plan import (
        _RaisingParser,
        parse_plan_args,
        validate_plan,
    )

    # --device-memory-bytes is the port's plan-only flag; the rest parses
    # through the verb's real parser.
    budget = _RaisingParser(add_help=False, allow_abbrev=False)
    budget.add_argument("--device-memory-bytes", type=int, default=None)
    try:
        ns, argv = budget.parse_known_args(list(argv))
        device_bytes = ns.device_memory_bytes
        if device_bytes is not None and device_bytes <= 0:
            raise ValueError(f"--device-memory-bytes must be positive, got {device_bytes}")
        (
            conf,
            plan_devices,
            json_out,
            host_mem_budget,
            analysis,
            topology,
            sched_budget_seconds,
        ) = parse_plan_args(argv)
    except ValueError as e:
        # Cross-flag contract violations from PcaConf._from_namespace are
        # plan rejections in their own right (e.g. --blocks-per-dispatch 0).
        print(f"  ERROR [flag-contract] {e}")
        print("plan REJECTED")
        return 2
    report = validate_plan(
        conf,
        plan_devices,
        host_mem_budget=host_mem_budget,
        analysis=analysis,
        topology=topology,
        sched_budget_seconds=sched_budget_seconds,
        device_bytes=device_bytes,
    )
    print(report.to_json() if json_out else report.format())
    return 0 if report.ok else 2


def _cmd_lockgraph(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.lockgraph import (
        build_lock_graph,
        default_lock_paths,
    )

    parser = argparse.ArgumentParser(prog="graftcheck lockgraph")
    parser.add_argument(
        "paths",
        nargs="*",
        help="Files or package trees to analyze (default: this package).",
    )
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    parser.add_argument(
        "--dot",
        default=None,
        metavar="FILE",
        help="Write the acquisition-order graph as a DOT artifact.",
    )
    ns = parser.parse_args(list(argv))
    paths = ns.paths or default_lock_paths()
    for path in paths:
        if not os.path.exists(path):
            print(
                f"graftcheck lockgraph: no such path {path!r}", file=sys.stderr
            )
            return 2
    graph = build_lock_graph(paths)
    if ns.dot:
        try:
            with open(ns.dot, "w", encoding="utf-8") as f:
                f.write(graph.to_dot())
        except OSError as e:
            print(
                f"graftcheck lockgraph: cannot write --dot {ns.dot!r}: {e}",
                file=sys.stderr,
            )
            return 2
    print(graph.to_json() if ns.json else graph.format())
    return 0 if graph.ok else 1


def _cmd_hostmem(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.hostmem import (
        audit_paths,
        default_hostmem_paths,
    )

    parser = argparse.ArgumentParser(prog="graftcheck hostmem")
    parser.add_argument(
        "paths",
        nargs="*",
        help=(
            "Files or trees to audit (default: this package's host-staging "
            "layers — sources/, pipeline/, ops/)."
        ),
    )
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    ns = parser.parse_args(list(argv))
    paths = ns.paths or default_hostmem_paths()
    for path in paths:
        if not os.path.exists(path):
            print(f"graftcheck hostmem: no such path {path!r}", file=sys.stderr)
            return 2
    report = audit_paths(paths)
    print(report.to_json() if ns.json else report.format())
    return 0 if report.ok else 1


def _cmd_proto(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.proto import (
        check_protocol,
        run_mutation_harness,
    )

    parser = argparse.ArgumentParser(prog="graftcheck proto")
    parser.add_argument(
        "--replicas",
        type=int,
        default=None,
        help="Replica bound for the explored state space (default 2).",
    )
    parser.add_argument(
        "--jobs",
        type=int,
        default=None,
        help="Job bound for the explored state space (default 2).",
    )
    parser.add_argument(
        "--crashes",
        type=int,
        default=None,
        help="Crash budget (process or host crashes, default 2).",
    )
    parser.add_argument(
        "--stalls",
        type=int,
        default=None,
        help=(
            "Lease-clock aging budget: each stall ages one live lease "
            "one notch on the live/lapsed/stale abstract clock "
            "(clean-run default 0 — pair with a --jobs 1 --stalls 2 "
            "run for the expiry/steal dimension; with --mutations, "
            "each planted bug defaults to its own witness bounds)."
        ),
    )
    parser.add_argument(
        "--max-states",
        type=int,
        default=2_000_000,
        help=(
            "Safety cap on explored states; hitting it means the run "
            "was NOT exhaustive and fails (default 2000000)."
        ),
    )
    parser.add_argument(
        "--mutations",
        action="store_true",
        help=(
            "Run the mutation harness instead of the clean check: each "
            "planted single-decision bug must trip its matching GP rule."
        ),
    )
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    ns = parser.parse_args(list(argv))
    if any(
        bound is not None and bound < floor
        for bound, floor in (
            (ns.replicas, 1),
            (ns.jobs, 1),
            (ns.crashes, 0),
            (ns.stalls, 0),
        )
    ):
        print(
            "graftcheck proto: bounds must be >= 1 replica/job and >= 0 "
            "crashes/stalls",
            file=sys.stderr,
        )
        return 2
    if ns.mutations:
        import json as _json

        outcomes = run_mutation_harness(
            replicas=ns.replicas,
            jobs=ns.jobs,
            crashes=ns.crashes,
            stalls=ns.stalls,
            max_states=ns.max_states,
        )
        if ns.json:
            print(_json.dumps([o.to_json() for o in outcomes], indent=2))
        else:
            for o in outcomes:
                verdict = "caught" if o.caught else "MISSED"
                bounds = ",".join(
                    f"{k}={v}" for k, v in sorted(o.bounds.items())
                )
                print(
                    f"  {verdict:6s} {o.name}: expected {o.expected}, "
                    f"tripped {','.join(o.tripped) or '(none)'} "
                    f"({o.states} states at [{bounds}])"
                )
            caught = sum(1 for o in outcomes if o.caught)
            print(
                f"graftcheck proto: {caught}/{len(outcomes)} planted "
                f"bugs caught"
            )
        return 0 if all(o.caught for o in outcomes) else 1
    report = check_protocol(
        **{
            name: value
            for name, value in (
                ("replicas", ns.replicas),
                ("jobs", ns.jobs),
                ("crashes", ns.crashes),
                ("stalls", ns.stalls),
            )
            if value is not None
        },
        max_states=ns.max_states,
    )
    print(report.to_json() if ns.json else report.format())
    return 0 if report.ok else 1


def _cmd_sanitize(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.sanitize import DEFAULT_MODES, run_sanitize

    parser = argparse.ArgumentParser(prog="graftcheck sanitize")
    parser.add_argument(
        "--modes",
        default=",".join(DEFAULT_MODES),
        help=f"Comma-separated sanitizer modes (default {','.join(DEFAULT_MODES)}).",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="Fail (not skip) when the toolchain is missing a mode.",
    )
    ns = parser.parse_args(list(argv))
    modes = [m.strip() for m in ns.modes.split(",") if m.strip()]
    return run_sanitize(modes, strict=ns.strict)


def _cmd_typecheck(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.typecheck import run_typecheck

    parser = argparse.ArgumentParser(prog="graftcheck typecheck")
    parser.add_argument(
        "--strict",
        action="store_true",
        help="Fail (not skip) when mypy is not installed.",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="Rewrite check/mypy_baseline.txt from the current diagnostics.",
    )
    ns = parser.parse_args(list(argv))
    return run_typecheck(strict=ns.strict, update_baseline=ns.update_baseline)


_SUBCOMMANDS = {
    "lint": _cmd_lint,
    "ir": _cmd_ir,
    "ranges": _cmd_ranges,
    "sched": _cmd_sched,
    "lockgraph": _cmd_lockgraph,
    "hostmem": _cmd_hostmem,
    "plan": _cmd_plan,
    "proto": _cmd_proto,
    "sanitize": _cmd_sanitize,
    "typecheck": _cmd_typecheck,
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0
    sub, rest = argv[0], argv[1:]
    if sub in NOT_PORTED:
        print(
            f"graftcheck {sub}: not yet ported to PyTorch (ROADMAP.md §1, "
            f"step {NOT_PORTED[sub]}); the port runs: "
            f"{', '.join(sorted(_SUBCOMMANDS))}",
            file=sys.stderr,
        )
        return 2
    if sub not in _SUBCOMMANDS:
        print(
            f"graftcheck: unknown subcommand {sub!r} "
            f"(have: {', '.join(sorted(_SUBCOMMANDS))})",
            file=sys.stderr,
        )
        return 2
    return _SUBCOMMANDS[sub](rest)


if __name__ == "__main__":
    raise SystemExit(main())
