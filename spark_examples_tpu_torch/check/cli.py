"""The ``graftcheck`` CLI front-end of the port.

Dispatched from the package CLI (``python -m spark_examples_tpu_torch
graftcheck <sub> ...``), as ``spark_examples_tpu/check/cli.py`` is from the
reference's. The port runs one subcommand, the device-free plan validator
the serve daemon's admission runs too:

    graftcheck plan [--analysis pca|grm|ld|assoc] <verb flags>
                  [--plan-devices N]
                  [--host-mem-budget BYTES]
                  [--device-memory-bytes BYTES] [--json]
                                              0 plan OK / 2 rejected

``--device-memory-bytes`` is the HBM budget of the memory rules (default
the reference's device-free 16 GiB; an H100's is
``torch.cuda.mem_get_info()[1]``). The reference's other subcommands
(``lint``, ``ir``, ``ranges``, ``sched``, ``lockgraph``, ``hostmem``,
``proto``, ``sanitize``, ``typecheck``) exit 2 naming the ROADMAP step
that brings them.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

#: The reference's subcommands the port does not run yet, all of them
#: ROADMAP.md §1's graftcheck step.
NOT_PORTED = (
    "lint",
    "ir",
    "ranges",
    "sched",
    "lockgraph",
    "hostmem",
    "proto",
    "sanitize",
    "typecheck",
)


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
    except NotImplementedError as e:
        print(f"graftcheck plan: {e}", file=sys.stderr)
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


_SUBCOMMANDS = {"plan": _cmd_plan}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0
    sub, rest = argv[0], argv[1:]
    if sub in NOT_PORTED:
        print(
            f"graftcheck {sub}: not yet ported to PyTorch (ROADMAP.md §1, "
            "the graftcheck step); the port runs: "
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
