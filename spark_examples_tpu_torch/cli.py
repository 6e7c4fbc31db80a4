"""Command-line entry point: the ``variants-pca`` and ``grm`` verbs, with
the JAX package's flag grammar plus ``--device``:

    python -m spark_examples_tpu_torch variants-pca --references 17:41196311:41277499
    python -m spark_examples_tpu_torch variants-pca --num-samples 16 --device cpu
    python -m spark_examples_tpu_torch grm --num-samples 64 \
        --references 1:0:400000 --grm-out kinship.tsv

File-backed runs (``--source file``) parse VCF inputs through the
chunk-parallel native parser; ``--ingest-workers N`` sizes its thread pool
(default min(8, cpu_count); ``0`` = the serial path, identical output),
and large single-set VCFs stream in one bounded pass:

    python -m spark_examples_tpu_torch variants-pca --source file \
        --input-files cohort.vcf.gz --ingest-workers 8

Telemetry: ``--heartbeat-seconds N`` writes a stderr progress line every N
seconds; ``--metrics-json PATH`` the schema-v2 run manifest;
``--profile-dir`` the stage timings and a ``torch.profiler`` trace:

    python -m spark_examples_tpu_torch variants-pca --all-references \
        --heartbeat-seconds 30 --metrics-json run.json

Robustness: ``--gramian-checkpoint-dir DIR`` snapshots the host-fed arms'
Gramian every ``--checkpoint-every-sites N`` sites, ``--resume-from DIR``
resumes a killed run (from either package's checkpoint), and
``--fault-plan`` (or ``SPARK_EXAMPLES_TPU_FAULTS``) injects deterministic
faults:

    python -m spark_examples_tpu_torch variants-pca --ingest packed \
        --gramian-checkpoint-dir ck --resume-from ck

The JAX package's other verbs are not ported yet; they exit with code 2.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from spark_examples_tpu_torch.analyses import grm
from spark_examples_tpu_torch.pipeline import pca_driver

#: The JAX package's verbs (``spark_examples_tpu/cli.py:COMMANDS``) that
#: the port does not run yet.
NOT_PORTED = (
    "ld-prune",
    "assoc-scan",
    "graftcheck",
    "serve",
    "submit",
    "trace",
    "obs",
    "search-variants-klotho",
    "search-variants-brca1",
    "search-reads-example-1",
    "search-reads-example-2",
    "search-reads-example-3",
    "search-reads-example-4",
)


#: The ported verbs.
COMMANDS = {"variants-pca": pca_driver.run, "grm": grm.run}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m spark_examples_tpu_torch <command> [flags]")
        print("commands:")
        for name in COMMANDS:
            print(f"  {name}")
        return 0
    command, rest = argv[0], argv[1:]
    if command in NOT_PORTED:
        print(f"{command}: not yet ported to PyTorch", file=sys.stderr)
        return 2
    if command not in COMMANDS:
        print(f"unknown command: {command}", file=sys.stderr)
        return 2
    COMMANDS[command](rest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
