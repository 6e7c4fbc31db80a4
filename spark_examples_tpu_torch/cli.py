"""Command-line entry point: the ``variants-pca``, ``grm``, ``ld-prune`` and
``assoc-scan`` verbs and the six other reference examples, with the JAX
package's flag grammar plus ``--device``:

    python -m spark_examples_tpu_torch variants-pca --references 17:41196311:41277499
    python -m spark_examples_tpu_torch variants-pca --num-samples 16 --device cpu
    python -m spark_examples_tpu_torch grm --num-samples 64 \
        --references 1:0:400000 --grm-out kinship.tsv
    python -m spark_examples_tpu_torch ld-prune --references 17:41196311:43196311 \
        --ld-window-sites 256 --ld-r2-threshold 0.2 --ld-out kept.tsv
    python -m spark_examples_tpu_torch assoc-scan --references 17:41196311:43196311 \
        --phenotypes phenotypes.tsv --assoc-out scan.tsv --assoc-top 10
    python -m spark_examples_tpu_torch search-variants-klotho
    python -m spark_examples_tpu_torch search-variants-brca1 --num-samples 17
    python -m spark_examples_tpu_torch search-reads-example-1 .. -4 --output-path out

The examples take the base flags only (``config.py:GenomicsConf``). With
``--source file`` the reads examples take their readsets from
``--input-files`` in order (example 4: normal, then tumor), as SAM files:

    python -m spark_examples_tpu_torch search-reads-example-4 --source file \
        --input-files normal.sam,tumor.sam --output-path out

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

A mesh: ``--mesh-shape data,samples`` (every card by default, the data
axis capped by ``--num-reduce-partitions``); ``--similarity-strategy
sharded`` keeps the Gramian as row tiles over the samples axis through a
ring (``--ring-pack-bits``, ``--reduce-schedule``). On ``--device cpu``
the positions are CPU positions:

    python -m spark_examples_tpu_torch variants-pca --device cpu \
        --num-samples 21 --references 17:0:20000 --mesh-shape 1,4 \
        --similarity-strategy sharded

Several processes (one a host, or several on one card over gloo) join one
run with ``--coordinator-address host:port --num-processes N
--process-id i``, the same flags in each; the mesh then spans them:

    python -m spark_examples_tpu_torch variants-pca --device cpu \
        --coordinator-address 127.0.0.1:29500 --num-processes 2 --process-id 0

A run records its stages' timeline with ``--trace-dir DIR`` (one
segment a process under ``DIR/trace/``); ``trace export`` merges the
segments (and a serve journal, where one is there) into one Chrome trace.
``obs report`` folds a serve fleet's run directory (journal, calibration
ledger, recorder segments) into one post-mortem report. ``graftcheck``
validates a configuration (``plan``) and audits the source tree
(``hostmem``, ``lockgraph``), the replica protocol (``proto``) and its
types (``typecheck``) device-free. These verbs are pure file I/O and
arithmetic: they touch no device and take no ``--device``, and their exit
codes propagate:

    python -m spark_examples_tpu_torch variants-pca --trace-dir run
    python -m spark_examples_tpu_torch trace export --run-dir run
    python -m spark_examples_tpu_torch obs report --run-dir run --json
    python -m spark_examples_tpu_torch graftcheck plan --num-samples 2504 \
        --references 17:0:81195210 --json
    python -m spark_examples_tpu_torch graftcheck lockgraph

The resident service: ``serve`` runs the daemon (jobs on every card, or
on the CPU with ``--device cpu``; ``--port 0 --endpoint-file F`` binds an
ephemeral port and writes its URL to F; SIGTERM drains, exit 0) and
``submit`` sends it a job, the flags after ``--`` being the verb's own
(a job may not name ``--device``: placement is the daemon's). Their exit
codes propagate:

    python -m spark_examples_tpu_torch serve --port 0 --endpoint-file url
    python -m spark_examples_tpu_torch submit --url "$(cat url)" \
        -- --num-samples 64 --references 17:41196311:41277499

"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from spark_examples_tpu_torch.analyses import assoc, grm, ld, reads_examples, variants_examples
from spark_examples_tpu_torch.config import GenomicsConf
from spark_examples_tpu_torch.parallel.mesh import distributed_shutdown
from spark_examples_tpu_torch.pipeline import pca_driver
from spark_examples_tpu_torch.sources.files import file_set_ids
from spark_examples_tpu_torch.utils.device import resolve_device

#: The JAX package's verbs (``spark_examples_tpu/cli.py:COMMANDS``) that
#: the port does not run yet: none.
NOT_PORTED = ()


def _trace_cmd(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.obs.trace import export_main

    return export_main(argv)


def _obs_cmd(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.obs.report import report_main

    return report_main(argv)


def _graftcheck_cmd(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.check.cli import main as graftcheck_main

    return graftcheck_main(argv)


#: Device-free verbs: file I/O and arithmetic, run without a card and
#: without ``--device``; their exit codes propagate.
DEVICE_FREE = {
    "trace": _trace_cmd,
    "obs": _obs_cmd,
    "graftcheck": _graftcheck_cmd,
}


def _serve_cmd(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.serve.http import serve_main

    return serve_main(argv)


def _submit_cmd(argv: Sequence[str]) -> int:
    from spark_examples_tpu_torch.serve.client import submit_main

    return submit_main(argv)


#: The resident service's verbs (``serve/``): the daemon takes its own
#: ``--device``, the client touches no device; their exit codes propagate.
SERVICE = {
    "serve": _serve_cmd,
    "submit": _submit_cmd,
}


def _readset_kwargs(conf: GenomicsConf, names: Sequence[str]) -> dict:
    """For ``--source file``, route the file-derived set ids into the reads
    examples' readset parameters (``names``, in ``--input-files`` order) —
    the hardcoded Google public readset ids only exist on the sunset API."""
    if conf.source != "file":
        return {}
    ids = file_set_ids(conf.input_files or [])
    if len(ids) < len(names):
        raise ValueError(
            f"this analysis needs {len(names)} --input-files "
            f"({', '.join(names)} in order); got {len(ids)}"
        )
    return dict(zip(names, ids))


def _variants_cmd(run_fn):
    def invoke(argv):
        conf = GenomicsConf.parse(argv)
        # Host-only, but on the device the flags name: no card, no run.
        resolve_device(conf.device)
        return run_fn(conf, pca_driver.make_source(conf))

    return invoke


def _reads_cmd(run_fn, readset_params: Sequence[str]):
    def invoke(argv):
        conf = GenomicsConf.parse(argv)
        resolve_device(conf.device)
        return run_fn(conf, pca_driver.make_source(conf), **_readset_kwargs(conf, readset_params))

    return invoke


#: The ported verbs.
COMMANDS = {
    "variants-pca": pca_driver.run,
    "grm": grm.run,
    "ld-prune": ld.run,
    "assoc-scan": assoc.run,
    "search-variants-klotho": _variants_cmd(variants_examples.run_klotho),
    "search-variants-brca1": _variants_cmd(variants_examples.run_brca1),
    "search-reads-example-1": _reads_cmd(reads_examples.run_example1, ["readset"]),
    "search-reads-example-2": _reads_cmd(reads_examples.run_example2, ["readset"]),
    "search-reads-example-3": _reads_cmd(reads_examples.run_example3, ["readset"]),
    "search-reads-example-4": _reads_cmd(
        reads_examples.run_example4, ["normal_readset", "tumor_readset"]
    ),
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m spark_examples_tpu_torch <command> [flags]")
        print("commands:")
        for name in (*COMMANDS, *DEVICE_FREE, *SERVICE):
            print(f"  {name}")
        return 0
    command, rest = argv[0], argv[1:]
    if command in DEVICE_FREE:
        return int(DEVICE_FREE[command](rest))
    if command in SERVICE:
        return int(SERVICE[command](rest))
    if command not in COMMANDS:
        print(f"unknown command: {command}", file=sys.stderr)
        return 2
    try:
        COMMANDS[command](rest)
    finally:
        distributed_shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
