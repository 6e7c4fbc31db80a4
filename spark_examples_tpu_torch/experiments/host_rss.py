"""The host memory a CUDA process of the port takes, step by step.

    PYTHONPATH=. python spark_examples_tpu_torch/experiments/host_rss.py

(As a file: ``python -m`` would import the package, and torch with it,
before the first step.)

Prints, after each step a ``variants-pca`` run takes on the card, the
process's peak RSS (``ru_maxrss``, what the manifest's ``hostmem`` pair
measures) and its current RSS (``VmRSS``): the interpreter, ``import
torch``, the CUDA driver (``torch.cuda.is_available``), the driver's
runtime baseline (``check/hostmem.py:runtime_baseline_bytes``: the
context, the kernels' libraries, a centering and subspace eigensolve on
cuBLAS and cuSOLVER), and chr17 at 16,384-site blocks through
``run_pipeline`` in this process; then that run's host-memory bound over
the baseline its driver registered, the bound's data terms (bound less
baseline), the run's growth past the baseline and its ``hostmem``
conformance pair. Start it from a small parent: a child's ``ru_maxrss``
begins at its parent's RSS at the fork. Prints the card line and one JSON
object. Runs on a CUDA card only.
"""

from __future__ import annotations

import contextlib
import io
import json
import resource
import subprocess
import sys

#: chr17 at the CLI's synthetic grid, 2,504 samples, 16,384-site blocks.
CHR17_ARGV = ["--references", "17:0:81195210", "--num-samples", "2504", "--ingest", "device",
              "--block-size", "16384"]


def peak_rss_bytes() -> int:
    """``ru_maxrss`` in bytes (Linux reports kibibytes), as the manifest
    reads it (``obs/metrics.py:read_host_peak_rss_bytes``), without
    importing the package (which imports torch)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def current_rss_bytes() -> int:
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def main() -> int:
    steps = [("interpreter", peak_rss_bytes(), current_rss_bytes())]

    def mark(step: str) -> None:
        steps.append((step, peak_rss_bytes(), current_rss_bytes()))

    import torch

    import spark_examples_tpu_torch  # noqa: F401  (the CLI's imports)

    mark("import torch and the port")
    if not torch.cuda.is_available():
        print("host_rss: no CUDA device is available", file=sys.stderr)
        return 1
    mark("CUDA driver")
    from spark_examples_tpu_torch.check.hostmem import runtime_baseline_bytes
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs.metrics import (
        HOST_BASELINE_RSS_BYTES,
        HOST_STATIC_BOUND_BYTES,
        conformance_block,
    )
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    runtime_baseline_bytes("cuda")
    mark("runtime baseline (context, libraries, cuBLAS, cuSOLVER)")
    conf = PcaConf.parse(CHR17_ARGV)
    with contextlib.redirect_stdout(io.StringIO()):
        result = run_pipeline(conf)
    torch.cuda.synchronize()
    mark("chr17 variants-pca")
    registry = result.driver.registry
    baseline = int(registry.value(HOST_BASELINE_RSS_BYTES))
    bound = int(registry.value(HOST_STATIC_BOUND_BYTES))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({
        "steps": [{"step": s, "peak_rss_bytes": p, "rss_bytes": r} for s, p, r in steps],
        "chr17_baseline_bytes": baseline, "chr17_bound_bytes": bound,
        "data_terms_bytes": bound - baseline, "growth_bytes": steps[-1][1] - baseline,
        "hostmem": conformance_block(registry)["hostmem"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
