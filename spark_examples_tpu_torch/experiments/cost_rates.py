"""The rates behind the cost model's constants (``obs/costmodel.py``).

    python -m spark_examples_tpu_torch.experiments.cost_rates

Runs ``variants-pca`` through ``run_pipeline`` in this fresh process on
the card and prints the card line and one JSON object with:

- ``cold_seconds``: the first chr17 run of the process (2,504 samples,
  16,384-site blocks, device generation) less the median of the next
  three — what a geometry's first run in a process pays: the kernel
  libraries' load and cuSOLVER's set-up (``COLD_COMPILE_SECONDS``);
- ``dispatch_overhead_seconds``: the median wall of three warm runs of
  the same geometry over 1 kb (11 candidate sites), the floor a trivial
  warm job pays (``DISPATCH_OVERHEAD_SECONDS``): the driver's set-up,
  the centering and eigensolve of the 2,504-sample Gramian, the printed
  rows;
- ``sites_per_second``: chr17's 811,953 candidate sites over the median
  ``ingest+similarity`` stage of the warm chr17 runs, the part of the
  wall that grows with the sites (``SITES_PER_SECOND``);
- ``host_bytes_per_second``: the host-memory bound
  (``check/hostmem.py:conf_host_peak_bytes``, the cost model's fallback
  when the site count is not static) of the host-fed packed arm over 2 Mb
  of chr17, over that arm's warm wall less the floor
  (``HOST_BYTES_PER_SECOND``).

Runs on a CUDA card only; ``chip_smoke.py`` runs it in a process of its
own, so the first run is cold.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

CHR17_ARGV = ["--references", "17:0:81195210", "--num-samples", "2504", "--ingest", "device",
              "--block-size", "16384"]
#: The same geometry over 1 kb (the region is no part of the geometry's
#: fingerprint, so these runs are warm after chr17's).
TINY_ARGV = ["--references", "17:41196311:41197311", "--num-samples", "2504", "--ingest",
             "device", "--block-size", "16384"]
PACKED_ARGV = ["--references", "17:41196311:43196311", "--num-samples", "2504", "--ingest",
               "packed"]
ROUNDS = 3


def _run(argv):
    """One run's wall and its ``ingest+similarity`` stage, in seconds."""
    import torch

    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    conf = PcaConf.parse(argv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = run_pipeline(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {s["path"]: s["seconds"] for s in result.driver.spans.flat()}
    return wall, stages["ingest+similarity"]


def measure() -> dict:
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes
    from spark_examples_tpu_torch.check.plan import _static_site_rows
    from spark_examples_tpu_torch.config import PcaConf

    cold, _ = _run(CHR17_ARGV)
    warm = [_run(CHR17_ARGV) for _ in range(ROUNDS)]
    tiny = [_run(TINY_ARGV)[0] for _ in range(ROUNDS)]
    _run(PACKED_ARGV)  # the packed arm's own first run
    packed = [_run(PACKED_ARGV)[0] for _ in range(ROUNDS)]
    warm_s = statistics.median(w for w, _ in warm)
    ingest_s = statistics.median(i for _, i in warm)
    tiny_s, packed_s = statistics.median(tiny), statistics.median(packed)
    sites = _static_site_rows(PcaConf.parse(CHR17_ARGV))
    host_bytes = conf_host_peak_bytes(PcaConf.parse(PACKED_ARGV))
    return {
        "chr17_cold_seconds": cold,
        "chr17_warm_seconds": [w for w, _ in warm],
        "chr17_ingest_similarity_seconds": [i for _, i in warm],
        "tiny_warm_seconds": tiny,
        "packed_warm_seconds": packed,
        "chr17_sites": sites,
        "packed_host_peak_bytes": host_bytes,
        "cold_seconds": cold - warm_s,
        "dispatch_overhead_seconds": tiny_s,
        "sites_per_second": sites / ingest_s,
        "host_bytes_per_second": host_bytes / (packed_s - tiny_s),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cost_rates: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    print(card[0] if card else torch.cuda.get_device_name(0))
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
