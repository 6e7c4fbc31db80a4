#!/usr/bin/env python3
"""Run one cell of the PyTorch port's benchmark on this machine's card.

    python3 gpubench/run.py --workload pcoa-1kg-wgs --seed 7 --seconds 30 --trace 0

The cell, its configuration, its traffic and its metrics come from
``BENCHMARK.json`` and the files it names under ``gpubench/``. The last
line of standard output is the result (one JSON object); the last lines of
standard error are the numbers compared for ``correct``, each beside its
limit.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], started=STARTED))
