"""The resident PCA service: executor slices, admission control, replicas.

The port's counterpart of ``spark_examples_tpu/serve/``: one process owns
the devices ``--device`` names, cut into executor slices
(``parallel/mesh.py:plan_executor_slices``), each with a worker thread on
CUDA streams of its own; every request is validated device-free at
admission against its slice; compatible small jobs coalesce into one
dispatch group, run as one stacked program when eligible; every
acknowledged admission is journaled so accepted jobs survive a daemon
kill; the warm-geometry ledger under the run directory survives restarts;
and replica daemons share one run directory through leases.

Layout:

- ``protocol.py`` — the versioned JSON request/response schema
- ``queue.py``    — bounded two-class admission queue + continuous batching
- ``journal.py``  — append-only job journal, leases, run-directory lock
- ``executor.py`` — one job through ``run_pipeline``/``run_grm_pipeline``,
  a group through ``run_fused_pipeline``
- ``daemon.py``   — the service: devices, slices, workers, job table, metrics
- ``http.py``     — stdlib HTTP front end + the ``serve`` CLI verb
- ``client.py``   — stdlib HTTP client + the ``submit`` CLI verb
"""
