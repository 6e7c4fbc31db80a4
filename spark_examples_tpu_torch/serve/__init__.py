"""The serve daemon's substrate: the shared job journal and its leases.

The port's counterpart of ``spark_examples_tpu/serve/``. It holds one
module so far, :mod:`~spark_examples_tpu_torch.serve.journal`, the
append-only job journal, the lease store and the run-directory lock that
the daemon's admission, replay and work stealing stand on; the daemon,
its queue, protocol, executor, HTTP front end and client are still to
port (ROADMAP.md §1).
"""
