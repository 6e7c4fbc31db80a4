"""What the ``tests/test_torch_serve*.py`` files share: both packages' serve
modules side by side, stub executors, and bounded waits.

Every wait here has a deadline and fails the test with the service's
state; events are ordered with ``threading.Event``s, never with fixed
sleeps.
"""

import functools
import importlib
import os
import subprocess
import sys
import threading
import time

import torch

PACKAGES = {"ref": "spark_examples_tpu", "port": "spark_examples_tpu_torch"}
PKGS = sorted(PACKAGES)

#: The reference tests' requests: a tiny synthetic window, the next contig's
#: (same batch geometry), and a window past ``SMALL_JOB_MAX_SITES``.
TINY_FLAGS = ["--num-samples", "8", "--references", "1:0:50000"]
TINY_FLAGS_B = ["--num-samples", "8", "--references", "2:0:50000"]
LARGE_FLAGS = ["--num-samples", "8", "--references", "1:0:30000000"]

_MODULES = (
    "serve.protocol", "serve.queue", "serve.daemon", "serve.executor",
    "serve.http", "serve.client", "serve.journal", "utils.faults",
    "utils.cache", "parallel.mesh", "config", "obs.metrics",
    "obs.heartbeat", "obs.manifest",
)


class Pkg:
    """One package's serve stack, module by module (``pkg.daemon``,
    ``pkg.queue``, ...)."""

    def __init__(self, name):
        self.name = name
        self.base = PACKAGES[name]
        for mod in _MODULES:
            setattr(self, mod.split(".")[-1], importlib.import_module(f"{self.base}.{mod}"))

    def service(self, run_dir, **kw):
        """A ``PcaService`` over eight device positions: the reference's
        test mesh has eight virtual CPU devices, the port takes eight CPU
        positions through ``devices=``."""
        if self.name == "port" and "device" not in kw:
            kw.setdefault("devices", [torch.device("cpu")] * 8)
        return self.daemon.PcaService(run_dir=str(run_dir), **kw)

    def real_service(self, run_dir, **kw):
        """A ``PcaService`` with the real executor: the reference on its
        test mesh, the port on one CPU position (``--device cpu``)."""
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.daemon.PcaService(run_dir=str(run_dir), **kw)

    def outcome(self, result, manifest_path=None, compile_cache="cold"):
        return self.executor.ExecutionOutcome(
            result=result, manifest_path=manifest_path, compile_cache=compile_cache
        )

    def doc(self, flags, **kw):
        return self.protocol.request_doc(list(flags), **kw)


@functools.lru_cache(maxsize=None)
def pkg_of(name):
    """The one :class:`Pkg` of package ``name`` (``ref`` or ``port``)."""
    return Pkg(name)


class GateExecutor:
    """Stub executor: records (id, slice, batch size) in order; jobs of
    ``block_classes`` wait on ``release``."""

    def __init__(self, pkg, block_classes=("small", "large")):
        self.pkg = pkg
        self.order = []
        self.release = threading.Event()
        self.started = threading.Event()
        self.block_classes = block_classes
        self._lock = threading.Lock()  # lock order: test-local leaf

    @property
    def ids(self):
        with self._lock:
            return [entry[0] for entry in self.order]

    def __call__(self, job, run_dir):
        with self._lock:
            self.order.append((job.id, job.slice, job.batch_size))
        self.started.set()
        if job.job_class in self.block_classes:
            assert self.release.wait(timeout=60), "gate never released"
        return self.pkg.outcome({"stub": True})


def wait_for(predicate, timeout, describe, interval=0.02):
    """Poll ``predicate`` until it returns a truthy value (returned) or
    ``timeout`` seconds pass (the test fails with ``describe()``)."""
    deadline = time.monotonic() + timeout
    tick = threading.Event()
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out after {timeout}s: {describe()}")
        tick.wait(interval)


def wait_status(service, job_id, statuses, timeout=30.0):
    """The job's doc once it reaches one of ``statuses`` on ``service``
    (a 404 while another replica owns it is polled again)."""

    def reached():
        _http, doc = service.job_status(job_id)
        job = doc.get("job")
        return job if job is not None and job.get("status") in statuses else None

    return wait_for(
        reached,
        timeout,
        lambda: f"job {job_id} never reached {sorted(statuses)}: "
        f"{service.job_status(job_id)}; health {service.healthz()}",
    )


def spawn_daemon(run_dir, name, extra=(), env_extra=None):
    """One port ``serve --device cpu`` daemon subprocess; returns
    ``(proc, url)`` once its endpoint file is written."""
    env = dict(os.environ)
    env.pop("SPARK_EXAMPLES_TPU_FAULTS", None)
    env.update(env_extra or {})
    endpoint = os.path.join(run_dir, f"endpoint.{name}")
    argv = [sys.executable, "-m", PACKAGES["port"], "serve", "--device", "cpu", "--port", "0",
            "--run-dir", run_dir, "--endpoint-file", endpoint, *extra]
    err_path = os.path.join(run_dir, f"daemon.{name}.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=err, env=env)

    def listening():
        if os.path.exists(endpoint):
            with open(endpoint, encoding="utf-8") as f:
                return f.read().strip()
        if proc.poll() is not None:
            raise AssertionError(
                f"daemon {name} exited {proc.returncode} before listening: "
                f"{open(err_path).read()[-2000:]}"
            )
        return None

    try:
        url = wait_for(listening, 90, lambda: f"daemon {name} never published {endpoint}")
    except BaseException:
        proc.kill()
        proc.wait(timeout=10)
        raise
    return proc, url


def stop_daemon(proc, timeout=60):
    """SIGTERM (drain) and reap; kill past ``timeout``. Returns the exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode
