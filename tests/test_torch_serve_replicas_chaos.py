"""Two port replica daemons as real processes, one SIGKILLed at a serve
kill point, the survivor's outcome held to a clean run's.

The port's counterpart of the reference's
``tests/test_serve_replicas_chaos.py``, at two of its kill points:

- ``serve.worker.claim``: replica ``a`` dies after claiming the job and
  before any device work; the survivor ``b`` steals it, runs it once
  (one ``began`` in the journal) and its PC rows equal the port's batch
  run of the same flags, byte for byte;
- ``serve.lease.pre-renew``: ``a`` dies at its first lease renewal with a
  job in hand (the canonical host loss); the job reaches exactly one
  valid terminal on ``b`` — the clean run's rows when its device work had
  not begun, the structured ``replica-failover:`` error when it had.

Each daemon is ``python -m spark_examples_tpu_torch serve --device cpu``
with the plan in ``SPARK_EXAMPLES_TPU_FAULTS``. The killed replica holds
a 0.3 s lease, renewed every 0.1 s; at ``serve.lease.pre-renew`` its job
is 32 samples over 200,001 sites (about 0.8 s on the CPU), so several
renewals come while the job is in hand. The survivor holds a 3 s lease,
out of reach of a stalled renewal thread.
"""

import contextlib
import io
import json
import os
import signal

from torch_serve_helpers import spawn_daemon, stop_daemon, wait_for

from spark_examples_tpu_torch.serve.client import ServeClient, ServeError
from spark_examples_tpu_torch.serve.journal import journal_path, replay_journal
from spark_examples_tpu_torch.serve.protocol import TERMINAL_STATUSES

CHAOS_FLAGS = ["--num-samples", "8", "--references", "1:0:50000"]
LONG_FLAGS = ["--num-samples", "32", "--references", "1:0:20000000"]
SURVIVOR_LEASE = ["--lease-seconds", "3.0", "--lease-grace-seconds", "0.2",
                  "--steal-interval-seconds", "0.2"]
VICTIM_LEASE = ["--lease-seconds", "0.3", "--lease-grace-seconds", "0.2",
                "--steal-interval-seconds", "0.2"]
COMMON = ["--executor-slices", "0", "--no-persistent-cache"]


def _oracle_lines(flags):
    """The clean run: the port's batch pipeline on the same flags."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    with contextlib.redirect_stdout(io.StringIO()):
        return run_pipeline(PcaConf.parse(list(flags) + ["--device", "cpu"])).lines


def _journal_facts(run_dir, job_id):
    """(began records, valid terminal records, settled) for one job."""
    lease_epoch, began, terminals = 0, 0, []
    with open(journal_path(run_dir), encoding="utf-8") as f:
        for line in f:
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if record.get("id") != job_id:
                continue
            if record["event"] == "began":
                began += 1
            elif record["event"] == "lease":
                lease_epoch = max(lease_epoch, record.get("epoch", 0))
            elif record["event"] == "terminal":
                terminals.append(record)
    valid = [t for t in terminals if t.get("epoch") is None or t["epoch"] >= lease_epoch]
    pending, _ = replay_journal(journal_path(run_dir))
    return began, len(valid), job_id not in {p.job_id for p in pending}


def _terminal_on(client, job_id, timeout=60):
    def settled():
        try:
            job = client.status(job_id)["job"]
        except ServeError as e:
            if e.status != 404:  # 404 until the survivor has stolen it
                raise
            return None
        return job if job["status"] in TERMINAL_STATUSES else None

    return wait_for(settled, timeout, lambda: f"job {job_id} never settled on the survivor",
                    interval=0.1)


def _submit_to_victim(url, run_dir, flags):
    """Submit the chaos job to the replica that is about to die. Its kill
    point may fire before the 202 is written (the worker claims the job the
    moment it is queued), so a lost reply is no failure: the accepted
    record, journaled before the job could be claimed, names the job."""
    try:
        return ServeClient(url, timeout=30).submit(flags)["job"]["id"]
    except (ServeError, OSError):
        with open(journal_path(run_dir), encoding="utf-8") as f:
            accepted = [line for line in f if '"accepted"' in line]
        assert len(accepted) == 1, accepted
        return json.loads(accepted[0])["id"]


def _kill_scenario(tmp_path, site, flags):
    run_dir = str(tmp_path / "rd")
    os.makedirs(run_dir)
    a_proc, a_url = spawn_daemon(run_dir, "a", COMMON + ["--replica-id", "a"] + VICTIM_LEASE,
                                 env_extra={"SPARK_EXAMPLES_TPU_FAULTS": f"kill@{site}"})
    b_proc = None
    try:
        b_proc, b_url = spawn_daemon(run_dir, "b", COMMON + ["--replica-id", "b"] + SURVIVOR_LEASE)
        job_id = _submit_to_victim(a_url, run_dir, flags)
        assert job_id.startswith("job-a-")
        a_rc = a_proc.wait(timeout=60)
        job = _terminal_on(ServeClient(b_url, timeout=30, max_retries=5), job_id)
        assert stop_daemon(b_proc) == 0
        return job, run_dir, a_rc
    finally:
        for proc in (b_proc, a_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def test_kill_at_worker_claim_survivor_reruns_byte_identical(tmp_path):
    job, run_dir, a_rc = _kill_scenario(tmp_path, "serve.worker.claim", CHAOS_FLAGS)
    assert a_rc == -signal.SIGKILL
    assert job["status"] == "done", job
    assert job["result"]["pc_lines"] == _oracle_lines(CHAOS_FLAGS)
    began, valid, settled = _journal_facts(run_dir, job["id"])
    assert settled and valid == 1 and began == 1


def test_kill_at_lease_pre_renew_exactly_one_outcome(tmp_path):
    job, run_dir, a_rc = _kill_scenario(tmp_path, "serve.lease.pre-renew", LONG_FLAGS)
    assert a_rc == -signal.SIGKILL
    began, valid, settled = _journal_facts(run_dir, job["id"])
    assert settled and valid == 1 and began == 1
    if job["status"] == "done":
        assert job["result"]["pc_lines"] == _oracle_lines(LONG_FLAGS)
    else:
        assert job["status"] == "failed" and job["error"].startswith("replica-failover:"), job
