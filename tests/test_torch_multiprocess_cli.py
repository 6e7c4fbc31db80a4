"""The port's CLI across two processes on the CPU (gloo): the same flags
with ``--coordinator-address``/``--num-processes``/``--process-id``, each
process's output equal to the one-process run's. These are the shapes the
harness (``tests/test_torch_multihost.py``) does not run through the CLI:
a ring whose data axis crosses processes (``--mesh-shape 2,2``, each
process holding one data slice's ring, the row tiles summed across them),
and the analyses on a mesh spanning the processes."""

import sys

import pytest

from spark_examples_tpu_torch.parallel.multihost import (
    _child_env,
    _free_port,
    _pc_rows,
    _run_children,
)

BASE = ["--device", "cpu", "--num-samples", "12", "--references", "17:0:200000,18:0:100000"]
CASES = {
    "variants-pca ring 2,2": (["variants-pca", "--mesh-shape", "2,2",
                               "--similarity-strategy", "sharded"], None),
    "grm sharded 1,4": (["grm", "--mesh-shape", "1,4", "--similarity-strategy", "sharded"],
                        "--grm-out"),
    "ld-prune 2,2": (["ld-prune", "--mesh-shape", "2,2", "--ld-window-sites", "32"], "--ld-out"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_print_and_write_the_solo_run(tmp_path, case):
    flags, out_flag = CASES[case]
    command = [sys.executable, "-m", "spark_examples_tpu_torch", *flags, *BASE]
    env = _child_env(60)

    def out(name):
        return [out_flag, str(tmp_path / name)] if out_flag else []

    solo = _run_children([command + out("solo.tsv")], env, 60)[0]
    port = _free_port()
    runs = _run_children([
        command + out(f"rank{i}.tsv") + ["--coordinator-address", f"127.0.0.1:{port}",
                                         "--num-processes", "2", "--process-id", str(i)]
        for i in range(2)
    ], env, 60)
    assert solo.returncode == 0, solo.stderr[-2000:]
    for i, run in enumerate(runs):
        assert run.returncode == 0, run.stderr[-2000:]
        assert f"Process {i} of 2 joined" in run.stdout
        if out_flag:
            assert (tmp_path / f"rank{i}.tsv").read_bytes() == (tmp_path / "solo.tsv").read_bytes()
        else:
            assert _pc_rows(run.stdout) == _pc_rows(solo.stdout) != []
