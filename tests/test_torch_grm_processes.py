"""``grm`` across two processes: a divergence from the JAX package, kept on
purpose.

The JAX package's ``grm`` feeds every site to the driver in each process
(``spark_examples_tpu/analyses/grm.py:182-192``) while its driver plans
host-sharded ingest all the same (``pipeline/pca_driver.py:498-582``): each
process accumulates every site on a process-local mesh and
``_merge_host_partials`` sums the partials, so each site's XᵀX counts once
a process while the host moments count it once. Its two-process kinship
then differs from its one-process kinship. The port builds the grm driver
with ``shard_ingest=False`` (``analyses/grm.py``), so its two processes
write the reference's one-process kinship. This test holds both halves,
on the CPU: the reference as ``spark_examples_tpu/parallel/multihost.py``'s
harness runs it (two virtual CPU devices a process), the port over gloo at
``--device cpu``, 24 samples over four windows of chr17-20."""

import sys
import threading

from spark_examples_tpu.parallel import multihost as ref_multihost
from spark_examples_tpu_torch.parallel import multihost

WINDOWS = ",".join(f"{contig}:41196311:41277499" for contig in (17, 18, 19, 20))
FLAGS = ["grm", "--num-samples", "24", "--references", WINDOWS]
TIMEOUT = 120


def _processes(package, flags, out, port):
    return [
        [sys.executable, "-m", package, *flags, "--grm-out", f"{out}{i}.tsv",
         "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)]
        for i in range(2)
    ]


def test_two_process_grm_port_writes_the_reference_solo_kinship(tmp_path):
    ref_env, port_env = ref_multihost._child_env(2), multihost._child_env(TIMEOUT)
    groups = {
        "reference solo": ([[sys.executable, "-m", "spark_examples_tpu", *FLAGS, "--grm-out",
                             str(tmp_path / "ref_solo.tsv")]], ref_env),
        "reference processes": (_processes("spark_examples_tpu", FLAGS, tmp_path / "ref",
                                           ref_multihost._free_port()), ref_env),
        "port processes": (_processes("spark_examples_tpu_torch", FLAGS + ["--device", "cpu"],
                                      tmp_path / "port", multihost._free_port()), port_env),
    }
    runs = {}

    def run(name):
        commands, env = groups[name]
        runs[name] = ref_multihost._run_children(commands, env, TIMEOUT)

    threads = [threading.Thread(target=run, args=(name,)) for name in groups]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    for name, results in runs.items():
        for result in results:
            assert result.returncode == 0, (name, result.stderr[-2000:])
    for i, result in enumerate(runs["port processes"]):
        assert f"Process {i} of 2 joined" in result.stdout
    solo = (tmp_path / "ref_solo.tsv").read_bytes()
    reference = [(tmp_path / f"ref{i}.tsv").read_bytes() for i in range(2)]
    port = [(tmp_path / f"port{i}.tsv").read_bytes() for i in range(2)]
    assert solo.count(b"\n") == 25  # the header and a row a sample
    # The reference's processes agree with each other, not with its solo run.
    assert reference[0] == reference[1] != solo
    # The port's processes write the reference's one-process kinship.
    assert port[0] == port[1] == solo
