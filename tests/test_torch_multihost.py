"""Several real processes over ``torch.distributed`` (gloo on the CPU): the
port's ``parallel/multihost.py`` harness, as the JAX package's
``tests/test_multihost.py`` runs its own.

The harness spawns coordinator-connected processes — no mocking — and
every process holds its Gramians (the data axis over the global mesh, the
flat ring whose hops cross processes, the hierarchical ring) against an
oracle it computes alone; here they are also held byte for byte against
the JAX package's one-process Gramian of the same source, region and
seed. The fleet rehearsal runs the ``variants-pca`` CLI alone and across
the processes with host-sharded ingest."""

import json
import subprocess
import sys

import numpy as np
import pytest

from spark_examples_tpu_torch.parallel import multihost


def _jax_gramian_sha256() -> str:
    """The JAX package's one-process Gramian of the harness's workload
    (its device-generation accumulator on one CPU device)."""
    from spark_examples_tpu.ops.devicegen import DeviceGenGramianAccumulator
    from spark_examples_tpu.sharding.contig import parse_contigs
    from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource, af_filter_micro

    source = SyntheticGenomicsSource(
        num_samples=multihost._NUM_SAMPLES, seed=multihost._SEED,
        variant_spacing=multihost._SPACING,
    )
    (contig,) = parse_contigs(multihost._REGION)
    acc = DeviceGenGramianAccumulator(
        num_samples=source.num_samples,
        vs_keys=[source.genotype_stream_key("synthetic-variantset-1")],
        pops=source.populations,
        site_key=source.site_key,
        spacing=source.variant_spacing,
        ref_block_fraction=source.ref_block_fraction,
        min_af_micro=af_filter_micro(multihost._MIN_AF),
        block_size=multihost._BLOCK_SIZE,
        blocks_per_dispatch=multihost._BLOCKS_PER_DISPATCH,
        exact_int=True,
        n_pops=source.n_pops,
    )
    acc.add_grid(*source.site_grid_range(contig))
    return multihost._digest(np.asarray(acc.finalize()).astype(np.int64))


def _check_report(report, processes, local):
    text = json.dumps(report, indent=2)
    for key in ("gramian_ok", "ring_gramian_ok", "hier_gramian_ok", "ring_bytes_ok",
                "counter_aggregation_ok", "result_spans_processes", "cli_ok",
                "cli_outputs_identical", "fleet_host_sharded", "fleet_io_ok",
                "fleet_conformance_ok", "ok"):
        assert report[key], (key, text)
    assert report["fleet_trace_ok"] is True
    assert report["cli_pc_lines"] == multihost._NUM_SAMPLES
    want = _jax_gramian_sha256()
    for child in report["children"]:
        assert child["global_devices"] == processes * local, child
        assert child["local_devices"] == local, child
        assert child["backend"] == "gloo", child
        assert child["hier_schedule_kind"] == "hier", child
        assert child["hier_schedule"]["hosts"] == processes, child
        for key in ("gramian_sha256", "ring_gramian_sha256", "hier_gramian_sha256"):
            assert child[key] == want, (key, child)
        # The rings' hops crossed processes.
        assert child["traffic"]["ring_flat"]["cross_rank_bytes"] > 0, child
    bases = report["fleet_io_reference_bases"]
    assert sum(bases["per_process"]) == bases["solo"]
    assert all(0 < b < bases["solo"] for b in bases["per_process"])
    assert report["fleet_backend"] == ["gloo"] * processes
    # The merged fleet trace passes the reference's validator too.
    from spark_examples_tpu.obs.trace import validate_chrome_trace

    assert validate_chrome_trace(report["fleet_trace"]) == []


def test_two_process_distributed_run():
    """2 processes × 4 CPU positions: the data axis over the global 8
    positions, the ring of 8 whose hops cross the process boundary, the
    two-level ring with host factor 2; the fleet over four contigs reads
    half the solo bases in each process."""
    _check_report(multihost.verify_multihost(num_processes=2, local_devices=4, timeout=90), 2, 4)


def test_three_process_distributed_run_non_power_of_two():
    """3 processes × 2 CPU positions: uneven grid groups over 6 data slices,
    a 6-position ring with 3 of its 6 hops crossing processes, the
    two-level ring factored 3×2, and the fleet's uneven 4-contig split."""
    _check_report(multihost.verify_multihost(num_processes=3, local_devices=2, timeout=90), 3, 2)


def test_child_exits_nonzero_on_bad_coordinator():
    """A process whose coordinator is unreachable fails within its process
    group's timeout — it neither hangs nor falls back to one process."""
    proc = subprocess.run(
        [
            sys.executable, "-c",
            "from spark_examples_tpu_torch.parallel.mesh import distributed_init\n"
            # Port 1 is never listening; a non-coordinator process (id 1)
            # must give up after the timeout rather than retry forever.
            "distributed_init('127.0.0.1:1', 2, 1, timeout=3, device='cpu')",
        ],
        env=multihost._child_env(30),
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert proc.returncode != 0


def test_partial_cluster_flags_rejected():
    """Partly given cluster flags raise the reference's error instead of
    starting a run over a part of the fleet."""
    from spark_examples_tpu_torch.parallel.mesh import distributed_init

    with pytest.raises(ValueError, match="num-processes"):
        distributed_init("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="num-processes"):
        distributed_init(None, 2, 0)
    with pytest.raises(ValueError, match="outside"):
        distributed_init("127.0.0.1:1", 2, 2)


def test_cuda_without_a_card_raises():
    import torch

    from spark_examples_tpu_torch.parallel.mesh import distributed_init

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_init("127.0.0.1:1", 2, 1, timeout=1, device="cuda")


def test_one_process_needs_no_group():
    from spark_examples_tpu_torch.parallel import mesh

    mesh.distributed_init(None, None, None)
    assert (mesh.process_index(), mesh.process_count(), mesh.process_backend()) == (0, 1, None)
    assert multihost.aggregate_host_counts([3, 4]) == [3, 4]
