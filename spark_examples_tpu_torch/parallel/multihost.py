"""Multi-process execution harness: a real ``torch.distributed`` run.

The port of ``spark_examples_tpu/parallel/multihost.py``. The reference's
central operational capability is one job spanning machines — a Spark
cluster addressed through a master URL (``GenomicsConf.scala:50-57``). The
port's analog is several processes, each driving its own positions, joined
through a coordinator into one global mesh (``parallel/mesh.py:
distributed_init``), the hops between them going through
``parallel/collectives.py``.

This module is the executable proof of that capability:

- :func:`child_check` runs inside a coordinator-connected process and
  drives the real accumulators over the global mesh: the data axis of
  device generation (each process generating its slices' spans, the sum
  across processes), the flat ring over a samples-only mesh whose hops
  cross processes, and the hierarchical ring with the process count as its
  host factor. Each Gramian must equal, in every process, an oracle this
  process computes alone: the packed-block host oracle (``--oracle host``,
  small cohorts) or the one-device accumulator (``--oracle device``).
- :func:`verify_multihost` orchestrates the whole thing from one machine:
  it spawns ``num_processes`` children with ``--coordinator-address
  127.0.0.1:<port> --num-processes N --process-id i`` and
  ``--local-devices`` positions each (CPU positions, or positions of one
  card under ``--device cuda``, all ranks of a one-card host sharing it
  over gloo), collects each child's verdict, then runs the unmodified
  ``variants-pca`` CLI once alone and once across a fresh set of
  processes with host-sharded ingest (:func:`_fleet_rehearsal`).

Run it directly for the machine-readable report::

    python -m spark_examples_tpu_torch.parallel.multihost --local-devices 4 --artifact out.json

Every child has a time limit, both as its ``subprocess`` timeout and as
its process group's timeout (``--timeout``), so a bad coordinator or a
lost peer fails the run instead of hanging it. The fleet's processes
record with ``--trace-dir`` into one run directory, whose segments merge
into one Chrome trace (``obs/trace.py:merge_run_trace``, the report's
``fleet_trace``): ``fleet_trace_ok`` holds when it validates and spans one
replica a process (``fleet_trace_errors`` lists what failed).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from spark_examples_tpu_torch.parallel.mesh import DIST_TIMEOUT_ENV

_CHILD_TAG = "MULTIHOST_CHILD "

# The small-but-real workload every child runs by default: the BRCA1 region
# of the flagship config (``SearchVariantsExampleBRCA1.scala:27``) over a
# cohort small enough for a few-second CPU run (the reference's).
_REGION = "17:41196311:41277499"
_NUM_SAMPLES = 24
_SEED = 7
_SPACING = 100
_MIN_AF = 0.01
_BLOCK_SIZE = 64
_BLOCKS_PER_DISPATCH = 2

#: The fleet rehearsal's region set: four equal-width windows, so the
#: host-sharded contig split has real work to balance and every process of
#: a 2–4 process fleet ingests a strict subset of the cohort's sites.
_FLEET_REGIONS = ",".join(f"{ref}:41196311:41277499" for ref in ("17", "18", "19", "20"))


def aggregate_host_counts(values) -> List[int]:
    """Sum small per-process host-side integer counters (I/O stats, ingest
    accounting) across every process of the run — the telemetry analog of
    the finalize sum, behind the manifest's global I/O block. A collective:
    every process calls it at the same point. With one process it is a
    plain int cast."""
    from spark_examples_tpu_torch.parallel.mesh import process_count

    arr = np.asarray(list(values), dtype=np.int64)
    if arr.ndim != 1:
        raise ValueError(f"expected a flat counter vector, got shape {arr.shape}")
    if process_count() == 1:
        return [int(v) for v in arr]
    import torch

    from spark_examples_tpu_torch.parallel.collectives import rank_reduce

    total = rank_reduce(torch.from_numpy(arr.copy()))
    return [int(v) for v in total.tolist()]


def _digest(G: np.ndarray) -> str:
    """SHA-256 of a Gramian's int64 bytes (row-major): what the verdicts
    and the tests compare across packages and processes."""
    return hashlib.sha256(np.ascontiguousarray(G, dtype=np.int64).tobytes()).hexdigest()


def child_check(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_devices: int = 4,
    device: str = "cpu",
    timeout: Optional[float] = None,
    num_samples: int = _NUM_SAMPLES,
    region: str = _REGION,
    block_size: int = _BLOCK_SIZE,
    blocks_per_dispatch: int = _BLOCKS_PER_DISPATCH,
    oracle: str = "host",
) -> Dict[str, object]:
    """Run the distributed Gramian checks inside one coordinator-connected
    process; returns the verdict dict (also the child's JSON line).

    Joins the run (``distributed_init``, the driver's seam), then runs
    three compositions over meshes of ``local_devices`` positions a
    process — the data axis of ``DeviceGenGramianAccumulator`` over the
    global mesh, and the ``DeviceGenRingGramianAccumulator`` ring over a
    samples-only mesh, flat and hierarchical (host factor = process count)
    — and compares each Gramian with the oracle this process computes
    alone."""
    import torch

    from spark_examples_tpu_torch.ops.devicegen import (
        DeviceGenGramianAccumulator,
        DeviceGenRingGramianAccumulator,
    )
    from spark_examples_tpu_torch.parallel import collectives
    from spark_examples_tpu_torch.parallel.mesh import (
        SAMPLES_AXIS,
        default_mesh,
        distributed_init,
        home_device,
        host_value,
        make_mesh,
        process_backend,
    )
    from spark_examples_tpu_torch.sharding.contig import parse_contigs
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
    from spark_examples_tpu_torch.utils.af import af_filter_micro

    distributed_init(coordinator_address, num_processes, process_id, timeout=timeout, device=device)
    home = home_device()
    local = [home] * int(local_devices)
    source = SyntheticGenomicsSource(num_samples=num_samples, seed=_SEED, variant_spacing=_SPACING)
    variant_set = "synthetic-variantset-1"
    (contig,) = parse_contigs(region)
    k0, k1 = source.site_grid_range(contig)
    common = dict(
        num_samples=source.num_samples,
        pops=source.populations,
        site_key=source.site_key,
        spacing=source.variant_spacing,
        ref_block_fraction=source.ref_block_fraction,
        min_af_micro=af_filter_micro(_MIN_AF),
        block_size=block_size,
        blocks_per_dispatch=blocks_per_dispatch,
        n_pops=source.n_pops,
    )
    key = source.genotype_stream_key(variant_set)

    def sync():
        if home.type == "cuda":
            torch.cuda.synchronize(home)

    def timed(run):
        sync()
        collectives.reset_traffic()
        t0 = time.perf_counter()
        out = run()
        sync()
        return out, time.perf_counter() - t0, dict(collectives.TRAFFIC)

    t0 = time.perf_counter()
    if oracle == "host":
        want = np.zeros((num_samples, num_samples), dtype=np.int64)
        for block in source.genotype_blocks(
            variant_set, contig, block_size=block_size, min_allele_frequency=_MIN_AF
        ):
            X = np.asarray(block["has_variation"], dtype=np.int64)
            want += X.T @ X
    else:
        solo = DeviceGenGramianAccumulator(vs_keys=[key], device=home, **common)
        solo.add_grid(k0, k1)
        want = host_value(solo.finalize_device()).astype(np.int64)
    oracle_seconds = time.perf_counter() - t0

    # (a) The data axis over the global mesh: each process generates its
    # slices' grid spans; the slices' sum runs across processes.
    mesh = default_mesh(devices=local)

    def data_axis():
        acc = DeviceGenGramianAccumulator(vs_keys=[key], mesh=mesh, **common)
        acc.add_grid(k0, k1)
        return acc, host_value(acc.finalize_device()).astype(np.int64)

    (acc, gramian), data_seconds, data_traffic = timed(data_axis)
    per_set_rows, kept_sites = acc.ingest_counters()

    # (b), (c) The ring over a samples-only mesh spanning every process:
    # flat (its hops cross processes), then hierarchical with the process
    # count as host factor (only the outer ring crosses).
    ring_mesh = make_mesh({SAMPLES_AXIS: num_processes * int(local_devices)}, local)

    def ring(schedule):
        def run():
            acc = DeviceGenRingGramianAccumulator(
                vs_key=key, mesh=ring_mesh, reduce_schedule=schedule, **common
            )
            acc.add_grid(k0, k1)
            block = acc.schedule_block()
            sharded = acc.finalize_sharded()
            full = host_value(sharded)[:num_samples, :num_samples].astype(np.int64)
            return acc, block, sharded, full

        return timed(run)

    (ring_acc, ring_block, ring_sharded, ring_gramian), ring_seconds, ring_traffic = ring("flat")
    (hier_acc, hier_block, hier_sharded, hier_gramian), hier_seconds, hier_traffic = ring("hier")

    # The manifest's cross-process I/O aggregation must reduce over the same
    # processes as the Gramian collectives: each process contributes
    # (process_id + 1, kept_sites), every process reads the same totals.
    aggregated = aggregate_host_counts([process_id + 1, int(kept_sites)])
    counts_ok = aggregated == [
        num_processes * (num_processes + 1) // 2,
        int(kept_sites) * num_processes,
    ]
    ring_bytes_ok = all(
        b["measured_ring_bytes"] == b["predicted_ring_bytes"] for b in (ring_block, hier_block)
    )
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": int(local_devices),
        "global_devices": len(mesh.flat()),
        "device": str(home),
        "backend": process_backend(),
        "mesh_shape": dict(mesh.shape),
        "result_spans_processes": bool(mesh.spans_processes),
        "gramian_ok": bool(np.array_equal(gramian, want)),
        "gramian_sum": int(gramian.sum()),
        "gramian_sha256": _digest(gramian),
        "oracle": oracle,
        "oracle_sha256": _digest(want),
        "ring_mesh_shape": dict(ring_mesh.shape),
        "ring_spans_processes": bool(ring_mesh.spans_processes),
        "ring_gramian_ok": bool(np.array_equal(ring_gramian, want)),
        "ring_gramian_sha256": _digest(ring_gramian),
        "ring_schedule": ring_block,
        "hier_schedule_kind": hier_block.get("kind"),
        "hier_schedule": hier_block,
        "hier_spans_processes": bool(ring_mesh.spans_processes),
        "hier_gramian_ok": bool(np.array_equal(hier_gramian, want)),
        "hier_gramian_sha256": _digest(hier_gramian),
        "ring_bytes_ok": bool(ring_bytes_ok),
        "counter_aggregation_ok": bool(counts_ok),
        "variant_rows": [int(v) for v in per_set_rows],
        "kept_sites": int(kept_sites),
        "seconds": {
            "oracle": oracle_seconds,
            "data_axis": data_seconds,
            "ring_flat": ring_seconds,
            "ring_hier": hier_seconds,
        },
        "traffic": {"data_axis": data_traffic, "ring_flat": ring_traffic, "ring_hier": hier_traffic},
        "launches": _launch_counts(),
    }


def _launch_counts() -> Dict[str, int]:
    """This process's launches of each hand-written kernel so far (zero
    on the CPU, where the plain versions run)."""
    from spark_examples_tpu_torch.ops import devicegen, gramian

    return {k.__name__: int(k.launches) for k in devicegen.KERNELS + gramian.KERNELS}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(timeout: float, device: str = "cpu") -> Dict[str, str]:
    """Environment for a spawned child: this repo first on the path, the
    process group's timeout (``DIST_TIMEOUT_ENV``), gloo on the loopback
    interface (the harness runs on one machine) and, on the CPU, one
    thread a process so the children do not crowd each other."""
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo_root + (os.pathsep + existing if existing else "")
    env[DIST_TIMEOUT_ENV] = str(float(timeout))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


def _run_children(
    commands: List[List[str]], env: Dict[str, str], timeout: float
) -> List[subprocess.CompletedProcess]:
    """Run coordinator-connected children concurrently and drain all their
    pipes in parallel (a sequential ``communicate()`` loop would deadlock
    if one child fills its pipe while a sibling waits on it in a
    collective). A child past ``timeout`` is killed and reported with
    return code -9; no child outlives this call."""
    procs = [
        subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in commands
    ]

    def drain(proc, cmd):
        try:
            out, err = proc.communicate(timeout=timeout)
            return subprocess.CompletedProcess(cmd, proc.returncode, out, err)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            return subprocess.CompletedProcess(
                cmd, -9, out, (err or "") + f"\n[timed out after {timeout}s]"
            )

    try:
        with ThreadPoolExecutor(max_workers=len(procs)) as pool:
            return list(pool.map(drain, procs, commands))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def verify_multihost(
    num_processes: int = 2,
    local_devices: int = 4,
    timeout: float = 120.0,
    run_cli: bool = True,
    device: str = "cpu",
    num_samples: int = _NUM_SAMPLES,
    region: str = _REGION,
    block_size: int = _BLOCK_SIZE,
    blocks_per_dispatch: int = _BLOCKS_PER_DISPATCH,
    oracle: str = "host",
    fleet_regions: str = _FLEET_REGIONS,
) -> Dict[str, object]:
    """Spawn a real N-process ``torch.distributed`` run on localhost and
    verify it end to end; returns the machine-readable report.

    Phase 1 — :func:`child_check` in every process: the data axis over the
    global mesh, the flat ring whose hops cross processes and the
    hierarchical ring (host factor = process count); every Gramian equals
    the oracle, in every process, and the rings' measured bytes equal
    their prediction.

    Phase 2 (``run_cli``) — :func:`_fleet_rehearsal`: the ``variants-pca``
    CLI alone and across a fleet of processes with host-sharded ingest."""
    env = _child_env(timeout, device)
    port = _free_port()
    check_cmds = [
        [
            sys.executable, "-m", "spark_examples_tpu_torch.parallel.multihost", "--child",
            "--coordinator-address", f"127.0.0.1:{port}",
            "--num-processes", str(num_processes), "--process-id", str(pid),
            "--local-devices", str(local_devices), "--device", device,
            "--timeout", str(timeout), "--num-samples", str(num_samples),
            "--region", region, "--block-size", str(block_size),
            "--blocks-per-dispatch", str(blocks_per_dispatch), "--oracle", oracle,
        ]
        for pid in range(num_processes)
    ]
    t0 = time.perf_counter()
    check_runs = _run_children(check_cmds, env, timeout)
    check_seconds = time.perf_counter() - t0
    children: List[Dict[str, object]] = []
    for run in check_runs:
        verdict: Optional[Dict[str, object]] = None
        for line in run.stdout.splitlines():
            if line.startswith(_CHILD_TAG):
                verdict = json.loads(line[len(_CHILD_TAG):])
        if verdict is None:
            verdict = {
                "gramian_ok": False,
                "error": (run.stderr or "")[-2000:],
                "returncode": run.returncode,
            }
        children.append(verdict)
    gramian_ok = all(c.get("gramian_ok") for c in children) and all(
        r.returncode == 0 for r in check_runs
    )
    ring_ok = all(c.get("ring_gramian_ok") for c in children)
    hier_ok = all(
        c.get("hier_gramian_ok") and c.get("hier_schedule_kind") == "hier" for c in children
    )
    counts_ok = all(c.get("counter_aggregation_ok") for c in children)
    ring_bytes_ok = all(c.get("ring_bytes_ok") for c in children)
    spans = all(
        c.get("result_spans_processes") and c.get("ring_spans_processes")
        and c.get("hier_spans_processes")
        for c in children
    )
    report: Dict[str, object] = {
        "num_processes": num_processes,
        "local_devices_per_process": local_devices,
        "device": device,
        "children": children,
        "check_wall_seconds": check_seconds,
        "gramian_ok": gramian_ok,
        "ring_gramian_ok": ring_ok,
        "hier_gramian_ok": hier_ok,
        "ring_bytes_ok": ring_bytes_ok,
        "counter_aggregation_ok": counts_ok,
        "result_spans_processes": spans,
    }
    ok = gramian_ok and ring_ok and hier_ok and counts_ok and ring_bytes_ok and spans
    if run_cli:
        report.update(_fleet_rehearsal(num_processes, env, timeout, device, fleet_regions, num_samples))
        ok = ok and all(report[k] for k in (
            "cli_ok", "cli_outputs_identical", "fleet_host_sharded", "fleet_io_ok",
            "fleet_conformance_ok", "fleet_trace_ok",
        ))
    report["ok"] = bool(ok)
    return report


def _pc_rows(text: str) -> List[str]:
    """Emitted PC rows (``<callset name>\\t<dataset>\\t<pc>...`` with the
    synthetic source's SxxNxxxxx naming): the result surface of a run,
    without the per-process lines (I/O stats, the host-shard notice, the
    join banner) that differ between fleet members."""
    return [line for line in text.splitlines() if re.match(r"^S\d{2}N\d{5}\t", line)]


def _stage_seconds(manifest: Optional[Dict], name: str) -> Optional[float]:
    for span in (manifest or {}).get("spans", []):
        if span.get("name") == name:
            return span.get("seconds")
    return None


def _fleet_rehearsal(
    num_processes: int,
    env: Dict[str, str],
    timeout: float,
    device: str = "cpu",
    regions: str = _FLEET_REGIONS,
    num_samples: int = _NUM_SAMPLES,
) -> Dict[str, object]:
    """The multi-process full-pipeline rehearsal: the unmodified
    ``variants-pca`` CLI over a multi-contig region, once alone (the
    byte-identity oracle) and once as an N-process coordinator-connected
    fleet with host-sharded ingest. Asserts, machine-readably: every
    process exits 0 and prints PC rows identical to the solo run's; every
    process ingested a strict subset (per-process ``reference_bases`` at
    most ~1/H of solo plus the one contig the split rule may overshoot by,
    summing to the solo total, and the global block every process summed
    collectively equal to it); every manifest's conformance block holds,
    the per-process host-memory pair included; the processes' flight
    recorder segments merge into one valid trace with a replica a
    process."""
    with tempfile.TemporaryDirectory(prefix="multihost-fleet-") as run_dir:
        return _fleet_runs(num_processes, env, timeout, device, regions, num_samples, run_dir)


def _fleet_runs(num_processes, env, timeout, device, regions, num_samples, run_dir):
    fleet_flags = [
        "variants-pca", "--source", "synthetic", "--num-samples", str(num_samples),
        "--references", regions, "--device", device,
    ]
    report: Dict[str, object] = {}
    solo_manifest_path = os.path.join(run_dir, "solo.manifest.json")
    solo_cmd = [
        sys.executable, "-m", "spark_examples_tpu_torch", *fleet_flags,
        "--metrics-json", solo_manifest_path,
    ]
    t0 = time.perf_counter()
    solo = _run_children([solo_cmd], env, timeout)[0]
    solo_seconds = time.perf_counter() - t0
    solo_rows = _pc_rows(solo.stdout)

    port = _free_port()
    manifest_paths = [
        os.path.join(run_dir, f"fleet.{pid}.manifest.json") for pid in range(num_processes)
    ]
    cli_cmds = [
        [
            sys.executable, "-m", "spark_examples_tpu_torch", *fleet_flags,
            "--coordinator-address", f"127.0.0.1:{port}",
            "--num-processes", str(num_processes), "--process-id", str(pid),
            "--metrics-json", manifest_paths[pid], "--trace-dir", run_dir,
        ]
        for pid in range(num_processes)
    ]
    t0 = time.perf_counter()
    cli_runs = _run_children(cli_cmds, env, timeout)
    fleet_seconds = time.perf_counter() - t0
    # Process wall clocks (start-up included: the operator's view of a cold
    # fleet run); the ingest split itself shows in the per-process bases.
    report["fleet_wall_seconds"] = {"solo": solo_seconds, "fleet": fleet_seconds}
    cli_ok = solo.returncode == 0 and all(run.returncode == 0 for run in cli_runs)
    fleet_rows = [_pc_rows(run.stdout) for run in cli_runs]
    report["cli_ok"] = cli_ok
    report["cli_outputs_identical"] = bool(solo_rows) and all(rows == solo_rows for rows in fleet_rows)
    report["cli_pc_lines"] = len(solo_rows)
    if not cli_ok:
        report["cli_errors"] = [
            (run.stderr or "")[-2000:] for run in [solo, *cli_runs] if run.returncode
        ]
    report["fleet_host_sharded"] = all(
        "Host-sharded ingest: process" in run.stdout for run in cli_runs
    )

    def load(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    manifests = [load(path) for path in manifest_paths]
    solo_manifest = load(solo_manifest_path)
    try:
        solo_bases = int(solo_manifest["io_stats"]["reference_bases"])
    except (TypeError, KeyError, ValueError):
        solo_bases = 0
    local_bases = [
        int((m or {}).get("io_stats", {}).get("reference_bases", -1)) for m in manifests
    ]
    fractions = [(b / solo_bases if solo_bases > 0 else -1.0) for b in local_bases]
    report["fleet_io_reference_bases"] = {"solo": solo_bases, "per_process": local_bases}
    report["fleet_backend"] = [((m or {}).get("process") or {}).get("backend") for m in manifests]
    report["fleet_stage_seconds"] = {
        "solo": _stage_seconds(solo_manifest, "ingest+similarity"),
        "per_process": [_stage_seconds(m, "ingest+similarity") for m in manifests],
    }
    global_ok = all(
        int(((m or {}).get("multihost") or {}).get("io_stats_global", {}).get("reference_bases", -1))
        == solo_bases
        for m in manifests
    )
    # Each process's share overshoots its 1/H fair share by at most the one
    # contig that closes its partition; the partition itself is exact.
    report["fleet_io_ok"] = bool(
        solo_bases > 0
        and sum(local_bases) == solo_bases
        and all(0 <= f <= 1.0 / num_processes + 0.26 for f in fractions)
        and global_ok
    )
    conformance_ok = True
    for m in manifests:
        block = (m or {}).get("conformance")
        if not isinstance(block, dict):
            conformance_ok = False
            continue
        hostmem = block.get("hostmem")
        if not isinstance(hostmem, dict) or hostmem.get("ok") is not True:
            conformance_ok = False
        if any(isinstance(pair, dict) and pair.get("ok") is False for pair in block.values()):
            conformance_ok = False
    report["fleet_conformance_ok"] = bool(conformance_ok)
    report.update(_fleet_trace(run_dir, num_processes))
    return report


def _fleet_trace(run_dir: str, num_processes: int) -> Dict[str, object]:
    """The fleet's merged trace and the reference's rule for it: it
    validates, and it spans one replica a process."""
    from spark_examples_tpu_torch.obs.trace import merge_run_trace, validate_chrome_trace

    doc = None
    try:
        doc = merge_run_trace(run_dir)
        errors = list(validate_chrome_trace(doc))
        replicas = {
            e.get("args", {}).get("name", "")
            for e in doc.get("traceEvents", [])
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        if len(replicas) != num_processes:
            errors.append(
                f"merged trace spans {len(replicas)} replicas, "
                f"expected {num_processes}: {sorted(replicas)}"
            )
    except Exception as e:  # the failure is the report's finding
        errors = [f"{type(e).__name__}: {e}"]
    report: Dict[str, object] = {"fleet_trace_ok": not errors, "fleet_trace": doc}
    if errors:
        report["fleet_trace_errors"] = errors[:20]
    return report


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="multi-process torch.distributed verification run")
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--local-devices", type=int, default=4)
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    parser.add_argument("--timeout", type=float, default=120.0,
                        help="Seconds each child may take, and its process group's timeout.")
    parser.add_argument("--num-samples", type=int, default=_NUM_SAMPLES)
    parser.add_argument("--region", default=_REGION)
    parser.add_argument("--block-size", type=int, default=_BLOCK_SIZE)
    parser.add_argument("--blocks-per-dispatch", type=int, default=_BLOCKS_PER_DISPATCH)
    parser.add_argument("--oracle", choices=["host", "device"], default="host")
    parser.add_argument("--fleet-regions", default=_FLEET_REGIONS)
    parser.add_argument("--artifact", default=None)
    args = parser.parse_args(argv)

    if args.child:
        from spark_examples_tpu_torch.parallel.mesh import distributed_shutdown

        verdict = child_check(
            args.coordinator_address, args.num_processes, args.process_id,
            local_devices=args.local_devices, device=args.device, timeout=args.timeout,
            num_samples=args.num_samples, region=args.region, block_size=args.block_size,
            blocks_per_dispatch=args.blocks_per_dispatch, oracle=args.oracle,
        )
        distributed_shutdown()
        print(_CHILD_TAG + json.dumps(verdict), flush=True)
        return 0 if all(verdict[k] for k in (
            "gramian_ok", "ring_gramian_ok", "hier_gramian_ok", "counter_aggregation_ok",
            "ring_bytes_ok",
        )) else 1

    report = verify_multihost(
        num_processes=args.num_processes, local_devices=args.local_devices,
        timeout=args.timeout, device=args.device,
        num_samples=args.num_samples, region=args.region, block_size=args.block_size,
        blocks_per_dispatch=args.blocks_per_dispatch, oracle=args.oracle,
        fleet_regions=args.fleet_regions,
    )
    print(json.dumps(report, indent=2))
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
