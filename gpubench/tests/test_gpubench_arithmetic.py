"""The harness's arithmetic: the window's rate, the p90 over all jobs, the
roofline's operations and bytes, the busy union and idle gaps of a trace,
the job seeds and the reservoir."""

import json
from types import SimpleNamespace

import pytest

from gpubench import roofline
from gpubench.catalog import Benchmark
from gpubench.devtrace import read_trace, short_name
from gpubench.stats import percentile
from gpubench.traffic import Reservoir, Traffic

BENCH = Benchmark()


def reader(name):
    return BENCH._reader(name)


def jobs(walls, sites=1000, spans=None):
    return [SimpleNamespace(wall_s=w, sites=sites, spans=spans or {}) for w in walls]


def test_rate_is_all_sites_over_the_whole_window():
    ctx = SimpleNamespace(jobs=jobs([0.5, 0.25, 0.25]), window_s=1.25)
    assert reader("pcoa_sites_per_s")(ctx) == 3000 / 1.25


def test_p90_is_nearest_rank_over_every_job():
    walls = [float(i) for i in range(1, 101)]
    ctx = SimpleNamespace(jobs=jobs(walls))
    assert reader("pcoa_job_p90_s")(ctx) == 90.0
    assert percentile([3.0, 1.0, 2.0], 90) == 3.0
    assert percentile([5.0], 90) == 5.0
    assert percentile(list(range(1, 11)), 90) == 9


def test_driver_overhead_is_wall_less_both_stage_spans():
    spans = {"ingest+similarity": 0.2, "center+pca": 0.05}
    ctx = SimpleNamespace(jobs=jobs([0.3, 0.4], spans=spans))
    assert reader("driver.job_overhead_ms")(ctx) == pytest.approx(100.0)
    assert reader("ingest.similarity_ms")(ctx) == pytest.approx(200.0)
    assert reader("pca.center_pca_ms")(ctx) == pytest.approx(50.0)
    assert reader("driver.job_overhead_ms")(SimpleNamespace(jobs=jobs([0.3]))) is None


def test_gram_roofline_bound_at_the_1000_genomes_block():
    n, sites = 2504, 16384
    assert roofline.gram_ops(n, sites) == 2504 * 2505 // 2 * 16384 * 2
    assert roofline.gram_bytes(n, sites) == 2504 * 16384 + 4 * 2504 * 2504
    # The kernel table's 0.0519 ms bound, set by the operations.
    assert roofline.gram_least_seconds(n, sites) * 1e3 == pytest.approx(0.0519, abs=5e-5)
    assert roofline.gram_ops(n, sites) / roofline.PEAK_INT8_OPS_PER_S > (
        roofline.gram_bytes(n, sites) / roofline.PEAK_BYTES_PER_S)


def event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


@pytest.fixture
def hand_trace(tmp_path):
    """Two jobs over [100, 300] µs; kernels at [110, 150], [140, 160] (they
    overlap), a copy at [200, 210] and a kernel outside the stretch."""
    events = [
        event("gpubench.job", "user_annotation", 100, 100),
        event("gpubench.job", "user_annotation", 200, 100),
        event("ingest+similarity", "user_annotation", 106, 90),
        event("center+pca", "user_annotation", 205, 90),
        event("aten::linalg_qr", "cpu_op", 220, 60),
        event("cudaLaunchKernel", "cuda_runtime", 108, 2),
        event("(anonymous namespace)::gram_accumulate_kernel(CUtensorMap_st, int*)", "kernel", 110, 40, tid=7),
        event("(anonymous namespace)::gen_genotypes_kernel", "kernel", 140, 20, tid=7),
        event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 200, 10, tid=7),
        event("void gram_accumulate_kernel<2>(int*, int)", "kernel", 400, 50, tid=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_busy_union_and_idle_share_on_a_hand_made_trace(hand_trace):
    trace = read_trace(hand_trace)
    assert (trace.lo, trace.hi) == (100, 300)
    assert trace.busy_us == 50 + 10  # [110, 160] and [200, 210]
    assert trace.window_s == pytest.approx(200e-6)
    assert trace.op_seconds("gram_accumulate") == pytest.approx(40e-6)
    assert trace.op_seconds("gen_genotypes") == pytest.approx(20e-6)
    ctx = SimpleNamespace(trace=trace)
    assert reader("device.idle_share")(ctx) == pytest.approx(100 * (1 - 60 / 200))


def test_idle_gaps_are_named_by_the_host_range(hand_trace):
    trace = read_trace(hand_trace)
    idle = dict(trace.breakdown()["idle_gaps"])
    # [100, 110] and [160, 200]: under ingest+similarity from 106 to 196;
    # [210, 300]: mid 255, inside center+pca's QR.
    assert idle["gpubench.job"] == pytest.approx(10e-6)
    assert idle["ingest+similarity"] == pytest.approx(40e-6)
    assert idle["center+pca/aten::linalg_qr"] == pytest.approx(90e-6)
    ops = dict(trace.breakdown()["device_ops"])
    assert ops["gram_accumulate_kernel"] == pytest.approx(40e-6)
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert short_name("void at::native::reduce_kernel<512, 1>(int)") == "at::native::reduce_kernel"


def test_roofline_and_generation_readers(hand_trace):
    trace = read_trace(hand_trace)
    ctx = SimpleNamespace(trace=trace, num_samples=2504, traced_kept_sites=[16384],
                          traced_jobs=jobs([1.0], sites=20000))
    share = reader("kernel.gram_accumulate_roofline")(ctx)
    assert share == pytest.approx(100 * roofline.gram_least_seconds(2504, 16384) / 40e-6)
    assert reader("kernel.gen_genotypes.ms_per_msite")(ctx) == pytest.approx(20e-3 / 0.02)
    silent = SimpleNamespace(trace=None)
    assert reader("kernel.gram_accumulate_roofline")(silent) is None
    assert reader("device.idle_share")(silent) is None


def test_job_seeds_are_fixed_by_the_run_seed():
    traffic = Traffic.from_doc("t", {"loop": "closed", "data": "seed_per_job", "warm_jobs": 1,
                                     "checked_jobs": 1, "trace_jobs": 3})
    big = 2**31 + 12345
    seeds = [traffic.job_seed(big, i) for i in range(50)]
    assert seeds == [traffic.job_seed(big, i) for i in range(50)]
    assert len(set(seeds)) == 50 and all(0 <= s < 2**63 for s in seeds)
    assert traffic.job_seed(big + 1, 0) != seeds[0]


def test_reservoir_is_uniform_and_bounded():
    counts = [0] * 10
    for seed in range(4000):
        r = Reservoir(1, seed)
        for i in range(10):
            r.offer(i, i)
        assert len(r.items) == 1
        counts[r.items[0][0]] += 1
    assert min(counts) > 300 and max(counts) < 500
