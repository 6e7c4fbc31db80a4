"""Stacked jobs (``ops/batched.py``) and the fused group runner
(``pipeline/fused.py``) of the port against the JAX package, on the CPU.

Inputs come from numpy seeds. Every port lane equals the reference's
stacked lane (whose float32 entries are exact integers) and the port's
serial ``GramianAccumulator`` byte for byte; ``steps`` is the reference's;
both packages refuse the same groups with the same messages; the group
runner's Gramians equal the reference runner's, its PCs agree within the
pipeline tests' 1e-4 after sign, and its summaries equal the reference's
but for ``dtype`` (the port's accumulator is int32, the reference's CPU
one float32). The fingerprints and the warm-geometry ledger are the
reference's, digest for digest and count for count."""

import contextlib
import io

import numpy as np
import pytest
import torch

from spark_examples_tpu.config import PcaConf as RefConf
from spark_examples_tpu.ops import batched as ref_batched
from spark_examples_tpu.pipeline import fused as ref_fused
from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu.utils import cache as ref_cache
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.ops import batched, gramian
from spark_examples_tpu_torch.pipeline import fused, pca_driver
from spark_examples_tpu_torch.utils import cache

TOLERANCE = 1e-4
TINY = ["--num-samples", "8", "--references", "1:0:50000"]
#: Three windows of chr17-20 at 24 samples, one a lane: ragged lanes.
WINDOWS = ("17:41196311:41226311", "18:41196311:41216311", "20:41196311:41241311")
GROUP = ["--num-samples", "24", "--block-size", "64", "--ingest", "packed"]


def _ref_conf(flags):
    return RefConf.parse(["--pca-backend", "tpu", *flags])


def _port_conf(flags):
    return PcaConf.parse(["--device", "cpu", *flags])


def _lane_rows(num_lanes, num_samples, seed=11):
    """The reference test's ragged {0,1} lanes: lengths straddle block
    boundaries and differ lane to lane."""
    rng = np.random.default_rng(seed)
    lengths = [3 + 4 * lane + lane % 2 for lane in range(num_lanes)]
    return [rng.integers(0, 2, size=(n, num_samples)).astype(np.uint8) for n in lengths]


def _cap_device_bytes(num_samples, cap):
    per_job = gramian._DENSE_BUFFERS * num_samples**2 * 4
    return int(cap * per_job / gramian.DENSE_HBM_FRACTION) + 1


def _feed(acc, rows_per_lane, chunk=3):
    """Interleaved uneven feeds: lanes reach block boundaries at different
    steps, so the lockstep drain queues pending operands."""
    cursors = [0] * len(rows_per_lane)
    while any(c < len(r) for c, r in zip(cursors, rows_per_lane)):
        for lane, rows in enumerate(rows_per_lane):
            if cursors[lane] < len(rows):
                acc.add_rows(lane, rows[cursors[lane]:cursors[lane] + chunk])
                cursors[lane] += chunk
    for lane in range(len(rows_per_lane)):
        acc.finish_lane(lane)
    return acc.finalize()


def _serial(rows, num_samples, block_size):
    acc = gramian.GramianAccumulator(num_samples, device="cpu", block_size=block_size)
    if len(rows):
        acc.add_rows(rows)
    return acc.finalize_device()


def _assert_lane(got: torch.Tensor, ref_lane, serial: torch.Tensor):
    ref_lane = np.asarray(ref_lane)
    assert np.array_equal(ref_lane, np.trunc(ref_lane))
    assert got.dtype == serial.dtype == torch.int32
    assert got.numpy().tobytes() == serial.numpy().tobytes()
    assert got.numpy().tobytes() == ref_lane.astype(np.int32).tobytes()


@pytest.mark.parametrize("group", ["one", "two", "max"])
def test_stacked_parity_matrix(group):
    """Groups of 1, 2 and the memory cap (5), 16 samples, blocks of 4: each
    lane equals the reference's stacked lane and the port's serial run, and
    the group stepped as often as the reference's (once a block of the
    longest lane)."""
    num_samples, block_size = 16, 4
    if group == "max":
        device_bytes = _cap_device_bytes(num_samples, 5)
        k = batched.max_fused_jobs(num_samples, device_bytes=device_bytes)
        assert k == ref_batched.max_fused_jobs(num_samples, device_bytes=device_bytes) == 5
    else:
        k = {"one": 1, "two": 2}[group]
    rows = _lane_rows(k, num_samples)
    ref = ref_batched.StackedJobsAccumulator(num_jobs=k, num_samples=num_samples,
                                             block_size=block_size)
    port = batched.StackedJobsAccumulator(k, num_samples, device="cpu", block_size=block_size)
    _feed(ref, rows)
    _feed(port, rows)
    for lane in range(k):
        _assert_lane(port.job_slice(lane), ref.job_slice(lane),
                     _serial(rows[lane], num_samples, block_size))
    assert port.steps == ref.steps == max(-(-len(r) // block_size) for r in rows)


def test_stacked_ragged_group_with_an_empty_lane():
    """A lane with no rows at all finishes first; its slice is zero, the
    others drain over its zero operands, as in the reference."""
    num_samples, block_size = 16, 4
    rows = [
        np.zeros((0, num_samples), dtype=np.uint8),
        _lane_rows(1, num_samples, seed=3)[0][:5],
        _lane_rows(1, num_samples, seed=5)[0][:3].repeat(4, axis=0)[:11],
    ]
    accs = (ref_batched.StackedJobsAccumulator(num_jobs=3, num_samples=num_samples,
                                               block_size=block_size),
            batched.StackedJobsAccumulator(3, num_samples, device="cpu", block_size=block_size))
    for acc in accs:
        acc.finish_lane(0)
        acc.add_rows(1, rows[1])
        acc.add_rows(2, rows[2])
        acc.finish_lane(1)
        acc.finish_lane(2)
        acc.finalize()
    ref, port = accs
    for lane in range(3):
        _assert_lane(port.job_slice(lane), ref.job_slice(lane),
                     _serial(rows[lane], num_samples, block_size))
    assert not port.job_slice(0).any()
    assert port.steps == ref.steps


def test_stacked_refuses_count_valued_rows():
    """Count-valued rows (a same-set join) refuse in both packages, with the
    same message."""
    counts = np.full((4, 16), 2, dtype=np.uint8)
    messages = []
    for acc in (ref_batched.StackedJobsAccumulator(num_jobs=2, num_samples=16, block_size=4),
                batched.StackedJobsAccumulator(2, 16, device="cpu", block_size=4)):
        with pytest.raises(ref_batched.FusedIneligible if acc.__module__.startswith(
                "spark_examples_tpu.") else batched.FusedIneligible, match="count-valued") as e:
            acc.add_rows(0, counts)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_stacked_refuses_a_lane_past_the_f32_exact_window(monkeypatch):
    """With the f32 exact window made small, the block that would carry a
    lane past it refuses in both packages at the same block, with the same
    message; with --exact-similarity neither refuses."""
    monkeypatch.setattr(ref_batched, "EXACT_F32_LIMIT", 10)
    monkeypatch.setattr(batched, "EXACT_F32_LIMIT", 10)
    rows = np.ones((12, 16), dtype=np.uint8)
    messages = []
    for acc in (ref_batched.StackedJobsAccumulator(num_jobs=1, num_samples=16, block_size=4),
                batched.StackedJobsAccumulator(1, 16, device="cpu", block_size=4)):
        acc.add_rows(0, rows[:8])
        with pytest.raises(RuntimeError, match="f32 exact window") as e:
            acc.add_rows(0, rows[8:])
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    exact = batched.StackedJobsAccumulator(1, 16, device="cpu", block_size=4, exact_int=True)
    exact.add_rows(0, rows)
    exact.finish_lane(0)
    assert int(exact.finalize()[0, 0, 0]) == 12


def test_max_fused_jobs_equals_the_reference_over_a_grid():
    for n in (1, 8, 17, 130, 2504, 25_000, 100_000):
        for budget in (None, 1 << 20, 16 << 30, 80 * 10**9, 85_029_158_912):
            for accum in (4, 8):
                assert batched.max_fused_jobs(n, accum, budget) == ref_batched.max_fused_jobs(
                    n, accum, budget), (n, budget, accum)


def test_load_reference_state_resumes_the_reference_group():
    """A group fed halfway in the reference, its state (G, bounds, rows,
    steps, staged and pending blocks) loaded into the port, then finished in
    both: every lane equal."""
    num_samples, block_size, k = 16, 4, 3
    rng = np.random.default_rng(23)
    rows = [(rng.random((size, num_samples)) < 0.4).astype(np.uint8) for size in (9, 14, 20)]
    halfway = (6, 9, 10)
    ref = ref_batched.StackedJobsAccumulator(num_jobs=k, num_samples=num_samples,
                                             block_size=block_size)
    for lane in range(k):
        ref.add_rows(lane, rows[lane][: halfway[lane]])
    assert any(ref._pending) and all(ref._fill) and ref.steps == 1
    port = batched.StackedJobsAccumulator(k, num_samples, device="cpu", block_size=block_size)
    batched.load_reference_state(
        port, np.asarray(ref.G), ref._entry_bound, rows_seen=ref.rows_seen, steps=ref.steps,
        fill=ref._fill, staging=ref._staging, pending=ref._pending, finished=ref._finished,
    )
    for acc in (ref, port):
        for lane in range(k):
            acc.add_rows(lane, rows[lane][halfway[lane]:])
            acc.finish_lane(lane)
        acc.finalize()
    for lane in range(k):
        _assert_lane(port.job_slice(lane), ref.job_slice(lane),
                     _serial(rows[lane], num_samples, block_size))
    assert port.steps == ref.steps and port.rows_seen == ref.rows_seen
    with pytest.raises(ValueError, match="must be"):
        batched.load_reference_state(port, np.zeros((2, 16, 16)), [0, 0])


# ------------------------------------------------------------- preflight

#: One case a check of ``preflight_fused``: the group's flag lists (the
#: port's; the reference's take the same with its backend name), its kinds
#: and the device budget.
PREFLIGHT = {
    "eligible pair": ([TINY, TINY], ["pca", "pca"], None),
    "eligible similarity triple": ([TINY] * 3, ["similarity"] * 3, None),
    "mixed kinds": ([TINY, TINY], ["pca", "similarity"], None),
    "unfusable kind": ([TINY, TINY], ["grm", "grm"], None),
    "kinds and confs differ": ([TINY, TINY], ["pca"], None),
    "file source": ([TINY + ["--source", "file", "--input-files", "x.vcf"], TINY],
                    ["pca", "pca"], None),
    "sharded strategy": ([TINY, TINY + ["--similarity-strategy", "sharded"]],
                         ["pca", "pca"], None),
    "mismatched N": ([TINY, ["--num-samples", "16", "--references", "1:0:50000"]],
                     ["pca", "pca"], None),
    "mismatched block": ([TINY, TINY + ["--block-size", "512"]], ["pca", "pca"], None),
    "mismatched exactness": ([TINY, TINY + ["--exact-similarity"]], ["pca", "pca"], None),
    "checkpoints": ([TINY + ["--gramian-checkpoint-dir", "ck"], TINY], ["pca", "pca"], None),
    "resume": ([TINY, TINY + ["--resume-from", "ck"]], ["pca", "pca"], None),
    "fault plan": ([TINY + ["--fault-plan", "kill@driver.post-flush#2"], TINY],
                   ["pca", "pca"], None),
    "wire ingest": ([TINY + ["--ingest", "wire"], TINY], ["pca", "pca"], None),
    "two variant sets": ([TINY + ["--variant-set-id", "a,b"], TINY], ["pca", "pca"], None),
    "host backend": ([TINY + ["--pca-backend", "host"], TINY], ["pca", "pca"], None),
    "save variants": ([TINY + ["--save-variants", "out"], TINY], ["pca", "pca"], None),
    "input path": ([TINY + ["--input-path", "ck"], TINY], ["pca", "pca"], None),
    "over the cap": ([TINY, TINY], ["pca", "pca"], _cap_device_bytes(8, 1)),
    "dense rule": ([["--num-samples", "40000", "--references", "1:0:5000"]] * 2,
                   ["pca", "pca"], None),
}


def _reference_flags(flags):
    """The reference's spelling of a port flag list (its device backend is
    ``tpu``)."""
    return [("tpu" if f == "gpu" else f) for f in flags]


@pytest.mark.parametrize("case", sorted(PREFLIGHT))
def test_preflight_refuses_what_the_reference_refuses(case):
    """Each check of ``preflight_fused``: both packages accept (the same K)
    or both refuse, with the same message but for the backend's name."""
    flag_lists, kinds, budget = PREFLIGHT[case]
    outcomes = []
    for preflight, make, error in (
        (ref_fused.preflight_fused, lambda f: _ref_conf(_reference_flags(f)),
         ref_batched.FusedIneligible),
        (fused.preflight_fused, _port_conf, batched.FusedIneligible),
    ):
        confs = [make(flags) for flags in flag_lists]
        if case == "host backend":
            assert confs[0].pca_backend == "host"
        try:
            outcomes.append(("accepts", preflight(confs, kinds, device_bytes=budget)))
        except error as e:
            outcomes.append(("refuses", str(e).replace("'tpu'", "'gpu'")))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "accepts") == case.startswith("eligible")


def test_preflight_refuses_check_ranges_as_the_reference_does():
    """``--check-ranges`` (per-accumulator telemetry, set here on the
    conf) refuses a fused group in both packages."""
    ref, port = _ref_conf(TINY), _port_conf(TINY)
    ref.check_ranges = port.check_ranges = True
    with pytest.raises(ref_batched.FusedIneligible, match="check-ranges") as want:
        ref_fused.preflight_fused([ref, _ref_conf(TINY)], ["pca", "pca"])
    with pytest.raises(batched.FusedIneligible, match="check-ranges") as got:
        fused.preflight_fused([port, _port_conf(TINY)], ["pca", "pca"])
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- the runner


class _RecordingStack(ref_batched.StackedJobsAccumulator):
    """The reference's stacked accumulator, kept so a test can read its
    Gramians (its runner returns none)."""

    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _RecordingStack.made.append(self)


def _pc_matrix(lines):
    return np.array([line.split("\t")[2:] for line in lines], dtype=float)


@pytest.mark.parametrize("kind", ["pca", "similarity"])
def test_run_fused_pipeline_on_the_cpu_equals_the_reference_runner(kind, monkeypatch):
    """Groups of 3 lanes at 24 samples over windows of chr17-20: every lane's
    Gramian equals the reference runner's lane and the port's serial run;
    PC rows agree with the reference's within 1e-4 after sign (names and
    datasets equal) and equal the serial port run's; summaries equal but
    for dtype; each job prints into its own log."""
    monkeypatch.setattr(ref_fused, "StackedJobsAccumulator", _RecordingStack)
    _RecordingStack.made.clear()
    flag_lists = [GROUP + ["--references", window] for window in WINDOWS]
    logs = {}

    @contextlib.contextmanager
    def job_log(j):
        with contextlib.redirect_stdout(logs.setdefault(j, io.StringIO())):
            yield

    with contextlib.redirect_stdout(io.StringIO()):
        want = ref_fused.run_fused_pipeline([_ref_conf(f) for f in flag_lists], [kind] * 3)
    got = fused.run_fused_pipeline([_port_conf(f) for f in flag_lists], [kind] * 3,
                                   devices=["cpu"], stdout_factory=job_log)
    ref_acc = _RecordingStack.made[-1]
    acc = got[0].driver.accumulator
    assert acc.steps == ref_acc.steps > 1
    for j, flags in enumerate(flag_lists):
        with contextlib.redirect_stdout(io.StringIO()):
            serial = pca_driver.run_pipeline(_port_conf(flags))
        _assert_lane(acc.job_slice(j), ref_acc.job_slice(j), serial.driver.accumulator.G)
        assert got[j].driver.accumulator is acc
        assert "Matrix size: 24." in logs[j].getvalue()
        if kind == "pca":
            assert got[j].lines == serial.lines
            assert [l.split("\t")[:2] for l in got[j].lines] == [
                l.split("\t")[:2] for l in want[j].lines]
            pcs, ref_pcs = _pc_matrix(got[j].lines), _pc_matrix(want[j].lines)
            pcs *= np.sign((pcs * ref_pcs).sum(axis=0))
            np.testing.assert_allclose(pcs, ref_pcs, rtol=0, atol=TOLERANCE)
            assert got[j].similarity_summary is None
        else:
            assert got[j].lines == want[j].lines == []
            summary, ref_summary = got[j].similarity_summary, want[j].similarity_summary
            assert (summary["dtype"], ref_summary["dtype"]) == ("int32", "float32")
            assert {**summary, "dtype": None} == {**ref_summary, "dtype": None}
        spans = [s["path"] for s in got[j].driver.spans.flat()]
        assert "ingest+similarity" in spans and (("center+pca" in spans) == (kind == "pca"))


def test_run_fused_pipeline_writes_each_jobs_manifest(tmp_path):
    flag_lists = [GROUP + ["--references", w, "--metrics-json", str(tmp_path / f"m{j}.json")]
                  for j, w in enumerate(WINDOWS[:2])]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        results = fused.run_fused_pipeline([_port_conf(f) for f in flag_lists], ["pca"] * 2,
                                           devices=["cpu"])
    from spark_examples_tpu_torch.obs.manifest import validate_manifest

    for j, result in enumerate(results):
        assert result.manifest_path == str(tmp_path / f"m{j}.json")
        assert validate_manifest(result.manifest) == []
        assert result.manifest["io_stats"]["variants"] > 0
        assert set(result.manifest["compile_cache"]) == {
            "dir", "entries", "geometry_hits", "geometry_misses"}
    assert f"Run manifest written to {tmp_path / 'm1.json'}." in out.getvalue()


def test_run_fused_pipeline_raises_without_a_card_when_one_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.run_fused_pipeline([PcaConf.parse(TINY)] * 2, ["pca"] * 2)


# ------------------------------------------------- similarity-only, ledger


def test_similarity_only_run_pipeline_summary_equals_the_reference():
    flags = GROUP + ["--references", WINDOWS[0]]
    with contextlib.redirect_stdout(io.StringIO()):
        want = ref_driver.run_pipeline(_ref_conf(flags), similarity_only=True)
        got = pca_driver.run_pipeline(_port_conf(flags), similarity_only=True)
    assert got.lines == want.lines == []
    assert got.similarity_summary["dtype"] == "int32"
    assert {**got.similarity_summary, "dtype": None} == {**want.similarity_summary, "dtype": None}


@pytest.fixture
def clean_ledgers():
    cache.reset_compile_cache_stats()
    ref_cache.reset_compile_cache_stats()
    yield
    cache.reset_compile_cache_stats()
    ref_cache.reset_compile_cache_stats()


FINGERPRINT_FLAGS = [
    TINY,
    TINY + ["--output-path", "out", "--metrics-json", "m.json"],
    ["--num-samples", "8", "--references", "2:0:50000"],
    TINY + ["--block-size", "64"],
    TINY + ["--ingest", "packed", "--exact-similarity"],
    TINY + ["--mesh-shape", "1,4", "--similarity-strategy", "sharded"],
    TINY + ["--fused-jobs", "3"],
]


@pytest.mark.parametrize("index", range(len(FINGERPRINT_FLAGS)))
def test_fingerprints_equal_the_references(index):
    flags = FINGERPRINT_FLAGS[index]
    ref, port = _ref_conf(flags), _port_conf(flags)
    for kind in ("pca", "similarity"):
        assert cache.compile_fingerprint(port, kind) == ref_cache.compile_fingerprint(ref, kind)
        batch = cache.batch_compile_fingerprint(port, kind)
        assert batch == ref_cache.batch_compile_fingerprint(ref, kind)
        for k in (1, 4):
            assert cache.fused_group_fingerprint(batch, k) == ref_cache.fused_group_fingerprint(
                batch, k)


def test_geometry_ledger_counts_as_the_reference(clean_ledgers):
    keys = [cache.compile_fingerprint(_port_conf(f)) for f in FINGERPRINT_FLAGS]
    for module in (cache, ref_cache):
        seen = [module.record_geometry(key) for key in keys + keys[:3]]
        # Placement flags and --fused-jobs leave the geometry as it is.
        assert seen == [False, True, False, False, False, False, True, True, True, True]
        assert module.geometry_seen(keys[2]) and not module.geometry_seen("0" * 16)
    assert cache.compile_cache_stats() == ref_cache.compile_cache_stats() == (5, 5)


def test_run_pipeline_records_its_geometry_in_the_manifest(clean_ledgers, tmp_path):
    """A second run of one geometry in a process is a hit, in the manifest's
    ``compile_cache`` block and its gauges, as in the reference."""
    flags = GROUP + ["--references", WINDOWS[1], "--metrics-json", str(tmp_path / "m.json")]
    blocks = []
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            blocks.append(pca_driver.run_pipeline(_port_conf(flags)).manifest["compile_cache"])
            ref_driver.run_pipeline(_ref_conf(flags))
    assert blocks == [{"dir": None, "entries": 0, "geometry_hits": 0, "geometry_misses": 1},
                      {"dir": None, "entries": 0, "geometry_hits": 1, "geometry_misses": 1}]
    assert ref_cache.compile_cache_stats() == (1, 1)
