"""Fault plans and retry arithmetic: the port's ``utils/faults.py`` and
``utils/retry.py`` against the JAX package's.

One plan string must parse, and fire, identically in both packages: the
same grammar, the same errors on bad specs, the same closed catalogues of
sites key for key, and one-shot firing at the exact occurrence. The
``files.read`` point reaches the port's streamed reads, and the retry
delays are the reference's on the same seeded ``random.Random``."""

import email.message
import random

import numpy as np
import pytest

from spark_examples_tpu.sources.files import _iter_vcf_chunks as ref_iter_vcf_chunks
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu.utils import retry as ref_retry
from spark_examples_tpu_torch.sources.files import _iter_vcf_chunks
from spark_examples_tpu_torch.utils import faults, retry

#: The reference's grammar cases (``tests/test_faults.py``): one good plan
#: and every malformed spec it rejects.
GOOD_PLAN = (
    "kill@driver.post-flush, raise@driver.pre-finalize#3,"
    "truncate@files.read=4096,slow@rest.post=0.05"
)
BAD_SPECS = [
    "no-at-sign",
    "explode@driver.post-flush",
    "kill@not.a.site",
    "kill@driver.post-flush#0",
    "kill@driver.post-flush#x",
    "truncate@files.read",
    "slow@rest.post=soon",
    "truncate@driver.post-flush=4",
    "truncate@rest.post=4",
    "raise@files.read",
    "crash@files.read#2",
    "ioerror@analysis.pre-manifest",
]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    """Each test starts and ends with no plan in either package
    (``configure(None)`` also blocks the lazy environment read)."""
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _entries(module, spec):
    return [(e.action, e.site, e.nth, e.arg) for e in module.parse_plan(spec)]


def test_parse_plan_equals_the_reference():
    assert _entries(faults, GOOD_PLAN) == _entries(ref_faults, GOOD_PLAN) == [
        ("kill", "driver.post-flush", 1, None),
        ("raise", "driver.pre-finalize", 3, None),
        ("truncate", "files.read", 1, "4096"),
        ("slow", "rest.post", 1, "0.05"),
    ]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_the_reference_errors(spec):
    with pytest.raises(ref_faults.FaultSpecError) as ref_error:
        ref_faults.parse_plan(spec)
    with pytest.raises(faults.FaultSpecError) as error:
        faults.parse_plan(spec)
    assert str(error.value) == str(ref_error.value)
    assert issubclass(faults.FaultSpecError, ValueError)


def test_catalogues_equal_the_reference_key_for_key():
    assert list(faults.KILL_POINTS) == list(ref_faults.KILL_POINTS)
    assert list(faults.IO_POINTS) == list(ref_faults.IO_POINTS)
    assert faults.TRUNCATE_IO_POINTS == ref_faults.TRUNCATE_IO_POINTS
    assert faults.ENV_VAR == ref_faults.ENV_VAR == "SPARK_EXAMPLES_TPU_FAULTS"


def test_hooks_are_noops_without_a_plan():
    faults.kill_point("driver.post-flush")
    assert faults.io_point("files.read", b"payload") == b"payload"
    assert faults.injected_count() == 0
    with pytest.raises(KeyError):
        faults.kill_point("driver.not-registered")
    with pytest.raises(KeyError):
        faults.io_point("files.not-registered")


@pytest.mark.parametrize("module", [faults, ref_faults], ids=["port", "reference"])
def test_io_point_fires_at_the_exact_occurrence(module):
    module.configure("truncate@files.read#2=3")
    assert [module.io_point("files.read", b"abcdef") for _ in range(3)] == [
        b"abcdef", b"abc", b"abcdef"
    ]
    assert module.snapshot() == (1, {"files.read": 3})


def test_kill_point_fires_at_the_exact_occurrence():
    faults.configure("raise@driver.pre-finalize#2,crash@serve.worker.mid-job")
    faults.kill_point("driver.pre-finalize")
    with pytest.raises(faults.InjectedFault):
        faults.kill_point("driver.pre-finalize")
    faults.kill_point("driver.pre-finalize")
    with pytest.raises(faults.InjectedWorkerCrash):
        faults.kill_point("serve.worker.mid-job")
    assert not issubclass(faults.InjectedWorkerCrash, Exception)
    assert faults.injected_count() == 2


def test_flush_hooks_run_before_a_fault_fires():
    ran = []
    hook = lambda: ran.append(faults.injected_count())  # noqa: E731
    faults.add_flush_hook(hook)
    try:
        faults.configure("raise@checkpoint.post-save")
        with pytest.raises(faults.InjectedFault):
            faults.kill_point("checkpoint.post-save")
    finally:
        faults.remove_flush_hook(hook)
    assert ran == [1]


def test_environment_plan_is_read_lazily(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "ioerror@rest.post#2")
    faults._plan_entries = faults._UNSET
    assert faults.active()
    assert faults.io_point("rest.post") is None
    with pytest.raises(OSError, match="injected IO error at rest.post"):
        faults.io_point("rest.post")


def _chunks(module, iter_chunks, path, plan):
    module.configure(plan)
    try:
        return b"".join(iter_chunks(str(path), chunk_bytes=64))
    finally:
        module.configure(None)


def test_truncate_reaches_the_streamed_read(tmp_path):
    """A truncated window reaches the windowed reader of the file source
    exactly as in the reference: the same bytes come out."""
    path = tmp_path / "data.vcf"
    path.write_bytes(b"".join(b"line-%03d\tA\tG\n" % i for i in range(40)))
    plan = "truncate@files.read#2=5"
    got = _chunks(faults, _iter_vcf_chunks, path, plan)
    want = _chunks(ref_faults, ref_iter_vcf_chunks, path, plan)
    assert got == want and len(got) == path.stat().st_size - 59


def test_ioerror_reaches_the_streamed_pipeline(tmp_path):
    """An injected read failure on a streamed VCF pass surfaces from the
    port's driver as the OSError a failing disk would raise."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    rng = np.random.default_rng(0)
    lines = ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1\tS2"]
    for k in range(50):
        gts = "\t".join(rng.choice(["0|0", "0|1"]) for _ in range(3))
        lines.append(f"1\t{100 + 10 * k}\t.\tA\tG\t.\t.\tAF=0.5\tGT\t{gts}")
    path = tmp_path / "cohort.vcf"
    path.write_text("\n".join(lines) + "\n")
    conf = PcaConf.parse([
        "--source", "file", "--input-files", str(path), "--references", "1:0:2000",
        "--ingest", "packed", "--stream-chunk-bytes", "256", "--device", "cpu",
        "--fault-plan", "ioerror@files.read#3",
    ])
    with pytest.raises(OSError, match="injected IO error at files.read"):
        run_pipeline(conf)
    assert faults.injected_count() == 1


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_full_jitter_delay_equals_the_reference(seed):
    ours, theirs = random.Random(seed), random.Random(seed)
    for attempt in range(8):
        for base, cap in ((0.5, 8.0), (1.0, 3.0)):
            d = retry.full_jitter_delay(attempt, base, cap, ours)
            assert d == ref_retry.full_jitter_delay(attempt, base, cap, theirs)
            assert 0.0 <= d <= min(cap, base * 2**attempt)


@pytest.mark.parametrize(
    "value, cap",
    [("7", 60.0), ("9999", 8.0), ("not-a-date", 8.0), (None, 8.0), ("-3", 8.0),
     ("Wed, 21 Oct 2015 07:28:00 GMT", 8.0)],
)
def test_retry_after_seconds_equals_the_reference(value, cap):
    headers = email.message.Message()
    if value is not None:
        headers["Retry-After"] = value
    assert retry.retry_after_seconds(headers, cap) == ref_retry.retry_after_seconds(headers, cap)
    assert retry.retry_after_seconds(None, cap) is None
