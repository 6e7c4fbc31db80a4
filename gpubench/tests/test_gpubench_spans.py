"""The readers of the program's ``setup`` and ``epilogue`` root spans and
of the idle time no program span names, on hand-built jobs and traces."""

import pytest

from gpubench.catalog import reader
from gpubench.devtrace import DeviceTrace
from gpubench.harness import Context, Job

ROOTS = {"driver.setup_ms": "setup", "driver.epilogue_ms": "epilogue"}
IDLE = "device.idle_unspanned_share"


def _ctx(spans=(), idle_us=None):
    jobs = [Job(seed=i, wall_s=1.0, sites=100, spans=dict(s), peak_bytes=0)
            for i, s in enumerate(spans)]
    trace = None
    if idle_us is not None:
        trace = DeviceTrace(lo=0.0, hi=1e6, busy_us=1e6 - sum(idle_us.values()),
                            op_us={"gram_accumulate_kernel": 1.0}, idle_us=idle_us)
    return Context(num_samples=24, setup_s=1.0, window_s=2.0, jobs=jobs, peak_bytes=0,
                   trace=trace)


@pytest.mark.parametrize("name", [*ROOTS, *(f"chr17.{n}" for n in ROOTS)])
def test_root_span_readers(name):
    read = reader(name)
    span = ROOTS[name.removeprefix("chr17.")]
    stages = {"ingest+similarity": 0.3, "center+pca": 0.1}
    # The parent's jobs have no such root: nothing to read.
    assert read(_ctx([stages, stages])) is None
    assert read(_ctx()) is None
    got = read(_ctx([{**stages, span: 0.020}, {**stages, span: 0.030}]))
    assert got == pytest.approx(25.0)


@pytest.mark.parametrize("name", [IDLE, f"chr17.{IDLE}"])
@pytest.mark.parametrize("idle_us, want", [
    ({"setup/aten::empty": 300.0, "callsets": 500.0, "walk/dispatch": 200.0}, 0.0),
    ({"gpubench.job": 700.0, "gpubench.job/aten::copy_": 300.0}, 100.0),
    ({"outside any range": 100.0, "epilogue/emit": 300.0}, 25.0),
    ({"emit": 250.0, "gpubench.job": 250.0, "ingest+similarity/aten::copy_": 500.0}, 25.0),
    ({}, 0.0),
], ids=["all-spanned", "all-under-job", "outside-any-range", "mixed", "never-idle"])
def test_idle_unspanned_share(name, idle_us, want):
    read = reader(name)
    assert read(_ctx(idle_us=idle_us)) == pytest.approx(want)
    assert read(_ctx()) is None
