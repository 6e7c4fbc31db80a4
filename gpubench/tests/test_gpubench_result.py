"""The result line of a run, driven on the CPU at a tiny size."""

from gpubench.verdict import NUMBERS

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_last_line_is_one_result_object(run_tiny):
    rc, result, err = run_tiny()
    assert rc == 0
    assert all(key in result for key in KEYS)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "pcoa_sites_per_s", "pcoa_job_p90_s"}
    for metric in result["metrics"].values():
        assert metric["value"] > 0 and metric["unit"]
    assert result["device"]["count"] == 1


def test_checks_end_standard_error_and_the_line(run_tiny):
    _, result, err = run_tiny()
    assert list(result["checks"]) == list(NUMBERS)
    tail = err.strip().splitlines()[-len(NUMBERS):]
    for name, line in zip(NUMBERS, tail):
        row = result["checks"][name]
        assert line == f"gpubench check {name}: {row['value']} (limit {row['limit']})"


def test_trace_run_reports_per_layer_metrics(run_tiny):
    rc, result, _ = run_tiny(trace=1)
    assert rc == 0 and result["correct"] is True
    # On the CPU the trace holds no device operation: only the span
    # readers find something to read.
    assert set(result["metrics"]) == {
        "driver.job_overhead_ms", "ingest.similarity_ms", "pca.center_pca_ms",
        "driver.setup_ms", "driver.epilogue_ms"}
    assert "breakdown" not in result
