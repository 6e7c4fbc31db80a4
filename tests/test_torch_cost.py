"""The cost model and its calibration (``obs/costmodel.py``,
``obs/calibration.py``) and the manifest's ``cost`` block
(``obs/manifest.py``) of both packages, held against each other.

The JAX package's ``tests/test_cost_observatory.py`` cases for these
modules (the estimate's floor, overhead and cold penalty, the
prediction's round trip, the calibration fold and its crash-durable
ledger, the ``cost`` block's validation) run here once per package
(``pkg``), the port's model given the reference's constants where a case
reads them. The cross checks: a calibration ledger written by either
package folds to the same ratios in both, and a ``cost`` block from
either package's manifest passes both validators.
"""

import importlib
import json

import pytest

PACKAGES = {"ref": "spark_examples_tpu", "port": "spark_examples_tpu_torch"}
PKGS = sorted(PACKAGES)


def _m(pkg, module):
    return importlib.import_module(f"{PACKAGES[pkg]}.obs.{module}")


@pytest.mark.parametrize("pkg", PKGS)
def test_estimate_floor_overhead_and_cold_penalty(pkg):
    cm = _m(pkg, "costmodel")
    warm = cm.estimate_seconds(sites=1_000_000, host_peak_bytes=None, sched_seconds=None,
                               cold=False)
    cold = cm.estimate_seconds(sites=1_000_000, host_peak_bytes=None, sched_seconds=None,
                               cold=True)
    assert warm["predicted_seconds"] == pytest.approx(
        cm.DISPATCH_OVERHEAD_SECONDS + warm["compute_seconds"])
    assert warm["compute_seconds"] == pytest.approx(1_000_000 / cm.SITES_PER_SECOND)
    assert cold["predicted_seconds"] - warm["predicted_seconds"] == pytest.approx(
        cm.COLD_COMPILE_SECONDS)
    empty = cm.estimate_seconds(sites=None, host_peak_bytes=None, sched_seconds=None, cold=False)
    assert empty["predicted_seconds"] == pytest.approx(
        max(cm.MIN_PREDICTED_SECONDS, cm.DISPATCH_OVERHEAD_SECONDS))
    bytes_only = cm.estimate_seconds(sites=None, host_peak_bytes=5 << 30, sched_seconds=None,
                                     cold=False)
    assert bytes_only["compute_seconds"] == pytest.approx((5 << 30) / cm.HOST_BYTES_PER_SECOND)
    linked = cm.estimate_seconds(sites=10, host_peak_bytes=None, sched_seconds=9.0, cold=False)
    assert linked["predicted_seconds"] == pytest.approx(cm.DISPATCH_OVERHEAD_SECONDS + 9.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_cost_prediction_round_trip_and_junk(pkg):
    cm = _m(pkg, "costmodel")
    pred = cm.CostPrediction(predicted_seconds=1.5, kind="pca", fingerprint="abc123",
                             compile="warm", compute_seconds=0.2, sites=501,
                             host_peak_bytes=1 << 30)
    assert cm.CostPrediction.from_dict(json.loads(json.dumps(pred.to_dict()))) == pred
    for junk in ({}, {"predicted_seconds": "junk"}, {"predicted_seconds": float("nan")},
                 {"predicted_seconds": -1.0}):
        assert cm.CostPrediction.from_dict(junk) is None
    pred = cm.CostPrediction(predicted_seconds=2.0)
    assert pred.best_estimate_seconds == 2.0
    pred.calibrated_seconds = 6.0
    assert pred.best_estimate_seconds == 6.0


@pytest.mark.parametrize("writer", PKGS)
def test_predictions_round_trip_across_packages(writer):
    doc = _m(writer, "costmodel").CostPrediction(
        predicted_seconds=3.25, kind="grm", fingerprint="fp", compile="cold",
        compute_seconds=1.5, sched_seconds=None, sites=7, host_peak_bytes=9,
        ring_bytes_per_flush=11, calibrated_seconds=2.0, calibration_ratio=0.6,
        calibration_samples=3).to_dict()
    parsed = [_m(pkg, "costmodel").CostPrediction.from_dict(doc).to_dict() for pkg in PKGS]
    assert parsed[0] == parsed[1] == doc


def _row(fingerprint="fp1", predicted=2.0, measured=1.0, **extra):
    doc = {"fingerprint": fingerprint, "kind": "pca", "job_class": "small",
           "predicted_seconds": predicted, "measured_seconds": measured,
           "queue_wait_seconds": 0.1, "compile": "warm"}
    doc.update(extra)
    return doc


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_learns_per_geometry_ratio_and_calibrates(pkg):
    cal, cm = _m(pkg, "calibration"), _m(pkg, "costmodel")
    fold = cal.CalibrationFold()
    for _ in range(max(2, cal.MIN_CALIBRATION_SAMPLES)):
        assert fold.add(_row("fp1", predicted=2.0, measured=1.0))
        assert fold.add(_row("fp2", predicted=1.0, measured=3.0))
    assert fold.ratio_for("fp1") == pytest.approx(0.5)
    assert fold.ratio_for("fp2") == pytest.approx(3.0)
    assert fold.ratio_for("fp-never-seen") == pytest.approx(fold.overall.ratio)
    pred = cm.CostPrediction(predicted_seconds=4.0, fingerprint="fp1")
    fold.calibrated_estimate(pred)
    assert pred.calibrated_seconds == pytest.approx(2.0)
    assert pred.calibration_ratio == pytest.approx(0.5)
    assert pred.best_estimate_seconds == pytest.approx(2.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_skips_junk_and_failed_rows(pkg):
    fold = _m(pkg, "calibration").CalibrationFold()
    assert not fold.add("not a dict")
    assert not fold.add({"predicted_seconds": 1.0})
    assert not fold.add(_row(predicted=float("nan")))
    assert not fold.add(_row(predicted=-1.0))
    assert not fold.add(_row(status="failed"))
    assert fold.overall.n == 0
    assert fold.add(_row())
    assert fold.overall.n == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_reservoir_is_deterministic_and_bounded(pkg):
    reservoir = _m(pkg, "calibration")._Reservoir
    r1, r2 = reservoir(capacity=8), reservoir(capacity=8)
    for i in range(1000):
        r1.add(float(i))
        r2.add(float(i))
    assert r1.samples == r2.samples and len(r1.samples) <= 8 and r1.stride > 1
    assert (r1.quantile(0.0), r1.quantile(1.0)) == (min(r1.samples), max(r1.samples))
    assert reservoir().quantile(0.5) is None


@pytest.mark.parametrize("reader", PKGS)
@pytest.mark.parametrize("writer", PKGS)
def test_ledger_torn_tail_and_merge_across_packages(writer, reader, tmp_path):
    """Two replicas (one of each package) append to one ledger; a torn
    tail is skipped; either package's fold reads the same ratios."""
    cal_w = _m(writer, "calibration")
    other = _m("port" if writer == "ref" else "ref", "calibration")
    run_dir = str(tmp_path)
    a, b = cal_w.CalibrationLedger(run_dir), other.CalibrationLedger(run_dir)
    a.record(fingerprint="fp1", kind="pca", job_class="small", predicted_seconds=2.0,
             measured_seconds=1.0, queue_wait_seconds=0.1, compile="warm", job_id="job-a-1")
    b.record(fingerprint="fp1", kind="pca", job_class="small", predicted_seconds=2.0,
             measured_seconds=1.0, queue_wait_seconds=None, compile="cold", job_id="job-b-1",
             status="failed")
    b.record(fingerprint="fp2", kind="grm", job_class="large", predicted_seconds=1.0,
             measured_seconds=4.0, queue_wait_seconds=0.0, compile="cold", job_id="job-b-2")
    assert a.fold.overall.n == 1 and a.refresh().overall.n == 2
    with open(cal_w.calibration_path(run_dir), "a", encoding="utf-8") as f:
        f.write('{"fingerprint": "fp1", "predicted_sec')
    fold = _m(reader, "calibration").fold_calibration(cal_w.calibration_path(run_dir))
    assert fold.overall.n == 2
    assert fold.ratio_for("fp1") == pytest.approx(0.5)
    assert fold.ratio_for("fp2") == pytest.approx(4.0)
    assert fold.summary() == other.fold_calibration(cal_w.calibration_path(run_dir)).summary()
    a.close()
    b.close()


def _valid_cost_block():
    return {"predicted_seconds": 1.5, "measured_seconds": 1.2, "queue_wait_seconds": 0.01,
            "compile": "warm", "fingerprint": "abc"}


TAMPERS = {
    "negative": lambda c: c.update(predicted_seconds=-1.0),
    "nan": lambda c: c.update(measured_seconds=float("nan")),
    "bool": lambda c: c.update(queue_wait_seconds=True),
    "string": lambda c: c.update(queue_wait_seconds="0.1"),
    "missing": lambda c: c.pop("measured_seconds"),
    "lukewarm": lambda c: c.update(compile="lukewarm"),
}


@pytest.mark.parametrize("validator", PKGS)
@pytest.mark.parametrize("maker", PKGS)
def test_manifest_cost_block_valid_and_absent(maker, validator):
    build = _m(maker, "manifest").build_manifest
    validate = _m(validator, "manifest").validate_manifest
    assert validate(build()) == []
    doc = build(cost=_valid_cost_block())
    assert validate(doc) == [] and doc["cost"]["compile"] == "warm"


@pytest.mark.parametrize("validator", PKGS)
@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_manifest_cost_block_tampering_rejected(tamper, validator):
    cost = _valid_cost_block()
    TAMPERS[tamper](cost)
    doc = _m("port", "manifest").build_manifest(cost=cost)
    errors = _m(validator, "manifest").validate_manifest(doc)
    assert errors and any("cost" in e for e in errors), errors
