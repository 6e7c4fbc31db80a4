"""What decides ``correct``: the control (the reference one precision step
down, in the program's place) and the faults the cells can have, planted
underneath the timed path, each come out not correct; the program as it
is comes out correct."""

import torch

from gpubench.harness import ControlJobs
from gpubench.verdict import UNREADABLE
from spark_examples_tpu_torch.ops import devicegen
from spark_examples_tpu_torch.pipeline import pca_driver

from conftest import TINY_CONFIG

DevAcc = devicegen.DeviceGenGramianAccumulator


def failing(result, *names):
    return [n for n, row in result["checks"].items() if row["value"] > row["limit"]] == list(names)


def test_the_program_is_correct(run_tiny):
    rc, result, _ = run_tiny(seed=31)
    assert rc == 0 and result["correct"] is True


def test_the_control_is_not_correct(run_tiny):
    rc, result, _ = run_tiny(seed=32, jobs=ControlJobs(dict(TINY_CONFIG), torch.device("cpu")))
    assert rc == 0 and result["correct"] is False
    assert failing(result, "pc_error")
    assert result["checks"]["pc_error"]["value"] > 10 * result["checks"]["pc_error"]["limit"]


def test_a_step_that_leaves_the_gramian_unchanged(run_tiny, monkeypatch):
    monkeypatch.setattr(devicegen, "gram_accumulate", lambda G, xt, split=None: None)
    rc, result, _ = run_tiny(seed=33)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["gramian_mismatch"]["value"] > 0


def test_half_the_sites_left_out(run_tiny, monkeypatch):
    blocks = DevAcc._blocks

    def half(self, d, grid_offset, n_valid, count):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls % 2:
            blocks(self, d, grid_offset, n_valid, count)

    monkeypatch.setattr(DevAcc, "_blocks", half)
    rc, result, _ = run_tiny(seed=34)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["gramian_mismatch"]["value"] > 0


def test_one_gramian_entry_altered(run_tiny, monkeypatch):
    finalize = DevAcc.finalize_device

    def altered(self):
        G = finalize(self)
        G[0, 1] += 1
        return G

    monkeypatch.setattr(DevAcc, "finalize_device", altered)
    rc, result, _ = run_tiny(seed=35)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["gramian_mismatch"]["value"] == 1


def test_one_emitted_component_altered(run_tiny, monkeypatch):
    emit = pca_driver.VariantsPcaDriver.emit_result

    def altered(self, result):
        (callset, pcs), *rest = result
        return emit(self, [(callset, [pcs[0] * 1.01, *pcs[1:]]), *rest])

    monkeypatch.setattr(pca_driver.VariantsPcaDriver, "emit_result", altered)
    rc, result, _ = run_tiny(seed=36)
    assert rc == 0 and result["correct"] is False
    assert failing(result, "pc_error")


def test_a_missing_row(run_tiny, monkeypatch):
    emit = pca_driver.VariantsPcaDriver.emit_result
    monkeypatch.setattr(pca_driver.VariantsPcaDriver, "emit_result",
                        lambda self, result: emit(self, result[1:]))
    rc, result, _ = run_tiny(seed=37)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["failed_jobs"]["value"] > 0
    assert result["checks"]["rows_wrong"]["value"] == 1
    assert result["checks"]["pc_error"]["value"] == UNREADABLE


def test_a_job_that_raises(run_tiny, monkeypatch):
    compute = pca_driver.VariantsPcaDriver.compute_pca
    calls = []

    def every_other(self, similarity):
        calls.append(1)
        if len(calls) % 2 == 0:
            raise RuntimeError("planted")
        return compute(self, similarity)

    monkeypatch.setattr(pca_driver.VariantsPcaDriver, "compute_pca", every_other)
    # A window long enough that a job completes after the first, which raises.
    rc, result, err = run_tiny(seed=38, seconds=1.0)
    assert rc == 0 and result["correct"] is False
    assert result["failed"] == result["checks"]["failed_jobs"]["value"] > 0
    assert "RuntimeError: planted" in err
