"""The blocked reference against the whole-matrix one on the CPU, with the
scratch sizes forced small, so that several site chunks, generation
sub-blocks and row blocks occur: the int32 Gramian, B's rows, the judge's
readings, the control and the planted faults."""

import contextlib
import inspect
import io
import math

import pytest
import torch

import test_gpubench_faults as faults
from gpubench import reference, verdict
from gpubench.harness import PortJobs
from gpubench.reference import (
    Centred,
    Cohort,
    JobOutput,
    gower_center,
    reference_gramian,
    top_components,
)
from gpubench.verdict import judge, pc_error_parts, read_rows

from conftest import TINY_CONFIG

CPU = torch.device("cpu")
N = TINY_CONFIG["num_samples"]
#: B's row blocks 3 rows, the product's 7, site chunks of 14 sites, each
#: generated in sub-blocks of 5.
SMALL_SCRATCH = 28 * N
SMALL_ELEMENTS = 5 * N


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(reference, "SCRATCH_BYTES", SMALL_SCRATCH)
    monkeypatch.setattr(verdict, "SCRATCH_BYTES", SMALL_SCRATCH)
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", SMALL_ELEMENTS)


def dense_gramian(cohort):
    """``Xᵀ diag(w) X`` over every grid index at once, float64."""
    lo, w = cohort.grid_weights(CPU)
    positions = torch.arange(lo, lo + w.numel(), dtype=torch.int64) * cohort.spacing
    x = cohort.has_variation(positions, cohort.populations(CPU)).double()
    return (x * w.double()[:, None]).T @ x


def dense_judge(cohort, output, num_pc):
    """The judge as it was: a float64 Gramian, the whole B."""
    wrong, V = read_rows(cohort, output.lines, num_pc)
    G = dense_gramian(cohort)
    mismatch = int((output.gramian.double() != G).sum())
    B = gower_center(G)
    _, evals = top_components(B, num_pc)
    parts = pc_error_parts(B, evals, V)
    return {"gramian_mismatch": mismatch, "rows_wrong": wrong,
            "pc_error": max(parts.values()), "pc_error_parts": parts}


@pytest.mark.parametrize("seed", [3, 2**40 + 7])
def test_blocked_gramian_equals_the_dense_one(seed, small_blocks):
    cohort = Cohort.from_config(TINY_CONFIG, seed)
    lo, w = cohort.grid_weights(CPU)
    assert w.numel() % 14 and int(w.max()) == 2  # a partial chunk; rows weighted
    G = reference_gramian(cohort, CPU)
    assert G.dtype == torch.int32
    assert torch.equal(G.double(), dense_gramian(cohort))


def test_centred_rows_are_bit_equal_to_gower_center(small_blocks):
    cohort = Cohort.from_config(TINY_CONFIG, 11)
    G = reference_gramian(cohort, CPU)
    B = Centred(G)
    dense = gower_center(G)
    assert len(B.spans) == math.ceil(N / 3)
    for a, b in B.spans:
        assert torch.equal(B.block(a, b), dense[a:b])
    V = torch.randn(N, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(B @ V, dense @ V, rtol=0, atol=1e-9)


def port_output(seed):
    with contextlib.redirect_stdout(io.StringIO()):
        output, _ = PortJobs(TINY_CONFIG, "cpu")(seed)
    return output


def altered(output):
    """Two Gramian entries in different row blocks off by one, and the first
    row's first component 1 % larger."""
    G = output.gramian.clone()
    G[0, 5] += 1
    G[N - 1, 2] -= 1
    name, dataset, pc1, *rest = output.lines[0].split("\t")
    first = "\t".join([name, dataset, str(float(pc1) * 1.01), *rest])
    return JobOutput([first, *output.lines[1:]], G)


@pytest.mark.parametrize("kind", ["as_emitted", "altered"])
def test_blocked_judge_reads_as_the_dense_judge(kind, small_blocks):
    seed = 424242
    cohort = Cohort.from_config(TINY_CONFIG, seed)
    output = port_output(seed)
    if kind == "altered":
        output = altered(output)
    want = dense_judge(cohort, output, 2)
    got = judge(cohort, output, 2, CPU)
    assert got["gramian_mismatch"] == want["gramian_mismatch"] == (2 if kind == "altered" else 0)
    assert got["rows_wrong"] == want["rows_wrong"] == 0
    assert abs(got["pc_error"] - want["pc_error"]) < 1e-12
    for name, value in want["pc_error_parts"].items():
        assert abs(got["pc_error_parts"][name] - value) < 1e-12


#: Every verdict of ``test_gpubench_faults.py``: the program correct, the
#: control and each planted fault not.
VERDICTS = [f for name, f in inspect.getmembers(faults, inspect.isfunction)
            if name.startswith("test_")]


@pytest.mark.parametrize("verdict_test", VERDICTS, ids=lambda f: f.__name__[len("test_"):])
def test_verdicts_hold_with_small_blocks(verdict_test, run_tiny, monkeypatch, small_blocks):
    fixtures = {"run_tiny": run_tiny, "monkeypatch": monkeypatch}
    verdict_test(**{name: fixtures[name] for name in inspect.signature(verdict_test).parameters})
