"""The plain reference against the port on the CPU at a tiny size: the
cohort's rows, names and kept sites, and a whole job's Gramian and
components."""

import contextlib
import io

import numpy as np
import pytest
import torch

from gpubench.harness import PortJobs
from gpubench.reference import (
    Cohort,
    control_job,
    gower_center,
    kept_sites,
    reference_gramian,
    top_components,
)
from gpubench.verdict import judge, read_rows

from spark_examples_tpu_torch.sharding.contig import Contig
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

from conftest import TINY_CONFIG

CPU = torch.device("cpu")


def port_source(cohort):
    return SyntheticGenomicsSource(num_samples=cohort.num_samples, seed=cohort.seed,
                                   variant_spacing=cohort.spacing, n_pops=cohort.n_pops,
                                   ref_block_fraction=cohort.ref_block_fraction)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5, 2**63 - 1])
def test_rows_names_and_kept_sites_match_the_port_source(seed):
    cohort = Cohort.from_config(TINY_CONFIG, seed)
    source = port_source(cohort)
    G = np.zeros((cohort.num_samples,) * 2, dtype=np.int64)
    kept = 0
    for name, start, end in cohort.contigs:
        contig = Contig(name, start, end)
        for positions, _ in source.site_threshold_plan(contig):
            kept += len(positions)
        for block in source.genotype_blocks(cohort.variant_set_id, contig):
            x = block["has_variation"].astype(np.int64)
            G += x.T @ x
    assert np.array_equal(reference_gramian(cohort, CPU).numpy(), G.astype(np.float64))
    assert kept_sites(cohort, CPU) == kept
    assert cohort.names() == [source.callset_name(cohort.variant_set_id, i)
                              for i in range(cohort.num_samples)]


def test_a_port_job_reads_clean_against_the_reference():
    seed = 987654321987
    jobs = PortJobs(TINY_CONFIG, "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        output, spans = jobs(seed)
    cohort = Cohort.from_config(TINY_CONFIG, seed)
    assert set(spans) >= {"ingest+similarity", "center+pca"}
    reading = judge(cohort, output, 2, CPU)
    assert reading["gramian_mismatch"] == 0 and reading["rows_wrong"] == 0
    assert reading["pc_error"] < 1e-6


def test_reference_eigenpairs_converge_and_match_eigh():
    cohort = Cohort.from_config(TINY_CONFIG, 5)
    B = gower_center(reference_gramian(cohort, CPU))
    V, evals = top_components(B, 2)
    full = torch.linalg.eigvalsh(B)
    top = full[torch.argsort(-full.abs())][:2]
    assert torch.allclose(evals, top, rtol=1e-12)
    assert float((B @ V - V * evals).norm(dim=0).max() / evals.abs().max()) < 1e-11


def test_control_rows_have_the_programs_format():
    cohort = Cohort.from_config(TINY_CONFIG, 9)
    output = control_job(cohort, 2, CPU)
    wrong, V = read_rows(cohort, output.lines, 2)
    assert wrong == 0 and not torch.isnan(V).any()
    assert output.lines == sorted(output.lines)
