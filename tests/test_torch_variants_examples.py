"""The port's variants examples and the examples' CLI against the JAX
package's.

``run_klotho`` and ``run_brca1`` on synthetic sources built with the same
arguments print the JAX package's lines exactly. The CLI runs the six
example verbs, refuses a ``variants-pca``-only flag as the reference's
parser does, raises the reference's error for example 4 with one input
file, and resolves the device before any work.
"""

import dataclasses

import pytest
import torch

from spark_examples_tpu.analyses import variants_examples as ref_examples
from spark_examples_tpu.cli import COMMANDS as REF_COMMANDS
from spark_examples_tpu.config import GenomicsConf as RefConf
from spark_examples_tpu.sharding.contig import Contig as RefContig
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource as RefSource
from spark_examples_tpu_torch import cli
from spark_examples_tpu_torch.analyses import variants_examples
from spark_examples_tpu_torch.config import GenomicsConf
from spark_examples_tpu_torch.sharding.contig import Contig
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

EXAMPLE_VERBS = (
    "search-variants-klotho",
    "search-variants-brca1",
    "search-reads-example-1",
    "search-reads-example-2",
    "search-reads-example-3",
    "search-reads-example-4",
)

#: (contig, start, end) of each run: the examples' defaults and wider or
#: other windows (the synthetic grid has a site every 100 bases, so the
#: Klotho SNP's one base holds none).
CONTIGS = {
    "klotho-default": ("chr13", 33628137, 33628138),
    "klotho-2kb": ("chr13", 33627000, 33629000),
    "klotho-chr13-20kb": ("chr13", 33_628_000, 33_648_000),
    "brca1-default": ("chr17", 41196311, 41277499),
    "brca1-20kb": ("chr17", 41_196_311, 41_216_311),
    "unnormalizable": ("chrX", 1_000, 5_000),
}


def _confs(variant_set_id=None):
    mine, theirs = GenomicsConf(device="cpu"), RefConf()
    if variant_set_id is not None:
        mine.variant_set_id = theirs.variant_set_id = [variant_set_id]
    return mine, theirs


@pytest.mark.parametrize("example", ["klotho", "brca1"])
@pytest.mark.parametrize("window", sorted(CONTIGS))
def test_variants_examples_print_the_reference_lines(example, window, capsys):
    name, start, end = CONTIGS[window]
    mine, theirs = _confs()
    source, ref_source = (SyntheticGenomicsSource(num_samples=12, seed=11),
                          RefSource(num_samples=12, seed=11))
    run = getattr(variants_examples, f"run_{example}")
    ref_run = getattr(ref_examples, f"run_{example}")
    got = run(mine, source, Contig(name, start, end))
    want = ref_run(theirs, ref_source, RefContig(name, start, end))
    assert got == want
    assert capsys.readouterr().out == "\n".join(got + want) + "\n"
    total, variants, blocks = (int(got[i].split()[2]) for i in range(3))
    assert total == variants + blocks


@pytest.mark.parametrize("set_id", ["vs-a", "10473108253681171589"])
def test_klotho_variant_set_flag_equals_the_reference(set_id, capsys):
    mine, theirs = _confs(set_id)
    contig = CONTIGS["klotho-chr13-20kb"]
    got = variants_examples.run_klotho(mine, SyntheticGenomicsSource(num_samples=5, seed=2),
                                       Contig(*contig))
    want = ref_examples.run_klotho(theirs, RefSource(num_samples=5, seed=2), RefContig(*contig))
    assert got == want and int(got[0].split()[2]) > 0


def test_example_contigs_are_the_reference_contigs():
    for name in ("KLOTHO_CONTIG", "BRCA1_CONTIG"):
        assert (dataclasses.astuple(getattr(variants_examples, name))
                == dataclasses.astuple(getattr(ref_examples, name)))


def test_klotho_verb_runs_on_the_cpu(capsys):
    assert cli.main(["search-variants-klotho", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["We have 0 records that overlap Klotho.",
                   "But only 0 records are of a variant.",
                   "The other 0 records are reference-matching blocks."]


def test_brca1_verb_prints_the_reference_lines(capsys):
    argv = ["--num-samples", "4", "--seed", "3"]
    assert cli.main(["search-variants-brca1", *argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    REF_COMMANDS["search-variants-brca1"](argv)
    assert got == capsys.readouterr().out and got.startswith("We have ")


def test_only_the_unported_verbs_are_refused():
    assert cli.NOT_PORTED == ("obs",)
    ported = set(cli.COMMANDS) | set(cli.DEVICE_FREE) | set(cli.SERVICE)
    assert ported | set(cli.NOT_PORTED) == set(REF_COMMANDS)
    assert not ported & set(cli.NOT_PORTED)
    assert not set(cli.COMMANDS) & set(cli.DEVICE_FREE)
    assert not (set(cli.COMMANDS) | set(cli.DEVICE_FREE)) & set(cli.SERVICE)


@pytest.mark.parametrize("verb", EXAMPLE_VERBS)
def test_example_verbs_are_ported(verb, capsys):
    assert verb in cli.COMMANDS
    assert cli.main([]) == 0
    assert verb in capsys.readouterr().out


@pytest.mark.parametrize("verb", EXAMPLE_VERBS)
@pytest.mark.parametrize("flag", [["--num-pc", "3"], ["--pca-backend", "host"],
                                  ["--all-references"], ["--ld-out", "x"]])
def test_variants_pca_flags_are_refused_as_the_reference_refuses_them(verb, flag, capsys):
    with pytest.raises(SystemExit) as err:
        RefConf.parse(flag)
    with pytest.raises(SystemExit) as mine:
        cli.main([verb, *flag, "--device", "cpu"])
    assert mine.value.code == err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("verb", EXAMPLE_VERBS)
def test_example_verbs_without_a_card_raise(verb):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for argv in ([verb], [verb, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


@pytest.mark.parametrize("files", [["n.sam"], []])
def test_example4_from_files_needs_two_inputs_as_the_reference(files):
    argv = ["--source", "file", "--input-files", ",".join(files)]
    with pytest.raises(ValueError) as want:
        REF_COMMANDS["search-reads-example-4"](argv)
    with pytest.raises(ValueError) as got:
        cli.main(["search-reads-example-4", *argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "flags",
    [["--trace-dir", "t"], ["--num-processes", "2"], ["--metrics-json", "m.json"],
     ["--heartbeat-seconds", "3"], ["--bases-per-partition", "500"], ["--spark-master", "x"]],
)
def test_examples_take_every_base_flag(flags):
    """The examples parse the reference's base flags (``GenomicsConf``),
    the ones their paths do not read included, as the reference's do."""
    ref = RefConf.parse(flags)
    conf = GenomicsConf.parse(flags + ["--device", "cpu"])
    for f in dataclasses.fields(ref):
        assert getattr(conf, f.name) == getattr(ref, f.name)


@pytest.mark.parametrize(
    "flags",
    [["--heartbeat-seconds", "-1"], ["--ingest-workers", "-2"], ["--checkpoint-every-sites", "0"],
     ["--fault-plan", "files.read:fail"], ["--source", "file"],
     ["--source", "file", "--input-files", "a.sam", "--variant-set-id", "b"]],
)
def test_examples_validate_the_base_flags_as_the_reference(flags):
    with pytest.raises(ValueError):
        RefConf.parse(flags)
    with pytest.raises(ValueError):
        GenomicsConf.parse(flags)
