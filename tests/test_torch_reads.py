"""The port's reads data plane and reads examples against the JAX package's.

The same inputs go through both packages: wire dicts, synthetic sources
built with the same arguments, or the same SAM text. Records compare field
for field (``dataclasses.asdict``), wire dicts dict for dict, part files
byte for byte and example 2's coverage as an equal float: no tolerance.
The reads examples run on the CPU (``--device cpu``), where the port's
depth wrappers take their plain versions.
"""

import dataclasses
import os

import numpy as np
import pytest

from spark_examples_tpu.analyses import reads_examples as ref_examples
from spark_examples_tpu.config import GenomicsConf as RefConf
from spark_examples_tpu.constants import Examples
from spark_examples_tpu.models import read as ref_read
from spark_examples_tpu.pipeline import datasets as ref_datasets
from spark_examples_tpu.sharding import partitioners as ref_parts
from spark_examples_tpu.sources import files as ref_files
from spark_examples_tpu.sources.base import ShardBoundary as RefBoundary
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource as RefSource
from spark_examples_tpu_torch.analyses import reads_examples
from spark_examples_tpu_torch.config import GenomicsConf
from spark_examples_tpu_torch.models import read
from spark_examples_tpu_torch.pipeline import datasets
from spark_examples_tpu_torch.sharding import partitioners as parts
from spark_examples_tpu_torch.sources import files
from spark_examples_tpu_torch.sources.base import ShardBoundary
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

#: The wire dicts of ``tests/test_models.py``'s two ReadBuilder cases.
WIRE_READS = {
    "mate-and-cigar": {
        "id": "read-1",
        "fragmentName": "frag-1",
        "readGroupSetId": "rgs-1",
        "alignedSequence": "ACGT",
        "alignedQuality": [30, 31, 32, 33],
        "fragmentLength": 300,
        "nextMatePosition": {"referenceName": "11", "position": 999},
        "alignment": {
            "position": {"referenceName": "11", "position": 100},
            "mappingQuality": 60,
            "cigar": [
                {"operationLength": 3, "operation": "ALIGNMENT_MATCH"},
                {"operationLength": 1, "operation": "CLIP_SOFT"},
            ],
        },
    },
    "no-mate": {
        "id": "r",
        "fragmentName": "f",
        "readGroupSetId": "g",
        "alignedSequence": "A",
        "alignedQuality": [30],
        "alignment": {
            "position": {"referenceName": "1", "position": 5},
            "mappingQuality": 20,
            "cigar": [],
        },
    },
    "every-cigar-op": {
        "id": "r9",
        "fragmentName": "f9",
        "readGroupSetId": "g9",
        "alignedSequence": "ACGTACGTAC",
        "alignment": {
            "position": {"referenceName": "chr2", "position": 77},
            "cigar": [
                {"operationLength": n + 1, "operation": op}
                for n, op in enumerate(sorted(ref_read.ReadBuilder.CIGAR_MATCH))
            ],
        },
    },
}

#: ``tests/test_files.py``'s SAM fixture, plus reads on a second contig.
SAM = (
    "@HD\tVN:1.6\tSO:coordinate\n"
    "@SQ\tSN:17\tLN:81195210\n"
    "r001\t99\t17\t101\t60\t8M2I4M\t=\t161\t75\tTTAGATAAAGGATA\tFFFFFFFFFFFFFF\n"
    "r002\t0\t17\t120\t30\t5M5D5M\t*\t0\t0\tAGCTAAGCTA\t*\n"
    "r003\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tFFFF\n"
    "r004\t0\t21\t5000\t40\t3S7M2N4M\t22\t900\t-40\tACGTACGTACGTAC\tIIIIIIIIIIIIII\n"
    "r005\t16\t21\t5003\t12\t10M\t*\t0\t0\t*\t*\n"
)


def _asdict(pair):
    key, value = pair
    return dataclasses.asdict(key), dataclasses.asdict(value)


@pytest.mark.parametrize("case", sorted(WIRE_READS))
def test_read_builder_equals_the_reference(case):
    wire = WIRE_READS[case]
    assert _asdict(read.ReadBuilder.build(wire)) == _asdict(ref_read.ReadBuilder.build(wire))
    assert read.ReadBuilder.CIGAR_MATCH == ref_read.ReadBuilder.CIGAR_MATCH


@pytest.mark.parametrize("length", [1, 7, 99, 100, 12_345, 327_414, 48_129_894, 249_250_620])
def test_splitters_equal_the_reference(length):
    for args in ((1,), (3,), (147,), (10 ** 9,)):
        assert parts.FixedSplits(*args).splits(length) == ref_parts.FixedSplits(*args).splits(length)
    for args in ((100, 5, 1024, 16 * 1024 * 1024), (100, 30, 1024, 16 * 1024 * 1024),
                 (50, 2, 10, 999)):
        assert (parts.TargetSizeSplits(*args).splits(length)
                == ref_parts.TargetSizeSplits(*args).splits(length))


def _ranges(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        start = int(rng.integers(0, 10 ** 8))
        yield {"21": (start, start + int(rng.integers(1, 2 * 10 ** 6))),
               "3": (0, int(rng.integers(1, 10 ** 7))),
               "11": (start, start + 1)}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("splitter", ["fixed", "target-3", "target-30"])
def test_reads_partitioner_layout_and_inverse_equal_the_reference(seed, splitter):
    """Over many ranges: the partitions (indices ordered by sequence name,
    spans with the remainder bases dropped) and ``get_partition`` (the
    inverse of the span layout, the JAX package's fix of the reference's
    formula) at starts, ends, span edges and outside the range."""
    make = {
        "fixed": lambda m: m.FixedSplits(7),
        "target-3": lambda m: m.TargetSizeSplits(100, 3, 1024, 1 << 20),
        "target-30": lambda m: m.TargetSizeSplits(100, 30, 1024, 16 << 20),
    }[splitter]
    rng = np.random.default_rng(seed + 100)
    for sequences in _ranges(seed, 5):
        mine = parts.ReadsPartitioner(sequences, make(parts))
        theirs = ref_parts.ReadsPartitioner(sequences, make(ref_parts))
        assert (mine.count, mine.num_partitions, mine.parts, mine.steps) == (
            theirs.count, theirs.num_partitions, theirs.parts, theirs.steps)
        got = mine.get_partitions(["a", "b"])
        assert [dataclasses.asdict(p) for p in got] == [
            dataclasses.asdict(p) for p in theirs.get_partitions(["a", "b"])]
        assert [p.get_reads_request() for p in got] == [
            p.get_reads_request() for p in theirs.get_partitions(["a", "b"])]
        for name, (start, end) in sequences.items():
            probes = {start, end - 1, end, start - 5, end + 5}
            probes |= {p.start for p in got if p.sequence == name}
            probes |= {p.end - 1 for p in got if p.sequence == name}
            probes |= set(int(x) for x in rng.integers(start, end, 20))
            for pos in sorted(probes):
                assert mine.get_partition(name, pos) == theirs.get_partition(name, pos)


def _sources(**kwargs):
    return SyntheticGenomicsSource(**kwargs), RefSource(**kwargs)


@pytest.mark.parametrize("boundary", ["STRICT", "OVERLAPS"])
@pytest.mark.parametrize("readset", [Examples.GOOGLE_EXAMPLE_READSET,
                                     Examples.GOOGLE_DREAM_SET3_TUMOR, "x-Tumor", "normal"])
def test_synthetic_reads_equal_the_reference(readset, boundary):
    mine, theirs = _sources(num_samples=4, seed=13, read_depth=6, somatic_rate=0.01)
    request = {"readGroupSetIds": [readset], "referenceName": "1", "start": 100_000_050,
               "end": 100_001_000}
    got = list(mine.client().search_reads(request, getattr(ShardBoundary, boundary)))
    want = list(theirs.client().search_reads(request, getattr(RefBoundary, boundary)))
    assert got and got == want
    assert mine.read_json(readset, "21", 1234, 3) == theirs.read_json(readset, "21", 1234, 3)
    assert list(mine.read_starts(50, 777)) == list(theirs.read_starts(50, 777))


@pytest.mark.parametrize("num_workers", [1, 8])
def test_reads_dataset_records_equal_the_reference(num_workers):
    mine, theirs = _sources(num_samples=4, seed=11, read_depth=4)
    region = {"21": (1_000, 9_000)}
    got = datasets.ReadsDataset(mine, [Examples.GOOGLE_EXAMPLE_READSET], parts.ReadsPartitioner(
        region, parts.FixedSplits(3)), num_workers=num_workers)
    want = ref_datasets.ReadsDataset(theirs, [Examples.GOOGLE_EXAMPLE_READSET],
                                     ref_parts.ReadsPartitioner(region, ref_parts.FixedSplits(3)))
    assert [_asdict(r) for r in got] == [_asdict(r) for r in want]
    assert [dataclasses.asdict(r) for r in got.reads()] == [
        dataclasses.asdict(r) for r in want.reads()]
    shards = [(p.index, len(records)) for p, records in got.iter_shards()]
    assert shards == [(p.index, len(records)) for p, records in want.iter_shards()]
    assert len(shards) == 3 and all(n for _, n in shards)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize(
    "contig, start, end",
    [("17", 0, 1000), ("17", 130, 140), ("17", 100, 101), ("17", 134, 200),
     ("21", 0, 10_000), ("21", 5_004, 5_010), ("21", 5_015, 5_020), ("2", 0, 10)],
)
def test_sam_records_equal_the_reference(tmp_path, contig, start, end):
    path = _write(tmp_path, "sample.sam", SAM)
    request = {"readGroupSetIds": ["sample"], "referenceName": contig, "start": start,
               "end": end}
    mine, theirs = files.FileGenomicsSource([path]), ref_files.FileGenomicsSource([path])
    for boundary in ("STRICT", "OVERLAPS"):
        got = list(mine.client().search_reads(request, getattr(ShardBoundary, boundary)))
        want = list(theirs.client().search_reads(request, getattr(RefBoundary, boundary)))
        assert got == want
        assert [_asdict(read.ReadBuilder.build(r)) for r in got] == [
            _asdict(ref_read.ReadBuilder.build(r)) for r in want]
    assert [dataclasses.astuple(c) for c in mine.get_contigs("sample")] == [
        dataclasses.astuple(c) for c in theirs.get_contigs("sample")]
    assert mine._table("sample").kind == theirs._table("sample").kind == "reads"


def test_sam_reads_through_the_port_match_the_reference_fixture(tmp_path):
    """``tests/test_files.py``'s SAM checks, on the port: the unmapped read
    dropped, the CIGAR, mate and qualities, and OVERLAPS over the deletion
    (r002 covers [119, 134) on the reference)."""
    path = _write(tmp_path, "sample.sam", SAM)
    client = files.FileGenomicsSource([path]).client()
    got = list(client.search_reads(
        {"readGroupSetIds": ["sample"], "referenceName": "17", "start": 0, "end": 1000}))
    assert len(got) == 2
    _, first = read.ReadBuilder.build(got[0])
    assert first.position == 100 and first.cigar == "8M2I4M"
    assert first.mate_position == 160 and first.mate_reference_name == "17"
    assert first.aligned_quality[0] == 37
    _, second = read.ReadBuilder.build(got[1])
    assert second.cigar == "5M5D5M" and second.aligned_quality == ()
    overlapping = list(client.search_reads(
        {"readGroupSetIds": ["sample"], "referenceName": "17", "start": 130, "end": 140},
        ShardBoundary.OVERLAPS))
    assert [r["fragmentName"] for r in overlapping] == ["r002"]


# ------------------------------------------------------------ the examples


@pytest.fixture()
def confs(tmp_path):
    """(port conf on the CPU, reference conf), writing into their own
    directories."""
    mine = GenomicsConf(output_path=str(tmp_path / "port"), device="cpu")
    theirs = RefConf()
    theirs.output_path = str(tmp_path / "ref")
    return mine, theirs


@pytest.fixture()
def small_shards(monkeypatch):
    """Both packages' examples cut their regions into shards of about
    1,280 bases (``TargetSizeSplits`` with a 64 KiB partition instead of
    16 MiB), so a few kb cross several shard boundaries and the carry
    between them."""
    for module in (reads_examples, ref_examples):
        target = module.TargetSizeSplits
        monkeypatch.setattr(module, "TargetSizeSplits",
                            lambda a, b, c, d, _t=target: _t(a, b, c, 64 * 1024 - 1))


def _pileup(source, snp, readset=Examples.GOOGLE_EXAMPLE_READSET, sequence="11"):
    """A naive half-open pileup: the reads starting within 1,000 bases of
    ``snp`` whose bases cover it, in the source's order."""
    wires = source.client().search_reads({"readGroupSetIds": [readset], "referenceName": sequence,
                                          "start": snp - 1000, "end": snp + 1000})
    reads = [(w["alignment"]["position"]["position"], w["alignedSequence"], w["alignedQuality"])
             for w in wires]
    covering = [r for r in reads if r[0] <= snp < r[0] + len(r[1])]
    first = min(p for p, _, _ in covering)
    lines = [" " * (snp - first) + "v"]
    for pos, seq, qual in covering:
        i = snp - pos
        lines.append(" " * (pos - first) + seq[: i + 1] + "(%02d) " % qual[i] + seq[i + 1:])
    return lines + [" " * (snp - first) + "^"]


@pytest.mark.parametrize("depth, snp", [(8, 6_889_650), (8, 6_889_601), (4, 6_889_648),
                                        (6, 6_889_705)])
def test_example1_equals_the_reference_where_it_returns(confs, capsys, depth, snp):
    mine, theirs = _sources(num_samples=4, seed=1, read_depth=depth)
    got = reads_examples.run_example1(confs[0], mine, snp=snp)
    want = ref_examples.run_example1(confs[1], theirs, snp=snp)
    assert got == want == _pileup(mine, snp)
    assert capsys.readouterr().out == "\n".join(got + want) + "\n"


@pytest.mark.parametrize("snp", [Examples.CILANTRO, 6_889_612, 6_889_700 + 12])
def test_example1_half_open_where_the_reference_raises(confs, snp):
    """At the synthetic geometry (length 100, depth 8: reads start at
    offsets 12·j mod 100) a read ends at ``snp - 1`` whenever ``snp`` is
    12·j mod 100, the CLI's default SNP among them: the JAX package keeps
    it and indexes its quality past the read. The port prints the pileup
    of the reads that do cover the SNP."""
    mine, theirs = _sources(num_samples=4, seed=1)
    with pytest.raises(IndexError):
        ref_examples.run_example1(confs[1], theirs, snp=snp)
    got = reads_examples.run_example1(confs[0], mine, snp=snp)
    assert got == _pileup(mine, snp)
    assert len(got) == 2 + 8  # depth 8: eight reads cover every base
    marker = len(got[0]) - 1
    assert all(line.index("(") - 1 == marker for line in got[1:-1])


@pytest.mark.parametrize("region", [(1_000, 21_000), (2_500, 9_999), (0, 100)])
def test_example2_coverage_equals_the_reference(confs, small_shards, capsys, region):
    mine, theirs = _sources(num_samples=4, seed=11, read_depth=4)
    got = reads_examples.run_example2(confs[0], mine, region=region)
    want = ref_examples.run_example2(confs[1], theirs, region=region)
    assert type(got) is float and got == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == f"Coverage of chromosome 21 = {want}"


@pytest.mark.parametrize(
    "geometry, region",
    [((100, 4), (1_000, 9_000)), ((100, 8), (1_000, 6_000)), ((400, 2), (1_000, 6_000)),
     ((100, 4), (0, 1_000))],
    ids=["depth4", "depth8", "reads400", "one-shard"],
)
def test_example3_part_file_equals_the_reference(confs, small_shards, geometry, region):
    length, depth = geometry
    mine, theirs = _sources(num_samples=4, seed=3, read_length=length, read_depth=depth)
    got = reads_examples.run_example3(confs[0], mine, region=region)
    want = ref_examples.run_example3(confs[1], theirs, region=region)
    assert got == os.path.join(confs[0].output_path, "coverage_21", "part-00000")
    text = open(got).read()
    assert text and text == open(want).read()
    assert not [f for f in os.listdir(os.path.dirname(got)) if f.endswith(".tmp")]


def test_example3_default_splitter_crosses_a_boundary(confs):
    """The examples' own splitter: 330 kb of chr21 are two shards of
    165,000 bases (depth 2 keeps it to 6,600 reads)."""
    mine, theirs = _sources(num_samples=4, seed=5, read_depth=2)
    region = (1_000, 331_000)
    assert len(parts.ReadsPartitioner({"21": region}, parts.TargetSizeSplits(
        100, 5, 1024, 16 * 1024 * 1024)).get_partitions(["x"])) == 2
    got = reads_examples.run_example3(confs[0], mine, region=region)
    want = ref_examples.run_example3(confs[1], theirs, region=region)
    assert open(got).read() == open(want).read()


@pytest.mark.parametrize(
    "seed, region, somatic",
    [(13, (100_000_000, 100_008_000), 0.01), (7, (100_000_000, 100_004_000), 0.05),
     (13, (100_000_000, 100_003_000), 0.0)],
)
def test_example4_diff_equals_the_reference(confs, small_shards, seed, region, somatic):
    mine, theirs = _sources(num_samples=4, seed=seed, read_depth=6, somatic_rate=somatic)
    got = reads_examples.run_example4(confs[0], mine, region=region)
    want = ref_examples.run_example4(confs[1], theirs, region=region)
    assert got == want
    assert bool(got) == (somatic > 0)
    path = ("diff_1", "part-00000")
    assert (open(os.path.join(confs[0].output_path, *path)).read()
            == open(os.path.join(confs[1].output_path, *path)).read())


def test_example4_default_splitter_crosses_a_boundary(confs):
    """The examples' own splitter: 60 kb of chr1 are two shards at depth 2."""
    mine, theirs = _sources(num_samples=4, seed=13, read_depth=2, somatic_rate=0.02)
    region = (100_000_000, 100_060_000)
    got = reads_examples.run_example4(confs[0], mine, region=region)
    want = ref_examples.run_example4(confs[1], theirs, region=region)
    assert got and got == want


def test_examples_on_sam_files_equal_the_reference(confs, tmp_path):
    """Examples 3 and 4 over SAM files of synthetic reads (normal, then
    tumor), both packages' file sources."""
    mine = SyntheticGenomicsSource(num_samples=4, seed=13, read_depth=6, somatic_rate=0.01)

    def sam(name, readset, contig, start, end):
        wires = mine.client().search_reads({"readGroupSetIds": [readset], "referenceName": contig,
                                            "start": start, "end": end})
        lines = ["@HD\tVN:1.6"]
        for w in wires:
            a = w["alignment"]
            lines.append("\t".join(map(str, (
                w["fragmentName"], 0, contig, a["position"]["position"] + 1, a["mappingQuality"],
                f"{len(w['alignedSequence'])}M", "*", 0, 0, w["alignedSequence"],
                "".join(chr(q + 33) for q in w["alignedQuality"])))))
        return _write(tmp_path, name, "\n".join(lines) + "\n")

    ex3 = sam("reads.sam", Examples.GOOGLE_EXAMPLE_READSET, "21", 2_000, 5_000)
    normal = sam("normal.sam", Examples.GOOGLE_DREAM_SET3_NORMAL, "1", 100_000_000, 100_004_000)
    tumor = sam("tumor.sam", Examples.GOOGLE_DREAM_SET3_TUMOR, "1", 100_000_000, 100_004_000)
    for source_args, run, ref_run, kwargs, out in (
        ([ex3], reads_examples.run_example3, ref_examples.run_example3,
         dict(readset="reads", region=(0, 8_000)), "coverage_21"),
        ([normal, tumor], reads_examples.run_example4, ref_examples.run_example4,
         dict(normal_readset="normal", tumor_readset="tumor",
              region=(100_000_000, 100_008_000)), "diff_1"),
    ):
        run(confs[0], files.FileGenomicsSource(source_args), **kwargs)
        ref_run(confs[1], ref_files.FileGenomicsSource(source_args), **kwargs)
        got = open(os.path.join(confs[0].output_path, out, "part-00000")).read()
        assert got and got == open(os.path.join(confs[1].output_path, out, "part-00000")).read()
