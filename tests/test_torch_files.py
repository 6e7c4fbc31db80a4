"""The port's file source against the JAX package's, on the same files.

The same fixtures — plain and gzip VCF, several contigs, missing GT calls
(``./.``), multi-allelic lines (``1/2``, two ALT alleles), AF-less lines,
comment lines before ``#CHROM`` and mid-file, JSONL wire records — go
through both packages' ``FileGenomicsSource``: the wire records of every
shard window, the packed column arrays, the streamed blocks (with chunk
sizes that cut lines mid-record) and their I/O counters, the contigs and
the callsets must be identical. Then the port's own contracts: the native
parser (``native/vcfparse.cpp``, built by ``utils/native.py`` into the
port's build directory) and the Python parser give identical arrays at
every worker count, and ``MalformedVcfLine`` and ``UnsortedVcfError`` are
raised on the same inputs as in the reference. Plus the windowed stream
layer (``sources/stream.py``) against the reference's on the same bytes.
"""

import ctypes
import gzip
import json
import os

import numpy as np
import pytest

from spark_examples_tpu.sources import files as ref_files
from spark_examples_tpu.sources import stream as ref_stream
from spark_examples_tpu.sources.base import ShardBoundary as RefBoundary
from spark_examples_tpu_torch.sharding.contig import Contig
from spark_examples_tpu_torch.sources import files, stream
from spark_examples_tpu_torch.sources.base import ShardBoundary
from spark_examples_tpu_torch.utils import native

GT_CHOICES = ["0|0", "0|1", "1|1", "./.", "1/2", "0/2", "1|0"]


def _vcf_text(seed=5, n_samples=7, rows=120, contigs=("1", "17"), comments=True):
    """A seeded coordinate-sorted VCF: AF-less lines every third row, missing
    and multi-allelic calls, two ALT alleles on some lines, a comment line
    before ``#CHROM`` and one mid-file."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2"]
    if comments:
        lines.append("# a comment line before the column row")
    lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"S{i:02d}" for i in range(n_samples))
    )
    for contig in contigs:
        for k in range(rows):
            pos = 50 + 17 * k
            info = f"AF={rng.random():.4f}" if k % 3 else "NS=2"
            alt = "G,T" if k % 5 == 0 else "G"
            vid = f"rs{k}" if k % 2 else "."
            gts = "\t".join(rng.choice(GT_CHOICES) for _ in range(n_samples))
            lines.append(f"{contig}\t{pos}\t{vid}\tAC\t{alt}\t.\t.\t{info}\tGT\t{gts}")
        if comments:
            lines.append("# a mid-file comment line")
    return "\n".join(lines) + "\n"


def _write(tmp_path, name, text, compress=False):
    path = tmp_path / name
    if compress:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def _jsonl_text(seed=9, n_samples=5, rows=40):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(rows):
        af = [round(float(rng.random()), 3)] if i % 4 else ["junk"]
        records.append({
            "referenceName": "17" if i < rows // 2 else "2",
            "start": 100 + 10 * i,
            "end": 101 + 10 * i,
            "referenceBases": "A",
            "alternateBases": ["G"],
            "info": {"AF": af},
            "calls": [
                {"callSetId": f"j-{s}", "callSetName": f"J{s}",
                 "genotype": [int(g) for g in rng.integers(0, 2, 2)]}
                for s in range(n_samples)
            ],
        })
    return "".join(json.dumps(r) + "\n" for r in records)


FIXTURES = {
    "plain": ("cohort.vcf", lambda: _vcf_text(), False),
    "gzip": ("cohort.vcf.gz", lambda: _vcf_text(seed=6), True),
    "one-contig": ("solo.vcf", lambda: _vcf_text(seed=7, contigs=("22",), comments=False), False),
    "three-contigs": ("tri.vcf.gz", lambda: _vcf_text(seed=8, rows=50, contigs=("1", "17", "X")), True),
}


@pytest.fixture(params=sorted(FIXTURES))
def vcf_path(request, tmp_path):
    name, make, compress = FIXTURES[request.param]
    return _write(tmp_path, name, make(), compress)


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype != object and np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])
    else:
        np.testing.assert_array_equal(a, b)


def _windows(source, set_id, width=700):
    for contig in source.get_contigs(set_id):
        yield from Contig(contig.reference_name, 0, contig.end).get_shards(width)


# ------------------------------------------------- the two packages agree


def test_callsets_and_contigs_match_reference(vcf_path):
    set_id = files.file_set_id(vcf_path)
    port, ref = files.FileGenomicsSource([vcf_path]), ref_files.FileGenomicsSource([vcf_path])
    assert port.search_callsets([set_id]) == ref.search_callsets([set_id])
    got = [(c.reference_name, c.start, c.end) for c in port.get_contigs(set_id)]
    want = [(c.reference_name, c.start, c.end) for c in ref.get_contigs(set_id)]
    assert got == want and got


@pytest.mark.parametrize("boundary", ["STRICT", "OVERLAPS"])
def test_wire_records_match_reference(vcf_path, boundary):
    set_id = files.file_set_id(vcf_path)
    port, ref = files.FileGenomicsSource([vcf_path]), ref_files.FileGenomicsSource([vcf_path])
    port_client, ref_client = port.client(), ref.client()
    total = 0
    for shard in _windows(port, set_id):
        request = {"variantSetIds": [set_id], "referenceName": shard.reference_name,
                   "start": shard.start, "end": shard.end}
        got = list(port_client.search_variants(request, ShardBoundary[boundary], page_size=4))
        want = list(ref_client.search_variants(request, RefBoundary[boundary], page_size=4))
        assert got == want
        total += len(got)
    assert total > 0
    assert vars(port_client.counters) == vars(ref_client.counters)


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_packed_arrays_match_reference(vcf_path, workers):
    set_id = files.file_set_id(vcf_path)
    got = files._PackedVcf(vcf_path, set_id, ingest_workers=workers)
    want = ref_files._PackedVcf(vcf_path, set_id, ingest_workers=workers)
    assert got.native == want.native
    assert list(got.by_contig) == list(want.by_contig)
    for name in want.by_contig:
        for a, b in zip(got.by_contig[name], want.by_contig[name]):
            _same_arrays(a, b)
    assert got.contig_bounds == want.contig_bounds


@pytest.mark.parametrize("chunk_bytes", [100, 777, 1 << 20])
@pytest.mark.parametrize("min_af", [None, 0.3])
def test_streamed_blocks_and_counters_match_reference(vcf_path, chunk_bytes, min_af):
    """One streaming pass, with chunks that cut lines mid-record, serves
    every window: identical blocks and I/O counters."""
    set_id = files.file_set_id(vcf_path)
    port = files.FileGenomicsSource([vcf_path], stream_chunk_bytes=chunk_bytes, ingest_workers=2)
    ref = ref_files.FileGenomicsSource([vcf_path], stream_chunk_bytes=chunk_bytes,
                                       ingest_workers=2)
    shards = list(_windows(ref, set_id, width=500))
    c_port = files.StreamCounters(len(shards))
    c_ref = ref_files.StreamCounters(len(shards))
    got = list(port.stream_genotype_blocks(set_id, shards, block_size=16,
                                           min_allele_frequency=min_af, counters=c_port))
    want = list(ref.stream_genotype_blocks(set_id, shards, block_size=16,
                                           min_allele_frequency=min_af, counters=c_ref))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            _same_arrays(g[key], w[key])
    assert (c_port.requests(), c_port.variants) == (c_ref.requests(), c_ref.variants)
    assert port.native_parse(set_id, streamed=True) == (native.vcf_library() is not None)


def test_genotype_blocks_and_page_requests_match_reference(vcf_path):
    set_id = files.file_set_id(vcf_path)
    port, ref = files.FileGenomicsSource([vcf_path]), ref_files.FileGenomicsSource([vcf_path])
    for contig in ref.get_contigs(set_id):
        assert port.page_requests(set_id, contig, 300) == ref.page_requests(set_id, contig, 300)
        got = list(port.genotype_blocks(set_id, contig, block_size=8, min_allele_frequency=0.2))
        want = list(ref.genotype_blocks(set_id, contig, block_size=8, min_allele_frequency=0.2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in w:
                _same_arrays(g[key], w[key])
    assert port.native_parse(set_id, streamed=False) == (native.vcf_library() is not None)


def test_jsonl_records_match_reference(tmp_path):
    path = _write(tmp_path, "wire.jsonl.gz", _jsonl_text(), compress=True)
    set_id = files.file_set_id(path)
    port, ref = files.FileGenomicsSource([path]), ref_files.FileGenomicsSource([path])
    assert port.search_callsets([set_id]) == ref.search_callsets([set_id])
    for contig in ref.get_contigs(set_id):
        request = {"variantSetIds": [set_id], "referenceName": contig.reference_name,
                   "start": contig.start, "end": contig.end}
        got = list(port.client().search_variants(request))
        assert got == list(ref.client().search_variants(request)) and got
    assert not port.wants_streaming(set_id)


@pytest.mark.parametrize("size, compress", [(1000, False), (200 << 20, False),
                                            (1000, True), (20 << 20, True)])
def test_wants_streaming_matches_reference(tmp_path, size, compress):
    """The auto-stream threshold and the gzip ratio estimate are the
    reference's, so ``auto`` resolves the same arm (sparse files stand in
    for large ones; only the size on disk is read)."""
    path = tmp_path / ("big.vcf.gz" if compress else "big.vcf")
    with open(path, "wb") as f:
        f.truncate(size)
    assert files.STREAM_THRESHOLD_BYTES == ref_files.STREAM_THRESHOLD_BYTES
    assert files._GZ_RATIO_ESTIMATE == ref_files._GZ_RATIO_ESTIMATE
    set_id = files.file_set_id(str(path))
    for chunk in (None, 0, 4096):
        port = files.FileGenomicsSource([str(path)], stream_chunk_bytes=chunk)
        ref = ref_files.FileGenomicsSource([str(path)], stream_chunk_bytes=chunk)
        assert port.wants_streaming(set_id) == ref.wants_streaming(set_id)


@pytest.mark.parametrize("value", [None, "0.25", " 0.5\t", "1e-3", "junk", "0x1A", "inf",
                                   "nan", "1_0", "", "9" * 70, 0.75, 3])
def test_af_grammar_matches_reference(value):
    got, want = files.af_float(value), ref_files.af_float(value)
    assert (got == want) or (np.isnan(got) and np.isnan(want))


def test_set_ids_match_reference():
    paths = ["/d/chr17.vcf.gz", "/e/chr17.vcf", "/f/my-cohort.2.jsonl", "/g/ckpt/"]
    assert files.file_set_ids(paths) == ref_files.file_set_ids(paths)
    assert files.file_set_id("/data/chr17.vcf.gz") == "chr17"


# ------------------------------------------------- errors on the same inputs


def _header(n=1):
    return "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(
        f"S{i}" for i in range(n)) + "\n"


@pytest.mark.parametrize("workers", [0, 3])
def test_malformed_line_raises_like_reference(tmp_path, workers):
    """Both packages raise on the same malformed line, with the same
    file-level data-line number."""
    rows = [f"1\t{10 + 7 * k}\t.\tA\tG\t.\t.\tAF=0.5\tGT\t0|1" for k in range(90)]
    rows[61] = "1\tnot_a_pos\t.\tA"
    path = _write(tmp_path, "bad.vcf", _header() + "\n".join(rows) + "\n")
    with pytest.raises(ValueError) as got:
        files._PackedVcf(path, "bad", ingest_workers=workers)
    with pytest.raises(ValueError) as want:
        ref_files._PackedVcf(path, "bad", ingest_workers=workers)
    assert str(got.value) == str(want.value)
    if native.vcf_library() is not None:
        assert isinstance(got.value, native.MalformedVcfLine)
        assert got.value.ordinal == 62


@pytest.mark.parametrize("order", ["positions", "contigs"])
def test_unsorted_vcf_raises_like_reference(tmp_path, order):
    """Explicit streaming of an unsorted file is the hard error in both
    packages; auto streaming falls back to the in-memory view instead."""
    if order == "positions":
        body = ["1\t500\t.\tA\tG\t.\t.\tAF=0.5\tGT\t0|1", "1\t100\t.\tA\tG\t.\t.\tAF=0.5\tGT\t1|1"]
    else:
        body = ["1\t100\t.\tA\tG\t.\t.\tAF=0.5\tGT\t0|1", "2\t100\t.\tA\tG\t.\t.\tAF=0.5\tGT\t0|1",
                "1\t300\t.\tA\tG\t.\t.\tAF=0.5\tGT\t1|1"]
    path = _write(tmp_path, "unsorted.vcf", _header() + "\n".join(body) + "\n")
    shards = [Contig("1", 0, 1000), Contig("2", 0, 1000)]
    for module in (files, ref_files):
        source = module.FileGenomicsSource([path], stream_chunk_bytes=64)
        with pytest.raises(module.UnsortedVcfError) as err:
            list(source.stream_genotype_blocks("unsorted", shards))
        assert "--stream-chunk-bytes 0" in str(err.value)
    assert issubclass(files.UnsortedVcfError, stream.UnsortedStreamError)


def test_sam_input_raises_naming_the_format(tmp_path):
    """SAM input is ported: a header-only file is an empty read group set,
    and a malformed data line raises naming the format, in both packages."""
    empty = _write(tmp_path, "reads.sam", "@HD\tVN:1.6\n")
    bad = _write(tmp_path, "bad.sam", "@HD\tVN:1.6\nr1\t0\t17\t5\n")
    request = {"readGroupSetIds": ["reads"], "referenceName": "17", "start": 0, "end": 100}
    for module in (files, ref_files):
        assert list(module.FileGenomicsSource([empty]).client().search_reads(request)) == []
        with pytest.raises(ValueError, match="malformed SAM"):
            module.FileGenomicsSource([bad]).client()


def test_directory_without_parts_raises_like_reference(tmp_path):
    (tmp_path / "notackpt").mkdir()
    for module in (files, ref_files):
        with pytest.raises(ValueError, match="no part"):
            module.FileGenomicsSource([str(tmp_path / "notackpt")]).client()


# --------------------------------------- native parser against the Python one


def test_native_library_is_a_gil_releasing_cdll_in_the_port_build_dir():
    lib = native.vcf_library()
    if lib is None:
        pytest.skip(f"no C++ compiler: {native.native_unavailable_reason()}")
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    built = [n for n in os.listdir(native.BUILD_DIR) if n.startswith("vcfparse-")]
    assert any(n.endswith(".so") for n in built)
    assert ".cache" not in str(native.BUILD_DIR)


@pytest.mark.parametrize("workers", [0, 1, 2, 4])
def test_native_and_python_parsers_give_identical_arrays(vcf_path, workers, monkeypatch):
    if native.vcf_library() is None:
        pytest.skip("no C++ compiler")
    set_id = files.file_set_id(vcf_path)
    fast = files._PackedVcf(vcf_path, set_id, ingest_workers=workers)
    monkeypatch.setattr(native, "vcf_library", lambda: None)
    slow = files._PackedVcf(vcf_path, set_id, ingest_workers=workers)
    assert fast.native and not slow.native
    assert list(fast.by_contig) == list(slow.by_contig)
    for name in slow.by_contig:
        for a, b in zip(fast.by_contig[name], slow.by_contig[name]):
            _same_arrays(a, b)
    assert fast.contig_bounds == slow.contig_bounds


@pytest.mark.parametrize("n_spans", [1, 2, 5, 13])
def test_parse_vcf_span_matches_whole_buffer(tmp_path, n_spans):
    if native.vcf_library() is None:
        pytest.skip("no C++ compiler")
    text = _vcf_text(rows=40).encode()
    whole = native.parse_vcf_arrays(text)
    _, n_samples = native.scan_vcf_counts(text)
    parts = [native.parse_vcf_span(text, a, b, n_samples)
             for a, b in files._line_aligned_spans(text, n_spans)]
    for i in range(5):
        _same_arrays(whole[i], np.concatenate([p[i] for p in parts]))
    parallel = files._native_parallel_vcf_arrays(text, workers=3)
    for i in range(5):
        _same_arrays(whole[i], parallel[i])


def test_native_chunk_and_site_scans_match_reference():
    if native.vcf_library() is None:
        pytest.skip("no C++ compiler")
    from spark_examples_tpu.utils import native as ref_native

    text = _vcf_text(seed=11).split("\n", 3)[3].encode()  # data lines only
    for got, want in ((native.parse_vcf_chunk(text, 7), ref_native.parse_vcf_chunk(text, 7)),
                      (native.scan_vcf_sites_chunk(text), ref_native.scan_vcf_sites_chunk(text))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_arrays(a, b)


# ------------------------------------------------ the chunk-parallel engine


@pytest.mark.parametrize("n_spans", [1, 3, 8, 1000])
def test_line_aligned_spans_reassemble_exactly(n_spans):
    text = _vcf_text(rows=30).encode() + b"tail-without-newline"
    spans = files._line_aligned_spans(text, n_spans)
    assert spans == ref_files._line_aligned_spans(text, n_spans)
    assert b"".join(text[a:b] for a, b in spans) == text
    assert all(text[b - 1:b] == b"\n" for _, b in spans[:-1])


@pytest.mark.parametrize("workers", [0, 1, 2, 5])
def test_ordered_pool_map_keeps_order_and_raises_in_place(workers):
    assert list(files._ordered_pool_map(lambda x: x * x, range(50), workers)) == [
        x * x for x in range(50)]

    def fail_at_7(x):
        if x == 7:
            raise KeyError(x)
        return x

    seen = []
    with pytest.raises(KeyError):
        for value in files._ordered_pool_map(fail_at_7, range(20), workers):
            seen.append(value)
    assert seen == list(range(7))


# ---------------------------------------------------- the windowed stream


def _payload(n=500, width=40):
    return b"".join(b"line-%06d-" % i + b"x" * width + b"\n" for i in range(n))


@pytest.mark.parametrize("window", [1, 64, 100, 4096, 1 << 20])
@pytest.mark.parametrize("compress", [False, True])
def test_byte_windows_match_reference(tmp_path, window, compress):
    payload = _payload() + b"unterminated tail"
    path = tmp_path / ("t.txt.gz" if compress else "t.txt")
    path.write_bytes(gzip.compress(payload) if compress else payload)
    got = list(stream.iter_byte_windows(str(path), window))
    assert got == list(ref_stream.iter_byte_windows(str(path), window))
    assert b"".join(got) == payload
    assert all(w.endswith(b"\n") for w in got[:-1])


def test_text_lines_universal_newlines_match_reference(tmp_path):
    path = tmp_path / "crlf.txt"
    path.write_bytes(b"a\r\nb\rc\n\nd")
    got = list(stream.iter_text_lines(str(path), 64))
    assert got == list(ref_stream.iter_text_lines(str(path), 64)) == ["a", "b", "c", "", "d"]


def test_windowed_and_size_bounds_match_reference(tmp_path):
    assert list(stream.windowed(range(7), 3)) == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(ValueError):
        list(stream.windowed([1], 0))
    plain = tmp_path / "p.txt"
    plain.write_bytes(b"x" * 1000)
    gz = tmp_path / "p.txt.gz"
    gz.write_bytes(gzip.compress(b"y" * 100_000))
    for path in (plain, gz, tmp_path / "missing"):
        assert stream.decompressed_size_bound(str(path)) == ref_stream.decompressed_size_bound(
            str(path))
        assert stream.wire_rows_bound(str(path)) == ref_stream.wire_rows_bound(str(path))


def test_sortedness_probe_and_budgets():
    probe = stream.SortednessProbe("t", hint="sort the input")
    probe.check("1", np.array([5, 7, 7]))
    probe.check("2", np.array([1]))
    with pytest.raises(stream.UnsortedStreamError, match="sort the input"):
        probe.check("1", np.array([9]))
    builder = stream.ChunkedArrayBuilder(np.int8, row_shape=(4,), capacity_rows=5)
    builder.add(np.ones((3, 4), np.int8))
    builder.add(np.zeros((2, 4), np.int8))
    assert builder.finish().sum() == 12
    with pytest.raises(stream.StreamBudgetError):
        builder.add(np.zeros((1, 4), np.int8))
    table = stream.SpooledRecordTable("t", capacity_rows=3)
    for contig, start, rec in (("1", 30, {"id": "a"}), ("1", 10, {"id": "b"}),
                               ("1", 30, {"id": "c"})):
        table.add(contig, start, rec)
    with pytest.raises(stream.StreamBudgetError):
        table.add("2", 1, {"id": "d"})
    table.finish()
    assert [r["id"] for r in table.iter_records("1")] == ["b", "a", "c"]
    assert [r["id"] for r in table.tail_records("1", 2)] == ["a", "c"]
    table.close()
