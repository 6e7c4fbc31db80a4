"""File-backed genomics source: VCF / wire-JSONL variants, SAM reads.

The port's copy of ``spark_examples_tpu/sources/files.py``: local files
behind the :class:`GenomicsSource` seam, so ``variants-pca``, the
analyses and the seven examples run on real data.

- ``*.vcf`` / ``*.vcf.gz`` — VCF 4.x text: sites, INFO (``AF`` feeds the
  ``--min-allele-frequency`` filter), and per-sample GT calls.
- ``*.jsonl`` / ``*.jsonl.gz`` — one wire-format variant dict per line, or
  the checkpoint entry shape ``{"key": ..., "variant": ...}``; a checkpoint
  directory (``pipeline/checkpoint.py``) is read through its part files.
- ``*.sam`` — SAM text alignments for the reads examples, served as read
  wire dicts by :meth:`FileClient.search_reads`.

Three views of one VCF serve the three ingest arms of the driver:

- the **wire** tables (:class:`_FileTable`): records parsed once into
  per-contig start-sorted spooled tables (``sources/stream.py``), queried
  per shard window through :class:`FileClient`;
- the **packed** view (:class:`_PackedVcf`): column arrays (positions, AF,
  has-variation rows) decoded by the chunk-parallel native parser
  (``native/vcfparse.cpp`` through ``utils/native.py``) or, without a
  compiler, by the Python parser with identical output;
- the **streamed** view (:class:`_StreamedVcf`): one bounded-memory pass
  over a coordinate-sorted file, serving every shard window in file order.

Each file is one variant set (or read group set) whose id is the file's
sanitized stem —
``/data/chr17.vcf.gz`` → ``chr17`` — with callset ids ``<set>-<i>``, so
``emit_result``'s dataset split on ``-`` works (``VariantsPca.scala:275``).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import threading
import warnings
from collections import deque

import numpy as np
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

from spark_examples_tpu_torch.sharding.contig import (
    Contig,
    SexChromosomeFilter,
    filter_sex_chromosomes,
)
from spark_examples_tpu_torch.sources.base import (
    GenomicsClient,
    GenomicsSource,
    ShardBoundary,
)
from spark_examples_tpu_torch.sources.stream import (
    ChunkedArrayBuilder,
    SortednessProbe,
    SpooledRecordTable,
    UnsortedStreamError,
    iter_byte_windows,
    iter_text_lines,
    wire_rows_bound,
)

#: letter → wire operation (inverse of ``ReadBuilder.CIGAR_MATCH``,
#: ``models/read.py``; SAM column 6).
_CIGAR_OPS = {
    "M": "ALIGNMENT_MATCH",
    "H": "CLIP_HARD",
    "S": "CLIP_SOFT",
    "D": "DELETE",
    "I": "INSERT",
    "P": "PAD",
    "=": "SEQUENCE_MATCH",
    "X": "SEQUENCE_MISMATCH",
    "N": "SKIP",
}

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def file_set_id(path: str) -> str:
    """A file's variant/read-group set id: the stem, sanitized so callset ids
    ``<set>-<i>`` split unambiguously on the FIRST '-' (dashes and other
    separators become '_')."""
    stem = os.path.basename(path.rstrip("/"))
    for suffix in (".gz", ".vcf", ".jsonl", ".sam"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    sanitized = re.sub(r"[^A-Za-z0-9_.]", "_", stem)
    return sanitized or "file"


def file_set_ids(paths: Sequence[str]) -> List[str]:
    """Set ids for a list of input files, in order; duplicates get a numeric
    suffix so every file stays addressable."""
    ids: List[str] = []
    for path in paths:
        base = file_set_id(path)
        candidate, k = base, 1
        while candidate in ids:
            k += 1
            candidate = f"{base}{k}"
        ids.append(candidate)
    return ids


_AF_CHARSET = frozenset("0123456789eE+-.")


def af_float(value: Optional[str]) -> float:
    """The file paths' AF grammar, shared bit for bit by the native parser
    (``native/vcfparse.cpp``), the Python fallback, and the file-backed wire
    filter: trim ``' '``/``'\\t'``, then the value must be 1..63 chars drawn
    from ``[0-9eE+-.]`` and float()-parseable; anything else — including a
    missing value — behaves as absent (NaN, which compares False against any
    threshold). The charset gate closes every strtod↔float() divergence
    (hex forms, digit underscores, inf/nan words, exotic whitespace). The
    REST path keeps the reference's throwing ``float()``
    (``VariantsPca.scala:136-148`` ``.toDouble``).

    JSONL wire records may carry AF as a JSON number rather than a string
    (``{"info": {"AF": [0.25]}}``) — numbers pass straight through."""
    if value is None:
        return float("nan")
    if isinstance(value, (int, float)):
        return float(value)
    value = value.strip(" \t")
    if not value or len(value) >= 64 or not _AF_CHARSET.issuperset(value):
        return float("nan")
    try:
        return float(value)
    except ValueError:
        return float("nan")


def default_ingest_workers() -> int:
    """Default parse worker count for the chunk-parallel ingest engine:
    ``min(8, cpu_count)`` — past ~8 threads the native parser is host
    memory-bandwidth-bound, and tiny containers should not oversubscribe."""
    return max(1, min(8, os.cpu_count() or 1))


def _resolve_ingest_workers(ingest_workers: Optional[int]) -> int:
    """``None`` = auto (:func:`default_ingest_workers`), ``0`` = the serial
    oracle path, ``N >= 1`` = exactly N parse threads."""
    if ingest_workers is None:
        return default_ingest_workers()
    workers = int(ingest_workers)
    if workers < 0:
        raise ValueError(f"ingest workers must be >= 0, got {workers}")
    return workers


def _ordered_pool_map(fn, items, workers: int, window: Optional[int] = None):
    """Map ``fn`` over ``items`` on a thread pool, yielding results in INPUT
    order with a bounded in-flight window — the order-preserving merge of the
    chunk-parallel ingest engine.

    Backpressure is structural: at most ``window`` results exist at once
    (pending futures + the one being yielded), and the source iterator is
    only advanced when a slot frees, so a slow consumer bounds both the pool
    queue AND how far a streaming reader runs ahead. ``workers <= 1``
    degrades to the serial loop (the oracle path — no pool, no reordering
    risk, bitwise-identical by construction). Exceptions surface at the
    failed item's position in the output order.
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    window = int(window or workers + 2)
    pending: deque = deque()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    try:
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for future in pending:
            future.cancel()
        pool.shutdown(wait=True)


def _line_aligned_spans(
    text: bytes, n_spans: int
) -> List[Tuple[int, int]]:
    """Split ``[0, len(text))`` into at most ``n_spans`` contiguous spans
    whose boundaries sit just past a ``'\\n'`` — the unit of work of the
    chunk-parallel parse. Concatenating the spans reproduces the buffer
    exactly; a final unterminated line stays whole in the last span."""
    size = len(text)
    if size == 0:
        return []
    n_spans = max(1, int(n_spans))
    target = -(-size // n_spans)
    spans: List[Tuple[int, int]] = []
    begin = 0
    while begin < size:
        cut = min(begin + target, size)
        if cut < size:
            nl = text.find(b"\n", cut - 1)
            cut = size if nl < 0 else nl + 1
        spans.append((begin, cut))
        begin = cut
    return spans


def _parse_vcf_info(text: str) -> Dict[str, List[str]]:
    """``AF=0.02,0.1;DB;NS=60`` → ``{"AF": ["0.02", "0.1"], "DB": [], ...}``."""
    info: Dict[str, List[str]] = {}
    if text in (".", ""):
        return info
    for item in text.split(";"):
        if "=" in item:
            key, value = item.split("=", 1)
            info[key] = value.split(",")
        elif item:
            info[item] = []
    return info


def _parse_genotype(gt: str) -> List[int]:
    """``0|1`` / ``0/1`` → ``[0, 1]``; missing alleles ('.') → -1 (the GA4GH
    convention; never counts as variation since only ``> 0`` does,
    ``VariantsPca.scala:67``)."""
    return [
        -1 if allele in (".", "") else int(allele)
        for allele in re.split(r"[/|]", gt)
    ]


def _vcf_line_record(
    line: str, path: str, set_id: str, samples: Sequence[str]
) -> Tuple[str, int, Dict]:
    """One VCF data line → ``(contig, start, wire record)`` — the single
    source of VCF data-line semantics, shared by the whole-file wire parser
    and the streaming chunk fallback so they cannot diverge.

    Wire-shape parity: VCF's 1-based POS becomes the half-open 0-based
    ``[start, end)`` interval the API used (``start = POS-1``,
    ``end = start + len(REF)``).
    """
    fields = line.split("\t")
    if len(fields) < 8:
        raise ValueError(
            f"{path}: malformed VCF data line (<8 fields): {line[:80]!r}"
        )
    chrom, pos, vid, ref, alt = fields[:5]
    start = int(pos) - 1
    record: Dict = {
        "referenceName": chrom,
        "variantSetId": set_id,
        "id": vid if vid != "." else f"{chrom}:{pos}:{ref}",
        "start": start,
        "end": start + len(ref),
        "referenceBases": ref,
        "info": _parse_vcf_info(fields[7]),
    }
    if vid != ".":
        record["names"] = vid.split(";")
    if alt not in (".", ""):
        record["alternateBases"] = alt.split(",")
    if len(fields) > 9 and samples:
        format_keys = fields[8].split(":")
        try:
            gt_index = format_keys.index("GT")
        except ValueError:
            gt_index = None
        calls = []
        for i, sample_field in enumerate(fields[9 : 9 + len(samples)]):
            call: Dict = {
                "callSetId": f"{set_id}-{i}",
                "callSetName": samples[i],
                "genotype": [],
            }
            if gt_index is not None:
                parts = sample_field.split(":")
                if gt_index < len(parts):
                    call["genotype"] = _parse_genotype(parts[gt_index])
            calls.append(call)
        record["calls"] = calls
    return chrom, start, record


def _parse_vcf(path: str, set_id: str, sink: SpooledRecordTable) -> List[Dict]:
    """Stream one VCF's data lines into ``sink`` (windowed read, one line
    resident at a time); → the callset list from the ``#CHROM`` header."""
    samples: List[str] = []
    for line in iter_text_lines(path):
        if not line:
            continue
        if line.startswith("#"):
            # '##' meta lines, the '#CHROM' column row, and any other
            # '#'-prefixed comment line are all header noise, never
            # data — matching the native parser (vcfparse.cpp skips
            # every '#' line), so the wire oracle and the packed paths
            # agree on comment-bearing files.
            if line.startswith("#CHROM"):
                columns = line.split("\t")
                samples = columns[9:] if len(columns) > 9 else []
            continue
        chrom, start, record = _vcf_line_record(line, path, set_id, samples)
        sink.add(chrom, start, record)
    return [
        {"id": f"{set_id}-{i}", "name": name} for i, name in enumerate(samples)
    ]


def _parse_jsonl(
    path: str, set_id: str, sink: SpooledRecordTable
) -> List[Dict]:
    """Stream wire-format JSON lines (bare variant dicts, or checkpoint
    entries ``{"key": ..., "variant": ...}``) into ``sink``. The cohort is
    taken from the first record carrying calls (1000G-style uniform
    cohorts)."""
    callsets: List[Dict] = []
    for line in iter_text_lines(path):
        line = line.strip()
        if not line:
            continue
        entry = json.loads(line)
        record = entry["variant"] if "variant" in entry else entry
        record = dict(record)
        record.setdefault("variantSetId", set_id)
        if not callsets and record.get("calls"):
            callsets = [
                {
                    "id": c.get("callSetId"),
                    "name": c.get("callSetName") or c.get("callSetId"),
                }
                for c in record["calls"]
            ]
        sink.add(record["referenceName"], int(record["start"]), record)
    return callsets


def _parse_sam(path: str, set_id: str, sink: SpooledRecordTable) -> List[Dict]:
    """Stream SAM text into ``sink`` as read wire dicts (the SearchReads
    item shape ``ReadBuilder.build`` consumes, ``models/read.py``)."""
    for line_no, line in enumerate(iter_text_lines(path)):
        if not line or line.startswith("@"):
            continue
        fields = line.split("\t")
        if len(fields) < 11:
            raise ValueError(
                f"{path}: malformed SAM data line (<11 fields): {line[:80]!r}"
            )
        qname, _flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = (
            fields[:11]
        )
        if rname == "*":
            continue  # unmapped: no position to shard on
        start = int(pos) - 1
        record: Dict = {
            "id": f"{set_id}:{line_no}",
            "fragmentName": qname,
            "readGroupSetId": set_id,
            "alignedSequence": "" if seq == "*" else seq,
            "fragmentLength": int(tlen),
            "alignment": {
                "position": {"referenceName": rname, "position": start},
                "mappingQuality": int(mapq),
                "cigar": [
                    {
                        "operationLength": int(length),
                        "operation": _CIGAR_OPS[op],
                    }
                    for length, op in _CIGAR_RE.findall(cigar)
                ],
            },
        }
        if qual != "*":
            record["alignedQuality"] = [ord(c) - 33 for c in qual]
        if rnext != "*":
            record["nextMatePosition"] = {
                "referenceName": rname if rnext == "=" else rnext,
                "position": int(pnext) - 1,
            }
        sink.add(rname, start, record)
    return []


def _load(path: str, set_id: str) -> Tuple[List[Dict], SpooledRecordTable, str]:
    """Parse one input into a finished spooled table and its record kind
    (``"variants"`` or ``"reads"``). The table's row
    capacity is the closed-form wire bound (``stream.wire_rows_bound``),
    enforced live: an input violating it raises ``StreamBudgetError``
    instead of growing past the bound."""
    if os.path.isdir(path):
        # A checkpoint directory (``pipeline/checkpoint.py``): concatenation
        # of its part files. A directory with no part files is a wrong path
        # (e.g. the checkpoint's parent), not an empty cohort — fail loudly.
        parts = [n for n in sorted(os.listdir(path)) if n.startswith("part-")]
        if not parts:
            raise ValueError(
                f"{path!r} is a directory with no part-* files; expected a "
                "checkpoint directory written by save_variants "
                "(pipeline/checkpoint.py)"
            )
        cap = sum(wire_rows_bound(os.path.join(path, n)) for n in parts)
        sink = SpooledRecordTable(path, capacity_rows=cap)
        callsets: List[Dict] = []
        for name in parts:
            part_callsets = _parse_jsonl(os.path.join(path, name), set_id, sink)
            callsets = callsets or part_callsets
        return callsets, sink.finish(), "variants"
    sink = SpooledRecordTable(path, capacity_rows=wire_rows_bound(path))
    lowered = path[:-3] if path.endswith(".gz") else path
    if lowered.endswith(".vcf"):
        return _parse_vcf(path, set_id, sink), sink.finish(), "variants"
    if lowered.endswith(".jsonl"):
        return _parse_jsonl(path, set_id, sink), sink.finish(), "variants"
    if lowered.endswith(".sam"):
        return _parse_sam(path, set_id, sink), sink.finish(), "reads"
    raise ValueError(
        f"unsupported input file {path!r}: expected .vcf[.gz], .jsonl[.gz], "
        ".sam, or a checkpoint directory"
    )


class _FileTable:
    """One parsed file: per-contig start-sorted spooled records + bisect
    queries. Resident memory is the integer index; records decode lazily
    from the spool per query (``stream.SpooledRecordTable``)."""

    def __init__(self, path: str, set_id: str):
        self.path = path
        self.set_id = set_id
        self.callsets, self.table, self.kind = _load(path, set_id)

    def query(
        self, contig: str, start: int, end: int, boundary: ShardBoundary
    ) -> Iterator[Dict]:
        starts = self.table.starts(contig)
        if boundary is ShardBoundary.STRICT:
            # Exactly the records whose start lies in [start, end).
            lo = int(np.searchsorted(starts, start, side="left"))
            hi = int(np.searchsorted(starts, end - 1, side="right"))
            yield from self.table.iter_records(contig, lo, hi)
            return
        # OVERLAPS: any record intersecting [start, end). Starts are sorted
        # but ends are not, so scan the prefix with start < end and filter.
        hi = int(np.searchsorted(starts, end - 1, side="right"))
        for record in self.table.iter_records(contig, 0, hi):
            if _record_end(record) > start:
                yield record

    def contigs(self) -> List[Contig]:
        out: List[Contig] = []
        for name in sorted(self.table.contig_names()):
            starts = self.table.starts(name)
            last = int(starts[-1]) if len(starts) else 0
            span = _max_span(self.table.tail_records(name, 64))
            out.append(Contig(name, 0, last + span))
        return out


def _record_end(record: Dict) -> int:
    """Half-open end of a variant or read record. Reads derive theirs from
    the reference-consuming CIGAR operations (M/D/N/=/X), the SAM span."""
    alignment = record.get("alignment")
    if alignment is None:
        return int(record.get("end", int(record["start"]) + 1))
    position = int(alignment["position"]["position"])
    span = sum(
        int(unit["operationLength"])
        for unit in alignment.get("cigar", [])
        if unit["operation"]
        in ("ALIGNMENT_MATCH", "DELETE", "SKIP", "SEQUENCE_MATCH", "SEQUENCE_MISMATCH")
    )
    return position + max(1, span)


def _record_start(record: Dict) -> int:
    alignment = record.get("alignment")
    if alignment is None:
        return int(record["start"])
    return int(alignment["position"]["position"])


def _max_span(records: List[Dict]) -> int:
    """Upper-bound span of the LAST few records (for a contig's bound)."""
    return max(
        (max(1, _record_end(r) - _record_start(r)) for r in records[-64:]),
        default=1,
    )


#: SearchVariants page size mirrored by the packed path's request
#: accounting (one request per page per shard, at least one per shard) —
#: keeps I/O stats identical between the wire and packed ingest paths.
FILE_PAGE_SIZE = 1024


def _records_to_arrays(items, n_samples: int):
    """(contig, start, wire record) triples → the native parser's array
    tuple — THE one Python record→arrays conversion (AF grammar,
    has-variation rows, zero-fill of short sample rows), shared by the
    whole-file fallback and the streamed chunk fallback so the two cannot
    drift."""
    contigs: List[str] = []
    positions: List[int] = []
    ends: List[int] = []
    af: List[float] = []
    hv_rows: List[np.ndarray] = []
    for contig, start, record in items:
        contigs.append(contig)
        positions.append(start)
        ends.append(int(record["end"]))
        af_values = record.get("info", {}).get("AF")
        af.append(af_float(af_values[0] if af_values else None))
        row = np.zeros(n_samples, dtype=np.int8)
        for i, call in enumerate(record.get("calls", [])[:n_samples]):
            if any(g > 0 for g in call.get("genotype", [])):
                row[i] = 1
        hv_rows.append(row)
    hv = (
        np.stack(hv_rows)
        if hv_rows
        else np.zeros((0, n_samples), dtype=np.int8)
    )
    return (
        np.array(contigs, dtype=object),
        np.array(positions, dtype=np.int64),
        np.array(ends, dtype=np.int64),
        np.array(af, dtype=np.float64),
        hv,
    )


def _python_vcf_arrays(path: str, set_id: str):
    """Pure-Python fallback producing the same arrays as the native parser
    (``utils/native.py:parse_vcf_arrays``), derived from the wire records —
    staged through a spooled table so even the fallback oracle never holds
    the record set in memory. Like the native parser, rows with fewer
    sample columns than the header zero-fill the missing samples (the
    header is the cohort authority)."""
    sink = SpooledRecordTable(path, capacity_rows=wire_rows_bound(path))
    callsets = _parse_vcf(path, set_id, sink)
    table = sink.finish()
    return _records_to_arrays(
        (
            (contig, int(start), record)
            for contig in sorted(table.contig_names())
            for start, record in zip(
                table.starts(contig).tolist(), table.iter_records(contig)
            )
        ),
        len(callsets),
    )


def _native_parallel_vcf_arrays(text: bytes, workers: int):
    """Span-parallel native parse of one in-memory VCF buffer: split into
    line-aligned spans, parse spans concurrently through the GIL-releasing
    C-ABI parser (``utils/native.py:parse_vcf_span``), and reassemble the
    per-span arrays in file order. Byte-identical to the serial
    ``parse_vcf_arrays`` by construction: the cohort comes from the same
    whole-buffer ``vcf_scan``, every span runs the same per-line core, and
    concatenation in span order IS file order. ``None`` when the native
    library is unavailable.

    Since the packed path moved to windowed staging
    (``_chunked_vcf_arrays``), no production path holds a whole-file
    buffer to hand here — this is the span-level parity oracle the fuzz
    corpus drives (parallel == serial on every document, including the
    malformed-ordinal contract), kept as the reference implementation for
    any buffer-holding caller."""
    from spark_examples_tpu_torch.utils.native import (
        parse_vcf_span,
        scan_vcf_counts,
    )

    from spark_examples_tpu_torch.utils.native import MalformedVcfLine

    counts = scan_vcf_counts(text)
    if counts is None:
        return None
    _, n_samples = counts
    # More spans than workers so a comment/header-dense span cannot straggle
    # the whole pool; spans stay multi-MB for real inputs.
    spans = _line_aligned_spans(text, workers * 4)
    if not spans:
        from spark_examples_tpu_torch.utils.native import parse_vcf_arrays

        return parse_vcf_arrays(text)
    parts = []
    rows_before = 0
    try:
        for arrays in _ordered_pool_map(
            lambda span: parse_vcf_span(text, span[0], span[1], n_samples),
            spans,
            workers,
        ):
            if arrays is None:  # library vanished mid-flight
                return None
            parts.append(arrays)
            rows_before += len(arrays[1])
    except MalformedVcfLine as e:
        # Results merge in span order, so every span BEFORE the failing one
        # has already been counted — the span-relative ordinal translates
        # to the file-level data-line number the serial parse reports.
        raise MalformedVcfLine(rows_before + e.ordinal) from None
    return tuple(
        np.concatenate([part[i] for part in parts]) for i in range(5)
    )


def _chunked_vcf_arrays(
    path: str, set_id: str, ingest_workers: Optional[int]
):
    """Windowed staging for the packed view: the streaming chunk engine
    (``_StreamedVcf.iter_chunk_arrays`` — bounded windows, partial-line
    carry, chunk-parallel native decode) feeds budgeted column builders
    (``stream.ChunkedArrayBuilder``, capacity = the closed-form wire row
    bound). Peak staging is O(workers × chunk) for the parse plus the
    growing packed columns, and for ``.gz`` inputs the compressed stream
    decodes window by window, never resident beside more than one
    decompressed window.

    → ``((contigs, positions, ends, af, hv), native)``; byte-identical to
    a whole-buffer parse (concatenating line-aligned windows in file order
    IS file order)."""
    from spark_examples_tpu_torch.utils.native import MalformedVcfLine

    view = _StreamedVcf(
        path,
        set_id,
        chunk_bytes=STREAM_CHUNK_BYTES,
        ingest_workers=ingest_workers,
    )
    cap = wire_rows_bound(path)
    n_samples = view.num_samples
    builders = (
        ChunkedArrayBuilder(object, capacity_rows=cap, label=path),
        ChunkedArrayBuilder(np.int64, capacity_rows=cap, label=path),
        ChunkedArrayBuilder(np.int64, capacity_rows=cap, label=path),
        ChunkedArrayBuilder(np.float64, capacity_rows=cap, label=path),
        ChunkedArrayBuilder(
            np.int8, row_shape=(n_samples,), capacity_rows=cap, label=path
        ),
    )
    rows_staged = 0
    try:
        for parts in view.iter_chunk_arrays():
            for builder, part in zip(builders, parts):
                builder.add(part)
            rows_staged += len(parts[1])
    except MalformedVcfLine as e:
        # Chunks merge in file order, so every chunk BEFORE the failing
        # one has been staged — the chunk-relative ordinal translates to
        # the file-level data-line number the serial parse reports.
        raise MalformedVcfLine(rows_staged + e.ordinal) from None
    return tuple(b.finish() for b in builders), view.native_decode


class _PackedVcf:
    """Column-oriented view of one VCF: per-contig start-sorted arrays
    (positions, AF, has-variation rows) feeding the packed ingest path —
    staged through the windowed chunk engine (native C++ decode when
    available, ``native/vcfparse.cpp``, chunk-parallel across
    ``ingest_workers`` threads; the shared-semantics Python fallback
    otherwise) with identical output (tested)."""

    def __init__(
        self,
        path: str,
        set_id: str,
        ingest_workers: Optional[int] = None,
    ):
        from spark_examples_tpu_torch.utils.native import vcf_library

        self.path = path
        self.native = False
        _resolve_ingest_workers(ingest_workers)
        lowered = path[:-3] if path.endswith(".gz") else path
        if not lowered.endswith(".vcf"):
            raise ValueError(
                f"packed ingest needs a .vcf[.gz] input; got {path!r}"
            )
        # Probe library availability BEFORE reading: without a compiler the
        # chunk engine would pay the windowed read only to fall back per
        # chunk — the spooled Python oracle is the honest path there.
        if vcf_library() is not None:
            arrays, self.native = _chunked_vcf_arrays(
                path, set_id, ingest_workers
            )
        else:
            arrays = _python_vcf_arrays(path, set_id)
        contigs, positions, ends, af, hv = arrays
        self.num_samples = hv.shape[1]
        self.by_contig: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self.contig_bounds: Dict[str, int] = {}
        for name in dict.fromkeys(contigs.tolist()):  # first-seen order
            mask = contigs == name
            order = np.argsort(positions[mask], kind="stable")
            self.by_contig[str(name)] = (
                positions[mask][order],
                af[mask][order],
                np.ascontiguousarray(hv[mask][order]),
            )
            self.contig_bounds[str(name)] = int(ends[mask].max())

    def window(self, contig: Contig):
        """(positions, af, hv) rows with start in [contig.start, contig.end)
        — the STRICT shard semantics of the wire path."""
        starts, af, hv = self.by_contig.get(
            contig.reference_name, (np.empty(0, np.int64), None, None)
        )
        if af is None:
            return (
                np.empty(0, np.int64),
                np.empty(0, np.float64),
                np.zeros((0, self.num_samples), np.int8),
            )
        lo = int(np.searchsorted(starts, contig.start, side="left"))
        hi = int(np.searchsorted(starts, contig.end - 1, side="right"))
        return starts[lo:hi], af[lo:hi], hv[lo:hi]


#: Decompressed bytes per streamed parse chunk (default; ``_StreamedVcf``).
STREAM_CHUNK_BYTES = 32 << 20

#: DECOMPRESSED bytes above which a VCF streams by default when no explicit
#: ``--stream-chunk-bytes`` is given. The reference's paging architecture
#: held one page per executor (``rdd/VariantsRDD.scala:198-225``);
#: whole-file parsing only wins below this scale.
STREAM_THRESHOLD_BYTES = 128 << 20

#: Conservative gzip ratio for VCF text (GT matrices compress 10-30×): the
#: auto-streaming decision compares a ``.gz`` file's on-disk size × this
#: against the decompressed threshold, so the standard compressed 1000
#: Genomes distribution streams instead of silently expanding to multi-GB
#: host arrays under the raw-size test.
_GZ_RATIO_ESTIMATE = 10


def _read_vcf_header_samples(path: str) -> List[str]:
    """Sample names from the ``#CHROM`` header row alone — O(header) work
    and memory, so callset discovery never pays a data parse. A headerless
    VCF (a data line before any ``#CHROM`` row) yields the empty cohort,
    exactly like the whole-file wire parser (``_parse_vcf``) — header-only
    discovery must not reject files the data parse would accept."""
    # A small window: the scan usually ends within the first KBs, and the
    # streamed-ingest memory tests pin the whole pass to O(chunk).
    for line in iter_text_lines(path, window_bytes=64 << 10):
        if not line:
            continue
        if line.startswith("#CHROM"):
            columns = line.split("\t")
            return columns[9:] if len(columns) > 9 else []
        if line.startswith("#"):
            # Any other '#'-prefixed line ('##' meta or a bare comment)
            # is header noise, not data: keep scanning for #CHROM. A
            # single-'#' comment before #CHROM previously ended the
            # scan here and silently yielded a 0-sample cohort.
            continue
        break  # a data line before #CHROM: headerless, no cohort
    return []


def _iter_vcf_chunks(path: str, chunk_bytes: int) -> Iterator[bytes]:
    """Stream a (possibly gzipped) text file in ~``chunk_bytes`` pieces that
    end at line boundaries (the partial last line carries into the next
    chunk), holding one chunk in memory at a time — the shared windowed
    reader (``sources/stream.py:iter_byte_windows``; the 64-byte window
    floor lives there)."""
    return iter_byte_windows(path, chunk_bytes)


def _python_chunk_arrays(chunk: bytes, path: str, set_id: str, samples):
    """Pure-Python fallback for one streamed chunk: the same array tuple as
    ``utils/native.py:parse_vcf_chunk``, in FILE order, built through the
    shared per-line wire parser (``_vcf_line_record``) and the shared
    record→arrays conversion (``_records_to_arrays``) so streamed semantics
    cannot drift from the wire oracle at either layer."""
    return _records_to_arrays(
        (
            _vcf_line_record(line, path, set_id, samples)
            for line in chunk.decode("utf-8").splitlines()
            if line and not line.startswith("#")
        ),
        len(samples),
    )


def _contig_runs(contigs: np.ndarray) -> Iterator[Tuple[str, slice]]:
    """Maximal same-contig runs of a per-row contig array, in order."""
    if len(contigs) == 0:
        return
    changes = np.flatnonzero(contigs[1:] != contigs[:-1]) + 1
    edges = [0, *changes.tolist(), len(contigs)]
    for lo, hi in zip(edges[:-1], edges[1:]):
        yield str(contigs[lo]), slice(lo, hi)


class UnsortedVcfError(UnsortedStreamError):
    """A streaming pass met records out of coordinate order. Explicitly
    requested streaming (``--stream-chunk-bytes N``) surfaces this as the
    hard error it is; AUTO-selected streaming catches it and falls back to
    the in-memory path with a warning (``FileGenomicsSource``) — the
    size heuristic must not turn a file that loaded fine before the
    threshold existed into a hard failure."""


class _RunOrderCheck(SortednessProbe):
    """Coordinate-sortedness guard for one streaming pass — the VCF face
    of the shared ``stream.SortednessProbe`` contract (contig-contiguous,
    non-decreasing positions), raising :class:`UnsortedVcfError` with the
    VCF-specific remedy."""

    def __init__(self, path: str):
        super().__init__(
            path,
            error_cls=UnsortedVcfError,
            hint=(
                "streaming ingest needs a coordinate-sorted VCF; sort the "
                "input or disable streaming (--stream-chunk-bytes 0)"
            ),
        )


class StreamCounters:
    """I/O-stats accounting filled during one streaming pass, mirroring the
    in-memory packed path's numbers exactly: ``requests`` are pages per
    shard over PRE-filter rows (at least one per shard, empty included),
    ``variants`` are post-filter kept rows.

    ``registry`` (the run's metrics registry, optional) gets live progress
    gauges as the pass advances — ``ingest_sites_scanned`` (rows attributed
    to shard windows so far) and ``ingest_partitions_done`` (windows the
    file-order cursor has reached) — because the driver flushes these
    counters into its I/O stats only AFTER the stream is fully consumed;
    without the gauges a multi-hour streaming ingest would heartbeat 0/N
    the whole way.
    """

    def __init__(
        self,
        num_shards: int,
        page_size: int = FILE_PAGE_SIZE,
        registry=None,
    ):
        self.num_shards = int(num_shards)
        self.page_size = int(page_size)
        self.shard_rows: Dict[int, int] = {}
        self.variants = 0
        self._rows_seen = 0
        self._reached: set = set()
        self._sites_gauge = self._done_gauge = None
        if registry is not None:
            from spark_examples_tpu_torch.obs.metrics import (
                INGEST_PARTITIONS_DONE,
                INGEST_SITES_SCANNED,
                well_known_gauge,
            )

            self._sites_gauge = well_known_gauge(
                registry, INGEST_SITES_SCANNED
            )
            self._done_gauge = well_known_gauge(
                registry, INGEST_PARTITIONS_DONE
            )

    def mark_window_reached(self, shard_index: int) -> None:
        """The file-order cursor reached this window — counted whether or
        not any record fell inside it, so the heartbeat's done/planned
        progress converges even with empty shard windows."""
        self._reached.add(shard_index)
        if self._done_gauge is not None:
            self._done_gauge.set(len(self._reached))

    def add_shard_rows(self, shard_index: int, n: int) -> None:
        """Pre-filter rows attributed to one shard window (page accounting
        derives from these in :meth:`requests`)."""
        self.shard_rows[shard_index] = self.shard_rows.get(shard_index, 0) + n
        self._rows_seen += n
        if self._sites_gauge is not None:
            self._sites_gauge.set(self._rows_seen)
        self.mark_window_reached(shard_index)

    def add_variants(self, n: int) -> None:
        """Post-filter kept rows."""
        self.variants += n

    def requests(self) -> int:
        nonempty = sum(
            -(-rows // self.page_size)
            for rows in self.shard_rows.values()
            if rows
        )
        empty = self.num_shards - sum(
            1 for rows in self.shard_rows.values() if rows
        )
        return nonempty + empty


class _StreamedVcf:
    """Bounded-memory streaming view of one VCF: one pass over the file in
    ``chunk_bytes`` pieces, native chunk parser when available
    (``native/vcfparse.cpp:vcf_parse`` is header-agnostic; the host carries
    partial lines), the shared-semantics Python fallback otherwise.

    This is the capability the reference's Spark ingest had by construction
    — one page in memory per executor (``rdd/VariantsRDD.scala:198-225``) —
    restated for the packed ingest: peak host memory is O(chunk), not
    O(file), so real larger-than-RAM cohort ingests run end to end. Requires
    a coordinate-sorted VCF (checked; the in-memory view has no such
    requirement). Gramian accumulation commutes, so blocks stream in FILE
    order regardless of the requested shard order.
    """

    def __init__(
        self,
        path: str,
        set_id: str,
        chunk_bytes: int = STREAM_CHUNK_BYTES,
        ingest_workers: Optional[int] = None,
    ):
        self.path = path
        self.set_id = set_id
        self.chunk_bytes = int(chunk_bytes)
        self.ingest_workers = _resolve_ingest_workers(ingest_workers)
        self.samples = _read_vcf_header_samples(path)
        self.num_samples = len(self.samples)
        self.callsets = [
            {"id": f"{set_id}-{i}", "name": name}
            for i, name in enumerate(self.samples)
        ]
        self._bounds: Optional[Dict[str, int]] = None
        #: Whether the LAST ``iter_chunk_arrays`` pass decoded natively
        #: end to end (the packed view's ``native`` flag derives from it).
        self.native_decode = False

    def iter_chunk_arrays(self):
        """→ ``(contigs, positions, ends, af, hv)`` per chunk, file order.

        With ``ingest_workers >= 2`` and the native library available,
        chunks decode CONCURRENTLY on a thread pool (the C-ABI parse
        releases the GIL) while this generator yields them in file order —
        the streaming face of the chunk-parallel ingest engine. The
        in-flight window is bounded (``_ordered_pool_map``), so peak host
        memory grows from O(chunk) to O(workers × chunk), still independent
        of file size, and a slow consumer backpressures the reader. The
        pure-Python fallback stays serial: it holds the GIL, so a pool
        would only add overhead around the same single-core parse."""
        from spark_examples_tpu_torch.utils.native import (
            parse_vcf_chunk,
            vcf_library,
        )

        self.native_decode = vcf_library() is not None

        def decode(chunk: bytes):
            arrays = parse_vcf_chunk(chunk, self.num_samples)
            if arrays is None:
                self.native_decode = False  # library vanished mid-flight
                arrays = _python_chunk_arrays(
                    chunk, self.path, self.set_id, self.samples
                )
            return arrays

        workers = self.ingest_workers if vcf_library() is not None else 0
        chunks = _iter_vcf_chunks(self.path, self.chunk_bytes)
        for arrays in _ordered_pool_map(decode, chunks, workers):
            if len(arrays[1]):
                yield arrays

    def contig_bounds(self) -> Dict[str, int]:
        """{contig: max record end} from a site-only streaming pass — lazy
        contig discovery for ``--all-references`` without the per-sample
        genotype walk (the result matches ``_PackedVcf.contig_bounds``)."""
        if self._bounds is None:
            from spark_examples_tpu_torch.utils.native import scan_vcf_sites_chunk

            bounds: Dict[str, int] = {}
            order = _RunOrderCheck(self.path)
            for chunk in _iter_vcf_chunks(self.path, self.chunk_bytes):
                scanned = scan_vcf_sites_chunk(chunk)
                if scanned is None:
                    # Site-only on the fallback too: an empty sample list
                    # skips the per-sample genotype walk entirely
                    # (contig/position/end are sample-independent).
                    contigs, positions, ends = _python_chunk_arrays(
                        chunk, self.path, self.set_id, []
                    )[:3]
                else:
                    contigs, positions, ends = scanned
                for name, run in _contig_runs(contigs):
                    order.check(name, positions[run])
                    run_max = int(ends[run].max())
                    if run_max > bounds.get(name, 0):
                        bounds[name] = run_max
            self._bounds = bounds
        return self._bounds

    def stream_blocks(
        self,
        shards: Sequence[Contig],
        block_size: int = 1024,
        min_allele_frequency: Optional[float] = None,
        counters: Optional[StreamCounters] = None,
    ) -> Iterator[Dict]:
        """ONE streaming pass serving every shard window: yields the same
        block dicts as ``FileGenomicsSource.genotype_blocks`` (AF-filtered,
        all-zero-variation rows dropped), in file order. ``counters`` (when
        given) accumulates the wire-parity request/variant accounting the
        per-shard path computes from its random-access view."""
        by_name: Dict[str, List[Tuple[int, int, int]]] = {}
        for idx, shard in enumerate(shards):
            by_name.setdefault(shard.reference_name, []).append(
                (shard.start, shard.end, idx)
            )
        for lst in by_name.values():
            lst.sort()
        # Advancing per-contig cursor over the start-sorted shard list: runs
        # arrive in position order (checked), so shards wholly before the
        # current run never revive.
        cursor = {name: 0 for name in by_name}
        order = _RunOrderCheck(self.path)

        for contigs, positions, ends, af, hv in self.iter_chunk_arrays():
            for name, run in _contig_runs(contigs):
                pos = positions[run]
                order.check(name, pos)
                lst = by_name.get(name)
                if not lst:
                    continue
                run_lo, run_hi = int(pos[0]), int(pos[-1])
                p = cursor[name]
                while p < len(lst) and lst[p][1] <= run_lo:
                    # Window wholly behind the stream — reached (possibly
                    # empty), never revived.
                    if counters is not None:
                        counters.mark_window_reached(lst[p][2])
                    p += 1
                cursor[name] = p
                af_run = af[run]
                hv_run = hv[run]
                for start, end, idx in lst[p:]:
                    if start > run_hi:
                        break
                    if counters is not None:
                        counters.mark_window_reached(idx)
                    lo = int(np.searchsorted(pos, start, side="left"))
                    hi = int(np.searchsorted(pos, end, side="left"))
                    if hi <= lo:
                        continue
                    if counters is not None:
                        counters.add_shard_rows(idx, hi - lo)
                    s_pos, s_af, s_hv = pos[lo:hi], af_run[lo:hi], hv_run[lo:hi]
                    if min_allele_frequency is not None:
                        # The reference's rule (``VariantsPca.scala:
                        # 136-148``): strictly greater, first AF value,
                        # absent AF (NaN) never passes.
                        keep = s_af > min_allele_frequency
                        s_pos, s_af, s_hv = s_pos[keep], s_af[keep], s_hv[keep]
                    for off in range(0, len(s_pos), block_size):
                        hv_block = s_hv[off : off + block_size]
                        nonzero = hv_block.any(axis=1)
                        if not nonzero.any():
                            continue
                        if counters is not None:
                            counters.add_variants(int(nonzero.sum()))
                        yield {
                            "positions": s_pos[off : off + block_size][nonzero],
                            "has_variation": hv_block[nonzero].astype(np.uint8),
                            "af": s_af[off : off + block_size][nonzero],
                        }


class FileClient(GenomicsClient):
    """A per-partition session over the shared parsed tables; counts one
    initialized request per page of results (REST-parity accounting)."""

    def __init__(self, tables: Mapping[str, _FileTable]):
        super().__init__()
        self._tables = tables

    def _search(
        self, set_ids: Sequence[str], request: Mapping, boundary, page_size: int
    ) -> Iterator[Dict]:
        contig = request["referenceName"]
        start = int(request.get("start", 0))
        end = int(request.get("end", 1 << 62))
        emitted = 0
        for set_id in set_ids:
            table = self._tables.get(set_id)
            if table is None:
                raise KeyError(
                    f"unknown set id {set_id!r}; have {sorted(self._tables)}"
                )
            for record in table.query(contig, start, end, boundary):
                if emitted % page_size == 0:
                    self.counters.add_request()
                emitted += 1
                yield record
        if emitted == 0:
            self.counters.add_request()  # the empty page

    def search_variants(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = FILE_PAGE_SIZE,
    ) -> Iterator[Dict]:
        return self._search(
            request["variantSetIds"], request, boundary, page_size
        )

    def search_reads(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = FILE_PAGE_SIZE,
    ) -> Iterator[Dict]:
        return self._search(
            request["readGroupSetIds"], request, boundary, page_size
        )


class FileGenomicsSource(GenomicsSource):
    """Local files behind the :class:`GenomicsSource` seam.

    ``paths`` maps each file to a set id (``file_set_ids``); each file parses
    once, lazily, under a lock (per-shard worker threads all call
    :meth:`client` concurrently — without the lock each would re-parse every
    file) and the tables are shared by every client session.
    """

    def __init__(
        self,
        paths: Sequence[str],
        stream_chunk_bytes: Optional[int] = None,
        ingest_workers: Optional[int] = None,
    ):
        if not paths:
            raise ValueError("--source file needs --input-files")
        self.paths = list(paths)
        self.set_ids = file_set_ids(self.paths)
        self._by_id = dict(zip(self.set_ids, self.paths))
        self._tables: Dict[str, _FileTable] = {}
        self._packed: Dict[str, _PackedVcf] = {}
        self._streamed: Dict[str, _StreamedVcf] = {}
        #: ``None`` = auto (stream VCFs past ``STREAM_THRESHOLD_BYTES``),
        #: ``0`` = never stream, ``> 0`` = always stream with this chunk.
        self.stream_chunk_bytes = stream_chunk_bytes
        #: Chunk-parallel ingest threads (``--ingest-workers``): ``None`` =
        #: auto (:func:`default_ingest_workers`), ``0`` = the serial oracle
        #: path. Validated here so a bad value fails at construction, not
        #: from a worker thread mid-parse.
        self.ingest_workers = ingest_workers
        _resolve_ingest_workers(ingest_workers)
        #: Sets whose AUTO-selected streaming failed the coordinate-order
        #: probe and fell back to the in-memory path (with a warning).
        self._no_stream: set = set()
        # lock order: leaf lock guarding the parsed-view caches; held only
        # around dict get/insert (parses happen inside, but never take
        # another lock — the parse pool's workers are lock-free).
        self._lock = threading.Lock()

    def _table(self, set_id: str) -> _FileTable:
        with self._lock:
            table = self._tables.get(set_id)
            if table is None:
                if set_id not in self._by_id:
                    raise KeyError(
                        f"unknown set id {set_id!r}; inputs are {self.set_ids}"
                    )
                table = _FileTable(self._by_id[set_id], set_id)
                self._tables[set_id] = table
            return table

    def client(self) -> FileClient:
        # Materialize every table so client sessions share one parsed copy.
        for set_id in self.set_ids:
            self._table(set_id)
        return FileClient(self._tables)

    # -------------------------------------------------------- streaming mode

    def _is_vcf(self, set_id: str) -> bool:
        path = self._by_id.get(set_id, "")
        lowered = path[:-3] if path.endswith(".gz") else path
        return lowered.endswith(".vcf") and not os.path.isdir(path)

    def wants_streaming(self, set_id: str) -> bool:
        """Whether this set's packed ingest should stream (bounded memory)
        rather than load: explicit via ``stream_chunk_bytes`` (0 = never,
        > 0 = always), else automatic past ``STREAM_THRESHOLD_BYTES``.
        Only VCFs stream; other formats keep the in-memory tables. Sets
        whose auto-selected streaming already failed the sortedness probe
        report False (they fell back to the in-memory path)."""
        if not self._is_vcf(set_id):
            return False
        if self.stream_chunk_bytes is not None:
            return self.stream_chunk_bytes > 0
        if set_id in self._no_stream:
            return False
        path = self._by_id[set_id]
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        if path.endswith(".gz"):
            # The threshold is in DECOMPRESSED bytes; estimate from the
            # compressed size (exact sizing would require reading the file).
            size *= _GZ_RATIO_ESTIMATE
        return size > STREAM_THRESHOLD_BYTES

    def streamed(self, set_id: str) -> _StreamedVcf:
        """The streaming view of one VCF input (header parsed once; data
        never resident)."""
        with self._lock:
            view = self._streamed.get(set_id)
            if view is None:
                if set_id not in self._by_id:
                    raise KeyError(
                        f"unknown set id {set_id!r}; inputs are {self.set_ids}"
                    )
                view = _StreamedVcf(
                    self._by_id[set_id],
                    set_id,
                    chunk_bytes=self.stream_chunk_bytes or STREAM_CHUNK_BYTES,
                    ingest_workers=self.ingest_workers,
                )
                self._streamed[set_id] = view
            return view

    def _auto_stream_verified(self, set_id: str) -> bool:
        """The ADVICE.md sharp-edge fix: AUTO-selected streaming verifies
        coordinate-sortedness up front (a cached site-only pass — the same
        scan lazy contig discovery runs, O(chunk) memory, no genotype walk)
        instead of hard-erroring mid-ingest. An unsorted file warns and
        falls back to the in-memory path; EXPLICIT ``--stream-chunk-bytes N``
        skips the probe and keeps the hard error (the flag asserts the
        input is sorted; a silent O(file) fallback would betray exactly the
        memory bound the user demanded)."""
        if self.stream_chunk_bytes is not None:
            return True  # explicit: trusted, hard error downstream
        if set_id in self._no_stream:
            return False
        try:
            # Runs (and caches) the order-checked site scan; sorted files
            # reuse the result for contig discovery.
            self.streamed(set_id).contig_bounds()
        except UnsortedVcfError as e:
            warnings.warn(
                f"auto-selected streaming ingest found an unsorted VCF "
                f"({e}); falling back to the in-memory parse — peak host "
                "memory is O(file), not O(chunk). Sort the input to "
                "restore bounded-memory streaming, or pass "
                "--stream-chunk-bytes 0 to choose the in-memory path "
                "explicitly and skip this probe.",
                RuntimeWarning,
                stacklevel=3,
            )
            with self._lock:
                self._no_stream.add(set_id)
                self._streamed.pop(set_id, None)
            return False
        return True

    def _packed_blocks(
        self,
        view: "_PackedVcf",
        shard: Contig,
        block_size: int,
        min_allele_frequency: Optional[float],
        counters: Optional[StreamCounters] = None,
        shard_index: Optional[int] = None,
    ) -> Iterator[Dict]:
        """Dense blocks for ONE shard window from the in-memory packed
        view — the shared body of the packed fast path and the unsorted-VCF
        fallback (whose ``counters`` must match what the streaming pass
        would have recorded: pre-filter rows per shard, post-filter kept
        variants)."""
        positions, af, hv = view.window(shard)
        if counters is not None and shard_index is not None and len(positions):
            counters.add_shard_rows(shard_index, len(positions))
        if min_allele_frequency is not None:
            # The reference's rule (``VariantsPca.scala:136-148``): strictly
            # greater, first AF value, records without AF dropped (NaN here;
            # NaN > t is False, so absent/unparseable AF never passes).
            keep = af > min_allele_frequency
            positions, af, hv = positions[keep], af[keep], hv[keep]
        for off in range(0, len(positions), block_size):
            hv_block = hv[off : off + block_size]
            nonzero = hv_block.any(axis=1)
            if not nonzero.any():
                continue
            if counters is not None:
                counters.add_variants(int(nonzero.sum()))
            yield {
                "positions": positions[off : off + block_size][nonzero],
                "has_variation": hv_block[nonzero].astype(np.uint8),
                "af": af[off : off + block_size][nonzero],
            }

    def stream_genotype_blocks(
        self,
        variant_set_id: str,
        shards: Sequence[Contig],
        block_size: int = 1024,
        min_allele_frequency: Optional[float] = None,
        counters: Optional[StreamCounters] = None,
    ) -> Iterator[Dict]:
        """One bounded-memory pass serving EVERY shard window (file order;
        the Gramian sum commutes). See ``_StreamedVcf.stream_blocks``.

        When the set was auto-selected for streaming but fails the
        sortedness probe (:meth:`_auto_stream_verified`), the same block
        stream — identical dicts, identical counter accounting — is served
        from the in-memory packed view instead, so a caller that already
        chose the streaming path degrades without re-planning."""
        if self._auto_stream_verified(variant_set_id):
            yield from self.streamed(variant_set_id).stream_blocks(
                shards,
                block_size=block_size,
                min_allele_frequency=min_allele_frequency,
                counters=counters,
            )
            return
        view = self.packed(variant_set_id)
        for idx, shard in enumerate(shards):
            yield from self._packed_blocks(
                view,
                shard,
                block_size,
                min_allele_frequency,
                counters=counters,
                shard_index=idx,
            )

    def native_parse(self, set_id: str, streamed: bool) -> Optional[bool]:
        """Whether the last packed (``streamed=False``) or streamed pass over
        ``set_id`` decoded with the native parser; ``None`` when that view
        never parsed. A streamed pass that fell back to the in-memory view
        (an unsorted file under auto streaming) reports the packed view."""
        with self._lock:
            if streamed and set_id not in self._no_stream:
                view = self._streamed.get(set_id)
                return None if view is None else view.native_decode
            packed = self._packed.get(set_id)
        return None if packed is None else packed.native

    # ------------------------------------------------------ packed fast path

    def packed(self, set_id: str) -> _PackedVcf:
        """The column-oriented packed view of one VCF input (native parser
        when available), parsed once under the same lock discipline as the
        wire tables."""
        with self._lock:
            view = self._packed.get(set_id)
            if view is None:
                if set_id not in self._by_id:
                    raise KeyError(
                        f"unknown set id {set_id!r}; inputs are {self.set_ids}"
                    )
                view = _PackedVcf(
                    self._by_id[set_id],
                    set_id,
                    ingest_workers=self.ingest_workers,
                )
                self._packed[set_id] = view
            return view

    def genotype_blocks(
        self,
        variant_set_id: str,
        contig: Contig,
        block_size: int = 1024,
        min_allele_frequency: Optional[float] = None,
    ) -> Iterator[Dict]:
        """Packed fast path: dense has-variation blocks for the Gramian —
        the same contract as the synthetic source's ``genotype_blocks``
        (AF-filtered, all-zero-variation rows dropped, the
        ``filter(_.size > 0)`` stage of ``VariantsPca.scala:206``).

        Streaming sets serve the window from a bounded-memory pass — one
        full decompress+parse pass of the file PER CALL, deliberately: the
        alternative (falling back to the in-memory view) would silently
        hold an O(file) parse of exactly the inputs streaming exists to
        bound. Multi-window callers on streaming sets must use
        :meth:`stream_genotype_blocks`, which serves every window in one
        pass (the driver does)."""
        if self.wants_streaming(variant_set_id) and self._auto_stream_verified(
            variant_set_id
        ):
            yield from self.stream_genotype_blocks(
                variant_set_id,
                [contig],
                block_size=block_size,
                min_allele_frequency=min_allele_frequency,
            )
            return
        yield from self._packed_blocks(
            self.packed(variant_set_id), contig, block_size,
            min_allele_frequency,
        )

    def page_requests(
        self, variant_set_id: str, contig: Contig, bases_per_partition: int
    ) -> int:
        """Wire-equivalent request accounting for a packed scan of
        ``contig``: one request per ``FILE_PAGE_SIZE`` records per shard, at
        least one per shard — exactly what ``FileClient.search_variants``
        counts, so I/O stats agree between the wire and packed paths."""
        view = self.packed(variant_set_id)
        total = 0
        for shard in contig.get_shards(bases_per_partition):
            rows = len(view.window(shard)[0])
            total += max(1, -(-rows // FILE_PAGE_SIZE))
        return total

    def search_callsets(self, variant_set_ids: Sequence[str]) -> List[Dict]:
        out: List[Dict] = []
        seen = set()
        for set_id in variant_set_ids:
            if set_id in seen:
                continue
            seen.add(set_id)
            if set_id not in self._tables and self._is_vcf(set_id):
                # VCF callsets come from the #CHROM header alone (identical
                # to the full parse's list) — a multi-GB VCF must not pay a
                # whole-file wire parse just to learn its cohort.
                out.extend(self.streamed(set_id).callsets)
                continue
            out.extend(self._table(set_id).callsets)
        return out

    def get_contigs(
        self,
        variant_set_id: str,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.INCLUDE_XY,
    ) -> List[Contig]:
        from spark_examples_tpu_torch.utils.native import vcf_library

        path = self._by_id.get(variant_set_id)
        lowered = (
            path[:-3] if path and path.endswith(".gz") else (path or "")
        )
        if self.wants_streaming(variant_set_id) and self._auto_stream_verified(
            variant_set_id
        ):
            # Lazy discovery: a site-only streaming pass (CHROM/POS/REF —
            # no genotype walk) learns the bounds in O(chunk) memory; the
            # result matches the packed view's ``contig_bounds``. The probe
            # above already ran (and cached) this scan for auto mode;
            # explicit streaming pays it here, where UnsortedVcfError
            # remains the documented hard error.
            contigs = [
                Contig(name, 0, bound)
                for name, bound in sorted(
                    self.streamed(variant_set_id).contig_bounds().items()
                )
            ]
            return filter_sex_chromosomes(contigs, sex_filter)
        with self._lock:
            packed = self._packed.get(variant_set_id)
            have_table = variant_set_id in self._tables
        if (
            packed is None
            and not have_table
            and lowered.endswith(".vcf")
            and vcf_library() is not None
        ):
            # Neither view exists yet: the native packed parse is the cheap
            # way to learn the contig extents (a packed --all-references run
            # would otherwise pay the full per-record Python parse here).
            packed = self.packed(variant_set_id)
        if packed is not None:
            contigs = [
                Contig(name, 0, bound)
                for name, bound in sorted(packed.contig_bounds.items())
            ]
            return filter_sex_chromosomes(contigs, sex_filter)
        return filter_sex_chromosomes(
            self._table(variant_set_id).contigs(), sex_filter
        )


__all__ = [
    "FileGenomicsSource",
    "FileClient",
    "StreamCounters",
    "UnsortedVcfError",
    "af_float",
    "default_ingest_workers",
    "file_set_id",
    "file_set_ids",
]
