"""Checkpoints: variants (``--save-variants``, ``--input-path``) and the
Gramian (``--gramian-checkpoint-dir``, ``--resume-from``).

The port's copy of ``spark_examples_tpu/pipeline/checkpoint.py``. The
reference resumed from pre-materialized variants
(``--input-path`` makes ``getData`` read ``sc.objectFile[(VariantKey,
Variant)]`` instead of hitting the API, ``VariantsPca.scala:112-113``,
stats disabled ``:332-335``): :func:`save_variants` /
:class:`CheckpointWriter` write sharded gzip JSON-lines part files and a
manifest, :func:`load_variants` streams them back. The on-disk format is
the JAX package's, so a checkpoint written by either package loads in the
other.

The manifest is published last, atomically (tmp + ``os.replace``), and the
reader cross-checks it against the part files on disk: a deleted, extra
or truncated part fails loudly as :class:`CheckpointCorruptError` instead
of silently resuming a polluted cohort.

Gramian checkpoints are the analysis pass's resume artifact: one
``gramian.ckpt.npz`` (the partial Gramian and a JSON meta record) that
:class:`GramianFeeder` publishes atomically every
``--checkpoint-every-sites`` rows, keyed by the conf fingerprint. The
artifact, its meta fields and the fingerprint are the reference's, so each
package resumes the other's checkpoints
(:func:`gramian_checkpoint_fingerprint` digests the reference's field set;
the port saves its G as the reference's ``(data_parallel, N, N)`` stack of
one slice).
"""

from __future__ import annotations

import gzip
import json
import os
import time
import zipfile
import zlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from spark_examples_tpu_torch.models.variant import Variant, VariantKey, VariantsBuilder
from spark_examples_tpu_torch.sources.stream import iter_byte_windows
from spark_examples_tpu_torch.utils import faults
from spark_examples_tpu_torch.utils.cache import compile_fingerprint

_MANIFEST = "_manifest.json"

#: Writer-side coalescing buffer: encoded lines accumulate to ~this many
#: characters between ``write()`` calls (bounded by one record past it).
_WRITE_BUFFER_BYTES = 1 << 20

#: Reader-side window: decompressed bytes per chunk of a part-file walk.
_READ_CHUNK_BYTES = 4 << 20


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory that cannot be trusted: missing/truncated/
    unparseable manifest, or part files that disagree with it. Raised
    instead of a raw ``JSONDecodeError``/``KeyError`` so callers (and
    operators) see "this checkpoint is corrupt — re-materialize it", not
    a parser traceback."""


class CheckpointMismatchError(RuntimeError):
    """A Gramian checkpoint whose conf fingerprint does not match the
    resuming run: merging it would silently produce a Gramian of a
    DIFFERENT analysis (other cohort, block size, references...). The
    artifact is fine; the flags are not."""


def _iter_jsonl_lines(path: str, chunk_bytes: int = _READ_CHUNK_BYTES):
    """Decoded JSON objects of one gzip JSON-lines file, streamed through
    the ONE windowed reader (``sources/stream.py:iter_byte_windows`` —
    fixed-size window, partial-line carry): peak memory is O(window),
    never O(part)."""
    for window in iter_byte_windows(path, chunk_bytes):
        for line in window.splitlines():
            if line.strip():
                yield json.loads(line)


class CheckpointWriter:
    """Incremental checkpoint writer: one gzip JSON-lines part file per
    shard as it streams, the manifest only on :meth:`close` — an abandoned
    (partially written) checkpoint has no manifest and fails loudly on
    load instead of silently resuming a truncated cohort.

    Records are the wire-format JSON of ``Variant.to_json`` plus the raw
    partition key, so the round trip preserves both members of the
    ``(VariantKey, Variant)`` pair the reference's objectFile held.
    """

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        # Re-materializing into an existing checkpoint dir: retract the
        # old manifest FIRST, so a crash mid-write leaves unreferenced
        # part files (loud CheckpointCorruptError) rather than the prior
        # manifest pointing at a mix of old and half-overwritten parts.
        try:
            os.remove(os.path.join(path, _MANIFEST))
        except FileNotFoundError:
            pass
        self.path = path
        self.total = 0
        self.parts = 0

    def write_shard(self, records: List[Tuple[VariantKey, Variant]]) -> None:
        part_path = os.path.join(self.path, f"part-{self.parts:05d}.jsonl.gz")
        with gzip.open(part_path, "wt") as f:
            # Fixed-size coalescing buffer: one write() per ~_WRITE_BUFFER_
            # BYTES of encoded text instead of one per record. The artifact
            # is byte-identical to per-record writes (gzip's compressor
            # only emits at its own block boundaries and at close; the
            # round-trip regression test asserts this), but the host never
            # holds more than one buffer of encoded lines beyond the
            # records the caller already owns.
            buffer: List[str] = []
            buffered = 0
            for key, variant in records:
                entry = {
                    "key": {"contig": key.contig, "position": key.position},
                    "variant": variant.to_json(),
                }
                line = json.dumps(entry) + "\n"
                buffer.append(line)
                buffered += len(line)
                self.total += 1
                if buffered >= _WRITE_BUFFER_BYTES:
                    f.write("".join(buffer))
                    buffer.clear()
                    buffered = 0
            if buffer:
                f.write("".join(buffer))
        self.parts += 1

    def close(self) -> None:
        # Drop stale parts from a previous, larger materialization before
        # publishing: the reader's parts-count cross-check would otherwise
        # reject this completed write forever ("3 declared but 5 on
        # disk"). A crash in here leaves extra-or-missing parts against
        # whichever manifest exists — still a loud load failure.
        written = {f"part-{i:05d}.jsonl.gz" for i in range(self.parts)}
        for name in os.listdir(self.path):
            if name.startswith("part-") and name not in written:
                os.remove(os.path.join(self.path, name))
        # Atomic publish (the obs/manifest.py pattern): a crash mid-write
        # leaves only the per-pid tmp, never a truncated _manifest.json a
        # later load would half-parse.
        manifest_path = os.path.join(self.path, _MANIFEST)
        tmp = f"{manifest_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "parts": self.parts,
                    "records": self.total,
                    "format": "jsonl.gz/v1",
                },
                f,
            )
        os.replace(tmp, manifest_path)


def save_variants(
    path: str,
    shards: Iterable[List[Tuple[VariantKey, Variant]]],
) -> int:
    """Write one part file per shard (consumed lazily); returns the record
    count. The driver's streaming save (``--save-variants``) uses
    :class:`CheckpointWriter` directly to interleave writing with the
    analysis pass."""
    writer = CheckpointWriter(path)
    for records in shards:
        writer.write_shard(records)
    writer.close()
    return writer.total


class CheckpointDataset:
    """Reader with the ``VariantsDataset`` iteration surface.

    Trust-but-verify on open AND on iteration: the manifest must parse and
    carry its required fields, the part files on disk must match the
    manifest's ``parts`` count, and a full iteration (:meth:`__iter__`)
    re-counts raw records against ``records`` — a part truncated after the
    manifest was written fails the resumed run loudly at the point the
    truncation is provable, instead of silently analyzing fewer variants.
    """

    def __init__(self, path: str):
        self.path = path
        manifest_path = os.path.join(path, _MANIFEST)
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"{path}: no {_MANIFEST} — the checkpoint write never "
                "completed (the manifest is written last, atomically); "
                "re-materialize with --save-variants"
            ) from None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"{path}/{_MANIFEST} is truncated or unparseable ({e}); "
                "the checkpoint cannot be trusted — re-materialize it"
            ) from e
        if (
            not isinstance(manifest, dict)
            or not isinstance(manifest.get("parts"), int)
            or not isinstance(manifest.get("records"), int)
        ):
            raise CheckpointCorruptError(
                f"{path}/{_MANIFEST} is missing required integer fields "
                "parts/records; the checkpoint cannot be trusted"
            )
        self.manifest = manifest
        on_disk = len(self.partitions())
        if on_disk != manifest["parts"]:
            raise CheckpointCorruptError(
                f"{path}: manifest declares {manifest['parts']} part "
                f"file(s) but {on_disk} are on disk — a deleted or foreign "
                "part would silently resume a truncated/polluted cohort"
            )

    def partitions(self) -> List[str]:
        return [
            os.path.join(self.path, name)
            for name in sorted(os.listdir(self.path))
            if name.startswith("part-") and not name.endswith(".tmp")
        ]

    def _iter_part_entries(self, part_path: str) -> Iterator[Dict]:
        """Raw manifest-counted entries of one part (pre-build): the unit
        the writer's ``records`` total counts, so the full-iteration
        cross-check compares like with like."""
        try:
            yield from _iter_jsonl_lines(part_path)
        except (EOFError, OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"{part_path} is truncated or unparseable ({e}); the "
                "checkpoint cannot be trusted — re-materialize it"
            ) from e

    @staticmethod
    def _build_pairs(entries: Iterator[Dict]) -> Iterator[Tuple[VariantKey, Variant]]:
        """The ONE spelling of entry → ``(key, variant)`` (build, skip
        unbuildable, reconstruct the partition key) — shared by the
        per-part reader and the counted whole-checkpoint iteration."""
        for entry in entries:
            built = VariantsBuilder.build(entry["variant"])
            if built is None:
                continue
            yield (
                VariantKey(
                    entry["key"]["contig"], int(entry["key"]["position"])
                ),
                built[1],
            )

    def iter_part(self, part_path: str) -> Iterator[Tuple[VariantKey, Variant]]:
        """Stream one part's ``(key, variant)`` pairs through the bounded
        read window — the resume path that never stages a whole part."""
        yield from self._build_pairs(self._iter_part_entries(part_path))

    def compute(self, part_path: str) -> Iterator[Tuple[VariantKey, Variant]]:
        """One part's ``(key, variant)`` pairs — the ``VariantsDataset``
        consumption surface, STREAMED through :meth:`iter_part`'s bounded
        read window: callers iterate, so no part is staged whole."""
        return self.iter_part(part_path)

    def __iter__(self) -> Iterator[Tuple[VariantKey, Variant]]:
        seen = 0

        def counted(part: str) -> Iterator[Dict]:
            nonlocal seen
            for entry in self._iter_part_entries(part):
                seen += 1
                yield entry

        for part in self.partitions():
            yield from self._build_pairs(counted(part))
        if seen != self.manifest["records"]:
            raise CheckpointCorruptError(
                f"{self.path}: manifest declares {self.manifest['records']} "
                f"record(s) but a full iteration found {seen} — a part was "
                "truncated or padded after the manifest was written"
            )

    def variants(self) -> Iterator[Variant]:
        for _, variant in self:
            yield variant


def load_variants(path: str) -> CheckpointDataset:
    return CheckpointDataset(path)


# ---------------------------------------------------------------------------
# Gramian checkpoints: the analysis-pass resume artifact.
# ---------------------------------------------------------------------------

GRAMIAN_CKPT = "gramian.ckpt.npz"
GRAMIAN_CKPT_VERSION = 1

#: Default ``--checkpoint-every-sites`` when a checkpoint directory is
#: given without an interval: ~18 snapshots across a whole genome
#: (~28.9 M candidate sites), each costing one accumulator sync + one
#: O(N²) host fetch + write — noise against the ingest it protects.
DEFAULT_CHECKPOINT_EVERY_SITES = 1_600_000

#: Meta fields every complete artifact carries (version-1 contract).
_META_REQUIRED = (
    "version",
    "fingerprint",
    "sites",
    "strategy",
    "accum_dtype",
    "entry_bound",
    "rows_seen",
    "flushes",
    "num_samples",
)

def gramian_checkpoint_fingerprint(conf) -> str:
    """The conf digest a Gramian checkpoint is keyed by:
    ``utils/cache.py:compile_fingerprint`` over every field that shapes the
    analysis (placement, telemetry and the checkpoint/fault flags
    themselves excluded, so the saving and the resuming run digest alike),
    in the reference's field set and backend name — equal to the
    reference's digest of the same argv."""
    return compile_fingerprint(conf, kind="gramian-checkpoint")


def save_gramian_checkpoint(
    directory: str, state: Dict, fingerprint: str, sites: int
) -> str:
    """Atomically publish one accumulator snapshot as
    ``<directory>/gramian.ckpt.npz`` (single file: tmp write + fsync +
    rename, so a crash at any instant leaves the PREVIOUS complete snapshot
    — or none — never a torn one). ``state`` is
    ``GramianAccumulator.snapshot_state()``'s dict; ``sites`` is the
    ingest cursor (rows of the deterministic stream consumed so far)."""
    os.makedirs(directory, exist_ok=True)
    meta = {
        "version": GRAMIAN_CKPT_VERSION,
        "fingerprint": str(fingerprint),
        "sites": int(sites),
        "strategy": state["strategy"],
        "accum_dtype": state["accum_dtype"],
        "exact_int": bool(state["exact_int"]),
        "entry_bound": int(state["entry_bound"]),
        "rows_seen": int(state["rows_seen"]),
        "flushes": int(state["flushes"]),
        "num_samples": int(state["num_samples"]),
        "data_parallel": int(state.get("data_parallel", 1)),
        "padded": int(state.get("padded", state["num_samples"])),
        "ring_bytes_total": int(state.get("ring_bytes_total", 0)),
    }
    final = os.path.join(directory, GRAMIAN_CKPT)
    # Sweep orphaned tmps of earlier killed writes: each is a full O(N²)
    # snapshot and every resume runs under a fresh pid. One writer per
    # directory (the driver), so nothing live matches the pattern here.
    for name in os.listdir(directory):
        if name.startswith(f"{GRAMIAN_CKPT}.") and name.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
    tmp = f"{final}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, G=state["G"], meta=np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ))
        f.flush()
        os.fsync(f.fileno())
    faults.kill_point("checkpoint.mid-write")
    os.replace(tmp, final)
    faults.kill_point("checkpoint.post-save")
    return final


def load_gramian_checkpoint(
    directory: str, fingerprint: Optional[str] = None
) -> Optional[Dict]:
    """The last COMPLETE snapshot of a checkpoint directory as ``{"meta":
    dict, "G": ndarray}``, or ``None`` when no complete artifact exists yet
    (a run killed before or during its first save resumes from zero;
    leftover ``.tmp`` files are ignored by construction). Raises
    :class:`CheckpointCorruptError` on an unreadable artifact and
    :class:`CheckpointMismatchError` when ``fingerprint`` is given and
    disagrees."""
    path = os.path.join(directory, GRAMIAN_CKPT)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as archive:
            meta = json.loads(bytes(archive["meta"]).decode("utf-8"))
            G = np.array(archive["G"])
    except (
        OSError,
        ValueError,
        KeyError,
        json.JSONDecodeError,
        # A valid zip magic with a corrupt tail surfaces as BadZipFile or
        # zlib.error, not ValueError — the same diagnosis.
        zipfile.BadZipFile,
        zlib.error,
    ) as e:
        raise CheckpointCorruptError(
            f"{path} is not a readable Gramian checkpoint ({e}); delete "
            "the directory to restart from zero"
        ) from e
    missing = [k for k in _META_REQUIRED if k not in meta]
    if missing or meta.get("version") != GRAMIAN_CKPT_VERSION:
        raise CheckpointCorruptError(
            f"{path}: incomplete or wrong-version checkpoint meta "
            f"(version={meta.get('version')!r}, missing={missing})"
        )
    if fingerprint is not None and meta["fingerprint"] != fingerprint:
        raise CheckpointMismatchError(
            f"{path} was written by a run with conf fingerprint "
            f"{meta['fingerprint']} but this run fingerprints as "
            f"{fingerprint}: the flags that shape the analysis (cohort, "
            "references, block size, mesh, strategy, dtype ladder, ingest "
            "path) differ — resuming would merge two different analyses. "
            "Re-run with the original flags, or point --resume-from at a "
            "matching checkpoint"
        )
    return {"meta": meta, "G": G}


class GramianFeeder:
    """Row-block conduit between an ingest stream and a live accumulator,
    adding crash-consistent periodic snapshots and resume fast-forward.

    Exposes ``add_rows`` (the accumulator surface the driver and
    ``ops/gramian.py:accumulate_index_rows`` feed), so it drops into the
    packed, streamed and wire arms unchanged:

    - **resume**: constructed with a loaded checkpoint, it restores the
      accumulator once and then SKIPS the first ``meta["sites"]`` rows of
      the (deterministic, contig-ordered) stream — splitting a block when
      the cursor lands inside one — before feeding resumes;
    - **checkpointing**: every ``every_sites`` accumulated rows it
      snapshots the accumulator (:meth:`snapshot_state` flushes the staged
      tail and drains the card's in-flight updates), fetches the partial
      Gramian and publishes the atomic artifact; :meth:`finish` writes a
      final snapshot so a crash between ingest end and finalize resumes at
      O(1) re-ingest.

    Different flush boundaries between the original and resumed runs are
    harmless: every accumulator entry is an exact integer at every point,
    so the merged Gramian is byte-identical however rows were grouped.
    ``snapshot_seconds`` and ``write_seconds`` add up the time of the
    saves' two halves (flush, drain and fetch; npz write, fsync and
    publish).
    """

    def __init__(
        self,
        acc,
        directory: Optional[str] = None,
        every_sites: Optional[int] = None,
        fingerprint: str = "",
        resume: Optional[Dict] = None,
        registry=None,
    ):
        self.acc = acc
        self.directory = directory
        self.every_sites = (
            int(every_sites)
            if every_sites is not None
            else DEFAULT_CHECKPOINT_EVERY_SITES
        )
        if self.every_sites < 1:
            raise ValueError(
                f"checkpoint cadence must be >= 1 site, got "
                f"{self.every_sites}"
            )
        self.fingerprint = fingerprint
        self.checkpoint_sites = 0
        self.sites_skipped = 0
        self.saves = 0
        self.snapshot_seconds = 0.0
        self.write_seconds = 0.0
        self._skip_remaining = 0
        self._saves_counter = self._sites_gauge = None
        if resume is not None:
            acc.restore_state(resume)
            self.checkpoint_sites = int(resume["meta"]["sites"])
            self._skip_remaining = self.checkpoint_sites
        self.sites_done = self.checkpoint_sites
        self._last_saved = self.checkpoint_sites
        if registry is not None and directory is not None:
            from spark_examples_tpu_torch.obs.metrics import (
                GRAMIAN_CHECKPOINT_SAVES,
                GRAMIAN_CHECKPOINT_SITES,
                well_known_counter,
                well_known_gauge,
            )

            self._saves_counter = well_known_counter(registry, GRAMIAN_CHECKPOINT_SAVES)
            self._sites_gauge = well_known_gauge(registry, GRAMIAN_CHECKPOINT_SITES)
            self._sites_gauge.set(float(self._last_saved))

    def add_rows(self, rows) -> None:
        n = len(rows)
        if self._skip_remaining > 0:
            if n <= self._skip_remaining:
                self._skip_remaining -= n
                self.sites_skipped += n
                return
            rows = rows[self._skip_remaining :]
            self.sites_skipped += self._skip_remaining
            self._skip_remaining = 0
            n = len(rows)
        self.acc.add_rows(rows)
        self.sites_done += n
        if (
            self.directory is not None
            and self.sites_done - self._last_saved >= self.every_sites
        ):
            self.save()

    def save(self) -> None:
        """Snapshot + atomic publish at the current cursor."""
        t0 = time.perf_counter()
        state = self.acc.snapshot_state()
        t1 = time.perf_counter()
        faults.kill_point("driver.post-flush")
        save_gramian_checkpoint(self.directory, state, self.fingerprint, self.sites_done)
        self.snapshot_seconds += t1 - t0
        self.write_seconds += time.perf_counter() - t1
        self._last_saved = self.sites_done
        self.saves += 1
        if self._saves_counter is not None:
            self._saves_counter.inc(1)
            self._sites_gauge.set(float(self._last_saved))

    def finish(self) -> None:
        """End of ingest: write the final snapshot (when checkpointing and
        anything accumulated since the last save).

        Fails loudly if the fast-forward never completed: the fingerprint
        covers conf flags and input paths, not file contents, so an input
        that SHRANK since the checkpoint is only detectable here —
        finalizing anyway would emit a silently wrong analysis built from
        the stale partial."""
        if self._skip_remaining > 0:
            raise CheckpointMismatchError(
                f"resume cursor lies past the end of the input stream: the "
                f"checkpoint was written at {self.checkpoint_sites} sites "
                f"but the stream ended after {self.sites_skipped} — the "
                "input shrank since the checkpoint was saved. Re-run "
                "without --resume-from (or against the original input)"
            )
        if self.directory is not None and self.sites_done > self._last_saved:
            self.save()


__all__ = [
    "CheckpointCorruptError",
    "CheckpointDataset",
    "CheckpointMismatchError",
    "CheckpointWriter",
    "DEFAULT_CHECKPOINT_EVERY_SITES",
    "GRAMIAN_CKPT",
    "GramianFeeder",
    "gramian_checkpoint_fingerprint",
    "load_gramian_checkpoint",
    "load_variants",
    "save_gramian_checkpoint",
    "save_variants",
]
