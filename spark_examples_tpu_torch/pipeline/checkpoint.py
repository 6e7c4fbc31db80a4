"""Variant checkpoints: ``--save-variants`` and ``--input-path``.

The port's copy of the variant half of ``spark_examples_tpu/pipeline/
checkpoint.py``. The reference resumed from pre-materialized variants
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
of silently resuming a polluted cohort. Gramian checkpoints (the other
half of the reference's module) are not ported yet.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, Iterable, Iterator, List, Tuple

from spark_examples_tpu_torch.models.variant import Variant, VariantKey, VariantsBuilder
from spark_examples_tpu_torch.sources.stream import iter_byte_windows

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


__all__ = [
    "CheckpointCorruptError",
    "CheckpointDataset",
    "CheckpointWriter",
    "load_variants",
    "save_variants",
]
