"""Bounded per-site output writer — the M-sized spill path of ``analyses/``.

The port's copy of ``spark_examples_tpu/pipeline/sitewriter.py``. The PCA
pipeline's outputs are O(N) (PC rows); the population-genetics analyses
emit one row per site or per sample pair block, so the rows stream
straight into a buffered file instead of an in-memory list:

- rows are appended window by window (:meth:`SiteOutputWriter.write_rows`),
  formatted and written into a buffered handle — peak host memory is
  O(window), never O(M);
- the output is published atomically: rows land in ``<path>.<pid>.tmp``
  and one ``os.replace`` at :meth:`SiteOutputWriter.close` makes the
  finished file appear — a killed run leaves a ``.tmp`` orphan, never a
  truncated file that looks complete (the contract of
  ``obs/manifest.py:write_manifest``).

Column layout is the caller's: a header tuple once (or ``None`` for no
header line) and pre-formatted row tuples after.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence, Tuple


class SiteOutputWriter:
    """One streaming TSV output file with atomic publish.

    Usage::

        writer = SiteOutputWriter(path, header=("contig", "pos", "kept"))
        for window in ...:
            writer.write_rows((c, p, int(k)) for c, p, k in window_rows)
        writer.close()   # atomic rename; the file now exists
    """

    def __init__(self, path: str, header: Optional[Sequence[str]] = None):
        self.path = str(path)
        self.rows_written = 0
        self._closed = False
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        self._tmp = f"{self.path}.{os.getpid()}.tmp"
        self._f = open(self._tmp, "w", encoding="utf-8")
        if header is not None:
            self._f.write("\t".join(str(h) for h in header) + "\n")

    def write_rows(self, rows: Iterable[Tuple]) -> int:
        """Append one window's rows (any iterable of field tuples); returns
        the row count written. Rows stream straight through the buffered
        handle — nothing is retained."""
        if self._closed:
            raise ValueError(f"writer for {self.path} is closed")
        n = 0
        for row in rows:
            self._f.write("\t".join(str(field) for field in row) + "\n")
            n += 1
        self.rows_written += n
        return n

    def close(self) -> None:
        """Flush and atomically publish the finished file (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._f.close()
        os.replace(self._tmp, self.path)

    def abort(self) -> None:
        """Discard the temp file without publishing (error paths): the
        output either exists complete or not at all."""
        if self._closed:
            return
        self._closed = True
        self._f.close()
        try:
            os.remove(self._tmp)
        except OSError:
            pass

    def __enter__(self) -> "SiteOutputWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


__all__ = ["SiteOutputWriter"]
