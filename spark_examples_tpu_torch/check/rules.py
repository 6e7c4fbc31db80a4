"""The graftcheck rule catalogue, as far as the port's checkers report.

The port's copy of ``spark_examples_tpu/check/rules.py`` for the three
ported source and protocol checkers: the host-memory audit
(``check/hostmem.py``, GH rules), the lock-order analysis
(``check/lockgraph.py``, GL rules) and the replica protocol's model
checker (``check/proto.py``, GP rules), with the shared :class:`Finding`
and the escape-hatch grammar. Ids, names and finding text are the
reference's, so both packages report the same findings on the same
source. The ``lint`` rules (GC) are JAX pitfalls; the port's torch rules
come with ``graftcheck lint`` (ROADMAP.md §1). The ``ir``, ``ranges`` and
``sched`` catalogues come with those checkers.

Every GH and GL rule honors the escape hatch::

    something_flagged()  # graftcheck: disable=GL002  -- justification

on the finding's line, or ``# graftcheck: disable-file=GL002`` anywhere in
the file (comma-separate multiple ids; ``disable=all`` silences the line).
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Rule:
    """One rule: identity, scope, and the one-line rationale."""

    id: str
    name: str
    summary: str
    #: Package-relative path globs the rule applies to; empty = everywhere.
    scope: Tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        if not self.scope:
            return True
        return any(fnmatch.fnmatch(relpath, g) for g in self.scope)


#: ``graftcheck hostmem`` scope: the host-staging layers whose ingest and
#: consume paths must be provably bounded-window — the ingest stack, the
#: resident service's control plane (a daemon that buffered request bodies
#: or backlogs unboundedly would run out of memory like an O(file) ingest)
#: and the analyses' per-site output layer.
HOSTMEM_GLOBS = ("sources/*", "pipeline/*", "ops/*", "serve/*", "analyses/*")

#: ``graftcheck hostmem`` rule catalogue (``check/hostmem.py``): an AST
#: dataflow audit classifying every host ingest/consume path as
#: bounded-window or O(file). The audit is a totality proof: the
#: ``hostmem(unbounded)`` escape hatch::
#:
#:     raw = f.read()  # graftcheck: hostmem(unbounded) -- why this path is O(file)
#:
#: is itself a finding (GH006). A justified hatch still routes its
#: underlying GH00x finding into the report's ``declared_unbounded``
#: inventory (so the report says what the hatch hides), but the hatch line
#: fails the audit regardless.
HOSTMEM_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GH001",
            "whole-file-read",
            "A no-size .read()/.readlines() on a file handle stages the "
            "entire file in host RAM at once; read a bounded window in a "
            "loop, or declare the site hostmem(unbounded) with its "
            "justification.",
            scope=HOSTMEM_GLOBS,
        ),
        Rule(
            "GH002",
            "unbounded-stream-accumulation",
            "A list/buffer accumulates file- or stream-derived items "
            "inside the read loop, so peak host memory grows with the "
            "input instead of the window; consume per window, or declare "
            "the site hostmem(unbounded).",
            scope=HOSTMEM_GLOBS,
        ),
        Rule(
            "GH003",
            "stream-materialization",
            "list()/tuple() over a file handle or a streaming block "
            "producer materializes the whole stream the producer exists "
            "to keep windowed; iterate it, or declare the site "
            "hostmem(unbounded).",
            scope=HOSTMEM_GLOBS,
        ),
        Rule(
            "GH004",
            "whole-buffer-decompress",
            "A one-shot decompress (gzip/zlib/bz2/lzma .decompress) holds "
            "compressed AND decompressed copies of the payload at once; "
            "stream through the module's file interface (e.g. gzip.open "
            "windowed reads), or declare the site hostmem(unbounded).",
            scope=HOSTMEM_GLOBS,
        ),
        Rule(
            "GH005",
            "whole-buffer-numpy-staging",
            "np.frombuffer/np.packbits/np.concatenate/np.stack over a "
            "whole-file buffer (or a stream-accumulated list) stages an "
            "O(file) array on host; stage per chunk/block, or declare the "
            "site hostmem(unbounded).",
            scope=HOSTMEM_GLOBS,
        ),
        Rule(
            "GH006",
            "declared-unbounded-forbidden",
            "A `# graftcheck: hostmem(unbounded)` escape hatch — the "
            "tree proves boundedness through the windowed stream "
            "abstraction (sources/stream.py), and a hatch (justified or "
            "not) is a finding, not a declaration. Refactor the site "
            "through iter_byte_windows/iter_text_lines/SpooledRecordTable/"
            "ChunkedArrayBuilder instead.",
            scope=HOSTMEM_GLOBS,
        ),
    ]
}


#: ``graftcheck lockgraph`` rule catalogue (``check/lockgraph.py``): static
#: lock-acquisition-order analysis of the threaded ingest, telemetry and
#: serve layers. GL findings anchor to real source lines, so the standard
#: ``# graftcheck: disable=GLnnn -- why`` escape hatch applies.
LOCK_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GL001",
            "lock-order-cycle",
            "The static lock-acquisition graph contains a cycle: two "
            "threads taking the member locks in opposite orders deadlock. "
            "Break the cycle or document a single global order.",
        ),
        Rule(
            "GL002",
            "device-sync-under-lock",
            "A lock is held across a device sync (torch.cuda.synchronize, "
            "a stream's or event's synchronize, block_until_ready): every "
            "thread needing the lock stalls behind a device round-trip. "
            "Sync first, then take the lock.",
        ),
        Rule(
            "GL003",
            "blocking-queue-op-under-lock",
            "A lock is held across a blocking queue put/get: if the "
            "consumer that would drain the queue needs the same lock, the "
            "backpressure becomes a deadlock. Move the queue op outside "
            "the critical section (or use the _nowait form).",
        ),
        Rule(
            "GL004",
            "self-reacquire",
            "A non-reentrant threading.Lock is (possibly) acquired while "
            "already held on the same call path — an immediate "
            "self-deadlock. Use RLock only if the recursion is "
            "intentional; otherwise split the critical section.",
        ),
    ]
}


#: ``graftcheck proto`` rule catalogue (``check/proto.py``): invariants of
#: the replica coordination protocol, checked by exhaustive explicit-state
#: exploration with the shipped ``serve/journal.py`` fold and lease
#: arbitration as the transition oracle. GP findings anchor to a witness
#: trace, not a source line, so their ``path`` is the protocol model's name
#: and ``line`` is 0. A GP finding has no escape hatch: a protocol
#: counterexample is fixed, not justified.
PROTO_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GP001",
            "double-effective-terminal",
            "One job reaches two terminal records that BOTH survive the "
            "fold's epoch fencing (or two replicas both publish its "
            "result): the journal's truth about the job's outcome is "
            "ambiguous — a deposed replica's late write settled a job "
            "its stealer also settled.",
        ),
        Rule(
            "GP002",
            "device-began-reexecution",
            "A job whose `began` record is journaled executes device "
            "work a second time in a later replica life: the "
            "requeue-once boundary is violated — device state under a "
            "crashed update cannot be trusted for a silent retry.",
        ),
        Rule(
            "GP003",
            "acked-job-lost",
            "A job whose admission was acknowledged (202 sent after the "
            "durable accepted record) becomes invisible: no journal "
            "record folds it as pending, no effective terminal exists, "
            "and no replica holds it in memory — after every crash is "
            "recovered, nobody will ever settle it.",
        ),
        Rule(
            "GP004",
            "lease-epoch-reissued",
            "A journaled lease record re-issues the job's highest "
            "already-journaled lease epoch under a DIFFERENT replica "
            "(the min-epoch claim guard failed): fold fencing cannot "
            "order same-epoch writers, so a zombie terminal would "
            "survive fencing. A lower-than-max straggler append is "
            "benign — the max-fold absorbs it.",
        ),
        Rule(
            "GP005",
            "steal-of-live-owner",
            "A replica successfully link-claims a fencing epoch over a "
            "lease that is still live — or expired but within the grace "
            "window — while its owner is alive: the grace asymmetry "
            "(owners abandon at expiry, stealers wait past expiry+grace) "
            "is violated and owner and stealer can run concurrently.",
        ),
        Rule(
            "GP006",
            "uncovered-crash-transition",
            "The model reaches a crash transition in a protocol window "
            "that no registered utils/faults.py KILL_POINT covers: the "
            "chaos matrix cannot rehearse this crash, so its recovery "
            "story is proven only in the model, never on the real "
            "daemon. Register a kill-point for the window (and enroll "
            "it in the chaos matrix) in the same change.",
        ),
    ]
}


#: Every rule id the port's checkers can emit, for Finding.rule lookup.
ALL_RULES: Dict[str, Rule] = {**LOCK_RULES, **HOSTMEM_RULES, **PROTO_RULES}


@dataclass
class Finding:
    """One finding, JSON-serializable for the machine report."""

    rule_id: str
    path: str
    line: int
    col: int
    detail: str

    @property
    def rule(self) -> Rule:
        return ALL_RULES[self.rule_id]

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule_id} "
            f"[{self.rule.name}] {self.detail}"
        )

    def to_json(self) -> Dict:
        return {
            "rule": self.rule_id,
            "name": self.rule.name,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "detail": self.detail,
        }


def parse_disables(
    source: str,
) -> Tuple[Dict[int, set], set]:
    """Extract the escape hatches from source text.

    Returns ``(per_line, whole_file)``: ``per_line`` maps 1-based line
    numbers to the set of rule ids disabled on that line (``{"all"}``
    disables every rule), ``whole_file`` is the set disabled for the file.
    Comment grammar::

        # graftcheck: disable=GL002,GL003  -- optional justification
        # graftcheck: disable-file=GL002   -- optional justification
    """
    per_line: Dict[int, set] = {}
    whole_file: set = set()
    for lineno, line in enumerate(source.splitlines(), start=1):
        marker = "# graftcheck:"
        at = line.find(marker)
        if at < 0:
            continue
        directive = line[at + len(marker) :].strip()
        for key, sink in (("disable-file=", whole_file), ("disable=", None)):
            if directive.startswith(key):
                ids = directive[len(key) :].split("--")[0]
                parsed = {
                    token.strip()
                    for token in ids.split(",")
                    if token.strip()
                }
                if sink is None:
                    per_line.setdefault(lineno, set()).update(parsed)
                else:
                    sink.update(parsed)
                break
    return per_line, whole_file


def apply_disables(
    findings: Sequence[Finding],
    per_line: Dict[int, set],
    whole_file: set,
) -> List[Finding]:
    """Drop findings silenced by an escape hatch."""

    def silenced(f: Finding) -> bool:
        if "all" in whole_file or f.rule_id in whole_file:
            return True
        ids = per_line.get(f.line, ())
        return "all" in ids or f.rule_id in ids

    return [f for f in findings if not silenced(f)]


__all__ = [
    "Rule",
    "Finding",
    "LOCK_RULES",
    "HOSTMEM_RULES",
    "PROTO_RULES",
    "ALL_RULES",
    "HOSTMEM_GLOBS",
    "parse_disables",
    "apply_disables",
]
