"""The graftcheck rule catalogue, as far as the port's checkers report.

The port's copy of ``spark_examples_tpu/check/rules.py`` for its five
ported checkers: the source linter (``check/linter.py``, GC rules), the
IR auditor (``check/ir.py``, GI rules), the host-memory audit
(``check/hostmem.py``, GH rules), the lock-order analysis
(``check/lockgraph.py``, GL rules) and the replica protocol's model
checker (``check/proto.py``, GP rules), with the shared :class:`Finding`
and the escape-hatch grammar. Ids, names and scopes are the reference's.
The GC rules name JAX pitfalls there; here each reads the same pitfall in
torch's idiom (a ``torch.compile``d or
``torch.jit.script``ed function where the reference has a jitted one, a
tensor where it has a ``jnp`` value) and its summary says so; the GI
rules read the reference's jaxpr contracts over the port's recorded
schedule. The ``ranges`` and ``sched`` catalogues come with those
checkers.

Every GC, GH and GL rule honors the escape hatch::

    something_flagged()  # graftcheck: disable=GC001  -- justification

on the finding's line, or ``# graftcheck: disable-file=GC001`` anywhere in
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


#: Directories (package-relative glob prefixes) that are "hot path" for
#: device-sync rules: per-block work that runs once per genotype block or
#: per shard, where one stray sync serializes the pipeline. The analyses'
#: per-window/per-block device fetches are deliberate (host-sequential
#: prune/chi-square) and carry justified GC001 disables.
HOT_PATH_GLOBS = ("ops/*", "pipeline/*", "analyses/*")

#: Ingest-concurrency scope: modules where threads share parse state, so
#: bare lock creation must carry the documented lock-ordering idiom
#: (a ``# lock order:`` comment on or just above the creation line).
INGEST_GLOBS = (
    "sources/*",
    "pipeline/datasets.py",
    "utils/native.py",
    "serve/*",
    "analyses/*",
)

#: Telemetry scope: pipeline code whose counters must flow through the
#: metrics registry (``obs/metrics.py``) via the owning object's methods —
#: a bare ``stats.x += n`` bypasses both the lock and the manifest.
TELEMETRY_GLOBS = ("ops/*", "pipeline/*", "sources/*", "serve/*", "analyses/*")


#: ``graftcheck lint`` rule catalogue (``check/linter.py``): the
#: reference's GC rules, each read in torch's idiom. A "compiled function"
#: is one decorated with ``torch.compile`` or ``torch.jit.script``/
#: ``trace`` — the reference's ``jax.jit``/``shard_map`` bodies; a "tensor
#: value" is an expression rooted at ``torch`` — the reference's ``jnp``
#: value.
RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GC000",
            "unparseable-file",
            "The file does not parse as Python; the linter cannot vouch "
            "for it (and neither can the interpreter).",
        ),
        Rule(
            "GC001",
            "host-sync-in-hot-path",
            "Implicit device→host sync (.item()/.tolist()/.cpu()/.numpy(), "
            "or float()/int()/np.asarray on a tensor value) inside per-block "
            "hot-path code stalls the launch queue once per call.",
            scope=HOT_PATH_GLOBS,
        ),
        Rule(
            "GC002",
            "python-branch-on-traced",
            "Python if/while on a tensor inside a torch.compile'd (or "
            "torch.jit.script'ed) function breaks the graph and syncs the "
            "device to read the value (or specializes on it); use "
            "torch.where/torch.cond, or pass the value as a Python scalar.",
        ),
        Rule(
            "GC003",
            "jit-in-loop",
            "torch.compile (or torch.jit.script/trace) constructed inside a "
            "loop builds a fresh compiled callable per iteration — a "
            "recompilation storm; hoist the compile out of the loop.",
        ),
        Rule(
            "GC004",
            "jnp-at-import-time",
            "torch.* executed at module import time builds tensors (and, on "
            "a device, initializes CUDA, which breaks a later fork) as a "
            "side effect of `import`; move it into a function or use numpy "
            "for module constants.",
        ),
        Rule(
            "GC005",
            "accumulator-update-without-donation",
            "An accumulator update that builds its result out of place "
            "(`return G + X`) holds two live copies of the accumulator per "
            "step; update it in place (G.add_(X), G += X, out=G) or "
            "document why not (e.g. measured pipelining win).",
            scope=("ops/*",),
        ),
        Rule(
            "GC006",
            "undocumented-lock-in-ingest",
            "A bare threading lock in ingest code without the documented "
            "lock-ordering idiom (`# lock order:` comment) — the "
            "GIL-released parse pool makes ordering violations real "
            "deadlocks, not theoretical ones.",
            scope=INGEST_GLOBS,
        ),
        Rule(
            "GC007",
            "sync-inside-loop",
            "torch.cuda.synchronize() (or an event's or stream's "
            ".synchronize()) inside a loop syncs every iteration, "
            "serializing launches against compute; sync once after the "
            "loop, or bound the in-flight window instead.",
            scope=HOT_PATH_GLOBS,
        ),
        Rule(
            "GC008",
            "print-under-jit",
            "print() inside a torch.compile'd function breaks the graph "
            "(and under torch.jit.script runs with the scripted values, not "
            "the eager ones); print outside the compiled function.",
        ),
        Rule(
            "GC009",
            "ad-hoc-stats-mutation",
            "Direct augmented assignment on a stats/counters object "
            "(`io_stats.requests += n`, `self.counters.x += 1`) bypasses "
            "the owner's accounting methods — and with them the lock and "
            "the metrics registry, so the mutation races concurrent "
            "workers and never reaches the run manifest; route it through "
            "an add_*() method.",
            scope=TELEMETRY_GLOBS,
        ),
        Rule(
            "GC011",
            "unjustified-narrowing-cast",
            "A narrowing .to()/.type()/astype (int8/uint8/int16/uint16/"
            "int32/uint32/float16/bfloat16/float32 target) in ops/ without "
            "a range-justifying `# range:` comment or contract reference — "
            "the Gramian dtype ladder's exactness rests on every narrowing "
            "cast's operand range being an explicit, checkable claim "
            "(ops/contracts.py), not an unstated assumption.",
            scope=("ops/*",),
        ),
        Rule(
            "GC012",
            "raw-file-iteration-outside-stream",
            "A read-mode file handle (open/gzip.open/bz2.open/lzma.open) "
            "is iterated or .read*()-consumed directly in ingest/pipeline "
            "code instead of through the one windowed stream abstraction "
            "(sources/stream.py: iter_byte_windows/iter_text_lines/"
            "open_binary) — a raw handle is exactly where O(file) staging "
            "regrows; route the read through sources/stream.py so the "
            "hostmem totality proof keeps covering it.",
            scope=("sources/*", "pipeline/*"),
        ),
        Rule(
            "GC013",
            "journal-record-outside-journal",
            "A journal protocol record (a dict literal with an `event` "
            "key naming accepted/began/terminal/lease) is constructed — "
            "or a journal appender's `_append` is called — outside "
            "serve/journal.py. The record constructors there are the "
            "protocol's ONLY writers: `graftcheck proto` proves the "
            "coordination protocol against exactly those shapes, so a "
            "hand-rolled record elsewhere is a write the proof does not "
            "cover. Route it through journal.accepted_record/"
            "began_record/terminal_record/lease_record (or the JobJournal "
            "methods).",
        ),
        Rule(
            "GC010",
            "host-numpy-under-jit",
            "A host `np.*` call inside a torch.compile'd (or "
            "torch.jit.script'ed) kernel breaks the graph (or fails to "
            "script) and runs on the host, or bakes a compile-time "
            "constant into the compiled program; use the torch equivalent "
            "(or hoist the host computation out of the kernel).",
            scope=("ops/*",),
        ),
    ]
}


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
#: ``graftcheck ir`` rule catalogue (``check/ir.py``): audits of the
#: RECORDED SCHEDULE of the Gramian updates (``obs/schedule.py``: the
#: kernels, transfers and stream waits the port's device program issues,
#: in order) — the reference's jaxpr contracts read over the port's
#: program, which has no jaxpr. GI findings anchor to a kernel audit name
#: (line 0); justification happens through the cross-checked GC005 AST
#: disables (GI002), not per-line escape hatches.
IR_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GI000",
            "kernel-trace-failure",
            "The update fails to run under the schedule recorder at the "
            "audit geometry; none of its contracts can be vouched for.",
        ),
        Rule(
            "GI001",
            "ring-overlap-broken",
            "A ring step's next shift is issued after that step's products "
            "(or sends a tile a product wrote), so the card's transfer "
            "stream waits for the tensor-core product instead of running "
            "under it — the overlap the double-buffered ring exists for "
            "silently vanishes.",
        ),
        Rule(
            "GI002",
            "accumulator-donation-contract",
            "An accumulator update is not in place (a product writes "
            "another buffer, or an accumulator-sized copy is made) and its "
            "function carries no justified GC005 AST disable — or carries "
            "a disable although the update is in place: the recorded "
            "schedule and the AST layer have drifted.",
        ),
        Rule(
            "GI003",
            "packed-wire-upcast",
            "A bit-packed uint8 wire tile changes dtype or width through a "
            "shift, or is read by anything but the designated unpack "
            "(unpack_rows_t), so the ring/PCIe wire silently loses its "
            "8-genotypes-per-byte format — 8x the traffic, or wrong math.",
        ),
        Rule(
            "GI004",
            "f64-in-kernel",
            "A float64 tensor appears in a Gramian update: some operand "
            "promoted through a silent dtype rule. f64 runs at a fraction "
            "of the card's int8/fp32 rate and doubles the bytes; every "
            "kernel dtype is an explicit int32/int8/uint8 contract.",
        ),
        Rule(
            "GI005",
            "ring-traffic-mismatch",
            "The bytes the recorded shifts move (summed over the receiving "
            "positions) disagree with the audited formula "
            "parallel/mesh.py:ring_traffic_bytes — the gramian_ring_bytes "
            "counter and the plan's numbers no longer describe the ring.",
        ),
        Rule(
            "GI006",
            "ring-permute-count",
            "A ring pass does not make exactly samples_axis - 1 shifts; an "
            "extra shift (the old return-to-owner step) wastes one full "
            "tile circulation per block, a missing one drops a position's "
            "columns.",
        ),
    ]
}

#: ``graftcheck ranges`` rule catalogue (``check/ranges.py``): the
#: reference's ids, names and text. The port proves them over the recorded
#: schedule (``obs/schedule.py``), where a product op stands for the
#: reference's ``dot_general`` and a cast between kernels for its
#: ``convert_element_type``; GR findings anchor to a kernel audit name
#: (line 0).
RANGES_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GR000",
            "kernel-range-trace-failure",
            "The kernel fails to trace to a jaxpr under the audit "
            "geometry; none of its range/exactness contracts can be "
            "vouched for.",
        ),
        Rule(
            "GR001",
            "int32-accumulator-overflow",
            "The int32 accumulator can overflow for the declared max "
            "geometry: declared rows x max_count² exceeds int32's 2^31-1 "
            "window, and the ladder has no wider in-accumulator rung — "
            "shrink the geometry contract or split the accumulation.",
        ),
        Rule(
            "GR002",
            "f32-partial-past-exact-window",
            "A per-dispatch f32 partial (a dot_general's output interval, "
            "derived from the declared input contracts) can exceed the "
            "2^24 exact-integer window BEFORE the accumulator conversion "
            "point ever sees it — the bf16/f32 path's exactness claim is "
            "false for this geometry.",
        ),
        Rule(
            "GR003",
            "lossy-narrowing-cast",
            "A convert_element_type whose inferred operand range is wider "
            "than the destination dtype's exact-integer window: integer "
            "values would round or wrap, silently corrupting the count "
            "semantics the dtype ladder promises to preserve.",
        ),
        Rule(
            "GR004",
            "uncontracted-dot-input",
            "A kernel input with no declared range contract "
            "(ops/contracts.py) reaches a dot_general: the prover has no "
            "interval to propagate, so no exactness claim about this "
            "kernel's partials or accumulator can be made at all.",
        ),
        Rule(
            "GR005",
            "conversion-trigger-not-conservative",
            "The runtime conversion trigger's projected per-flush "
            "increment (ops/contracts.py:flush_entry_increment, fed to "
            "_maybe_switch_accumulator) is SMALLER than the per-dispatch "
            "entry increment proven from the traced jaxpr — the f32→int32 "
            "conversion could fire after an entry already left the exact "
            "window.",
        ),
    ]
}


#: ``graftcheck sched`` rule catalogue (``check/sched.py``): schedule-level
#: audits of the collective reduction on a DECLARED topology
#: (``parallel/mesh.py:Topology`` — hosts x devices_per_host + per-link
#: rates, proven against before the fleet exists), with the reference's ids
#: and names. The schedule is the RECORDED one (``obs/schedule.py``: every
#: shift call with its hops' bytes and the link each hop rides, and whether
#: it is issued free of the products) of the runtime's own rings, simulated
#: per link class. GS findings anchor to a schedule subject name (line 0),
#: like the GI rules.
SCHED_RULES: Dict[str, Rule] = {
    rule.id: rule
    for rule in [
        Rule(
            "GS001",
            "flat-ring-on-dcn",
            "A flat ring is SELECTED on a multi-host topology: its single "
            "ring wraps across every host, so each of its steps has a hop "
            "on the slow inter-host link and the whole circulation is "
            "gated on it — past the hierarchical schedule's proven DCN "
            "bound. Use --reduce-schedule hier (or auto) when the samples "
            "axis spans hosts.",
        ),
        Rule(
            "GS002",
            "schedule-formula-mismatch",
            "The per-level traffic simulated from the recorded schedule "
            "disagrees with the audited closed forms "
            "(parallel/mesh.py:ring_traffic_bytes / "
            "hierarchical_traffic_bytes) — telemetry, the manifest's "
            "schedule block, and the plan validator no longer describe "
            "the schedule the ring executes.",
        ),
        Rule(
            "GS003",
            "overlap-hole",
            "A link-bound schedule step is not issued free of the products "
            "in the recorded schedule (a hop sent after a product that "
            "reads its tile, or sending a buffer a product wrote): the "
            "transfer adds to the critical path instead of hiding behind "
            "the tensor cores — the schedule-level generalization of "
            "GI001, applied to BOTH levels of the hierarchical ring.",
        ),
        Rule(
            "GS004",
            "schedule-liveness-past-hbm",
            "The schedule's static per-device peak liveness (a sweep over "
            "each position's storage lifetimes in the recorded schedule) "
            "exceeds the HBM fraction budget — the schedule cannot run at "
            "this geometry regardless of its traffic profile.",
        ),
        Rule(
            "GS005",
            "critical-path-past-budget",
            "The predicted schedule-limited critical path (per-level link "
            "time over the declared topology's rates, overlap-aware) "
            "exceeds the declared --sched-budget-seconds — the plan "
            "cannot be proven to fit its time budget on this topology.",
        ),
    ]
}


ALL_RULES: Dict[str, Rule] = {
    **RULES, **IR_RULES, **RANGES_RULES, **SCHED_RULES, **LOCK_RULES, **HOSTMEM_RULES,
    **PROTO_RULES,
}


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
    "RULES",
    "IR_RULES",
    "RANGES_RULES",
    "SCHED_RULES",
    "LOCK_RULES",
    "HOSTMEM_RULES",
    "PROTO_RULES",
    "ALL_RULES",
    "HOT_PATH_GLOBS",
    "HOSTMEM_GLOBS",
    "INGEST_GLOBS",
    "TELEMETRY_GLOBS",
    "parse_disables",
    "apply_disables",
]
