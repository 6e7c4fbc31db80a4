"""``graftcheck ir`` of the port (``check/ir.py``, ``obs/schedule.py``) on
the CPU, at the reference's audit sizes (N=64 and 100, B=8).

The reference's verdicts come from this image's JAX, which its audits do
not run under (its ring audits stop at ``AbstractMesh``), so the port is
held against the reference where that does not matter — the rule
catalogue, the spec names, the report schema, the CLI grammar, the dense
output shapes and the closed forms the audit compares with
(``parallel/mesh.py:ring_traffic_bytes``, ``S - 1`` shifts a pass) — and
its own verdicts against mutants written in the port's idiom, each of
which must flag exactly its GI rule.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch.check import ir
from spark_examples_tpu_torch.check.ir import (
    DonationSite,
    KernelSpec,
    Update,
    audit_kernel,
    counts_kernel_spec,
    default_specs,
    dense_kernel_spec,
    devicegen_hier_spec,
    devicegen_ring_spec,
    hier_kernel_spec,
    overlap_findings,
    peak_live_bytes,
    record_update,
    ring_kernel_spec,
    run_audit,
    stacked_kernel_spec,
)
from spark_examples_tpu_torch.obs.schedule import Op, Tile
from spark_examples_tpu_torch.ops import gramian as port_gramian
from spark_examples_tpu_torch.ops.devicegen import cross_accumulate, gram_accumulate
from spark_examples_tpu_torch.ops.gramian import dense_update, unpack_rows_t, unpack_rows_t_plain
from spark_examples_tpu_torch.parallel.collectives import consume, ring_shift
from spark_examples_tpu_torch.parallel.mesh import padded_cohort

RING_PASS = port_gramian.ring_pass


def _ids(audit):
    return sorted({f.rule_id for f in audit.findings})


def _ref_ir():
    from spark_examples_tpu.check import ir as ref_ir

    return ref_ir


@pytest.fixture
def reference_jax_shims(monkeypatch):
    """The reference's ring audit is written for an older JAX: its
    ``AbstractMesh`` took ``((name, size), ...)`` and its jitted programs
    traced as ``pjit``. Adapted in this process only."""
    import jax.sharding

    ref_ir = _ref_ir()
    base = jax.sharding.AbstractMesh

    class AbstractMesh(base):
        def __init__(self, shape, axis_names=None, *args, **kwargs):
            if axis_names is None:
                sizes = tuple(size for _, size in shape)
                axis_names = tuple(name for name, _ in shape)
                shape = sizes
            super().__init__(shape, axis_names, *args, **kwargs)

    monkeypatch.setattr(jax.sharding, "AbstractMesh", AbstractMesh)
    monkeypatch.setattr(
        ref_ir, "_find_top_pjit",
        lambda jaxpr: next((e for e in jaxpr.eqns if e.primitive.name in ("pjit", "jit")), None),
    )


# --------------------------------------------------------------------------
# The shipped matrix.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("topologies,count", [((), 18), (((2, 4),), 21)])
def test_default_matrix_is_clean_and_names_the_references(topologies, count):
    specs = default_specs(topologies=topologies)
    ref_names = [s.name for s in _ref_ir().default_specs(topologies=topologies)]
    assert [s.name for s in specs] == ref_names and len(specs) == count
    report = run_audit(specs)
    assert report.ok, report.format()
    assert report.format().endswith(f"graftcheck ir: {count} kernel(s), clean")
    for audit in report.audits:
        assert audit.facts["accumulator_donated"] is True
        assert audit.facts["gc005_disable_present"] is False
        assert audit.facts["f64_free"] is True


def _ring_cases():
    for data, samples in ((1, 2), (1, 4), (2, 2)):
        for n in (64, 100):
            for pack in (True, False):
                yield f"ring-{data}x{samples}-N{n}-{pack}", lambda d=data, s=samples, n=n, p=pack: (
                    ring_kernel_spec(d, s, n, 8, p), d * 8, s, n, p)
        for pack in (True, False):
            yield f"devicegen-{data}x{samples}-{pack}", lambda d=data, s=samples, p=pack: (
                devicegen_ring_spec(d, s, 64, 8, 2, p), d * 2 * 8, s, 64, p)
    for hosts, per_host in ((2, 2), (2, 4)):
        for n in (64, 100):
            for pack in (True, False):
                yield f"hier-{hosts}x{per_host}-N{n}-{pack}", lambda h=hosts, d=per_host, n=n, p=pack: (
                    hier_kernel_spec(1, h, d, n, 8, p), 8, h * d, n, p)
        yield f"devicegen-hier-{hosts}x{per_host}", lambda h=hosts, d=per_host: (
            devicegen_hier_spec(1, h, d, 64, 8, 2), 2 * 8, h * d, 64, True)


RING_CASES = dict(_ring_cases())


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_shifts_and_bytes_equal_both_formulas(case):
    from spark_examples_tpu.parallel.mesh import ring_traffic_bytes as ref_bytes
    from spark_examples_tpu_torch.parallel.mesh import ring_traffic_bytes

    spec, rows, samples, n, pack = RING_CASES[case]()
    audit = audit_kernel(spec)
    assert audit.ok, "\n".join(f.format() for f in audit.findings)
    passes = spec.ring_passes
    assert audit.facts["permute_executions"] == passes * (samples - 1)
    assert audit.facts["ring_overlap_independent"] is True
    n_local = padded_cohort(n, samples, pack=pack) // samples
    want = ring_traffic_bytes(rows, samples, n_local, pack)
    assert want == ref_bytes(rows, samples, n_local, pack)
    assert audit.facts["ring_bytes_jaxpr"] == audit.facts["ring_bytes_formula"] == want
    assert audit.facts["liveness_scope"] == "per-device" and audit.facts["peak_live_bytes"] > 0


@pytest.mark.parametrize("pack,hosts", [(True, 1), (False, 1), (True, 2)])
def test_recorded_bytes_equal_the_ring_counter(pack, hosts):
    """A full flush of ``ShardedGramianAccumulator`` on CPU positions with
    its counters on: the bytes of the recorded shifts are the increment of
    ``gramian_ring_bytes``."""
    from spark_examples_tpu_torch.obs.metrics import GRAMIAN_RING_BYTES, MetricsRegistry
    from spark_examples_tpu_torch.ops.gramian import ShardedGramianAccumulator
    from spark_examples_tpu_torch.parallel.mesh import make_mesh

    registry = MetricsRegistry()
    mesh = make_mesh({"data": 1, "samples": 4}, ["cpu"] * 4, local=True)
    acc = ShardedGramianAccumulator(64, mesh, block_size=8, registry=registry,
                                    pack_bits="on" if pack else "off",
                                    reduce_schedule="hier" if hosts > 1 else "flat",
                                    hier_hosts=hosts)
    rows = (np.random.default_rng(3).random((8, 64)) < 0.4).astype(np.uint8)
    before = registry.value(GRAMIAN_RING_BYTES, default=0)
    trace = record_update(Update(lambda: acc.add_rows(rows), []))
    shifts = [op for op in trace.ops if op.role == "shift"]
    assert len({op.call for op in shifts}) == 3
    recorded = sum(op.results[0].nbytes for op in shifts)
    assert recorded == registry.value(GRAMIAN_RING_BYTES) - before > 0
    want = np.asarray(rows, dtype=np.int64)
    assert np.array_equal(acc.finalize(), want.T @ want)


@pytest.mark.parametrize("make,size", [
    (dense_kernel_spec, 1), (dense_kernel_spec, 2), (counts_kernel_spec, 1),
    (counts_kernel_spec, 2), (stacked_kernel_spec, 2), (stacked_kernel_spec, 4),
])
def test_dense_out_shapes_equal_the_reference(make, size):
    ref_make = getattr(_ref_ir(), make.__name__)
    ref = ref_make(size, 64, 8)
    port = make(size, 64, 8)
    assert port.name == ref.name
    ref_facts = _ref_ir().audit_kernel(ref).facts
    facts = audit_kernel(port).facts
    assert facts["out_shapes"] == ref_facts["out_shapes"] == [[size, 64, 64]]
    # The kept divergence: int32 from the first flush, float32 in the reference.
    assert (facts["out_dtypes"], ref_facts["out_dtypes"]) == (["int32"], ["float32"])


def test_ir_rules_match_the_reference():
    from spark_examples_tpu.check.rules import IR_RULES as REF
    from spark_examples_tpu_torch.check.rules import ALL_RULES, IR_RULES

    assert [(r.id, r.name) for r in IR_RULES.values()] == [(r.id, r.name) for r in REF.values()]
    assert all(ALL_RULES[rule_id] is rule for rule_id, rule in IR_RULES.items())


@pytest.mark.parametrize("which", ["dense", "ring"])
def test_report_json_keys_match_the_reference(which, reference_jax_shims):
    ref_ir = _ref_ir()
    make = {"dense": lambda m: m.dense_kernel_spec(1, 64, 8),
            "ring": lambda m: m.ring_kernel_spec(1, 2, 64, 8, True)}[which]
    docs = [json.loads(m.run_audit([make(m)]).to_json()) for m in (ref_ir, ir)]
    ref, port = docs
    assert set(port) == set(ref) == {"tool", "ok", "kernel_count", "finding_count", "kernels"}
    assert port["tool"] == ref["tool"] == "graftcheck-ir"
    [ref_kernel], [port_kernel] = ref["kernels"], port["kernels"]
    assert set(port_kernel) == set(ref_kernel)
    assert set(port_kernel["facts"]) == set(ref_kernel["facts"])
    assert port["ok"] and port["finding_count"] == 0


def test_audit_makes_no_cuda_context():
    run_audit(default_specs(num_samples=32, ragged_samples=52, block_size=8,
                            meshes=((1, 2), (2, 2)), topologies=((2, 2),)))
    run_audit([ring_kernel_spec(1, 4, 2504, 1024, True, device="meta")])
    assert not torch.cuda.is_initialized()


def test_peak_live_bytes_is_deterministic_and_bounded_below():
    a, b = torch.ones((64, 64)), torch.ones((64, 64))
    trace = record_update(Update(lambda: (a @ b) + 1.0, (a,)))
    peak = peak_live_bytes(trace)
    assert peak >= 3 * 64 * 64 * 4  # both operands and the product coexist
    assert peak == peak_live_bytes(record_update(Update(lambda: (a @ b) + 1.0, (a,))))
    spec = dense_kernel_spec(1, 64, 8)
    first, second = (audit_kernel(spec).facts["peak_live_bytes"] for _ in range(2))
    assert first == second >= 64 * 64 * 4 + 8 * 8  # G and the packed block


def test_meta_ring_schedule_is_the_cpu_schedule():
    """The plan's ring audit runs on ``meta`` tensors at a run's geometry:
    the same ops, dtypes and shapes as on CPU positions."""
    cpu, meta = (ir.trace_kernel(ring_kernel_spec(1, 4, 100, 8, True, device=d))
                 for d in ("cpu", "meta"))
    assert [op.signature() for op in cpu.ops] == [op.signature() for op in meta.ops]
    assert audit_kernel(ring_kernel_spec(1, 4, 100, 8, True, device="meta")).ok


# --------------------------------------------------------------------------
# Mutants: one defect each, written in the port's idiom.
# --------------------------------------------------------------------------


def _step(positions, tiles, events, mine, G_local, n_local, packed, j, max_count=None):
    """One flat ring step, as ``ring_pass`` takes it."""
    S = len(positions)
    for p, pos in enumerate(positions):
        owner = (p + j) % S
        cols = G_local[p][:, owner * n_local : (owner + 1) * n_local]
        with pos.run():
            if owner == p:
                cross_accumulate(cols, mine[p], mine[p])
                continue
            consume(pos, tiles[p], events[p])
            b = unpack_rows_t(tiles[p], n_local, counts=not packed, max_count=max_count)
            cross_accumulate(cols, mine[p], b)


def serialized_ring_pass(positions, own, ready, mine, G_local, n_local, packed, hosts=1,
                         max_count=None):
    """The pre-overlap loop: each step's products, then the shift of the
    tile they read."""
    S = len(positions)
    tiles, events = list(own), list(ready)
    for j in range(S):
        _step(positions, tiles, events, mine, G_local, n_local, packed, j, max_count)
        if j < S - 1:
            tiles, events = ring_shift(tiles, events, positions, [(p + 1) % S for p in range(S)])


def extra_shift_ring_pass(positions, own, ready, mine, G_local, n_local, packed, hosts=1,
                          max_count=None):
    """The double-buffered loop that still returns each tile to its owner:
    S shifts a pass."""
    S = len(positions)
    tiles, events = list(own), list(ready)
    for j in range(S):
        nxt = ring_shift(tiles, events, positions, [(p + 1) % S for p in range(S)])
        _step(positions, tiles, events, mine, G_local, n_local, packed, j, max_count)
        tiles, events = nxt


def chatty_ring_pass(positions, own, ready, mine, G_local, n_local, packed, hosts=1,
                     max_count=None):
    """The ring sends each position's unpacked rows (its Xᵀ transposed
    back, a byte a genotype) in place of its packed tile."""
    rows = [xt[:n_local, : tile.shape[0]].T.contiguous().view(torch.uint8)
            for xt, tile in zip(mine, own)]
    RING_PASS(positions, rows, ready, mine, G_local, n_local, False, hosts, 1)


def inline_unpack(block, num_columns, counts=False, max_count=None):
    """The tiles unpacked before (and after) their shift by the inline
    shifts and masks, not the designated kernel."""
    return unpack_rows_t_plain(block, num_columns, counts)


def out_of_place_update(G, X, num_samples):
    partial = torch.zeros_like(G)
    gram_accumulate(partial, unpack_rows_t(X, num_samples))
    return G + partial


def stale_update(G, X, num_samples):  # graftcheck: disable=GC005 -- stale: this update is in place
    dense_update(G, X, num_samples)


def unjustified_update(G, X, num_samples):
    dense_update(G, X, num_samples)


def f64_update(G, X, num_samples):
    sites = torch.tensor(X.shape[0]).double()  # noqa: F841 — the defect: a float64 value
    dense_update(G, X, num_samples)


def _dense_mutant(update, function):
    def build():
        G = torch.zeros((64, 64), dtype=torch.int32)
        X = torch.from_numpy(np.packbits(ir._bits((8, 64)), axis=-1))
        return Update(lambda: update(G, X, 64), (G,), (X,))

    return KernelSpec(f"mutant-{function}", build, packed=True,
                      donation=DonationSite(__file__, function, "tests/test_torch_ir.py"))


def _boom():
    raise ValueError("fixture cannot build")


#: mutant → (what to patch in ops/gramian.py, the spec, the one rule it trips)
MUTANTS = {
    "serialized": (("ring_pass", serialized_ring_pass), lambda: ring_kernel_spec(1, 4, 64, 8, True),
                   "GI001"),
    "extra-shift": (("ring_pass", extra_shift_ring_pass),
                    lambda: ring_kernel_spec(1, 4, 64, 8, True), "GI006"),
    "inline-unpack": (("unpack_rows_t", inline_unpack), lambda: ring_kernel_spec(1, 4, 64, 8, True),
                      "GI003"),
    "chatty": (("ring_pass", chatty_ring_pass), lambda: ring_kernel_spec(1, 4, 64, 8, True),
               "GI005"),
    "f64": (None, lambda: _dense_mutant(f64_update, "unjustified_update"), "GI004"),
    "out-of-place": (None, lambda: _dense_mutant(out_of_place_update, "out_of_place_update"),
                     "GI002"),
    "stale-disable": (None, lambda: _dense_mutant(stale_update, "stale_update"), "GI002"),
    "trace-failure": (None, lambda: KernelSpec("mutant-boom", _boom), "GI000"),
    "update-raises": (None, lambda: _dense_mutant(lambda G, X, n: _boom(), "unjustified_update"),
                      "GI000"),
}


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_each_mutant_flags_exactly_its_rule(name, monkeypatch):
    patch, make, rule = MUTANTS[name]
    if patch is not None:
        monkeypatch.setattr(port_gramian, *patch)
    audit = audit_kernel(make())
    assert _ids(audit) == [rule], "\n".join(f.format() for f in audit.findings)
    facts = audit.facts
    if rule == "GI001":
        assert facts["ring_overlap_independent"] is False
    if rule == "GI006":
        assert facts["permute_executions"] == 4 and facts["permute_executions_expected"] == 3
    if rule == "GI005":
        assert facts["ring_bytes_jaxpr"] > facts["ring_bytes_formula"]
    if rule == "GI004":
        assert facts["f64_free"] is False
    if name == "out-of-place":
        assert "NOT in place" in audit.findings[0].detail
    if name == "stale-disable":
        assert "drifted" in audit.findings[0].detail


def test_a_shift_sending_what_a_product_wrote_is_serialized():
    """The second GI001 form, on a schedule written out: a product writes
    storage 7, then a shift sends it."""
    def t(storage, dtype="int32"):
        return Tile(dtype, (8, 8), storage, 256, 256)

    ops = [
        Op(0, "cross_accumulate", "product", (t(1, "int8"), t(2, "int8")), (t(7),), (), 0, 0),
        Op(1, "ring_shift", "shift", (t(7),), (), (t(8),), 1, 1, (0, 1)),
    ]
    [message] = overlap_findings(ops)
    assert "earlier product wrote" in message
    assert overlap_findings(ops[1:]) == []


def test_gc005_cross_check_reads_the_port_disables():
    here = ir.gc005_justified_functions(__file__)
    assert "stale_update" in here and "unjustified_update" not in here
    for name in ("gramian", "devicegen", "batched"):
        assert ir.gc005_justified_functions(ir._module_file(name)) == set()


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--mesh", "bogus"], ["--mesh", "0,2"], ["--mesh", "1,2,3"], ["--topology", "3"],
    ["--topology", "a,b"], ["--topology", "0,2"],
])
def test_cli_grammar_errors_are_the_references(argv):
    from spark_examples_tpu.check.cli import main as ref_main
    from spark_examples_tpu_torch.check.cli import main

    ref_rc, _, ref_err = _run(ref_main, ["ir", *argv])
    rc, _, err = _run(main, ["ir", *argv])
    assert rc == ref_rc == 2
    assert err == ref_err


def test_cli_ir_exit_codes(monkeypatch):
    from spark_examples_tpu_torch.check.cli import main

    rc, out, _ = _run(main, ["ir", "--mesh", "1,2", "--num-samples", "16", "--block-size", "4"])
    assert rc == 0 and out.strip().endswith("kernel(s), clean")
    rc, out, _ = _run(main, ["ir", "--json", "--mesh", "1,4", "--topology", "2,2"])
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] and doc["kernel_count"] == 2 + 2 + 3 + 1 + 3
    monkeypatch.setattr(port_gramian, "ring_pass", serialized_ring_pass)
    rc, out, _ = _run(main, ["ir", "--mesh", "1,4"])
    assert rc == 1 and "GI001" in out and "GI00" not in out.replace("GI001", "")
    assert not torch.cuda.is_initialized()


def test_recordings_are_per_thread():
    """A thread records its own calls only (the serve daemon audits a
    sharded plan while workers launch), and two threads can audit at
    once."""
    import threading

    from spark_examples_tpu_torch.obs import schedule

    G = torch.zeros((64, 64), dtype=torch.int32)
    X = torch.from_numpy(np.packbits(ir._bits((8, 64)), axis=-1))
    with schedule.recording() as mine:
        worker = threading.Thread(target=dense_update, args=(G, X, 64))
        worker.start()
        worker.join()
        assert mine.ops == [] and schedule.SINK is schedule.current
    assert schedule.SINK is None and int(G.sum()) > 0
    audits = [None, None]

    def audit(i):
        audits[i] = audit_kernel(ring_kernel_spec(1, 4, 2504, 1024, True, device="meta"))

    threads = [threading.Thread(target=audit, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(a.ok for a in audits)
    assert audits[0].facts == audits[1].facts


class _EndingSink:
    """Stands for ``obs/schedule.py`` in the hooked modules: each read of
    ``SINK`` after one that gave the sink gives ``None``, as when another
    thread's recording ends between two reads."""

    def __init__(self):
        self.reads = 0

    @property
    def SINK(self):
        self.reads += 1
        return (lambda: None) if self.reads % 2 else None


@pytest.mark.parametrize("make", [
    lambda: dense_kernel_spec(1, 64, 8),
    lambda: counts_kernel_spec(1, 64, 8),
    lambda: stacked_kernel_spec(2, 64, 8),
    lambda: ring_kernel_spec(1, 4, 64, 8, True),
    lambda: ring_kernel_spec(1, 4, 64, 8, False),
    lambda: hier_kernel_spec(1, 2, 2, 64, 8, True),
    lambda: devicegen_ring_spec(1, 4, 64, 8, 2),
    lambda: devicegen_ring_spec(1, 4, 64, 8, 2, pack=False),
], ids=["dense", "counts", "stacked", "ring", "ring-unpacked", "hier", "devicegen",
        "devicegen-unpacked"])
def test_hooks_read_the_sink_once(make, monkeypatch):
    """Every hook (the kernel wrappers, ``ring_shift``, ``consume`` and
    ``Position.run``) reads ``SINK`` once, so a recording that ends on
    another thread between its check and its call cannot make it call
    ``None``."""
    from spark_examples_tpu_torch.ops import batched, devicegen
    from spark_examples_tpu_torch.parallel import collectives, mesh

    update = make().build()
    sink = _EndingSink()
    for module in (port_gramian, devicegen, batched, collectives, mesh):
        monkeypatch.setattr(module, "_schedule", sink)
    update.run()
    assert sink.reads >= 2


def test_a_recording_ending_while_another_thread_launches():
    """One thread starts and ends recordings in a loop while another runs a
    ring flush and dense updates unrecorded: the worker never fails and
    its Gramian is the plain one."""
    import sys
    import threading

    from spark_examples_tpu_torch.obs import schedule

    G = torch.zeros((64, 64), dtype=torch.int32)
    X = torch.from_numpy(np.packbits(ir._bits((8, 64)), axis=-1))
    ring = ring_kernel_spec(1, 4, 64, 8, True)
    stop, errors = threading.Event(), []

    def worker():
        try:
            while not stop.is_set():
                dense_update(G, X, 64)
                ring.build().run()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    thread = threading.Thread(target=worker)
    try:
        thread.start()
        for _ in range(2000):
            with schedule.recording():
                pass
    finally:
        stop.set()
        thread.join()
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert schedule.SINK is None
    want = torch.zeros_like(G)
    dense_update(want, X, 64)
    assert int(G.sum()) % int(want.sum()) == 0 and int(G.sum()) > 0
