"""``graftcheck sched`` of the port (``check/sched.py``) on the CPU, against
the reference's (``spark_examples_tpu/check/sched.py``).

The reference's schedule prover traces jaxprs, which this image's JAX only
runs under the shims of ``tests/test_torch_ir.py:reference_jax_shims``
(its ``AbstractMesh`` spelling, ``pjit`` named ``jit``); with them it
proves its whole matrix in seconds. The port records its rings' schedule
(``obs/schedule.py``) and places each shift on a link class by where its
hops go (``Op.source`` → ``Op.position``). Held against each other: the
subject names and order, the per-level bytes and steps, the closed forms,
the selection, the hierarchical bound and the six comparisons of the
default matrix (16 subjects, the 32x8 fleet included); the critical path
under the reference's link rates (the port's default rates are an H100
fleet's); the CLI's grammar and exit codes; the plan's ``--topology`` /
``--sched-budget-seconds`` accepts and rejects. Each GS rule has a mutant
written in the port's idiom. Only the default matrix and the plan's 32x8
cases record the 256-position rings.
"""

import contextlib
import dataclasses
import io
import json

import pytest
import torch

from spark_examples_tpu_torch.check import ir
from spark_examples_tpu_torch.check.sched import (
    DEFAULT_TOPOLOGIES,
    audit_schedule,
    extract_schedule,
    run_audit,
    schedule_kernel_spec,
)
from spark_examples_tpu_torch.ops import gramian as port_gramian
from spark_examples_tpu_torch.ops.devicegen import cross_accumulate
from spark_examples_tpu_torch.ops.gramian import unpack_rows_t
from spark_examples_tpu_torch.parallel.collectives import consume, ring_shift
from spark_examples_tpu_torch.parallel.mesh import (
    DEFAULT_DCN_BYTES_PER_S,
    DEFAULT_ICI_BYTES_PER_S,
    Topology,
    hierarchical_traffic_bytes,
    parse_topology,
    ring_traffic_bytes,
)

#: The reference's link rates (a TPU pod's: ``spark_examples_tpu/parallel/
#: mesh.py:DEFAULT_ICI_BYTES_PER_S`` / ``DEFAULT_DCN_BYTES_PER_S``).
REF_ICI, REF_DCN = 100 * 10**9, 25 * 10**9

#: Facts that must equal the reference's on every subject (the liveness is
#: the port's own recorded buffers', the seconds follow the link rates).
SAME_FACTS = ("topology", "schedule", "kernel", "selected", "ici_bytes", "dcn_bytes",
              "ici_steps", "dcn_steps", "rows_per_call", "formula_ici_bytes",
              "formula_dcn_bytes", "hbm_budget_bytes", "hier_dcn_bound_bytes", "sim_rows")


def _shim(mp):
    """The reference's ring audit on this image's JAX, in this process
    only (``tests/test_torch_ir.py:reference_jax_shims``)."""
    import jax.sharding

    from spark_examples_tpu.check import ir as ref_ir

    base = jax.sharding.AbstractMesh

    class AbstractMesh(base):
        def __init__(self, shape, axis_names=None, *args, **kwargs):
            if axis_names is None:
                sizes = tuple(size for _, size in shape)
                axis_names = tuple(name for name, _ in shape)
                shape = sizes
            super().__init__(shape, axis_names, *args, **kwargs)

    mp.setattr(jax.sharding, "AbstractMesh", AbstractMesh)
    mp.setattr(ref_ir, "_find_top_pjit",
               lambda jaxpr: next((e for e in jaxpr.eqns if e.primitive.name in ("pjit", "jit")),
                                  None))


@pytest.fixture
def ref_sched(monkeypatch):
    _shim(monkeypatch)
    from spark_examples_tpu.check import sched

    return sched


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def matrices():
    """The default matrix of both packages: the port's through its CLI,
    in this process; the reference's ``run_audit`` under the shims."""
    from spark_examples_tpu.check import sched as ref
    from spark_examples_tpu_torch.check.cli import main

    rc, out, err = _run(main, ["sched", "--json"])
    with pytest.MonkeyPatch.context() as mp:
        _shim(mp)
        reference = json.loads(ref.run_audit().to_json())
    return rc, json.loads(out), reference, err


# --------------------------------------------------------------------------
# The default matrix against the reference's.
# --------------------------------------------------------------------------


class TestSchedMatrix:
    def test_default_matrix_proves_clean(self, matrices):
        rc, port, ref, err = matrices
        assert rc == 0 and err == "", err
        assert port["tool"] == ref["tool"] == "graftcheck-sched"
        assert set(port) == set(ref)
        assert port["ok"] and port["finding_count"] == 0 and port["subject_count"] == 16
        assert [s["subject"] for s in port["subjects"]] == [s["subject"] for s in ref["subjects"]]
        # Every multi-host topology carries its hier-vs-flat comparison for
        # both rings, hier strictly below on the slow link — the reference's.
        assert port["comparisons"] == ref["comparisons"]
        assert len(port["comparisons"]) == 2 * len([t for t in DEFAULT_TOPOLOGIES if t[0] > 1])
        assert {c["kernel"] for c in port["comparisons"]} == {"gramian", "devicegen"}
        assert all(c["hier_strictly_below"] and c["dcn_reduction"] > 1.0
                   for c in port["comparisons"])

    @pytest.mark.parametrize("index", range(16))
    def test_subject_facts_are_the_references(self, matrices, index):
        _, port, ref, _ = matrices
        mine, theirs = port["subjects"][index], ref["subjects"][index]
        assert mine["subject"] == theirs["subject"] and mine["ok"] and theirs["ok"]
        assert set(mine["facts"]) == set(theirs["facts"])
        for key in SAME_FACTS:
            assert mine["facts"].get(key) == theirs["facts"].get(key), key
        assert mine["facts"]["critical_path_seconds"] > 0

    def test_named_cells_of_the_issue(self, matrices):
        """The 32x8 flat Gramian ring is DCN 522,240 B in 255 steps; the 2x4
        hierarchical device ring ICI 768 B / 12 steps and DCN 128 B / 2."""
        facts = {s["subject"]: s["facts"] for s in matrices[1]["subjects"]}
        flat = facts["sched[32x8,flat,ring[data=1,samples=256,N=64,B=8,pack=on]]"]
        assert (flat["ici_bytes"], flat["dcn_bytes"], flat["dcn_steps"]) == (0, 522240, 255)
        hier = facts["sched[2x4,hier,devicegen-hier[data=1,hosts=2,devices=4,N=64,B=8,K=2,"
                     "pack=on]]"]
        assert (hier["ici_bytes"], hier["ici_steps"], hier["dcn_bytes"], hier["dcn_steps"]) == (
            768, 12, 128, 2)

    def test_flat_simulation_matches_formula_exactly(self, matrices):
        """GS002's clean side: every flat subject's bytes are
        ``ring_traffic_bytes``, all on one level."""
        for subject in matrices[1]["subjects"]:
            facts = subject["facts"]
            if facts["schedule"] != "flat":
                continue
            hosts, per_host = map(int, facts["topology"].split("x"))
            topo = Topology(hosts, per_host)
            spec = schedule_kernel_spec(topo, "flat", 64, 8, kernel=facts["kernel"])
            total = ring_traffic_bytes(facts["rows_per_call"], topo.devices, spec.n_local, True)
            level = "ici" if hosts == 1 else "dcn"
            assert facts[f"{level}_bytes"] == total and facts["ici_bytes"] + facts["dcn_bytes"] == total

    def test_hier_per_level_bytes_and_steps(self):
        topo = Topology(4, 8)
        audit = audit_schedule(topo, "hier")
        assert audit.ok, [f.format() for f in audit.findings]
        level = hierarchical_traffic_bytes(
            audit.facts["rows_per_call"], 4, 8, schedule_kernel_spec(topo, "hier", 64, 8).n_local,
            True)
        assert (audit.facts["ici_bytes"], audit.facts["dcn_bytes"]) == (level.ici_bytes,
                                                                        level.dcn_bytes)
        # Per ring: H·(D-1) inner + (H-1) outer shift calls = S - 1.
        assert (audit.facts["ici_steps"], audit.facts["dcn_steps"]) == (4 * 7, 3)

    @pytest.mark.parametrize("topology,schedule,kernel", [
        ((1, 4), "flat", "gramian"), ((2, 4), "hier", "gramian"), ((2, 4), "flat", "gramian"),
        ((4, 8), "hier", "gramian"), ((2, 4), "hier", "devicegen"), ((4, 8), "flat", "devicegen"),
    ])
    def test_critical_path_under_the_reference_rates(self, ref_sched, topology, schedule,
                                                     kernel):
        """With the reference's link rates the port predicts the
        reference's seconds, per level and on the critical path, for one
        flush and scaled over 4,001 rows."""
        hosts, per_host = topology
        for rows in (None, 4001):
            port = audit_schedule(Topology(hosts, per_host, REF_ICI, REF_DCN), schedule,
                                  kernel=kernel, rows=rows).facts
            ref = ref_sched.audit_schedule(ref_sched.Topology(hosts, per_host), schedule,
                                           kernel=kernel, rows=rows).facts
            for key in ("ici_seconds", "dcn_seconds", "critical_path_seconds"):
                assert port[key] == pytest.approx(ref[key], rel=1e-12), key
            assert port["sim_rows"] == ref["sim_rows"]

    def test_critical_path_scales_linearly_with_rows(self):
        topo = Topology(4, 8)
        spec = schedule_kernel_spec(topo, "hier", 64, 8)
        schedule = extract_schedule(ir.trace_kernel(spec, watch=False), spec, topo, "hier")
        one = schedule.critical_path_seconds()
        assert schedule.critical_path_seconds(schedule.rows_per_call * 10) == pytest.approx(one * 10)
        # Overlap proven on both levels: the slower level, not the sum.
        assert one == max(schedule.link_seconds().values())
        assert not schedule.overlap_holes()

    def test_default_rates_are_the_h100_fleets(self):
        topo = parse_topology("32,8")
        assert (topo.hosts, topo.devices_per_host, topo.devices) == (32, 8, 256)
        assert (topo.ici_bytes_per_s, topo.dcn_bytes_per_s) == (
            DEFAULT_ICI_BYTES_PER_S, DEFAULT_DCN_BYTES_PER_S) == (450 * 10**9, 400 * 10**9)
        for bad in ("32", "a,b", "1,2,3", ""):
            with pytest.raises(ValueError):
                parse_topology(bad)
        with pytest.raises(ValueError):
            Topology(0, 4)
        with pytest.raises(ValueError):
            Topology(2, 2, ici_bytes_per_s=0)

    def test_run_audit_touches_no_device(self, monkeypatch):
        """CPU positions only: no tensor on another device, no CUDA call."""
        def refuse(*args, **kwargs):
            raise AssertionError("the schedule prover queried CUDA")

        for fn in ("is_available", "device_count", "mem_get_info", "get_device_properties",
                   "synchronize", "current_device"):
            monkeypatch.setattr(torch.cuda, fn, refuse)
        with _DeviceWatch() as watch:
            report = run_audit(topologies=((2, 2), (1, 2)))
        assert report.ok and len(report.audits) == 6
        assert watch.devices == {"cpu"}
        assert not torch.cuda.is_initialized()


class _DeviceWatch(torch.overrides.TorchFunctionMode):
    """Records the device of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


# --------------------------------------------------------------------------
# The link class comes from each hop's sender.
# --------------------------------------------------------------------------


def _levels(schedule):
    return {level: sum(s.executions for s in schedule.steps if s.level == level)
            for level in ("ici", "dcn")}


def test_link_class_comes_from_each_hops_sender():
    """A hierarchical recording of 2x4 is ICI 6 / DCN 1 shift calls: the
    inner calls' hops stay on their host, the outer call's cross it (axis
    ``hosts``). The same flat recording is all ICI on one host and all DCN
    across two; and with each hop's sender moved onto its receiver's host
    the outer call reads as ICI — the class is read off ``Op.source``."""
    topo = Topology(2, 4)
    spec = schedule_kernel_spec(topo, "hier", 64, 8)
    trace = ir.trace_kernel(spec, watch=False)
    hier = extract_schedule(trace, spec, topo, "hier")
    assert _levels(hier) == {"ici": 6, "dcn": 1}
    assert {(s.level, s.axis) for s in hier.steps} == {("ici", "samples"), ("dcn", "hosts")}
    assert hier.mesh_bytes() == {"ici": 384, "dcn": 64}
    assert len({op.ring for op in trace.ops if op.role == "shift"}) == 1  # one ring for both

    flat_spec = schedule_kernel_spec(Topology(1, 8), "flat", 64, 8)
    flat = ir.trace_kernel(flat_spec, watch=False)
    assert _levels(extract_schedule(flat, flat_spec, Topology(1, 8), "flat")) == {"ici": 7,
                                                                                  "dcn": 0}
    assert _levels(extract_schedule(flat, flat_spec, topo, "flat")) == {"ici": 0, "dcn": 7}

    moved = [op._replace(source=op.position - op.position % 4 + op.source % 4)
             if op.role == "shift" else op for op in trace.ops]
    trace.ops[:] = moved
    trace._serialized = None
    assert _levels(extract_schedule(trace, spec, topo, "hier")) == {"ici": 7, "dcn": 0}


def test_a_data_axis_does_not_move_the_hosts():
    """Positions map host-major within their ring (the samples axis): on a
    2 x (2x2) mesh both data slices' rings split 2 ICI / 1 DCN calls."""
    topo = Topology(2, 2)
    spec = schedule_kernel_spec(topo, "hier", 64, 8, data=2)
    schedule = extract_schedule(ir.trace_kernel(spec, watch=False), spec, topo, "hier")
    assert _levels(schedule) == {"ici": 2, "dcn": 1}
    level = hierarchical_traffic_bytes(16, 2, 2, spec.n_local, True)
    assert schedule.mesh_bytes() == {"ici": level.ici_bytes, "dcn": level.dcn_bytes}
    assert schedule.total_devices == 8


# --------------------------------------------------------------------------
# The recording's fast paths record what a full recording records.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda: ir.ring_kernel_spec(1, 4, 100, 8, True),
    lambda: ir.ring_kernel_spec(2, 2, 64, 8, False),
    lambda: ir.hier_kernel_spec(1, 2, 4, 64, 8, True),
    lambda: ir.hier_kernel_spec(1, 2, 2, 64, 8, True, device="meta"),
    lambda: ir.devicegen_ring_spec(1, 4, 64, 8, 2, pack=False),
    lambda: ir.devicegen_hier_spec(1, 2, 4, 64, 8, 2),
    lambda: ir.ring_kernel_spec(2, 4, 100, 8, True, device="meta"),
    lambda: ir.dense_kernel_spec(2, 40, 8, device="meta"),
    lambda: ir.counts_kernel_spec(1, 40, 8),
    lambda: ir.stacked_kernel_spec(3, 40, 8),
], ids=["ring", "ring-unpacked-2x2", "hier", "hier-meta", "devicegen-unpacked", "devicegen-hier",
        "ring-meta-2x4", "dense-meta", "counts", "stacked"])
def test_shapes_only_recording_is_the_full_one(make):
    """A recording without the dispatch watch is shapes-only (each kernel
    body once a launch layout) and notes the ops of a full one, whose
    every body runs (the watched recording, its dispatched events set
    aside): signatures, supports, senders, each tile's bytes and strides,
    and which storages are one; the audit reads the same facts off both."""
    watched = ir.trace_kernel(make())
    full = dataclasses.replace(watched, events=[], _serialized=None)
    fast = ir.trace_kernel(make(), watch=False)

    def canonical(trace):
        ids = {}
        rows = []
        for op in trace.ops:
            tiles = tuple((t.dtype, t.shape, ids.setdefault(t.storage, len(ids)), t.nbytes,
                           t.storage_nbytes, t.offset, t.strides)
                          for t in (*op.reads, *op.writes, *op.results))
            rows.append((op.signature(), op.support, op.source, op.ring and len(op.ring),
                         op.call, op.packed, tiles))
        return rows

    assert watched.events and not fast.events
    assert canonical(fast) == canonical(full)
    assert ir.audit_kernel(make(), traced=fast).facts == ir.audit_kernel(make(),
                                                                         traced=full).facts


def _serialized_by_pairs(ops):
    """:func:`check.ir.serialized_hops` as every shift against every
    earlier product (the quadratic form it replaced)."""
    root = ir._roots(ops)
    top = lambda key: root.get(key, key)  # noqa: E731
    products = [op for op in ops if op.role == "product"]
    late, written = set(), set()
    for shift in (op for op in ops if op.role == "shift" and op.reads):
        sent = shift.reads[0].storage
        before = [p for p in products if p.index < shift.index]
        if any(top(t.storage) == top(sent) for p in before for t in p.reads):
            late.add(shift.index)
        if any(t.storage == sent for p in before for t in p.writes):
            written.add(shift.index)
    return late, written


@pytest.mark.parametrize("serialized", [False, True])
def test_serialized_hops_in_one_pass_are_the_pairwise_ones(serialized, monkeypatch):
    if serialized:
        monkeypatch.setattr(port_gramian, "ring_pass", serialized_ring_pass)
    for spec in (ir.hier_kernel_spec(1, 2, 4, 64, 8, True), ir.ring_kernel_spec(2, 4, 64, 8, False)):
        ops = ir.trace_kernel(spec, watch=False).ops
        late, written = ir.serialized_hops(ops)
        assert (late, written) == _serialized_by_pairs(ops)
        assert bool(late) == serialized


# --------------------------------------------------------------------------
# The GS rules, one mutant or mis-selected subject each.
# --------------------------------------------------------------------------


def _step(positions, tiles, events, mine, G_local, n_local, packed, k, j, H, D, max_count):
    """One step of the two-level ring, as ``ring_pass`` takes it."""
    for p, pos in enumerate(positions):
        h, d = divmod(p, D)
        owner = ((h + k) % H) * D + (d + j) % D
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
    """The two-level ring with every shift issued after the products that
    read the tile it sends (the serialized anti-pattern, both levels)."""
    S, H = len(positions), int(hosts)
    D = S // H
    inner = [(p // D) * D + (p % D + 1) % D for p in range(S)]
    outer_source = [((p // D + 1) % H) * D + p % D for p in range(S)]
    outer, outer_ready = list(own), list(ready)
    for k in range(H):
        cur, cur_ready = outer, outer_ready
        for j in range(D):
            _step(positions, cur, cur_ready, mine, G_local, n_local, packed, k, j, H, D,
                  max_count)
            if j < D - 1:
                cur, cur_ready = ring_shift(cur, cur_ready, positions, inner)
        if k < H - 1:
            outer, outer_ready = ring_shift(outer, outer_ready, positions, outer_source)


def wide_ring_shift(tiles, ready, positions, source):
    """``ring_shift`` that sends each tile with one extra row."""
    wide = [None if t is None else torch.cat([t, t[:1]]) for t in tiles]
    return ring_shift(wide, ready, positions, source)


def _ids(audit):
    return sorted({f.rule_id for f in audit.findings})


class TestSchedRules:
    def test_gs001_flat_selected_on_multihost(self):
        audit = audit_schedule(Topology(2, 4), "flat", selected=True)
        assert _ids(audit) == ["GS001"]
        assert "inter-host" in audit.findings[0].detail
        assert audit.facts["hier_dcn_bound_bytes"] == 64 < audit.facts["dcn_bytes"] == 448

    def test_gs001_not_on_single_host_or_unselected(self):
        assert audit_schedule(Topology(1, 4), "flat", selected=True).ok
        assert audit_schedule(Topology(2, 4), "flat", selected=False).ok

    def test_gs001_silent_when_one_device_per_host(self):
        # hosts x 1: the flat ring IS the host ring — equal bounds.
        audit = audit_schedule(Topology(4, 1), "flat", selected=True)
        assert audit.ok, [f.format() for f in audit.findings]

    def test_gs002_a_shift_sending_an_extra_row(self, monkeypatch):
        monkeypatch.setattr(port_gramian, "ring_shift", wide_ring_shift)
        audit = audit_schedule(Topology(2, 2), "hier", selected=False)
        assert _ids(audit) == ["GI005", "GS002"]
        assert audit.facts["ici_bytes"] > audit.facts["formula_ici_bytes"]
        assert audit.facts["dcn_bytes"] > audit.facts["formula_dcn_bytes"]

    def test_gs002_a_trace_the_kernel_does_not_make(self):
        # The unpacked wire's recording held against the packed spec.
        unpacked = ir.trace_kernel(ir.hier_kernel_spec(1, 2, 2, 64, 8, False), watch=False)
        audit = audit_schedule(Topology(2, 2), "hier", selected=False, traced=unpacked)
        assert "GS002" in _ids(audit)

    def test_gs002_a_ring_that_fails_to_run(self, monkeypatch):
        def broken(*args, **kwargs):
            raise RuntimeError("no ring")

        monkeypatch.setattr(port_gramian, "ring_pass", broken)
        audit = audit_schedule(Topology(2, 2), "hier")
        assert _ids(audit) == ["GS002"] and "failed to trace" in audit.findings[0].detail

    def test_gs003_serialized_schedule(self, monkeypatch):
        monkeypatch.setattr(port_gramian, "ring_pass", serialized_ring_pass)
        topo = Topology(2, 2)
        audit = audit_schedule(topo, "hier", selected=False)
        assert _ids(audit) == ["GI001", "GS003"]  # every step a hole, and the IR agrees
        holes = [f.detail for f in audit.findings if f.rule_id == "GS003"]
        assert any("DCN step over axis 'hosts'" in d for d in holes)
        assert any("ICI step over axis 'samples'" in d for d in holes)
        # With holes, the levels serialize: the critical path is the sum.
        spec = schedule_kernel_spec(topo, "hier", 64, 8)
        schedule = extract_schedule(ir.trace_kernel(spec, watch=False), spec, topo, "hier")
        seconds = schedule.link_seconds()
        assert schedule.critical_path_seconds() == pytest.approx(seconds["ici"] + seconds["dcn"])

    def test_gs004_liveness_budget(self):
        audit = audit_schedule(Topology(2, 2), "hier", hbm_budget_bytes=1024)
        assert _ids(audit) == ["GS004"]
        assert audit.facts["peak_live_bytes_per_device"] > 1024

    def test_gs005_budget(self):
        topo = Topology(4, 8)
        tight = audit_schedule(topo, "hier", rows=40_000_000, budget_seconds=1e-6)
        assert _ids(tight) == ["GS005"]
        roomy = audit_schedule(topo, "hier", rows=40_000_000, budget_seconds=3600.0)
        assert roomy.ok, [f.format() for f in roomy.findings]
        assert tight.facts["critical_path_seconds"] == roomy.facts["critical_path_seconds"] > 1e-6

    def test_sched_rules_match_the_reference(self):
        from spark_examples_tpu.check.rules import SCHED_RULES as REF
        from spark_examples_tpu_torch.check.rules import ALL_RULES, SCHED_RULES

        assert [(r.id, r.name) for r in SCHED_RULES.values()] == [
            (r.id, r.name) for r in REF.values()]
        assert all(ALL_RULES[rule_id] is rule for rule_id, rule in SCHED_RULES.items())


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------


class TestCli:
    def test_sched_clean_and_json(self, ref_sched):
        from spark_examples_tpu.check.cli import main as ref_main
        from spark_examples_tpu_torch.check.cli import main

        argv = ["sched", "--topology", "2,2", "--json"]
        (rc, out, _), (ref_rc, ref_out, _) = _run(main, argv), _run(ref_main, argv)
        assert rc == ref_rc == 0
        doc, ref = json.loads(out), json.loads(ref_out)
        assert doc["tool"] == "graftcheck-sched" and doc["ok"] is True
        assert {s["facts"]["schedule"] for s in doc["subjects"]} == {"hier", "flat"}
        assert doc["comparisons"] == ref["comparisons"]
        assert doc["comparisons"][0]["hier_strictly_below"] is True
        assert [s["subject"] for s in doc["subjects"]] == [s["subject"] for s in ref["subjects"]]

    def test_sched_text_report(self):
        from spark_examples_tpu_torch.check.cli import main

        rc, out, _ = _run(main, ["sched", "--topology", "1,2"])
        assert rc == 0 and out.endswith("graftcheck sched: 2 schedule(s), clean\n")
        assert "  proved: sched[1x2,flat,ring[" in out and "== formula" in out

    def test_sched_flat_forced_flags_gs001(self):
        from spark_examples_tpu_torch.check.cli import main

        rc, out, _ = _run(main, ["sched", "--topology", "2,2", "--reduce-schedule", "flat"])
        assert rc == 1 and "GS001" in out

    def test_sched_budget_flag(self):
        from spark_examples_tpu_torch.check.cli import main

        rc, out, _ = _run(main, ["sched", "--topology", "2,2", "--sched-budget-seconds", "1e-15"])
        assert rc == 1 and "GS005" in out

    @pytest.mark.parametrize("argv", [
        ["sched", "--topology", "nope"], ["ir", "--topology", "1"],
        ["ranges", "--topology", "2,2,2"], ["sched", "--mesh", "2,2"],
        ["sched", "--sched-budget-seconds", "-1"], ["sched", "--sched-budget-seconds", "0"],
    ])
    def test_usage_errors_are_the_references(self, argv):
        from spark_examples_tpu.check.cli import main as ref_main
        from spark_examples_tpu_torch.check.cli import main

        (rc, _, err), (ref_rc, _, ref_err) = _run(main, argv), _run(ref_main, argv)
        assert rc == ref_rc == 2
        assert err == ref_err
        if "--mesh" in argv:
            assert "--topology" in err
        if "--sched-budget-seconds" in argv:
            assert "positive" in err

    def test_every_subcommand_is_ported(self):
        from spark_examples_tpu_torch.check import cli

        assert cli.NOT_PORTED == {}
        assert "sched" in cli._SUBCOMMANDS


# --------------------------------------------------------------------------
# graftcheck plan: --topology / --sched-budget-seconds.
# --------------------------------------------------------------------------


BASE = ["--num-samples", "64", "--references", "1:0:400000"]

#: The reference's plan cases (``tests/test_graftcheck_sched.py:
#: TestPlanTopology``) short of the 32x8 ones: argv → the issue codes both
#: packages give.
PLAN_CASES = {
    "flat-on-pod": (BASE + ["--topology", "2,4", "--reduce-schedule", "flat"], ["sched-GS001"]),
    "unprovable-budget": (["--num-samples", "64", "--all-references", "--topology", "2,4",
                           "--sched-budget-seconds", "10"], ["sched-budget-unprovable"]),
    "budget-without-topology": (BASE + ["--sched-budget-seconds", "60"],
                                ["sched-budget-seconds"]),
    "budget-on-host-backend": (BASE + ["--pca-backend", "host", "--topology", "2,4",
                                       "--sched-budget-seconds", "0.001"],
                               ["sched-budget-unprovable"]),
    "topology-on-host-backend": (BASE + ["--pca-backend", "host", "--topology", "2,4"],
                                 ["sched-not-applicable"]),
    "budget-on-ld": (["--analysis", "ld", *BASE, "--topology", "2,4",
                      "--sched-budget-seconds", "1"], ["sched-budget-unprovable"]),
    "dense-budget": (BASE + ["--similarity-strategy", "dense", "--topology", "2,4",
                             "--sched-budget-seconds", "60"], ["sched-budget-unprovable"]),
    "data-only-mesh": (BASE + ["--topology", "2,2", "--mesh-shape", "4,1", "--plan-devices", "4"],
                       ["data-axis-starvation", "topology-mesh-mismatch"]),
    "hier-device-ingest": (BASE + ["--ingest", "device", "--reduce-schedule", "hier",
                                   "--topology", "2,4"], []),
    "hier-factor-must-divide": (BASE + ["--reduce-schedule", "hier", "--mesh-shape", "1,9",
                                        "--plan-devices", "9", "--similarity-strategy", "sharded",
                                        "--topology", "2,4"], ["hier-hosts-samples-axis"]),
    "devices-agree": (BASE + ["--topology", "2,4", "--plan-devices", "8"],
                      ["data-axis-starvation"]),
    "mesh-mismatch": (BASE + ["--topology", "2,4", "--mesh-shape", "1,2", "--plan-devices", "8",
                              "--similarity-strategy", "sharded"], ["topology-mesh-mismatch"]),
    "mesh-matches": (BASE + ["--topology", "2,2", "--mesh-shape", "1,4", "--plan-devices", "4",
                             "--similarity-strategy", "sharded"], []),
}


def _plan(pkg, argv):
    import importlib

    plan = importlib.import_module(f"{pkg}.check.plan")
    conf, devices, _json, budget, analysis, topology, sched_budget = plan.parse_plan_args(argv)
    return plan.validate_plan(conf, devices, host_mem_budget=budget, analysis=analysis,
                              topology=topology, sched_budget_seconds=sched_budget)


def _sched_geometry(report):
    return {k: v for k, v in report.geometry.items()
            if k.startswith("sched_") and k != "sched_critical_path_seconds"}


class TestPlanTopology:
    @pytest.mark.parametrize("name", sorted(PLAN_CASES))
    def test_plan_case_is_the_references(self, name, ref_sched):
        argv, codes = PLAN_CASES[name]
        ref, port = (_plan(pkg, argv) for pkg in ("spark_examples_tpu", "spark_examples_tpu_torch"))
        assert sorted(i.code for i in port.issues) == sorted(i.code for i in ref.issues) == codes
        assert port.ok == ref.ok
        assert _sched_geometry(port) == _sched_geometry(ref)

    def test_hier_on_device_ingest_proves_the_device_ring(self):
        report = _plan("spark_examples_tpu_torch", BASE + ["--ingest", "device",
                                                           "--reduce-schedule", "hier",
                                                           "--topology", "2,4"])
        assert report.ok, [i.message for i in report.issues]
        assert (report.geometry["sched_schedule"], report.geometry["sched_kernel"]) == (
            "hier", "devicegen")
        assert report.geometry["sched_dcn_bytes"] > 0

    def test_accepts_pod_topology(self, ref_sched):
        report = _plan("spark_examples_tpu_torch", BASE + ["--topology", "32,8"])
        assert report.ok, [i.message for i in report.issues]
        assert report.geometry["sched_schedule"] == "hier"
        assert report.geometry["sched_rows"] == 4001
        assert report.geometry["sched_critical_path_seconds"] > 0
        ref = _plan("spark_examples_tpu", BASE + ["--topology", "32,8"])
        assert _sched_geometry(report) == _sched_geometry(ref)
        assert report.geometry["sched_dcn_bytes"] == 8126464

    @pytest.mark.parametrize("budget,codes", [("1e-12", ["sched-GS005"]), ("60", [])])
    def test_pod_budget(self, budget, codes):
        report = _plan("spark_examples_tpu_torch",
                       BASE + ["--topology", "32,8", "--sched-budget-seconds", budget])
        assert [i.code for i in report.issues] == codes
        assert report.geometry["sched_critical_path_seconds"] < 60

    def test_pod_devices_mismatch_is_rejected_before_recording(self):
        report = _plan("spark_examples_tpu_torch",
                       BASE + ["--topology", "32,8", "--plan-devices", "8"])
        assert "topology-devices-mismatch" in [i.code for i in report.issues]
        assert "sched_schedule" not in report.geometry

    def test_explicit_dense_strategy_not_falsely_proven(self):
        report = _plan("spark_examples_tpu_torch",
                       BASE + ["--similarity-strategy", "dense", "--topology", "32,8"])
        assert report.ok and "sched_schedule" not in report.geometry
        assert [i.code for i in report.issues] == ["sched-not-applicable"]

    def test_hier_env_override_validated_offline(self, monkeypatch):
        from spark_examples_tpu_torch.parallel.mesh import HIER_HOSTS_ENV

        argv = BASE + ["--reduce-schedule", "hier", "--mesh-shape", "1,8", "--plan-devices", "8",
                       "--similarity-strategy", "sharded"]
        monkeypatch.setenv(HIER_HOSTS_ENV, "3")
        assert "hier-hosts-samples-axis" in [
            i.code for i in _plan("spark_examples_tpu_torch", argv).issues]
        monkeypatch.setenv(HIER_HOSTS_ENV, "4")
        report = _plan("spark_examples_tpu_torch", argv)
        assert report.ok, [i.message for i in report.issues]

    def test_topology_grammar_rejection(self):
        from spark_examples_tpu_torch.check.plan import parse_plan_args

        with pytest.raises(ValueError):
            parse_plan_args(BASE + ["--topology", "pod"])

    def test_plan_cli_exit_codes(self):
        from spark_examples_tpu_torch.check.cli import main

        assert _run(main, ["plan", *BASE, "--topology", "2,4"])[0] == 0
        assert _run(main, ["plan", *BASE, "--topology", "2,4", "--reduce-schedule", "flat"])[0] == 2
        assert _run(main, ["plan", *BASE, "--topology", "bad"])[0] == 2

    def test_cost_model_reads_the_critical_path(self):
        from spark_examples_tpu_torch.check.plan import parse_plan_args, predict_job_cost

        conf, *_ = parse_plan_args(BASE)
        cost = predict_job_cost(conf, Topology(2, 4), plan_devices=8)
        assert cost.sched_seconds is not None and cost.sched_seconds > 0
        assert predict_job_cost(conf).sched_seconds is None
