"""``graftcheck ranges`` of the port (``check/ranges.py``), the plan's
exactness audit and ``--check-ranges``, on the CPU.

The reference's prover steps only into ``pjit`` equations, which this
image's JAX names ``jit``, and stops at the ``pvary`` it inserts in
``shard_map``; under ``reference_range_shims`` (those two, beside the two
of ``tests/test_torch_ir.py``'s ``reference_jax_shims``) it traces all 27
kernels. Its dense, counts and stacked kernels are oracles for every fact.
On the rings its disjoint-slice refinement does not engage under this
JAX, so its ``entry_increment`` equals its conservative bound and it
reports GR005 on every 1×S and two-level mesh; the port's ring increments
are held to the closed form its own tests assert (one product partial an
entry a ring pass), every other ring fact to the reference's run. Each GR
rule fires on a mutant written in the port's idiom, and each transfer
function is held against the kernel's plain version on extreme inputs.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch.check import ranges
from spark_examples_tpu_torch.check.ir import Update, record_update
from spark_examples_tpu_torch.check.ranges import (
    Prover,
    RangeKernelSpec,
    audit_range_kernel,
    default_specs,
    dense_range_spec,
    devicegen_range_spec,
    ring_range_spec,
    run_audit,
)
from spark_examples_tpu_torch.ops.contracts import (
    COUNT_ROW,
    HAS_VARIATION,
    PACKED_BYTE,
    SITE_INDEX,
    exact_int_window,
)

INT32_WINDOW = exact_int_window(np.int32)
F32_WINDOW = exact_int_window(np.float32)
TOPOLOGY = ((2, 4),)
#: The six kernels whose every fact the reference's run proves.
DENSE_KINDS = ("ranges:dense[", "ranges:dense-counts[", "ranges:stacked[")


def _ids(audit):
    return sorted({f.rule_id for f in audit.findings})


@contextlib.contextmanager
def _reference_range_shims():
    """The reference's range prover under this image's JAX: ``AbstractMesh``
    takes ``(sizes, names)``, the ring audit finds ``jit`` where it looks
    for ``pjit`` (``tests/test_torch_ir.py:reference_jax_shims``), the
    interpreter descends into ``jit`` equations and passes ``pvary`` on.
    Adapted in this process only, for the block."""
    import jax.sharding

    from spark_examples_tpu.check import ir as ref_ir
    from spark_examples_tpu.check import ranges as ref_ranges

    base = jax.sharding.AbstractMesh

    class AbstractMesh(base):
        def __init__(self, shape, axis_names=None, *args, **kwargs):
            if axis_names is None:
                sizes = tuple(size for _, size in shape)
                axis_names = tuple(name for name, _ in shape)
                shape = sizes
            super().__init__(shape, axis_names, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.sharding, "AbstractMesh", AbstractMesh)
        mp.setattr(ref_ir, "_find_top_pjit", lambda jaxpr: next(
            (e for e in jaxpr.eqns if e.primitive.name in ("pjit", "jit")), None))
        mp.setattr(ref_ranges.Interpreter, "_prim_jit", ref_ranges.Interpreter._descend,
                   raising=False)
        mp.setattr(ref_ranges, "_PASSTHROUGH", ref_ranges._PASSTHROUGH | {"pvary"})
        yield ref_ranges


@pytest.fixture
def reference_range_shims():
    with _reference_range_shims() as ref_ranges:
        yield ref_ranges


@pytest.fixture(scope="module")
def reference_facts():
    """The reference's audit of its matrix with ``--topology 2,4``, under
    the shims: ``{name: facts}`` in its order."""
    with _reference_range_shims() as ref_ranges:
        report = ref_ranges.run_audit(ref_ranges.default_specs(topologies=TOPOLOGY))
    return {a.name: a.facts for a in report.audits}


@pytest.fixture(scope="module")
def port_report():
    return run_audit(default_specs(topologies=TOPOLOGY))


# --------------------------------------------------------------------------
# The shipped matrix against the reference's.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("topologies,count", [((), 24), (TOPOLOGY, 27)])
def test_matrix_names_and_counts_are_the_references(topologies, count):
    from spark_examples_tpu.check import ranges as ref_ranges

    names = [s.name for s in default_specs(topologies=topologies)]
    assert names == [s.name for s in ref_ranges.default_specs(topologies=topologies)]
    assert len(names) == count


def test_matrix_is_clean(port_report):
    assert port_report.ok, port_report.format()
    assert port_report.format().endswith("graftcheck ranges: 27 kernel(s), clean")
    for audit in port_report.audits:
        assert audit.facts["accum_dtype"] == "int32"
        assert "unhandled_primitives" not in audit.facts


def test_the_reference_under_its_shims_proves_the_dense_products(reference_facts):
    """The oracle is real: the shimmed reference reads nonzero partials."""
    assert reference_facts["ranges:dense[data=1,N=64,B=8]"]["dot_partial_bound"] == 8.0
    assert reference_facts["ranges:dense-counts[data=1,N=64,B=8]"]["dot_partial_bound"] == 128.0


def _dense_names():
    return [s.name for s in default_specs(topologies=TOPOLOGY) if s.name.startswith(DENSE_KINDS)]


def _ring_names():
    return [s.name for s in default_specs(topologies=TOPOLOGY)
            if not s.name.startswith(DENSE_KINDS)]


@pytest.mark.parametrize("name", _dense_names())
def test_dense_counts_and_stacked_facts_equal_the_references(name, port_report,
                                                             reference_facts):
    """Every fact equals the reference's; ``accum_dtype`` is the port's one
    int32 accumulator (the kept divergence of ROADMAP.md §3)."""
    facts = next(a.facts for a in port_report.audits if a.name == name)
    ref = dict(reference_facts[name])
    assert ref.pop("accum_dtype") == "float32" and facts["accum_dtype"] == "int32"
    assert {k: v for k, v in facts.items() if k != "accum_dtype"} == ref


@pytest.mark.parametrize("name", _ring_names())
def test_ring_facts_equal_the_references_and_the_closed_form(name, port_report,
                                                             reference_facts):
    """The ring facts the reference proves under this JAX are its; the
    increment is one partial an entry a pass: B × hi² × passes (8 for the
    ring, 128 for the count-valued ring, 16 for the generation ring at
    K = 2), where the reference's unengaged refinement reports its
    conservative bound."""
    facts = next(a.facts for a in port_report.audits if a.name == name)
    ref = reference_facts[name]
    for key in ("dot_partial_bound", "flush_projection", "entry_increment_conservative",
                "exactness_headroom_sites", "gramian_entry_bound", "declared_rows",
                "input_contracts"):
        assert facts[key] == ref[key], key
    hi = COUNT_ROW.hi if name.endswith(",counts]") else HAS_VARIATION.hi
    passes = 2 if "K=2" in name else 1
    assert facts["entry_increment"] == 8 * hi * hi * passes
    assert ref["entry_increment"] == ref["entry_increment_conservative"]
    assert facts["entry_increment"] <= facts["flush_projection"]


def test_rules_and_contracts_are_the_references():
    from spark_examples_tpu.check.rules import RANGES_RULES as ref_rules
    from spark_examples_tpu.ops import contracts as ref_contracts
    from spark_examples_tpu_torch.check.rules import ALL_RULES, RANGES_RULES
    from spark_examples_tpu_torch.ops import contracts

    assert [(r.id, r.name, r.summary, r.scope) for r in RANGES_RULES.values()] == [
        (r.id, r.name, r.summary, r.scope) for r in ref_rules.values()]
    assert all(ALL_RULES[rule_id] is rule for rule_id, rule in RANGES_RULES.items())
    as_tuples = lambda cs: [(k, c.name, c.lo, c.hi, c.description, c.integral)  # noqa: E731
                            for k, c in cs.items()]
    assert as_tuples(contracts.CONTRACTS) == as_tuples(ref_contracts.CONTRACTS)
    for name in ("GENOTYPE", "HAS_VARIATION", "COUNT_ROW", "ALLELE_FREQUENCY", "PACKED_BYTE",
                 "SITE_INDEX"):
        assert dataclasses.astuple(getattr(contracts, name)) == dataclasses.astuple(
            getattr(ref_contracts, name))


def test_json_and_text_reports_keep_the_references_shape(port_report, reference_range_shims):
    ref_ranges = reference_range_shims
    specs = [s for s in ref_ranges.default_specs() if s.name.startswith("ranges:dense[data=1")]
    ref = json.loads(ref_ranges.run_audit(specs).to_json())
    port = json.loads(run_audit([dense_range_spec(1, 64, 8)]).to_json())
    assert list(port) == list(ref) and port["tool"] == "graftcheck-ranges"
    assert list(port["kernels"][0]) == list(ref["kernels"][0])
    assert list(port["kernels"][0]["facts"]) == list(ref["kernels"][0]["facts"])
    by_name = {a.name: a for a in port_report.audits}
    ring = by_name["ranges:ring[data=1,samples=4,N=64,B=8,pack=on][int8]"]
    assert list(ring.facts) == ["input_contracts", "accum_dtype", "dot_partial_bound",
                                "entry_increment", "entry_increment_conservative",
                                "flush_projection", "gramian_entry_bound", "declared_rows",
                                "exactness_headroom_sites"]
    line = ("  proved: ranges:ring[data=1,samples=4,N=64,B=8,pack=on][int8]: partial ≤ 8, "
            "entry increment ≤ 8/flush (projection 8), headroom f32 16777216 / int32 "
            "2147483647 sites")
    assert line in port_report.format().splitlines()


def _cli(pkg, argv):
    import importlib

    cli = importlib.import_module(f"{pkg}.check.cli")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["ranges", *argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["--mesh", "0,2"], ["--mesh", "1"], ["--topology", "2"],
                                  ["--topology", "0,4"]])
def test_cli_grammar_errors_exit_2_as_the_references(argv):
    ref_rc, _, ref_err = _cli("spark_examples_tpu", argv)
    rc, out, err = _cli("spark_examples_tpu_torch", argv)
    assert rc == ref_rc == 2 and not out
    assert err.splitlines()[-1] == ref_err.splitlines()[-1]


def test_cli_json_and_meshes():
    rc, out, _ = _cli("spark_examples_tpu_torch", ["--json", "--mesh", "1,2", "--topology", "2,2"])
    report = json.loads(out)
    assert rc == 0 and report["ok"] and report["finding_count"] == 0
    assert [k["kernel"] for k in report["kernels"]][-1] == (
        "ranges:devicegen-hier[data=1,hosts=2,devices=2,N=64,B=8,K=2,pack=on]")
    assert report["kernel_count"] == 2 + 2 + 6 + 3
    rc, out, _ = _cli("spark_examples_tpu_torch", ["--num-samples", "100", "--block-size", "16",
                                                   "--mesh", "1,4"])
    assert rc == 0 and out.endswith("graftcheck ranges: 10 kernel(s), clean\n")


def test_the_audit_touches_no_card(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the range audit asked CUDA")

    for fn in ("is_available", "device_count", "mem_get_info", "get_device_properties",
               "synchronize", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    report = run_audit(default_specs(meshes=((2, 2),), topologies=((2, 2),)))
    assert report.ok and not torch.cuda.is_initialized()


# --------------------------------------------------------------------------
# One mutant a rule.
# --------------------------------------------------------------------------


def _raise():
    raise RuntimeError("planted build failure")


def test_gr000_a_build_that_raises():
    spec = RangeKernelSpec("ranges:broken", _raise, (None, PACKED_BYTE))
    audit = audit_range_kernel(spec)
    assert _ids(audit) == ["GR000"] and "planted build failure" in audit.findings[0].detail
    assert audit.facts == {}


def test_gr001_declared_geometry_past_int32():
    spec = dense_range_spec(1, 64, 8)
    spec.declared_rows = 1 << 31
    audit = audit_range_kernel(spec)
    assert _ids(audit) == ["GR001"] and audit.facts["gramian_entry_bound"] == 1 << 31


def _bytes_to_product():
    """Bit-packed wire bytes fed straight to a product: the count-valued
    unpack takes them as values (its device-read guard waved past)."""
    from spark_examples_tpu_torch.ops.devicegen import gram_accumulate
    from spark_examples_tpu_torch.ops.gramian import MAX_INT8_COUNT, unpack_rows_t

    X = torch.from_numpy(np.packbits(np.ones((8, 64), dtype=np.uint8), axis=-1))
    G = torch.zeros((8, 8), dtype=torch.int32)
    return Update(lambda: gram_accumulate(G, unpack_rows_t(X, 8, counts=True,
                                                           max_count=MAX_INT8_COUNT)), (G,))


def test_gr001_packed_bytes_fed_straight_to_a_product():
    audit = audit_range_kernel(RangeKernelSpec("ranges:bytes", _bytes_to_product,
                                               (None, PACKED_BYTE), rows_per_flush=8,
                                               max_count=PACKED_BYTE.hi))
    assert _ids(audit) == ["GR001"]
    assert "exceeds the int8 exact-integer window (127)" in audit.findings[0].detail


def _float_accumulator_counts(rows):
    def build():
        from spark_examples_tpu_torch.ops.gramian import dense_update_counts

        G = torch.zeros((16, 16), dtype=torch.int32, device="meta")
        X = torch.empty((rows, 16), dtype=torch.uint8, device="meta")
        return Update(lambda: dense_update_counts(G, X, max_count=COUNT_ROW.hi), (G,))

    return RangeKernelSpec("ranges:f32-counts", build, (None, COUNT_ROW), rows_per_flush=rows,
                           max_count=COUNT_ROW.hi, operand_window_dtype="bfloat16",
                           accum_dtype="float32")


def test_gr002_a_float32_partial_past_its_window():
    rows = (1 << 20) + 128  # × COUNT_ROW.hi² = 16: past 2^24
    audit = audit_range_kernel(_float_accumulator_counts(rows))
    assert _ids(audit) == ["GR002"]
    assert audit.facts["dot_partial_bound"] == rows * 16 > F32_WINDOW
    assert audit_range_kernel(_float_accumulator_counts(1 << 20)).ok  # exactly 2^24


def _narrowed_accumulator(block_size):
    def build():
        from spark_examples_tpu_torch.ops.gramian import dense_update

        G = torch.zeros((64, 64), dtype=torch.int32)
        X = torch.from_numpy(np.packbits(np.ones((block_size, 64), dtype=np.uint8), axis=-1))

        def run():
            dense_update(G, X, 64)
            G.to(torch.int8)

        return Update(run, (G,))

    return RangeKernelSpec("ranges:narrowed", build, (None, PACKED_BYTE),
                           rows_per_flush=block_size)


def test_gr003_an_int32_accumulator_cast_to_int8_between_kernels():
    audit = audit_range_kernel(_narrowed_accumulator(256))
    assert _ids(audit) == ["GR003"] and "int32→int8" in audit.findings[0].detail
    assert audit_range_kernel(_narrowed_accumulator(120)).ok  # 120 fits int8
    # The plan records without the watch: no cast is seen there.
    assert audit_range_kernel(_narrowed_accumulator(256), watch=False).ok


def test_gr004_an_uncontracted_input():
    spec = dense_range_spec(1, 64, 8)
    spec.input_contracts = (None, None)
    audit = audit_range_kernel(spec)
    assert _ids(audit) == ["GR004"]
    dg = devicegen_range_spec(1, 2, 64, 8)
    dg.input_contracts = (None, SITE_INDEX, None, SITE_INDEX, SITE_INDEX)
    assert _ids(audit_range_kernel(dg)) == ["GR004"]


def _ring_on_own_columns(positions, own, ready, mine, G_local, n_local, packed, hosts=1,
                         max_count=None):
    """A ``ring_pass`` whose every step adds into the position's own
    columns: one entry takes a partial a step, not a pass."""
    from spark_examples_tpu_torch.ops.devicegen import cross_accumulate

    for _ in range(len(positions)):
        for p, pos in enumerate(positions):
            if pos.local:
                with pos.run():
                    cross_accumulate(G_local[p][:, p * n_local : (p + 1) * n_local],
                                     mine[p], mine[p])


@pytest.mark.parametrize("samples", [2, 4])
def test_gr005_a_ring_whose_steps_write_the_owners_own_columns(samples, monkeypatch):
    from spark_examples_tpu_torch.ops import gramian

    spec = ring_range_spec(1, samples, 64, 8, True, True)
    assert audit_range_kernel(spec).ok
    monkeypatch.setattr(gramian, "ring_pass", _ring_on_own_columns)
    audit = audit_range_kernel(ring_range_spec(1, samples, 64, 8, True, True))
    assert _ids(audit) == ["GR005"]
    assert audit.facts["entry_increment"] == audit.facts["entry_increment_conservative"] == (
        8 * samples)
    dg = audit_range_kernel(devicegen_range_spec(1, samples, 64, 8))
    assert _ids(dg) == ["GR005"] and dg.facts["entry_increment"] == 2 * 8 * samples


def test_a_generated_slice_padded_with_zero_columns_keeps_its_support():
    """At 260 samples over 2 positions the last slice's generated Xᵀ (124
    columns) is padded to its position's 256 rows by a ``cat`` between
    kernels: the copy keeps the block's 8 sites, so the partial stays 8."""
    audit = audit_range_kernel(devicegen_range_spec(1, 2, 260, 8))
    assert audit.ok and audit.facts["dot_partial_bound"] == 8
    assert audit.facts["entry_increment"] == 16


def test_gr005_an_accumulator_written_outside_a_product():
    def build():
        from spark_examples_tpu_torch.ops.gramian import dense_update

        G = torch.zeros((64, 64), dtype=torch.int32)
        X = torch.from_numpy(np.packbits(np.ones((8, 64), dtype=np.uint8), axis=-1))

        def run():
            dense_update(G, X, 64)
            G.add_(1)

        return Update(run, (G,))

    audit = audit_range_kernel(RangeKernelSpec("ranges:clobbered", build, (None, PACKED_BYTE),
                                               rows_per_flush=8))
    assert _ids(audit) == ["GR005"] and audit.facts["entry_increment"] is None


# --------------------------------------------------------------------------
# Each transfer function is honest: plain versions on extreme inputs.
# --------------------------------------------------------------------------


def _prove(run, accumulators, contract):
    trace = record_update(Update(run, accumulators))
    return trace, Prover(trace, (None, contract)).run()


def _holds(prover, tensor, storage):
    val = prover.values[storage]
    t = tensor.to(torch.int64)
    return val.lo <= int(t.min()) and int(t.max()) <= val.hi


@pytest.mark.parametrize("rows", [1, 8, 130])
def test_bit_unpack_and_product_reach_their_bound(rows):
    """All bits set: Xᵀ lies in [0, 1] and zero past the rows handed, and
    the product's largest entry is exactly support × 1²."""
    from spark_examples_tpu_torch.ops.devicegen import gram_accumulate
    from spark_examples_tpu_torch.ops.gramian import unpack_rows_t

    X = torch.full((rows, 8), 255, dtype=torch.uint8)
    G = torch.zeros((64, 64), dtype=torch.int32)
    out = {}

    def run():
        out["xt"] = unpack_rows_t(X, 64)
        gram_accumulate(G, out["xt"])

    trace, prover = _prove(run, (G,), PACKED_BYTE)
    unpack = trace.ops[0]
    assert unpack.support == rows and _holds(prover, out["xt"], unpack.results[0].storage)
    assert not out["xt"][:, rows:].any()
    assert int(G.max()) == prover.dots[0].out.hi == rows


@pytest.mark.parametrize("counts", [True, False])
def test_count_unpack_and_product_reach_their_bound(counts):
    """Counts at COUNT_ROW.hi: the largest entry is support × hi²."""
    from spark_examples_tpu_torch.ops.gramian import dense_update_counts

    hi = COUNT_ROW.hi if counts else HAS_VARIATION.hi
    X = torch.full((8, 64), hi, dtype=torch.uint8)
    G = torch.zeros((64, 64), dtype=torch.int32)
    _, prover = _prove(lambda: dense_update_counts(G, X, max_count=hi), (G,),
                       COUNT_ROW if counts else HAS_VARIATION)
    assert int(G.max()) == prover.dots[0].out.hi == 8 * hi * hi


def test_stacked_unpack_and_product_reach_their_bound():
    from spark_examples_tpu_torch.ops.batched import (
        stacked_gram_accumulate,
        stacked_unpack_rows_t,
    )

    X = torch.full((3, 8, 8), 255, dtype=torch.uint8)
    G = torch.zeros((3, 64, 64), dtype=torch.int32)
    out = {}

    def run():
        out["xt"] = stacked_unpack_rows_t(X, 64)
        stacked_gram_accumulate(G, out["xt"])

    trace, prover = _prove(run, (G,), PACKED_BYTE)
    assert _holds(prover, out["xt"], trace.ops[0].results[0].storage)
    assert int(G.max()) == prover.dots[0].out.hi == 8
    assert audit_range_kernel(RangeKernelSpec("s", lambda: Update(run, (G,)), (None, PACKED_BYTE),
                                              rows_per_flush=8)).facts["entry_increment"] == 8


def test_pack_and_transpose_hold_their_values():
    from spark_examples_tpu_torch.ops.gramian import pack_rows_t, transpose_rows_t

    xt = torch.ones((128, 128), dtype=torch.int8)
    out = {}

    def run():
        out["packed"] = pack_rows_t(xt, 64, rows=8)
        out["rows"] = transpose_rows_t(xt, 64, rows=8)

    trace, prover = _prove(run, (), HAS_VARIATION)
    assert int(out["packed"].max()) == 255 and int(out["rows"].max()) == 1
    for op, key in zip(trace.ops, ("packed", "rows")):
        assert _holds(prover, out[key], op.results[0].storage)


def test_generation_holds_its_interval_and_support():
    from spark_examples_tpu_torch.ops.devicegen import gen_genotypes, make_gen_plan

    plan = make_gen_plan([0x5EED], [np.zeros(64, dtype=np.int32)], 0xFACADE, 100, 0.0, None, 1,
                         torch.device("cpu"))
    kept, rows = torch.zeros((), dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    out = {}

    def run():
        out["xt"] = gen_genotypes(plan, 0, 40, 40, kept, rows)

    trace, prover = _prove(run, (), SITE_INDEX)
    prover.scalars_contracted = True
    op = trace.ops[0]
    assert op.support == 40 and _holds(prover, out["xt"], op.results[0].storage)
    assert int(out["xt"].max()) == 1 and not out["xt"][:, 40:].any()


@pytest.mark.parametrize("pack,counts", [(True, False), (False, False), (False, True)])
def test_ring_entries_reach_the_proven_increment(pack, counts, monkeypatch):
    """Every row set (counts at COUNT_ROW.hi): each entry of the ring's
    tiles is exactly the proven increment, B × hi² — one partial a pass."""
    from spark_examples_tpu_torch.check import ir

    hi = COUNT_ROW.hi if counts else 1
    monkeypatch.setattr(ir, "_bits", lambda shape: np.full(shape, hi, dtype=np.uint8))
    monkeypatch.setattr(ir, "_COUNTS_MAX", 1)
    spec = ring_range_spec(1, 4, 64, 8, pack, True, counts=counts)
    update = spec.build()
    trace = record_update(update)
    audit = audit_range_kernel(spec, traced=trace)
    assert audit.ok
    G = torch.cat([t for t in update.accumulators])[:64, :64]
    assert int(G.min()) == int(G.max()) == audit.facts["entry_increment"] == 8 * hi * hi


# --------------------------------------------------------------------------
# The plan's exactness audit (the reference's test_graftcheck_ranges.py
# plan cases, each held against the reference's plan where it runs).
# --------------------------------------------------------------------------


def _plans(args, devices=1):
    from spark_examples_tpu.check.plan import validate_plan as ref_validate
    from spark_examples_tpu.config import PcaConf as RefConf
    from spark_examples_tpu_torch.check.plan import validate_plan
    from spark_examples_tpu_torch.config import PcaConf

    with _reference_range_shims():
        ref = ref_validate(RefConf.parse(args), plan_devices=devices)
    return ref, validate_plan(PcaConf.parse(args + ["--device", "cpu"]), plan_devices=devices)


def test_plan_reports_exactness_facts():
    ref, report = _plans(["--num-samples", "64", "--references", "1:0:50000"])
    assert report.ok and ref.ok
    assert report.geometry["exactness_headroom_sites"] == ref.geometry[
        "exactness_headroom_sites"] == {"float32": F32_WINDOW, "int32": INT32_WINDOW}
    assert report.geometry["gramian_entry_bound"] == ref.geometry["gramian_entry_bound"] == 501
    line = ("range audit (1 kernel(s)): per-dispatch partial <= 1024 exact, entry increment "
            "<= 1024/flush, flush projection proven conservative (GR005)")
    assert line in report.shape_checks
    assert any("range audit (1 kernel(s))" in line for line in ref.shape_checks)


def test_plan_headroom_shrinks_with_duplicate_sets():
    ref, report = _plans(["--num-samples", "64", "--references", "1:0:50000;1:0:50000",
                          "--variant-set-id", "a,a"])
    assert report.geometry["exactness_headroom_sites"] == ref.geometry["exactness_headroom_sites"]
    assert report.geometry["exactness_headroom_sites"]["float32"] == F32_WINDOW // 4
    assert any(line.startswith("range audit (2 kernel(s)): per-dispatch partial <= 16384 exact")
               for line in report.shape_checks)


@pytest.mark.parametrize("pack", ["auto", "off"])
def test_plan_sharded_duplicate_ids_audits_counts_ring(pack):
    """The count-valued unpacked ring is proven beside the configured one.
    The reference's only rejection here is its own ring GR005 (its
    refinement does not engage under this JAX)."""
    args = ["--num-samples", "64", "--references", "1:0:50000;1:0:50000",
            "--variant-set-id", "a,a", "--mesh-shape", "1,4", "--similarity-strategy",
            "sharded", "--ring-pack-bits", pack]
    ref, report = _plans(args, devices=4)
    assert report.ok, [i.format() for i in report.issues]
    assert {i.code for i in ref.issues if i.severity == "error"} == {"ranges-GR005"}
    assert report.geometry["exactness_headroom_sites"] == ref.geometry["exactness_headroom_sites"]
    assert any(line.startswith("range audit (2 kernel(s)): per-dispatch partial <= 16384 exact, "
                               "entry increment <= 16384/flush") for line in report.shape_checks)


def test_plan_exactness_boundary_geometry():
    at_window = (INT32_WINDOW - 1) * 100
    base = ["--num-samples", "64", "--bases-per-partition", "1000000000000"]
    ref, accept = _plans(base + ["--references", f"1:0:{at_window}"])
    assert accept.ok and ref.ok, [i.format() for i in accept.issues]
    assert accept.geometry["gramian_entry_bound"] == ref.geometry["gramian_entry_bound"] == (
        INT32_WINDOW)
    ref, reject = _plans(base + ["--references", f"1:0:{at_window + 100}"])
    assert not reject.ok and not ref.ok
    assert {i.code for i in reject.issues if i.severity == "error"} == {
        i.code for i in ref.issues if i.severity == "error"} == {"exactness-window"}


def test_plan_partial_windows_are_the_int32_accumulators():
    """The reference rejects a partial past 2^24 on its float32 path
    (ranges-GR002); the port accumulates int32 from the first flush, so the
    same block is exact, and only a partial past 2^31 - 1 rejects
    (ranges-GR001)."""
    from spark_examples_tpu_torch.check.plan import validate_plan
    from spark_examples_tpu_torch.config import PcaConf

    f32_args = ["--num-samples", "8", "--references", "1:0:50000",
                "--block-size", str((1 << 24) + 8)]
    ref, report = _plans(f32_args)
    assert {i.code for i in ref.issues} >= {"ranges-GR002"} and not ref.ok
    assert report.ok, [i.format() for i in report.issues]
    past = validate_plan(PcaConf.parse(["--num-samples", "8", "--references", "1:0:50000",
                                        "--block-size", str(1 << 31), "--device", "cpu"]))
    assert not past.ok and "ranges-GR001" in {i.code for i in past.issues}


def test_plan_file_source_has_no_static_entry_bound():
    ref, report = _plans(["--source", "file", "--input-files", "cohort.vcf",
                          "--references", "1:0:50000"])
    assert report.ok and ref.ok
    assert report.geometry["gramian_entry_bound"] is ref.geometry["gramian_entry_bound"] is None
    assert report.geometry["exactness_headroom_sites"]["int32"] > 0


def test_plan_exactness_cli_exit_2():
    from spark_examples_tpu.check import cli as ref_cli
    from spark_examples_tpu_torch.check import cli

    argv = ["plan", "--num-samples", "64", "--references", f"1:0:{INT32_WINDOW * 100}",
            "--bases-per-partition", "1000000000000"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == ref_cli.main(argv) == 2


def test_plan_range_audit_reuses_the_rings_recording(monkeypatch):
    """A sharded admission records its ring once: the range audit reads
    the schedule the ring audit recorded."""
    from spark_examples_tpu_torch.check import ir, plan
    from spark_examples_tpu_torch.config import PcaConf

    calls = []
    real = ir.record_update
    monkeypatch.setattr(ir, "record_update", lambda *a, **k: calls.append(1) or real(*a, **k))
    conf = PcaConf.parse(["--num-samples", "2504", "--references", "17:0:81195210",
                          "--mesh-shape", "1,4", "--similarity-strategy", "sharded",
                          "--block-size", "16384", "--device", "cpu"])
    report = plan.validate_plan(conf, plan_devices=4)
    assert report.ok and len(calls) == 3  # the dense and counts updates, the ring
    assert any(line.startswith("range audit (1 kernel(s)): per-dispatch partial <= 16384")
               for line in report.shape_checks)


# --------------------------------------------------------------------------
# --check-ranges: the runtime half.
# --------------------------------------------------------------------------


def _rows(n, rows=32, seed=0):
    return (np.random.RandomState(seed).rand(rows, n) > 0.5).astype(np.uint8)


def test_check_ranges_sampling_measured_within_bound():
    """The reference's case: the same rows give the same sampled maximum
    and bound in both packages."""
    from spark_examples_tpu.obs import metrics as ref_metrics
    from spark_examples_tpu.ops.gramian import GramianAccumulator as RefAccumulator
    from spark_examples_tpu_torch.obs.metrics import (
        GRAMIAN_ENTRY_MAX,
        GRAMIAN_STATIC_ENTRY_BOUND,
        MetricsRegistry,
    )
    from spark_examples_tpu_torch.ops.gramian import GramianAccumulator

    registry, ref_registry = MetricsRegistry(), ref_metrics.MetricsRegistry()
    acc = GramianAccumulator(8, device="cpu", block_size=4, check_ranges=True, registry=registry)
    ref = RefAccumulator(8, block_size=4, check_ranges=True, registry=ref_registry)
    for a in (acc, ref):
        a.add_rows(_rows(8))
        a.finalize()
    measured = registry.value(GRAMIAN_ENTRY_MAX)
    bound = registry.value(GRAMIAN_STATIC_ENTRY_BOUND)
    assert measured == ref_registry.value(ref_metrics.GRAMIAN_ENTRY_MAX) > 0
    assert bound == ref_registry.value(ref_metrics.GRAMIAN_STATIC_ENTRY_BOUND) == acc._entry_bound
    assert measured <= bound and acc.telemetry.entry_max_seen == measured


def test_check_ranges_off_registers_nothing():
    from spark_examples_tpu_torch.obs.metrics import GRAMIAN_ENTRY_MAX, MetricsRegistry
    from spark_examples_tpu_torch.ops.gramian import GramianAccumulator

    registry = MetricsRegistry()
    acc = GramianAccumulator(8, device="cpu", block_size=4, registry=registry)
    acc.add_rows(np.ones((8, 8), dtype=np.uint8))
    acc.finalize()
    assert registry.value(GRAMIAN_ENTRY_MAX) is None and acc.telemetry.entry_max_seen == 0


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_check_ranges_samples_the_rings_tiles(mesh):
    """On the ring the sample is the max over the row tiles; its Gramian
    and its bound are the dense accumulator's on the same rows."""
    from spark_examples_tpu_torch.check.ir import _mesh
    from spark_examples_tpu_torch.obs.metrics import (
        GRAMIAN_ENTRY_MAX,
        GRAMIAN_STATIC_ENTRY_BOUND,
        MetricsRegistry,
    )
    from spark_examples_tpu_torch.ops.gramian import GramianAccumulator, ShardedGramianAccumulator

    rows = _rows(21, rows=40, seed=1)
    registry, dense_registry = MetricsRegistry(), MetricsRegistry()
    ring = ShardedGramianAccumulator(21, _mesh(*mesh), block_size=4, registry=registry,
                                     check_ranges=True)
    dense = GramianAccumulator(21, device="cpu", block_size=4 * mesh[0],
                               registry=dense_registry, check_ranges=True)
    for a in (ring, dense):
        a.add_rows(rows)
    G = ring.finalize()
    assert np.array_equal(G, dense.finalize())
    if mesh[0] == 1:
        assert registry.value(GRAMIAN_ENTRY_MAX) == dense_registry.value(GRAMIAN_ENTRY_MAX) == (
            G.max())
    assert registry.value(GRAMIAN_STATIC_ENTRY_BOUND) == dense_registry.value(
        GRAMIAN_STATIC_ENTRY_BOUND) == ring._entry_bound
    assert 0 < registry.value(GRAMIAN_ENTRY_MAX) <= ring._entry_bound


def test_manifest_gramian_exactness_block_and_validation():
    from spark_examples_tpu.obs import manifest as ref_manifest
    from spark_examples_tpu_torch.obs.manifest import (
        build_manifest,
        build_run_manifest,
        validate_manifest,
    )
    from spark_examples_tpu_torch.obs.metrics import (
        GRAMIAN_ENTRY_MAX,
        GRAMIAN_STATIC_ENTRY_BOUND,
        MetricsRegistry,
        well_known_gauge,
    )

    doc = build_manifest()
    assert doc["gramian_exactness"] is None and validate_manifest(doc) == []
    registry = MetricsRegistry()
    well_known_gauge(registry, GRAMIAN_ENTRY_MAX).set(142)
    well_known_gauge(registry, GRAMIAN_STATIC_ENTRY_BOUND).set(335)
    doc = build_run_manifest(registry=registry)
    assert doc["gramian_exactness"] == {"entry_max": 142, "static_entry_bound": 335}
    assert validate_manifest(doc) == []
    bad = build_manifest(gramian_exactness={"entry_max": -1})
    errors = validate_manifest(bad)
    assert errors == ref_manifest.validate_manifest(
        ref_manifest.build_manifest(gramian_exactness={"entry_max": -1}))
    assert any("entry_max" in e for e in errors)
    assert any("static_entry_bound" in e for e in errors)


@pytest.mark.parametrize("mesh", [["--num-reduce-partitions", "1"], ["--mesh-shape", "4,1"]])
def test_check_ranges_e2e_driver_run(mesh, tmp_path):
    """A packed driver run with --check-ranges writes measured <= proven
    (the reference's numbers on the same inputs: on a data axis, both
    sample the largest entry of a slice's partial), an ok ``ranges``
    conformance pair, and the Gramian of the same run without the flag."""
    from spark_examples_tpu.config import PcaConf as RefConf
    from spark_examples_tpu.obs.manifest import build_run_manifest as ref_manifest
    from spark_examples_tpu.pipeline import pca_driver as ref_driver
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    flags = ["--num-samples", "8", "--block-size", "8", "--references", "1:0:30000",
             "--ingest", "packed", *mesh]
    conf = RefConf.parse(flags + ["--check-ranges"])
    driver = ref_driver.VariantsPcaDriver(conf)
    similarity = ref_driver._similarity_stage(conf, driver, use_device=False, use_packed=True)
    driver.compute_pca(similarity)
    want = ref_manifest(conf=conf, registry=driver.registry)["gramian_exactness"]

    grams = {}
    for flag in ([], ["--check-ranges"]):
        path = tmp_path / f"m{len(flag)}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            result = run_pipeline(PcaConf.parse(flags + flag + ["--device", "cpu",
                                                                "--metrics-json", str(path)]))
        grams[len(flag)] = result.driver.accumulator.G.clone()
        assert result.driver.accumulator.data_parallel == (4 if "4,1" in mesh else 1)
        doc = read_manifest(str(path))
        assert validate_manifest(doc) == []
    assert torch.equal(grams[0], grams[1])
    got = doc["gramian_exactness"]
    assert got == want and 0 < got["entry_max"] <= got["static_entry_bound"]
    assert doc["conformance"]["ranges"] == {"measured": got["entry_max"],
                                            "proven": got["static_entry_bound"], "ok": True}
    assert read_manifest(str(tmp_path / "m0.json"))["gramian_exactness"] is None


def test_check_ranges_leaves_the_device_ring_unsampled(tmp_path):
    """The device-generation arms have no host flush to sample: the flag
    leaves their manifest's block null, as the reference's does."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs.manifest import read_manifest
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    path = tmp_path / "m.json"
    with contextlib.redirect_stdout(io.StringIO()):
        run_pipeline(PcaConf.parse(["--num-samples", "8", "--references", "1:0:30000",
                                    "--ingest", "device", "--check-ranges", "--device", "cpu",
                                    "--metrics-json", str(path)]))
    doc = read_manifest(str(path))
    assert doc["gramian_exactness"] is None and doc["conformance"]["ranges"] is None


def test_ranges_module_is_in_the_port_only():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ranges))
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert not any(n.split(".")[0] in ("jax", "spark_examples_tpu") for n in names)
