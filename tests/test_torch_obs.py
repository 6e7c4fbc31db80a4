"""The run's telemetry in the port against the JAX package's: the metrics
registry (histograms, quantiles, the Prometheus text), the schema-v2 run
manifest (``--metrics-json``), the heartbeat (``--heartbeat-seconds``) and
the stage report and device trace (``--profile-dir``).

The same observations go into both packages' registries and must give the
same quantiles and the same Prometheus text; the port's manifest of a small
run passes both packages' validators (and the reference's passes the
port's); heartbeat lines have the reference's format on the same registry
state; ``--profile-dir`` writes a ``torch.profiler`` trace on the CPU."""

import glob
import json
import re
import threading

import numpy as np
import pytest

from spark_examples_tpu.obs import heartbeat as ref_heartbeat
from spark_examples_tpu.obs import manifest as ref_manifest
from spark_examples_tpu.obs import metrics as ref_metrics
from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu.utils.tracing import StageTimes as RefStageTimes
from spark_examples_tpu_torch import run, run_pipeline
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.obs import heartbeat, manifest, metrics
from spark_examples_tpu_torch.obs.spans import SpanRecorder
from spark_examples_tpu_torch.utils.tracing import StageTimes, device_trace

BASE = ["--references", "17:0:20000", "--variant-set-id", "vs-a", "--num-samples", "8",
        "--seed", "5", "--bases-per-partition", "5000"]


def _vcf(tmp_path, n=5, rows=80):
    rng = np.random.default_rng(2)
    lines = ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(n))]
    for k in range(rows):
        gts = "\t".join(rng.choice(["0|0", "0|1", "1|1"]) for _ in range(n))
        lines.append(f"17\t{100 + 50 * k}\t.\tA\tG\t.\t.\tAF={rng.random():.3f}\tGT\t{gts}")
    path = tmp_path / "obs.vcf"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


# ------------------------------------------------------------------ registry


def _feed(module, seed):
    """The same observations and registrations into ``module``'s registry."""
    rng = np.random.default_rng(seed)
    reg = module.MetricsRegistry()
    hist = reg.histogram("flush_seconds", "Seconds per flush.")
    wide = reg.histogram("job_seconds", "Job wall.", labelnames=("kind",),
                         buckets=(0.5, 1.0, 10.0, 60.0, 300.0))
    for value in rng.exponential(0.05, 200):
        hist.observe(float(value))
    for value in rng.exponential(30.0, 50):
        wide.labels(kind="pca").observe(float(value))
    reg.counter("rows_total", 'Rows "seen"\nso far.').inc(17)
    reg.counter("by_set_total", "Per set.", labelnames=("set",)).labels(set='a"b\\c').inc(3)
    gauge = reg.gauge("depth", "Queue depth.")
    gauge.set(2.5)
    reg.gauge("sampled", "Sampled.").set_function(lambda: 4.0)
    reg.gauge("broken", "Raises.").set_function(lambda: 1 / 0)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_json_export_match_reference(seed):
    port, ref = _feed(metrics, seed), _feed(ref_metrics, seed)
    assert port.prometheus_text() == ref.prometheus_text()
    assert json.dumps(port.as_dict(), sort_keys=True) == json.dumps(ref.as_dict(), sort_keys=True)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match_reference(q):
    for seed in range(3):
        port, ref = _feed(metrics, seed), _feed(ref_metrics, seed)
        for name, labels in (("flush_seconds", None), ("job_seconds", {"kind": "pca"})):
            got = metrics.histogram_quantile(port.value(name, labels), q)
            want = ref_metrics.histogram_quantile(ref.value(name, labels), q)
            assert got == want


def test_histogram_quantile_edges():
    reg = metrics.MetricsRegistry()
    hist = reg.histogram("h", buckets=(1.0, 2.0))
    assert metrics.histogram_quantile(hist.value, 0.5) is None
    for value in (0.5, 1.5, 1.5, 99.0):
        hist.observe(value)
    assert metrics.histogram_quantile(hist.value, 0.5) == 1.5
    assert metrics.histogram_quantile(hist.value, 1.0) == 2.0


def test_registration_conflicts_and_function_gauges():
    reg = metrics.MetricsRegistry()
    reg.counter("x_total", labelnames=("a",))
    with pytest.raises(metrics.MetricError):
        reg.gauge("x_total")
    with pytest.raises(metrics.MetricError):
        reg.counter("x_total", labelnames=("b",))
    with pytest.raises(metrics.MetricError):
        reg.counter("bad name")
    gauge = reg.gauge("g")
    gauge.set_function(lambda: 3)
    with pytest.raises(metrics.MetricError, match="function-backed"):
        gauge.inc()
    assert reg.value("g") == 3


def test_registry_is_thread_safe():
    reg = metrics.MetricsRegistry()
    counter = reg.counter("n_total")
    hist = reg.histogram("h")

    def work():
        for _ in range(2000):
            counter.inc()
            hist.observe(0.01)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert reg.value("n_total") == 16000 and hist.value["count"] == 16000


# ------------------------------------------------------------------ heartbeat


def _heartbeat_lines(module, hb_module):
    reg = module.MetricsRegistry()
    sites = reg.gauge("ingest_sites_scanned")
    reg.gauge("ingest_partitions_planned").set(8)
    done = reg.counter("io_partitions_total")
    reg.gauge("prefetch_queue_depth").set(2)
    reg.gauge("prefetch_queue_occupancy").set(1)
    reg.gauge("gramian_inflight_dispatches").set(2)
    reg.gauge("host_peak_rss_bytes").set(3 << 29)
    clock = [0.0]
    hb = hb_module.Heartbeat(10.0, reg, emit=lambda line: None, clock=lambda: clock[0])
    hb._started_at = 0.0
    lines = []
    for step in range(1, 4):
        clock[0] = 7.0 * step
        sites.set(12_345 * step)
        done.inc(2)
        lines.append(hb.line())
    return lines


def test_heartbeat_lines_match_reference_format():
    """On the same registry state and clock, the port's lines are the
    reference's (no card here, so no device-memory segment in either)."""
    got = _heartbeat_lines(metrics, heartbeat)
    assert got == _heartbeat_lines(ref_metrics, ref_heartbeat)
    assert got[1] == (
        "heartbeat[14s]: 24,690 sites scanned (1.8k sites/s); partitions 4/8 "
        "(ETA 14s); prefetch queue 1/2; dispatch in-flight 2; host rss peak "
        "1.5 GiB/4.0 GiB bound"
    )


def test_heartbeat_with_nothing_registered_and_streamed_progress():
    reg, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for r in (reg, ref):
        r.gauge("ingest_partitions_planned").set(10)
        r.counter("io_partitions_total")
        r.gauge("ingest_partitions_done").set(4)
    lines = []
    for module, r in ((heartbeat, reg), (ref_heartbeat, ref)):
        hb = module.Heartbeat(10.0, r, emit=lambda line: None, clock=lambda: 100.0)
        hb._started_at = 0.0
        lines.append(hb.line())
    assert lines[0] == lines[1] == "heartbeat[100s]: partitions 4/10 (ETA 150s)"
    empty = heartbeat.Heartbeat(1.0, metrics.MetricsRegistry(), clock=lambda: 0.0)
    assert empty.line() == "heartbeat[0s]: no progress metrics registered yet"


def test_heartbeat_emits_then_stops_on_error():
    reg = metrics.MetricsRegistry()
    reg.gauge("ingest_sites_scanned").set(1000)
    emitted = []
    hb = heartbeat.Heartbeat(0.01, reg, emit=emitted.append)
    with pytest.raises(RuntimeError):
        with hb:
            waiter = threading.Event()
            for _ in range(500):
                if emitted:
                    break
                waiter.wait(0.01)
            raise RuntimeError("driver failed mid-run")
    assert not hb.running and emitted
    count = len(emitted)
    threading.Event().wait(0.05)
    assert len(emitted) == count
    assert "1,000 sites scanned" in emitted[0]
    with pytest.raises(ValueError):
        heartbeat.Heartbeat(0.0, reg)


def test_heartbeat_flag_writes_progress_lines_to_stderr(capsys):
    run(BASE + ["--ingest", "wire", "--heartbeat-seconds", "0.001"], device="cpu")
    captured = capsys.readouterr()
    assert "heartbeat[" not in captured.out
    assert re.search(r"^heartbeat\[\d+s\]: ", captured.err, flags=re.M)


# ------------------------------------------------------------------ manifest


def _parse_epilogue(out):
    fields = {
        "# of partitions": "partitions",
        "# of bases requested": "reference_bases",
        "# of variants read": "variants",
        "# of API requests": "requests",
        "# of unsuccessful responses": "unsuccessful_responses",
        "# of IO exceptions": "io_exceptions",
    }
    return {fields[k]: int(v) for k, v in re.findall(r"^(# of [\w ]+): (\d+)$", out, re.M)}


@pytest.mark.parametrize("arm", ["device", "packed", "wire", "file packed", "file streamed",
                                 "file wire"])
def test_manifest_passes_both_validators_and_matches_the_epilogue(tmp_path, capsys, arm):
    if arm.startswith("file"):
        argv = ["--source", "file", "--input-files", _vcf(tmp_path),
                "--references", "17:0:5000", "--bases-per-partition", "1000",
                "--ingest", "wire" if arm == "file wire" else "packed"]
        if arm == "file streamed":
            argv += ["--stream-chunk-bytes", "300"]
    else:
        argv = BASE + ["--ingest", arm]
    path = tmp_path / "m.json"
    result = run_pipeline(PcaConf.parse(argv + ["--metrics-json", str(path),
                                                "--profile-dir", str(tmp_path / "p")]), "cpu")
    out = capsys.readouterr().out
    assert f"Run manifest written to {path}." in out
    doc = manifest.read_manifest(str(path))
    assert doc == json.loads(json.dumps(result.manifest))
    assert manifest.validate_manifest(doc) == []
    assert ref_manifest.validate_manifest(doc) == []
    assert doc["io_stats"] == {**_parse_epilogue(out), "io_retries": 0}
    printed = dict(re.findall(r"^([\w+]+): (\d+\.\d{3}) s$", out, flags=re.M))
    spans = {s["name"]: s["seconds"] for s in doc["spans"]}
    for name in ("ingest+similarity", "center+pca"):
        assert f"{spans[name]:.3f}" == printed[name]
    assert doc["host_memory"]["peak_rss_bytes"] > 0
    assert doc["config"]["device"] == "cpu" or doc["config"]["device"] == "cuda"
    if arm in ("packed", "file packed", "file streamed"):
        assert doc["overlap"]["blocks"] > 0
        assert manifest.manifest_metric_value(doc, "gramian_flushes_total") > 0
    if arm.startswith("file ") and arm != "file wire":
        want = 1.0 if files_native() else 0.0
        assert manifest.manifest_metric_value(doc, "vcf_native_parse") == want


def files_native():
    from spark_examples_tpu_torch.utils import native

    return native.vcf_library() is not None


def test_reference_manifest_passes_the_port_validator(tmp_path, capsys):
    path = tmp_path / "ref.json"
    ref_driver.run(BASE + ["--metrics-json", str(path), "--ingest", "wire"])
    doc = ref_manifest.read_manifest(str(path))
    assert manifest.validate_manifest(doc) == []


@pytest.mark.parametrize("damage", ["schema", "spans", "io_stats", "host_memory", "metrics"])
def test_manifest_validators_agree_on_damage(damage):
    doc = manifest.build_manifest(config={"a": 1}, spans=[], metrics={}, io_stats=None)
    assert manifest.validate_manifest(doc) == ref_manifest.validate_manifest(doc) == []
    if damage == "schema":
        doc["schema"]["version"] = 3
    elif damage == "spans":
        doc["spans"] = [{"name": "x", "seconds": -1, "synced": True, "children": []}]
    elif damage == "io_stats":
        doc["io_stats"] = {"partitions": "1"}
    elif damage == "host_memory":
        doc["host_memory"]["static_bound_bytes"] = None
    else:
        doc["metrics"] = {"m": {"type": "summary", "values": []}}
    got, want = manifest.validate_manifest(doc), ref_manifest.validate_manifest(doc)
    assert got == want and got


def test_unwritable_manifest_path_keeps_the_run(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    lines = run(BASE + ["--metrics-json", str(blocker / "m.json")], device="cpu")
    assert len(lines) == 8
    assert "Run manifest NOT written" in capsys.readouterr().err


# ------------------------------------------------------ stage report, trace


def test_stage_report_format_matches_reference():
    port, ref = StageTimes(), RefStageTimes()
    for times in (port, ref):
        times.stages.extend([("ingest+similarity", 1.23456), ("center+pca", 0.5)])
    assert str(port) == str(ref)
    with port.stage("extra"):
        pass
    assert port.recorder.as_list()[0]["name"] == "extra"


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path, capsys):
    profile = tmp_path / "prof"
    run(BASE + ["--ingest", "packed", "--profile-dir", str(profile)], device="cpu")
    out = capsys.readouterr().out
    assert f"Device trace written to {profile}." in out
    assert "Stage timings:" in out and "ingest overlap: parse" in out
    traces = glob.glob(str(profile / "torch_trace_*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_device_trace_is_a_no_op_without_a_directory():
    with device_trace(None) as prof:
        assert prof is None


def test_span_tree_export():
    spans = SpanRecorder()
    with spans.span("outer"):
        with spans.span("inner", sync=lambda: None):
            pass
        spans.add("agg", 0.25)
    (tree,) = spans.as_list()
    assert tree["name"] == "outer" and tree["seconds"] >= 0
    assert [c["name"] for c in tree["children"]] == ["inner", "agg"]
    assert tree["children"][0]["synced"] is True
    assert isinstance(tree["started_unix"], float)


# --------------------------------------------------------- host-memory bound


def _bound_argvs(tmp_path):
    """name → argv of the host-memory bound's cases: every ingest shape
    the bound resolves differently."""
    import gzip
    import shutil

    vcf = _vcf(tmp_path)
    gz = tmp_path / "obs.vcf.gz"
    with open(vcf, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    other = tmp_path / "other.vcf"
    other.write_text(open(vcf).read())
    saved = tmp_path / "saved"
    run(["--source", "file", "--input-files", vcf, "--references", "17:0:5000",
         "--save-variants", str(saved)], device="cpu")
    file = ["--source", "file", "--references", "17:0:5000", "--input-files"]
    return {
        "synthetic": BASE,
        "synthetic packed, block 2048, 3 workers": BASE + [
            "--ingest", "packed", "--block-size", "2048", "--ingest-workers", "3"],
        "synthetic host backend": BASE + ["--pca-backend", "host"],
        "file packed .vcf": file + [vcf, "--ingest", "packed"],
        "file streamed .vcf.gz": file + [str(gz), "--ingest", "packed",
                                         "--stream-chunk-bytes", "300"],
        "file wire": file + [vcf, "--ingest", "wire"],
        "multi-set wire": file + [f"{vcf},{other}", "--variant-set-id", "obs,other"],
        "--input-path resume": file + [vcf, "--input-path", str(saved)],
    }


BOUND_CASES = ("synthetic", "synthetic packed, block 2048, 3 workers", "synthetic host backend",
               "file packed .vcf", "file streamed .vcf.gz", "file wire", "multi-set wire",
               "--input-path resume")


@pytest.mark.parametrize("case", BOUND_CASES)
def test_host_bound_equals_the_reference_at_one_device(tmp_path, capsys, case):
    """``conf_host_peak_bytes`` of both packages, integer for integer, at
    one device (the port's) and the reference's runtime baseline, passed
    explicitly, from the flag's cohort width and from the discovered one;
    the port's driver on the CPU registers that bound, and its manifest
    records it, its baseline, and a ``hostmem`` conformance pair."""
    from spark_examples_tpu.check.hostmem import conf_host_peak_bytes as ref_bound
    from spark_examples_tpu.config import PcaConf as RefPcaConf
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes

    argv = _bound_argvs(tmp_path)[case]
    conf, ref_conf = PcaConf.parse(argv), RefPcaConf.parse(argv)
    for n in (None, 5, 2504):
        got = conf_host_peak_bytes(conf, device_count=1, num_samples=n,
                                   baseline_bytes=metrics.HOST_RUNTIME_BASELINE_BYTES)
        assert isinstance(got, int) and got == ref_bound(ref_conf, device_count=1, num_samples=n)
    path = tmp_path / "m.json"
    result = run_pipeline(PcaConf.parse(argv + ["--metrics-json", str(path)]), "cpu")
    capsys.readouterr()
    width = len(result.driver.indexes)
    want = ref_bound(ref_conf, device_count=1, num_samples=width)
    assert result.driver.registry.value(metrics.HOST_STATIC_BOUND_BYTES) == want
    assert want > metrics.HOST_RUNTIME_BASELINE_BYTES
    doc = manifest.read_manifest(str(path))
    assert doc["host_memory"]["static_bound_bytes"] == want
    assert doc["host_memory"]["runtime_baseline_bytes"] == metrics.HOST_RUNTIME_BASELINE_BYTES
    hostmem = doc["conformance"]["hostmem"]
    assert hostmem["proven"] == want and hostmem["ok"] is True
    assert hostmem["measured"] == int(doc["host_memory"]["peak_rss_bytes"])
    assert doc["conformance"]["sched"] is None and doc["conformance"]["ranges"] is None


@pytest.mark.parametrize("host", [False, True], ids=["device", "host backend"])
@pytest.mark.parametrize("verb", ["ld-prune", "assoc-scan", "grm"])
def test_analysis_host_bound_equals_the_reference(tmp_path, verb, host):
    """The analyses' bound, integer for integer at one device: the W×W
    window term charged to ``ld-prune`` only, and the host accumulator
    left off ``ld-prune`` and ``assoc-scan`` under ``--pca-backend host``
    (charged to ``grm``)."""
    from spark_examples_tpu.check.hostmem import conf_host_peak_bytes as ref_bound
    from spark_examples_tpu.config import AssocConf as RefAssocConf
    from spark_examples_tpu.config import GrmConf as RefGrmConf
    from spark_examples_tpu.config import LdConf as RefLdConf
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes
    from spark_examples_tpu_torch.config import AssocConf, GrmConf, LdConf

    confs = {"ld-prune": (LdConf, RefLdConf, ["--ld-window-sites", "512"]),
             "assoc-scan": (AssocConf, RefAssocConf, ["--phenotypes", "p.tsv"]),
             "grm": (GrmConf, RefGrmConf, [])}
    port_conf, ref_conf, extra = confs[verb]
    file = ["--source", "file", "--references", "17:0:5000", "--input-files", _vcf(tmp_path)]
    backend = ["--pca-backend", "host"] if host else []
    for argv in (BASE, file):
        conf, ref = port_conf.parse(argv + extra + backend), ref_conf.parse(argv + extra + backend)
        for n in (None, 5, 2504):
            got = conf_host_peak_bytes(conf, device_count=1, num_samples=n,
                                       baseline_bytes=metrics.HOST_RUNTIME_BASELINE_BYTES)
            assert isinstance(got, int) and got == ref_bound(ref, device_count=1, num_samples=n)

    def bound(cls, argv):
        return conf_host_peak_bytes(cls.parse(BASE + argv), device_count=1, num_samples=2504)

    # The host backend's N×N accumulator is charged to grm alone; the
    # window term to ld-prune alone.
    charged = bound(port_conf, extra + backend) - bound(port_conf, extra)
    assert (charged > 0) == (host and verb == "grm")
    pca = bound(PcaConf, [])
    assert (bound(port_conf, extra) > pca) == (verb != "assoc-scan")


def test_heartbeat_analysis_segment_matches_the_reference():
    """``analysis kept K/T sites`` appears once the kept gauge exists, in
    the reference's words and place."""
    lines = []
    for module, hb_module in ((metrics, heartbeat), (ref_metrics, ref_heartbeat)):
        registry = module.MetricsRegistry()
        beat = hb_module.Heartbeat(60.0, registry, emit=lambda line: None, clock=lambda: 0.0)
        assert "analysis kept" not in beat.line()
        module.well_known_gauge(registry, module.ANALYSIS_SITES_TESTED).set(1000)
        module.well_known_gauge(registry, module.ANALYSIS_SITES_KEPT).set(250)
        registry.gauge("gramian_inflight_dispatches").set(1)
        lines.append(beat.line())
    assert lines[0] == lines[1]
    assert "dispatch in-flight 1; analysis kept 250/1,000 sites" in lines[0]


def test_runtime_baseline_is_the_reference_constant_on_the_cpu():
    """The one device-dependent term: on the CPU the reference's 4 GiB;
    a different baseline moves the bound by exactly the difference, every
    data term staying the reference's."""
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes, runtime_baseline_bytes

    assert runtime_baseline_bytes("cpu") == metrics.HOST_RUNTIME_BASELINE_BYTES == 4 << 30
    conf = PcaConf.parse(BASE + ["--ingest", "packed"])
    default = conf_host_peak_bytes(conf, device_count=1)
    assert default == conf_host_peak_bytes(
        conf, device_count=1, baseline_bytes=metrics.HOST_RUNTIME_BASELINE_BYTES)
    warm = 5_374_447_616
    assert conf_host_peak_bytes(conf, device_count=1, baseline_bytes=warm) - default == (
        warm - metrics.HOST_RUNTIME_BASELINE_BYTES)


def test_both_manifests_carry_the_same_bound_and_conformance(tmp_path, capsys):
    """On one argv, the reference run on a one-device list (its tests run
    on eight virtual devices, which would widen its data axis) and the
    port's write the same ``static_bound_bytes`` and each a ``hostmem``
    conformance entry; both validators pass both manifests."""
    import jax

    from spark_examples_tpu.config import PcaConf as RefPcaConf

    argv = BASE + ["--ingest", "packed", "--block-size", "512"]
    ref_path, path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_driver.run_pipeline(RefPcaConf.parse(argv + ["--metrics-json", str(ref_path)]),
                            devices=jax.devices()[:1])
    run_pipeline(PcaConf.parse(argv + ["--metrics-json", str(path)]), "cpu")
    capsys.readouterr()
    ref_doc, doc = ref_manifest.read_manifest(str(ref_path)), manifest.read_manifest(str(path))
    assert doc["host_memory"]["static_bound_bytes"] == ref_doc["host_memory"]["static_bound_bytes"]
    assert doc["conformance"].keys() == ref_doc["conformance"].keys()
    for d in (doc, ref_doc):
        assert d["conformance"]["hostmem"]["proven"] == doc["host_memory"]["static_bound_bytes"]
        assert d["conformance"]["hostmem"]["ok"] is True
        assert manifest.validate_manifest(d) == [] and ref_manifest.validate_manifest(d) == []


def test_conformance_block_matches_the_reference():
    """The same pairs recorded in both registries give the same block: a
    held bound, a broken one (rounded toward the verdict), a pair without a
    bound, and an unknown prover refused."""
    blocks = []
    for module in (metrics, ref_metrics):
        reg = module.MetricsRegistry()
        assert module.conformance_block(reg) is None
        module.record_prover_conformance(reg, "hostmem", 100.5, 200.2)
        module.record_prover_conformance(reg, "sched", 300.5, 300.2)
        module.record_prover_conformance(reg, "ranges", 7.6, None)
        with pytest.raises(module.MetricError, match="unknown conformance prover"):
            module.record_prover_conformance(reg, "lint", 1.0, 2.0)
        blocks.append(module.conformance_block(reg))
    assert blocks[0] == blocks[1]
    assert blocks[0]["sched"] == {"measured": 301, "proven": 300, "ok": False}
