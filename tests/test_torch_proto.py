"""``graftcheck proto`` in both packages: the replica protocol's model
checker over each package's ``serve/journal.py`` fold, at the bounds of
the reference's ``tests/test_graftcheck_proto.py``.

The port's journal is the reference's, record for record, so at the same
bounds both checkers must explore the same states and transitions, reach
the same crash windows and give the same verdicts: the clean runs, the
capped run, every planted mutation, the witnesses and the CLI's exit codes
and reports (timings aside). The kill-point registry beside it is GP006's
ground truth: every port call site of ``kill_point`` names a registered
point, and every registered point is called.
"""

import contextlib
import io
import json
import os
import re

import pytest

from spark_examples_tpu.check import proto as ref_proto
from spark_examples_tpu.check.cli import main as ref_main
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.check import proto as port_proto
from spark_examples_tpu_torch.check.cli import main as port_main
from spark_examples_tpu_torch.utils import faults as port_faults

PORT_ROOT = os.path.dirname(os.path.abspath(port_faults.__file__)).rsplit(os.sep, 1)[0]


def _verdict(report):
    """A report's facts, the run's wall clock aside."""
    doc = json.loads(report.to_json())
    doc.pop("elapsed_seconds")
    return doc


#: The reference tests' bounds: (replicas, jobs, crashes, stalls, max_states).
BOUNDS = {
    "small-matrix": (2, 1, 1, 1, 2_000_000),
    "two-jobs": (2, 2, 1, 0, 2_000_000),
    "json-shape": (2, 1, 1, 0, 2_000_000),
    "capped": (2, 1, 2, 2, 50),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_clean_exploration_equals_the_reference(name):
    replicas, jobs, crashes, stalls, max_states = BOUNDS[name]
    reports = [
        module.check_protocol(replicas=replicas, jobs=jobs, crashes=crashes, stalls=stalls,
                              max_states=max_states)
        for module in (ref_proto, port_proto)
    ]
    assert _verdict(reports[1]) == _verdict(reports[0])
    port = reports[1]
    if name == "capped":
        assert not port.exhausted and not port.ok
    else:
        assert port.exhausted and port.ok and port.findings == []
        assert port.uncovered_windows == []
    if name == "small-matrix":
        assert set(port.crash_windows) == {
            "serve.submit.post-accept",
            "serve.lease.post-claim",
            "serve.worker.claim",
            "serve.worker.mid-job",
        }


def _outcomes(module, **bounds):
    return [o.to_json() for o in module.run_mutation_harness(**bounds)]


@pytest.mark.parametrize("bounds", [{}, {"jobs": 1, "stalls": 0}], ids=["witness", "no-stalls"])
def test_mutation_harness_equals_the_reference(bounds):
    ref, port = _outcomes(ref_proto, **bounds), _outcomes(port_proto, **bounds)
    assert port == ref
    assert [m.name for m in port_proto.MUTATIONS] == [m.name for m in ref_proto.MUTATIONS]
    by_name = {o["name"]: o for o in port}
    if bounds:
        assert not by_name["graceless-steal"]["caught"]
    else:
        assert len(port) >= 8 and all(o["caught"] for o in port)
        assert {o["expected"] for o in port} == {f"GP00{i}" for i in range(1, 7)}


@pytest.mark.parametrize("rule, mutation", [
    ("GP005", "graceless-steal"),
    ("GP006", "unregistered-kill-window"),
])
def test_planted_bug_witness_equals_the_reference(rule, mutation):
    reports = []
    for module in (ref_proto, port_proto):
        planted = next(m for m in module.MUTATIONS if m.name == mutation)
        reports.append(module.check_protocol(
            replicas=2, jobs=1, crashes=1, stalls=1 if rule == "GP005" else 0,
            mutations=planted.mutations, stop_on_rule=rule))
    assert _verdict(reports[1]) == _verdict(reports[0])
    found = [f for f in reports[1].findings if f.rule_id == rule]
    assert found and "[witness:" in found[0].detail
    if rule == "GP006":
        assert reports[1].uncovered_windows


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["proto", *argv])
    return rc, out.getvalue()


_TIMING = re.compile(r" in \d+\.\d+s ")


@pytest.mark.parametrize("argv", [
    ["--replicas", "2", "--jobs", "1", "--crashes", "1", "--stalls", "1"],
    ["--replicas", "2", "--jobs", "1", "--crashes", "1", "--stalls", "0", "--json"],
    ["--mutations", "--json"],
    ["--replicas", "0"],
    ["--crashes", "-1"],
], ids=["text", "json", "mutations-json", "zero-replicas", "negative-crashes"])
def test_cli_equals_the_reference(argv, capsys):
    (ref_rc, ref_out), (port_rc, port_out) = _cli(ref_main, argv), _cli(port_main, argv)
    capsys.readouterr()
    assert port_rc == ref_rc
    if "--json" in argv:
        ref_doc, port_doc = json.loads(ref_out), json.loads(port_out)
        if isinstance(port_doc, dict):
            ref_doc.pop("elapsed_seconds"), port_doc.pop("elapsed_seconds")
        assert port_doc == ref_doc
    else:
        assert _TIMING.sub(" in ", port_out) == _TIMING.sub(" in ", ref_out)
    if argv[0] in ("--replicas", "--crashes") and argv[1] in ("0", "-1"):
        assert port_rc == 2
    else:
        assert port_rc == 0
    if argv[-1] == "1":
        assert "clean: every reachable state satisfies GP001-GP006" in port_out


# --------------------------------------------------------- kill-point registry

_KILL_POINT_CALL = re.compile(r'kill_point\(\s*"([^"]+)"\s*\)')


def _kill_point_call_sites():
    """Every string-literal ``kill_point("...")`` call in the port,
    ``{site: [relpath, ...]}``."""
    sites = {}
    for dirpath, _dirnames, filenames in os.walk(PORT_ROOT):
        for filename in filenames:
            if not filename.endswith(".py"):
                continue
            path = os.path.join(dirpath, filename)
            rel = os.path.relpath(path, PORT_ROOT)
            if rel == os.path.join("utils", "faults.py"):
                continue  # the registry itself, not a call site
            with open(path, "r", encoding="utf-8") as handle:
                for match in _KILL_POINT_CALL.finditer(handle.read()):
                    sites.setdefault(match.group(1), []).append(rel)
    return sites


def test_kill_point_registry_matches_the_port_call_sites():
    registry = port_faults.registered_kill_points()
    assert registry == port_faults.KILL_POINTS and registry is not port_faults.KILL_POINTS
    assert set(registry) == set(ref_faults.registered_kill_points())
    sites = _kill_point_call_sites()
    assert sorted(set(sites) - set(registry)) == []
    assert sorted(set(registry) - set(sites)) == []


def test_kill_point_registry_locations_name_port_modules():
    for site, where in port_faults.registered_kill_points().items():
        module = where.split(":", 1)[0].split(" ", 1)[0]
        assert os.path.exists(os.path.join(PORT_ROOT, module)), (site, where)


def test_model_path_and_windows_are_the_reference_s():
    assert port_proto.MODEL_PATH == ref_proto.MODEL_PATH
    assert port_proto._PHASE_WINDOW == ref_proto._PHASE_WINDOW
    assert set(port_proto._PHASE_WINDOW.values()) <= set(port_faults.registered_kill_points())
