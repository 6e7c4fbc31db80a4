"""The REST source: the port's ``sources/rest.py`` against the JAX
package's, through injected transports (no sockets).

Every case of the reference's ``tests/test_rest.py`` runs on both clients
with the same scripted transport: the requests they send (URL, payload,
headers), what they yield or raise, their counters and their backoff
sleeps must be equal. Then ``variants-pca`` over ``--source rest`` with a
transport serving the synthetic cohort's wire JSON: its Gramian equals the
synthetic run's exactly, with an injected IO fault retried, and its PCs
the reference's REST run's within ``TOLERANCE``."""

import contextlib
import dataclasses
import io
import json
import random
import urllib.error

import numpy as np
import pytest

from spark_examples_tpu.config import PcaConf as RefConf
from spark_examples_tpu.pipeline.pca_driver import VariantsPcaDriver as RefDriver
from spark_examples_tpu.sharding.contig import SexChromosomeFilter as RefSexFilter
from spark_examples_tpu.sources import rest as ref_rest
from spark_examples_tpu.sources.base import OfflineAuth as RefAuth
from spark_examples_tpu.sources.base import ShardBoundary as RefBoundary
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource as RefSynthetic
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
from spark_examples_tpu_torch.sharding.contig import SexChromosomeFilter
from spark_examples_tpu_torch.sources import rest
from spark_examples_tpu_torch.sources.base import OfflineAuth, ShardBoundary
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils import faults

#: |PC entry| tolerance against the reference's REST run, after the shared
#: sign convention (the two eigensolves start from different iterates).
TOLERANCE = 1e-4

#: Each package's names, so one scenario drives either client.
PORT = dict(rest=rest, auth=OfflineAuth, boundary=ShardBoundary, sex=SexChromosomeFilter)
REFERENCE = dict(rest=ref_rest, auth=RefAuth, boundary=RefBoundary, sex=RefSexFilter)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


class FakeTransport:
    """Scripted transport: a queue of responses/exceptions per call."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def __call__(self, url, payload, headers):
        self.calls.append((url, dict(payload), dict(headers)))
        action = self.script.pop(0)
        if isinstance(action, Exception):
            raise action
        return action


def _variant(start):
    return {"id": f"v{start}", "start": start}


def _read(pos):
    return {"alignment": {"position": {"position": pos}}}


def _client(pkg, script, **kwargs):
    transport = FakeTransport(script)
    slept = []
    kwargs.setdefault("sleep", slept.append)
    client = pkg["rest"].RestClient(kwargs.pop("auth", None), base_url="http://x/api",
                                    transport=transport, **kwargs)
    return client, transport, slept


def _outcome(fn):
    try:
        return "ok", fn()
    except RuntimeError as e:
        return "raised", str(e)


def _pagination(pkg):
    client, transport, slept = _client(pkg, [
        {"variants": [_variant(1), _variant(2)], "nextPageToken": "t1"},
        {"variants": [_variant(3)], "nextPageToken": "t2"},
        {"variants": [_variant(4)]},
    ])
    got = _outcome(lambda: [v["id"] for v in client.search_variants(
        {"start": 0, "end": 100}, pkg["boundary"].STRICT)])
    return got, transport, client, slept


def _strict_boundary(pkg):
    client, transport, slept = _client(pkg, [
        {"variants": [_variant(5), _variant(10), _variant(20)]}])
    got = _outcome(lambda: [v["start"] for v in client.search_variants(
        {"start": 10, "end": 20}, pkg["boundary"].STRICT)])
    return got, transport, client, slept


def _retries_then_succeed(pkg):
    client, transport, slept = _client(pkg, [
        urllib.error.HTTPError("u", 500, "boom", {}, None),
        urllib.error.URLError("down"),
        {"variants": [_variant(1)]},
    ], rng=random.Random(3))
    got = _outcome(lambda: len(list(client.search_variants({"start": 0, "end": 10}))))
    return got, transport, client, slept


def _retries_exhausted(pkg):
    client, transport, slept = _client(pkg, [urllib.error.URLError("down")] * 3,
                                       max_retries=3, rng=random.Random(4))
    got = _outcome(lambda: list(client.search_variants({"start": 0, "end": 10})))
    return got, transport, client, slept


def _4xx_not_retried(pkg):
    client, transport, slept = _client(pkg, [urllib.error.HTTPError("u", 404, "nope", {}, None)])
    got = _outcome(lambda: list(client.search_variants({"start": 0, "end": 10})))
    return got, transport, client, slept


def _429_retried(pkg):
    client, transport, slept = _client(pkg, [
        urllib.error.HTTPError("u", 429, "slow down", {}, None),
        {"variants": [_variant(1)]},
    ], rng=random.Random(5))
    got = _outcome(lambda: len(list(client.search_variants({"start": 0, "end": 10}))))
    return got, transport, client, slept


def _backoff_full_jitter(pkg):
    client, transport, slept = _client(pkg, [urllib.error.URLError("down")] * 4,
                                       max_retries=4, backoff_base=1.0, backoff_cap=3.0,
                                       rng=random.Random(0))
    got = _outcome(lambda: client._post("variants/search", {}))
    mirror = random.Random(0)
    assert slept == [mirror.uniform(0.0, c) for c in [1.0, 2.0, 3.0]]
    return got, transport, client, slept


def _auth_header(pkg):
    auth = pkg["auth"](client_secrets_file="cs.json", access_token="tok123")
    client, transport, slept = _client(pkg, [{"variants": []}], auth=auth)
    got = _outcome(lambda: list(client.search_variants({"start": 0, "end": 1})))
    assert transport.calls[0][2]["Authorization"] == "Bearer tok123"
    return got, transport, client, slept


def _reads_boundary(pkg):
    client, transport, slept = _client(pkg, [{"alignments": [_read(5), _read(15)]}])
    got = _outcome(lambda: len(list(client.search_reads(
        {"start": 10, "end": 20}, pkg["boundary"].STRICT))))
    return got, transport, client, slept


def _oversized_page(pkg):
    client, transport, slept = _client(pkg, [{"variants": [_variant(i) for i in range(9)]}])
    try:
        list(client.search_variants({"start": 0, "end": 100}, page_size=2))
        got = ("ok", None)
    except Exception as e:  # noqa: BLE001 — StreamBudgetError of either package
        got = (type(e).__name__, str(e))
    return got, transport, client, slept


CLIENT_CASES = {
    "pagination": (_pagination, ("ok", ["v1", "v2", "v3", "v4"])),
    "strict boundary": (_strict_boundary, ("ok", [10])),
    "retries then succeed": (_retries_then_succeed, ("ok", 1)),
    "retries exhausted": (_retries_exhausted, None),
    "4xx not retried": (_4xx_not_retried, None),
    "429 retried": (_429_retried, ("ok", 1)),
    "backoff full jitter": (_backoff_full_jitter, None),
    "auth header": (_auth_header, ("ok", [])),
    "reads boundary": (_reads_boundary, ("ok", 1)),
    "oversized page": (_oversized_page, None),
}


@pytest.mark.parametrize("case", list(CLIENT_CASES))
def test_client_behaves_as_the_reference(case):
    scenario, expected = CLIENT_CASES[case]
    got, transport, client, slept = scenario(PORT)
    ref_got, ref_transport, ref_client, ref_slept = scenario(REFERENCE)
    assert got == ref_got
    if expected is not None:
        assert got == expected
    assert transport.calls == ref_transport.calls
    assert dataclasses.asdict(client.counters) == dataclasses.asdict(ref_client.counters)
    assert slept == ref_slept


def test_callsets_and_contigs_discovery_as_the_reference():
    script = [
        {"callSets": [{"id": "cs0", "name": "S0"}], "nextPageToken": "n"},
        {"callSets": [{"id": "cs1", "name": "S1"}]},
        {"referenceBounds": [{"referenceName": "chr1", "upperBound": 1000},
                             {"referenceName": "X", "upperBound": 500}]},
    ]
    results = []
    for pkg in (PORT, REFERENCE):
        transport = FakeTransport(script)
        source = pkg["rest"].RestGenomicsSource(base_url="http://x", transport=transport)
        callsets = source.search_callsets(["vs1"])
        contigs = source.get_contigs("vs1", pkg["sex"].EXCLUDE_XY)
        results.append((callsets, [(c.reference_name, c.start, c.end) for c in contigs],
                        transport.calls))
    assert results[0] == results[1]
    assert [c["id"] for c in results[0][0]] == ["cs0", "cs1"]
    assert results[0][1] == [("chr1", 0, 1000)]


def test_rest_post_fault_point_feeds_the_retry_loop():
    faults.configure("ioerror@rest.post#1")
    client, transport, slept = _client(PORT, [{"variants": [_variant(1)]}], rng=random.Random(0))
    assert len(list(client.search_variants({"start": 0, "end": 10}))) == 1
    assert (client.counters.io_exceptions, client.counters.retries) == (1, 1)
    assert len(transport.calls) == 1 and len(slept) == 1
    assert faults.injected_count() == 1


def _serving_transport(synthetic, boundary):
    """A transport serving ``synthetic``'s callsets and wire variants."""
    def transport(url, payload, headers):
        if url.endswith("/callsets/search"):
            return {"callSets": synthetic.search_callsets(payload["variantSetIds"])}
        if url.endswith("/variants/search"):
            items = list(synthetic.client().search_variants(payload, boundary.STRICT))
            return {"variants": json.loads(json.dumps(items))}
        raise AssertionError(f"unexpected url {url}")
    return transport


ARGV = ["--references", "17:41196311:41216311", "--num-samples", "10", "--seed", "4",
        "--block-size", "32"]


def test_driver_over_rest_equals_the_synthetic_run_and_the_reference():
    """``variants-pca`` over ``--source rest`` (the second POST, the first
    variant page, fails once and is retried): the Gramian equals the
    synthetic wire run's exactly, the run's stats count the retry, and
    the PCs equal the reference's REST run's within TOLERANCE."""
    synthetic = SyntheticGenomicsSource(num_samples=10, seed=4)
    source = rest.RestGenomicsSource(base_url="http://fake", sleep=lambda s: None,
                                     transport=_serving_transport(synthetic, ShardBoundary))
    with contextlib.redirect_stdout(io.StringIO()):
        got = run_pipeline(PcaConf.parse(ARGV + ["--source", "rest", "--device", "cpu",
                                                 "--fault-plan", "ioerror@rest.post#2"]),
                           source=source)
        want = run_pipeline(PcaConf.parse(ARGV + ["--ingest", "wire", "--device", "cpu"]))
    np.testing.assert_array_equal(got.driver.accumulator.G.numpy(),
                                  want.driver.accumulator.G.numpy())
    stats = got.driver.io_stats.as_dict()
    assert stats["io_retries"] == 1 and stats["io_exceptions"] == 1
    assert stats["variants"] == want.driver.io_stats.as_dict()["variants"] > 0
    assert faults.injected_count() == 1

    ref_synthetic = RefSynthetic(num_samples=10, seed=4)
    ref_source = ref_rest.RestGenomicsSource(
        base_url="http://fake", transport=_serving_transport(ref_synthetic, RefBoundary))
    with contextlib.redirect_stdout(io.StringIO()):
        driver = RefDriver(RefConf.parse(ARGV + ["--source", "rest"]), ref_source)
        S = driver.get_similarity_matrix(driver.iter_calls(driver.get_data()))
        ref_lines = driver.emit_result(driver.compute_pca(S))
    np.testing.assert_array_equal(got.driver.accumulator.G.numpy(), np.asarray(S))
    assert [line.split("\t")[:2] for line in got.lines] == [
        line.split("\t")[:2] for line in ref_lines]
    A = np.array([[float(x) for x in line.split("\t")[2:]] for line in got.lines])
    B = np.array([[float(x) for x in line.split("\t")[2:]] for line in ref_lines])
    signs = np.sign((A * B).sum(axis=0))
    np.testing.assert_allclose(A, B * signs, atol=TOLERANCE, rtol=0)
