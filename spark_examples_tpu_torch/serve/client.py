"""Stdlib HTTP client for the resident PCA service + the ``submit`` verb.

The port's copy of ``spark_examples_tpu/serve/client.py``; it speaks the
same protocol, so it drives either package's daemon.

``ServeClient`` is the scripting surface (the smoke test and
``tests/test_serve.py`` ride it); ``submit_main`` is the CLI verb::

    python -m spark_examples_tpu_torch submit --url http://127.0.0.1:8765 \\
        -- --num-samples 64 --references 17:41196311:41277499

Everything after ``--`` is the EXISTING PCA flag namespace, forwarded
verbatim — a batch invocation becomes a served job by replacing
``variants-pca`` with ``submit --url ... --``. Waiting (``--wait``, the
default) polls ``GET /v1/jobs/<id>`` honoring the server's
``Retry-After`` hint with the shared ``utils/retry.py`` full-jitter
backoff between polls. Exit codes: 0 job done, 1 job
failed/cancelled/timed out, 2 rejected at admission (the rejection
body, including the plan facts, prints as JSON).

The client touches no device: submitting from a laptop to a daemon on
a card must not initialize CUDA locally.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Sequence, Tuple

from spark_examples_tpu_torch.serve.protocol import (
    JOB_KINDS,
    RESERVED_KINDS,
    TERMINAL_STATUSES,
    request_doc,
)
from spark_examples_tpu_torch.utils.retry import (
    full_jitter_delay,
    retry_after_seconds,
)

#: The submit verb's ``--kind`` choices, sourced from the protocol's own
#: tables (never a drifted copy). Reserved kinds pass argparse on purpose:
#: the server's structured ``reserved-kind`` 400 is the answer the user
#: should see, not an argparse usage error.
SUBMIT_KIND_CHOICES = tuple(JOB_KINDS) + tuple(RESERVED_KINDS)

#: Hard cap on response bodies (bounded read — a misbehaving server must
#: not stage unbounded bytes in client memory).
MAX_RESPONSE_BYTES = 64 << 20


class ServeError(Exception):
    """A non-2xx service response; carries the HTTP status and the parsed
    error body (``error.code``, ``error.message``, optional ``plan``)."""

    def __init__(self, status: int, body):
        code = None
        message = None
        if isinstance(body, dict):
            error = body.get("error") or {}
            code = error.get("code")
            message = error.get("message")
        super().__init__(
            f"HTTP {status}"
            + (f" [{code}]" if code else "")
            + (f": {message}" if message else "")
        )
        self.status = status
        self.body = body
        self.code = code


def _connection_refused(e: BaseException) -> bool:
    """Whether this transport error means the request NEVER reached a
    server (the kernel refused the connect) — the only failure class a
    single-shot POST may fail over on without risking a duplicate."""
    if isinstance(e, ConnectionRefusedError):
        return True
    return isinstance(
        getattr(e, "reason", None), ConnectionRefusedError
    )


class ServeClient:
    """``url`` may be a comma-separated endpoint list
    (``http://a:8765,http://b:8766`` — the multi-replica serving form):
    requests go to the current endpoint and fail over to the next when a
    connection is refused, so a client outlives any single replica."""

    def __init__(
        self,
        url: str,
        timeout: float = 30.0,
        max_retries: int = 3,
        backoff_base: float = 0.1,
        backoff_cap: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self.urls = [
            u.strip().rstrip("/") for u in url.split(",") if u.strip()
        ]
        if not self.urls:
            raise ValueError(f"no endpoint in url {url!r}")
        self._endpoint = 0
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()

    @property
    def url(self) -> str:
        """The endpoint requests currently target (rotates on failover)."""
        return self.urls[self._endpoint]

    # ------------------------------------------------------------ transport

    def _backoff(self, attempt: int, response_headers) -> None:
        """One bounded-backoff delay (the shared ``utils/retry.py``
        arithmetic): honor a server-sent ``Retry-After`` when present,
        full jitter otherwise; both capped by ``backoff_cap``."""
        delay = retry_after_seconds(response_headers, self.backoff_cap)
        if delay is None:
            delay = full_jitter_delay(
                attempt, self.backoff_base, self.backoff_cap, self._rng
            )
        self._sleep(delay)

    def _request(
        self,
        method: str,
        path: str,
        doc: Optional[Dict] = None,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, object, str, Optional[Dict]]:
        """One HTTP exchange. GETs (``status``/``/metrics``/``/healthz``)
        retry connection resets and 5xx responses with bounded backoff —
        they are idempotent, and a daemon mid-worker-recovery must not
        look "down" to a poller that raced one refused connect. POSTs
        stay single-shot PER SERVER: a retried submit could enqueue the
        job twice — but a REFUSED connect provably never reached a
        server, so both verbs fail over to the next configured endpoint
        (once per extra endpoint per request) when one is given."""
        data = None
        headers = {"Accept": "application/json"}
        if extra_headers:
            headers.update(extra_headers)
        if doc is not None:
            data = json.dumps(doc).encode("utf-8")
            headers["Content-Type"] = "application/json"
        attempts = max(1, self.max_retries) if method == "GET" else 1
        failovers_left = len(self.urls) - 1
        attempt = 0
        while True:
            retryable = attempt + 1 < attempts
            req = urllib.request.Request(
                self.url + path, data=data, method=method, headers=headers
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    status = resp.status
                    raw = resp.read(MAX_RESPONSE_BYTES + 1)
                    content_type = resp.headers.get("Content-Type", "")
                    headers = dict(resp.headers)
            except urllib.error.HTTPError as e:
                if e.code >= 500 and retryable:
                    self._backoff(attempt, e.headers)
                    attempt += 1
                    continue
                status = e.code
                raw = e.read(MAX_RESPONSE_BYTES + 1)
                content_type = (
                    e.headers.get("Content-Type", "") if e.headers else ""
                )
                headers = dict(e.headers) if e.headers else None
            except (urllib.error.URLError, OSError) as e:
                if _connection_refused(e) and failovers_left > 0:
                    # This replica is down; move to the next endpoint
                    # immediately (no backoff, no attempt consumed — the
                    # request never left this host).
                    failovers_left -= 1
                    self._endpoint = (self._endpoint + 1) % len(self.urls)
                    continue
                # Connection reset (possibly mid-response): safe to
                # resend only because GETs are idempotent.
                if retryable:
                    self._backoff(attempt, None)
                    attempt += 1
                    continue
                raise
            break
        if len(raw) > MAX_RESPONSE_BYTES:
            raise ServeError(
                status,
                {
                    "error": {
                        "code": "response-too-large",
                        "message": f"response exceeds {MAX_RESPONSE_BYTES} bytes",
                    }
                },
            )
        text = raw.decode("utf-8", errors="replace")
        if "application/json" in content_type:
            try:
                return status, json.loads(text), text, headers
            except json.JSONDecodeError:
                pass
        return status, None, text, headers

    def _json_with_headers(
        self,
        method: str,
        path: str,
        doc: Optional[Dict] = None,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[Dict, Optional[Dict]]:
        status, body, text, headers = self._request(
            method, path, doc, extra_headers=extra_headers
        )
        if status >= 400:
            raise ServeError(status, body if body is not None else text)
        if not isinstance(body, dict):
            raise ServeError(
                status,
                {
                    "error": {
                        "code": "bad-response",
                        "message": f"expected a JSON object, got: {text[:200]}",
                    }
                },
            )
        return body, headers

    def _json(
        self,
        method: str,
        path: str,
        doc: Optional[Dict] = None,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Dict:
        return self._json_with_headers(
            method, path, doc, extra_headers=extra_headers
        )[0]

    # ----------------------------------------------------------------- verbs

    def submit(
        self,
        flags: Sequence[str],
        kind: str = "pca",
        deadline_seconds: Optional[float] = None,
        tag: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> Dict:
        """Submit one job; returns the job envelope (``doc["job"]["id"]``
        is the handle). Raises :class:`ServeError` on every rejection —
        ``.body["plan"]`` carries the admission validator's facts.

        This is where a trace is BORN: the client mints a trace id (or
        forwards the caller's — a batch harness correlating many submits)
        and sends it as the ``X-Trace-Id`` header; the server stamps it
        on the job, its journal record, and every flight-recorder event,
        and echoes it back as ``doc["job"]["trace"]``."""
        from spark_examples_tpu_torch.obs.trace import TRACE_HEADER, mint_trace_id

        trace = trace_id if trace_id is not None else mint_trace_id()
        return self._json(
            "POST",
            "/v1/jobs",
            request_doc(
                flags, kind=kind, deadline_seconds=deadline_seconds, tag=tag
            ),
            extra_headers={TRACE_HEADER: trace},
        )

    def status(self, job_id: str) -> Dict:
        return self._json("GET", f"/v1/jobs/{job_id}")

    def cancel(self, job_id: str) -> Dict:
        return self._json("POST", f"/v1/jobs/{job_id}/cancel")

    def wait(
        self,
        job_id: str,
        timeout: float = 600.0,
        poll_cap_seconds: float = 2.0,
    ) -> Dict:
        """Poll ``GET /v1/jobs/<id>`` until the job reaches a terminal
        status; raises :class:`TimeoutError` past ``timeout``.

        Pacing is server-first: a ``Retry-After`` header on a non-terminal
        response (``serve/http.py`` sends one) is honored exactly; without
        one the shared ``utils/retry.py`` full-jitter backoff paces the
        polls — both capped by ``poll_cap_seconds`` so a long job is
        polled steadily, not hammered, and a thundering herd of waiting
        clients decorrelates instead of synchronizing."""
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            try:
                body, headers = self._json_with_headers(
                    "GET", f"/v1/jobs/{job_id}"
                )
            except ServeError as e:
                if e.status != 404 or len(self.urls) <= 1:
                    raise
                # The failover window: a surviving replica answers 404
                # for a dead peer's job until its steal scan adopts it
                # (lease expiry + grace + one scan interval). With more
                # than one endpoint configured that is a non-terminal
                # state, bounded by this wait's own deadline.
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"job {job_id} not visible on any endpoint after "
                        f"{timeout}s (failover pending?)"
                    ) from None
                headers = None
                body = None
            if body is not None and body["job"]["status"] in TERMINAL_STATUSES:
                return body
            if body is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"job {job_id} still {body['job']['status']!r} after "
                    f"{timeout}s"
                )
            delay = retry_after_seconds(headers, poll_cap_seconds)
            if delay is None:
                delay = full_jitter_delay(
                    attempt, self.backoff_base, poll_cap_seconds, self._rng
                )
            attempt += 1
            self._sleep(delay)

    def metrics(self) -> str:
        status, _body, text, _headers = self._request("GET", "/metrics")
        if status >= 400:
            raise ServeError(status, text)
        return text

    def healthz(self) -> Dict:
        return self._json("GET", "/healthz")


def submit_main(argv: Optional[Sequence[str]] = None) -> int:
    """The ``submit`` CLI verb; see the module docstring."""
    parser = argparse.ArgumentParser(prog="spark_examples_tpu_torch submit")
    parser.add_argument(
        "--url",
        required=True,
        help=(
            "Service base URL (see serve --port), or a comma-separated "
            "endpoint list (http://a:8765,http://b:8766): the client "
            "fails over to the next endpoint when a connect is refused "
            "— the multi-replica serving form."
        ),
    )
    parser.add_argument(
        "--kind", choices=list(SUBMIT_KIND_CHOICES), default="pca"
    )
    parser.add_argument("--deadline-seconds", type=float, default=None)
    parser.add_argument("--tag", default=None)
    parser.add_argument(
        "--wait",
        action="store_true",
        help=(
            "Poll until the job reaches a terminal state (the default; "
            "spelled out for scripts that want the contract explicit). "
            "Polling honors server Retry-After hints with full-jitter "
            "backoff between them; the exit code mirrors the terminal "
            "state (0 done, 1 failed/cancelled/timed out)."
        ),
    )
    parser.add_argument(
        "--no-wait",
        action="store_true",
        help="Print the job id and return without polling.",
    )
    parser.add_argument(
        "--timeout",
        type=float,
        default=600.0,
        help="Polling timeout in seconds (with waiting enabled).",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="Print the final job/error envelope as JSON.",
    )
    parser.add_argument(
        "flags",
        nargs=argparse.REMAINDER,
        help="PCA flag namespace after '--' (forwarded verbatim).",
    )
    ns = parser.parse_args(list(argv) if argv is not None else None)
    if ns.wait and ns.no_wait:
        parser.error("--wait and --no-wait are mutually exclusive")
    flags = list(ns.flags)
    if flags and flags[0] == "--":
        flags = flags[1:]

    client = ServeClient(ns.url)
    try:
        doc = client.submit(
            flags,
            kind=ns.kind,
            deadline_seconds=ns.deadline_seconds,
            tag=ns.tag,
        )
    except ServeError as e:
        body = e.body if isinstance(e.body, dict) else {"raw": e.body}
        print(json.dumps({"http_status": e.status, **body}, indent=2))
        return 2
    job_id = doc["job"]["id"]
    if ns.no_wait:
        print(json.dumps(doc, indent=2) if ns.json else job_id)
        return 0
    try:
        doc = client.wait(job_id, timeout=ns.timeout)
    except TimeoutError as e:
        print(str(e), file=sys.stderr)
        return 1
    job = doc["job"]
    if ns.json:
        print(json.dumps(doc, indent=2))
    elif job["status"] == "done":
        result = job.get("result") or {}
        for line in result.get("pc_lines") or []:
            print(line)
        if "similarity" in result:
            print(json.dumps(result["similarity"], indent=2))
        print(
            f"job {job_id} done in {job['seconds']:.3f}s "
            f"(compile cache {job['compile_cache']}; "
            f"manifest {job['manifest_path']})",
            file=sys.stderr,
        )
    else:
        print(
            f"job {job_id} {job['status']}: {job.get('error')}",
            file=sys.stderr,
        )
    return 0 if job["status"] == "done" else 1


__all__ = ["MAX_RESPONSE_BYTES", "ServeError", "ServeClient", "submit_main"]
