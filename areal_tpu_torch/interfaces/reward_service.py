"""The reward verification service (port of
areal_tpu/interfaces/reward_service.py): a standard-library HTTP server
that grades with the same in-process graders, so verification can run
on other hosts than the trainer, and a client that falls back to local
grading.

Grading dispatches on the item's ``task`` over an open registry
(`register_verifier`; "math", "code" and "judge" are registered), and
items travel in an opaque schema::

    {"task": "code", "text": "<response>", "payload": {...backend args}}

The server hands ``payload`` to the backend unread.  The older flat
schema (backend keys at the top level) is still accepted, with a
warning logged once.  The wire format is the JAX package's: either
package's `post_verify` talks to either package's server.

    python -m areal_tpu_torch.apps.verifier --port 8090   # the server
    RemoteVerifier("http://127.0.0.1:8090").verify_batch(items)

Each grade opens a ``grade:<task>`` span, and an item carrying a
``trace_id`` gets its ``graded`` lineage stamp (`base/tracer.py`); the
server traces as role ``reward``.  A fleet of announced graders behind a
load-balancing client is `system/verifier_pool.py`.
"""

import dataclasses
import json
import logging
import os
import re
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import metrics, tracer

logger = logging.getLogger("areal_tpu_torch.reward_service")

# Failed remote round trips by failure class: "the service is down"
# (network, timeout) against "we disagree on the wire format" (http,
# protocol, shape).
_M_REMOTE_ERRORS = metrics.default_registry().counter(
    "areal_reward_remote_errors_total",
    "remote reward verification failures, by reason",
    ("reason",),
)

# The failures verify_batch retries; anything else (a programming error)
# propagates, so a typo never degrades every batch to local grading.
_RETRYABLE = (urllib.error.URLError, TimeoutError, OSError, ValueError, KeyError)


class VerifierShapeError(ValueError):
    """The service returned a result list whose length differs from the
    batch's: typed, so it counts under ``reason=shape`` and is never
    zipped against the items."""


def _error_reason(e: BaseException) -> str:
    """A transport or protocol failure -> its counter label."""
    if isinstance(e, VerifierShapeError):
        return "shape"
    if isinstance(e, urllib.error.HTTPError):
        return "http"
    if isinstance(e, TimeoutError):
        return "timeout"
    if isinstance(e, urllib.error.URLError):
        if isinstance(getattr(e, "reason", None), TimeoutError):
            return "timeout"
        return "network"
    if isinstance(e, OSError):
        return "network"
    return "protocol"


# ---------------- the verifier registry ----------------

_VERIFIERS: Dict[str, Callable[[str, Dict[str, Any]], bool]] = {}


def register_verifier(task: str, fn: Callable[[str, Dict[str, Any]], bool]) -> None:
    """Register (or replace) the grader of a ``task``: ``fn(text,
    payload) -> bool``, run on the service's grading threads."""
    _VERIFIERS[task] = fn


def verifier_names() -> List[str]:
    return sorted(_VERIFIERS)


# The graders live here, not in interfaces/reward.py: a verifier process
# grades without importing the model stack (torch).

def _row_is_choice(info: Dict[str, Any]) -> Optional[bool]:
    """Row-level multiple-choice evidence: an explicit flag or a rendered
    `choices` list decides; absent both, the gold string does."""
    if info.get("is_choice") is not None:
        return bool(info["is_choice"])
    if "choices" in info and info["choices"] is not None:
        return bool(info["choices"])
    return None


def verify_code(text: str, io_spec, timeout_s: float = 8.0) -> bool:
    """Run the response's last fenced program on each test input in the
    sandbox (rlimits, a temporary dir as its jail, a network namespace
    where the host allows one; `interfaces/sandbox.py`); pass iff every
    run exits 0 with the expected stdout (whitespace-trimmed).
    `io_spec`: {"inputs": [...], "outputs": [...]} or its JSON."""
    from areal_tpu_torch.interfaces.sandbox import run_sandboxed

    prog = _extract_code_block(text)
    if prog is None:
        return False
    try:
        io_spec = json.loads(io_spec) if isinstance(io_spec, str) else io_spec
        inputs, outputs = io_spec["inputs"], io_spec["outputs"]
    except (KeyError, TypeError, json.JSONDecodeError):
        return False
    with tempfile.TemporaryDirectory(prefix="areal_torch_grade_") as jail:
        path = os.path.join(jail, "prog.py")
        with open(path, "w") as f:
            f.write(prog)
        for inp, expected in zip(inputs, outputs):
            rc, stdout = run_sandboxed(
                [sys.executable, path], input_text=inp, timeout_s=timeout_s, cwd=jail,
            )
            if rc != 0 or stdout.strip() != expected.strip():
                return False
    return True


def _extract_code_block(text: str) -> Optional[str]:
    blocks = re.findall(r"```(?:python)?\n(.*?)```", text, flags=re.DOTALL)
    return blocks[-1] if blocks else None


def _verify_math_backend(text: str, payload: Dict[str, Any]) -> bool:
    from areal_tpu_torch.interfaces import math_verify

    return bool(math_verify.verify_math(
        text, payload.get("solutions") or [], is_choice=_row_is_choice(payload),
    ))


def _verify_code_backend(text: str, payload: Dict[str, Any]) -> bool:
    return verify_code(text, payload.get("input_output"),
                       timeout_s=float(payload.get("timeout_s", 8.0)))


def _verify_judge_backend(text: str, payload: Dict[str, Any]) -> bool:
    """The judge-model stub: case-insensitive containment of
    ``payload["reference"]`` in the response's tail (``tail_chars``; 0:
    all of it).  No reference grades False."""
    ref = str(payload.get("reference", "")).strip()
    if not ref:
        return False
    tail = int(payload.get("tail_chars", 0))
    hay = text[-tail:] if tail > 0 else text
    return ref.lower() in hay.lower()


register_verifier("math", _verify_math_backend)
register_verifier("code", _verify_code_backend)
register_verifier("judge", _verify_judge_backend)

_legacy_schema_warned = False
_unknown_tasks_warned: set = set()


def _normalize_item(item: Dict[str, Any]):
    """(task, text, payload) of an item, the older flat schema (backend
    keys at the top level) included, with a warning logged once."""
    global _legacy_schema_warned
    task = str(item.get("task", "math"))
    text = str(item.get("text", ""))
    payload = item.get("payload")
    if isinstance(payload, dict):
        return task, text, payload
    payload = {k: v for k, v in item.items() if k not in ("task", "text", "trace_id")}
    if payload and not _legacy_schema_warned:
        _legacy_schema_warned = True
        logger.warning("verify item without 'payload': accepting the flat schema; send "
                       "{'task', 'text', 'payload'} (warned once)")
    return task, text, payload


def grade_item(item: Dict[str, Any]) -> bool:
    """Grade one item through the registry: the one dispatch of the
    service's handler, `RemoteVerifier`'s fallback and `RewardFabric`.
    A task with no backend grades False (warned once a task).  An item
    carrying a ``trace_id`` gets a ``graded`` lineage stamp, joining the
    grade to the sample's causal timeline."""
    task, text, payload = _normalize_item(item)
    trace_id = str(item.get("trace_id") or "")
    fn = _VERIFIERS.get(task)
    if fn is None:
        if task not in _unknown_tasks_warned:
            _unknown_tasks_warned.add(task)
            logger.warning(f"no verifier backend for task {task!r} "
                           f"(registered: {verifier_names()}); reward 0")
        if trace_id:
            tracer.lineage("graded", trace_id, task=task, passed=False, backend="missing")
        return False
    with tracer.span(f"grade:{task}", cat="host", task=task):
        ok = bool(fn(text, payload))
    if trace_id:
        tracer.lineage("graded", trace_id, task=task, passed=ok)
    return ok


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        logger.debug(fmt % args)

    def _send(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._send(200, {"status": "ok"})
        else:
            self._send(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/verify":
            self._send(404, {"error": "unknown path"})
            return
        token = getattr(self.server, "auth_token", None)
        if token and self.headers.get("X-Areal-Token") != token:
            self._send(403, {"error": "bad token"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            items = json.loads(self.rfile.read(n))["items"]
            # Code grading runs sandboxed programs for seconds: grade the
            # batch in parallel.
            with tracer.span("verify", cat="host", n=len(items)):
                with ThreadPoolExecutor(max_workers=getattr(self.server, "max_workers", 8)) as ex:
                    results = list(ex.map(grade_item, items))
            tracer.flush()
            self._send(200, {"results": results})
        except Exception as e:  # noqa: BLE001 — report to the client
            self._send(500, {"error": repr(e)})


def serve(host: str = "127.0.0.1", port: int = 8090, background: bool = False,
          token: str = "", max_workers: int = 8) -> ThreadingHTTPServer:
    """Run the verification server; `background=True` returns at once
    with the server's thread running (`shutdown()` and
    `server_close()` stop it).

    Code grading runs the submitted programs: the default bind is
    loopback, and a non-loopback deployment should set a shared token
    (`token` or AREAL_REWARD_TOKEN; clients send X-Areal-Token)."""
    tracer.configure(role="reward", rank=port)
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.auth_token = token or os.environ.get("AREAL_REWARD_TOKEN", "")
    srv.max_workers = int(max_workers)
    logger.info(f"reward service listening on {host}:{srv.server_port}")
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return srv


def post_verify(url: str, items: List[Dict[str, Any]], timeout_s: float,
                token: str = "") -> List[bool]:
    """One ``POST /verify`` round trip.  Raises VerifierShapeError when
    the results do not match the batch; the caller decides on retries."""
    headers = {"Content-Type": "application/json"}
    tok = token or os.environ.get("AREAL_REWARD_TOKEN", "")
    if tok:
        headers["X-Areal-Token"] = tok
    req = urllib.request.Request(
        url.rstrip("/") + "/verify", data=json.dumps({"items": items}).encode(),
        headers=headers,
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        out = json.loads(r.read())
    results = [bool(x) for x in out["results"]]
    if len(results) != len(items):
        raise VerifierShapeError(
            f"result length mismatch: sent {len(items)} items, got {len(results)} results"
        )
    return results


@dataclasses.dataclass
class RemoteVerifier:
    """Client of the reward service with local fallback: each batch gets
    `attempts` tries (each within `timeout_s`, `backoff_s` times the try
    between them) over the typed failures (transport errors, timeouts,
    malformed replies), then grades in-process, so a dead service costs
    throughput, never correctness.  Each failed round trip counts in
    ``areal_reward_remote_errors_total{reason}``; the fallback is logged
    at warning once, then at debug."""

    url: str
    timeout_s: float = 600.0
    token: str = ""
    attempts: int = 3
    backoff_s: float = 0.5
    _degraded: bool = dataclasses.field(default=False, init=False, repr=False)

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"RemoteVerifier.attempts must be >= 1, got {self.attempts}")
        if self.backoff_s < 0:
            raise ValueError(f"RemoteVerifier.backoff_s must be >= 0, got {self.backoff_s}")

    def _round_trip(self, items: List[Dict[str, Any]]) -> List[bool]:
        return post_verify(self.url, items, self.timeout_s, self.token)

    def verify_batch(self, items: List[Dict[str, Any]]) -> List[bool]:
        for attempt in range(1, self.attempts + 1):
            try:
                results = self._round_trip(items)
                if self._degraded:
                    self._degraded = False
                    logger.info(f"remote verification at {self.url} recovered")
                return results
            except _RETRYABLE as e:
                reason = _error_reason(e)
                _M_REMOTE_ERRORS.labels(reason).inc()
                if attempt < self.attempts:
                    logger.debug(f"remote verification attempt {attempt}/{self.attempts} "
                                 f"failed ({reason}: {e!r}); retrying")
                    time.sleep(self.backoff_s * attempt)
                    continue
                log = logger.debug if self._degraded else logger.warning
                log(f"remote verification failed after {self.attempts} attempts "
                    f"(last: {reason}: {e!r}); grading locally")
                self._degraded = True
        return [grade_item(it) for it in items]
