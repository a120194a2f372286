"""The verifier service pool: reward grading scaled across processes (port
of areal_tpu/system/verifier_pool.py).

The reference offloads grading to a remote FaaS (realhf/functioncall/) so
one slow sandboxed-code grade cannot backpressure the training loop; this
module gives the same property a fleet shape, reusing every elastic
primitive from ``system/fleet.py``:

- :class:`VerifierWorker` — one grading server.  Wraps the reward
  service's HTTP handler (``interfaces/reward_service.py``) with fleet
  membership: ``announce()`` registers the worker under
  ``names.verifier_servers`` with a keepalive TTL and a heartbeat thread,
  ``announce_metrics()`` joins the metrics plane so the supervisor can
  scrape it, and an ``AREAL_FAULTS`` kill crashes it WITHOUT
  deregistering (flight-recorder dump included) — exactly like a
  preempted node, leaving TTL expiry to evict it.

- :func:`verifier_discovery` — live membership ``{server_id: url}`` as a
  callable, the grading mirror of ``fleet.fleet_discovery``.

- :class:`VerifierPool` — the load-balancing client ``RewardFabric`` and
  ``MultiTaskRewardInterface`` plug in wherever a ``RemoteVerifier``
  fits (it exposes the same ``verify_batch``).  Each grade batch goes to
  the least-loaded live backend whose :class:`fleet.CircuitBreaker` is
  closed (an open breaker past cooldown admits the batch as its
  half-open probe); every attempt gets its own deadline; a failed
  attempt retries on a DIFFERENT server; when no backend remains the
  pool degrades to the in-process verifier registry — a dead fleet
  degrades throughput, never correctness.

``system/fleet.py``'s ``FleetSupervisor`` scales the pool through a
``SupervisorLane`` keyed on the ``grade_latency_p99`` /
``verifier_queue_depth`` signals of ``apps/metrics_report.py``
(``apps/fleet.py --verifier-spawn-cmd``).
"""

import json
import logging
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import faults as faults_mod
from areal_tpu_torch.base import metrics, name_resolve, names, tracer
from areal_tpu_torch.interfaces import reward_service
from areal_tpu_torch.system.fleet import CircuitBreaker

logger = logging.getLogger("areal_tpu_torch.verifier_pool")

_REG = metrics.default_registry()

# Client-observed grade round-trip latency per backend; the fleet signal
# `grade_latency_p99` (apps/metrics_report.py) and the supervisor's
# verifier lane scale on its p99.
_M_GRADE_SECONDS = _REG.histogram(
    "areal_verifier_grade_seconds",
    "grade batch round-trip latency by backend server",
    ("server",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0),
)
# Items the pool client currently has in flight across all backends —
# the `verifier_queue_depth` capacity signal.
_M_QUEUE_DEPTH = _REG.gauge(
    "areal_verifier_queue_depth",
    "grade items in flight across pool backends (client view)",
)
_M_POOL_SERVERS = _REG.gauge(
    "areal_verifier_pool_servers",
    "live verifier servers visible to the pool client",
)
_M_BREAKER_OPEN = _REG.gauge(
    "areal_verifier_breaker_open",
    "verifier backends currently circuit-broken open",
)
_M_BREAKER_TRANS = _REG.counter(
    "areal_verifier_breaker_transitions_total",
    "verifier breaker state transitions",
    ("state",),
)
_M_REDISPATCH = _REG.counter(
    "areal_verifier_redispatch_total",
    "grade batches retried on a different verifier server",
    ("reason",),
)
_M_GRADES = _REG.counter(
    "areal_verifier_grades_total",
    "items graded through the pool, by route",
    ("route",),  # pooled | local
)
# Worker-side signals (one per verifier process).
_M_WORKER_INFLIGHT = _REG.gauge(
    "areal_verifier_worker_inflight",
    "grade items currently being verified by this worker",
)
_M_WORKER_GRADED = _REG.counter(
    "areal_verifier_worker_graded_total",
    "items this worker graded, by task",
    ("task",),
)
_M_FAULTS = _REG.counter(
    "areal_verifier_faults_total",
    "chaos faults fired inside verifier workers",
    ("kind",),
)


def verifier_discovery(
    experiment: str, trial: str
) -> Callable[[], Dict[str, str]]:
    """``{server_id: url}`` of currently-announced verifier workers, as
    a closure the pool client polls at refresh time.  Expired keepalives
    (dead workers) drop out via the name_resolve TTL reaper, so a
    preempted worker leaves the pool without anyone deregistering it."""
    root = names.verifier_servers(experiment, trial)

    def discover() -> Dict[str, str]:
        out: Dict[str, str] = {}
        for key in name_resolve.find_subtree(root):
            sid = key[len(root) + 1:]
            try:
                out[sid] = name_resolve.get(key)
            except Exception:  # noqa: BLE001 — expired between list and get
                continue
        return out

    return discover


def list_verifiers(experiment: str, trial: str) -> List[str]:
    """Sorted live verifier server ids — the membership view the
    supervisor's verifier lane counts against its target size."""
    root = names.verifier_servers(experiment, trial)
    return sorted(
        key[len(root) + 1:] for key in name_resolve.find_subtree(root)
    )


class _WorkerHandler(reward_service._Handler):
    """The reward-service handler plus fleet-worker accounting: in-flight
    gauges, per-task graded counters, chaos injection at the ``grade``
    point, and a ``/metrics`` route for the supervisor's scrapes."""

    def do_GET(self):
        worker = getattr(self.server, "worker", None)
        path = self.path.split("?")[0]
        if path == "/health":
            inflight = worker.inflight if worker is not None else 0
            self._send(200, {"status": "ok", "inflight": inflight})
        elif path == "/metrics":
            body = metrics.default_registry().expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
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
        worker: "VerifierWorker" = self.server.worker
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            items = req["items"]
            results = worker.grade_batch(items)
            tracer.flush()
            self._send(200, {"results": results})
        except Exception as e:  # noqa: BLE001 — report to the client
            try:
                self._send(500, {"error": repr(e)})
            except Exception:  # noqa: BLE001 — crashed mid-reply
                pass


class VerifierWorker:
    """One grading server in the verifier fleet.

    Same graders and wire format as ``reward_service.serve`` (the
    verifier registry dispatches on the item's ``task`` key), plus fleet
    membership and chaos hooks.  A ``kill`` fault crashes the worker
    like a preemption: no deregistration, no draining — the flight
    recorder dumps its last grades and the TTL reaper evicts the
    announcement.  ``slow``/``error`` faults fire per grade batch at the
    ``grade`` injection point, so a chaos leg can inflate one backend's
    latency 10x without touching product code.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        token: str = "",
        max_workers: int = 8,
        faults: Optional[faults_mod.FaultInjector] = None,
    ):
        tracer.configure(role="verifier", rank=port)
        self.max_workers = max_workers
        self._stop = threading.Event()
        self._crashed = False
        self._announce_key: Optional[str] = None
        self.inflight = 0
        self.graded = 0
        self._lock = threading.Lock()
        self._faults = (
            faults
            if faults is not None
            else faults_mod.FaultInjector.from_env(
                on_fire=lambda kind: _M_FAULTS.labels(kind).inc()
            )
        )
        self.httpd = ThreadingHTTPServer((host, port), _WorkerHandler)
        self.httpd.auth_token = token
        self.httpd.worker = self
        self.port = self.httpd.server_port
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        if self._faults is not None and self._faults.kill_spec is not None:
            threading.Thread(target=self._kill_loop, daemon=True).start()
        logger.info(f"verifier worker at {self.url}")

    # ---------------- grading ----------------

    def grade_batch(self, items: List[Dict[str, Any]]) -> List[bool]:
        if self._faults is not None:
            self._faults.fire("grade")
        with self._lock:
            self.inflight += len(items)
            _M_WORKER_INFLIGHT.set(self.inflight)
        try:
            from concurrent.futures import ThreadPoolExecutor

            with tracer.span("verify", cat="host", n=len(items)):
                with ThreadPoolExecutor(self.max_workers) as ex:
                    results = list(
                        ex.map(reward_service.grade_item, items)
                    )
            for it in items:
                _M_WORKER_GRADED.labels(str(it.get("task", "math"))).inc()
            return results
        finally:
            with self._lock:
                self.inflight -= len(items)
                self.graded += len(items)
                _M_WORKER_INFLIGHT.set(self.inflight)

    # ---------------- chaos ----------------

    def _kill_loop(self) -> None:
        """Once the injector's `kill` fault is due, tear the worker down
        as a CRASH — no deregistration, the announcement expires by TTL,
        and the flight ring dumps the post-mortem."""
        while not self._stop.is_set():
            if self._faults.kill_due():
                logger.warning("FAULT kill: crashing the verifier worker")
                self._crashed = True
                tracer.flight_event("kill", port=self.port)
                tracer.flight_dump(
                    "fault_kill", role="verifier", rank=self.port
                )
                self.close()
                return
            self._stop.wait(0.05)

    # ---------------- fleet membership ----------------

    def announce(
        self,
        experiment: str,
        trial: str,
        server_id: Optional[str] = None,
        ttl: float = 10.0,
    ) -> str:
        """Join the verifier fleet under ``names.verifier_servers`` with
        a keepalive TTL and a heartbeat thread at ttl/3.  Default id is
        port-stable ``v<port>`` so a restart on the same port resumes
        the same fleet identity (and the pool's breaker probe re-closes
        it instead of treating it as a new member)."""
        sid = server_id or f"v{self.port}"
        key = names.verifier_server(experiment, trial, sid)
        name_resolve.add(
            key, self.url, keepalive_ttl=ttl, replace=True,
            delete_on_exit=True,
        )
        self._announce_key = key
        beat_s = max(ttl / 3.0, 0.05)

        def beat():
            repo = name_resolve.default()
            while not self._stop.wait(beat_s):
                try:
                    repo.touch(key)
                except Exception:  # noqa: BLE001 — key deleted: stop beating
                    return

        threading.Thread(target=beat, daemon=True).start()
        logger.info(f"announced verifier {sid} (ttl {ttl}s)")
        return sid

    def announce_metrics(
        self, experiment: str, trial: str, server_id: str
    ) -> None:
        """Join the metrics plane so metrics_report / the supervisor
        scrape this worker's /metrics alongside the rest of the trial."""
        name_resolve.add(
            names.metrics_endpoint(experiment, trial, f"verifier/{server_id}"),
            self.url,
            keepalive_ttl=30.0,
            replace=True,
            delete_on_exit=True,
        )

    def close(self) -> None:
        self._stop.set()
        if tracer.enabled():
            tracer.flush()
            logger.info(f"tracer: {tracer.flush_stats()}")
        if self._announce_key is not None and not self._crashed:
            try:
                name_resolve.delete(self._announce_key)
            except Exception:  # noqa: BLE001 — already expired is fine
                pass
        if self._faults is not None:
            self._faults.release()
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:  # noqa: BLE001 — double-close on crash path
            pass


class VerifierPool:
    """Load-balancing client over the announced verifier fleet.

    Drop-in wherever a ``RemoteVerifier`` fits: ``verify_batch(items)``
    returns one bool per item, always.  Dispatch policy per batch:

    1. refresh membership (rate-limited to ``refresh_s``); joins get a
       breaker and start taking batches within one refresh, leaves stop
       receiving new batches (in-flight round-trips just fail over);
    2. pick the least-loaded backend whose breaker admits work — a
       closed breaker, or an open one past cooldown whose half-open
       probe rides this very batch;
    3. one POST with a per-attempt deadline (``attempt_timeout_s``);
    4. on failure: count the typed reason
       (``areal_reward_remote_errors_total{reason}`` — ``shape`` for a
       result-length mismatch), trip the backend's breaker, and retry
       the batch on a DIFFERENT server (``max_attempts`` total);
    5. exhausted or empty fleet: degrade to the in-process verifier
       registry (log-once), unless ``local_fallback=False``.

    Thread-safe — ``RewardFabric`` calls ``verify_batch`` from its
    grading pool threads.
    """

    def __init__(
        self,
        discovery: Optional[Callable[[], Dict[str, str]]] = None,
        servers: Optional[Dict[str, str]] = None,
        attempt_timeout_s: float = 60.0,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        refresh_s: float = 1.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        token: str = "",
        local_fallback: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        if discovery is None and servers is None:
            raise ValueError("VerifierPool needs a discovery fn or servers")
        self.discovery = discovery or (lambda: dict(servers or {}))
        self.attempt_timeout_s = attempt_timeout_s
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = backoff_s
        self.refresh_s = refresh_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.token = token
        self.local_fallback = local_fallback
        self._clock = clock
        self._lock = threading.Lock()
        self._members: Dict[str, str] = {}  # sid -> url
        self._inflight: Dict[str, int] = {}  # sid -> items in flight
        # Breakers persist across leave/rejoin: a worker restarting on
        # the same port (same sid) is re-admitted via a half-open probe,
        # not treated as a pristine stranger.
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._last_refresh: Optional[float] = None
        self._pending = 0
        self._degraded = False
        # Plain counters for harness assertions (metrics mirror them).
        self.graded_pooled = 0
        self.graded_local = 0
        self.redispatches = 0
        self._refresh(force=True)

    # ---------------- membership ----------------

    def _breaker(self, sid: str) -> CircuitBreaker:
        br = self.breakers.get(sid)
        if br is None:
            def on_transition(state: str, _sid: str = sid) -> None:
                _M_BREAKER_TRANS.labels(state).inc()
                logger.info(f"verifier breaker[{_sid}] -> {state}")

            br = CircuitBreaker(
                threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s,
                on_transition=on_transition,
                clock=self._clock,
            )
            self.breakers[sid] = br
        return br

    def _refresh(self, force: bool = False) -> None:
        with self._lock:
            now = self._clock()
            if (
                not force
                and self._last_refresh is not None
                and now - self._last_refresh < self.refresh_s
            ):
                return
            self._last_refresh = now
            try:
                live = dict(self.discovery())
            except Exception as e:  # noqa: BLE001 — registry hiccup
                logger.warning(f"verifier discovery failed: {e!r}")
                return
            joined = set(live) - set(self._members)
            left = set(self._members) - set(live)
            self._members = live
            for sid in joined:
                self._breaker(sid)
                self._inflight.setdefault(sid, 0)
                logger.info(f"verifier joined the pool: {sid}")
            for sid in left:
                logger.info(f"verifier left the pool: {sid}")
            _M_POOL_SERVERS.set(len(self._members))
            _M_BREAKER_OPEN.set(
                sum(
                    1
                    for sid in self._members
                    if self.breakers[sid].state == CircuitBreaker.OPEN
                )
            )

    def servers(self) -> Dict[str, str]:
        self._refresh()
        with self._lock:
            return dict(self._members)

    def _choose(self, exclude: set) -> Optional[str]:
        """Least-loaded live backend whose breaker admits work; an open
        breaker past cooldown is begun as a half-open probe — the probe
        IS the next grade batch, no separate health poll.  Probes take
        priority over healthy backends: a healed server must rejoin
        promptly even when the rest of the pool could absorb the load
        (a failed probe just re-opens and the batch retries elsewhere)."""
        with self._lock:
            for sid in sorted(self._members):
                if sid in exclude:
                    continue
                br = self.breakers[sid]
                if br.probe_due():
                    br.begin_probe()
                    return sid
            candidates = [
                sid
                for sid in self._members
                if sid not in exclude
                and self.breakers[sid].allow_dispatch()
            ]
            if not candidates:
                return None
            return min(
                candidates, key=lambda s: (self._inflight.get(s, 0), s)
            )

    # ---------------- grading ----------------

    def verify_batch(self, items: List[Dict[str, Any]]) -> List[bool]:
        self._refresh()
        with self._lock:
            self._pending += len(items)
            _M_QUEUE_DEPTH.set(self._pending)
        try:
            return self._verify_locked_out(items)
        finally:
            with self._lock:
                self._pending -= len(items)
                _M_QUEUE_DEPTH.set(self._pending)

    def _verify_locked_out(self, items: List[Dict[str, Any]]) -> List[bool]:
        exclude: set = set()
        last_err: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            sid = self._choose(exclude)
            if sid is None:
                break
            with self._lock:
                url = self._members.get(sid)
                if url is None:
                    continue
                self._inflight[sid] = self._inflight.get(sid, 0) + 1
            t0 = time.monotonic()
            try:
                results = reward_service.post_verify(
                    url, items, self.attempt_timeout_s, self.token
                )
            except reward_service._RETRYABLE as e:
                last_err = e
                reason = reward_service._error_reason(e)
                reward_service._M_REMOTE_ERRORS.labels(reason).inc()
                br = self.breakers[sid]
                br.record_failure()
                _M_BREAKER_OPEN.set(
                    sum(
                        1
                        for b in self.breakers.values()
                        if b.state == CircuitBreaker.OPEN
                    )
                )
                exclude.add(sid)
                if attempt < self.max_attempts:
                    self.redispatches += 1
                    _M_REDISPATCH.labels(reason).inc()
                    logger.debug(
                        f"grade batch failed on {sid} ({reason}: {e!r}); "
                        f"retrying on a different server "
                        f"({attempt}/{self.max_attempts})"
                    )
                    if self.backoff_s > 0:
                        time.sleep(self.backoff_s)
                continue
            finally:
                with self._lock:
                    self._inflight[sid] = max(
                        0, self._inflight.get(sid, 1) - 1
                    )
            self.breakers[sid].record_success()
            _M_GRADE_SECONDS.labels(sid).observe(time.monotonic() - t0)
            _M_GRADES.labels("pooled").inc(len(items))
            with self._lock:
                self.graded_pooled += len(items)
            if self._degraded:
                self._degraded = False
                logger.info("verifier pool recovered from degradation")
            return results
        if not self.local_fallback:
            raise last_err if last_err is not None else RuntimeError(
                "verifier pool has no live backends"
            )
        log = logger.debug if self._degraded else logger.warning
        log(
            "verifier pool degraded to in-process grading "
            + (
                f"(last: {last_err!r})"
                if last_err is not None
                else "(no live backends)"
            )
        )
        self._degraded = True
        _M_GRADES.labels("local").inc(len(items))
        with self._lock:
            self.graded_local += len(items)
        return [reward_service.grade_item(it) for it in items]
