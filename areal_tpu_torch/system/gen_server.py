"""Generation service: a batching HTTP server around a GeneratorEngine
(port of areal_tpu/system/gen_server.py; it serves ``POST /generate``,
``POST /episode``, ``POST /update_weights``, ``POST /param_push``,
``POST /pause``, ``POST /resume``, ``GET /health`` and ``GET /metrics``
with the JAX server's wire formats, so both packages' `LLMAPIClient`
talk to it unchanged), and the trainer's side of decoupled generation:
`make_gen_client` and `RemoteGeneratorEngine`, the weightless
"remote_generator" backend whose `set_params` saves an HF checkpoint
and posts ``/update_weights`` (``push_mode="disk"``) or publishes the
weights once into a `ParamStore` and pushes them down a broadcast tree
(``push_mode="fabric"``, `system/paramstore.py`).

    python -m areal_tpu_torch.system.gen_server --path <hf_ckpt_dir> \
        [--port 8091] [--experiment E --trial T --keepalive-ttl 10] [--device cpu]

serves a checkpoint (on the CUDA card unless ``--device cpu``); with
``--experiment`` it announces its ``/metrics`` endpoint and joins the
fleet under ``names.gen_servers`` (`announce`: a keepalive key that a
crashed server lets expire and `close()` deletes).

Concurrent /generate requests are MERGED by a collector thread into
shared engine calls: client-side fan-out gets cross-request batching.

`update_weights_inmem` is the interruptible in-memory weight push of
asynchronous RL: the running generate call parks at its next chunk
boundary, the weights are swapped under the engine lock, and the call
resumes on its existing KV pages (one chunk of replay instead of a full
drain).  Each response carries `version_start`, the weight version its
sampling started on, and `version`, the one it finished on.

`POST /episode` (`handle_episode`) runs agent episodes, one turn a
request, on the engine slot that holds the episode's KV pages; a turn a
push parks resumes on its pages.  A continuation on a reclaimed slot
gets HTTP 409 with ``{"error_type": "slot_gone"}``.

Faults (`base/faults.py`, ``AREAL_FAULTS``) fire at the ``health``,
``generate``, ``episode`` and ``param_push`` points (``slow`` sleeps,
``hang`` blocks the request thread until `close()`, ``error`` fails the
request with HTTP 500), and ``corrupt_push@point=weight_push`` corrupts
an in-memory push's payload before its checksum, which refuses it.

``POST /update_weights`` swaps the weights for an HF checkpoint dir on
this host; with `ckpt_root` (or ``AREAL_GEN_CKPT_ROOT``) set, a path
that resolves outside it is refused.

``POST /param_push`` takes one hop of a fabric push
(`_handle_param_push`): it relays the raw payload to its subtree's
children first, then applies it through the checksummed
`update_weights_inmem` at the pushed (absolute) version; a
``kill@point=param_push`` fault crashes the server there, and a
point-less ``kill@t=...`` crashes it once due (`_kill_loop`); each
crash dumps the flight ring first.

Tracing (`base/tracer.py`): a request's ``X-Areal-Trace`` header (the
dispatcher's lineage id) gets its ``first_token``, ``generated`` and
``failed`` stamps and a ``request:<qid>`` span; each engine call is a
``gen_batch`` span, and the collector samples the ``gen_queue`` gauge.
The command line traces as role ``gen_server``.

Not yet ported: the ZMQ transport (ROADMAP queue 1 item 7.8).
"""

import dataclasses
import json
import logging
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    APIGenerateOutput,
    GenerationHyperparameters,
    LLMAPIClient,
    SlotGoneError,
)
from areal_tpu_torch.base import integrity, metrics, tracer
from areal_tpu_torch.base.faults import FaultInjector

logger = logging.getLogger("areal_tpu_torch.gen_server")

# The JAX server's metrics, registered once a process: every server in
# a process shares one series a name.
_REG = metrics.default_registry()
_M_QUEUE_DEPTH = _REG.gauge("areal_gen_queue_depth",
                            "requests waiting in the batching collector queue")
_M_REQUESTS = _REG.counter("areal_gen_requests_total",
                           "generate requests finished, by terminal status", ("status",))
_M_REQUEST_SECONDS = _REG.histogram("areal_gen_request_seconds",
                                    "request latency, enqueue to reply")
_M_BATCHES = _REG.counter("areal_gen_batches_total", "collector batches dispatched")
_M_WEIGHT_VERSION = _REG.gauge("areal_gen_weight_version", "current serving weight version")
_M_WEIGHT_UPDATES = _REG.counter("areal_gen_weight_updates_total", "weight swaps applied")
_M_CAPACITY = _REG.gauge("areal_gen_capacity_slots", "max concurrent decode slots")
_M_PAUSED = _REG.gauge("areal_gen_paused", "1 while paused for a weight swap")
_M_FAULTS = _REG.counter("areal_gen_faults_total",
                         "injected chaos faults fired (AREAL_FAULTS), by kind", ("kind",))
# Episode continuations refused because the engine reclaimed the slot:
# each costs the controller a full-conversation re-admission.
_M_EPISODE_SLOT_LOST = _REG.counter(
    "areal_gen_episode_slot_lost_total",
    "episode continuations rejected: slot reclaimed",
)


@dataclasses.dataclass
class _Pending:
    qid: str
    prompt_ids: List[int]
    gconfig: GenerationHyperparameters
    done: threading.Event
    seed: Optional[int] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    t_enq: Optional[int] = None  # enqueue time (monotonic ns)
    # The dispatcher's lineage id (the X-Areal-Trace header).
    trace_id: Optional[str] = None


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients past that has its connections dropped and retried about a
    # second later, after the batcher's linger window — the burst then
    # splits into several engine calls.
    request_queue_size = 1024


def _gkey(p: _Pending):
    g = p.gconfig
    # Requests merged into one engine call share one random stream, so
    # the seed is part of the key (stream isolation between clients).
    return (g.n, g.max_new_tokens, g.min_new_tokens, g.greedy, g.top_p,
            g.top_k, g.temperature, g.spec_decode_k, g.spec_ngram, g.stop,
            p.seed)


class GenerationServer:
    """Batching HTTP front-end over one GeneratorEngine (which runs on
    the CUDA card unless it was built with device="cpu")."""

    def __init__(
        self,
        engine,  # areal_tpu_torch.engines.generator.GeneratorEngine
        host: str = "127.0.0.1",
        port: int = 0,
        max_wait_ms: float = 5.0,
        max_batch: int = 256,
        token: str = "",
        faults: Optional[FaultInjector] = None,
        # /update_weights loads a path and swaps the serving weights:
        # confine it to this directory when set.
        ckpt_root: str = "",
        # The starting weight version: a restarted fleet member rejoins
        # at the trainer's version instead of 0.
        version: int = 0,
    ):
        self.engine = engine
        self.ckpt_root = ckpt_root or os.environ.get("AREAL_GEN_CKPT_ROOT", "")
        # Chaos: defaults to the AREAL_FAULTS spec (None when unset).
        self._faults = faults if faults is not None else FaultInjector.from_env()
        if self._faults is not None and self._faults.on_fire is None:
            self._faults.on_fire = lambda kind: _M_FAULTS.labels(kind).inc()
        self.version = int(version)
        _M_CAPACITY.set(int(engine.max_decode_batch))
        # Fleet membership (announce()): the keepalive key.  A kill fault
        # closes the server as a crash, without deregistering (its
        # announcement expires by its TTL, as a preempted node's does).
        self._announce_key: Optional[str] = None
        self._announce_thread: Optional[threading.Thread] = None
        self._crashed = False
        self.max_wait_ms = max_wait_ms
        self.max_batch = max_batch
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._seed = 0
        # One engine call at a time; the weight swap takes it too.
        self._engine_lock = threading.Lock()
        # Pause/resume: set while a weight push (or a /pause) holds the
        # server; a parked generate call waits on _resume_cond.
        self._pause_evt = threading.Event()
        self._resume_cond = threading.Condition()
        # One in-memory push at a time.
        self._update_mutex = threading.Lock()
        self.inmem_updates = 0
        # Guards version and the pause flag as /health reads them.
        self._health_lock = threading.Lock()
        self._token = token
        # episode_id -> trace_id: later turns join the start op's lineage.
        self._episode_traces: Dict[str, str] = {}
        if not token and host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(
                f"refusing to bind {host} without a token: pass token= to "
                "serve an open network port"
            )

        srv = self

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
                    self._send(200, srv.health_info())
                elif self.path.split("?")[0] == "/metrics":
                    body = metrics.default_registry().expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": "unknown path"})

            def _read_param_push(self, n: int):
                """(meta, payload) of a /param_push body of `n` bytes,
                read straight into one writable buffer: the leaves
                deserialized from it need no copy on the host."""
                head = self.rfile.read(8)
                mlen = int.from_bytes(head, "big") if len(head) == 8 else -1
                if mlen < 0 or 8 + mlen > n:
                    raise ValueError("param_push meta prefix exceeds the body")
                meta = json.loads(self.rfile.read(mlen))
                payload = np.empty(n - 8 - mlen, np.uint8)  # not zero-filled: read over
                view, got = memoryview(payload), 0
                while got < len(payload):
                    k = self.rfile.readinto(view[got:])
                    if not k:
                        raise ValueError(f"param_push body ended at {8 + mlen + got} of {n} bytes")
                    got += k
                return meta, view

            def do_POST(self):
                if srv._token and self.headers.get("X-Areal-Token") != srv._token:
                    # Drain the body first: a reply while the client still
                    # writes breaks its pipe before it reads the 403.
                    left = int(self.headers.get("Content-Length", 0) or 0)
                    while left > 0:
                        got = len(self.rfile.read(min(left, 1 << 20)))
                        if not got:
                            break
                        left -= got
                    self._send(403, {"error": "bad token"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if self.path == "/param_push":
                        # The binary plane: a meta prefix, its JSON and the
                        # raw serialized params, never parsed as JSON.
                        self._send(200, srv._handle_param_push(*self._read_param_push(n)))
                        return
                    req = json.loads(self.rfile.read(n))
                    # The lineage id rides a header, so any client (or a
                    # proxy) stamps it without touching the body.
                    trace_hdr = self.headers.get("X-Areal-Trace")
                    if trace_hdr and isinstance(req, dict):
                        req.setdefault("trace_id", trace_hdr)
                    if self.path == "/generate":
                        self._send(200, srv._handle_generate(req))
                    elif self.path == "/episode":
                        self._send(200, srv.handle_episode(req))
                    elif self.path == "/update_weights":
                        self._send(200, srv._handle_update(req))
                    elif self.path == "/pause":
                        srv.pause()
                        self._send(200, {"paused": True, "version": srv.version})
                    elif self.path == "/resume":
                        srv.resume()
                        self._send(200, {"paused": False, "version": srv.version})
                    else:
                        self._send(404, {"error": "unknown path"})
                except SlotGoneError as e:
                    # Typed, not a silent fresh admission: the controller
                    # decides to re-admit the conversation.
                    self._send(409, {
                        "error": str(e), "error_type": "slot_gone",
                        "episode_id": e.episode_id, "reason": e.reason,
                    })
                except Exception as e:  # noqa: BLE001 — report to client
                    logger.exception("request failed")
                    self._send(500, {"error": repr(e)})

        self._http = _HTTPServer((host, port), _Handler)
        self.port = self._http.server_port
        self.url = f"http://{host}:{self.port}"
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )
        self._collector_thread = threading.Thread(
            target=self._collect_loop, daemon=True
        )
        self._http_thread.start()
        self._collector_thread.start()
        if self._faults is not None and self._faults.kill_spec is not None:
            threading.Thread(target=self._kill_loop, daemon=True).start()
        logger.info(f"generation server at {self.url}")

    def _fire_fault(self, point: str) -> None:
        if self._faults is not None:
            self._faults.fire(point)

    def _kill_loop(self) -> None:
        """A point-less ``kill`` fault: once due, crash the server (no
        deregistration, no draining, as a preempted node), after the
        flight ring's dump; its announcement expires by its TTL."""
        while not self._stop.is_set():
            if self._faults.kill_due():
                logger.warning("FAULT kill: crashing the generation server")
                self._crashed = True
                tracer.flight_event("kill", port=self.port)
                tracer.flight_dump("fault_kill", role="gen_server", rank=self.port)
                self.close()
                return
            self._stop.wait(0.05)

    # ---------------- fleet membership ----------------

    def announce(self, experiment: str, trial: str, server_id: Optional[str] = None,
                 ttl: float = 10.0) -> str:
        """Join the fleet: register this server's URL under
        `names.gen_servers` with a keepalive TTL and touch it from a
        heartbeat thread every ttl/3.  A server that stops beating (a
        crash) expires out of the listing; `close()` deregisters at once.
        Returns the server id (default ``s<port>``, stable across a
        restart on the same port)."""
        from areal_tpu_torch.base import name_resolve, names

        sid = server_id or f"s{self.port}"
        key = names.gen_server(experiment, trial, sid)
        name_resolve.add(key, self.url, keepalive_ttl=ttl, replace=True, delete_on_exit=True)
        self._announce_key = key
        beat_s = max(ttl / 3.0, 0.05)

        def beat():
            repo = name_resolve.default()
            while not self._stop.wait(beat_s):
                try:
                    repo.touch(key)
                except Exception:  # noqa: BLE001 — key deleted: stop beating
                    return

        self._announce_thread = threading.Thread(target=beat, daemon=True)
        self._announce_thread.start()
        logger.info(f"announced fleet member {sid} (ttl {ttl}s)")
        return sid

    def health_info(self) -> Dict:
        """Liveness + the load signals a rollout controller balances on;
        the engine's (live_slots, kv_utilization) pair is one atomically
        replaced tuple."""
        self._fire_fault("health")
        eng = self.engine
        live, kvu = eng.load_state
        with self._health_lock:
            version = self.version
            paused = self._pause_evt.is_set()
        qd = self._queue.qsize()
        _M_QUEUE_DEPTH.set(qd)
        _M_WEIGHT_VERSION.set(version)
        return {
            "status": "ok",
            "version": version,
            "queue_depth": qd,
            "live_slots": int(live),
            "kv_utilization": float(kvu),
            "capacity": int(eng.max_decode_batch),
            "paused": paused,
        }

    # ---------------- pause / resume / in-memory weight push ----------------

    def pause(self) -> None:
        """Stop decoding at the next chunk boundary: the running generate
        call parks (releasing the engine lock) and new batches wait until
        resume()."""
        with self._health_lock:
            self._pause_evt.set()
        _M_PAUSED.set(1)
        self.engine.interrupt()

    def resume(self) -> None:
        with self._health_lock:
            self._pause_evt.clear()
        _M_PAUSED.set(0)
        self.engine.clear_interrupt()
        with self._resume_cond:
            self._resume_cond.notify_all()

    def update_weights_inmem(self, params, checksum=None, version=None) -> int:
        """Interruptible in-memory weight push: pause at a chunk boundary,
        swap `params` into the engine under the engine lock, bump the
        version, resume — interrupted requests continue on their existing
        KV pages.

        `version` (a fabric push) sets the ABSOLUTE serving version; a
        push at or behind the current one is a no-op that returns the
        current version (a repair and a relay racing on one server must
        not apply twice).  Without it the version bumps by one.
        `checksum` (`integrity.params_checksum` at the pusher) is verified
        BEFORE the swap: a mismatch raises `integrity.WeightChecksumError`
        and the server keeps serving its previous weights.  Returns the
        version now served."""
        if version is not None:
            with self._health_lock:
                if int(version) <= self.version:
                    return self.version
        if self._faults is not None and self._faults.poison("weight_push") == "corrupt_push":
            # In-flight corruption, against the real verification below.
            params = integrity.corrupt_params(params)
        with self._update_mutex:
            if checksum is not None:
                # Reduced on the engine's device: host leaves stream to
                # it a chunk at a time, so no second copy of the tree
                # lands on the card before the swap.
                try:
                    integrity.verify_checksum(params, checksum, device=self.engine.device)
                except integrity.WeightChecksumError:
                    # A fault instant: the dump shows what this server
                    # was doing when the bad payload arrived.
                    tracer.flight_event("push_rejected", port=self.port, version=self.version)
                    tracer.flight_dump("push_rejected", role="gen_server", rank=self.port)
                    raise
            self.pause()
            try:
                with self._engine_lock:
                    with self._health_lock:
                        if version is not None and int(version) <= self.version:
                            # Another push of this (or a newer) version
                            # landed while this one waited on the mutex.
                            return self.version
                    self.engine.set_params(params)
                    with self._health_lock:
                        self.version = self.version + 1 if version is None else int(version)
                        v = self.version
                    self.inmem_updates += 1
                    _M_WEIGHT_VERSION.set(v)
                    _M_WEIGHT_UPDATES.inc()
            finally:
                self.resume()
        logger.info(f"weights updated in memory -> version {v}")
        return v

    def _handle_param_push(self, req: Dict, payload) -> Dict:
        """One hop of a fabric push (`system/paramstore.py`): relay the
        raw payload to this node's subtree children FIRST (the fan-out
        keeps moving while the local apply waits for a chunk boundary),
        then deserialize it against the engine's own params and apply it
        through the checksummed, interruptible `update_weights_inmem` at
        the pushed version.  The ack gathers the subtree's outcomes:
        ``applied`` (sids now serving the version) and ``failed`` (sids
        orphaned, and why).  A local failure never fails the ack: each
        subtree degrades on its own."""
        if self._faults is not None and self._faults.kill_point("param_push"):
            # A relay preempted mid-broadcast: crash semantics (no
            # deregistration), its subtree orphaned.
            logger.warning("FAULT kill: crashing relay mid-broadcast")
            self._crashed = True
            tracer.flight_event("kill", port=self.port)
            tracer.flight_dump("fault_kill", role="gen_server", rank=self.port)
            self.close()
            raise RuntimeError("server killed at param_push")
        self._fire_fault("param_push")
        from areal_tpu_torch.system import paramstore

        t0 = time.monotonic()
        version = int(req["version"])
        manifest = req["manifest"]
        checksum = (np.asarray(req["checksum"], np.float64)
                    if req.get("checksum") is not None else None)
        node = req.get("subtree") or {}
        sid = str(node.get("sid") or f"s{self.port}")
        applied, failed = paramstore.relay_subtrees(
            node.get("children") or [],
            {"cmd": "param_push", "version": version, "manifest": manifest,
             "checksum": req.get("checksum")},
            payload, token=self._token, timeout_s=float(req.get("timeout_s", 120.0)),
        )
        t_relay = time.monotonic()
        try:
            params = paramstore.deserialize_params(self.engine.params, manifest, payload)
            self.update_weights_inmem(params, checksum=checksum, version=version)
            applied.insert(0, sid)
        except Exception as e:  # noqa: BLE001 — per-subtree degradation
            logger.warning(f"local param_push apply failed: {e!r}")
            failed.append({"sid": sid, "error": repr(e)})
        logger.info(f"param_push v{version} at {sid}: relay to "
                    f"{len(node.get('children') or [])} children {t_relay - t0:.3f} s, apply "
                    f"{time.monotonic() - t_relay:.3f} s -> version {self.version}")
        return {"version": self.version, "applied": applied, "failed": failed}

    def _handle_update(self, req: Dict) -> Dict:
        """Swap the weights for the HF checkpoint at ``req["path"]`` and
        bump the version.  Waits for a running generate call unless a
        /pause parked it."""
        from areal_tpu_torch.models.hf import registry as hf

        path = os.path.realpath(str(req["path"]))
        if self.ckpt_root and not path.startswith(os.path.realpath(self.ckpt_root) + os.sep):
            raise ValueError(f"update path {path!r} outside checkpoint root {self.ckpt_root!r}")
        # Load the resolved path: the raw one could be a symlink swapped
        # after the check.
        _, params = hf.load_hf_checkpoint(
            path, dtype=self.engine.compute_dtype, device=self.engine.device
        )
        with self._engine_lock:
            self.engine.set_params(params)
            with self._health_lock:
                self.version += 1
                v = self.version
            _M_WEIGHT_VERSION.set(v)
            _M_WEIGHT_UPDATES.inc()
        logger.info(f"weights updated from {req['path']} -> version {v}")
        return {"version": v}

    def _await_resume(self) -> None:
        """Block a parked _run_subgroup until resume(); the caller does
        not hold the engine lock (the weight swap needs it)."""
        while self._pause_evt.is_set():
            if self._stop.is_set():
                raise RuntimeError("generation server shutting down")
            with self._resume_cond:
                self._resume_cond.wait(timeout=0.2)

    # ---------------- request handling ----------------

    def _handle_generate(self, req: Dict) -> Dict:
        # Chaos: may sleep, hang this request's thread or raise (HTTP 500).
        self._fire_fault("generate")
        g = GenerationHyperparameters(
            n=int(req.get("n", 1)),
            max_new_tokens=int(req.get("max_new_tokens", 256)),
            min_new_tokens=int(req.get("min_new_tokens", 0)),
            greedy=bool(req.get("greedy", False)),
            top_p=float(req.get("top_p", 1.0)),
            top_k=int(req.get("top_k", 0)),
            temperature=float(req.get("temperature", 1.0)),
            spec_decode_k=int(req.get("spec_decode_k", 0)),
            spec_ngram=int(req.get("spec_ngram", 3)),
            stop=req.get("stop") or (),
        )
        p = _Pending(
            qid=str(req["qid"]),
            prompt_ids=[int(t) for t in req["prompt_ids"]],
            gconfig=g,
            done=threading.Event(),
            seed=(int(req["seed"]) if req.get("seed") is not None else None),
            t_enq=time.monotonic_ns(),
            trace_id=(str(req["trace_id"]) if req.get("trace_id") else None),
        )
        self._queue.put(p)
        while not p.done.wait(timeout=1.0):
            if self._stop.is_set():
                raise RuntimeError("generation server shutting down")
            if not self._collector_thread.is_alive():
                raise RuntimeError("generation collector thread died")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def handle_episode(self, req: Dict) -> Dict:
        """Agent episode ops (start/extend/release), one turn a request,
        pinned to the engine slot that holds the episode's KV pages.

        Runs on the request's own thread, not through the collector: an
        episode op needs ITS slot, and the engine lock already serializes
        it against batched generates and weight swaps.  A push parks the
        turn at a chunk boundary; the loop below frees the engine for the
        swap and resumes the SAME turn on its pages.  An op on a
        reclaimed slot raises SlotGoneError (HTTP 409) and counts in
        ``areal_gen_episode_slot_lost_total``."""
        self._fire_fault("episode")
        eng = self.engine
        op = str(req.get("op", ""))
        ep_id = str(req.get("episode_id", ""))
        if not ep_id:
            raise ValueError("episode op needs a non-empty episode_id")
        # Lineage: the start op carries the trace_id; later turns of the
        # episode take it from the per-episode store.
        trace_id = str(req["trace_id"]) if req.get("trace_id") else None
        if op == "start" and trace_id:
            self._episode_traces[ep_id] = trace_id
        elif trace_id is None:
            trace_id = self._episode_traces.get(ep_id)
        if op == "release":
            self._episode_traces.pop(ep_id, None)
            with self._engine_lock:
                released = bool(eng.episode_release(ep_id))
            if trace_id:
                tracer.lineage("turn", trace_id, episode_id=ep_id, op="release")
            return {"episode_id": ep_id, "released": released, "version": self.version}
        if op == "start":
            g = GenerationHyperparameters(**req.get("gconfig", {}))
            prompt_ids = [int(t) for t in req.get("prompt_ids", [])]
            budget = int(req.get("token_budget", 0))
            seed = int(req.get("seed", 0))

            def first():
                return eng.episode_start(ep_id, prompt_ids, g, token_budget=budget, seed=seed)
        elif op == "extend":
            obs = [int(t) for t in req.get("obs_ids", [])]

            def first():
                return eng.episode_extend(ep_id, obs)
        else:
            raise ValueError(f"unknown episode op {op!r}")
        try:
            if self._pause_evt.is_set():
                self._await_resume()
            self._engine_lock.acquire()
            locked = True
            try:
                version_start = self.version
                out = first()
                while out is None:
                    # Parked by pause(): free the engine for the swap,
                    # then resume THIS turn on its pages.
                    self._engine_lock.release()
                    locked = False
                    self._await_resume()
                    self._engine_lock.acquire()
                    locked = True
                    out = eng.episode_resume(ep_id)
                version = self.version
            finally:
                if locked:
                    self._engine_lock.release()
        except SlotGoneError:
            _M_EPISODE_SLOT_LOST.inc()
            self._episode_traces.pop(ep_id, None)
            raise
        out = dict(out)
        out["version"] = version
        out["version_start"] = version_start
        if trace_id:
            tracer.lineage("turn", trace_id, episode_id=ep_id, op=op,
                           stop_reason=str(out.get("stop_reason", "")), version=version)
        return out

    # ---------------- batching collector ----------------

    def _collect_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            # The collector must never die: every /generate blocks on
            # p.done.  _run_subgroup guards per-group errors; this guards
            # the batching glue and fails the batch loudly.
            try:
                # Linger briefly so concurrent clients land in one call.
                time.sleep(self.max_wait_ms / 1000.0)
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                # How deep the queue sits when a batch is picked: the
                # server-side pressure signal.
                tracer.counter("gen_queue", depth=self._queue.qsize(), batch=len(batch))
                _M_QUEUE_DEPTH.set(self._queue.qsize())
                _M_BATCHES.inc()
                by_g: Dict[Any, List[_Pending]] = {}
                for p in batch:
                    by_g.setdefault(_gkey(p), []).append(p)
                for group in by_g.values():
                    self._run_group(group)
                tracer.flush()
            except Exception as e:  # noqa: BLE001
                logger.exception("collector batching error")
                for p in batch:
                    if not p.done.is_set():
                        p.error = f"collector error: {e!r}"
                        p.done.set()
        # Shutdown: fail anything still queued so no client hangs.
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = "generation server shutting down"
            p.done.set()

    def _run_group(self, group: List[_Pending]):
        """Split the group against the engine's KV page budget (when the
        pool is explicitly sized), CoW-aware, and run each sub-group as
        one generate call.  A request that exceeds the budget even alone
        fails up front with the capacity error."""
        budget = self.engine.page_budget_tokens
        if budget is None:
            return self._run_subgroup(group)
        sub: List[_Pending] = []
        used = 0
        for p in group:
            g = p.gconfig
            need = self.engine.group_footprint_tokens(
                len(p.prompt_ids), g.max_new_tokens, g.n
            )
            if need > budget:
                logger.error(f"rejecting {p.qid}: footprint {need} > {budget}")
                p.error = (
                    f"request footprint {need} tokens (n={g.n}, prompt "
                    f"{len(p.prompt_ids)} + max_new {g.max_new_tokens}) "
                    f"exceeds the KV page budget of {budget} tokens; raise "
                    f"kv_pool_pages or shrink the request"
                )
                _M_REQUESTS.labels("rejected").inc()
                if p.t_enq is not None:
                    _M_REQUEST_SECONDS.observe((time.monotonic_ns() - p.t_enq) / 1e9)
                    self._request_span(p, error=True)
                if p.trace_id:
                    tracer.lineage("failed", p.trace_id, qid=p.qid, error=p.error)
                p.done.set()
                continue
            if sub and used + need > budget:
                self._run_subgroup(sub)
                sub, used = [], 0
            sub.append(p)
            used += need
        if sub:
            self._run_subgroup(sub)

    def _run_subgroup(self, group: List[_Pending]):
        try:
            # Wait out a pause before dispatch, so a batch arriving
            # mid-push does not race the swap for the engine lock.
            if self._pause_evt.is_set():
                self._await_resume()
            g = group[0].gconfig
            # Internal ids are positional: client qids may collide.
            uids = [f"u{i}" for i in range(len(group))]
            sample = SequenceSample(
                keys={"packed_prompts"},
                ids=uids,
                seqlens={"packed_prompts": [[len(p.prompt_ids)] for p in group]},
                data={
                    "packed_prompts": np.concatenate(
                        [np.asarray(p.prompt_ids, np.int32) for p in group]
                    )
                },
            )
            self._seed += 1
            seed = group[0].seed if group[0].seed is not None else self._seed
            # Uncategorized: the engine's compute spans attribute the
            # time; this one shows the lock wait and the call's shape.
            with tracer.span("gen_batch", n_reqs=len(group)):
                self._engine_lock.acquire()
                locked = True
                try:
                    version_start = self.version
                    for p in group:
                        if p.trace_id:
                            tracer.lineage("first_token", p.trace_id, qid=p.qid)
                    out = self.engine.generate(sample, MicroBatchSpec(), g, seed=seed)
                    while out is None:
                        # Parked by pause(): free the engine for the weight
                        # swap, wait for resume(), continue the interrupted
                        # call on its existing KV pages.
                        self._engine_lock.release()
                        locked = False
                        self._await_resume()
                        self._engine_lock.acquire()
                        locked = True
                        out = self.engine.resume_generate()
                    version = self.version
                finally:
                    if locked:
                        self._engine_lock.release()
            per_id = {s.ids[0]: s for s in out.unpack()}
            for uid, p in zip(uids, group):
                p.result = _extract_output(
                    per_id[uid], len(p.prompt_ids), g.n, version, version_start
                )
        except Exception as e:  # noqa: BLE001 — fail the whole group
            logger.exception("generation batch failed")
            for p in group:
                p.error = repr(e)
        finally:
            for p in group:
                _M_REQUESTS.labels("error" if p.error else "ok").inc()
                if p.t_enq is not None:
                    _M_REQUEST_SECONDS.observe((time.monotonic_ns() - p.t_enq) / 1e9)
                    self._request_span(p, error=bool(p.error))
                if p.trace_id:
                    tracer.lineage("generated", p.trace_id, qid=p.qid, error=bool(p.error))
                p.done.set()

    def _request_span(self, p: _Pending, error: bool) -> None:
        """The request's lifetime, enqueue to reply, across threads."""
        args = dict(qid=p.qid, n=p.gconfig.n, prompt_len=len(p.prompt_ids), error=error)
        if p.trace_id:
            args["trace_id"] = p.trace_id
        tracer.complete(f"request:{p.qid}", start_ns=p.t_enq, **args)

    def close(self):
        self._stop.set()
        if self._faults is not None:
            self._faults.release()  # hung requests fail now, not at the cap
        if self._announce_key and not self._crashed:
            # A graceful leave deregisters now; a crash leaves the key to
            # expire by its TTL.
            from areal_tpu_torch.base import name_resolve

            try:
                name_resolve.delete(self._announce_key)
            except Exception:  # noqa: BLE001 — already expired or deleted
                pass
            self._announce_key = None
        self._http.shutdown()
        self._http.server_close()
        self._collector_thread.join(timeout=5.0)
        tracer.flush()


def _extract_output(
    s: SequenceSample, prompt_len: int, n: int, version: int,
    version_start: Optional[int] = None,
) -> Dict[str, Any]:
    """Slice one request's SequenceSample (`GeneratorEngine._assemble`
    layout) back into API JSON: per-response generated ids + logprobs."""
    toks = np.asarray(s.data["packed_input_ids"])
    lps = np.asarray(s.data["packed_logprobs"])
    noe = np.asarray(s.data["seq_no_eos_mask"])
    lens = s.seqlens["packed_input_ids"][0]
    out_ids, out_lps = [], []
    t_off = lp_off = 0
    for r in range(n):
        full_len = int(lens[r])
        row = toks[t_off : t_off + full_len]
        row_lp = lps[lp_off : lp_off + full_len - 1]
        out_ids.append([int(x) for x in row[prompt_len:]])
        out_lps.append([float(x) for x in row_lp[prompt_len - 1 : full_len - 1]])
        t_off += full_len
        lp_off += full_len - 1
    return {
        "output_ids": out_ids,
        "output_logprobs": out_lps,
        "no_eos": [bool(x) for x in noe[:n]],
        "version": version,
        "version_start": version if version_start is None else version_start,
    }


def make_gen_client(url: str, **kw) -> LLMAPIClient:
    """The client of the generation server at `url` (http:// only)."""
    if not url.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"generation server URL {url!r}: only http:// is ported "
            "(ROADMAP queue 1, item 7.8: the ZMQ transport)"
        )
    return LLMAPIClient(url, **kw)


class RemoteGeneratorEngine:
    """A generation engine backed by remote GenerationServers (backend
    "remote_generator"): this worker holds no generation weights.
    `generate` splits the prompts round-robin across the servers (each
    client's share co-batches server-side).  `set_params` ships new
    weights to every server: with ``push_mode="disk"`` it saves an HF
    checkpoint through the port's HF IO and posts ``/update_weights`` to
    every server at once, paused around the push when `inmem_sync` (the
    running generate call parks at a chunk boundary and resumes on its
    KV pages under the new weights); with ``push_mode="fabric"`` it
    publishes the weights once into a `ParamStore` and pushes them down
    a broadcast tree of fan-out `push_fanout` over the servers (no disk
    checkpoint; each server relays, then swaps in place)."""

    def __init__(
        self,
        cfg,
        url,  # str | List[str]: one client a serving rank
        model_type: str = "qwen2",
        sync_dir: Optional[str] = None,
        inmem_sync: bool = False,
        push_mode: str = "disk",
        push_fanout: int = 2,
    ):
        if push_mode not in ("disk", "fabric"):
            raise ValueError(f"unknown push_mode {push_mode!r}")
        self.cfg = cfg
        self.inmem_sync = inmem_sync
        self.push_mode = push_mode
        self.push_fanout = int(push_fanout)
        self._fabric = None  # built at the first fabric push
        urls = [url] if isinstance(url, str) else list(url)
        if not urls:
            raise ValueError("remote generator needs at least one URL")
        self.clients = [make_gen_client(u) for u in urls]
        self.model_type = model_type
        # One dir an engine: two trials on one host never interleave
        # checkpoint shards.
        self.sync_dir = sync_dir or tempfile.mkdtemp(prefix="areal_torch_gen_sync_")
        self.pushes = 0

    def train_batch(self, *a, **k):
        raise NotImplementedError("RemoteGeneratorEngine is generation-only")

    def forward(self, *a, **k):
        raise NotImplementedError("RemoteGeneratorEngine is generation-only")

    def get_params(self):
        raise NotImplementedError("remote generator weights live on the server")

    def generate(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        gconfig: GenerationHyperparameters,
        prompt_key: str = "packed_prompts",
        seed: int = 0,
    ) -> SequenceSample:
        from concurrent.futures import ThreadPoolExecutor

        from areal_tpu_torch.engines.generator import assemble_rollout

        prompts = np.asarray(sample.data[prompt_key])
        bounds = sample.cu_seqlens(prompt_key)
        inps = [
            APIGenerateInput(
                qid=sample.ids[i],
                prompt_ids=[int(t) for t in prompts[bounds[i]:bounds[i + 1]]],
                gconfig=gconfig,
                seed=seed,
            )
            for i in range(sample.bs)
        ]
        outs: Dict[str, APIGenerateOutput] = {}
        shards = [inps[k::len(self.clients)] for k in range(len(self.clients))]
        with ThreadPoolExecutor(len(self.clients)) as pool:
            for batch in pool.map(lambda cs: cs[0].generate_batch(cs[1]),
                                  zip(self.clients, shards)):
                for o in batch:
                    outs[o.qid] = o

        def fetch(i, r):
            o = outs[sample.ids[i]]
            return o.output_ids[r], o.output_logprobs[r], o.no_eos[r]

        return assemble_rollout(sample, prompt_key, gconfig.n, fetch)

    def set_params(self, params) -> None:
        """Ship `params` to every server: publish and push them down the
        broadcast tree (fabric), or save them as an HF checkpoint in
        `sync_dir` and post ``/update_weights`` to every server at once
        (disk)."""
        if self.push_mode == "fabric":
            self._fabric_push(params)
            self.pushes += 1
            return
        from concurrent.futures import ThreadPoolExecutor

        from areal_tpu_torch.models.hf import registry as hf

        os.makedirs(self.sync_dir, exist_ok=True)
        hf.save_hf_checkpoint(self.sync_dir, self.cfg, params, model_type=self.model_type)
        if self.inmem_sync:
            for c in self.clients:
                c.pause()
        try:
            with ThreadPoolExecutor(len(self.clients)) as pool:
                list(pool.map(lambda c: c.update_weights_from_disk(self.sync_dir),
                              self.clients))
        finally:
            if self.inmem_sync:
                for c in self.clients:
                    c.resume()
        self.pushes += 1

    def _fabric_push(self, params) -> None:
        """Serialize and checksum once (the leaves copied off the card
        into one host buffer), then push down the tree.  An orphaned
        subtree (a relay died mid-push) keeps serving its version until
        the next push: a partial push costs staleness, never
        correctness (every apply is checksummed)."""
        from areal_tpu_torch.system import paramstore

        if self._fabric is None:
            # The membership is the engine's static client set: sid = url.
            self._fabric = paramstore.BroadcastFabric(
                paramstore.ParamStore(),
                discovery=lambda: {c.url: c.url for c in self.clients},
                fanout=self.push_fanout,
            )
        self._fabric.store.publish(params)
        report = self._fabric.push()
        if report.orphans:
            logger.warning(
                f"fabric push v{report.version}: {len(report.orphans)} server(s) orphaned "
                f"({[o['sid'] for o in report.orphans]}); they serve the previous version "
                "until the next push"
            )


def main(argv=None) -> None:
    """A standalone server: ``python -m areal_tpu_torch.system.gen_server
    --path <hf_ckpt_dir> [--port 8091] [--device cpu]``; on the CUDA card
    unless ``--device cpu``.  Serves until interrupted, or until a kill
    fault crashes the server (then the process exits too)."""
    import argparse

    from areal_tpu_torch.base.device import resolve_device
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.hf import registry as hf

    p = argparse.ArgumentParser(prog="areal_tpu_torch.system.gen_server")
    p.add_argument("--path", required=True, help="HF checkpoint dir")
    p.add_argument("--parallel", default="d1",
                   help="only d1 (ROADMAP queue 1 item 8.6b: generation on a sharded "
                        "layout)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8091)
    p.add_argument("--eos-token-id", type=int, default=None)
    p.add_argument("--max-decode-batch", type=int, default=64)
    p.add_argument("--kv-page-size", type=int, default=128,
                   help="tokens per KV page in the paged decode pool")
    p.add_argument("--kv-pool-pages", type=int, default=0,
                   help="fixed KV pool size in pages (0 = auto-size)")
    p.add_argument("--no-paged-kv", action="store_true",
                   help="dense grow-by-doubling KV window instead of the paged pool")
    p.add_argument("--prefill-chunk-tokens", type=int, default=None,
                   help="prompt tokens consumed per inner step of the serving chunk "
                        "(0 = the two-program admit)")
    p.add_argument("--no-kv-share-prefix", action="store_true",
                   help="no copy-on-write prompt page sharing in the serving plane")
    p.add_argument("--serving-admit-lanes", type=int, default=None,
                   help="extra packed-stream query lanes above one a slot (0 = auto)")
    p.add_argument("--token", default="", help="shared secret (or AREAL_GEN_TOKEN)")
    p.add_argument("--zmq-port", type=int, default=None,
                   help="not yet ported (ROADMAP queue 1 item 7.8: the ZMQ transport)")
    p.add_argument("--experiment", default="",
                   help="announce this server's /metrics endpoint under the experiment/"
                        "trial metrics subtree AND join the fleet under names.gen_servers")
    p.add_argument("--trial", default="trial")
    p.add_argument("--keepalive-ttl", type=float, default=10.0,
                   help="fleet keepalive TTL in seconds: a server that stops beating "
                        "expires out of the fleet after this long")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.zmq_port is not None:
        raise SystemExit("--zmq-port is not yet ported (ROADMAP queue 1, item 7.8: the ZMQ "
                         "transport)")
    if args.parallel != "d1":
        raise SystemExit(f"--parallel {args.parallel} is not yet ported (ROADMAP queue 1, "
                         "item 8.6b: generation on a sharded layout); only d1 runs")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    tracer.configure(role="gen_server", rank=args.port)
    device = resolve_device(args.device)
    cfg, params = hf.load_hf_checkpoint(args.path, device=device)
    eos = args.eos_token_id
    if eos is None:
        cfg_path = os.path.join(args.path, "config.json")
        try:
            with open(cfg_path) as f:
                eos = json.load(f).get("eos_token_id")
        except (OSError, json.JSONDecodeError) as e:
            raise RuntimeError(
                f"gen_server config missing or unreadable at {cfg_path}: {e}; pass "
                "--eos-token-id or point --path at a checkpoint directory with config.json"
            ) from e
    options = dict(max_decode_batch=args.max_decode_batch, kv_page_size=args.kv_page_size,
                   kv_pool_pages=args.kv_pool_pages)
    if args.no_paged_kv:
        options["kv_paged"] = False
    if args.no_kv_share_prefix:
        options["kv_share_prefix"] = False
    if args.prefill_chunk_tokens is not None:
        options["prefill_chunk_tokens"] = args.prefill_chunk_tokens
    if args.serving_admit_lanes is not None:
        options["serving_admit_lanes"] = args.serving_admit_lanes
    engine = GeneratorEngine(cfg, params, device, eos_token_id=eos, **options)
    del params
    server = GenerationServer(engine, host=args.host, port=args.port,
                              token=args.token or os.environ.get("AREAL_GEN_TOKEN", ""))
    if args.experiment:
        from areal_tpu_torch.base import name_resolve, names

        # The server's own HTTP plane serves /metrics.
        name_resolve.add(
            names.metrics_endpoint(args.experiment, args.trial, f"gen_server/{server.port}"),
            server.url, replace=True, delete_on_exit=True,
        )
        server.announce(args.experiment, args.trial, ttl=args.keepalive_ttl)
    logger.info(f"serving {args.path} at {server.url} on {device}; Ctrl-C to stop")
    try:
        server._stop.wait()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
