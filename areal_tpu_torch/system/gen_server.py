"""Generation service: a batching HTTP server around a GeneratorEngine
(port of areal_tpu/system/gen_server.py; it serves ``POST /generate``,
``POST /pause``, ``POST /resume`` and ``GET /health`` with the JAX
server's JSON wire format, so the JAX package's `LLMAPIClient` talks to
it unchanged).

Concurrent /generate requests are MERGED by a collector thread into
shared engine calls: client-side fan-out gets cross-request batching.

`update_weights_inmem` is the interruptible in-memory weight push of
asynchronous RL: the running generate call parks at its next chunk
boundary, the weights are swapped under the engine lock, and the call
resumes on its existing KV pages (one chunk of replay instead of a full
drain).  Each response carries `version_start`, the weight version its
sampling started on, and `version`, the one it finished on.

Not yet ported: `/update_weights` from a checkpoint on disk,
`/param_push`, the ZMQ transport, episodes, fault injection and the
command-line entry point.
"""

import dataclasses
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.base import integrity

logger = logging.getLogger("areal_tpu_torch.gen_server")


@dataclasses.dataclass
class _Pending:
    qid: str
    prompt_ids: List[int]
    gconfig: GenerationHyperparameters
    done: threading.Event
    seed: Optional[int] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None


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
    ):
        self.engine = engine
        self.version = 0
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
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if srv._token and self.headers.get("X-Areal-Token") != srv._token:
                    self._send(403, {"error": "bad token"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    if self.path == "/generate":
                        self._send(200, srv._handle_generate(req))
                    elif self.path == "/pause":
                        srv.pause()
                        self._send(200, {"paused": True, "version": srv.version})
                    elif self.path == "/resume":
                        srv.resume()
                        self._send(200, {"paused": False, "version": srv.version})
                    else:
                        self._send(404, {"error": "unknown path"})
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
        logger.info(f"generation server at {self.url}")

    def health_info(self) -> Dict:
        """Liveness + the load signals a rollout controller balances on;
        the engine's (live_slots, kv_utilization) pair is one atomically
        replaced tuple."""
        eng = self.engine
        live, kvu = eng.load_state
        with self._health_lock:
            version = self.version
            paused = self._pause_evt.is_set()
        return {
            "status": "ok",
            "version": version,
            "queue_depth": self._queue.qsize(),
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
        self.engine.interrupt()

    def resume(self) -> None:
        with self._health_lock:
            self._pause_evt.clear()
        self.engine.clear_interrupt()
        with self._resume_cond:
            self._resume_cond.notify_all()

    def update_weights_inmem(self, params, checksum=None, version=None) -> int:
        """Interruptible in-memory weight push: pause at a chunk boundary,
        swap `params` into the engine under the engine lock, bump the
        version, resume — interrupted requests continue on their existing
        KV pages.

        `version` sets the ABSOLUTE serving version; a push at or behind
        the current one is a no-op.  Without it the version bumps by one.
        `checksum` (`integrity.params_checksum` at the pusher) is verified
        BEFORE the swap: a mismatch raises `integrity.WeightChecksumError`
        and the server keeps serving its previous weights.  Returns the
        version now served."""
        if version is not None:
            with self._health_lock:
                if int(version) <= self.version:
                    return self.version
        with self._update_mutex:
            if checksum is not None:
                integrity.verify_checksum(params, checksum)
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
            finally:
                self.resume()
        logger.info(f"weights updated in memory -> version {v}")
        return v

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
                by_g: Dict[Any, List[_Pending]] = {}
                for p in batch:
                    by_g.setdefault(_gkey(p), []).append(p)
                for group in by_g.values():
                    self._run_group(group)
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
            self._engine_lock.acquire()
            locked = True
            try:
                version_start = self.version
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
                p.done.set()

    def close(self):
        self._stop.set()
        self._http.shutdown()
        self._http.server_close()
        self._collector_thread.join(timeout=5.0)


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
