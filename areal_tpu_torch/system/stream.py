"""The master⇄worker request stream of a multi-process trial (port of
areal_tpu/system/stream.py), over the standard library's
`multiprocessing.connection` where the JAX package uses ZMQ.

The master binds one listening socket (`Acceptor`) and publishes its
address under `names.request_reply_stream`.  Every connection must pass
`multiprocessing.connection`'s HMAC challenge with the trial's authkey
(`trial_authkey`).  Each worker connects twice: its request lane, on
which it says hello with its index and then serves requests until
`exit`, and its heartbeat lane, on which a thread of its own sends a
beat every `worker_heartbeat_s`.  Requests carry ids, so many can be in
flight to one worker; one reader thread a connection resolves their
futures on the master's event loop (`loop.call_soon_threadsafe`).  A
`Connection` is not thread-safe, so every send on one goes under one
lock: the master's requests, and on the worker its replies, including
those of the transfer threads.

Liveness: `ConnWorkerPool.request` takes a deadline (by default the
pool's `mfc_timeout_s`).  When it expires, a worker whose last beat is
within 3 beats is slow (the deadline re-arms, and the log says so); one
whose beats stopped is dead: its in-flight futures fail with
`WorkerDeadError` and its hello slot is cleared, so `wait_workers` waits
for a relaunched replacement.  A reply that comes after its deadline is
dropped and counted as an orphan by reason.  With `mfc_timeout_s=None`
(the default) a request is one plain await.  `close()` fails every
pending future with `PoolClosedError`.
"""

import asyncio
import logging
import os
import socket
import threading
import time
from collections import deque
from multiprocessing.connection import (
    AuthenticationError,
    Client,
    Connection,
    answer_challenge,
    deliver_challenge,
)
from typing import Any, Callable, Dict, Optional, Set, Tuple

from areal_tpu_torch.base import name_resolve, names, network
from areal_tpu_torch.system.master import (
    PoolClosedError,
    WorkerDeadError,
    WorkerPool,
    pool_metrics,
)

logger = logging.getLogger("areal_tpu_torch.stream")

STREAM_NAME = "master"
ENV_AUTHKEY = "AREAL_TRIAL_AUTHKEY"

# Ids of requests whose deadline expired, kept so that a late reply is
# counted as a "timed_out" orphan (older ones count as "unknown").
_TIMED_OUT_KEEP = 4096

_UNSET = object()
_process_authkey: Optional[bytes] = None


def trial_authkey() -> bytes:
    """The trial's authkey: `AREAL_TRIAL_AUTHKEY` (hex) when set (the
    launcher sets it for itself and its workers), else one made for this
    process."""
    global _process_authkey
    hexkey = os.environ.get(ENV_AUTHKEY, "")
    if hexkey:
        return bytes.fromhex(hexkey)
    if _process_authkey is None:
        _process_authkey = os.urandom(32)
    return _process_authkey


def connect(addr: str, authkey: bytes) -> Connection:
    """A client connection to an `Acceptor` at "host:port"."""
    host, port = addr.rsplit(":", 1)
    return Client((host, int(port)), authkey=authkey)


def shutdown(conn: Connection) -> None:
    """Wake the thread blocked reading `conn` (it sees EOF and closes
    the connection itself): a close from another thread would not."""
    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
    except OSError:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.close()


class Acceptor:
    """A listening TCP socket on this host.  Each connection passes the
    HMAC challenge both ways (as `multiprocessing.connection.Listener`
    does) on a thread of its own, which then runs `on_conn(conn)`."""

    def __init__(self, on_conn: Callable[[Connection], None], authkey: bytes, name: str):
        self._on_conn = on_conn
        self._authkey = authkey
        self._name = name
        self._sock = socket.create_server((network.gethostip(), 0))
        self._sock.settimeout(0.2)
        host, port = self._sock.getsockname()[:2]
        self.address = f"{host}:{port}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, name=f"{name}-accept", daemon=True)
        self._thread.start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                s, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            s.setblocking(True)
            threading.Thread(target=self._handshake, args=(Connection(s.detach()),),
                             name=f"{self._name}-conn", daemon=True).start()

    def _handshake(self, conn: Connection):
        try:
            deliver_challenge(conn, self._authkey)
            answer_challenge(conn, self._authkey)
        except (AuthenticationError, EOFError, OSError) as e:
            logger.warning(f"{self._name}: refused a connection ({e!r})")
            conn.close()
            return
        self._on_conn(conn)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._sock.close()


class ConnWorkerPool(WorkerPool):
    """The master's side: one request lane and one heartbeat lane a
    worker, the table of requests in flight, the liveness verdicts."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        n_workers: int,
        mfc_timeout_s: Optional[float] = None,
        worker_heartbeat_s: float = 5.0,
    ):
        self._n_workers = n_workers
        self.mfc_timeout_s = mfc_timeout_s
        self.worker_heartbeat_s = worker_heartbeat_s
        # Dead only when a deadline expired AND the beats are older than
        # 3 of them: a long MFC keeps beating from its own thread.
        self._beat_grace_s = max(3.0 * worker_heartbeat_s, 1.0)
        self.authkey = trial_authkey()
        self._lock = threading.Lock()  # the tables below, shared with the reader threads
        self._conns: Dict[int, Connection] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._last_beat: Dict[int, float] = {}  # worker -> time.monotonic()
        self._dead: Set[int] = set()
        self._hello = threading.Event()
        # Loop-thread state: req_id -> (future, worker).
        self._pending: Dict[int, Tuple[asyncio.Future, int]] = {}
        self._timed_out: Set[int] = set()
        self._timed_out_order: deque = deque()
        self._next_req_id = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        self._m_worker_dead, self._m_mfc_timeout, self._m_orphans = pool_metrics()
        self._acceptor = Acceptor(self._on_conn, self.authkey, "stream")
        self._addr = self._acceptor.address
        name_resolve.add(
            names.request_reply_stream(experiment_name, trial_name, STREAM_NAME),
            self._addr, replace=True,
        )
        logger.info(f"master stream bound at {self._addr}")

    @property
    def n_workers(self) -> int:
        return self._n_workers

    @property
    def dead_workers(self) -> Set[int]:
        with self._lock:
            return set(self._dead)

    # ---------------- the reader threads ----------------

    def _note_beat(self, worker: int):
        with self._lock:
            self._last_beat[worker] = time.monotonic()

    def _on_conn(self, conn: Connection):
        if not conn.poll(30.0):
            conn.close()
            return
        try:
            hello = conn.recv()
            widx, lane = int(hello["worker_index"]), hello.get("lane", "stream")
        except Exception as e:  # noqa: BLE001 — a malformed peer is dropped
            logger.error(f"stream: bad hello ({e!r})")
            conn.close()
            return
        if lane == "beat":
            self._read(conn, widx, beats=True)
            return
        with self._lock:
            old = self._conns.get(widx)
            self._conns[widx] = conn
            self._send_locks[widx] = threading.Lock()
            self._last_beat[widx] = time.monotonic()
            if widx in self._dead:
                # A relaunched replacement: a fresh peer with no model
                # state (the master restores it).
                self._dead.discard(widx)
                logger.info(f"worker {widx} re-joined the stream")
            if len(self._conns) >= self._n_workers:
                self._hello.set()
        if old is not None:
            shutdown(old)
        self._read(conn, widx, beats=False)

    def _read(self, conn: Connection, widx: int, beats: bool):
        try:
            while True:
                msg = conn.recv()
                self._note_beat(widx)  # any traffic is proof of life
                if beats:
                    continue
                loop = self._loop
                if loop is None:
                    self._m_orphans.labels("unknown").inc()
                    continue
                loop.call_soon_threadsafe(self._on_reply, msg)
        except (EOFError, OSError):
            pass
        except RuntimeError:  # the master's loop is closed
            pass
        finally:
            conn.close()
            if not beats and not self._closed:
                logger.info(f"worker {widx}'s request lane closed")

    # ---------------- the loop thread ----------------

    def _bind_loop(self):
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            self._loop = loop

    def _on_reply(self, msg: Dict[str, Any]):
        req_id = msg.get("req_id")
        entry = self._pending.pop(req_id, None)
        if entry is None:
            if req_id in self._timed_out:
                # A late reply to an expired request: the ordinary
                # aftermath of a "slow" verdict.
                self._m_orphans.labels("timed_out").inc()
                logger.debug(f"late reply for timed-out req_id={req_id} dropped")
            else:
                self._m_orphans.labels("unknown").inc()
                logger.warning(f"orphan reply req_id={req_id}")
            return
        fut, _ = entry
        if fut.done():
            return
        if msg.get("error"):
            fut.set_exception(RuntimeError(msg["error"]))
        else:
            fut.set_result(msg.get("result"))

    def _fail_pending(self, exc: Exception):
        for fut, _ in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def wait_workers(self, timeout: float = 300.0):
        """Block until every worker has said hello.  A death clears its
        slot, so a later call waits for the relaunched worker."""
        self._bind_loop()
        deadline = time.monotonic() + timeout
        while not self._hello.is_set():
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers {sorted(self._missing())} did not connect "
                                   f"within {timeout}s")
            await asyncio.sleep(0.05)
        logger.info(f"all {self._n_workers} workers connected")

    def _missing(self):
        with self._lock:
            return set(range(self._n_workers)) - set(self._conns)

    def _record_timed_out(self, req_id: int):
        self._timed_out.add(req_id)
        self._timed_out_order.append(req_id)
        while len(self._timed_out_order) > _TIMED_OUT_KEEP:
            self._timed_out.discard(self._timed_out_order.popleft())

    def _fail_worker(self, worker_id: int, reason: str):
        """Declare a worker dead: close its lane, clear its hello slot
        (wait_workers re-arms), fail its requests in flight, count it."""
        with self._lock:
            if worker_id in self._dead:
                return
            self._dead.add(worker_id)
            conn = self._conns.pop(worker_id, None)
            self._send_locks.pop(worker_id, None)
            self._hello.clear()
        if conn is not None:
            shutdown(conn)
        self._m_worker_dead.inc()
        err = WorkerDeadError(worker_id, reason)
        for req_id in [r for r, (_, w) in self._pending.items() if w == worker_id]:
            fut, _ = self._pending.pop(req_id)
            self._record_timed_out(req_id)
            if not fut.done():
                fut.set_exception(err)
        logger.error(f"worker {worker_id} declared dead: {reason}")

    def _send(self, worker_id: int, msg: Dict[str, Any]):
        with self._lock:
            conn = self._conns.get(worker_id)
            lock = self._send_locks.get(worker_id)
        if conn is None:
            raise WorkerDeadError(worker_id, "no request lane (not connected)")
        try:
            with lock:
                conn.send(msg)
        except OSError as e:
            # As a message to a lost peer: the deadline (or the launcher's
            # watch on the process) decides what happened.
            logger.warning(f"send to worker {worker_id} failed: {e!r}")

    async def request(self, worker_id: int, payload: Dict[str, Any],
                      timeout: Any = _UNSET) -> Dict:
        self._bind_loop()
        if self._closed:
            raise PoolClosedError("worker pool closed")
        if worker_id in self.dead_workers:
            raise WorkerDeadError(worker_id, "worker previously declared dead")
        if not self._hello.is_set():
            await self.wait_workers()
        loop = asyncio.get_running_loop()
        req_id = self._next_req_id
        self._next_req_id += 1
        fut = loop.create_future()
        self._pending[req_id] = (fut, worker_id)
        self._send(worker_id, {"req_id": req_id, "request": payload})
        if timeout is _UNSET:
            timeout = self.mfc_timeout_s
        if timeout is None:
            return await fut
        # The deadline lane: shield() keeps the future across each slice.
        deadline = time.monotonic() + timeout
        poll_s = min(timeout, max(self.worker_heartbeat_s, 0.05))
        while True:
            try:
                return await asyncio.wait_for(asyncio.shield(fut), poll_s)
            except asyncio.TimeoutError:
                if fut.done():
                    return fut.result()
                if time.monotonic() < deadline:
                    continue
                self._m_mfc_timeout.inc()
                with self._lock:
                    beat_age = time.monotonic() - self._last_beat.get(worker_id, -1e18)
                if beat_age <= self._beat_grace_s:
                    logger.warning(
                        f"request {req_id} ({payload.get('type')}) to worker {worker_id} "
                        f"exceeded {timeout}s but the worker is beating (last beat "
                        f"{beat_age:.1f}s ago): slow, not dead; deadline re-armed"
                    )
                    deadline = time.monotonic() + timeout
                    continue
                self._fail_worker(
                    worker_id,
                    f"no reply to {payload.get('type')} within {timeout}s and no heartbeat "
                    f"for {beat_age:.1f}s (grace {self._beat_grace_s:.1f}s)",
                )
                return await fut  # failed with WorkerDeadError

    async def broadcast(self, payload: Dict[str, Any]):
        """`payload` to every living worker (a dead one is skipped)."""
        dead = self.dead_workers
        return await asyncio.gather(*[
            self.request(w, payload) for w in range(self._n_workers) if w not in dead
        ])

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._fail_pending(PoolClosedError("worker pool closed"))
        except RuntimeError:  # futures of a loop already closed
            pass
        self._acceptor.close()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            shutdown(conn)


# Served on threads of their own: a transfer's receive side blocks until
# the peer's send lands, so a serial loop could deadlock on a send/recv
# pair between two workers.  Compute requests stay serial.
_THREADED_TYPES = frozenset({"data_send", "data_recv", "param_send", "param_recv"})


def _start_heartbeat(addr: str, worker_index: int, heartbeat_s: float, authkey: bytes):
    """The heartbeat lane: a connection and a thread of its own, beating
    every `heartbeat_s` until stopped.  The beats stop exactly when the
    process is gone; a slow or hung MFC keeps beating."""
    stop = threading.Event()

    def beat():
        try:
            conn = connect(addr, authkey)
        except OSError as e:
            logger.error(f"worker {worker_index}: heartbeat lane failed to connect: {e!r}")
            return
        try:
            conn.send({"type": "hello", "worker_index": worker_index, "lane": "beat"})
            while not stop.is_set():
                conn.send({"type": "beat", "worker_index": worker_index})
                stop.wait(heartbeat_s)
        except OSError:
            pass
        finally:
            conn.close()

    threading.Thread(target=beat, name=f"heartbeat-{worker_index}", daemon=True).start()
    return stop


def run_worker_stream(
    worker,  # ModelWorker
    experiment_name: str,
    trial_name: str,
    timeout: float = 300.0,
    control=None,  # Optional[worker_control.WorkerServer]
    heartbeat_s: Optional[float] = None,
) -> None:
    """The worker's side: connect, say hello, serve requests until `exit`
    (or until the master's end of the lane closes)."""
    if heartbeat_s is None:
        heartbeat_s = float(os.environ.get("AREAL_WORKER_HEARTBEAT_S", "5.0"))
    key = trial_authkey()
    idx = worker.config.worker_index
    addr = name_resolve.wait(
        names.request_reply_stream(experiment_name, trial_name, STREAM_NAME), timeout=timeout,
    )
    conn = connect(addr, key)
    send_lock = threading.Lock()
    conn.send({"type": "hello", "worker_index": idx, "lane": "stream"})
    logger.info(f"worker {idx} connected to the master at {addr}")
    beat_stop = _start_heartbeat(addr, idx, heartbeat_s, key) if heartbeat_s > 0 else None
    threads: list = []

    def reply(msg):
        try:
            with send_lock:
                conn.send(msg)
        except OSError as e:
            logger.warning(f"worker {idx}: reply {msg.get('req_id')} not sent: {e!r}")

    def serve(req, req_id):
        try:
            msg = {"req_id": req_id, "result": worker.handle_request(req)}
        except Exception as e:  # noqa: BLE001 — forwarded to the master
            logger.error(f"worker {idx} request {req.get('type')} failed: {e!r}")
            msg = {"req_id": req_id, "error": repr(e)}
        reply(msg)

    def join_threads():
        for t in threads:  # transfers in flight finish first
            t.join(timeout=timeout)

    try:
        while True:
            # An exit asked on the control side channel.
            if control is not None and control.state.value == "exiting":
                join_threads()
                break
            try:
                if not conn.poll(0.1):
                    continue
                msg = conn.recv()
            except (EOFError, OSError):
                logger.warning(f"worker {idx}: the master closed the stream")
                break
            req = msg["request"]
            # A paused worker parks every request but exit until resumed.
            if control is not None and req.get("type") != "exit":
                while control.paused and control.state.value != "exiting":
                    control.wait_if_paused(timeout=0.5)
            if req.get("type") == "exit":
                join_threads()
                reply({"req_id": msg["req_id"], "result": {}})
                break
            if req.get("type") in _THREADED_TYPES:
                t = threading.Thread(target=serve, args=(req, msg["req_id"]), daemon=True)
                t.start()
                threads = [x for x in threads if x.is_alive()] + [t]
            else:
                serve(req, msg["req_id"])
    finally:
        if beat_stop is not None:
            beat_stop.set()
        conn.close()
