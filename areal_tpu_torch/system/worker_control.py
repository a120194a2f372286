"""Worker lifecycle control (port of areal_tpu/system/worker_control.py):
a command server in each worker and the controller's panel, over the
standard library transport of `system/stream.py` where the JAX package
uses ZMQ REQ/REP sockets.

The heavy traffic stays on the master's request stream; this is a side
channel on which a controller configures, pauses, resumes, pings and
stops workers whatever their requests in flight, plus liveness from a
TTL keepalive key in name_resolve.  The states are READY -> CONFIGURED
-> RUNNING <-> PAUSED -> EXITING.

    python -m areal_tpu_torch.system.worker_control status \\
        --experiment ppo-math --trial trial0 --root <name_resolve root>
"""

import enum
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.system.stream import Acceptor, connect, shutdown, trial_authkey

logger = logging.getLogger("areal_tpu_torch.worker_control")

KEEPALIVE_TTL = 10.0  # seconds; the panel reads an older key as dead


class WorkerState(str, enum.Enum):
    READY = "ready"
    CONFIGURED = "configured"
    RUNNING = "running"
    PAUSED = "paused"
    EXITING = "exiting"
    ERROR = "error"


class WorkerServer:
    """The worker's command server: each controller connection is served
    on a thread of its own, one reply a command.  Built-in commands:
    ping, status, configure, start, pause, resume, exit; more come from
    `register_handler`.  `pause` holds the owning worker's serve loop
    (`wait_if_paused`) until `resume`.  A shared token
    (`AREAL_WORKER_TOKEN`, when set) is asked of every command, on top
    of the trial's authkey."""

    def __init__(self, experiment_name: str, trial_name: str, worker_name: str,
                 keepalive_ttl: float = KEEPALIVE_TTL):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_name = worker_name
        self.state = WorkerState.READY
        self.config: Any = None
        self._token = os.environ.get("AREAL_WORKER_TOKEN", "")
        self._handlers: Dict[str, Callable[[Dict], Any]] = {}
        self._not_paused = threading.Event()
        self._not_paused.set()
        self._stop = threading.Event()
        self.exited = threading.Event()
        self._conns: List[Any] = []
        self._conns_lock = threading.Lock()
        self._acceptor = Acceptor(self._serve_conn, trial_authkey(), f"control-{worker_name}")
        self._addr = self._acceptor.address
        name_resolve.add(names.worker_control(experiment_name, trial_name, worker_name),
                         self._addr, replace=True)
        self._keepalive_name = names.worker_keepalive(experiment_name, trial_name, worker_name)
        self._keepalive_ttl = keepalive_ttl
        name_resolve.add(self._keepalive_name, str(time.time()), keepalive_ttl=keepalive_ttl,
                         replace=True)
        self._thread = threading.Thread(target=self._keepalive, daemon=True)
        self._thread.start()
        logger.info(f"worker {worker_name} control server at {self._addr}")

    def register_handler(self, command: str, fn: Callable[[Dict], Any]):
        self._handlers[command] = fn

    @property
    def paused(self) -> bool:
        return not self._not_paused.is_set()

    def wait_if_paused(self, timeout: Optional[float] = None) -> bool:
        """The owning worker's serve loop calls this before a request."""
        return self._not_paused.wait(timeout)

    def _handle(self, command: str, payload: Dict) -> Any:
        if command == "ping":
            return {"state": self.state.value, "name": self.worker_name}
        if command == "status":
            return {"state": self.state.value}
        if command == "configure":
            self.config = payload.get("config")
            self.state = WorkerState.CONFIGURED
            return {"state": self.state.value}
        if command == "start":
            self.state = WorkerState.RUNNING
            return {"state": self.state.value}
        if command == "pause":
            self._not_paused.clear()
            self.state = WorkerState.PAUSED
            return {"state": self.state.value}
        if command == "resume":
            self._not_paused.set()
            self.state = WorkerState.RUNNING
            return {"state": self.state.value}
        if command == "exit":
            # Only the state flips: the serve loop sees EXITING, drains
            # its work and calls stop(); meanwhile ping and the keepalive
            # go on answering (a draining worker is not dead).
            self.state = WorkerState.EXITING
            self._not_paused.set()
            return {"state": self.state.value}
        if command in self._handlers:
            return self._handlers[command](payload)
        raise ValueError(f"unknown control command {command!r}")

    def _serve_conn(self, conn):
        with self._conns_lock:
            if self._stop.is_set():
                conn.close()
                return
            self._conns.append(conn)
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                # One reply a command, whatever fails.
                try:
                    if self._token and msg.get("token") != self._token:
                        raise PermissionError("bad control token")
                    reply = {"result": self._handle(msg.get("command"),
                                                    msg.get("payload") or {})}
                except Exception as e:  # noqa: BLE001 — forwarded to the panel
                    reply = {"error": repr(e)}
                if self._stop.is_set():
                    return
                conn.send(reply)
        except OSError:
            return
        finally:
            conn.close()

    def _keepalive(self):
        """Refresh the liveness key well inside its TTL until stopped."""
        try:
            while not self._stop.wait(self._keepalive_ttl / 3):
                try:
                    name_resolve.default().touch(self._keepalive_name)
                except Exception:  # noqa: BLE001 — a missed touch reads as a stall
                    pass
        finally:
            self.exited.set()

    def stop(self):
        self._stop.set()
        self._not_paused.set()
        self._acceptor.close()
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            shutdown(conn)
        self.exited.wait(timeout=5.0)


class WorkerControlPanel:
    """The controller's side: find the workers' command servers in
    name_resolve and send them commands, one connection a worker."""

    def __init__(self, experiment_name: str, trial_name: str, authkey: Optional[bytes] = None):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._authkey = authkey or trial_authkey()
        self._conns: Dict[str, Any] = {}
        self._addrs: Dict[str, str] = {}
        self._token = os.environ.get("AREAL_WORKER_TOKEN", "")

    def connect(self, worker_names: List[str], timeout: float = 60.0):
        deadline = time.time() + timeout
        for wn in worker_names:
            addr = name_resolve.wait(
                names.worker_control(self.experiment_name, self.trial_name, wn),
                timeout=max(0.1, deadline - time.time()),
            )
            self._addrs[wn] = addr
            self._conns[wn] = None  # connected at the first command

    def _send(self, worker_name: str, command: str, payload: Optional[Dict]):
        conn = self._conns.get(worker_name)
        if conn is None:
            conn = self._conns[worker_name] = connect(self._addrs[worker_name], self._authkey)
        conn.send({"command": command, "payload": payload, "token": self._token})

    def _recv(self, worker_name: str, command: str, deadline: float) -> Any:
        conn = self._conns[worker_name]
        if not conn.poll(max(0.0, deadline - time.time())):
            # A connection with a reply outstanding would hand that reply
            # to the next command: drop it, the next one reconnects.
            conn.close()
            self._conns[worker_name] = None
            raise TimeoutError(f"worker {worker_name} did not answer {command!r}")
        try:
            reply = conn.recv()
        except (EOFError, OSError) as e:
            conn.close()
            self._conns[worker_name] = None
            raise TimeoutError(f"worker {worker_name} closed the channel on {command!r}") from e
        if "error" in reply:
            raise RuntimeError(f"worker {worker_name} {command!r} failed: {reply['error']}")
        return reply["result"]

    def request(self, worker_name: str, command: str, payload: Optional[Dict] = None,
                timeout: float = 60.0) -> Any:
        try:
            self._send(worker_name, command, payload)
        except OSError as e:
            self._conns[worker_name] = None
            raise TimeoutError(f"worker {worker_name} unreachable for {command!r}: {e!r}") from e
        return self._recv(worker_name, command, time.time() + timeout)

    def group_request(self, command: str, payloads: Optional[Dict[str, Dict]] = None,
                      timeout: float = 60.0) -> Dict[str, Any]:
        """`command` to every connected worker: every send first, then
        every reply, so a group takes the slowest worker's time, not the
        sum.  Every channel is drained (or dropped on a timeout) even when
        some fail; the failures are raised together after."""
        errors: Dict[str, Exception] = {}
        sent = []
        for wn in self._conns:
            try:
                self._send(wn, command, (payloads or {}).get(wn))
                sent.append(wn)
            except OSError as e:
                self._conns[wn] = None
                errors[wn] = e
        deadline = time.time() + timeout
        results: Dict[str, Any] = {}
        for wn in sent:
            try:
                results[wn] = self._recv(wn, command, deadline)
            except Exception as e:  # noqa: BLE001 — gathered below
                errors[wn] = e
        if errors:
            raise RuntimeError(f"group {command!r} failed on {sorted(errors)}: "
                               + "; ".join(f"{wn}: {e!r}" for wn, e in errors.items()))
        return results

    def check_liveness(self, worker_names: Optional[List[str]] = None) -> Dict[str, bool]:
        """Liveness from each worker's keepalive key (a stalled server
        lets it expire); needs no connection."""
        alive = {}
        for wn in (worker_names if worker_names is not None else self._conns):
            key = names.worker_keepalive(self.experiment_name, self.trial_name, wn)
            try:
                name_resolve.get(key)
                alive[wn] = True
            except name_resolve.NameEntryNotFoundError:
                alive[wn] = False
        return alive

    def close(self):
        for conn in self._conns.values():
            if conn is not None:
                conn.close()
        self._conns = {wn: None for wn in self._conns}


def main(argv=None):
    """Operator CLI: inspect or control a running trial's workers.  The
    trial's authkey comes from `--authkey-file` (the launcher writes one
    in its plan directory) or `AREAL_TRIAL_AUTHKEY`."""
    import argparse
    import json

    from areal_tpu_torch.system import stream

    p = argparse.ArgumentParser(prog="areal_tpu_torch.system.worker_control")
    p.add_argument("command", choices=["status", "ping", "pause", "resume", "exit", "liveness"])
    p.add_argument("--experiment", required=True)
    p.add_argument("--trial", required=True)
    p.add_argument("--root", default=None,
                   help="file name-resolve root (default: $AREAL_NAME_RESOLVE_ROOT)")
    p.add_argument("--workers", default=None,
                   help="comma-separated worker names (default: every worker registered "
                        "under the trial)")
    p.add_argument("--authkey-file", default=None,
                   help="file holding the trial's authkey in hex (default: "
                        f"${stream.ENV_AUTHKEY})")
    p.add_argument("--timeout", type=float, default=10.0)
    args = p.parse_args(argv)

    # Trials publish to the file store; an operator's shell has no
    # AREAL_NAME_RESOLVE, and the memory store could never see a trial.
    name_resolve.set_default(name_resolve.FileNameResolveRepository(args.root))
    if args.workers:
        workers = [w.strip() for w in args.workers.split(",") if w.strip()]
    else:
        prefix = f"{names.trial_root(args.experiment, args.trial)}/control"
        workers = [k[len(prefix) + 1:] for k in name_resolve.find_subtree(prefix)]
        if not workers:
            raise SystemExit(f"no workers registered under {prefix}")
    authkey = None
    if args.authkey_file:
        with open(args.authkey_file) as f:
            authkey = bytes.fromhex(f.read().strip())
    panel = WorkerControlPanel(args.experiment, args.trial, authkey=authkey)
    try:
        if args.command == "liveness":
            # Keepalive keys only: a dead worker reads alive=false, not a
            # connection timeout.
            out = panel.check_liveness(workers)
        else:
            panel.connect(workers, timeout=args.timeout)
            cmd = "ping" if args.command == "status" else args.command
            out = panel.group_request(cmd, timeout=args.timeout)
        print(json.dumps(out, indent=2, default=str))
    finally:
        panel.close()


if __name__ == "__main__":
    main()
