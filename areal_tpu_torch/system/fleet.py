"""The generation fleet: circuit breaking and membership (a trimmed
port of areal_tpu/system/fleet.py).

- `CircuitBreaker`: the dispatch gate the rollout controller keeps for
  each server.
- `fleet_discovery`: membership as a closure.  Generation servers
  announce under ``names.gen_servers`` with a keepalive TTL
  (`GenerationServer.announce`); the closure lists the live subtree as
  ``{server_id: url}``.  An expired keepalive (a dead server) drops out
  of the listing without anyone deregistering it.
- `LocalProcessFleet`: spawns and drains server processes on this host.

The verifier fleet's members and pool client are
`system/verifier_pool.py`.  The supervisor and its lanes
(`FleetSupervisor`, `SupervisorLane`, which read SLO rules with the
metrics report) are ROADMAP queue 1 item 7.5's last part.
"""

import logging
import shlex
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence

from areal_tpu_torch.base import name_resolve, names

logger = logging.getLogger("areal_tpu_torch.fleet")


class CircuitBreaker:
    """Consecutive-failure circuit breaker for one generation server.

    closed --(threshold consecutive failures)--> open
    open   --(cooldown elapsed; next probe)----> half_open
    half_open --success--> closed;  --failure--> open (fresh cooldown)
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        on_transition: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.on_transition = on_transition
        self._clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opens = 0  # times the breaker tripped open
        self.closes = 0  # times a probe closed it again
        self._opened_at = 0.0

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if state == self.OPEN:
            self.opens += 1
            self._opened_at = self._clock()
        elif state == self.CLOSED:
            self.closes += 1
        if self.on_transition is not None:
            self.on_transition(state)

    def allow_dispatch(self) -> bool:
        """Only a closed breaker takes regular dispatches; a half-open one
        admits only the probe, which rides the health poll."""
        return self.state == self.CLOSED

    def probe_due(self) -> bool:
        return self.state == self.OPEN and self._clock() - self._opened_at >= self.cooldown_s

    def begin_probe(self) -> None:
        self._to(self.HALF_OPEN)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._to(self.CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or (
            self.state == self.CLOSED and self.consecutive_failures >= self.threshold
        ):
            self._to(self.OPEN)
        elif self.state == self.OPEN:
            # A failure while open (a straggler dispatch) re-arms the
            # cooldown, so the probe waits for quiet.
            self._opened_at = self._clock()


def fleet_discovery(experiment: str, trial: str) -> Callable[[], Dict[str, str]]:
    """``{server_id: url}`` of the announced generation servers, as a
    closure the rollout controller and the broadcast fabric call at each
    refresh or push."""
    root = names.gen_servers(experiment, trial)

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


class LocalProcessFleet:
    """Spawn and drain server processes on this host.

    ``command`` is an argv template; ``{port}``, ``{experiment}`` and
    ``{trial}`` are substituted at each spawn (ports count up from
    `base_port`).  Drain deletes the server's announcement under
    ``name_key(experiment, trial, sid_prefix + port)`` first, then
    terminates the process after `drain_grace_s` if it has not exited.
    A generation server announces itself as ``s<port>``, so a gen-server
    fleet that should deregister on drain passes ``sid_prefix="s"``;
    with the default ``"port"`` the drain deletes no key and the
    announcement expires by its TTL."""

    def __init__(
        self,
        command: Sequence[str],
        experiment: str,
        trial: str,
        base_port: int = 8101,
        drain_grace_s: float = 10.0,
        name_key: Callable[[str, str, str], str] = names.gen_server,
        sid_prefix: str = "port",
    ):
        self.command = list(command)
        self.experiment = experiment
        self.trial = trial
        self._next_port = base_port
        self.drain_grace_s = drain_grace_s
        self.name_key = name_key
        self.sid_prefix = sid_prefix
        self.procs: Dict[str, subprocess.Popen] = {}

    def spawn(self) -> str:
        port = self._next_port
        self._next_port += 1
        argv = [a.format(port=port, experiment=self.experiment, trial=self.trial)
                for a in self.command]
        logger.info(f"fleet spawn: {shlex.join(argv)}")
        proc = subprocess.Popen(argv)
        sid = f"{self.sid_prefix}{port}"
        self.procs[sid] = proc
        return sid

    def drain(self, server_id: str) -> None:
        try:
            name_resolve.delete(self.name_key(self.experiment, self.trial, server_id))
        except Exception:  # noqa: BLE001 — already gone is fine
            pass
        proc = self.procs.pop(server_id, None)
        if proc is None:
            return
        deadline = time.monotonic() + self.drain_grace_s
        while time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.2)
        if proc.poll() is None:
            proc.terminate()

    def shutdown(self) -> None:
        for sid in list(self.procs):
            self.drain(sid)
