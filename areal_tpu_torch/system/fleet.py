"""The generation fleet: circuit breaking, membership and the SLO-driven
supervisor (port of areal_tpu/system/fleet.py).

- `CircuitBreaker`: the dispatch gate the rollout controller keeps for
  each server.
- `fleet_discovery`: membership as a closure.  Generation servers
  announce under ``names.gen_servers`` with a keepalive TTL
  (`GenerationServer.announce`); the closure lists the live subtree as
  ``{server_id: url}``.  An expired keepalive (a dead server) drops out
  of the listing without anyone deregistering it.
- `LocalProcessFleet`: spawns and drains server processes on this host.

- `FleetSupervisor`: evaluates the metrics report's SLO rules
  (`apps/metrics_report.py`) against live fleet scrapes and spawns or
  drains generation servers: a CRIT violation on a capacity signal
  (staleness p99, queue depth, backpressure) adds a server, a sustained
  idle window (goodput ~0, the fleet idle, nothing in flight) drains the
  last in sorted order.  Both respect ``[min_servers, max_servers]`` and
  an action cooldown.  Membership epochs persist through
  ``RecoverInfo.fleet_state``, merged with what the master wrote, so a
  restarted supervisor resumes its epoch counters.  A `param_repair`
  hook (`paramstore.BroadcastFabric.repair`) runs once a round.
- `SupervisorLane`: a second, independently scaled pool on the same
  scrape loop (the verifier fleet): refill below ``min_servers`` without
  the cooldown, scale up on a CRIT of its own signals, drain after an
  idle window.

The verifier fleet's members and pool client are
`system/verifier_pool.py`; `apps/fleet.py` is the supervisor's command
line.
"""

import dataclasses
import logging
import shlex
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from areal_tpu_torch.base import name_resolve, names, recover

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


# ---------------------------------------------------------------------------
# Supervisor


@dataclasses.dataclass
class FleetDecision:
    action: str  # "spawn" | "drain" | "hold"
    reason: str = ""
    victim: str = ""  # server_id being drained (drain only)


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


class SupervisorLane:
    """One independently-scaled service pool under the supervisor.

    The gen-server fleet is the supervisor's built-in concern; a lane is
    a SECOND pool with its own membership view, SLO rules, bounds, and
    cooldown that rides the same control loop (the verifier fleet is the
    first consumer — RLAX/Podracer-style decoupled pools per pipeline
    role, each scaled on its own signals).  Three behaviours per tick:

    - **refill** — live membership below ``min_servers`` spawns
      immediately, bypassing the cooldown: a TTL-evicted crash leaves a
      hole the lane must repair as liveness, not as a tuning decision;
    - **scale-up** — a CRIT violation of a rule whose signal is in
      ``scale_up_signals`` (e.g. ``grade_latency_p99``,
      ``verifier_queue_depth``) spawns one, respecting ``max_servers``
      and the cooldown;
    - **scale-down** — ``idle_rounds`` consecutive scrapes with the
      ``idle_signal`` at ~0 drain the last member, down to
      ``min_servers``.

    ``list_servers``/``spawn``/``drain`` are injectable callables
    (``verifier_pool.list_verifiers`` + ``LocalProcessFleet`` methods in
    production, fakes in tests); the lane itself never forks.
    """

    def __init__(
        self,
        name: str,
        list_servers: Callable[[], List[str]],
        rules: Sequence[Any] = (),  # metrics_report.SLORule
        spawn: Optional[Callable[[], Any]] = None,
        drain: Optional[Callable[[str], Any]] = None,
        min_servers: int = 1,
        max_servers: int = 8,
        scale_up_signals: Sequence[str] = (
            "grade_latency_p99", "verifier_queue_depth",
        ),
        action_cooldown_s: float = 30.0,
        idle_rounds: int = 3,
        idle_signal: str = "verifier_queue_depth",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.list_servers = list_servers
        self.rules = list(rules)
        self.spawn = spawn
        self.drain = drain
        self.min_servers = min_servers
        self.max_servers = max_servers
        self.scale_up_signals = set(scale_up_signals)
        self.action_cooldown_s = action_cooldown_s
        self.idle_rounds = idle_rounds
        self.idle_signal = idle_signal
        self._clock = clock
        self.epoch = 0
        self._idle_streak = 0
        self._last_action_t: Optional[float] = None

    def _cooled_down(self) -> bool:
        return (
            self._last_action_t is None
            or self._clock() - self._last_action_t >= self.action_cooldown_s
        )

    def evaluate(
        self, history: Sequence[Dict[str, float]]
    ) -> FleetDecision:
        """One control-loop step over the SHARED signal history the
        supervisor already appended to (lanes never append — one scrape,
        many consumers)."""
        signals = history[-1] if history else {}
        live = self.list_servers()
        n = len(live)
        if n < self.min_servers:
            return FleetDecision(
                "spawn",
                f"[{self.name}] {n} live < min_servers="
                f"{self.min_servers} (refill)",
            )
        for rule in self.rules:
            msg = rule.evaluate(history)
            if (
                msg is not None
                and rule.severity == "crit"
                and rule.signal in self.scale_up_signals
            ):
                self._idle_streak = 0
                if n >= self.max_servers:
                    return FleetDecision(
                        "hold",
                        f"[{self.name}] CRIT but at max_servers="
                        f"{self.max_servers}: {msg}",
                    )
                if not self._cooled_down():
                    return FleetDecision(
                        "hold", f"[{self.name}] CRIT but cooling down: {msg}"
                    )
                return FleetDecision("spawn", f"[{self.name}] {msg}")
        idle = signals.get(self.idle_signal, 0.0) <= 0.0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if (
            self._idle_streak >= self.idle_rounds
            and n > self.min_servers
            and self._cooled_down()
        ):
            self._idle_streak = 0
            return FleetDecision(
                "drain",
                f"[{self.name}] {self.idle_signal} idle for "
                f"{self.idle_rounds} consecutive scrapes",
                victim=sorted(live)[-1],
            )
        return FleetDecision("hold", "")

    def apply(self, decision: FleetDecision) -> None:
        if decision.action == "hold":
            return
        if decision.action == "spawn":
            if self.spawn is None:
                logger.warning(
                    f"lane {self.name} would spawn ({decision.reason}) "
                    "but no spawn action is configured"
                )
                return
            self.spawn()
        elif decision.action == "drain":
            if self.drain is None:
                logger.warning(
                    f"lane {self.name} would drain {decision.victim} "
                    f"({decision.reason}) but no drain action is configured"
                )
                return
            self.drain(decision.victim)
        self._last_action_t = self._clock()
        self.epoch += 1
        logger.info(
            f"lane {self.name} {decision.action} (epoch {self.epoch}): "
            f"{decision.reason}"
        )

    def step(
        self, history: Sequence[Dict[str, float]]
    ) -> FleetDecision:
        decision = self.evaluate(history)
        if decision.action != "hold":
            self.apply(decision)
        return decision


class FleetSupervisor:
    """SLO-rule-driven autoscaler over the announced gen-server fleet.

    Scale-up: any CRIT violation of a rule whose signal is in
    ``scale_up_signals`` (capacity pressure) spawns one server.
    Scale-down: ``idle_rounds`` consecutive evaluations with goodput at
    ~0 and the fleet idle drain one.  Both respect ``[min_servers,
    max_servers]`` and an action cooldown so the loop cannot flap.

    ``spawn``/``drain`` are callables (``LocalProcessFleet`` methods, or
    fakes in tests); the supervisor itself never forks.
    """

    def __init__(
        self,
        experiment: str,
        trial: str,
        rules: Sequence[Any] = (),  # metrics_report.SLORule
        spawn: Optional[Callable[[], Any]] = None,
        drain: Optional[Callable[[str], Any]] = None,
        min_servers: int = 1,
        max_servers: int = 8,
        action_cooldown_s: float = 30.0,
        idle_rounds: int = 3,
        idle_goodput: float = 1e-6,
        idle_frac: float = 0.95,
        scale_up_signals: Sequence[str] = (
            "staleness_p99", "queue_depth", "backpressure",
        ),
        recover_root: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        # Parameter-fabric repair hook (BroadcastFabric.repair or a
        # fake): invoked once per control-loop tick so servers that
        # joined/lagged between pushes (a fresh spawn, a breaker-open
        # subtree orphaned mid-broadcast) are caught up to the store
        # head without waiting for the next training step's push.
        param_repair: Optional[Callable[[], Any]] = None,
        # Additional independently-scaled pools (e.g. the verifier
        # fleet) riding the same scrape loop — see SupervisorLane.
        lanes: Sequence["SupervisorLane"] = (),
    ):
        self.experiment = experiment
        self.trial = trial
        self.lanes = list(lanes)
        self.rules = list(rules)
        self.spawn = spawn
        self.drain = drain
        self.min_servers = min_servers
        self.max_servers = max_servers
        self.action_cooldown_s = action_cooldown_s
        self.idle_rounds = idle_rounds
        self.idle_goodput = idle_goodput
        self.idle_frac = idle_frac
        self.scale_up_signals = set(scale_up_signals)
        self.recover_root = recover_root
        self.param_repair = param_repair
        self._clock = clock
        self.history: List[Dict[str, float]] = []
        self.membership_epoch = 0
        self._idle_streak = 0
        self._last_action_t: Optional[float] = None
        self._restore()

    # ---------------- membership / persistence ----------------

    def list_servers(self) -> List[str]:
        root = names.gen_servers(self.experiment, self.trial)
        return [
            key[len(root) + 1:] for key in name_resolve.find_subtree(root)
        ]

    def _restore(self) -> None:
        if not self.recover_root:
            return
        info = recover.load(self.recover_root)
        if info is not None and info.fleet_state:
            self.membership_epoch = int(
                info.fleet_state.get("membership_epoch", 0)
            )
            lane_state = info.fleet_state.get("lanes", {}) or {}
            for lane in self.lanes:
                st = lane_state.get(lane.name)
                if st:
                    lane.epoch = int(st.get("epoch", 0))
            logger.info(
                f"fleet supervisor recovered at membership epoch "
                f"{self.membership_epoch}"
            )

    def persist(self) -> None:
        """Write the membership epoch + server set into the trial's
        RecoverInfo (merging with whatever the master already dumped)."""
        if not self.recover_root:
            return
        info = recover.load(self.recover_root) or recover.RecoverInfo()
        info.fleet_state = {
            "membership_epoch": self.membership_epoch,
            "servers": sorted(self.list_servers()),
            "lanes": {
                lane.name: {
                    "epoch": lane.epoch,
                    "servers": sorted(lane.list_servers()),
                }
                for lane in self.lanes
            },
        }
        recover.dump(info, self.recover_root)

    # ---------------- decisions ----------------

    def _cooled_down(self) -> bool:
        return (
            self._last_action_t is None
            or self._clock() - self._last_action_t >= self.action_cooldown_s
        )

    def evaluate(self, signals: Dict[str, float]) -> FleetDecision:
        """One control-loop step: append the scrape to history, evaluate
        the SLO rules, return a decision (without executing it)."""
        self.history.append(signals)
        n = len(self.list_servers())
        for rule in self.rules:
            msg = rule.evaluate(self.history)
            if (
                msg is not None
                and rule.severity == "crit"
                and rule.signal in self.scale_up_signals
            ):
                self._idle_streak = 0
                if n >= self.max_servers:
                    return FleetDecision(
                        "hold", f"CRIT but at max_servers={self.max_servers}: {msg}"
                    )
                if not self._cooled_down():
                    return FleetDecision("hold", f"CRIT but cooling down: {msg}")
                return FleetDecision("spawn", msg)
        idle = (
            signals.get("goodput", 0.0) <= self.idle_goodput
            and signals.get("idle_frac", 0.0) >= self.idle_frac
            and signals.get("in_flight", 0.0) <= 0.0
        )
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if (
            self._idle_streak >= self.idle_rounds
            and n > self.min_servers
            and self._cooled_down()
        ):
            servers = sorted(self.list_servers())
            self._idle_streak = 0
            return FleetDecision(
                "drain",
                f"idle for {self.idle_rounds} consecutive scrapes "
                f"(goodput<={self.idle_goodput:g}, "
                f"idle_frac>={self.idle_frac:g})",
                victim=servers[-1],
            )
        return FleetDecision("hold", "")

    def apply(self, decision: FleetDecision) -> None:
        if decision.action == "hold":
            return
        if decision.action == "spawn":
            if self.spawn is None:
                logger.warning(
                    f"fleet would spawn ({decision.reason}) but no spawn "
                    "action is configured"
                )
                return
            self.spawn()
        elif decision.action == "drain":
            if self.drain is None:
                logger.warning(
                    f"fleet would drain {decision.victim} "
                    f"({decision.reason}) but no drain action is configured"
                )
                return
            self.drain(decision.victim)
        self._last_action_t = self._clock()
        self.membership_epoch += 1
        logger.info(
            f"fleet {decision.action} (epoch {self.membership_epoch}): "
            f"{decision.reason}"
        )
        self.persist()

    # ---------------- the control loop ----------------

    def run(
        self,
        count: Optional[int] = None,
        interval: float = 2.0,
    ) -> List[FleetDecision]:
        """Scrape → evaluate → act, ``count`` times (None = forever).
        Reuses the metrics plane's scrape/signal machinery so the
        supervisor and the watchdog see the SAME numbers."""
        from areal_tpu_torch.apps import metrics_report as mr

        actions: List[FleetDecision] = []
        prev = None
        i = 0
        while count is None or i < count:
            if i > 0:
                time.sleep(interval)
            endpoints = mr.discover(self.experiment, self.trial)
            roles = mr.scrape_fleet(endpoints)
            signals, _ = mr.fleet_signals(roles, prev)
            prev = {r.role: r for r in roles}
            decision = self.evaluate(signals)
            if decision.action != "hold":
                self.apply(decision)
                actions.append(decision)
            for lane in self.lanes:
                lane_decision = lane.step(self.history)
                if lane_decision.action != "hold":
                    actions.append(lane_decision)
                    self.persist()
            if self.param_repair is not None:
                try:
                    self.param_repair()
                except Exception as e:  # noqa: BLE001 — repair is advisory
                    logger.warning(f"param repair failed: {e!r}")
            i += 1
        return actions
