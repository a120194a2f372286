"""Rollout controller: the actor plane of asynchronous RL (port of
areal_tpu/system/rollout.py).

It pulls prompts from a data stream and fans them out to generation
servers:

- **Load balancing**: each dispatch picks the server whose ``/health``
  reports the least load (collector queue depth + live decode slots)
  plus the controller's own unanswered dispatches to it.  Health is
  refreshed at a bounded rate, the servers polled at once, each with
  its own timeout.
- **Version stamping**: every trajectory records the weight version it
  started sampling under (``version_start``, the head version) and the
  one it finished under; the `ReplayBuffer` admits on the head version.
- **Backpressure**: while the replay buffer cannot accept (at
  capacity), the controller pulls no prompt, and a finished response
  waits for a free slot rather than evict an unconsumed one.
- **Bounded fan-out**: a semaphore caps the dispatches in flight, on
  top of each client's bounded ``agenerate``.
- **Deadlines and retries**: a dispatch runs under an optional
  deadline (``dispatch_timeout_s``); a failed or expired one is sent
  again, with exponential backoff, to a different server, up to
  ``max_dispatch_retries`` times, before the prompt counts as
  ``failed``.  No prompt is dropped silently.
- **Circuit breaking**: each server has a `CircuitBreaker`; failed
  dispatches and failed health polls open it, the half-open probe rides
  the next health poll, and only closed breakers take dispatches.
- **Dynamic membership**: with a ``discovery`` callable (normally
  `fleet.fleet_discovery` over the ``names.gen_servers`` keepalive
  subtree) the controller diffs the announced fleet at every health
  refresh: a join gets a client and takes dispatches within one refresh
  interval; a leave is drained (no new dispatches, the ones in flight
  finish) and reaped once idle.  Clients passed at construction are
  never drained by discovery.
- **Version pins**: with a ``paramstore`` (`system/paramstore.py`) each
  health poll pins the server's serving version under ``server:{sid}``
  (exclusive: the pin follows the server as it upgrades), each dispatch
  pins the trainer's version under ``dispatch:{qid}`` until the prompt
  ends, and a reap releases the departed server's pins.

With ``episode_runner`` (`system/episode.make_episode_runner`) a prompt
becomes a multi-turn episode on the chosen server and lands in the
buffer as one trajectory.  `state_dict` carries the prompt cursor, so a
recovered trial resumes the stream where it stopped.

With ``mixture`` (a `data/mixture.TaskMixtureStream`) `run()` pumps the
mixture by default, its per-task cursors ride in
``state_dict()["mixture"]`` (a record holding only the scalar cursor is
backfilled by replaying the deterministic schedule), and every dispatch
is stamped with its task.

Every prompt's causal lineage starts here: `_dispatch` mints its
trace_id and stamps the root ``dispatch`` (`base/tracer.py`); the id
rides the request to the server, the grader, the replay admission and
the trainer.  Dispatch decisions and breaker transitions go to the
flight ring.
"""

import asyncio
import dataclasses
import inspect
import logging
import time
from typing import Any, Callable, Dict, FrozenSet, Iterable, Iterator, List, Optional, Sequence

from areal_tpu_torch.api.model_api import APIGenerateInput, GenerationHyperparameters
from areal_tpu_torch.base import metrics, tracer
from areal_tpu_torch.system.fleet import CircuitBreaker
from areal_tpu_torch.system.replay import ReplayBuffer, Trajectory

logger = logging.getLogger("areal_tpu_torch.rollout")


@dataclasses.dataclass
class RolloutStat:
    submitted: int = 0
    completed: int = 0
    accepted: int = 0
    rejected: int = 0
    failed: int = 0
    redispatched: int = 0
    in_flight: int = 0
    backpressure_waits: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServerState:
    """One server as the controller sees it."""

    sid: str
    client: Any  # an LLMAPIClient, or anything with its methods
    breaker: CircuitBreaker
    # False for clients passed at construction (never drained by
    # discovery); True for announced members.
    dynamic: bool = False
    health: Dict = dataclasses.field(default_factory=dict)
    # An explicit flag, so an unreachable server's numbers never count.
    healthy: bool = False
    # Dispatches sent and not yet answered: the live correction to the
    # (staler) polled queue depth.
    local_load: int = 0
    # Draining: no new dispatches; those in flight finish, then the
    # membership sync reaps the entry.
    draining: bool = False


def _normalize_prompt(item, cursor: int):
    """(qid, prompt_ids) pairs, {"qid", "prompt_ids"} dicts or bare
    token lists -> ``(qid, prompt_ids, task)``.  An item with task
    metadata gets a ``{task}:e{epoch}:p{index}`` qid (unique across task
    streams and dataset passes); a plain one ``prompt{cursor}``."""
    if isinstance(item, dict):
        task = str(item.get("task", "") or "")
        ids = list(map(int, item["prompt_ids"]))
        qid = item.get("qid")
        if qid is not None:
            return str(qid), ids, task
        if task or "epoch" in item:
            epoch = int(item.get("epoch", 0) or 0)
            index = int(item.get("index", cursor))
            return f"{task or 'task'}:e{epoch}:p{index}", ids, task
        return f"prompt{cursor}", ids, task
    if isinstance(item, (tuple, list)) and len(item) == 2 and isinstance(item[0], str):
        return item[0], list(map(int, item[1])), ""
    return f"prompt{cursor}", [int(t) for t in item], ""


class RolloutController:
    """Pumps a prompt stream through a set of generation servers into a
    ReplayBuffer."""

    def __init__(
        self,
        clients: Sequence[Any] = (),  # static members (never drained)
        replay: ReplayBuffer = None,
        gconfig: GenerationHyperparameters = None,
        seed: Optional[int] = None,
        max_concurrency: int = 0,  # 0 = the sum of the clients' max_inflight
        health_refresh_s: float = 0.5,
        backpressure_poll_s: float = 0.05,
        autosize_inflight: bool = True,
        discovery: Optional[Callable[[], Dict[str, Any]]] = None,
        dispatch_timeout_s: float = 0.0,  # 0 = no deadline
        max_dispatch_retries: int = 2,
        retry_backoff_s: float = 0.05,  # doubles a retry, at most 2 s
        health_poll_timeout_s: float = 2.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        # Agent episodes: ``episode_runner(client, qid, prompt_ids)``
        # runs a whole episode on the chosen server (blocking; run in a
        # worker thread, so deadlines, retries and breakers apply to the
        # episode) and returns an Episode.
        episode_runner: Optional[Callable[[Any, str, List[int]], Any]] = None,
        # A `ParamStore` whose pins the controller keeps from what it
        # observes: a version retires only when no live server serves it
        # and no prompt in flight was dispatched against it.
        paramstore: Optional[Any] = None,
        # A task-mixture curriculum (`data/mixture.py`): run()'s default
        # prompt source, its cursors in state_dict()["mixture"].
        mixture: Optional[Any] = None,
    ):
        if not clients and discovery is None:
            raise ValueError(
                "rollout controller needs at least one client or a fleet-discovery callable"
            )
        if replay is None or gconfig is None:
            raise ValueError("rollout controller needs replay and gconfig")
        self.replay = replay
        self.gconfig = gconfig
        self.seed = seed
        self.health_refresh_s = health_refresh_s
        self.backpressure_poll_s = backpressure_poll_s
        # True: each health poll sizes a client's agenerate bound to the
        # server's reported decode capacity.
        self.autosize_inflight = autosize_inflight
        self.discovery = discovery
        self.dispatch_timeout_s = dispatch_timeout_s
        self.max_dispatch_retries = max_dispatch_retries
        self.retry_backoff_s = retry_backoff_s
        self.health_poll_timeout_s = health_poll_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.episode_runner = episode_runner
        self.paramstore = paramstore
        self.mixture = mixture
        self._runner_takes_trace = False
        if episode_runner is not None:
            try:
                sig = inspect.signature(episode_runner)
                self._runner_takes_trace = "trace_id" in sig.parameters or any(
                    p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
                )
            except (TypeError, ValueError):
                pass
        self.stat = RolloutStat()
        # Prompts consumed from the stream since the trial started.
        self.cursor = 0
        # Bumps at every join, leave and reap.
        self.membership_epoch = 0
        self._skip_on_run = 0
        self._stop = False
        self._servers: List[ServerState] = []
        self._by_sid: Dict[str, ServerState] = {}
        for i, c in enumerate(clients):
            self._add_server(f"static{i}", c, dynamic=False)
        self._health_ts = 0.0
        self._refresh_lock: Optional[asyncio.Lock] = None
        cap = max_concurrency or sum(
            max(1, int(getattr(c, "max_inflight", 1))) for c in clients
        ) or 16
        self._sem = asyncio.Semaphore(cap)
        self.max_concurrency = cap
        reg = metrics.default_registry()
        self._m_in_flight = reg.gauge("areal_rollout_in_flight", "dispatches awaiting a response")
        self._m_backpressure = reg.counter(
            "areal_rollout_backpressure_total", "waits because the replay buffer could not accept"
        )
        self._m_dispatched = reg.counter(
            "areal_rollout_dispatched_total", "prompt dispatches, by terminal status", ("status",)
        )
        self._m_version_lag = reg.gauge(
            "areal_rollout_version_lag",
            "trainer weight version minus the dispatched server's serving version, at dispatch",
        )
        self._m_redispatch = reg.counter(
            "areal_rollout_redispatch_total",
            "prompts re-sent to a different server after a dispatch failure, by reason",
            ("reason",),
        )
        self._m_breaker_open = reg.gauge(
            "areal_rollout_breaker_open", "servers whose circuit breaker is open"
        )
        self._m_breaker_trans = reg.counter(
            "areal_rollout_breaker_transitions_total",
            "circuit-breaker state transitions, by target state", ("state",),
        )
        self._m_servers = reg.gauge(
            "areal_rollout_servers", "non-draining fleet members known to the controller"
        )

    # ---------------- servers ----------------

    @property
    def clients(self) -> List[Any]:
        return [s.client for s in self._servers]

    @property
    def servers(self) -> List[ServerState]:
        return list(self._servers)

    def server(self, sid: str) -> Optional[ServerState]:
        return self._by_sid.get(sid)

    def _make_breaker(self) -> CircuitBreaker:
        def on_transition(state: str) -> None:
            self._m_breaker_trans.labels(state).inc()
            self._m_breaker_open.set(
                sum(1 for s in self._servers if s.breaker.state == CircuitBreaker.OPEN)
            )
            tracer.flight_event("breaker", state=state)

        return CircuitBreaker(
            threshold=self.breaker_threshold,
            cooldown_s=self.breaker_cooldown_s,
            on_transition=on_transition,
        )

    def _add_server(self, sid: str, client: Any, dynamic: bool) -> ServerState:
        st = ServerState(sid=sid, client=client, breaker=self._make_breaker(), dynamic=dynamic)
        self._servers.append(st)
        self._by_sid[sid] = st
        return st

    def _release_pins(self, holder: str) -> None:
        if self.paramstore is not None:
            try:
                self.paramstore.release_holder(holder)
            except Exception:  # noqa: BLE001 — accounting, not dispatch
                pass

    def _sync_membership(self, mapping: Dict[str, Any]) -> None:
        """Diff the announced fleet against the known set: add joins,
        drain leaves (dynamic members only), reap the drained and idle."""
        changed = False
        for sid, target in mapping.items():
            st = self._by_sid.get(sid)
            if st is None:
                if isinstance(target, str):
                    from areal_tpu_torch.system.gen_server import make_gen_client

                    client = make_gen_client(target)
                else:  # a ready-made client object
                    client = target
                self._add_server(sid, client, dynamic=True)
                changed = True
                logger.info(f"fleet join: {sid}")
            elif st.draining:
                st.draining = False  # announced again while draining
                changed = True
                logger.info(f"fleet re-join: {sid}")
        for st in self._servers:
            if st.dynamic and not st.draining and st.sid not in mapping:
                st.draining = True
                changed = True
                logger.info(f"fleet leave: {st.sid} draining ({st.local_load} in flight)")
        for st in [s for s in self._servers if s.draining and s.local_load == 0]:
            self._servers.remove(st)
            del self._by_sid[st.sid]
            changed = True
            logger.info(f"fleet reap: {st.sid}")
            # A reaped server no longer holds its version alive (the
            # store's TTL covers a crash no reap observes).
            self._release_pins(f"server:{st.sid}")
            close = getattr(st.client, "close", None)
            if st.dynamic and callable(close):
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        if changed:
            self.membership_epoch += 1
        self._m_servers.set(sum(1 for s in self._servers if not s.draining))

    def drain(self, sid: str) -> None:
        """Stop dispatching to `sid`; the dispatches in flight finish."""
        st = self._by_sid.get(sid)
        if st is not None:
            st.draining = True

    # ---------------- recover ----------------

    def state_dict(self) -> Dict[str, Any]:
        sd = {
            "cursor": self.cursor,
            "stat": self.stat.as_dict(),
            "membership_epoch": self.membership_epoch,
        }
        if self.mixture is not None:
            sd["mixture"] = self.mixture.state_dict()
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.cursor = int(sd.get("cursor", 0))
        self.membership_epoch = int(sd.get("membership_epoch", 0))
        for k, v in sd.get("stat", {}).items():
            if hasattr(self.stat, k) and k != "in_flight":
                setattr(self.stat, k, int(v))
        self.stat.in_flight = 0
        if self.mixture is not None:
            ms = sd.get("mixture")
            if ms:
                # Per-task cursors restore exactly: the stream resumes
                # itself, and run() skips nothing.
                self.mixture.load_state_dict(ms)
            else:
                # A record from before the mixture holds only the scalar
                # cursor: replaying that many draws of the deterministic
                # schedule rebuilds the per-task positions.
                self.mixture.fast_forward(self.cursor)
            self._skip_on_run = 0
            return
        # The next run() fast-forwards the restarted prompt stream past
        # what the trial already consumed.
        self._skip_on_run = self.cursor

    def stop(self) -> None:
        self._stop = True

    # ---------------- health / load balancing ----------------

    async def _poll_one(self, st: ServerState) -> None:
        """One server's health poll.  An open breaker is not polled until
        its cooldown has passed; the poll after it is the half-open
        probe."""
        br = st.breaker
        if br.state == CircuitBreaker.OPEN:
            if not br.probe_due():
                st.health = {}
                st.healthy = False
                return
            br.begin_probe()
        try:
            h = await asyncio.wait_for(
                asyncio.to_thread(st.client.health), timeout=self.health_poll_timeout_s
            )
        except Exception as e:  # noqa: BLE001 — deprioritize, do not die
            logger.warning(f"health poll failed for {st.sid}: {e!r}")
            st.health = {}
            st.healthy = False
            br.record_failure()
            return
        st.health = h
        st.healthy = True
        br.record_success()
        if self.paramstore is not None and h.get("version") is not None:
            # Exclusive: the pin follows the server's serving version; a
            # laggard keeps its version alive until it catches up.
            try:
                self.paramstore.pin(int(h["version"]), f"server:{st.sid}", exclusive=True)
            except Exception:  # noqa: BLE001 — accounting, not dispatch
                pass
        cap = int(h.get("capacity", 0))
        if cap > 0 and self.autosize_inflight:
            st.client.max_inflight = max(cap, 1)

    async def _refresh_health(self) -> None:
        if self.discovery is not None:
            try:
                mapping = await asyncio.to_thread(self.discovery)
            except Exception as e:  # noqa: BLE001 — keep the last view
                logger.warning(f"fleet discovery failed: {e!r}")
            else:
                self._sync_membership(dict(mapping))
        await asyncio.gather(*(self._poll_one(s) for s in self._servers if not s.draining))

    async def _maybe_refresh(self) -> None:
        if self._refresh_lock is None:
            self._refresh_lock = asyncio.Lock()
        async with self._refresh_lock:
            if time.monotonic() - self._health_ts < self.health_refresh_s:
                return
            await self._refresh_health()
            self._health_ts = time.monotonic()

    def _load_score(self, st: ServerState) -> float:
        h = st.health
        return float(h.get("queue_depth", 0)) + float(h.get("live_slots", 0)) + st.local_load

    def _eligible(self, exclude: FrozenSet[str]) -> List[ServerState]:
        return [
            s for s in self._servers
            if not s.draining and s.healthy and s.breaker.allow_dispatch()
            and s.sid not in exclude
        ]

    async def _choose_client(self, exclude: FrozenSet[str] = frozenset()
                             ) -> Optional[ServerState]:
        """The least-loaded dispatchable server, preferring one not in
        `exclude` (servers seen failing this prompt); waits through
        refreshes while none is dispatchable.  None only after stop()."""
        while not self._stop:
            await self._maybe_refresh()
            eligible = self._eligible(exclude) or self._eligible(frozenset())
            if eligible:
                return min(eligible, key=self._load_score)
            await asyncio.sleep(min(self.health_refresh_s, 0.1))
        return None

    # ---------------- the pump ----------------

    async def run(self, prompt_source: Optional[Iterable] = None,
                  max_prompts: Optional[int] = None) -> RolloutStat:
        """Pump prompts until the source ends, `max_prompts` are
        dispatched or stop(), then await every dispatch in flight.  With
        no source, the configured mixture is pumped (it never ends: bound
        it with `max_prompts`)."""
        if prompt_source is None:
            prompt_source = self.mixture
        if prompt_source is None:
            raise ValueError("run() needs a prompt source (or a configured mixture)")
        it: Iterator = iter(prompt_source)
        while self._skip_on_run > 0:
            if next(it, None) is None:
                break
            self._skip_on_run -= 1
        tasks: "set[asyncio.Task]" = set()
        dispatched = 0
        while not self._stop and (max_prompts is None or dispatched < max_prompts):
            # A full buffer means the trainer is behind: more prompts
            # would only evict samples it never saw.
            while not self.replay.can_accept() and not self._stop:
                self.stat.backpressure_waits += 1
                self._m_backpressure.inc()
                tracer.counter("rollout_controller", in_flight=self.stat.in_flight,
                               backpressured=1)
                await asyncio.sleep(self.backpressure_poll_s)
            if self._stop:
                break
            item = next(it, None)
            if item is None:
                break
            qid, prompt_ids, task = _normalize_prompt(item, self.cursor)
            self.cursor += 1
            dispatched += 1
            t = asyncio.create_task(self._dispatch(qid, prompt_ids, task))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
            await asyncio.sleep(0)  # dispatches start at once on a fast source
        if tasks:
            await asyncio.gather(*tasks)
        return self.stat

    async def completed_groups(self, n_groups: Optional[int] = None,
                               timeout_per_group: Optional[float] = None,
                               poll_s: float = 0.2):
        """Async iterator over retired groups in retirement order, each
        stamped with ``retired_version``: the streaming complement of
        ``replay.get_batch``.  Waits run in a worker thread in ``poll_s``
        slices so stop() ends the iterator promptly;
        ``timeout_per_group`` bounds each group's wait (TimeoutError)."""
        yielded = 0
        while not self._stop and (n_groups is None or yielded < n_groups):
            deadline = None if timeout_per_group is None else time.monotonic() + timeout_per_group
            while True:
                if self._stop:
                    return
                wait = poll_s
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"completed_groups: waited {timeout_per_group}s for the next "
                            "admissible group"
                        )
                    wait = min(wait, remaining)
                try:
                    batch = await asyncio.to_thread(self.replay.get_batch, 1, wait)
                except TimeoutError:
                    continue
                break
            yield batch[0]
            yielded += 1

    async def _generate_with_retries(self, qid: str, prompt_ids: List[int],
                                     trace_id: str = ""):
        """Dispatch under the deadline, re-sending on failure: each failure
        excludes that server for this prompt, counts on its breaker and
        backs off.  Returns the output, or None once every attempt failed
        (or after stop())."""
        exclude: set = set()
        backoff = self.retry_backoff_s
        attempts = 1 + max(0, self.max_dispatch_retries)
        for attempt in range(attempts):
            srv = await self._choose_client(frozenset(exclude))
            if srv is None:
                return None
            srv.local_load += 1
            srv_version = srv.health.get("version")
            if srv_version is not None:
                self._m_version_lag.set(self.replay.version - int(srv_version))
            tracer.flight_event("dispatch", trace_id=trace_id, qid=qid, sid=srv.sid,
                                attempt=attempt)
            err = reason = None
            try:
                if self.episode_runner is not None:
                    kw = {"trace_id": trace_id or None} if self._runner_takes_trace else {}
                    coro = asyncio.to_thread(
                        self.episode_runner, srv.client, qid, prompt_ids, **kw
                    )
                else:
                    coro = srv.client.agenerate(APIGenerateInput(
                        qid=qid, prompt_ids=prompt_ids, gconfig=self.gconfig, seed=self.seed,
                        trace_id=trace_id or None,
                    ))
                if self.dispatch_timeout_s > 0:
                    out = await asyncio.wait_for(coro, timeout=self.dispatch_timeout_s)
                else:
                    out = await coro
            except asyncio.TimeoutError:
                err, reason = f"deadline ({self.dispatch_timeout_s}s) expired", "timeout"
            except Exception as e:  # noqa: BLE001 — one prompt, not the pump
                err, reason = repr(e), "error"
            finally:
                srv.local_load -= 1
            if err is None:
                srv.breaker.record_success()
                return out
            srv.breaker.record_failure()
            exclude.add(srv.sid)
            last = attempt == attempts - 1
            logger.warning(f"dispatch {qid} -> {srv.sid} failed ({err}); "
                           + ("giving up" if last else "re-dispatching"))
            if not last:
                self.stat.redispatched += 1
                self._m_redispatch.labels(reason).inc()
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
        return None

    async def _dispatch(self, qid: str, prompt_ids: List[int], task: str = "") -> None:
        # The lineage root: the trace_id rides the request through the
        # server, the grader, the replay admission and the trainer; the
        # task stamp lets trace_report attribute latency a task stream.
        trace_id = tracer.new_trace_id()
        t_dispatch = time.monotonic()
        tracer.lineage(
            "dispatch", trace_id, root=True, qid=qid, prompt_len=len(prompt_ids),
            trainer_version=self.replay.version, **({"task": task} if task else {}),
        )
        async with self._sem:
            self.stat.submitted += 1
            self.stat.in_flight += 1
            self._m_in_flight.set(self.stat.in_flight)
            tracer.counter("rollout_controller", in_flight=self.stat.in_flight,
                           backpressured=0)
            if self.paramstore is not None:
                # The version this prompt was dispatched against stays in
                # the store until the prompt ends.
                try:
                    self.paramstore.pin(self.replay.version, f"dispatch:{qid}", exclusive=False)
                except Exception:  # noqa: BLE001 — accounting only
                    pass
            try:
                out = await self._generate_with_retries(qid, prompt_ids, trace_id)
            finally:
                self.stat.in_flight -= 1
                self._m_in_flight.set(self.stat.in_flight)
                self._release_pins(f"dispatch:{qid}")
            if out is None:
                # Every retry failed: counted, never dropped silently.
                self.stat.failed += 1
                self._m_dispatched.labels("failed").inc()
                tracer.lineage("failed", trace_id, qid=qid, error="exhausted")
                return
            self.stat.completed += 1
        if self.episode_runner is not None:
            # One Episode is one trajectory; its turns ride in data.
            traj = out.to_trajectory(qid, birth_time=time.time())
        else:
            traj = Trajectory(
                qid=out.qid, prompt_ids=list(out.prompt_ids), output_ids=out.output_ids,
                output_logprobs=out.output_logprobs, no_eos=out.no_eos,
                version_start=out.version_start, version_end=out.version,
            )
        traj.trace_id = trace_id
        traj.t_dispatch = t_dispatch
        traj.task = task
        # Lossless backpressure on the put side: a finished response waits
        # for a free slot rather than evict an unconsumed one.  A response
        # too stale already goes to put() and is rejected.
        while (
            not self._stop
            and len(self.replay) >= self.replay.capacity
            and self.replay.version - traj.version_start <= self.replay.max_head_offpolicyness
        ):
            self.stat.backpressure_waits += 1
            self._m_backpressure.inc()
            await asyncio.sleep(self.backpressure_poll_s)
        if self.replay.put(traj):
            self.stat.accepted += 1
            self._m_dispatched.labels("accepted").inc()
        else:
            self.stat.rejected += 1
            self._m_dispatched.labels("rejected").inc()
