"""Staleness-bounded replay buffer of asynchronous RL (port of
areal_tpu/system/replay.py).

Trajectories arrive stamped with the weight version they started
sampling under (the head version); the trainer advances its own version
as it steps.  A trajectory is admissible iff

    trainer_version - traj.version_start <= max_head_offpolicyness

`put` rejects a trajectory that is already too stale when it arrives,
and `set_version` and `get_batch` purge entries that aged past the cap
while queued, so they are dropped rather than trained on.  With
``max_head_offpolicyness=0`` only trajectories sampled under the current
weights are ever returned: the synchronous regime.

Thread-safe: the rollout plane puts from its threads while the trainer
gets from its own loop.  Occupancy and the admission outcomes are
exported as gauges and counters on the port's `base/metrics.py`
registry and as the tracer's ``replay_buffer`` and ``replay_staleness``
counters; a trajectory carrying a trace_id gets its ``admitted``,
``rejected_stale`` and ``trained`` lineage stamps here.
"""

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import metrics, tracer

# Registered once at import; every ReplayBuffer of a process shares them
# (in practice one buffer a trainer process).
_reg = metrics.default_registry()
_M_STALENESS = _reg.histogram(
    "areal_replay_staleness",
    "staleness (trainer_version - version_start) of consumed trajectories",
    buckets=(0, 1, 2, 4, 8, 16, 32),
)
_M_SIZE = _reg.gauge("areal_replay_size", "resident trajectories")
_M_CAPACITY = _reg.gauge("areal_replay_capacity", "buffer capacity")
_M_VERSION = _reg.gauge("areal_replay_version", "trainer weight version")
_M_MIN_VERSION = _reg.gauge("areal_replay_min_version", "oldest resident head version")
_M_MAX_VERSION = _reg.gauge("areal_replay_max_version", "newest resident head version")
_M_EVENTS = _reg.counter(
    "areal_replay_events_total",
    "admission outcomes: accepted / rejected / evicted / dropped_stale / consumed",
    ("event",),
)
# Per-sample latencies from the rollout controller's dispatch stamp.
_LAT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 120.0)
_M_E2E = _reg.histogram(
    "areal_sample_e2e_seconds",
    "dispatch -> train-consumption wall time per trajectory",
    buckets=_LAT_BUCKETS,
)
_M_ADMIT = _reg.histogram(
    "areal_sample_admit_seconds",
    "dispatch -> replay-admission wall time per trajectory",
    buckets=_LAT_BUCKETS,
)


@dataclasses.dataclass
class Trajectory:
    """One rollout group (a prompt and its ``n`` responses) with the
    weight-version stamps the asynchronous plane keys on."""

    qid: str
    prompt_ids: list  # List[int]
    output_ids: list  # List[List[int]]
    output_logprobs: list  # List[List[float]]
    no_eos: list  # List[bool]
    version_start: int = 0  # weight version when sampling started
    version_end: int = 0  # weight version when sampling finished
    birth_time: float = 0.0
    # Trainer version when the buffer handed the group out (-1 = not yet).
    retired_version: int = -1
    data: Any = None  # opaque payload
    trace_id: str = ""
    t_dispatch: float = 0.0  # monotonic dispatch stamp (0: unknown)
    task: str = ""  # the task stream it came from ("" = single stream)

    def staleness(self, trainer_version: int) -> int:
        return trainer_version - self.version_start


class StaleTrajectoryError(ValueError):
    pass


class ReplayBuffer:
    """FIFO buffer with bounded-staleness admission and capacity eviction.

    Args:
        capacity: most resident trajectories; a put at capacity evicts
            the oldest (counted in ``evicted``).
        max_head_offpolicyness: the admission cap on
            ``trainer_version - version_start``.  0 = synchronous.
        on_drop: called (lock held: cheap, no calls back into the
            buffer) for every trajectory discarded without reaching the
            trainer: a capacity eviction or one aged past the cap.
    """

    def __init__(
        self,
        capacity: int = 128,
        max_head_offpolicyness: int = 0,
        on_drop: Optional[Callable[[Trajectory], None]] = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if max_head_offpolicyness < 0:
            raise ValueError(
                f"max_head_offpolicyness must be >= 0, got {max_head_offpolicyness}"
            )
        self.capacity = capacity
        self.max_head_offpolicyness = max_head_offpolicyness
        self.on_drop = on_drop
        self._entries: List[Trajectory] = []
        self._cond = threading.Condition()
        self._version = 0
        # Monotonic counters (persisted through watermarks()).
        self.accepted = 0
        self.rejected = 0
        self.evicted = 0  # capacity evictions
        self.dropped_stale = 0  # aged past the cap while queued
        self.consumed = 0
        # Per-task consumed count and staleness sum (task-stamped only).
        self._task_stats: Dict[str, Dict[str, float]] = {}

    # ---------------- trainer side ----------------

    @property
    def version(self) -> int:
        return self._version

    def set_version(self, v: int) -> None:
        """The trainer advances its weight version; entries that aged
        past the cap are purged at once."""
        with self._cond:
            if v < self._version:
                raise ValueError(f"version must be monotonic: {v} < {self._version}")
            self._version = v
            self._purge_stale_locked()
            self._emit_gauges_locked()
            self._cond.notify_all()

    def get_batch(self, n: int, timeout: Optional[float] = None) -> List[Trajectory]:
        """Block until ``n`` admissible trajectories are resident; return
        the oldest ``n`` (FIFO), each stamped with ``retired_version``.
        Raises TimeoutError on expiry."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._purge_stale_locked()
                if len(self._entries) >= n:
                    out = self._entries[:n]
                    del self._entries[:n]
                    self.consumed += n
                    _M_EVENTS.labels("consumed").inc(n)
                    now = time.monotonic()
                    for t in out:
                        t.retired_version = self._version
                        _M_STALENESS.observe(t.staleness(self._version))
                        if t.task:
                            st = self._task_stats.setdefault(
                                t.task, {"consumed": 0, "staleness_sum": 0.0}
                            )
                            st["consumed"] += 1
                            st["staleness_sum"] += t.staleness(self._version)
                        if t.t_dispatch:
                            _M_E2E.observe(max(0.0, now - t.t_dispatch))
                        if t.trace_id:
                            tracer.lineage(
                                "trained", t.trace_id, qid=t.qid,
                                staleness=t.staleness(self._version),
                                trainer_version=self._version,
                            )
                    self._emit_gauges_locked()
                    return out
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"replay buffer: waited {timeout}s for {n} admissible "
                            f"trajectories, have {len(self._entries)}"
                        )
                    self._cond.wait(timeout=remaining)
                else:
                    self._cond.wait(timeout=1.0)

    def get_group(self, timeout: Optional[float] = None) -> Trajectory:
        """Retire the single oldest admissible group (one Trajectory is
        one GRPO group)."""
        return self.get_batch(1, timeout=timeout)[0]

    def stream(self, n_groups: Optional[int] = None,
               timeout_per_group: Optional[float] = None):
        """Generator of retired groups in FIFO order: ``n_groups`` of
        them (forever when None), blocking a group at a time."""
        yielded = 0
        while n_groups is None or yielded < n_groups:
            yield self.get_group(timeout=timeout_per_group)
            yielded += 1

    # ---------------- rollout side ----------------

    def put(self, traj: Trajectory, strict: bool = False) -> bool:
        """Admit a trajectory.  Returns False (raises when ``strict``) if
        its head version lags the trainer by more than the cap."""
        with self._cond:
            if traj.staleness(self._version) > self.max_head_offpolicyness:
                self.rejected += 1
                _M_EVENTS.labels("rejected").inc()
                if traj.trace_id:
                    tracer.lineage("rejected_stale", traj.trace_id, qid=traj.qid,
                                   version_lag=traj.staleness(self._version))
                self._emit_gauges_locked()
                if strict:
                    raise StaleTrajectoryError(
                        f"trajectory {traj.qid}: version_start={traj.version_start} lags "
                        f"trainer version {self._version} by more than "
                        f"max_head_offpolicyness={self.max_head_offpolicyness}"
                    )
                return False
            if not traj.birth_time:
                traj.birth_time = time.monotonic()
            while len(self._entries) >= self.capacity:
                old = self._entries.pop(0)
                self.evicted += 1
                _M_EVENTS.labels("evicted").inc()
                if self.on_drop is not None:
                    self.on_drop(old)
            self._entries.append(traj)
            self.accepted += 1
            _M_EVENTS.labels("accepted").inc()
            if traj.t_dispatch:
                _M_ADMIT.observe(max(0.0, time.monotonic() - traj.t_dispatch))
            if traj.trace_id:
                tracer.lineage("admitted", traj.trace_id, qid=traj.qid,
                               version_lag=traj.staleness(self._version),
                               version_start=traj.version_start)
            self._emit_gauges_locked()
            self._cond.notify_all()
            return True

    def can_accept(self, version_start: Optional[int] = None) -> bool:
        """Backpressure probe: True iff a put would neither evict nor be
        rejected."""
        with self._cond:
            if len(self._entries) >= self.capacity:
                return False
            if version_start is not None and (
                self._version - version_start > self.max_head_offpolicyness
            ):
                return False
            return True

    # ---------------- introspection ----------------

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def staleness_histogram(self) -> Dict[int, int]:
        """Occupancy by staleness offset (trainer_version - version_start)."""
        with self._cond:
            return self._histogram_locked()

    def task_watermarks(self) -> Dict[str, Dict[str, float]]:
        """Per task: ``{"consumed", "staleness_mean"}`` over the retired
        task-stamped trajectories."""
        with self._cond:
            out: Dict[str, Dict[str, float]] = {}
            for task, st in self._task_stats.items():
                n = int(st["consumed"])
                out[task] = {
                    "consumed": n,
                    "staleness_mean": st["staleness_sum"] / n if n else 0.0,
                }
            return out

    def watermarks(self) -> Dict[str, Any]:
        """Version watermarks and counters, persisted in RecoverInfo so a
        restarted trial resumes admission where it left off."""
        with self._cond:
            versions = [t.version_start for t in self._entries]
            return {
                "version": self._version,
                "size": len(self._entries),
                "min_version": min(versions) if versions else self._version,
                "max_version": max(versions) if versions else self._version,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "evicted": self.evicted,
                "dropped_stale": self.dropped_stale,
                "consumed": self.consumed,
                "tasks": {t: dict(st) for t, st in self._task_stats.items()},
            }

    def load_watermarks(self, wm: Dict[str, Any]) -> None:
        with self._cond:
            self._version = int(wm.get("version", 0))
            self.accepted = int(wm.get("accepted", 0))
            self.rejected = int(wm.get("rejected", 0))
            self.evicted = int(wm.get("evicted", 0))
            self.dropped_stale = int(wm.get("dropped_stale", 0))
            self.consumed = int(wm.get("consumed", 0))
            # Absent in records from before task streams: empty.
            self._task_stats = {
                t: {"consumed": int(st.get("consumed", 0)),
                    "staleness_sum": float(st.get("staleness_sum", 0.0))}
                for t, st in (wm.get("tasks") or {}).items()
            }
            self._cond.notify_all()

    # ---------------- internals (lock held) ----------------

    def _histogram_locked(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for t in self._entries:
            off = t.staleness(self._version)
            hist[off] = hist.get(off, 0) + 1
        return hist

    def _purge_stale_locked(self) -> None:
        keep = []
        for t in self._entries:
            if t.staleness(self._version) > self.max_head_offpolicyness:
                self.dropped_stale += 1
                _M_EVENTS.labels("dropped_stale").inc()
                if self.on_drop is not None:
                    self.on_drop(t)
            else:
                keep.append(t)
        self._entries = keep

    def _emit_gauges_locked(self) -> None:
        _M_SIZE.set(len(self._entries))
        _M_CAPACITY.set(self.capacity)
        _M_VERSION.set(self._version)
        versions = [t.version_start for t in self._entries]
        _M_MIN_VERSION.set(min(versions) if versions else self._version)
        _M_MAX_VERSION.set(max(versions) if versions else self._version)
        if not tracer.enabled():
            return
        tracer.counter(
            "replay_buffer", size=len(self._entries), capacity=self.capacity,
            accepted=self.accepted, rejected=self.rejected, evicted=self.evicted,
            dropped_stale=self.dropped_stale,
        )
        hist: Dict[int, int] = {}
        for t in self._entries:
            off = t.staleness(self._version)
            hist[off] = hist.get(off, 0) + 1
        if hist:
            tracer.counter("replay_staleness",
                           **{f"off{k}": v for k, v in sorted(hist.items())})
