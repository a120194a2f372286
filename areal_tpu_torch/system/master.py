"""Master worker (port of the synchronous half of areal_tpu/system/master.py):
drives the DFG one train step at a time, keeps the epoch/step account,
the save and recover-checkpoint cadence, the difficulty filter and the
quarantine escalation.

Each step is one asyncio gather of a data loader and one coroutine per
MFC: an MFC's coroutine waits in the `SequenceBuffer` until its input
keys are ready for `n_seqs` data ids, runs its pre-hooks, dispatches the
call to the worker that hosts its model, amends the buffer with the
outputs' metadata and runs its post-hooks (the generator's weight sync
and the reference model's EMA after the actor's train step, a model's
host offload).  The pool runs each request in a thread of its own, so
MFCs whose inputs are ready together (the reward and the reference
model's forward) run at once.  The requests between steps (the
difficulty filter, the cache clear, saves and recover checkpoints) run
after the step's gather has finished, so none races an MFC.

Recover checkpoints (`ckpt_freq_steps`, `ckpt_freq_secs`) stage each
train model's weights and optimizer state, write a manifest, flip the
staged dir into place and then write `RecoverInfo` (`base/recover.py`).
A master built on the same fileroot, experiment and trial finds it
(`load_recover_info`) and, before its first step, restores the workers:
weights and optimizer state, the train nodes' post-hooks replayed, the
weight versions rewound, the filter re-applied, the data cursors
rewound, the interfaces' state restored.  A streak of quarantined steps
rolls back to the last valid recover checkpoint, within the
`max_recoveries` budget.  ``AREAL_FAULTS`` kills the master (exit 42)
at ``recover_stage`` (after every stage, before any flip) or
``recover_flip`` (after the flips, before the recover info).

`pipeline_overlap` streams a step through the graph in chunks of
`pipeline_chunk_seqs` prompts, `overlap_window` chunks in flight
(`_execute_step_streamed`): while chunk i trains, chunk i+1 may still
generate.  Window 1 runs the unchanged per-node path in topological
order, bit for bit the barrier step.  Each step's `pipeline` stats
(and the `areal_master_pipeline_*` gauges) give each stage's fill and
bubble.  Unlike the JAX master it releases no aliased generator before
a stream (the port's generator never aliases the trainer's weights).

Tracing (`base/tracer.py`, ``AREAL_TRACE=1``): the master resolves the
trial's shard directory (exported, so workers inherit it) and traces as
role ``master``: a ``step`` span a step, ``load_data``, the
``mfc:<node>`` dispatch waits, ``xfer:data``, ``offload:*``,
``param_sync:*`` and ``param_realloc:*``, the streamed step's
``pipe:<stage>`` spans, and flight dumps at a worker's death and a
quarantine rollback.

Metrics (`base/metrics.py`, the JAX master's series): each step bumps
``areal_master_steps_total`` and observes ``areal_master_step_seconds``,
mirrors the merged per-MFC ``perf/*`` stats into the gauges
``areal_mfc_wall_seconds``, ``areal_mfc_mfu_ratio`` and
``areal_mfc_tflops`` (labelled by MFC, ``all`` for an unprefixed key)
and sets ``areal_master_advisor_pred_err_ratio``, the relative error of
the per-MFC walls composed through the DFG's levels
(`analysis/costmodel.compose_step`) against the measured step.  A
committed recover checkpoint bumps ``areal_ckpt_flips_total`` once a
flipped dir and stamps ``areal_ckpt_last_success_timestamp_seconds``;
the quarantine plane keeps ``areal_master_quarantined_steps_total``,
``areal_master_consecutive_quarantines`` and
``areal_master_quarantine_rollbacks_total``.  `apps/main.py` serves the
registry as the trial's ``master`` role.

Asynchronous RL has two step modes (`execute_step` picks one):
- `rollout_ahead=1` (`_execute_step_async`): the source GENERATE nodes
  of step t+1 run while the rest of step t's graph trains.  The weight
  sync to the generator (the train node's post-hook) first waits for
  that prefetch (`_run_hook`), so every batch is generated under one
  weight version, exactly one step stale.
- `max_head_offpolicyness` (`_execute_step_async_rl`): K = cap + 1
  rollout batches stay launched ahead of consumption, each stamped with
  the trainer version at its generation start, and the trainer takes
  them through a staleness-bounded `ReplayBuffer`.  The weight sync
  does not wait: a batch mid-generation keeps its head stamp and
  finishes under the new weights; decoupled PPO corrects the gap.  Cap 0
  is the synchronous ordering, bit for bit.
The pool runs each request in a thread of its own, so a prefetch's
generate and the step's train step run at once (on the card, on the
one default stream).  Each step reports `replay/*` stats, and recover
checkpoints carry the replay watermarks and the pipeline's state.

Workers and placement.  Each model lives on exactly one worker
(`model_placement`); the datasets live on the data workers.  The pool
is the transport: `InProcessPool` (every worker in this process, each
request in a thread of its own) or `system/stream.ConnWorkerPool` (each
worker a process of its own, over `multiprocessing.connection`).  Across
workers the master plans the moves itself: an ownership map says which
workers hold each (data id, key) (`_record_owner`, at each fetch and at
each MFC's outputs); before an MFC, `_ensure_data` moves what its worker
lacks as one tagged data_send/data_recv pair a source; a weight sync
whose target lives on another worker becomes a checksummed
param_send/param_recv pair (an EMA target gets its `eta`); the
difficulty filter reads each id's rewards where they live.  Each step
reports the transfers as `transfer/*` stats (`_acc_xfer`).

Worker death.  A request past the pool's deadline (`mfc_timeout_s`)
whose worker has stopped beating raises `WorkerDeadError`; the run loop
absorbs it (`_recover_from_worker_death`): a fault report, the step
aborted, the `worker_relauncher` (if any) called with the dead, a wait
until every worker is back, and a rollback of every worker to the last
recover checkpoint, within the `max_recoveries` budget that quarantine
rollbacks share.  A model over several workers (`model_groups`,
replicas) and every layout other than d1 come with ROADMAP queue 1,
item 8.
"""

import asyncio
import collections
import contextvars
import dataclasses
import inspect
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.api.config import ModelInterfaceType
from areal_tpu_torch.api.dfg import DFG, MFCDef, OffloadHook, ParamReallocHook
from areal_tpu_torch.base import faults, integrity, metrics, recover, timeutil, tracer
from areal_tpu_torch.base.monitor import StatsLogger
from areal_tpu_torch.base.stats import merge_stats
from areal_tpu_torch.system.buffer import SequenceBuffer
from areal_tpu_torch.system.replay import ReplayBuffer, Trajectory

logger = logging.getLogger("areal_tpu_torch.master")

# True inside a rollout prefetch (and the tasks it gathers): a hook that
# runs there must not wait for the prefetch itself.
_IN_PREFETCH: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "areal_torch_in_prefetch", default=False
)

OPTIMIZER_FILE = "optimizer_state.safetensors"


class WorkerDeadError(RuntimeError):
    """A worker missed its MFC deadline and (over the process transport)
    its heartbeat: its in-flight requests fail with this, so the master
    aborts the step and recovers instead of hanging."""

    def __init__(self, worker_id: int, reason: str):
        super().__init__(f"worker {worker_id} dead: {reason}")
        self.worker_id = worker_id
        self.reason = reason


class PoolClosedError(RuntimeError):
    """The pool was closed with requests in flight: their awaiters get
    this instead of hanging on futures no one will resolve."""


def pool_metrics():
    """The worker-liveness counters every WorkerPool shares (the
    registry is get-or-create, so each call returns the same three)."""
    reg = metrics.default_registry()
    return (
        reg.counter("areal_master_worker_dead_total",
                    "workers declared dead (deadline expired, heartbeat stale)"),
        reg.counter("areal_master_mfc_timeout_total",
                    "MFC requests whose deadline expired (slow or dead)"),
        reg.counter("areal_master_orphan_replies_total",
                    "late or unmatched worker replies dropped by the master", ("reason",)),
    )


_TIMEOUT_UNSET = object()


class WorkerPool:
    """Transport abstraction: request(worker_id, payload) -> response."""

    # The per-request deadline's default; None waits for ever.
    mfc_timeout_s: Optional[float] = None

    async def request(self, worker_id: int, payload: Dict[str, Any],
                      timeout: Any = _TIMEOUT_UNSET) -> Dict:
        raise NotImplementedError

    @property
    def n_workers(self) -> int:
        raise NotImplementedError

    @property
    def dead_workers(self) -> set:
        return set()

    async def wait_workers(self, timeout: float = 300.0):
        """Block until every worker is reachable (a no-op in-process)."""


class InProcessPool(WorkerPool):
    """Every worker lives in this process; each request runs in a thread
    of its own.  With a deadline, a request that outlives it declares its
    worker dead (a handler thread cannot beat for itself, so there is no
    heartbeat lane here) until `revive`."""

    def __init__(self, workers, mfc_timeout_s: Optional[float] = None):
        self.workers = list(workers)
        self.mfc_timeout_s = mfc_timeout_s
        self._dead: set = set()
        self._m_worker_dead, self._m_mfc_timeout, _ = pool_metrics()

    async def request(self, worker_id: int, payload: Dict[str, Any],
                      timeout: Any = _TIMEOUT_UNSET) -> Dict:
        if timeout is _TIMEOUT_UNSET:
            timeout = self.mfc_timeout_s
        if worker_id in self._dead:
            raise WorkerDeadError(worker_id, "worker previously declared dead")
        coro = asyncio.to_thread(self.workers[worker_id].handle_request, payload)
        if timeout is None:
            return await coro
        # The expired thread runs on: whoever injected a hang releases it.
        try:
            return await asyncio.wait_for(coro, timeout)
        except asyncio.TimeoutError:
            self._m_mfc_timeout.inc()
            self._m_worker_dead.inc()
            self._dead.add(worker_id)
            raise WorkerDeadError(
                worker_id, f"no reply to {payload.get('type')} within {timeout}s"
            ) from None

    def revive(self, worker_id: int):
        """Clear a death verdict (the in-process stand-in for a relaunch)."""
        self._dead.discard(worker_id)

    @property
    def dead_workers(self) -> set:
        return set(self._dead)

    @property
    def n_workers(self) -> int:
        return len(self.workers)


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    total_train_epochs: int = 1
    save_freq_steps: Optional[int] = None
    # Recover checkpoints, every N steps and/or every N seconds.
    ckpt_freq_steps: Optional[int] = None
    ckpt_freq_secs: Optional[float] = None
    benchmark_steps: Optional[int] = None  # stop early after N steps


class MasterWorker:
    def __init__(
        self,
        dfg: DFG,
        pool: WorkerPool,
        model_placement: Dict[str, int],  # model key -> worker id
        data_worker_ids: List[int],
        ctrl: ExperimentSaveEvalControl,
        fileroot: str = "/tmp/areal_tpu_torch/trial",
        experiment_name: str = "exp",
        trial_name: str = "trial",
        # Dynamic difficulty filtering: after each step, prompts whose
        # group accuracy falls outside [min_accuracy, max_accuracy] are
        # removed from the datasets.
        difficulty_filter: Optional[Dict[str, float]] = None,
        # Rollbacks to the recover checkpoint the run loop absorbs (worker
        # deaths and quarantine streaks together) before it gives up.
        max_recoveries: int = 3,
        # Called with the sorted dead worker ids before the master waits
        # for the fleet again after a worker death (sync or async); a
        # launcher uses it to respawn the processes.  Without one the
        # master still waits: a worker relaunched from outside rejoins.
        worker_relauncher: Optional[Any] = None,
        # Consecutive quarantined steps that escalate to a rollback onto
        # the last valid recover checkpoint (0: only count them).
        max_consecutive_quarantines: int = 3,
        # Checksummed cross-worker weight pushes: the receiver verifies
        # the sender's checksum before it swaps.
        weight_push_checksum: bool = True,
        # The pipeline-overlapped step: chunks of pipeline_chunk_seqs
        # prompts, overlap_window of them in flight (1: the barrier path
        # in topological order, bit for bit).
        pipeline_overlap: bool = False,
        overlap_window: int = 2,
        pipeline_chunk_seqs: int = 1,
        # Asynchronous rollout: 1 = generate step t+1's rollouts while
        # step t trains (one-step-stale behaviour policy, one weight
        # version a batch).
        rollout_ahead: int = 0,
        # Asynchronous RL: cap + 1 rollout batches outstanding, consumed
        # through a staleness-bounded ReplayBuffer (None: off; 0: the
        # synchronous ordering).  Exclusive with rollout_ahead.
        max_head_offpolicyness: Optional[int] = None,
        # The replay buffer's capacity in batches (at least cap + 1).
        replay_capacity: int = 4,
    ):
        outside = sorted({
            w for w in [*model_placement.values(), *data_worker_ids]
            if not (isinstance(w, int) and 0 <= w < pool.n_workers)
        }, key=str)
        if outside:
            raise ValueError(
                f"placement names workers {outside} outside the pool's {pool.n_workers} "
                "(each model lives on exactly one worker; a model over several workers "
                "comes with ROADMAP queue 1, item 8)"
            )
        self.dfg = dfg
        self.pool = pool
        self.placement = model_placement
        self.data_worker_ids = list(data_worker_ids)
        self.ctrl = ctrl
        self.fileroot = fileroot
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.difficulty_filter = difficulty_filter
        self._filtered_ids: List[str] = []
        # Ids of the latest fetch: the quarantine ledger's attribution.
        self._last_data_ids: List[str] = []
        # The master's chaos points (AREAL_FAULTS): recover_stage and
        # recover_flip kill it between a checkpoint's stage and its flip,
        # and between the flip and the recover info.
        self._faults = faults.FaultInjector.from_env()
        self.buffer = SequenceBuffer(consumers={n.name: n.input_keys for n in dfg.nodes})
        self.step_info = recover.StepInfo()
        self.save_ctl = timeutil.FrequencyControl(frequency_steps=ctrl.save_freq_steps)
        self.ckpt_ctl = timeutil.FrequencyControl(
            frequency_steps=ctrl.ckpt_freq_steps, frequency_seconds=ctrl.ckpt_freq_secs,
        )
        self.stats_history: List[Dict[str, float]] = []
        self.stats_logger = StatsLogger(fileroot, experiment_name, trial_name)
        # Resolve (and export) the trial's shard dir before claiming this
        # process's identity: in-process workers share the master's shard,
        # spawned ones inherit the dir.
        tracer.default_dir(fileroot, experiment_name, trial_name)
        tracer.configure(role="master")
        self.max_recoveries = int(max_recoveries)
        self.worker_relauncher = worker_relauncher
        self._recoveries = 0
        self.max_consecutive_quarantines = int(max_consecutive_quarantines)
        self.weight_push_checksum = bool(weight_push_checksum)
        self._consecutive_quarantines = 0
        self._quarantine_ledger: List[Dict[str, Any]] = []
        self._steps_per_epoch: Optional[int] = None
        self._restore_pending: Optional[recover.RecoverInfo] = None
        self.restore_seconds: Optional[float] = None  # the last restore's wall
        self._train_rpcs = [
            n for n in dfg.nodes if n.interface_type == ModelInterfaceType.TRAIN_STEP
        ]
        self.pipeline_overlap = bool(pipeline_overlap)
        self.overlap_window = int(overlap_window)
        self.pipeline_chunk_seqs = int(pipeline_chunk_seqs)
        if self.pipeline_overlap and self.overlap_window < 1:
            raise ValueError(f"overlap_window must be >= 1, got {overlap_window}")
        if self.pipeline_overlap and self.pipeline_chunk_seqs < 1:
            raise ValueError(f"pipeline_chunk_seqs must be >= 1, got {pipeline_chunk_seqs}")
        if rollout_ahead not in (0, 1):
            raise ValueError(
                "rollout_ahead supports 0 (synchronous) or 1 (one-step overlap); deeper "
                "pipelines need the staleness-bounded async-RL mode (max_head_offpolicyness)"
            )
        self.rollout_ahead = rollout_ahead
        self._async_rl = max_head_offpolicyness is not None
        self.max_head_offpolicyness = int(max_head_offpolicyness) if self._async_rl else 0
        if self._async_rl:
            if rollout_ahead:
                raise ValueError(
                    "rollout_ahead and max_head_offpolicyness are mutually exclusive "
                    "(async RL subsumes the one-step overlap)"
                )
            if self.max_head_offpolicyness < 0:
                raise ValueError(
                    f"max_head_offpolicyness must be >= 0, got {self.max_head_offpolicyness}"
                )
        if self.pipeline_overlap and (rollout_ahead or self._async_rl):
            raise ValueError(
                "pipeline_overlap is mutually exclusive with rollout_ahead / "
                "max_head_offpolicyness: those overlap generation ACROSS steps, pipeline "
                "overlap streams WITHIN one on-policy step"
            )
        self._async_K = self.max_head_offpolicyness + 1
        self._replay_dropped: List[Trajectory] = []
        self.replay: Optional[ReplayBuffer] = (
            ReplayBuffer(
                capacity=max(int(replay_capacity), self._async_K),
                max_head_offpolicyness=self.max_head_offpolicyness,
                on_drop=self._replay_dropped.append,
            ) if self._async_rl else None
        )
        # Completed train steps: the version rollout batches are stamped
        # against.
        self._trainer_version = 0
        self._ahead_queue: "collections.deque[asyncio.Task]" = collections.deque()
        self._ahead_task: Optional[asyncio.Task] = None
        self._batches_launched = 0
        self._batch_seq = 0
        self._total_steps: Optional[int] = None
        # Serialize dataset fetches and the generator across outstanding
        # prefetches (created lazily: asyncio primitives want a loop).
        self._fetch_lock: Optional[asyncio.Lock] = None
        self._gen_lock: Optional[asyncio.Lock] = None
        # The GENERATE nodes fed by the dataset alone: the streamed step
        # needs one to chunk.
        self._source_nodes = [
            n for n in dfg.nodes
            if n.interface_type == ModelInterfaceType.GENERATE
            and all(dfg.data_producers.get(k) is None for k in n.input_keys)
        ]
        # The cross-worker data plane's book: which workers hold which
        # (data id, key); a copy in flight is a future under (id, key, dst).
        self._owners: Dict[str, Dict[str, set]] = {}
        self._inflight: Dict[tuple, asyncio.Future] = {}
        self._xfer_id = 0
        # This step's transfers (bytes and seconds by kind), reported as
        # the step's transfer/* stats.
        self._xfer_acc: Dict[str, float] = {}
        reg = metrics.default_registry()
        self._m_steps = reg.counter("areal_master_steps_total", "train steps completed")
        self._m_step_seconds = reg.histogram(
            "areal_master_step_seconds",
            "wall time per train step",
            buckets=(0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 300),
        )
        self._m_mfc_seconds = reg.gauge(
            "areal_mfc_wall_seconds", "last step's wall seconds, per MFC", ("mfc",),
        )
        self._m_mfc_mfu = reg.gauge(
            "areal_mfc_mfu_ratio", "last step's model FLOP utilization, per MFC", ("mfc",),
        )
        self._m_mfc_tflops = reg.gauge(
            "areal_mfc_tflops", "last step's achieved TFLOP/s, per MFC", ("mfc",),
        )
        # |composed per-MFC walls - measured step| / measured step: a
        # drifting residual means the DFG composition no longer tracks the
        # measured step (metrics_report's `advisor_pred_err`).
        self._m_advisor_err = reg.gauge(
            "areal_master_advisor_pred_err_ratio",
            "relative error of DFG-composed per-MFC walls vs measured step seconds, last step",
        )
        self._m_ckpt_flips = reg.counter(
            "areal_ckpt_flips_total",
            "recover checkpoints atomically committed (staged dir flipped)",
        )
        self._m_ckpt_last_success = reg.gauge(
            "areal_ckpt_last_success_timestamp_seconds",
            "unix time of the last committed recover checkpoint",
        )
        self._m_quarantined = reg.counter(
            "areal_master_quarantined_steps_total",
            "train steps quarantined by the anomaly sentinels",
        )
        self._m_consec_quar = reg.gauge(
            "areal_master_consecutive_quarantines",
            "current run of consecutive quarantined steps",
        )
        self._m_quar_rollbacks = reg.counter(
            "areal_master_quarantine_rollbacks_total",
            "checkpoint rollbacks triggered by quarantine streaks",
        )
        self._m_recoveries = reg.counter(
            "areal_master_recoveries_total",
            "worker-death recoveries absorbed by the master run loop",
        )
        self._m_pipe_fill = reg.gauge(
            "areal_master_pipeline_fill_ratio",
            "last streamed step: stage busy seconds / step window", ("stage",),
        )
        self._m_pipe_bubble = reg.gauge(
            "areal_master_pipeline_bubble_seconds",
            "last streamed step: stage idle seconds inside its active span", ("stage",),
        )
        self._m_pipe_chunks = reg.counter(
            "areal_master_pipeline_chunks_total",
            "rollout chunks streamed through the pipelined step path",
        )

    # ---------------- lifecycle ----------------

    async def discover_spec(self) -> Dict[str, int]:
        sizes = await asyncio.gather(
            *[self.pool.request(w, {"type": "spec"}) for w in self.data_worker_ids]
        )
        self._steps_per_epoch = max(max(s["steps_per_epoch"] for s in sizes), 1)
        return {
            "dataset_size": sum(s["dataset_size"] for s in sizes),
            "steps_per_epoch": self._steps_per_epoch,
        }

    async def run(self) -> List[Dict[str, float]]:
        """Train until total_train_epochs (or benchmark_steps) complete."""
        await self.discover_spec()
        total_steps = self.ctrl.total_train_epochs * self._steps_per_epoch
        if self.ctrl.benchmark_steps is not None:
            total_steps = min(total_steps, self.ctrl.benchmark_steps)
        self._total_steps = total_steps
        logger.info(f"master: {total_steps} steps ({self.ctrl.total_train_epochs} epochs x "
                    f"{self._steps_per_epoch})")
        if self._restore_pending:
            await self._restore_worker_state()
        try:
            while self.step_info.global_step < total_steps:
                t0 = time.monotonic()
                try:
                    # The window trace_report buckets every process's
                    # track against.
                    with tracer.span("step", step=self.step_info.global_step + 1):
                        stats = await self.execute_step()
                except WorkerDeadError as e:
                    await self._recover_from_worker_death(e)
                    continue
                dt = time.monotonic() - t0
                stats["time/step_s"] = dt
                self._export_step_metrics(stats, dt)
                quarantined = self._note_quarantine(stats)
                self.stats_history.append(stats)
                step = self.step_info.global_step + 1
                logger.info(f"step {step}/{total_steps} ({dt:.2f}s): "
                            f"{ {k: round(v, 4) for k, v in stats.items()} }")
                self.stats_logger.log(step, stats)
                self.step_info = self.step_info.next(self._steps_per_epoch)
                if not quarantined:
                    await self._post_step()
                elif (self.max_consecutive_quarantines > 0
                      and self._consecutive_quarantines >= self.max_consecutive_quarantines):
                    # A quarantined step never saves (the rollback target
                    # must predate the anomaly); a streak at the threshold
                    # rolls back.
                    await self._quarantine_rollback()
                tracer.flush()
        finally:
            self.stats_logger.close()
            tracer.flush()
        return self.stats_history

    def _export_step_metrics(self, stats: Dict[str, float], step_seconds: float) -> None:
        """Mirror the merged per-MFC perf keys (the worker's `_mfc_perf`)
        into the labelled gauges: the per-MFC wall and MFU view the fleet
        watchdog trends."""
        self._m_steps.inc()
        self._m_step_seconds.observe(step_seconds)
        suffixes = (
            ("perf/time_s", self._m_mfc_seconds),
            ("perf/mfu", self._m_mfc_mfu),
            ("perf/tflops", self._m_mfc_tflops),
        )
        for k, v in stats.items():
            for suffix, gauge in suffixes:
                if k == suffix:
                    gauge.labels("all").set(float(v))
                elif k.endswith("/" + suffix):
                    gauge.labels(k[: -(len(suffix) + 1)]).set(float(v))
        self._export_advisor_residual(stats, step_seconds)

    def _export_advisor_residual(self, stats: Dict[str, float], step_seconds: float) -> None:
        """Compose this step's measured per-MFC walls through the DFG's
        levels and publish the relative error against the measured step."""
        from areal_tpu_torch.analysis import costmodel

        walls: Dict[str, float] = {}
        for node in self.dfg.nodes:
            v = stats.get(f"{node.name}/perf/time_s")
            if v is None and len(self.dfg.nodes) == 1:
                v = stats.get("perf/time_s")
            if v is not None:
                walls[node.name] = float(v)
        if not walls or step_seconds <= 0:
            return
        levels = [[n.name for n in lvl] for lvl in self.dfg.topological_order()]
        pred = costmodel.compose_step(levels, walls)
        self._m_advisor_err.set(abs(pred - step_seconds) / step_seconds)

    async def _post_step(self):
        if self.save_ctl.check():
            await self.save(kind="persistent")
        if self.ckpt_ctl.check():
            await self.save(kind="recover")

    # ---------------- worker-death recovery ----------------

    async def _recover_from_worker_death(self, err: WorkerDeadError) -> None:
        """Absorb a worker's death: report it, abort the half-done step,
        have the relauncher (if any) respawn the dead, wait until every
        worker is back and roll every worker back to the last recover
        checkpoint.  Raises (so run() fails) past the recovery budget or
        without a checkpoint to roll back to."""
        self._recoveries += 1
        self._m_recoveries.inc()
        report = {
            "event": "worker_dead",
            "worker_id": err.worker_id,
            "reason": err.reason,
            "step": self.step_info.global_step,
            "dead_workers": sorted(self.pool.dead_workers),
            "recovery": self._recoveries,
            "max_recoveries": self.max_recoveries,
        }
        logger.error(f"FAULT_REPORT {json.dumps(report, sort_keys=True)}")
        # The flight ring keeps the last events around the death.
        tracer.flight_event("worker_dead", worker_id=err.worker_id, reason=err.reason,
                            step=self.step_info.global_step)
        tracer.flight_dump("worker_dead", role="master", rank=0)
        if self._recoveries > self.max_recoveries:
            raise RuntimeError(
                f"recovery budget exhausted ({self.max_recoveries}): "
                f"worker {err.worker_id} dead: {err.reason}"
            )
        await self._abort_step()
        if self.worker_relauncher is not None:
            ret = self.worker_relauncher(sorted(self.pool.dead_workers))
            if inspect.isawaitable(ret):
                await ret
        await self.pool.wait_workers()
        if not self.load_recover_info():
            raise RuntimeError(
                f"worker {err.worker_id} died before the first recover checkpoint "
                "existed; nothing to roll back to"
            )
        await self._restore_worker_state()
        logger.info(f"recovered from worker {err.worker_id}'s death; resuming at step "
                    f"{self.step_info.global_step}")

    # ---------------- step quarantine and escalation ----------------

    def _note_quarantine(self, stats: Dict[str, float]) -> bool:
        """Fold the step's verdict into the streak.  A positive
        `quarantined` stat of any MFC means the train engine discarded
        the update: extend the streak and add the step, its verdict and
        its data ids to the ledger.  A clean step ends the streak."""
        quarantined = any(
            k.rsplit("/", 1)[-1] == "quarantined" and v > 0 for k, v in stats.items()
        )
        if not quarantined:
            if self._consecutive_quarantines:
                self._consecutive_quarantines = 0
                self._m_consec_quar.set(0.0)
            return False
        verdict = 0
        for k, v in stats.items():
            if k.rsplit("/", 1)[-1] == "anomaly_verdict":
                verdict |= int(v)
        self._consecutive_quarantines += 1
        self._m_quarantined.inc()
        self._m_consec_quar.set(float(self._consecutive_quarantines))
        entry = integrity.quarantine_entry(
            self.step_info.global_step, verdict, self._last_data_ids
        )
        self._quarantine_ledger.append(entry.as_dict())
        logger.warning("QUARANTINE " + json.dumps({
            "event": "step_quarantined", "step": self.step_info.global_step,
            "verdict": verdict, "kinds": list(entry.kinds),
            "consecutive": self._consecutive_quarantines,
            "threshold": self.max_consecutive_quarantines,
        }, sort_keys=True))
        tracer.flight_event("quarantine", step=self.step_info.global_step, verdict=verdict,
                            consecutive=self._consecutive_quarantines)
        return True

    async def _quarantine_rollback(self) -> None:
        """Roll every model back to the last valid recover checkpoint (a
        quarantined step never checkpoints, so it predates the streak),
        within the `max_recoveries` budget."""
        self._recoveries += 1
        self._m_recoveries.inc()
        self._m_quar_rollbacks.inc()
        report = {
            "event": "quarantine_rollback",
            "step": self.step_info.global_step,
            "consecutive_quarantines": self._consecutive_quarantines,
            "ledger_tail": self._quarantine_ledger[-self._consecutive_quarantines:],
            "recovery": self._recoveries,
            "max_recoveries": self.max_recoveries,
        }
        logger.error(f"FAULT_REPORT {json.dumps(report, sort_keys=True)}")
        tracer.flight_event("quarantine_escalation", step=self.step_info.global_step,
                            consecutive=self._consecutive_quarantines)
        tracer.flight_dump("quarantine_rollback", role="master", rank=0)
        if self._recoveries > self.max_recoveries:
            raise RuntimeError(
                f"recovery budget exhausted ({self.max_recoveries}): "
                f"{self._consecutive_quarantines} consecutive quarantined steps"
            )
        await self._abort_step()
        if not self.load_recover_info():
            raise RuntimeError(
                "quarantine streak hit before the first recover checkpoint "
                "existed; nothing to roll back to"
            )
        await self._restore_worker_state()
        # The rollback resolves the streak (the replayed steps get a fresh
        # verdict); load_recover_info restored the saved state's count.
        self._consecutive_quarantines = 0
        self._m_consec_quar.set(0.0)
        logger.info(f"quarantine rollback complete; resuming at step "
                    f"{self.step_info.global_step}")

    async def _abort_step(self) -> None:
        """Cancel the rollout prefetches, drop the open train streams of
        the living workers and forget the step's data and transfers
        before a rollback, so the replayed step starts clean.  (A
        cancelled prefetch's thread runs to its end.)"""
        tasks = list(self._ahead_queue)
        self._ahead_queue.clear()
        if self._ahead_task is not None:
            tasks.append(self._ahead_task)
            self._ahead_task = None
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        alive = [w for w in range(self.pool.n_workers) if w not in self.pool.dead_workers]
        await asyncio.gather(*[
            self.pool.request(w, {"type": "train_stream_abort"}) for w in alive
        ], return_exceptions=True)
        self.buffer.clear()
        for fut in self._inflight.values():
            if not fut.done():
                fut.cancel()
        self._inflight.clear()
        self._owners.clear()
        self._xfer_acc.clear()

    # ---------------- one step ----------------

    async def execute_step(self) -> Dict[str, float]:
        results: Dict[str, Dict[str, float]] = {}
        # clear(), never rebind: a prefetch's transfers of the next step
        # land in it while this step runs.
        self._xfer_acc.clear()
        if self._async_rl and self._source_nodes:
            await self._execute_step_async_rl(results)
        elif self.rollout_ahead > 0 and self._source_nodes:
            await self._execute_step_async(results)
        elif self.pipeline_overlap and self._source_nodes:
            await self._execute_step_streamed(results)
        else:
            await asyncio.gather(
                self._load_data(), *[self._run_mfc(node, results) for node in self.dfg.nodes]
            )
        if self._ahead_task is not None:
            # The cache clear keeps the buffer's ids: the prefetch must
            # have amended its outputs first.
            await self._ahead_task
        if self.difficulty_filter:
            await self._apply_difficulty_filter()
        await self._clear_worker_caches()
        merged: Dict[str, float] = {}
        for name, stats in results.items():
            for k, v in stats.items():
                merged[f"{name}/{k}" if len(results) > 1 else k] = v
        for k, v in self._xfer_acc.items():
            merged[f"transfer/{k}"] = v
        for k, v in self.buffer.stats().items():
            merged[f"buffer/{k}"] = float(v)
        return merged

    async def _load_data(self) -> List[str]:
        if self._fetch_lock is None:
            self._fetch_lock = asyncio.Lock()
        # The lock keeps outstanding prefetches from racing two fetches.
        async with self._fetch_lock:
            with tracer.span("load_data", cat="host"):
                resps = await asyncio.gather(
                    *[self.pool.request(w, {"type": "fetch"}) for w in self.data_worker_ids]
                )
                ids: List[str] = []
                for w, r in zip(self.data_worker_ids, resps):
                    self._record_owner(r["meta"], w)
                    await self.buffer.put_batch(r["meta"], step=self.step_info.global_step)
                    ids.extend(r["meta"].ids)
            self._last_data_ids = ids
        return ids

    # ---------------- asynchronous rollout ----------------

    async def _execute_step_async(self, results: Dict) -> None:
        """One step with one-step-ahead rollouts: take this step's
        rollouts from the prefetch started last step (the first step
        generates inline), register the next batch and launch its
        prefetch, and run the rest of this step's graph meanwhile.  The
        weight sync waits for the prefetch (`_run_hook`), so each batch
        sees one weight version.  A crash loses the prefetch's batch
        (its data cursor already advanced)."""
        if self._ahead_task is not None:
            results.update(await self._ahead_task)
            self._ahead_task = None
        else:
            await self._load_data()
            results.update(await self._prefetch_rollouts())
        nxt = self.step_info.global_step + 1
        if self._total_steps is None or nxt < self._total_steps:
            await self._load_data()
            self._ahead_task = asyncio.create_task(self._prefetch_rollouts())
        rest = [n for n in self.dfg.nodes if n not in self._source_nodes]
        await asyncio.gather(*[self._run_mfc(n, results) for n in rest])

    async def _prefetch_rollouts(self) -> Dict[str, Dict[str, float]]:
        # The mark is inherited by the gathered tasks; reset it, since the
        # first step runs this inline in the run loop's own context.
        token = _IN_PREFETCH.set(True)
        try:
            results: Dict[str, Dict[str, float]] = {}
            await asyncio.gather(*[self._run_mfc(n, results) for n in self._source_nodes])
            return results
        finally:
            _IN_PREFETCH.reset(token)

    def _topup_prefetch(self) -> None:
        """Keep at most K = cap + 1 rollout batches launched ahead of
        consumption (the trainer version counts consumed batches, one a
        step): the n-th batch launches no earlier than step n-K, stamps
        a head version >= n-K and is consumed at step n-1, so its
        staleness is at most the cap."""
        limit = self._trainer_version + self._async_K
        if self._total_steps is not None:
            limit = min(limit, self._total_steps)
        while self._batches_launched < limit:
            self._batches_launched += 1
            self._ahead_queue.append(asyncio.create_task(self._prefetch_rollout_batch()))

    async def _prefetch_rollout_batch(self):
        """One stamped rollout batch: fetch a dataset batch, then run the
        source GENERATE nodes once the generator is free.  The stamp is
        the trainer version at generation start; a sync landing mid-
        generation does not change it."""
        if self._gen_lock is None:
            self._gen_lock = asyncio.Lock()
        ids = await self._load_data()
        token = _IN_PREFETCH.set(True)
        try:
            results: Dict[str, Dict[str, float]] = {}
            async with self._gen_lock:
                v0 = self._trainer_version
                await asyncio.gather(*[self._run_mfc(n, results) for n in self._source_nodes])
            return results, v0, ids
        finally:
            _IN_PREFETCH.reset(token)

    async def _execute_step_async_rl(self, results: Dict) -> None:
        """One step of the replay-driven pipeline: admit finished batches
        until the buffer holds one, train on the oldest (FIFO), advance
        the trainer version (purging what aged past the cap) and report
        `replay/*`."""
        self._topup_prefetch()
        while len(self.replay) == 0:
            if not self._ahead_queue:
                raise RuntimeError(
                    "async_rl: replay buffer empty with no rollout batches in flight "
                    "(admission rejected everything?)"
                )
            gen_stats, v0, ids = await self._ahead_queue.popleft()
            self._topup_prefetch()
            self._batch_seq += 1
            traj = Trajectory(
                qid=f"rollout_batch{self._batch_seq}", prompt_ids=[], output_ids=[],
                output_logprobs=[], no_eos=[], version_start=v0,
                version_end=self._trainer_version, data={"stats": gen_stats, "ids": ids},
            )
            if not self.replay.put(traj):
                logger.warning(
                    f"async_rl: rejected {traj.qid} (head version {v0} vs trainer "
                    f"{self._trainer_version}, cap {self.max_head_offpolicyness})"
                )
                await self._drop_batch_ids(ids)
                # Free its launch slot: a replacement stamped with the
                # current version keeps the step budget whole.
                self._batches_launched -= 1
                self._topup_prefetch()
        traj = self.replay.get_batch(1, timeout=0)[0]
        await self._flush_replay_drops()
        staleness = traj.staleness(self._trainer_version)
        tracer.flight_event("train_chunk", qid=traj.qid, staleness=staleness,
                            version=self._trainer_version)
        results.update(traj.data["stats"])
        rest = [n for n in self.dfg.nodes if n not in self._source_nodes]
        await asyncio.gather(*[self._run_mfc(n, results) for n in rest])
        self._trainer_version += 1
        self.replay.set_version(self._trainer_version)
        await self._flush_replay_drops()
        wm = self.replay.watermarks()
        results["replay"] = {
            "staleness": float(staleness),
            "size": float(wm["size"]),
            "in_flight_batches": float(len(self._ahead_queue)),
            "accepted": float(wm["accepted"]),
            "rejected": float(wm["rejected"]),
            "dropped_stale": float(wm["dropped_stale"]),
            "evicted": float(wm["evicted"]),
        }

    async def _flush_replay_drops(self) -> None:
        """Drop from the ledger the batches the replay buffer discarded
        (capacity eviction or aged past the cap)."""
        if not self._replay_dropped:
            return
        dropped, self._replay_dropped = self._replay_dropped, []
        for traj in dropped:
            await self._drop_batch_ids(traj.data["ids"])

    async def _drop_batch_ids(self, ids: List[str]) -> None:
        await self.buffer.drop_ids(ids)
        for sid in ids:
            self._owners.pop(sid, None)

    # ---------------- the pipeline-overlapped step ----------------

    async def _execute_step_streamed(self, results: Dict) -> None:
        """One step as a chunked dataflow: the batch is split into chunks
        of `pipeline_chunk_seqs` prompts, and each chunk runs the graph
        in topological order as one task (generate, then the reward and
        the reference model, then a TRAIN node's gradient accumulation),
        `overlap_window` chunks in flight.  A lock per node keeps one
        engine's calls apart, so stages overlap across chunks, never
        within one.  TRAIN nodes open a stream at their first chunk,
        accumulate each chunk, and take their one optimizer step after
        the last; post-hooks (the weight sync) run once, after it.
        Window 1 runs the whole batch through the unchanged per-node
        `_run_mfc` path, node after node: the bit-exact gate."""
        t_step0 = time.monotonic()
        ids = await self._load_data()
        order = [n for lvl in self.dfg.topological_order() for n in lvl]
        spans: Dict[str, List[Tuple[float, float]]] = {n.name: [] for n in order}

        if self.overlap_window <= 1:
            for node in order:
                t0 = time.monotonic()
                with tracer.span(f"pipe:{node.name}", stage=node.name, chunk=0, n=len(ids)):
                    await self._run_mfc(node, results)
                spans[node.name].append((t0, time.monotonic()))
            self._m_pipe_chunks.inc()
            self._emit_pipeline_stats(results, spans, t_step0, 1)
            return

        k = self.pipeline_chunk_seqs
        chunks = [ids[i : i + k] for i in range(0, len(ids), k)]
        sem = asyncio.Semaphore(self.overlap_window)
        locks = {n.name: asyncio.Lock() for n in order}
        started: set = set()
        node_stats: Dict[str, List[Dict]] = {n.name: [] for n in order}

        async def run_chunk(ci: int, chunk_ids: List[str]) -> None:
            async with sem:
                for node in order:
                    key = str(node.model_name)
                    worker = self.placement[key]
                    is_train = node.interface_type == ModelInterfaceType.TRAIN_STEP
                    async with locks[node.name]:
                        if node.name not in started:
                            started.add(node.name)
                            for hook in node.pre_hooks:
                                await self._run_hook(hook, node)
                            if is_train:
                                await self.pool.request(worker, {
                                    "type": "mfc_stream_begin", "model_name": key,
                                    "mb_spec": node.mb_spec,
                                })
                        t0 = time.monotonic()
                        with tracer.span(f"pipe:{node.name}", stage=node.name, chunk=ci,
                                         n=len(chunk_ids)):
                            if is_train:
                                await self._ensure_data(node, chunk_ids, worker)
                                resp = await self.pool.request(worker, {
                                    "type": "mfc_stream_chunk", "model_name": key,
                                    "ids": chunk_ids, "input_keys": list(node.input_keys),
                                    "input_key_remap": dict(node.input_key_remap),
                                    "mb_spec": node.mb_spec,
                                })
                            else:
                                resp = await self._dispatch_mfc(node, chunk_ids)
                        node_stats[node.name].append(resp.get("stats") or {})
                        spans[node.name].append((t0, time.monotonic()))
            self._m_pipe_chunks.inc()

        await asyncio.gather(*[run_chunk(ci, c) for ci, c in enumerate(chunks)])

        # Close the streams (each TRAIN node's one optimizer step), then
        # the post-hooks in graph order: the weight sync fires once, after
        # the whole gradient sum, as on the barrier path.
        for node in order:
            key = str(node.model_name)
            if node.interface_type == ModelInterfaceType.TRAIN_STEP:
                t0 = time.monotonic()
                with tracer.span(f"pipe:{node.name}", stage=node.name, chunk=-1, apply=True):
                    resp = await self.pool.request(self.placement[key], {
                        "type": "mfc_stream_end", "model_name": key, "mb_spec": node.mb_spec,
                    })
                spans[node.name].append((t0, time.monotonic()))
                results[node.name] = resp.get("stats") or {}
            else:
                results[node.name] = merge_stats(node_stats[node.name])
            for hook in node.post_hooks:
                await self._run_hook(hook, node)
        # The chunks bypassed the buffer's waits: take each node's batch
        # now (every key is resident) only to mark it consumed, so the
        # step's entries are evicted.
        for node in order:
            await self.buffer.get_batch_for_rpc(node, timeout=60)
        self._emit_pipeline_stats(results, spans, t_step0, len(chunks))

    def _emit_pipeline_stats(self, results: Dict, spans: Dict[str, List[Tuple[float, float]]],
                             t0: float, n_chunks: int) -> None:
        """Each stage's fill (the union of its chunk intervals over the
        step's window) and bubble (its idle seconds between its first and
        last chunk), as `results["pipeline"]` and the gauges."""
        window = max(time.monotonic() - t0, 1e-9)
        pipe: Dict[str, float] = {
            "n_chunks": float(n_chunks),
            "window": float(self.overlap_window),
            "step_window_s": window,
        }
        for name, ivals in spans.items():
            if not ivals:
                continue
            ivals = sorted(ivals)
            busy = 0.0
            cur_a, cur_b = ivals[0]
            for a, b in ivals[1:]:
                if a > cur_b:
                    busy += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            busy += cur_b - cur_a
            fill = busy / window
            bubble = max(ivals[-1][1] - ivals[0][0] - busy, 0.0)
            pipe[f"fill_{name}"] = fill
            pipe[f"bubble_s_{name}"] = bubble
            self._m_pipe_fill.labels(name).set(fill)
            self._m_pipe_bubble.labels(name).set(bubble)
        results["pipeline"] = pipe

    async def _run_mfc(self, node: MFCDef, results: Dict):
        batch = await self.buffer.get_batch_for_rpc(node, timeout=600)
        for hook in node.pre_hooks:
            await self._run_hook(hook, node)
        resp = await self._dispatch_mfc(node, list(batch.ids))
        results[node.name] = resp.get("stats") or {}
        for hook in node.post_hooks:
            await self._run_hook(hook, node)

    async def _dispatch_mfc(self, node: MFCDef, ids: List[str]) -> Dict:
        worker = self.placement[str(node.model_name)]
        await self._ensure_data(node, ids, worker)
        payload = {
            "type": "mfc",
            "model_name": str(node.model_name),
            "interface_type": node.interface_type.value,
            "ids": ids,
            "input_keys": list(node.input_keys),
            "input_key_remap": dict(node.input_key_remap),
            "output_key_remap": dict(node.output_key_remap),
            "mb_spec": node.mb_spec,
        }
        # Uncategorized: the master waits here on the worker's compute,
        # which the worker's own track attributes.
        with tracer.span(f"mfc:{node.name}", model=str(node.model_name), n=len(ids)):
            resp = await self.pool.request(worker, payload)
        meta = resp.get("meta")
        if meta is not None:
            self._record_owner(meta, worker, replace=True)
            await self.buffer.amend_batch(meta)
        return resp

    # ---------------- the cross-worker data plane ----------------

    def _record_owner(self, meta, worker: int, replace: bool = False):
        for sid in meta.ids:
            km = self._owners.setdefault(sid, {})
            for key in meta.keys:
                if replace:
                    km[key] = {worker}
                else:
                    km.setdefault(key, set()).add(worker)

    async def _ensure_data(self, node: MFCDef, ids, dst: int):
        """Move each input (id, key) not yet on `dst` there from a worker
        that holds it: one tagged data_send/data_recv pair a source and
        key set.  A copy another MFC already has in flight to `dst` is
        awaited, not sent twice."""
        plans: Dict[int, Dict[str, list]] = {}  # src -> key -> [ids]
        waits = set()
        started: list = []
        # Planning makes no awaits, so its marks are atomic among the
        # coroutines.
        for sid in ids:
            km = self._owners.get(sid, {})
            for key in node.input_keys:
                holders = km.get(key)
                if holders is None:
                    raise KeyError(f"MFC {node.name}: no worker holds {key!r} for data id {sid!r}")
                if dst in holders:
                    fut = self._inflight.get((sid, key, dst))
                    if fut is not None:
                        waits.add(fut)
                    continue
                src = min(w for w in holders if (sid, key, w) not in self._inflight)
                plans.setdefault(src, {}).setdefault(key, []).append(sid)
                km[key].add(dst)
                self._inflight[(sid, key, dst)] = asyncio.get_running_loop().create_future()
                started.append((sid, key, dst))
        err: Optional[BaseException] = None
        try:
            for src, key_ids in plans.items():
                by_id: Dict[str, set] = {}
                for key, sids in key_ids.items():
                    for sid in sids:
                        by_id.setdefault(sid, set()).add(key)
                groups: Dict[frozenset, list] = {}
                for sid, keys in by_id.items():
                    groups.setdefault(frozenset(keys), []).append(sid)
                for keys, sids in groups.items():
                    xfer_id = self._xfer_id
                    self._xfer_id += 1
                    # The consuming MFC's label, as the worker stamps its
                    # compute span: the profile joins bytes to their MFC.
                    with tracer.span(
                        "xfer:data", cat="comms", src=src, dst=dst, n=len(sids),
                        mfc=f"{node.model_name}:{node.interface_type.value}",
                    ) as targs:
                        send_r, recv_r = await asyncio.gather(
                            self.pool.request(src, {"type": "data_send", "ids": sids,
                                                    "keys": sorted(keys), "dst": dst,
                                                    "xfer_id": xfer_id}),
                            self.pool.request(dst, {"type": "data_recv", "xfer_id": xfer_id}),
                        )
                        targs["bytes"] = send_r.get("bytes", 0)
                    self._acc_xfer("data", send_r, recv_r)
        except BaseException as e:  # fail the waiters too, then re-raise
            err = e
            raise
        finally:
            for tag in started:
                fut = self._inflight.pop(tag, None)
                if fut is None or fut.done():
                    continue
                if err is None:
                    fut.set_result(None)
                else:
                    fut.set_exception(RuntimeError(f"transfer for {tag} failed: {err!r}"))
        if waits:
            await asyncio.gather(*waits)

    def _acc_xfer(self, kind: str, send_r: Optional[Dict] = None,
                  recv_r: Optional[Dict] = None, count: bool = True):
        """Fold one transfer's replies into the step's transfer/* stats."""
        acc = self._xfer_acc
        if send_r is not None:
            acc[f"{kind}_bytes"] = acc.get(f"{kind}_bytes", 0.0) + float(send_r.get("bytes", 0) or 0)
            acc[f"{kind}_send_s"] = (acc.get(f"{kind}_send_s", 0.0)
                                     + float(send_r.get("seconds", 0.0) or 0.0))
        if recv_r is not None:
            acc[f"{kind}_recv_s"] = (acc.get(f"{kind}_recv_s", 0.0)
                                     + float(recv_r.get("seconds", 0.0) or 0.0))
        if count:
            acc[f"{kind}_count"] = acc.get(f"{kind}_count", 0.0) + 1.0

    async def _run_hook(self, hook, node: MFCDef):
        if isinstance(hook, OffloadHook):
            target = str(hook.target or node.model_name)
            with tracer.span(f"offload:{target}", cat="host"):
                await self.pool.request(
                    self.placement[target], {"type": "offload", "model_name": target}
                )
        elif isinstance(hook, ParamReallocHook):
            if (self._ahead_task is not None and not _IN_PREFETCH.get()
                    and str(hook.target) in {str(n.model_name) for n in self._source_nodes}):
                # One-step-ahead rollout: never swap a generator's weights
                # under its prefetch (one weight version a batch).
                await self._ahead_task
            src_w = self.placement[str(node.model_name)]
            dst_w = self.placement[str(hook.target)]
            if src_w == dst_w:
                # Both models on one worker: a local copy (or EMA).
                with tracer.span(f"param_sync:{hook.target}", cat="comms"):
                    await self.pool.request(src_w, {
                        "type": "param_sync",
                        "src": str(node.model_name),
                        "dst": str(hook.target),
                        "eta": hook.eta,
                    })
                return
            # Across workers over the transfer plane: the source gathers
            # its weights on the host and ships them with their checksum;
            # the target verifies before it swaps.  A rejected push is
            # sent again once (the sender's serialize-once cache reships
            # the same encoding).  One observation of the push's wall a
            # hook, in the fabric's histogram.
            from areal_tpu_torch.system.paramstore import M_PUSH_SECONDS

            push_t0 = time.monotonic()
            for attempt in (1, 2):
                xfer_id = self._xfer_id
                self._xfer_id += 1
                try:
                    with tracer.span(f"param_realloc:{hook.target}", cat="comms",
                                     n_dst=1) as realloc_args:
                        send_r, recv_r = await asyncio.gather(
                            self.pool.request(src_w, {
                                "type": "param_send", "model_name": str(node.model_name),
                                "dsts": [dst_w], "xfer_ids": [xfer_id],
                                "checksum": self.weight_push_checksum,
                            }),
                            self.pool.request(dst_w, {
                                "type": "param_recv", "model_name": str(hook.target),
                                "xfer_id": xfer_id, "eta": hook.eta,
                            }),
                        )
                        realloc_args["bytes"] = int(send_r.get("bytes", 0) or 0)
                    break
                except integrity.WeightChecksumError as e:
                    if attempt >= 2:
                        raise
                    logger.warning(f"weight push to {hook.target} rejected by the receiver's "
                                   f"checksum ({e}); retrying once")
            M_PUSH_SECONDS.observe(time.monotonic() - push_t0)
            self._acc_xfer("param", send_r, recv_r)
        else:
            raise TypeError(f"unknown hook {hook!r}")

    async def _apply_difficulty_filter(self):
        """Remove the prompts whose group accuracy this step falls
        outside the configured band from every data worker's dataset:
        too easy and too hard prompts give GRPO no advantage.  Each id's
        rewards are read where they live."""
        by_worker: Dict[int, List[str]] = {}
        for sid, km in self._owners.items():
            holders = km.get("rewards")
            if holders:
                by_worker.setdefault(min(holders), []).append(sid)
        if not by_worker:
            return
        resps = await asyncio.gather(*[
            self.pool.request(w, {"type": "data_accuracy", "ids": ids})
            for w, ids in by_worker.items()
        ])
        accs: Dict[str, float] = {}
        for r in resps:
            accs.update(r.get("accuracy") or {})
        lo = self.difficulty_filter.get("min_accuracy", 0.0)
        hi = self.difficulty_filter.get("max_accuracy", 1.0)
        drop = [sid for sid, a in accs.items() if a < lo or a > hi]
        if not drop:
            return
        resps = await asyncio.gather(*[
            self.pool.request(w, {"type": "filter_dataset", "ids": drop})
            for w in self.data_worker_ids
        ])
        removed = sum(int(r.get("removed") or 0) for r in resps)
        self._filtered_ids.extend(drop)
        logger.info(f"difficulty filter: removed {removed} prompts "
                    f"({len(drop)}/{len(accs)} flagged outside accuracy [{lo}, {hi}])")

    async def _clear_worker_caches(self):
        if self._fetch_lock is None:
            self._fetch_lock = asyncio.Lock()
        # Under the fetch lock: a prefetch's fetch registers its ids in the
        # buffer inside the same critical section, so the keep set never
        # misses data a worker already caches.
        async with self._fetch_lock:
            keep = self.buffer.ids()
            keep_set = set(keep)
            for sid in list(self._owners):
                if sid not in keep_set:
                    del self._owners[sid]
            await asyncio.gather(*[
                self.pool.request(w, {"type": "clear_cache", "keep_ids": keep})
                for w in range(self.pool.n_workers)
            ])

    # ---------------- save / recover ----------------

    async def save(self, kind: str = "persistent"):
        step = self.step_info.global_step
        if kind == "recover":
            await self._save_recover(step)
            logger.info(f"saved (recover) at step {step}")
            return
        for node in self._train_rpcs:
            key = str(node.model_name)
            await self.pool.request(self.placement[key], {
                "type": "save", "model_name": key, "save_dir": self._ckpt_dir(node, f"step_{step}"),
            })
        logger.info(f"saved ({kind}) at step {step}")

    async def _save_recover(self, step: int) -> None:
        """Atomic recover save: each train node's weights and optimizer
        state are staged into ``recover_checkpoint.tmp.<step>``, a
        fsynced MANIFEST.json makes the staged dir self-validating, then
        every staged dir flips into place (the old current rotates to
        ``.prev``) and only then is recover_info.pkl rewritten.  A crash
        at any point leaves a manifest-valid checkpoint and recover info
        of the same or an older step.  The chaos kill points
        ``recover_stage`` (everything staged, nothing flipped) and
        ``recover_flip`` (flipped, the recover info still the old one)
        exit the process with code 42, as the JAX master does."""
        # Every model's version, the generator's too: its sampling seed
        # is its version, so a rollback must rewind it.
        model_versions: Dict[str, int] = {}
        for w in range(self.pool.n_workers):
            out = await self.pool.request(w, {"type": "model_versions"})
            for k, v in out["versions"].items():
                model_versions[k] = int(v)
        staged_dirs = []
        for node in self._train_rpcs:
            key = str(node.model_name)
            base = self._ckpt_dir(node, "recover_checkpoint")
            recover.clean_stale_stages(base)
            staged = recover.stage_dir(base, step)
            worker = self.placement[key]
            await self.pool.request(worker, {"type": "save", "model_name": key,
                                             "save_dir": staged})
            await self.pool.request(worker, {"type": "save_optimizer", "model_name": key,
                                             "path": os.path.join(staged, OPTIMIZER_FILE)})
            recover.write_manifest(staged, step, {key: model_versions.get(key, 0)})
            staged_dirs.append((staged, base))
        # A kill here must leave the previous current checkpoint intact.
        if self._faults is not None and self._faults.kill_point("recover_stage"):
            os._exit(42)
        for staged, base in staged_dirs:
            recover.commit_checkpoint(staged, base)
            self._m_ckpt_flips.inc()
        self._m_ckpt_last_success.set(time.time())
        # A kill here restores the older recover info against the newer
        # weights: the manifest's step tells them apart.
        if self._faults is not None and self._faults.kill_point("recover_flip"):
            os._exit(42)
        states = await asyncio.gather(
            *[self.pool.request(w, {"type": "data_state"}) for w in self.data_worker_ids]
        )
        iface_states = await asyncio.gather(*[
            self.pool.request(w, {"type": "interface_state"}) for w in range(self.pool.n_workers)
        ])
        info = recover.RecoverInfo(
            last_step_info=self.step_info,
            save_ctl_states={"save": self.save_ctl.state_dict(), "ckpt": self.ckpt_ctl.state_dict()},
            data_states={w: s["states"] for w, s in zip(self.data_worker_ids, states)},
            interface_states={w: s["states"] for w, s in enumerate(iface_states) if s["states"]},
            used_data_ids=list(self._filtered_ids),
            model_versions=model_versions,
            replay_watermarks=self.replay.watermarks() if self.replay is not None else {},
            rollout_state=(
                {"trainer_version": self._trainer_version, "batch_seq": self._batch_seq}
                if self._async_rl else {}
            ),
            quarantine_ledger=list(self._quarantine_ledger),
            consecutive_quarantines=self._consecutive_quarantines,
        )
        recover.dump(info, recover.recover_root(self.fileroot, self.experiment_name,
                                                self.trial_name))

    def _ckpt_dir(self, node: MFCDef, sub: str) -> str:
        return os.path.join(
            self.fileroot, "checkpoints", self.experiment_name, self.trial_name,
            str(node.model_name), sub,
        )

    def load_recover_info(self) -> bool:
        """Adopt the trial's recover info, if it has one: the counters
        and controls now, the workers' state at the start of run()."""
        info = recover.load(
            recover.recover_root(self.fileroot, self.experiment_name, self.trial_name)
        )
        if info is None:
            return False
        self.step_info = info.last_step_info
        if "save" in info.save_ctl_states:
            self.save_ctl.load_state_dict(info.save_ctl_states["save"])
        if "ckpt" in info.save_ctl_states:
            self.ckpt_ctl.load_state_dict(info.save_ctl_states["ckpt"])
        # A fresh restart adopts the saved ledger; a live rollback keeps
        # the longer in-memory one (its streak never checkpointed).
        if len(info.quarantine_ledger) > len(self._quarantine_ledger):
            self._quarantine_ledger = list(info.quarantine_ledger)
        self._consecutive_quarantines = int(info.consecutive_quarantines or 0)
        self._m_consec_quar.set(float(self._consecutive_quarantines))
        self._restore_pending = info
        logger.info(f"recovered at step {self.step_info.global_step}")
        return True

    async def _restore_worker_state(self):
        """Reload each train node's weights and optimizer state from its
        recover checkpoint and replay its post-hooks (the generator takes
        the weights; the EMA reference model, which no checkpoint holds,
        is mixed again from its initial weights), rewind the weight
        versions, re-apply the difficulty filter, rewind the data cursors
        and restore the interfaces' state."""
        info = self._restore_pending
        self._restore_pending = None
        t0 = time.monotonic()
        for node in self._train_rpcs:
            key = str(node.model_name)
            base = self._ckpt_dir(node, "recover_checkpoint")
            # Trust only a manifest-valid dir (current, else .prev).
            d = recover.latest_valid_checkpoint(base)
            if d is None:
                if os.path.isdir(base) or os.path.isdir(base + recover.PREV_SUFFIX):
                    raise RuntimeError(
                        f"recover checkpoint for {key!r} at {base} failed manifest "
                        "validation (and no intact .prev exists): refusing to restore "
                        "from a torn checkpoint"
                    )
                continue
            manifest = recover.validate_manifest(d)
            if manifest["step"] != self.step_info.global_step:
                logger.warning(
                    f"checkpoint step {manifest['step']} != recover-info step "
                    f"{self.step_info.global_step} for {key!r} (a crash between the flip "
                    "and the recover-info rewrite); restoring anyway"
                )
            await self.pool.request(self.placement[key], {
                "type": "load_model", "model_name": key, "ckpt_dir": d,
                "optimizer_path": os.path.join(d, OPTIMIZER_FILE),
            })
            for hook in node.post_hooks:
                await self._run_hook(hook, node)
            logger.info(f"restored {key} from {d}")
        if info.model_versions:
            # After the post-hook replay, which must not advance them: the
            # generator's version is its sampling seed.
            await asyncio.gather(*[
                self.pool.request(w, {"type": "set_model_versions",
                                      "versions": info.model_versions})
                for w in range(self.pool.n_workers)
            ])
        # The filter before the cursors, so the replay walks the dataset
        # the saved trial walked.
        if info.used_data_ids:
            self._filtered_ids = list(info.used_data_ids)
            await asyncio.gather(*[
                self.pool.request(w, {"type": "filter_dataset", "ids": self._filtered_ids})
                for w in self.data_worker_ids
            ])
        await asyncio.gather(*[
            self.pool.request(w, {"type": "load_data_state", "states": states})
            for w, states in info.data_states.items()
        ])
        await asyncio.gather(*[
            self.pool.request(w, {"type": "load_interface_state", "states": states})
            for w, states in info.interface_states.items()
        ])
        if self._async_rl:
            # Resume admission where the crashed trial stopped; the
            # pipeline cursor rewinds to the consumed batches (the
            # in-flight prefetches died with the process).
            if info.replay_watermarks:
                self.replay.load_watermarks(info.replay_watermarks)
            rs = info.rollout_state or {}
            self._trainer_version = int(rs.get("trainer_version", self.step_info.global_step))
            self._batch_seq = int(rs.get("batch_seq", 0))
            if self.replay.version < self._trainer_version:
                self.replay.set_version(self._trainer_version)
            self._batches_launched = self.step_info.global_step
        self.restore_seconds = time.monotonic() - t0
        logger.info(f"restored the workers' state in {self.restore_seconds:.2f}s")
