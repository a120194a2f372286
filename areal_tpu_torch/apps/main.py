"""Experiment launcher (port of areal_tpu/apps/main.py).

Two ways to run a plan:
- `run_experiment_inproc(plan)`: every worker in this process
  (`experiments/common.run_experiment`: an `InProcessPool`, the workers
  joined by `InProcTransfer`).
- `run_experiment(plan)`: one worker process a `WorkerConfig` (an SPMD
  worker group's members each one, rank r on card r; model replicas
  are independent processes and may share a card), started by
  the local scheduler (`python -m areal_tpu_torch.apps.worker`, through
  subprocess: fork then exec, never a bare fork of a process whose CUDA
  is initialised), the master in this process over a `ConnWorkerPool`.
  The plan is pickled into a plan directory, discovery goes through the
  file name_resolve store under the trial's fileroot, and the workers get
  `PYTHONPATH`, the trial's authkey, the heartbeat period and the kernel
  build directory in their environment.  A watch on the processes fails
  the attempt as soon as a worker exits; with `recover_retries` the
  launcher then stops every worker, resubmits them all and the master
  resumes from the last recover checkpoint.  Each attempt serves the
  master's metrics registry at ``GET /metrics``, announced as the trial's
  ``master`` role (the in-process trial starts no server, as in the JAX
  package).

The launcher's process runs only the master and needs no CUDA context.
"""

import asyncio
import logging
import os
import pickle
import sys
import time
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import metrics, name_resolve, tracer
from areal_tpu_torch.experiments.common import ExperimentPlan
from areal_tpu_torch.scheduler import JobException, JobState, make_scheduler
from areal_tpu_torch.scheduler.client import read_log_tail
from areal_tpu_torch.system.master import MasterWorker

logger = logging.getLogger("areal_tpu_torch.main")


def run_experiment_inproc(plan: ExperimentPlan, tokenizer=None, device=None):
    """Every worker in this process, on `device` (the CUDA card unless
    told otherwise); returns the per-step stats."""
    from areal_tpu_torch.experiments.common import run_experiment as run_inproc

    _, stats = run_inproc(plan, tokenizer=tokenizer, device=device)
    return stats


def make_master(plan: ExperimentPlan, pool) -> MasterWorker:
    return MasterWorker(
        dfg=plan.dfg,
        pool=pool,
        model_placement=plan.model_placement,
        data_worker_ids=plan.data_worker_ids,
        ctrl=plan.ctrl,
        fileroot=plan.fileroot,
        experiment_name=plan.experiment_name,
        trial_name=plan.trial_name,
        model_groups=plan.model_groups,
        model_replicas=plan.model_replicas,
        difficulty_filter=plan.difficulty_filter,
        max_recoveries=plan.max_recoveries,
        max_consecutive_quarantines=plan.max_consecutive_quarantines,
        weight_push_checksum=plan.weight_push_checksum,
        pipeline_overlap=plan.pipeline_overlap,
        overlap_window=plan.overlap_window,
        pipeline_chunk_seqs=plan.pipeline_chunk_seqs,
        rollout_ahead=plan.rollout_ahead,
        max_head_offpolicyness=plan.max_head_offpolicyness,
        replay_capacity=plan.replay_capacity,
    )


async def _watch_jobs(sched):
    """Fail fast when a worker process exits while the master runs."""
    while True:
        for info in sched.find_all():
            if info.state in (JobState.FAILED, JobState.CANCELLED):
                raise JobException(
                    "trial", info.name, info.host or "?", info.state
                ) from RuntimeError(f"worker log tail:\n{read_log_tail(info.log_path)}")
        await asyncio.sleep(1.0)


async def _run_master(plan: ExperimentPlan, sched, on_finish, timeline):
    from areal_tpu_torch.system.stream import ConnWorkerPool

    pool = ConnWorkerPool(
        plan.experiment_name, plan.trial_name, len(plan.worker_configs),
        mfc_timeout_s=plan.mfc_timeout_s, worker_heartbeat_s=plan.worker_heartbeat_s,
    )
    loop = asyncio.get_running_loop()
    watchdog = loop.create_task(_watch_jobs(sched))
    try:
        master_task = loop.create_task(_drive_master(plan, pool, on_finish, timeline))
        done, _ = await asyncio.wait({master_task, watchdog},
                                     return_when=asyncio.FIRST_COMPLETED)
        if watchdog in done:  # a worker exited: fail the attempt
            master_task.cancel()
            await asyncio.gather(master_task, return_exceptions=True)
            watchdog.result()
        return master_task.result()
    finally:
        watchdog.cancel()
        pool.close()


async def _drive_master(plan: ExperimentPlan, pool, on_finish, timeline):
    await pool.wait_workers()
    _mark(timeline, "connected")
    master = make_master(plan, pool)
    # Resume the trial from its recover checkpoint, if it has one.
    master.load_recover_info()
    stats = await master.run()
    if on_finish is not None:
        await asyncio.to_thread(on_finish, master)
    await pool.broadcast({"type": "exit"})
    return stats


def _mark(timeline: Optional[List], event: str, **kw):
    if timeline is not None:
        timeline.append({"event": event, "t": time.monotonic(), **kw})


def run_experiment(
    plan: ExperimentPlan,
    recover_retries: int = 0,
    worker_env: Optional[Dict[str, str]] = None,
    device=None,
    worker_envs: Optional[Dict[int, Dict[str, str]]] = None,
    on_finish: Optional[Callable[[MasterWorker], None]] = None,
    timeline: Optional[List] = None,
):
    """The multi-process trial: one worker process a `WorkerConfig` on
    `device` (the CUDA card unless told otherwise), the master here, a
    retry from the recover checkpoint after a failed attempt (up to
    `recover_retries` times).  `on_finish(master)` runs (in a thread)
    after the last step, while the workers still serve; `timeline`
    collects each attempt's events with their monotonic times.
    `worker_env` goes to every worker, `worker_envs[i]` to worker i
    alone.  Returns the per-step stats of the attempt that finished."""
    from areal_tpu_torch.kernels.build import BUILD_DIR
    from areal_tpu_torch.system.stream import ENV_AUTHKEY

    root = os.path.join(plan.fileroot, "name_resolve", plan.experiment_name, plan.trial_name)
    os.makedirs(root, exist_ok=True)
    os.environ["AREAL_NAME_RESOLVE"] = "file"
    os.environ["AREAL_NAME_RESOLVE_ROOT"] = root
    name_resolve.set_default(name_resolve.FileNameResolveRepository(root))
    # One authkey a trial: every lane of the stream, the transfer plane and
    # the control servers ask it; the operator CLI reads the file.
    authkey = os.urandom(32).hex()
    os.environ[ENV_AUTHKEY] = authkey

    plan_dir = os.path.join(plan.fileroot, "plans", plan.experiment_name, plan.trial_name)
    os.makedirs(plan_dir, exist_ok=True)
    for wc in plan.worker_configs:
        with open(os.path.join(plan_dir, f"worker_{wc.worker_index}.pkl"), "wb") as f:
            pickle.dump(wc, f)
    key_path = os.path.join(plan_dir, "authkey")
    with open(os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600), "w") as f:
        f.write(authkey)

    # The workers import the package whatever their working directory.
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pythonpath = os.environ.get("PYTHONPATH", "")
    if pkg_root not in pythonpath.split(os.pathsep):
        pythonpath = f"{pkg_root}{os.pathsep}{pythonpath}" if pythonpath else pkg_root
    env = {
        "PYTHONPATH": pythonpath,
        "AREAL_NAME_RESOLVE": "file",
        "AREAL_NAME_RESOLVE_ROOT": root,
        ENV_AUTHKEY: authkey,
        # The liveness lane: beats this often let the master's deadline
        # tell a slow worker from a dead one.
        "AREAL_WORKER_HEARTBEAT_S": str(plan.worker_heartbeat_s),
        # The kernels built once (chip_smoke's build phase, or the first
        # launch) are loaded by every worker from here.
        "AREAL_TORCH_BUILD_DIR": BUILD_DIR,
    }
    # Every process's trace shards land in one dir: the explicit env
    # ships it with the workers (the master configures itself).
    trace_dir = tracer.default_dir(plan.fileroot, plan.experiment_name, plan.trial_name)
    if trace_dir:
        env["AREAL_TRACE"] = os.environ.get("AREAL_TRACE", "1")
        env["AREAL_TRACE_DIR"] = trace_dir
    env.update(worker_env or {})
    dev = "cuda" if device is None else str(device)

    last_err = None
    for attempt in range(recover_retries + 1):
        sched = make_scheduler("local", plan.experiment_name, f"{plan.trial_name}-attempt{attempt}",
                               env=env, log_root=os.path.join(plan.fileroot, "logs"))
        _mark(timeline, "submit", attempt=attempt)
        # The master's metrics plane (it runs in this process): serve the
        # default registry and announce it as the trial's "master" role,
        # beside the workers' own servers (apps/worker.py).
        metrics_server = metrics.MetricsServer(
            announce=(plan.experiment_name, plan.trial_name, "master")
        )
        # A fresh rendezvous key an attempt: a worker group's members must
        # never meet at an earlier attempt's (or run's) stale address.
        rendezvous = f"attempt{attempt}-{os.urandom(4).hex()}"
        for i in range(len(plan.worker_configs)):
            sched.submit(f"model_worker/{i}", [
                sys.executable, "-m", "areal_tpu_torch.apps.worker",
                "--config", plan_dir, "--index", str(i),
                "--experiment", plan.experiment_name, "--trial", plan.trial_name,
                "--device", dev, "--rendezvous", rendezvous,
            ], env=(worker_envs or {}).get(i))
        try:
            stats = asyncio.run(_run_master(plan, sched, on_finish, timeline))
            sched.wait(timeout=60.0)
            _mark(timeline, "done", attempt=attempt)
            return stats
        except (JobException, RuntimeError, TimeoutError) as e:
            last_err = e
            _mark(timeline, "failed", attempt=attempt, error=repr(e))
            logger.error(f"trial attempt {attempt} failed: {e!r}")
            if e.__cause__ is not None:
                logger.error(str(e.__cause__))
            sched.stop_all()
            if attempt >= recover_retries:
                raise
            logger.info(f"recovering (attempt {attempt + 1})")
        finally:
            metrics_server.close()
            sched.stop_all()
    raise last_err  # pragma: no cover
