"""Master worker (port of the synchronous half of areal_tpu/system/master.py):
drives the DFG one train step at a time, keeps the epoch/step account
and the save cadence.

Each step is one asyncio gather of a data loader and one coroutine per
MFC: an MFC's coroutine waits in the `SequenceBuffer` until its input
keys are ready for `n_seqs` data ids, runs its pre-hooks, dispatches the
call to the worker that hosts its model, amends the buffer with the
outputs' metadata and runs its post-hooks (the generator's weight sync
after the actor's train step, a model's host offload).  The pool runs
each request in a thread of its own, so MFCs whose inputs are ready
together (the reward and the reference model's forward) run at once.

One worker hosts every model (a single device).  Not yet ported, and
refused where a plan asks for them: placements over more than one
worker (ROADMAP queue 1, items 7 and 8), recover checkpoints and
recovery (`ckpt_freq_steps`; queue 1, item 4) and the asynchronous and
streamed step branches (`rollout_ahead`, `max_head_offpolicyness`,
`pipeline_overlap`; items 6 and 7).
"""

import asyncio
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.config import ModelInterfaceType
from areal_tpu_torch.api.dfg import DFG, MFCDef, OffloadHook, ParamReallocHook
from areal_tpu_torch.base.monitor import StatsLogger
from areal_tpu_torch.system.buffer import SequenceBuffer

logger = logging.getLogger("areal_tpu_torch.master")


class WorkerPool:
    """Transport abstraction: request(worker_id, payload) -> response."""

    async def request(self, worker_id: int, payload: Dict[str, Any]) -> Dict:
        raise NotImplementedError

    @property
    def n_workers(self) -> int:
        raise NotImplementedError


class InProcessPool(WorkerPool):
    """Every worker lives in this process; each request runs in a thread
    of its own."""

    def __init__(self, workers):
        self.workers = list(workers)

    async def request(self, worker_id: int, payload: Dict[str, Any]) -> Dict:
        return await asyncio.to_thread(self.workers[worker_id].handle_request, payload)

    @property
    def n_workers(self) -> int:
        return len(self.workers)


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    total_train_epochs: int = 1
    save_freq_steps: Optional[int] = None
    # Recover checkpoints: not yet ported (ROADMAP queue 1, item 4).
    ckpt_freq_steps: Optional[int] = None
    benchmark_steps: Optional[int] = None  # stop early after N steps


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self, steps_per_epoch: int) -> "StepInfo":
        ep, es = self.epoch, self.epoch_step + 1
        if es >= steps_per_epoch:
            ep, es = ep + 1, 0
        return StepInfo(epoch=ep, epoch_step=es, global_step=self.global_step + 1)


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
    ):
        if (pool.n_workers != 1 or set(model_placement.values()) != {0}
                or list(data_worker_ids) != [0]):
            raise NotImplementedError(
                "placements over more than one worker need the cross-worker data and "
                "param planes (ROADMAP queue 1, items 7 and 8)"
            )
        if ctrl.ckpt_freq_steps is not None:
            raise NotImplementedError(
                "recover checkpoints (ckpt_freq_steps) are not yet ported (ROADMAP queue 1, item 4)"
            )
        self.dfg = dfg
        self.pool = pool
        self.placement = model_placement
        self.data_worker_ids = list(data_worker_ids)
        self.ctrl = ctrl
        self.fileroot = fileroot
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.buffer = SequenceBuffer(consumers={n.name: n.input_keys for n in dfg.nodes})
        self.step_info = StepInfo()
        self.stats_history: List[Dict[str, float]] = []
        self.stats_logger = StatsLogger(fileroot, experiment_name, trial_name)
        self._steps_since_save = 0
        self._steps_per_epoch: Optional[int] = None
        self._train_rpcs = [
            n for n in dfg.nodes if n.interface_type == ModelInterfaceType.TRAIN_STEP
        ]

    # ---------------- lifecycle ----------------

    def load_recover_info(self) -> bool:
        """Recovery is not yet ported (ROADMAP queue 1, item 4): a trial
        always starts at step 0."""
        return False

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
        logger.info(f"master: {total_steps} steps ({self.ctrl.total_train_epochs} epochs x "
                    f"{self._steps_per_epoch})")
        try:
            while self.step_info.global_step < total_steps:
                t0 = time.monotonic()
                stats = await self.execute_step()
                dt = time.monotonic() - t0
                stats["time/step_s"] = dt
                self.stats_history.append(stats)
                step = self.step_info.global_step + 1
                logger.info(f"step {step}/{total_steps} ({dt:.2f}s): "
                            f"{ {k: round(v, 4) for k, v in stats.items()} }")
                self.stats_logger.log(step, stats)
                self.step_info = self.step_info.next(self._steps_per_epoch)
                # A quarantined step (the update discarded by the train
                # engine's non-finite guard) never saves.
                quarantined = any(
                    k.rsplit("/", 1)[-1] == "quarantined" and v > 0 for k, v in stats.items()
                )
                if not quarantined:
                    await self._post_step()
        finally:
            self.stats_logger.close()
        return self.stats_history

    async def _post_step(self):
        freq = self.ctrl.save_freq_steps
        self._steps_since_save += 1
        if freq is not None and self._steps_since_save >= freq:
            self._steps_since_save = 0
            await self.save()

    # ---------------- one step ----------------

    async def execute_step(self) -> Dict[str, float]:
        results: Dict[str, Dict[str, float]] = {}
        await asyncio.gather(
            self._load_data(), *[self._run_mfc(node, results) for node in self.dfg.nodes]
        )
        await self._clear_worker_caches()
        merged: Dict[str, float] = {}
        for name, stats in results.items():
            for k, v in stats.items():
                merged[f"{name}/{k}" if len(results) > 1 else k] = v
        for k, v in self.buffer.stats().items():
            merged[f"buffer/{k}"] = float(v)
        return merged

    async def _load_data(self) -> None:
        resps = await asyncio.gather(
            *[self.pool.request(w, {"type": "fetch"}) for w in self.data_worker_ids]
        )
        for r in resps:
            await self.buffer.put_batch(r["meta"])

    async def _run_mfc(self, node: MFCDef, results: Dict):
        batch = await self.buffer.get_batch_for_rpc(node, timeout=600)
        for hook in node.pre_hooks:
            await self._run_hook(hook, node)
        resp = await self._dispatch_mfc(node, list(batch.ids))
        results[node.name] = resp.get("stats") or {}
        for hook in node.post_hooks:
            await self._run_hook(hook, node)

    async def _dispatch_mfc(self, node: MFCDef, ids: List[str]) -> Dict:
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
        resp = await self.pool.request(self.placement[str(node.model_name)], payload)
        if resp.get("meta") is not None:
            await self.buffer.amend_batch(resp["meta"])
        return resp

    async def _run_hook(self, hook, node: MFCDef):
        if isinstance(hook, OffloadHook):
            target = str(hook.target or node.model_name)
            await self.pool.request(
                self.placement[target], {"type": "offload", "model_name": target}
            )
        elif isinstance(hook, ParamReallocHook):
            # Both models on the one worker: a local copy.
            await self.pool.request(self.placement[str(node.model_name)], {
                "type": "param_sync",
                "src": str(node.model_name),
                "dst": str(hook.target),
                "eta": hook.eta,
            })
        else:
            raise TypeError(f"unknown hook {hook!r}")

    async def _clear_worker_caches(self):
        keep = self.buffer.ids()
        await asyncio.gather(*[
            self.pool.request(w, {"type": "clear_cache", "keep_ids": keep})
            for w in range(self.pool.n_workers)
        ])

    # ---------------- save ----------------

    async def save(self):
        step = self.step_info.global_step
        for node in self._train_rpcs:
            key = str(node.model_name)
            await self.pool.request(self.placement[key], {
                "type": "save", "model_name": key, "save_dir": self._ckpt_dir(node, f"step_{step}"),
            })
        logger.info(f"saved at step {step}")

    def _ckpt_dir(self, node: MFCDef, sub: str) -> str:
        return os.path.join(
            self.fileroot, "checkpoints", self.experiment_name, self.trial_name,
            str(node.model_name), sub,
        )
