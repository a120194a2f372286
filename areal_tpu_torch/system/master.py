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
`max_recoveries` budget.

One worker hosts every model (a single device).  Not yet ported, and
refused where a plan asks for them: placements over more than one
worker (ROADMAP queue 1, items 7 and 8), worker-death recovery and the
asynchronous and streamed step branches (`rollout_ahead`,
`max_head_offpolicyness`, `pipeline_overlap`; items 6 and 7).
"""

import asyncio
import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.config import ModelInterfaceType
from areal_tpu_torch.api.dfg import DFG, MFCDef, OffloadHook, ParamReallocHook
from areal_tpu_torch.base import integrity, recover, timeutil
from areal_tpu_torch.base.monitor import StatsLogger
from areal_tpu_torch.system.buffer import SequenceBuffer

logger = logging.getLogger("areal_tpu_torch.master")

OPTIMIZER_FILE = "optimizer_state.safetensors"


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
        # Rollbacks to the recover checkpoint the run loop absorbs before
        # it gives up.
        max_recoveries: int = 3,
        # Consecutive quarantined steps that escalate to a rollback onto
        # the last valid recover checkpoint (0: only count them).
        max_consecutive_quarantines: int = 3,
    ):
        if (pool.n_workers != 1 or set(model_placement.values()) != {0}
                or list(data_worker_ids) != [0]):
            raise NotImplementedError(
                "placements over more than one worker need the cross-worker data and "
                "param planes (ROADMAP queue 1, items 7 and 8)"
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
        # Ids the step's reward call graded, in the buffer's order (the
        # JAX master reads them from its cross-worker ownership map).
        self._graded_ids: List[str] = []
        # Ids of the latest fetch: the quarantine ledger's attribution.
        self._last_data_ids: List[str] = []
        self.buffer = SequenceBuffer(consumers={n.name: n.input_keys for n in dfg.nodes})
        self.step_info = recover.StepInfo()
        self.save_ctl = timeutil.FrequencyControl(frequency_steps=ctrl.save_freq_steps)
        self.ckpt_ctl = timeutil.FrequencyControl(
            frequency_steps=ctrl.ckpt_freq_steps, frequency_seconds=ctrl.ckpt_freq_secs,
        )
        self.stats_history: List[Dict[str, float]] = []
        self.stats_logger = StatsLogger(fileroot, experiment_name, trial_name)
        self.max_recoveries = int(max_recoveries)
        self._recoveries = 0
        self.max_consecutive_quarantines = int(max_consecutive_quarantines)
        self._consecutive_quarantines = 0
        self._quarantine_ledger: List[Dict[str, Any]] = []
        self._steps_per_epoch: Optional[int] = None
        self._restore_pending: Optional[recover.RecoverInfo] = None
        self._train_rpcs = [
            n for n in dfg.nodes if n.interface_type == ModelInterfaceType.TRAIN_STEP
        ]

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
        logger.info(f"master: {total_steps} steps ({self.ctrl.total_train_epochs} epochs x "
                    f"{self._steps_per_epoch})")
        if self._restore_pending:
            await self._restore_worker_state()
        try:
            while self.step_info.global_step < total_steps:
                t0 = time.monotonic()
                stats = await self.execute_step()
                dt = time.monotonic() - t0
                stats["time/step_s"] = dt
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
        finally:
            self.stats_logger.close()
        return self.stats_history

    async def _post_step(self):
        if self.save_ctl.check():
            await self.save(kind="persistent")
        if self.ckpt_ctl.check():
            await self.save(kind="recover")

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
            self._consecutive_quarantines = 0
            return False
        verdict = 0
        for k, v in stats.items():
            if k.rsplit("/", 1)[-1] == "anomaly_verdict":
                verdict |= int(v)
        self._consecutive_quarantines += 1
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
        return True

    async def _quarantine_rollback(self) -> None:
        """Roll every model back to the last valid recover checkpoint (a
        quarantined step never checkpoints, so it predates the streak),
        within the `max_recoveries` budget."""
        self._recoveries += 1
        report = {
            "event": "quarantine_rollback",
            "step": self.step_info.global_step,
            "consecutive_quarantines": self._consecutive_quarantines,
            "ledger_tail": self._quarantine_ledger[-self._consecutive_quarantines:],
            "recovery": self._recoveries,
            "max_recoveries": self.max_recoveries,
        }
        logger.error(f"FAULT_REPORT {json.dumps(report, sort_keys=True)}")
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
        logger.info(f"quarantine rollback complete; resuming at step "
                    f"{self.step_info.global_step}")

    async def _abort_step(self) -> None:
        """Forget the step's data before a rollback, so the replayed step
        starts from a clean buffer.  (The JAX master also cancels its
        prefetches and drops open train streams: the port has neither.)"""
        self.buffer.clear()
        self._graded_ids = []

    # ---------------- one step ----------------

    async def execute_step(self) -> Dict[str, float]:
        results: Dict[str, Dict[str, float]] = {}
        self._graded_ids = []
        await asyncio.gather(
            self._load_data(), *[self._run_mfc(node, results) for node in self.dfg.nodes]
        )
        if self.difficulty_filter:
            await self._apply_difficulty_filter()
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
        ids: List[str] = []
        for r in resps:
            await self.buffer.put_batch(r["meta"])
            ids.extend(r["meta"].ids)
        self._last_data_ids = ids

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
        meta = resp.get("meta")
        if meta is not None:
            await self.buffer.amend_batch(meta)
            if "rewards" in meta.keys:
                self._graded_ids.extend(meta.ids)
        return resp

    async def _run_hook(self, hook, node: MFCDef):
        if isinstance(hook, OffloadHook):
            target = str(hook.target or node.model_name)
            await self.pool.request(
                self.placement[target], {"type": "offload", "model_name": target}
            )
        elif isinstance(hook, ParamReallocHook):
            # Both models on the one worker: a local copy (or EMA).
            await self.pool.request(self.placement[str(node.model_name)], {
                "type": "param_sync",
                "src": str(node.model_name),
                "dst": str(hook.target),
                "eta": hook.eta,
            })
        else:
            raise TypeError(f"unknown hook {hook!r}")

    async def _apply_difficulty_filter(self):
        """Remove the prompts whose group accuracy this step falls
        outside the configured band from every data worker's dataset:
        too easy and too hard prompts give GRPO no advantage."""
        ids = list(dict.fromkeys(self._graded_ids))
        if not ids:
            return
        # One worker holds every graded id.
        resp = await self.pool.request(0, {"type": "data_accuracy", "ids": ids})
        accs: Dict[str, float] = dict(resp.get("accuracy") or {})
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
        keep = self.buffer.ids()
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
        of the same or an older step.  (The JAX master's fault-injection
        kill points and its asynchronous-RL fields come with ROADMAP
        queue 1, item 7.)"""
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
        for staged, base in staged_dirs:
            recover.commit_checkpoint(staged, base)
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
