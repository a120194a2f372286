"""Task-mixture curriculum scheduler (port of areal_tpu/data/mixture.py):
a weighted multi-dataset prompt stream for the rollout controller.

A :class:`TaskMixtureStream` interleaves several named task sources
(math, code, ...) by smooth weighted round-robin — deterministic, with a
bounded starvation window: a task holding fraction ``w`` of the total
weight is drawn at least once every ``ceil(1/w) + 1`` draws, so a
low-weight task can never be silently starved the way i.i.d. sampling
allows.  Each emitted item carries its task name, the task's dataset
epoch, and the per-task index, so the rollout controller mints
collision-free qids (``task:e{epoch}:p{index}``) and stamps lineage
trace roots with their task.

Per-task cursors/epochs (and the round-robin credit state) persist
through ``state_dict``/``load_state_dict`` — riding inside
``RolloutController.state_dict()`` into ``RecoverInfo.rollout_state`` —
so a recovered trial resumes every task stream exactly where it stopped.
An old pickle that only recorded the controller's scalar ``cursor`` is
backfilled by :meth:`fast_forward`: replaying that many draws of the
deterministic schedule reconstructs the identical per-task positions.

Curriculum: :meth:`observe_reward` maintains a per-task reward EMA
(exported as ``areal_mixture_task_reward{task}`` — the per-task reward
curve on the metrics plane); in ``adaptive`` mode, tasks whose EMA sits
below their ``reward_watermark`` are upweighted proportionally to the
shortfall, bounded by ``max_boost``, and the effective weights are
re-normalized — the mixture leans into whatever the policy has not
learned yet.  :meth:`observe_staleness` tracks per-task staleness from
the replay plane (``ReplayBuffer.task_watermarks``) for the dashboard.
"""

import dataclasses
import logging
import math
from typing import Any, Dict, List, Optional, Sequence

from areal_tpu_torch.base import metrics

logger = logging.getLogger("areal_tpu_torch.mixture")

_REG = metrics.default_registry()

# Per-task reward curve (EMA of observed pass/fail rewards) — the signal
# the adaptive curriculum and the dashboard both read.
_M_TASK_REWARD = _REG.gauge(
    "areal_mixture_task_reward",
    "per-task reward EMA observed by the mixture scheduler",
    ("task",),
)
_M_TASK_WEIGHT = _REG.gauge(
    "areal_mixture_task_weight",
    "effective (normalized) mixture weight per task",
    ("task",),
)
_M_TASK_SAMPLED = _REG.counter(
    "areal_mixture_task_sampled_total",
    "prompts drawn from each task stream",
    ("task",),
)
_M_TASK_STALENESS = _REG.gauge(
    "areal_mixture_task_staleness",
    "per-task consumed-staleness EMA from the replay plane",
    ("task",),
)


@dataclasses.dataclass
class TaskSource:
    """One named prompt stream in the mixture.

    ``prompts`` is any indexable sequence of items the rollout
    controller accepts (bare token lists, ``(qid, ids)`` pairs, or
    dicts); the stream cycles it forever, bumping the task's epoch on
    each wrap.  ``reward_watermark`` is the adaptive mode's target: a
    task whose reward EMA sits below it gets upweighted."""

    name: str
    prompts: Sequence[Any]
    weight: float = 1.0
    reward_watermark: float = 0.5


class TaskMixtureStream:
    """Deterministic weighted interleave over named task sources.

    Iterating yields dicts ``{"task", "epoch", "index", "prompt_ids",
    ...}`` (dict sources are merged through, so extra keys like an
    explicit ``qid`` survive).  Infinite — callers bound consumption via
    ``max_prompts`` on the controller.
    """

    def __init__(
        self,
        sources: Sequence[TaskSource],
        adaptive: bool = False,
        adapt_gain: float = 1.0,
        max_boost: float = 4.0,
        ema_alpha: float = 0.2,
    ):
        if not sources:
            raise ValueError("mixture needs at least one task source")
        seen = set()
        for s in sources:
            if s.name in seen:
                raise ValueError(f"duplicate task name {s.name!r}")
            seen.add(s.name)
            if s.weight <= 0:
                raise ValueError(
                    f"task {s.name!r} weight must be > 0, got {s.weight}"
                )
            if len(s.prompts) == 0:
                raise ValueError(f"task {s.name!r} has no prompts")
        self.sources: Dict[str, TaskSource] = {s.name: s for s in sources}
        self.adaptive = adaptive
        self.adapt_gain = adapt_gain
        self.max_boost = max_boost
        self.ema_alpha = ema_alpha
        total = sum(s.weight for s in sources)
        self._base = {s.name: s.weight / total for s in sources}
        self._eff = dict(self._base)
        self._credit = {s.name: 0.0 for s in sources}
        self._cursors = {s.name: 0 for s in sources}
        self._epochs = {s.name: 0 for s in sources}
        self._reward_ema: Dict[str, Optional[float]] = {
            s.name: None for s in sources
        }
        self._staleness_ema: Dict[str, Optional[float]] = {
            s.name: None for s in sources
        }
        self.drawn = 0
        self._export_weights()

    # ---------------- scheduling ----------------

    @property
    def weights(self) -> Dict[str, float]:
        """Effective (normalized) weights the interleave is running on."""
        return dict(self._eff)

    def _pick(self) -> str:
        """Smooth weighted round-robin: every task accrues credit at its
        weight, the richest task is drawn and pays the full pot back.
        Deterministic (ties break by name), and any task's credit
        deficit is bounded by 1, which bounds its starvation window."""
        for name, w in self._eff.items():
            self._credit[name] += w
        pick = max(
            self._credit, key=lambda n: (self._credit[n], n)
        )
        self._credit[pick] -= 1.0
        return pick

    def _draw(self, advance_only: bool = False) -> Optional[Dict[str, Any]]:
        name = self._pick()
        src = self.sources[name]
        i = self._cursors[name]
        epoch = self._epochs[name]
        self._cursors[name] += 1
        if self._cursors[name] >= len(src.prompts):
            self._cursors[name] = 0
            self._epochs[name] += 1
        self.drawn += 1
        if advance_only:
            return None
        _M_TASK_SAMPLED.labels(name).inc()
        item = src.prompts[i]
        out: Dict[str, Any] = {}
        if isinstance(item, dict):
            out.update(item)
            ids = item.get("prompt_ids")
        elif (
            isinstance(item, (tuple, list))
            and len(item) == 2
            and isinstance(item[0], str)
        ):
            out["qid"] = item[0]
            ids = item[1]
        else:
            ids = item
        out["task"] = name
        out["epoch"] = epoch
        out["index"] = i
        out["prompt_ids"] = [int(t) for t in ids]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        return self._draw()

    def fast_forward(self, n: int) -> None:
        """Advance the deterministic schedule by ``n`` draws without
        emitting — the old-pickle backfill path: a pre-mixture recover
        record only holds the controller's scalar cursor, and replaying
        that many draws reconstructs the exact per-task positions."""
        for _ in range(max(0, int(n))):
            self._draw(advance_only=True)

    # ---------------- curriculum feedback ----------------

    def observe_reward(self, task: str, reward: float) -> None:
        """Fold one graded sample into the task's reward EMA; adaptive
        mode re-derives the effective weights from the watermarks."""
        if task not in self.sources:
            return
        prev = self._reward_ema[task]
        ema = (
            float(reward)
            if prev is None
            else (1 - self.ema_alpha) * prev + self.ema_alpha * float(reward)
        )
        self._reward_ema[task] = ema
        _M_TASK_REWARD.labels(task).set(ema)
        if self.adaptive:
            self._recompute()

    def observe_staleness(self, task: str, staleness: float) -> None:
        if task not in self.sources:
            return
        prev = self._staleness_ema[task]
        ema = (
            float(staleness)
            if prev is None
            else (1 - self.ema_alpha) * prev
            + self.ema_alpha * float(staleness)
        )
        self._staleness_ema[task] = ema
        _M_TASK_STALENESS.labels(task).set(ema)

    def sync_replay(self, task_watermarks: Dict[str, Dict[str, float]]):
        """Fold ``ReplayBuffer.task_watermarks()`` into the per-task
        staleness EMAs (one call per training step is plenty)."""
        for task, wm in task_watermarks.items():
            self.observe_staleness(task, wm.get("staleness_mean", 0.0))

    def reward_ema(self, task: str) -> Optional[float]:
        return self._reward_ema.get(task)

    def _recompute(self) -> None:
        """Adaptive weights: each task's base weight is boosted by its
        relative shortfall below the reward watermark (an unobserved
        task stays at base — no reward signal, no opinion), capped at
        ``max_boost``, then the set is re-normalized."""
        eff = {}
        for name, base in self._base.items():
            ema = self._reward_ema[name]
            wm = self.sources[name].reward_watermark
            boost = 1.0
            if ema is not None and wm > 0 and ema < wm:
                boost = min(
                    self.max_boost,
                    1.0 + self.adapt_gain * (wm - ema) / wm,
                )
            eff[name] = base * boost
        total = sum(eff.values())
        self._eff = {n: w / total for n, w in eff.items()}
        self._export_weights()

    def _export_weights(self) -> None:
        for name, w in self._eff.items():
            _M_TASK_WEIGHT.labels(name).set(w)

    def starvation_bound(self, task: str) -> int:
        """Largest draw gap the schedule can show this task: with credit
        deficits bounded by 1, a task at effective weight ``w`` waits at
        most ``ceil(1/w) + 1`` draws between selections."""
        w = self._eff[task]
        return int(math.ceil(1.0 / w)) + 1

    # ---------------- persistence ----------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "cursors": dict(self._cursors),
            "epochs": dict(self._epochs),
            "credit": dict(self._credit),
            "eff_weights": dict(self._eff),
            "reward_ema": dict(self._reward_ema),
            "staleness_ema": dict(self._staleness_ema),
            "drawn": self.drawn,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore per-task positions; unknown tasks in the record are
        dropped (a config that removed a task keeps working), missing
        tasks keep their fresh defaults (a config that added one)."""
        for field, target in (
            ("cursors", self._cursors),
            ("epochs", self._epochs),
            ("credit", self._credit),
            ("eff_weights", self._eff),
            ("reward_ema", self._reward_ema),
            ("staleness_ema", self._staleness_ema),
        ):
            for name, v in (sd.get(field) or {}).items():
                if name in target:
                    target[name] = v
        self.drawn = int(sd.get("drawn", 0))
        for name in self._cursors:
            n = len(self.sources[name].prompts)
            if self._cursors[name] >= n:
                # The dataset shrank since the record was written.
                self._cursors[name] %= n
        self._export_weights()


def build_mixture(
    weights: Dict[str, float],
    prompts_by_task: Dict[str, Sequence[Any]],
    adaptive: bool = False,
    reward_watermarks: Optional[Dict[str, float]] = None,
) -> TaskMixtureStream:
    """Config-plumbing helper: ``weights`` comes straight from the
    experiment config's ``mixture_weights`` mapping."""
    wms = reward_watermarks or {}
    sources: List[TaskSource] = []
    for name, w in weights.items():
        if name not in prompts_by_task:
            raise ValueError(
                f"mixture names task {name!r} but no prompts were given "
                f"for it (have: {sorted(prompts_by_task)})"
            )
        sources.append(
            TaskSource(
                name=name,
                prompts=prompts_by_task[name],
                weight=float(w),
                reward_watermark=float(wms.get(name, 0.5)),
            )
        )
    return TaskMixtureStream(sources, adaptive=adaptive)
