"""Verification-based rewards (port of areal_tpu/interfaces/reward.py,
`MultiTaskRewardInterface`).

Each sequence is dispatched by its task metadata, its response decoded
and graded, and scored ±`reward_value` (one scalar per sequence).  An
item travels in the reward service's opaque schema (``{"task", "text",
"payload"}``) and is graded by the verifier registry
(`interfaces/reward_service.grade_item`: math, code, judge) in this
process, with `remote_url` by a reward service over HTTP (local
fallback), or with `verifier_pool` by the trial's announced verifier
fleet (`system/verifier_pool.py`).  Code grading runs the response's
last fenced program on each test input in the sandbox
(`interfaces/sandbox.run_sandboxed`)."""

import dataclasses
import json
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface
from areal_tpu_torch.interfaces.reward_service import _row_is_choice, verify_code  # noqa: F401

logger = logging.getLogger("areal_tpu_torch.reward")


@dataclasses.dataclass
class MultiTaskRewardInterface(ModelInterface):
    """id2info maps query_id -> the dataset row (task, solutions,
    input_output, ...)."""

    id2info: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    dataset_path: Optional[str] = None
    reward_value: float = 5.0
    code_timeout_s: float = 8.0
    # http://host:port of a reward service; each batch is graded there in
    # one round trip (local fallback on failure).  None: in-process.
    remote_url: Optional[str] = None
    remote_timeout_s: float = 600.0
    # Overrides every row's task (one backend for the run); "" = per row.
    reward_backend: str = ""
    # Grade through the announced verifier fleet (system/verifier_pool.py)
    # instead of a fixed remote_url: batches go to the least-loaded live
    # worker behind its breaker, retry on another, and fall back to the
    # in-process registry when none is live.  Takes precedence over
    # remote_url.
    verifier_pool: bool = False
    pool_experiment: str = ""
    pool_trial: str = ""
    pool_attempt_timeout_s: float = 60.0
    _pool: Any = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.dataset_path and not self.id2info:
            with open(self.dataset_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    row.setdefault("task", "math")
                    self.id2info[str(row.get("query_id", row.get("id")))] = row

    def inference(
        self, model: Optional[Model], sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Scores every sequence; returns key 'rewards' (one scalar per
        sequence).  `model` supplies the tokenizer; no forward runs."""
        tokenizer = model.tokenizer if model is not None else None
        if tokenizer is None:
            raise ValueError("the reward interface needs a tokenizer")
        tokens = np.asarray(sample.data["packed_input_ids"])
        pmask = np.asarray(sample.data["prompt_mask"])
        bounds = sample.cu_seqlens("packed_input_ids")
        seqlens_r: List[List[int]] = []
        todo: List[Dict[str, Any]] = []
        si = 0
        for ei, group in enumerate(sample.seqlens["packed_input_ids"]):
            info = self.id2info.get(str(sample.ids[ei]), {})
            task = info.get("task", "math")
            seqlens_r.append([1] * len(group))
            for _ in group:
                lo, hi = bounds[si], bounds[si + 1]
                resp = tokens[lo:hi][~pmask[lo:hi].astype(bool)]
                todo.append({
                    "task": self.reward_backend or task,
                    "text": tokenizer.decode(resp.tolist()),
                    "payload": {
                        "solutions": info.get("solutions") or [],
                        "input_output": info.get("input_output"),
                        "choices": info.get("choices"),
                        "reference": info.get("reference"),
                        "timeout_s": self.code_timeout_s,
                    },
                })
                si += 1
        if self.verifier_pool:
            oks = self._verifier_pool().verify_batch(todo)
        elif self.remote_url:
            from areal_tpu_torch.interfaces.reward_service import RemoteVerifier

            oks = RemoteVerifier(self.remote_url, timeout_s=self.remote_timeout_s
                                 ).verify_batch(todo)
        else:
            oks = [self.verify(it["task"], it["text"], it["payload"]) for it in todo]
        rewards = [self.reward_value if ok else -self.reward_value for ok in oks]
        logger.info(f"reward verification: {sum(map(int, oks))}/{len(rewards)} correct")
        return SequenceSample(
            keys={"rewards"},
            ids=list(sample.ids),
            seqlens={"rewards": seqlens_r},
            data={"rewards": np.asarray(rewards, np.float32)},
        )

    def _verifier_pool(self):
        """The fleet-discovering pool client, built once an interface, so
        its breakers and membership view outlive an inference call."""
        if self._pool is None:
            from areal_tpu_torch.system.verifier_pool import VerifierPool, verifier_discovery

            if not (self.pool_experiment and self.pool_trial):
                raise ValueError("verifier_pool=True needs pool_experiment and pool_trial to "
                                 "discover the announced fleet")
            self._pool = VerifierPool(
                discovery=verifier_discovery(self.pool_experiment, self.pool_trial),
                attempt_timeout_s=self.pool_attempt_timeout_s,
            )
        return self._pool

    def verify(self, task: str, text: str, info: Dict[str, Any]) -> bool:
        """Grade one response for `task` through the verifier registry
        (the graders the reward service runs)."""
        from areal_tpu_torch.interfaces import reward_service

        payload = dict(info)
        payload.setdefault("timeout_s", self.code_timeout_s)
        return reward_service.grade_item(
            {"task": self.reward_backend or task, "text": text, "payload": payload}
        )


register_interface("rw-math-code", MultiTaskRewardInterface)
