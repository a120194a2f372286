"""Verification-based rewards (port of the in-process math branch of
areal_tpu/interfaces/reward.py, `MultiTaskRewardInterface`).

Each sequence is dispatched by its task metadata, its response decoded
and graded, and scored ±`reward_value` (one scalar per sequence).  Only
math grading in-process is ported; code and judge grading, the remote
reward service and the verifier fleet raise NotImplementedError."""

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface
from areal_tpu_torch.interfaces import math_verify


def _row_is_choice(info: Dict[str, Any]) -> Optional[bool]:
    """Row-level multiple-choice evidence: an explicit flag or a rendered
    `choices` list decides; absent both, the gold string does."""
    if info.get("is_choice") is not None:
        return bool(info["is_choice"])
    if "choices" in info and info["choices"] is not None:
        return bool(info["choices"])
    return None


@dataclasses.dataclass
class MultiTaskRewardInterface(ModelInterface):
    """id2info maps query_id -> the dataset row (task, solutions, ...)."""

    id2info: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    dataset_path: Optional[str] = None
    reward_value: float = 5.0
    remote_url: Optional[str] = None
    reward_backend: str = ""
    verifier_pool: bool = False

    def __post_init__(self):
        if self.remote_url or self.verifier_pool:
            raise NotImplementedError(
                "remote and fleet reward grading are not yet ported"
            )
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
        rewards: List[float] = []
        si = 0
        for ei, group in enumerate(sample.seqlens["packed_input_ids"]):
            info = self.id2info.get(str(sample.ids[ei]), {})
            task = self.reward_backend or info.get("task", "math")
            seqlens_r.append([1] * len(group))
            for _ in group:
                lo, hi = bounds[si], bounds[si + 1]
                resp = tokens[lo:hi][~pmask[lo:hi].astype(bool)]
                ok = self.verify(task, tokenizer.decode(resp.tolist()), info)
                rewards.append(self.reward_value if ok else -self.reward_value)
                si += 1
        return SequenceSample(
            keys={"rewards"},
            ids=list(sample.ids),
            seqlens={"rewards": seqlens_r},
            data={"rewards": np.asarray(rewards, np.float32)},
        )

    def verify(self, task: str, text: str, info: Dict[str, Any]) -> bool:
        """Grade one response for `task` (math only)."""
        if task != "math":
            raise NotImplementedError(f"{task!r} grading is not yet ported")
        return bool(math_verify.verify_math(
            text, info.get("solutions") or [], is_choice=_row_is_choice(info),
        ))


register_interface("rw-math-code", MultiTaskRewardInterface)
