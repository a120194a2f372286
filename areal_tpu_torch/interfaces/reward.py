"""Verification-based rewards (port of areal_tpu/interfaces/reward.py,
`MultiTaskRewardInterface`).

Each sequence is dispatched by its task metadata, its response decoded
and graded, and scored ±`reward_value` (one scalar per sequence).  An
item travels in the reward service's opaque schema (``{"task", "text",
"payload"}``) and is graded by the verifier registry
(`interfaces/reward_service.grade_item`: math, code, judge) in this
process, or with `remote_url` by a reward service over HTTP, with local
fallback.  Code grading runs the response's last fenced program on each
test input in the sandbox (`interfaces/sandbox.run_sandboxed`).  The
verifier fleet (`verifier_pool`) is ROADMAP queue 1 item 7.5."""

import dataclasses
import json
import logging
import os
import re
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface

logger = logging.getLogger("areal_tpu_torch.reward")


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
    verifier_pool: bool = False

    def __post_init__(self):
        if self.verifier_pool:
            raise NotImplementedError(
                "grading through the verifier fleet is not yet ported (ROADMAP queue 1, "
                "item 7.5: the fleet); set remote_url for one reward service"
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
        if self.remote_url:
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

    def verify(self, task: str, text: str, info: Dict[str, Any]) -> bool:
        """Grade one response for `task` through the verifier registry
        (the graders the reward service runs)."""
        from areal_tpu_torch.interfaces import reward_service

        payload = dict(info)
        payload.setdefault("timeout_s", self.code_timeout_s)
        return reward_service.grade_item(
            {"task": self.reward_backend or task, "text": text, "payload": payload}
        )


def verify_code(text: str, io_spec, timeout_s: float = 8.0) -> bool:
    """Run the response's last fenced program on each test input in the
    sandbox (rlimits, a temporary dir as its jail, a network namespace
    where the host allows one; `interfaces/sandbox.py`); pass iff every
    run exits 0 with the expected stdout (whitespace-trimmed).
    `io_spec`: {"inputs": [...], "outputs": [...]} or its JSON."""
    from areal_tpu_torch.interfaces.sandbox import run_sandboxed

    prog = _extract_code_block(text)
    if prog is None:
        return False
    try:
        io_spec = json.loads(io_spec) if isinstance(io_spec, str) else io_spec
        inputs, outputs = io_spec["inputs"], io_spec["outputs"]
    except (KeyError, TypeError, json.JSONDecodeError):
        return False
    with tempfile.TemporaryDirectory(prefix="areal_torch_grade_") as jail:
        path = os.path.join(jail, "prog.py")
        with open(path, "w") as f:
            f.write(prog)
        for inp, expected in zip(inputs, outputs):
            rc, stdout = run_sandboxed(
                [sys.executable, path], input_text=inp, timeout_s=timeout_s, cwd=jail,
            )
            if rc != 0 or stdout.strip() != expected.strip():
                return False
    return True


def _extract_code_block(text: str) -> Optional[str]:
    blocks = re.findall(r"```(?:python)?\n(.*?)```", text, flags=re.DOTALL)
    return blocks[-1] if blocks else None


register_interface("rw-math-code", MultiTaskRewardInterface)
