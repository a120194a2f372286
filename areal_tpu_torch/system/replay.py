"""The replay record (a trimmed port of areal_tpu/system/replay.py): only
`Trajectory`, the record `Episode.to_trajectory` returns.  The
staleness-bounded `ReplayBuffer` comes with ROADMAP queue 1 item 7."""

import dataclasses
from typing import Any


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
    t_dispatch: float = 0.0
    task: str = ""

    def staleness(self, trainer_version: int) -> int:
        return trainer_version - self.version_start
