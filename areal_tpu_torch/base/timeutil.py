"""Frequency control for the save and recover-checkpoint cadence (port of
areal_tpu/base/timeutil.py `FrequencyControl`).

The master asks its controls once per finished step whether a persistent
save or a recover checkpoint is due; a recover checkpoint stores each
control's `state_dict`, so a resumed trial keeps its cadence.
"""

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FrequencyControl:
    """Triggers when any of the configured frequencies elapses.

    check() returns True if (a) `frequency_steps` steps have accumulated,
    (b) `frequency_epochs` epochs have completed, or (c) `frequency_seconds`
    wall-clock seconds have passed since the last trigger.  A frequency of
    None disables that criterion; if all are None, check() never triggers.
    """

    frequency_steps: Optional[int] = None
    frequency_epochs: Optional[int] = None
    frequency_seconds: Optional[float] = None
    initial_value: bool = False

    def __post_init__(self):
        self._last_time = time.monotonic()
        self._steps = 0
        self._epochs = 0
        self._pending_initial = self.initial_value

    def state_dict(self) -> dict:
        return {
            "steps": self._steps,
            "epochs": self._epochs,
            "elapsed": time.monotonic() - self._last_time,
            "pending_initial": self._pending_initial,
        }

    def load_state_dict(self, state: dict) -> None:
        self._steps = state["steps"]
        self._epochs = state["epochs"]
        self._last_time = time.monotonic() - state["elapsed"]
        self._pending_initial = state.get("pending_initial", False)

    def check(self, steps: int = 1, epochs: int = 0) -> bool:
        if self._pending_initial:
            self._pending_initial = False
            self._reset()
            return True
        self._steps += steps
        self._epochs += epochs
        triggered = False
        if self.frequency_steps is not None and self._steps >= self.frequency_steps:
            triggered = True
        if self.frequency_epochs is not None and self._epochs >= self.frequency_epochs:
            triggered = True
        if (
            self.frequency_seconds is not None
            and time.monotonic() - self._last_time >= self.frequency_seconds
        ):
            triggered = True
        if triggered:
            self._reset()
        return triggered

    def _reset(self):
        self._steps = 0
        self._epochs = 0
        self._last_time = time.monotonic()
