"""The generation fleet's circuit breaker (a trimmed port of
areal_tpu/system/fleet.py: `CircuitBreaker`, which the rollout
controller keeps for each server).  The fleet's dynamic discovery, its
supervisor and its lanes come with ROADMAP queue 1 item 7.5."""

import time
from typing import Callable, Optional


class CircuitBreaker:
    """Consecutive-failure circuit breaker for one generation server.

    closed --(threshold consecutive failures)--> open
    open   --(cooldown elapsed; next probe)----> half_open
    half_open --success--> closed;  --failure--> open (fresh cooldown)
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        on_transition: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.on_transition = on_transition
        self._clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opens = 0  # times the breaker tripped open
        self.closes = 0  # times a probe closed it again
        self._opened_at = 0.0

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if state == self.OPEN:
            self.opens += 1
            self._opened_at = self._clock()
        elif state == self.CLOSED:
            self.closes += 1
        if self.on_transition is not None:
            self.on_transition(state)

    def allow_dispatch(self) -> bool:
        """Only a closed breaker takes regular dispatches; a half-open one
        admits only the probe, which rides the health poll."""
        return self.state == self.CLOSED

    def probe_due(self) -> bool:
        return self.state == self.OPEN and self._clock() - self._opened_at >= self.cooldown_s

    def begin_probe(self) -> None:
        self._to(self.HALF_OPEN)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._to(self.CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or (
            self.state == self.CLOSED and self.consecutive_failures >= self.threshold
        ):
            self._to(self.OPEN)
        elif self.state == self.OPEN:
            # A failure while open (a straggler dispatch) re-arms the
            # cooldown, so the probe waits for quiet.
            self._opened_at = self._clock()
