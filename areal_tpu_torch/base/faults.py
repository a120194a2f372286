"""Fault injection at named points (a trimmed port of
areal_tpu/base/faults.py): the spec grammar, `FaultInjector.parse`,
`from_env`, `fire`, and the kill checks `kill_point` and `kill_due`.

    AREAL_FAULTS="error@point=tool:calculator&times=1"  # break one tool call
    AREAL_FAULTS="slow@ms=50&p=0.5, error@p=0.05"       # combined

Grammar (commas or whitespace separate faults; ``&`` separates params)::

    FAULT := KIND ["@" PARAM ("&" PARAM)*]      PARAM := KEY "=" VALUE
    KIND  := kill | hang | slow | error | nan | corrupt_push

Params: ``t`` (arm delay: seconds, or with an ``s``/``ms`` suffix),
``p`` (per-call probability), ``ms`` (the latency of ``slow``),
``point`` (one injection point; default all), ``skip`` (ignore the
first N matching calls), ``times`` (fire at most N times, 0 =
unlimited).  At a ``fire(point)`` call ``slow`` sleeps, ``error`` raises
:class:`FaultError` and ``hang`` blocks until :meth:`release` or its
cap.  ``kill`` never fires there: the host asks `kill_point(point)` (a
point-scoped kill, skip and times counted) or `kill_due()` (a kill
without a point, once its arm delay has passed) and exits itself.  The
poison kinds (``nan``, ``corrupt_push``) parse, and their check
`poison` comes with ROADMAP queue 1 item 7.6.  `fired` counts the
faults that fired, by kind.  The probability stream is seeded from
``AREAL_FAULTS_SEED`` (default 0).
"""

import dataclasses
import logging
import os
import random
import re
import threading
import time
from typing import Callable, List, Optional, Sequence

logger = logging.getLogger("areal_tpu_torch.faults")

KINDS = ("kill", "hang", "slow", "error", "nan", "corrupt_push")
PASSIVE_KINDS = ("kill", "nan", "corrupt_push")
POISON_KINDS = ("nan", "corrupt_push")
ENV_SPEC = "AREAL_FAULTS"
ENV_SEED = "AREAL_FAULTS_SEED"


class FaultError(RuntimeError):
    """Raised at an injection point by an ``error`` fault (and by a
    ``hang`` that was released or hit its cap)."""


_DURATION_RE = re.compile(r"^(?P<num>[0-9]*\.?[0-9]+)(?P<unit>ms|s)?$")


def _parse_duration_s(text: str) -> float:
    m = _DURATION_RE.match(text.strip())
    if not m:
        raise ValueError(f"unparseable duration {text!r} (want e.g. 5s, 500ms, 2.5)")
    v = float(m.group("num"))
    return v / 1000.0 if m.group("unit") == "ms" else v


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    arm_after_s: float = 0.0
    prob: float = 1.0
    latency_s: float = 0.0
    point: str = ""
    skip: int = 0
    times: int = 0

    def matches(self, point: str, elapsed_s: float) -> bool:
        if elapsed_s < self.arm_after_s:
            return False
        return not self.point or self.point == point


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse a fault spec, validating every clause up front: an error
    names the clause at fault."""
    specs: List[FaultSpec] = []
    for raw in re.split(r"[,\s]+", text.strip()):
        if not raw:
            continue
        kind, _, params = raw.partition("@")
        if kind not in KINDS:
            raise ValueError(f"bad fault clause {raw!r}: unknown kind {kind!r} (one of {KINDS})")
        kw = dict(kind=kind)
        for param in params.split("&") if params else ():
            key, sep, val = param.partition("=")
            if not sep:
                raise ValueError(
                    f"bad fault clause {raw!r}: malformed param {param!r} (want KEY=VALUE)"
                )
            try:
                if key == "t":
                    kw["arm_after_s"] = _parse_duration_s(val)
                elif key == "p":
                    kw["prob"] = float(val)
                    if not 0.0 <= kw["prob"] <= 1.0:
                        raise ValueError(f"probability {val!r} out of [0, 1]")
                elif key == "ms":
                    kw["latency_s"] = float(val) / 1000.0
                elif key == "point":
                    kw["point"] = val
                elif key in ("skip", "times"):
                    kw[key] = int(val)
                    if kw[key] < 0:
                        raise ValueError(f"{key} must be >= 0, got {val!r}")
                else:
                    raise ValueError(
                        f"unknown param {key!r} (one of t, p, ms, point, skip, times)"
                    )
            except ValueError as e:
                if raw in str(e):
                    raise
                raise ValueError(f"bad fault clause {raw!r}: {e}") from None
        if kind != "slow" and kw.get("latency_s"):
            raise ValueError(f"bad fault clause {raw!r}: ms= only applies to slow")
        if kind in POISON_KINDS and not kw.get("point"):
            raise ValueError(
                f"bad fault clause {raw!r}: {kind} needs point= (a data boundary)"
            )
        specs.append(FaultSpec(**kw))
    if not specs:
        raise ValueError(f"empty fault spec {text!r}")
    return specs


class FaultInjector:
    """Applies a list of :class:`FaultSpec` at named injection points;
    thread-safe (`fire` is called from request and tool threads)."""

    def __init__(self, specs: Sequence[FaultSpec], seed: Optional[int] = None,
                 hang_max_s: float = 300.0,
                 on_fire: Optional[Callable[[str], None]] = None):
        self.specs = list(specs)
        # The host (a generation server) counts fired faults by kind.
        self.on_fire = on_fire
        if seed is None:
            seed = int(os.environ.get(ENV_SEED, "0"))
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.hang_max_s = hang_max_s
        self._released = threading.Event()
        self._t0 = time.monotonic()
        self._match_counts = {}
        self.fired = {k: 0 for k in KINDS}
        self._kill_reported = False

    @classmethod
    def parse(cls, text: str, **kw) -> "FaultInjector":
        return cls(parse_faults(text), **kw)

    @classmethod
    def from_env(cls, environ=None, **kw) -> Optional["FaultInjector"]:
        """Injector from ``AREAL_FAULTS``, or None when it is unset or empty."""
        spec = (environ or os.environ).get(ENV_SPEC, "").strip()
        return cls.parse(spec, **kw) if spec else None

    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def _record(self, kind: str) -> None:
        self.fired[kind] += 1
        if self.on_fire is not None:
            self.on_fire(kind)

    def _eligible(self, idx: int, spec: FaultSpec) -> bool:
        """Count the matching call and apply skip, times and p: the spec
        may fire on call numbers (skip, skip + times]."""
        with self._lock:
            n = self._match_counts[idx] = self._match_counts.get(idx, 0) + 1
            if n <= spec.skip or (spec.times and n > spec.skip + spec.times):
                return False
            return spec.prob >= 1.0 or self._rng.random() < spec.prob

    def fire(self, point: str) -> None:
        """Apply every armed active fault matching ``point``: may sleep
        (``slow``), block (``hang``) or raise :class:`FaultError`
        (``error``); returns normally when nothing fires."""
        elapsed = self.elapsed_s()
        for i, s in enumerate(self.specs):
            if s.kind in PASSIVE_KINDS or not s.matches(point, elapsed):
                continue
            if not self._eligible(i, s):
                continue
            self._record(s.kind)
            if s.kind == "slow":
                time.sleep(s.latency_s)
            elif s.kind == "hang":
                logger.warning(f"FAULT hang at point {point!r}")
                if not self._released.wait(timeout=self.hang_max_s):
                    raise FaultError(
                        f"hang fault at {point!r} exceeded the {self.hang_max_s}s safety cap"
                    )
                raise FaultError(f"hang fault at {point!r} released")
            elif s.kind == "error":
                raise FaultError(f"injected error at {point!r}")

    @property
    def kill_spec(self) -> Optional[FaultSpec]:
        """The first ``kill`` without a point (point-scoped kills go
        through `kill_point`, never through the host's timer)."""
        for s in self.specs:
            if s.kind == "kill" and not s.point:
                return s
        return None

    def kill_due(self) -> bool:
        """True once a point-less ``kill``'s arm delay has passed.  The
        host polls this and exits itself; the injector never does."""
        s = self.kill_spec
        due = s is not None and self.elapsed_s() >= s.arm_after_s
        if due and not self._kill_reported:
            self._kill_reported = True
            self._record("kill")
        return due

    def kill_point(self, point: str) -> bool:
        """True when a point-scoped ``kill`` matches this call (skip,
        times and p counted): the host exits itself (``os._exit``)."""
        elapsed = self.elapsed_s()
        for i, s in enumerate(self.specs):
            if s.kind != "kill" or not s.point or not s.matches(point, elapsed):
                continue
            if not self._eligible(i, s):
                continue
            self._record("kill")
            logger.warning(f"FAULT kill at point {point!r}")
            return True
        return False

    def release(self) -> None:
        """Unblock every ``hang`` in flight."""
        self._released.set()
