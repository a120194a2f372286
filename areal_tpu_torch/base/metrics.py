"""In-process metrics registry (a trimmed port of areal_tpu/base/metrics.py):
Counter, Gauge and Histogram with labeled series, get-or-create
registration and Prometheus text exposition (`Registry.expose`).

Only what the episode plane and the generation server use is here; the
`/metrics` endpoint, the ring-buffer scrapes and the enable switch come
with ROADMAP queue 1 item 7.  Metric names follow the JAX package's:
``areal_[a-z0-9_]+``, counters end in ``_total``.
"""

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
)

# Distinct label sets per metric before new sets share one overflow
# series: a caller interpolating ids into labels cannot grow the
# registry without bound.
MAX_LABEL_SETS = 128


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names, values, extra=()) -> str:
    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    parts = [f'{k}="{esc(v)}"' for k, v in list(zip(names, values)) + list(extra)]
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def get(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # the last is +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect_left(self._buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[int, ...], float, int]:
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    def get(self) -> float:  # a histogram's value is its count
        with self._lock:
            return float(self._count)


class _Metric:
    kind = "untyped"
    child_cls: type = _Child

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._overflow: Optional[object] = None
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self.child_cls()

    def labels(self, *labelvalues):
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name} expects labels {self.labelnames}, got {key}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_LABEL_SETS:
                    if self._overflow is None:
                        self._overflow = self._make_child()
                        self._children[("_overflow",) * len(key)] = self._overflow
                    return self._overflow
                child = self._children[key] = self._make_child()
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; call .labels() first")
        return self._children[()]

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Metric):
    kind = "counter"
    child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def get(self) -> float:
        return self._default().get()


class Gauge(_Metric):
    kind = "gauge"
    child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def get(self) -> float:
        return self._default().get()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(float(x) for x in buckets if math.isfinite(x)))
        if not self.buckets:
            raise ValueError(f"{name}: a histogram needs at least one finite bucket")
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class Registry:
    """Get-or-create home of a process's metrics: registering the same
    spec twice returns the first metric, a conflicting spec raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, labelnames: Sequence[str], **kw):
        if not _NAME_RE.match(name) or not all(_NAME_RE.match(n) for n in labelnames):
            raise ValueError(f"bad metric or label name in {name!r} {tuple(labelnames)}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a conflicting spec "
                        f"(was {existing.kind}{existing.labelnames})"
                    )
                return existing
            m = self._metrics[name] = cls(name, help, labelnames, **kw)
            return m

    def counter(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
        if not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end in _total")
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str, labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text format 0.0.4."""
        out: List[str] = []
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m.children():
                if isinstance(m, Histogram):
                    counts, s, n = child.snapshot()
                    acc = 0
                    for ub, c in zip(m.buckets, counts):
                        acc += c
                        lbl = _fmt_labels(m.labelnames, key, [("le", _fmt_value(ub))])
                        out.append(f"{m.name}_bucket{lbl} {acc}")
                    lbl = _fmt_labels(m.labelnames, key, [("le", "+Inf")])
                    out.append(f"{m.name}_bucket{lbl} {n}")
                    plain = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}_sum{plain} {_fmt_value(s)}")
                    out.append(f"{m.name}_count{plain} {n}")
                else:
                    lbl = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}{lbl} {_fmt_value(child.get())}")
        return "\n".join(out) + "\n"


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry()
        return _default
