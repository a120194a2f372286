"""The live metrics plane (port of areal_tpu/base/metrics.py): an
in-process registry of Counter, Gauge and Histogram with labeled series,
Prometheus text exposition, a ring-buffer view of the last scrapes of
each series, and the ``GET /metrics`` server every process role runs.

- Registration is get-or-create: registering an identical spec again
  returns the first metric, a conflicting spec (type, label names or
  buckets) raises.  Names follow the JAX package's: ``areal_[a-z0-9_]+``,
  counters end in ``_total``.
- ``AREAL_METRICS=0`` (or `configure(enabled=False)`) turns every
  child's ``inc``, ``set`` and ``observe`` into one branch that does
  nothing; when on, each child series holds its own short lock.
- `Registry.expose` renders Prometheus text format 0.0.4, byte for byte
  the JAX package's for the same operations.
- `Registry.scrape` appends every series to a ring buffer
  (``deque(maxlen=window)``); `Registry.window(name, labels)` returns
  the retained ``(timestamp, value)`` points.
- `MetricsServer` serves ``GET /metrics`` and announces its URL under
  ``names.metrics_endpoint`` so `apps/metrics_report.py` finds every
  role of a trial; `close` deletes the key.
- `parse_prometheus_text` and `quantile_from_buckets` read exposition
  text back (the metrics report and the tests).
"""

from __future__ import annotations

import http.server
import math
import os
import re
import socket
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "MetricsServer",
    "default_registry",
    "enabled",
    "configure",
    "parse_prometheus_text",
    "quantile_from_buckets",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# Latency-ish default, in seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
)

# Distinct label-sets allowed per metric before new sets collapse into a
# shared overflow child (a hot path must never be able to OOM the
# registry by interpolating request ids into labels).
MAX_LABEL_SETS = 128


class _State:
    """Process-wide enable flag, consulted on every hot-path op."""

    def __init__(self) -> None:
        self.on = os.environ.get("AREAL_METRICS", "1") not in ("0", "false", "")


_state = _State()


def enabled() -> bool:
    return _state.on


def configure(enabled: Optional[bool] = None) -> None:
    """Flip the metrics plane at runtime (tests / overhead A-B legs)."""
    if enabled is not None:
        _state.on = bool(enabled)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    parts = [
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in zip(labelnames, labelvalues)
    ]
    parts += [f'{k}="{_escape_label_value(str(v))}"' for k, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series; holds the only lock touched on the hot path."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def get(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if not _state.on:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        if not _state.on:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _state.on:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets  # finite upper bounds, sorted
        self._counts = [0] * (len(buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not _state.on:
            return
        i = bisect_left(self._buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[int, ...], float, int]:
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    def get(self) -> float:  # uniform accessor: a histogram "value" is
        with self._lock:     # its observation count
            return float(self._count)


class _Metric:
    """Base for the three metric families; manages labeled children."""

    kind = "untyped"
    child_cls: type = _Child

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()  # child-map lock, not hot path
        self._children: Dict[Tuple[str, ...], object] = {}
        self._overflow: Optional[object] = None
        self.dropped_label_sets = 0
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self.child_cls()

    def labels(self, *labelvalues, **labelkv):
        if labelkv:
            if labelvalues:
                raise ValueError("pass labels positionally or by name, not both")
            try:
                labelvalues = tuple(labelkv[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"unknown label {e} for {self.name}") from None
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {key}"
            )
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_LABEL_SETS:
                    # Cardinality guard: collapse into one overflow
                    # series instead of growing without bound.
                    self.dropped_label_sets += 1
                    if self._overflow is None:
                        self._overflow = self._make_child()
                        self._children[
                            ("_overflow",) * len(self.labelnames)
                        ] = self._overflow
                    return self._overflow
                child = self._make_child()
                self._children[key] = child
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels() first"
            )
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
        b = tuple(sorted(float(x) for x in buckets if math.isfinite(x)))
        if not b:
            raise ValueError(f"{name}: histogram needs >= 1 finite bucket")
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def snapshot(self) -> Tuple[Tuple[int, ...], float, int]:
        return self._default().snapshot()


class Registry:
    """Get-or-create home for every metric of a process role."""

    def __init__(self, window: int = 64) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._window = int(window)
        # (name, label-tuple) -> deque[(timestamp, value)]
        self._rings: Dict[Tuple[str, Tuple[str, ...]], deque] = {}
        self.scrapes = 0

    # -- registration ---------------------------------------------------
    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                spec_ok = (
                    type(existing) is cls
                    and existing.labelnames == tuple(labelnames)
                    and (not kw.get("buckets")
                         or existing.buckets
                         == tuple(sorted(float(x) for x in kw["buckets"]
                                         if math.isfinite(x))))
                )
                if not spec_ok:
                    raise ValueError(
                        f"metric {name!r} re-registered with a conflicting "
                        f"spec (was {existing.kind}{existing.labelnames})"
                    )
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        if not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end in _total")
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exposition -----------------------------------------------------
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
                        lbl = _fmt_labels(m.labelnames, key,
                                          extra=[("le", _fmt_value(ub))])
                        out.append(f"{m.name}_bucket{lbl} {acc}")
                    lbl = _fmt_labels(m.labelnames, key, extra=[("le", "+Inf")])
                    out.append(f"{m.name}_bucket{lbl} {n}")
                    plain = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}_sum{plain} {_fmt_value(s)}")
                    out.append(f"{m.name}_count{plain} {n}")
                else:
                    lbl = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}{lbl} {_fmt_value(child.get())}")
        return "\n".join(out) + "\n"

    # -- ring-buffer time series ----------------------------------------
    def scrape(self, now: Optional[float] = None) -> Dict[
            Tuple[str, Tuple[str, ...]], float]:
        """Snapshot every series and append to its ring buffer.

        Histograms contribute ``<name>_count`` and ``<name>_sum`` series
        (bucket vectors stay exposition-only — windows hold scalars).
        """
        t = time.time() if now is None else now
        snap: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, child in m.children():
                if isinstance(m, Histogram):
                    _, s, n = child.snapshot()
                    snap[(m.name + "_count", key)] = float(n)
                    snap[(m.name + "_sum", key)] = float(s)
                else:
                    snap[(m.name, key)] = child.get()
        with self._lock:
            self.scrapes += 1
            for sk, v in snap.items():
                ring = self._rings.get(sk)
                if ring is None:
                    ring = self._rings[sk] = deque(maxlen=self._window)
                ring.append((t, v))
        return snap

    def window(self, name: str,
               labels: Sequence[str] = ()) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._rings.get((name, tuple(str(v) for v in labels)))
            return list(ring) if ring else []

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._rings.clear()
            self.scrapes = 0


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry()
    return _default


def _reset_default_for_tests() -> None:
    global _default
    with _default_lock:
        _default = None


# ---------------------------------------------------------------------------
# HTTP exposition


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: Registry = None  # type: ignore[assignment]

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.split("?")[0] in ("/metrics", "/"):
            body = self.server.registry.expose().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, *a):  # silence per-scrape stderr spam
        pass


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Serve ``GET /metrics`` for one process role.

    Optionally announces its URL into name_resolve (under
    ``names.metrics_endpoint``) so ``apps/metrics_report.py`` can
    discover every role of a trial.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 announce: Optional[Tuple[str, str, str]] = None) -> None:
        self.registry = registry or default_registry()
        self._srv = _HTTPServer((host, port), _MetricsHandler)
        self._srv.registry = self.registry
        self.host, self.port = self._srv.server_address[:2]
        if self.host in ("0.0.0.0", "::"):
            self.host = socket.gethostbyname(socket.gethostname())
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()
        self._announced: Optional[str] = None
        if announce is not None:
            self.announce(*announce)

    def announce(self, experiment: str, trial: str, role: str) -> None:
        from areal_tpu_torch.base import name_resolve, names

        key = names.metrics_endpoint(experiment, trial, role)
        name_resolve.add(key, self.url, replace=True, delete_on_exit=True)
        self._announced = key

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:
            pass
        if self._announced:
            from areal_tpu_torch.base import name_resolve

            try:
                name_resolve.delete(self._announced)
            except Exception:
                pass
            self._announced = None


# ---------------------------------------------------------------------------
# Parsing (for metrics_report / tests; round-trips expose())


def parse_prometheus_text(text: str) -> Tuple[
        List[Tuple[str, Dict[str, str], float]], Dict[str, str]]:
    """Parse exposition text into ``(samples, types)``.

    samples: list of (metric_name, labels_dict, value); types maps family
    name -> kind from ``# TYPE`` lines.  Raises ValueError on malformed
    sample lines (the smoke check's "text parses" assertion).
    """
    samples: List[Tuple[str, Dict[str, str], float]] = []
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$", line
        )
        if not m:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, _, labelstr, valstr = m.groups()
        labels: Dict[str, str] = {}
        if labelstr:
            for lm in re.finditer(
                r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"', labelstr
            ):
                labels[lm.group(1)] = (
                    lm.group(2)
                    .replace('\\"', '"')
                    .replace("\\n", "\n")
                    .replace("\\\\", "\\")
                )
        try:
            value = float(valstr)
        except ValueError:
            raise ValueError(f"bad sample value in line: {raw!r}") from None
        samples.append((name, labels, value))
    return samples, types


def quantile_from_buckets(
    bucket_samples: Iterable[Tuple[float, float]], q: float
) -> float:
    """Estimate a quantile from cumulative (le_upper_bound, count) pairs.

    Linear interpolation within the winning bucket, Prometheus
    ``histogram_quantile`` style; returns the bucket bound for +Inf.
    """
    pts = sorted(bucket_samples, key=lambda x: x[0])
    if not pts:
        return float("nan")
    total = pts[-1][1]
    if total <= 0:
        return float("nan")
    rank = q * total
    prev_ub, prev_c = 0.0, 0.0
    for ub, c in pts:
        if c >= rank:
            if math.isinf(ub):
                return prev_ub
            if c == prev_c:
                return ub
            frac = (rank - prev_c) / (c - prev_c)
            return prev_ub + (ub - prev_ub) * frac
        prev_ub, prev_c = (0.0 if math.isinf(ub) else ub), c
    return pts[-1][0]
