"""Distributed span tracer (port of areal_tpu/base/tracer.py): a
Chrome/Perfetto timeline for every process of a trial.

Each process (master, model workers, generation servers, the reward
service, verifiers) records spans into per-thread ring buffers and
flushes them to its own ``trace_<role>_<rank>.jsonl`` shard;
:func:`merge_shards` aligns the shards' monotonic clocks through the
(monotonic, epoch) pair stamped in each shard's meta line and emits one
Perfetto-loadable ``trace.json``: a track a process, a lane a thread,
counter tracks for sampled gauges.  The shard and flight-dump files are
the JAX package's, byte for byte, so either package's ``trace_report``
reads a fleet that mixes both.

Design constraints:
- Zero overhead when disabled: ``span()`` returns a no-op context
  manager after one bool check: no clock read, no buffer traffic, and
  never a device synchronization.
- No locks on the hot path: each thread appends to its own
  ``collections.deque(maxlen=...)`` (GIL-atomic); the registry lock is
  taken once a thread's lifetime and once a flush.
- Spans yield a MUTABLE args dict, so callers attach values known only
  after the work ran (the worker fills tokens/TFLOPs/MFU).
- On the card the port's work is queued asynchronously: a span measures
  the host's time between its edges.  A ``compute`` span therefore ends
  where its code already waits for the device (a host read of the
  chunk's outputs, the static loop's done flag); a span's args carry
  Python numbers, and a CUDA tensor in them raises rather than
  synchronize in the flush.

Gating: ``AREAL_TRACE=1`` enables, ``AREAL_TRACE_DIR`` picks the shard
directory (the master defaults it to ``<fileroot>/logs/<exp>/<trial>/
trace`` and exports it, so spawned processes inherit it).

Usage::

    from areal_tpu_torch.base import tracer
    tracer.configure(role="worker", rank=3)
    with tracer.span("mfc:actor:train_step", cat="compute") as args:
        ...
        args["tflops"] = 1.23
    tracer.counter("kv_pool", live_tokens=512, allocated_tokens=4096)
    tracer.flush()

Categories drive the stall attribution of ``apps/trace_report.py``:
``compute`` (device work), ``comms`` (data and param movement and the
waits on it), ``host`` (CPU work: data loading, grading).
Uncategorized spans are timeline-only; step time no span covers is
idle.

Two planes ride on the span stream:

- **Causal lineage**: :func:`new_trace_id` mints a per-sample id at
  rollout dispatch; :func:`lineage` stamps ``lineage:<stage>`` instants
  (dispatch/first_token/generated/graded/admitted/trained) carrying the
  id through every process the sample touches.  The dispatch stamp is
  the *root* (``root=True``); :func:`validate_trace` rejects a child
  whose trace_id appears on no root.
- **Flight recorder**: an always-on bounded ring of recent structured
  events (span closures while tracing, and explicit
  :func:`flight_event` calls, which record even with ``AREAL_TRACE=0``).
  :func:`flight_dump` writes it as ``flightrec_<role>_<rank>.json`` next
  to the shards for ``trace_report --flight``; a process that ends by
  ``os._exit`` dumps before it exits, since ``atexit`` never runs.
"""

import atexit
import collections
import json
import os
import sys
import threading
import time
from time import perf_counter as _perf_counter
from typing import Any, Dict, List, Optional

# Per-thread ring capacity.  A step emits O(100) events per process;
# 65536 absorbs many steps between flushes before dropping the oldest.
_RING_CAP = 65536

# Flight-recorder ring: process-wide, always on.  Appends are GIL-atomic
# (no lock); 512 recent events is several seconds of fleet activity —
# enough context around a fault instant without unbounded memory.
_FLIGHT_CAP = 512

_lock = threading.Lock()
_buffers: List[collections.deque] = []  # every thread's ring, for flush
_flight: collections.deque = collections.deque(maxlen=_FLIGHT_CAP)
_tls = threading.local()

_state: Dict[str, Any] = {
    "enabled": False,
    "configured": False,
    "role": None,
    "rank": 0,
    "dir": None,
    "path": None,
    "file": None,
    "meta_written": False,
}
# This process's flushes: count, events written, seconds spent (the
# tracer's own cost, read by `flush_stats`).
_flush_acc = {"flushes": 0, "events": 0, "seconds": 0.0}


def _env_enabled() -> bool:
    return os.environ.get("AREAL_TRACE", "0") not in ("", "0")


def enabled() -> bool:
    return _state["enabled"]


def configure(
    role: str,
    rank: int = 0,
    dir: Optional[str] = None,
    enabled: Optional[bool] = None,
    force: bool = False,
) -> bool:
    """Set this process's trace identity and shard location.

    First configure wins (a library re-configuring must not steal the
    process's shard) unless ``force=True`` — tests use force to switch
    shards mid-process.  ``enabled=None`` reads AREAL_TRACE; an explicit
    bool overrides the env (tests, check_trace).  Returns the resulting
    enabled state."""
    with _lock:
        if _state["configured"] and not force:
            return _state["enabled"]
        if enabled is None:
            enabled = _env_enabled()
        if force:
            _close_file_locked()
            _state["meta_written"] = False
        _state["enabled"] = bool(enabled)
        _state["configured"] = True
        _state["role"] = str(role)
        _state["rank"] = int(rank)
        d = dir or os.environ.get("AREAL_TRACE_DIR")
        if d is None and enabled:
            import tempfile

            d = os.path.join(tempfile.gettempdir(), "areal_tpu_trace")
        _state["dir"] = d
        _state["path"] = (
            os.path.join(d, f"trace_{role}_{rank}.jsonl") if d else None
        )
        return _state["enabled"]


def default_dir(fileroot: str, experiment: str, trial: str) -> Optional[str]:
    """Resolve (and export) the trial's trace dir: AREAL_TRACE_DIR if the
    operator set one, else ``<fileroot>/logs/<exp>/<trial>/trace``.  The
    master calls this BEFORE workers start so scheduler-spawned processes
    inherit one shared dir via the environment.  No-op when disabled."""
    if not _env_enabled() and not _state["enabled"]:
        return None
    d = os.environ.get("AREAL_TRACE_DIR")
    if not d:
        d = os.path.join(fileroot, "logs", experiment, trial, "trace")
        os.environ["AREAL_TRACE_DIR"] = d
    return d


def shard_path() -> Optional[str]:
    return _state["path"]


# ---------------- hot path ----------------


def _buf() -> collections.deque:
    b = getattr(_tls, "buf", None)
    if b is None:
        b = collections.deque(maxlen=_RING_CAP)
        _tls.buf = b
        with _lock:
            _buffers.append(b)
    return b


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: Optional[str], args: Dict):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> Dict:
        self.t0 = time.monotonic_ns()
        return self.args

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        ev = {
            "ph": "X",
            "name": self.name,
            "ts": self.t0 // 1000,
            "dur": max((t1 - self.t0) // 1000, 1),
            "tid": threading.get_ident(),
        }
        if self.cat:
            ev["cat"] = self.cat
        if self.args:
            ev["args"] = self.args
        _buf().append(ev)
        _flight.append(
            {
                "t_us": int(time.time() * 1e6),
                "kind": "span",
                "name": self.name,
                "dur_us": ev["dur"],
                "tid": ev["tid"],
            }
        )
        return False


class _NoopSpan:
    """Shared disabled-path span: __enter__ hands back the caller's own
    args dict so post-hoc ``args[...] = v`` writes stay valid and cheap."""

    __slots__ = ("args",)

    def __init__(self, args: Dict):
        self.args = args

    def __enter__(self) -> Dict:
        return self.args

    def __exit__(self, *exc) -> bool:
        return False


def span(name: str, cat: Optional[str] = None, **args) -> Any:
    if not _state["enabled"]:
        return _NoopSpan(args)
    return _Span(name, cat, args)


def trace(name: Optional[str] = None, cat: Optional[str] = None):
    """Decorator form: @tracer.trace("load_data", cat="host")."""

    def deco(fn):
        import functools

        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not _state["enabled"]:
                return fn(*a, **kw)
            with span(label, cat=cat):
                return fn(*a, **kw)

        return wrapped

    return deco


def instant(name: str, **args) -> None:
    if not _state["enabled"]:
        return
    ev = {
        "ph": "i",
        "name": name,
        "ts": time.monotonic_ns() // 1000,
        "tid": threading.get_ident(),
        "s": "t",
    }
    if args:
        ev["args"] = args
    _buf().append(ev)


def counter(name: str, **values) -> None:
    """Sampled gauge: each kwarg becomes one series on the counter track
    (Perfetto ph="C")."""
    if not _state["enabled"]:
        return
    _buf().append(
        {
            "ph": "C",
            "name": name,
            "ts": time.monotonic_ns() // 1000,
            "args": values,
        }
    )


def complete(
    name: str,
    start_ns: int,
    end_ns: Optional[int] = None,
    cat: Optional[str] = None,
    **args,
) -> None:
    """Emit a span with an explicit start (for request lifetimes measured
    across threads, e.g. gen_server enqueue -> retire)."""
    if not _state["enabled"]:
        return
    if end_ns is None:
        end_ns = time.monotonic_ns()
    ev = {
        "ph": "X",
        "name": name,
        "ts": start_ns // 1000,
        "dur": max((end_ns - start_ns) // 1000, 1),
        "tid": threading.get_ident(),
    }
    if cat:
        ev["cat"] = cat
    if args:
        ev["args"] = args
    _buf().append(ev)


# ---------------- causal lineage ----------------


def new_trace_id() -> str:
    """Mint a per-sample lineage id (rollout dispatch is the root)."""
    import uuid

    return "tr-" + uuid.uuid4().hex[:16]


def lineage(stage: str, trace_id: str, root: bool = False, **args) -> None:
    """Stamp one lineage stage for ``trace_id`` in this process.

    Emits a ``lineage:<stage>`` instant into the trace stream (when
    enabled) so ``trace_report --lineage`` can join merged shards into a
    per-sample timeline, AND always records the stamp in the flight ring
    — a fault dump shows the victim's recent per-sample activity even
    with AREAL_TRACE=0.  ``root=True`` marks the minting stage
    (dispatch); every other stamp must share a root's trace_id or
    validate_trace flags it as an orphan."""
    if not trace_id:
        return
    if _state["enabled"]:
        a = {"trace_id": trace_id, "stage": stage}
        if root:
            a["root"] = True
        a.update(args)
        _buf().append(
            {
                "ph": "i",
                "name": f"lineage:{stage}",
                "cat": "lineage",
                "ts": time.monotonic_ns() // 1000,
                "tid": threading.get_ident(),
                "s": "t",
                "args": a,
            }
        )
    fe = {
        "t_us": int(time.time() * 1e6),
        "kind": "lineage",
        "stage": stage,
        "trace_id": trace_id,
    }
    fe.update(args)
    _flight.append(fe)


# ---------------- flight recorder ----------------


def flight_event(kind: str, **fields) -> None:
    """Record one structured event in the always-on flight ring (dispatch
    decisions, breaker transitions, quarantine verdicts, weight pushes).
    Costs one deque append; nothing is written until flight_dump()."""
    fe = {"t_us": int(time.time() * 1e6), "kind": kind}
    fe.update(fields)
    _flight.append(fe)


def flight_events() -> List[Dict[str, Any]]:
    """Snapshot the flight ring (oldest first)."""
    return list(_flight)


def flight_dump(
    reason: str,
    role: Optional[str] = None,
    rank: Optional[int] = None,
    dir: Optional[str] = None,
) -> Optional[str]:
    """Dump the flight ring as ``flightrec_<role>_<rank>.json`` next to
    the trace shards.  Called from fault paths (worker death, quarantine
    escalation, checksum-rejected push, chaos kill).  role/rank default
    to the tracer identity; dir falls back to the configured trace dir
    then AREAL_TRACE_DIR.  Returns the path, or None when no dump
    location is known."""
    d = dir or _state["dir"] or os.environ.get("AREAL_TRACE_DIR")
    if not d:
        return None
    role = role if role is not None else (_state["role"] or "proc")
    rank = rank if rank is not None else _state["rank"]
    path = os.path.join(d, f"flightrec_{role}_{rank}.json")
    doc = {
        "role": str(role),
        "rank": int(rank),
        "pid": os.getpid(),
        "reason": str(reason),
        "t_dump_us": int(time.time() * 1e6),
        "events": list(_flight),
    }
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, default=_json_default)
    except OSError:
        return None
    return path


def read_flight_dumps(trace_dir: str) -> List[Dict[str, Any]]:
    """Load every ``flightrec_*.json`` in ``trace_dir`` (unparseable or
    torn dumps are skipped)."""
    import glob

    dumps = []
    for path in sorted(
        glob.glob(os.path.join(trace_dir, "flightrec_*.json"))
    ):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            doc["path"] = path
            dumps.append(doc)
    return dumps


# ---------------- flush / shard IO ----------------


def _json_default(o):
    """numpy and CPU torch scalars and arrays -> JSON; a CUDA tensor
    raises: serializing it would synchronize the device."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(o, torch.Tensor):
        if o.is_cuda or o.device.type != "cpu":
            raise TypeError(
                "a device tensor in a trace event: pass a Python number taken "
                "where the code already reads the device"
            )
        return o.tolist()
    if type(o).__module__ == "numpy" and getattr(o, "ndim", 0) > 0:
        return o.tolist()
    try:
        return float(o)
    except Exception:
        return str(o)


def _close_file_locked() -> None:
    f = _state["file"]
    if f is not None:
        try:
            f.close()
        except Exception:
            pass
        _state["file"] = None


def flush() -> Optional[str]:
    """Drain every thread's ring into this process's shard file.  Safe to
    call from any thread; returns the shard path (None when disabled or
    unconfigured)."""
    if not _state["enabled"]:
        return None
    t0 = _perf_counter()
    with _lock:
        path = _state["path"]
        if path is None:
            return None
        if _state["file"] is None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _state["file"] = open(path, "a")
        f = _state["file"]
        if not _state["meta_written"]:
            # Paired clocks let the exporter shift this shard's monotonic
            # timestamps onto the shared epoch timeline.
            f.write(
                json.dumps(
                    {
                        "kind": "meta",
                        "role": _state["role"],
                        "rank": _state["rank"],
                        "pid": os.getpid(),
                        "mono_us": time.monotonic_ns() // 1000,
                        "epoch_us": int(time.time() * 1e6),
                    }
                )
                + "\n"
            )
            _state["meta_written"] = True
        n = 0
        for b in _buffers:
            while True:
                try:
                    ev = b.popleft()
                except IndexError:
                    break
                f.write(json.dumps(ev, default=_json_default) + "\n")
                n += 1
        f.flush()
        _flush_acc["flushes"] += 1
        _flush_acc["events"] += n
        _flush_acc["seconds"] += _perf_counter() - t0
        return path


def flush_stats() -> Dict[str, Any]:
    """This process's flushes so far: {"flushes", "events", "seconds"}."""
    return dict(_flush_acc)


def _reset_for_tests() -> None:
    """Disable tracing and drop all buffered events/identity (test
    isolation; not part of the public surface)."""
    with _lock:
        _close_file_locked()
        _state.update(
            enabled=False,
            configured=False,
            role=None,
            rank=0,
            dir=None,
            path=None,
            meta_written=False,
        )
        for b in _buffers:
            b.clear()
        _flight.clear()
        _flush_acc.update(flushes=0, events=0, seconds=0.0)


atexit.register(flush)


# ---------------- exporter ----------------


def read_shard(path: str):
    """-> (meta dict or None, [event dicts])."""
    meta = None
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn tail line from a killed process
            if row.get("kind") == "meta":
                if meta is None:
                    meta = row
                continue
            events.append(row)
    return meta, events


def merge_shards(
    trace_dir: str, out_path: Optional[str] = None
) -> Dict[str, Any]:
    """Merge every ``trace_*.jsonl`` shard in ``trace_dir`` into one
    Chrome/Perfetto trace object (and write it to ``out_path`` when
    given).  Per shard: timestamps shift from its monotonic clock onto
    the epoch timeline (meta's paired clocks), events get the shard's
    pid, and a process_name metadata event labels the track
    ``<role>_<rank>``."""
    import glob

    shards = sorted(glob.glob(os.path.join(trace_dir, "trace_*.jsonl")))
    events: List[Dict[str, Any]] = []
    synthetic_pid = 1 << 20  # shards missing a meta line (crashed early)
    used_pids: set = set()
    for path in shards:
        meta, evs = read_shard(path)
        if not evs:
            continue
        if meta is not None:
            pid = int(meta["pid"])
            shift = int(meta["epoch_us"]) - int(meta["mono_us"])
            label = f"{meta['role']}_{meta['rank']}"
        else:
            pid = synthetic_pid
            synthetic_pid += 1
            shift = 0
            label = os.path.basename(path)[len("trace_"):-len(".jsonl")]
        # One track per shard: two shards can share an OS pid (a process
        # re-configured into a new role, or pid recycling across hosts).
        if pid in used_pids:
            pid = synthetic_pid
            synthetic_pid += 1
        used_pids.add(pid)
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": label},
            }
        )
        for ev in evs:
            ev = dict(ev)
            ev["pid"] = pid
            ev["ts"] = int(ev.get("ts", 0)) + shift
            ev.setdefault("tid", 0)
            events.append(ev)
    # Normalize onto a zero-based timeline (Perfetto renders epoch-µs
    # offsets fine, but small numbers keep the JSON and UI readable).
    real = [e for e in events if e["ph"] != "M"]
    if real:
        t0 = min(e["ts"] for e in real)
        for e in real:
            e["ts"] -= t0
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(trace, f, default=_json_default)
    return trace


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Schema check for the merged trace (shared by tests and
    scripts/check_trace.py).  Returns a list of problems; empty = valid."""
    errors: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    if not any(e.get("ph") == "X" for e in evs):
        errors.append("no complete ('X') span events")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        errors.append(f"not JSON-serializable: {e!r}")
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("X", "C", "M", "i"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            errors.append(f"event {i}: missing name")
        for field in ("ts", "pid", "tid"):
            if not isinstance(e.get(field), int):
                errors.append(f"event {i} ({e.get('name')}): bad {field}")
        if ph == "X" and not (
            isinstance(e.get("dur"), int) and e["dur"] >= 0
        ):
            errors.append(f"event {i} ({e.get('name')}): bad dur")
        if ph == "C" and not isinstance(e.get("args"), dict):
            errors.append(f"event {i} ({e.get('name')}): counter sans args")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    if len(errors) <= 20:
        errors.extend(_validate_lineage(evs))
    return errors


def _validate_lineage(evs: List[Dict[str, Any]]) -> List[str]:
    """Lineage frame checks: every ``lineage:*`` event carries string
    trace_id/stage args, and any event stamped with a trace_id (lineage
    instants and request spans alike) must share a trace_id that appears
    on a root (``root=True``) lineage event somewhere in the merged
    trace — an orphan child means a broken propagation path."""
    errors: List[str] = []
    roots = set()
    stamped = []  # (index, event, trace_id)
    for i, e in enumerate(evs):
        args = e.get("args")
        if not isinstance(args, dict):
            continue
        tid = args.get("trace_id")
        name = e.get("name")
        is_lineage = isinstance(name, str) and name.startswith("lineage:")
        if is_lineage:
            if not isinstance(tid, str) or not tid:
                errors.append(f"event {i} ({name}): lineage sans trace_id")
                continue
            if not isinstance(args.get("stage"), str):
                errors.append(f"event {i} ({name}): lineage sans stage")
            if args.get("root"):
                roots.add(tid)
        if isinstance(tid, str) and tid:
            stamped.append((i, name, tid))
    for i, name, tid in stamped:
        if tid not in roots:
            errors.append(
                f"event {i} ({name}): orphan trace_id {tid!r} "
                f"(no root lineage event)"
            )
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors
