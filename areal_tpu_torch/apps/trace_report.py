"""Stall attribution over a merged trace (port of
areal_tpu/apps/trace_report.py): where did each step's wall-clock
go, per process?

    python -m areal_tpu_torch.apps.trace_report <trace_dir | trace.json> [--top N]

Given a directory, first merges the ``trace_*.jsonl`` shards into
``trace.json`` (tracer.merge_shards), then walks each process track and
buckets every step's wall-clock into compute / comms / host / idle:

- step windows come from the master's ``step`` spans (the whole trace is
  one step when absent — e.g. a bare gen_server capture);
- category time is the union of that process's categorized spans clipped
  to the window, with precedence comms > compute > host (a compute span
  nested inside a transfer wait counts once, as comms);
- idle is the uncovered remainder — the bubbles future overlap PRs exist
  to shrink.  The top-N bubble intervals are printed with the spans that
  bound them, which is the artifact a perf PR cites before/after.

Uncategorized spans (request lifetimes, dispatch waits) shape the
timeline but never count toward a bucket.

``--pipeline`` switches the human view to the pipelined-step report:
one row per (step, stage) over the master's ``pipe:<stage>`` dispatch
spans, with each stage's busy time (interval union of its chunk
dispatches), fill fraction of the step window, and intra-stage bubble,
plus a per-step overlap fraction (how much of the stages' summed busy
time ran concurrently — 0 under the barrier scheduler, > 0 once chunks
of different stages execute at the same time).

``--lineage`` switches to the causal-lineage view: joins the merged
shards by ``trace_id`` (the ``lineage:*`` instant events every stage of
the async-RL pipeline stamps) and renders one end-to-end timeline per
sample — dispatched → first-token → generated → graded → admitted →
trained — plus stage-transition p50/p99 and a staleness-vs-latency
breakdown keyed on the admission-time weight-version lag.

``--flight`` renders the flight-recorder dumps
(``flightrec_<role>_<rank>.json``, written next to the shards when a
fault trips) as one cross-process timeline of the last ``--window``
seconds before the fault instant.  It reads the dumps directly — no
merge, no validation — because the trace may be torn at exactly the
moment you need this view.

``--json`` emits the report as one JSON object with a stable schema
(``json_report``) instead of the human tables, for dashboards and the
regression tooling:

    {"version": 4,
     "rows": [{"step", "pid", "process", "window_us", "compute_us",
               "comms_us", "host_us", "idle_us"}, ...],
     "bubbles": [{"process", "step", "start_us", "dur_us",
                  "after_span", "before_span"}, ...],
     "pipeline": [{"step", "window_us", "overlap_frac",
                   "stages": [{"stage", "n_chunks", "busy_us", "fill",
                               "bubble_us"}, ...]}, ...],
     "lineage": {"summary": {"n", "complete", "in_flight", "failed",
                             "rejected_stale", "orphans", "e2e_p50_us",
                             "e2e_p99_us", "transitions", "staleness"},
                 "traces": [{"trace_id", "qid", "root", "complete",
                             "e2e_us", "version_lag", "stages"}, ...]},
     "profile": [<harvest_profile entries: per-MFC
                  records keyed (mfc, model_shape, layout, batch_shape),
                  per-step walls, inferred topology levels>]}

``version`` bumps on any breaking change; consumers must reject
versions they don't know.  v2 was additive over v1 (``pipeline``); v3
was additive over v2 (``lineage``, empty traces/zero counts when the
trace carries no ``lineage:*`` events); v4 is additive over v3:
``profile`` is new — the placement advisor's profile-store entries
harvested from this trace (empty list when no MFC spans carry profile
args, i.e. any pre-advisor run).
"""

import argparse
import dataclasses
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.base import tracer

Interval = Tuple[int, int]  # [start_us, end_us)

# Attribution precedence: a span overlapped by a higher category yields
# to it so nested spans never double-count.
CATEGORIES = ("comms", "compute", "host")


def _union(intervals: List[Interval]) -> List[Interval]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _subtract(base: List[Interval], cut: List[Interval]) -> List[Interval]:
    """base minus cut; both must be sorted unions."""
    out: List[Interval] = []
    ci = 0
    for s, e in base:
        cur = s
        while ci < len(cut) and cut[ci][1] <= cur:
            ci += 1
        j = ci
        while j < len(cut) and cut[j][0] < e:
            cs, ce = cut[j]
            if cs > cur:
                out.append((cur, cs))
            cur = max(cur, ce)
            if cur >= e:
                break
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


def _clip(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    return [
        (max(s, lo), min(e, hi))
        for s, e in intervals
        if min(e, hi) > max(s, lo)
    ]


def _total(intervals: List[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _spans_by_pid(trace) -> Dict[int, List[Dict]]:
    by_pid: Dict[int, List[Dict]] = defaultdict(list)
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X":
            by_pid[int(e.get("pid", 0))].append(e)
    return by_pid


def _proc_names(trace) -> Dict[int, str]:
    names = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            names[int(e["pid"])] = e.get("args", {}).get("name", "?")
    return names


def _step_windows(trace) -> List[Tuple[Optional[int], int, int]]:
    """[(step_number, start_us, end_us)] from ``step`` spans; the whole
    trace as one anonymous window when no step spans exist."""
    steps = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("name") == "step":
            num = (e.get("args") or {}).get("step")
            steps.append(
                (
                    int(num) if num is not None else None,
                    int(e["ts"]),
                    int(e["ts"]) + int(e["dur"]),
                )
            )
    if steps:
        return sorted(steps, key=lambda t: t[1])
    spans = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    if not spans:
        return []
    lo = min(int(e["ts"]) for e in spans)
    hi = max(int(e["ts"]) + int(e["dur"]) for e in spans)
    return [(None, lo, hi)]


def attribute(trace) -> List[Dict[str, Any]]:
    """-> one row per (step, process): {step, process, window_us,
    compute_us, comms_us, host_us, idle_us}."""
    by_pid = _spans_by_pid(trace)
    names = _proc_names(trace)
    rows = []
    for step, lo, hi in _step_windows(trace):
        for pid, spans in sorted(by_pid.items()):
            cat_iv: Dict[str, List[Interval]] = {c: [] for c in CATEGORIES}
            for e in spans:
                c = e.get("cat")
                if c in cat_iv:
                    cat_iv[c].append(
                        (int(e["ts"]), int(e["ts"]) + int(e["dur"]))
                    )
            covered: List[Interval] = []
            row = {
                "step": step,
                "pid": pid,
                "process": names.get(pid, str(pid)),
                "window_us": hi - lo,
            }
            for c in CATEGORIES:
                u = _subtract(_union(_clip(cat_iv[c], lo, hi)), covered)
                row[f"{c}_us"] = _total(u)
                covered = _union(covered + u)
            row["idle_us"] = (hi - lo) - _total(covered)
            row["_covered"] = covered
            rows.append(row)
    return rows


def bubbles(trace, top: int = 5) -> List[Dict[str, Any]]:
    """Largest uncovered (idle) intervals per process across all step
    windows, with the categorized spans bounding each gap."""
    by_pid = _spans_by_pid(trace)
    names = _proc_names(trace)
    windows = _step_windows(trace)
    out = []
    for pid, spans in by_pid.items():
        cat_spans = [e for e in spans if e.get("cat") in CATEGORIES]
        covered = _union(
            [
                (int(e["ts"]), int(e["ts"]) + int(e["dur"]))
                for e in cat_spans
            ]
        )
        for step, lo, hi in windows:
            for gs, ge in _subtract([(lo, hi)], _clip(covered, lo, hi)):
                before = after = None
                for e in cat_spans:
                    s, ee = int(e["ts"]), int(e["ts"]) + int(e["dur"])
                    if ee <= gs and (
                        before is None
                        or ee > int(before["ts"]) + int(before["dur"])
                    ):
                        before = e
                    if s >= ge and (
                        after is None or s < int(after["ts"])
                    ):
                        after = e
                out.append(
                    {
                        "process": names.get(pid, str(pid)),
                        "step": step,
                        "start_us": gs,
                        "dur_us": ge - gs,
                        "after_span": before["name"] if before else None,
                        "before_span": after["name"] if after else None,
                    }
                )
    out.sort(key=lambda b: -b["dur_us"])
    return out[:top]


def pipeline_rows(trace) -> List[Dict[str, Any]]:
    """Per-step occupancy of the pipelined executor, from the master's
    ``pipe:<stage>`` dispatch spans.

    For each step window and each stage (DFG node): ``busy_us`` is the
    interval union of that stage's chunk dispatches clipped to the
    window, ``fill`` = busy / window, ``bubble_us`` = idle time strictly
    inside the stage's own active span (last end - first start - busy).
    The per-step ``overlap_frac`` = 1 - union(all stages) / sum(stages):
    0 when stages run strictly one after another (the barrier
    scheduler), approaching 1 - 1/n_stages as they fully overlap.
    Steps without pipe spans (non-pipelined runs) produce no rows.
    """
    events = [
        e
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("pipe:")
    ]
    out: List[Dict[str, Any]] = []
    for step, lo, hi in _step_windows(trace):
        window = hi - lo
        stages: Dict[str, List[Interval]] = {}
        for e in events:
            s, ee = int(e["ts"]), int(e["ts"]) + int(e["dur"])
            if ee <= lo or s >= hi:
                continue
            stage = (e.get("args") or {}).get("stage") or e["name"][
                len("pipe:"):
            ]
            stages.setdefault(str(stage), []).append(
                (max(s, lo), min(ee, hi))
            )
        if not stages:
            continue
        srows = []
        busy_all: List[Interval] = []
        sum_busy = 0
        for stage, iv in sorted(stages.items()):
            u = _union(iv)
            busy = _total(u)
            srows.append(
                {
                    "stage": stage,
                    "n_chunks": len(iv),
                    "busy_us": busy,
                    "fill": busy / max(window, 1),
                    "bubble_us": max((u[-1][1] - u[0][0]) - busy, 0),
                }
            )
            busy_all.extend(u)
            sum_busy += busy
        union_all = _total(_union(busy_all))
        out.append(
            {
                "step": step,
                "window_us": window,
                "overlap_frac": (
                    1.0 - union_all / sum_busy if sum_busy else 0.0
                ),
                "stages": srows,
            }
        )
    return out


def format_pipeline(trace) -> str:
    steps = pipeline_rows(trace)
    if not steps:
        return (
            "no pipe:* spans in this trace (pipeline_overlap off, or the "
            "master was not traced)"
        )
    lines = [
        f"{'step':>5} {'stage':<16} {'chunks':>6} {'busy_ms':>9} "
        f"{'fill%':>6} {'bubble_ms':>9}"
    ]
    for st in steps:
        step = "-" if st["step"] is None else str(st["step"])
        for r in st["stages"]:
            lines.append(
                f"{step:>5} {r['stage']:<16} {r['n_chunks']:>6} "
                f"{r['busy_us'] / 1000.0:9.1f} {100.0 * r['fill']:5.1f}% "
                f"{r['bubble_us'] / 1000.0:9.1f}"
            )
        lines.append(
            f"{step:>5} {'(step)':<16} window "
            f"{st['window_us'] / 1000.0:.1f} ms, overlap "
            f"{100.0 * st['overlap_frac']:.1f}%"
        )
    return "\n".join(lines)


def format_report(trace, top: int = 5) -> str:
    rows = attribute(trace)
    lines = []
    ms = lambda us: f"{us / 1000.0:9.1f}"  # noqa: E731
    lines.append(
        f"{'step':>5} {'process':<16} {'window_ms':>9} {'compute':>9} "
        f"{'comms':>9} {'host':>9} {'idle':>9} {'idle%':>6}"
    )
    for r in rows:
        step = "-" if r["step"] is None else str(r["step"])
        idle_pct = 100.0 * r["idle_us"] / max(r["window_us"], 1)
        lines.append(
            f"{step:>5} {r['process']:<16} {ms(r['window_us'])} "
            f"{ms(r['compute_us'])} {ms(r['comms_us'])} {ms(r['host_us'])} "
            f"{ms(r['idle_us'])} {idle_pct:5.1f}%"
        )
    bubs = bubbles(trace, top=top)
    if bubs:
        lines.append("")
        lines.append(f"top {len(bubs)} bubbles (uncovered intervals):")
        for b in bubs:
            step = "-" if b["step"] is None else str(b["step"])
            lines.append(
                f"  {b['dur_us'] / 1000.0:8.1f} ms  step {step:>3}  "
                f"{b['process']:<16} between "
                f"{b['after_span'] or '<window start>'} and "
                f"{b['before_span'] or '<window end>'}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# causal lineage: join merged shards by trace_id into per-sample timelines
# ---------------------------------------------------------------------------

# The canonical stage order of the async-RL pipeline; transitions between
# adjacent present stages are what the p50/p99 table reports.
_LINEAGE_TRANSITIONS = (
    ("dispatch", "first_token"),
    ("first_token", "generated"),
    ("generated", "graded"),
    ("graded", "admitted"),
    ("admitted", "trained"),
)


def _pctl(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    return float(vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))])


def lineage_rows(trace) -> List[Dict[str, Any]]:
    """-> one row per trace_id: {trace_id, qid, root, stages: {stage:
    first_ts_us}, complete, e2e_us, version_lag}.  ``complete`` means
    the sample's timeline runs dispatch → trained; ``version_lag`` is
    the admission-time staleness the replay buffer stamped."""
    by_tid: Dict[str, Dict[str, Any]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "i" or str(e.get("cat", "")) != "lineage":
            continue
        a = e.get("args") or {}
        tid = str(a.get("trace_id", ""))
        if not tid:
            continue
        row = by_tid.setdefault(
            tid,
            {
                "trace_id": tid,
                "qid": "",
                "task": "",
                "root": False,
                "stages": {},
                "version_lag": None,
            },
        )
        stage = str(a.get("stage", ""))
        ts = int(e.get("ts", 0))
        if stage and (
            stage not in row["stages"] or ts < row["stages"][stage]
        ):
            row["stages"][stage] = ts
        if a.get("root"):
            row["root"] = True
        if a.get("qid") and not row["qid"]:
            row["qid"] = str(a["qid"])
        # Task-mixture stamp (the dispatch root carries it; graders
        # echo it) — keys per-task e2e attribution.
        if a.get("task") and not row["task"]:
            row["task"] = str(a["task"])
        if stage == "admitted" and a.get("version_lag") is not None:
            row["version_lag"] = int(a["version_lag"])
    rows = []
    for tid in sorted(by_tid):
        row = by_tid[tid]
        st = row["stages"]
        row["complete"] = "dispatch" in st and "trained" in st
        row["e2e_us"] = (
            st["trained"] - st["dispatch"] if row["complete"] else None
        )
        rows.append(row)
    return rows


def _group_by_task(rows: List[Dict[str, Any]]) -> Dict[str, List[Dict]]:
    by_task: Dict[str, List[Dict]] = {}
    for r in rows:
        if r.get("task"):
            by_task.setdefault(r["task"], []).append(r)
    return by_task


def lineage_summary(trace) -> Dict[str, Any]:
    """Fleet view of the joined timelines: counts (complete / in-flight
    at shutdown / failed / rejected / orphaned), end-to-end and
    stage-transition p50/p99, and staleness-vs-latency keyed on the
    admission version lag."""
    rows = lineage_rows(trace)
    complete = [r for r in rows if r["complete"]]
    terminal = ("trained", "failed", "rejected_stale")
    in_flight = [
        r["trace_id"]
        for r in rows
        if r["root"] and not any(s in r["stages"] for s in terminal)
    ]
    transitions: Dict[str, Dict[str, float]] = {}
    for a, b in _LINEAGE_TRANSITIONS:
        deltas = [
            float(r["stages"][b] - r["stages"][a])
            for r in rows
            if a in r["stages"] and b in r["stages"]
        ]
        if deltas:
            transitions[f"{a}->{b}"] = {
                "n": len(deltas),
                "p50_us": _pctl(deltas, 0.5),
                "p99_us": _pctl(deltas, 0.99),
            }
    e2e = [float(r["e2e_us"]) for r in complete]
    by_lag: Dict[int, List[float]] = {}
    for r in complete:
        if r["version_lag"] is not None:
            by_lag.setdefault(r["version_lag"], []).append(
                float(r["e2e_us"])
            )
    return {
        "n": len(rows),
        "complete": len(complete),
        "in_flight": len(in_flight),
        "failed": sum(1 for r in rows if "failed" in r["stages"]),
        "rejected_stale": sum(
            1 for r in rows if "rejected_stale" in r["stages"]
        ),
        "orphans": [r["trace_id"] for r in rows if not r["root"]],
        "e2e_p50_us": _pctl(e2e, 0.5),
        "e2e_p99_us": _pctl(e2e, 0.99),
        "transitions": transitions,
        # Per-task e2e attribution (task-mixture trials): which task
        # stream the pipeline's latency is going to.  Empty-task rows
        # (single-stream trials) are omitted.
        "by_task": [
            {
                "task": task,
                "n": len(trs),
                "complete": sum(1 for r in trs if r["complete"]),
                "e2e_p50_us": _pctl(
                    [float(r["e2e_us"]) for r in trs if r["complete"]],
                    0.5,
                ),
                "e2e_p99_us": _pctl(
                    [float(r["e2e_us"]) for r in trs if r["complete"]],
                    0.99,
                ),
            }
            for task, trs in sorted(_group_by_task(rows).items())
        ],
        "staleness": [
            {
                "version_lag": lag,
                "n": len(v),
                "p50_us": _pctl(v, 0.5),
                "p99_us": _pctl(v, 0.99),
            }
            for lag, v in sorted(by_lag.items())
        ],
    }


def format_lineage(trace) -> str:
    rows = lineage_rows(trace)
    if not rows:
        return (
            "no lineage:* events in this trace (pre-lineage run, or the "
            "dispatcher was not traced)"
        )
    s = lineage_summary(trace)
    lines = [
        f"{'trace_id':<22} {'qid':<14} {'lag':>3} {'e2e_ms':>9}  timeline"
    ]
    for r in rows:
        order = sorted(r["stages"].items(), key=lambda kv: kv[1])
        t0 = order[0][1]
        tl = " -> ".join(
            f"{st}@{(ts - t0) / 1000.0:.1f}ms" for st, ts in order
        )
        e2e = (
            f"{r['e2e_us'] / 1000.0:9.1f}" if r["complete"] else
            f"{'-':>9}"
        )
        lag = "-" if r["version_lag"] is None else str(r["version_lag"])
        lines.append(
            f"{r['trace_id']:<22} {r['qid']:<14} {lag:>3} {e2e}  {tl}"
        )
    lines.append("")
    lines.append(
        f"{s['n']} traces: {s['complete']} complete, "
        f"{s['in_flight']} in-flight, {s['failed']} failed, "
        f"{s['rejected_stale']} rejected stale, "
        f"{len(s['orphans'])} orphaned; e2e p50 "
        f"{s['e2e_p50_us'] / 1000.0:.1f} ms, p99 "
        f"{s['e2e_p99_us'] / 1000.0:.1f} ms"
    )
    for name, t in s["transitions"].items():
        lines.append(
            f"  {name:<24} n={t['n']:<4} p50 {t['p50_us'] / 1000.0:8.1f} "
            f"ms  p99 {t['p99_us'] / 1000.0:8.1f} ms"
        )
    for b in s["by_task"]:
        lines.append(
            f"  task={b['task']:<12} n={b['n']:<4} "
            f"complete={b['complete']:<4} e2e p50 "
            f"{b['e2e_p50_us'] / 1000.0:8.1f} ms  p99 "
            f"{b['e2e_p99_us'] / 1000.0:8.1f} ms"
        )
    for b in s["staleness"]:
        lines.append(
            f"  lag={b['version_lag']:<2} n={b['n']:<4} e2e p50 "
            f"{b['p50_us'] / 1000.0:8.1f} ms  p99 "
            f"{b['p99_us'] / 1000.0:8.1f} ms"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# flight recorder: cross-process timeline around the fault instant
# ---------------------------------------------------------------------------


def format_flight(trace_dir: str, window_s: float = 10.0) -> str:
    """Render every flightrec dump in ``trace_dir`` as one merged
    timeline of the last ``window_s`` seconds before the latest fault.
    Reads the dumps directly — the trace itself may be torn at exactly
    the moment this view matters."""
    dumps = tracer.read_flight_dumps(trace_dir)
    if not dumps:
        return f"no flightrec_*.json dumps in {trace_dir}"
    fault_us = max(int(d.get("t_dump_us", 0)) for d in dumps)
    lo_us = fault_us - int(window_s * 1e6)
    lines = [
        f"{len(dumps)} flight dump(s); fault window: last "
        f"{window_s:.1f}s before t={fault_us}us"
    ]
    for d in sorted(dumps, key=lambda d: int(d.get("t_dump_us", 0))):
        lines.append(
            f"  {d.get('role', '?')}_{d.get('rank', '?')} "
            f"(pid {d.get('pid', '?')}): {d.get('reason', '?')} with "
            f"{len(d.get('events', []))} ring events"
        )
    merged = []
    for d in dumps:
        who = f"{d.get('role', '?')}_{d.get('rank', '?')}"
        for ev in d.get("events", []):
            t = int(ev.get("t_us", 0))
            if t >= lo_us:
                merged.append((t, who, ev))
    merged.sort(key=lambda x: x[0])
    for t, who, ev in merged:
        rest = {
            k: v for k, v in ev.items() if k not in ("t_us", "kind")
        }
        detail = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
        lines.append(
            f"  {(t - fault_us) / 1e6:+9.3f}s {who:<16} "
            f"{ev.get('kind', '?'):<10} {detail}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the placement advisor's profile entries (the harvest half of
# areal_tpu/analysis/profile.py): json_report's "profile"
# ---------------------------------------------------------------------------

PROFILE_VERSION = 1

# Span-arg fields copied verbatim from an mfc:* compute span into the
# record's metrics (max over calls — watermarks and monotonic counters).
_WATERMARK_ARGS = (
    "pool_bytes",
    "pool_peak_bytes",
    "param_bytes",
    "opt_bytes",
    "compiles",
)


def _bucket_pow2(x: float) -> int:
    """Round up to a power of two so near-identical batch shapes share a
    profile key instead of fragmenting the store per step."""
    n = 1
    x = max(int(x), 1)
    while n < x:
        n *= 2
    return n


def batch_shape_of(seqs: int, tokens: int) -> str:
    """Stable batch-shape key: sequence count x pow2-bucketed mean
    per-sequence length (``n8x64``)."""
    seqs = max(int(seqs), 1)
    return f"n{seqs}x{_bucket_pow2(tokens / seqs)}"


@dataclasses.dataclass(frozen=True)
class ProfileKey:
    mfc: str          # "model_key:interface_type"
    model_shape: str  # "l{layers}h{hidden}q{qheads}kv{kvheads}v{vocab}"
    layout: str       # ParallelConfig.to_str(), e.g. "d4f2"
    batch_shape: str  # batch_shape_of(), e.g. "n8x64"

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "ProfileKey":
        return cls(
            mfc=str(d.get("mfc", "")),
            model_shape=str(d.get("model_shape", "")),
            layout=str(d.get("layout", "")),
            batch_shape=str(d.get("batch_shape", "")),
        )


@dataclasses.dataclass
class ProfileRecord:
    key: ProfileKey
    calls: int = 0
    wall_s_sum: float = 0.0
    tokens_sum: int = 0
    seqs_sum: int = 0
    tflops_sum: float = 0.0
    tflops_n: int = 0
    mfu_sum: float = 0.0
    mfu_n: int = 0
    xfer_bytes_sum: float = 0.0
    watermarks: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def wall_s_mean(self) -> float:
        return self.wall_s_sum / max(self.calls, 1)

    @property
    def tokens_mean(self) -> float:
        return self.tokens_sum / max(self.calls, 1)

    def metrics(self) -> Dict[str, float]:
        m = {
            "calls": self.calls,
            "wall_s_sum": round(self.wall_s_sum, 6),
            "wall_s_mean": round(self.wall_s_mean, 6),
            "tokens_sum": self.tokens_sum,
            "tokens_mean": round(self.tokens_mean, 3),
            "seqs_mean": round(self.seqs_sum / max(self.calls, 1), 3),
            "xfer_bytes_mean": round(
                self.xfer_bytes_sum / max(self.calls, 1), 3
            ),
        }
        if self.tflops_n:
            m["tflops_mean"] = round(self.tflops_sum / self.tflops_n, 9)
        if self.mfu_n:
            m["mfu_mean"] = round(self.mfu_sum / self.mfu_n, 6)
        m.update(self.watermarks)
        return m

    def to_entry(self, meta: Optional[Dict[str, Any]] = None) -> Dict:
        e = {
            "v": PROFILE_VERSION,
            "kind": "mfc",
            "key": self.key.to_dict(),
            "metrics": self.metrics(),
        }
        if meta:
            e["meta"] = dict(meta)
        return e


def _profile_step_windows(trace) -> List[Tuple[Optional[int], int, int]]:
    steps = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("name") == "step":
            num = (e.get("args") or {}).get("step")
            steps.append(
                (
                    int(num) if num is not None else None,
                    int(e["ts"]),
                    int(e["ts"]) + int(e["dur"]),
                )
            )
    return sorted(steps, key=lambda t: t[1])


def _mfc_spans(trace) -> List[Dict]:
    """Worker compute spans carrying an ``mfc`` arg.  Stream chunk spans
    (``:train_chunk``) are pieces of a ``:train_step`` whole and are
    skipped — the profile records whole MFC executions."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "compute":
            continue
        a = e.get("args") or {}
        mfc = a.get("mfc")
        if not mfc or str(mfc).endswith(":train_chunk"):
            continue
        out.append(e)
    return out


def harvest_profile(
    trace: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
    skip_warmup: int = 0,
) -> List[Dict[str, Any]]:
    """Aggregate a merged trace into profile-store entries: one ``mfc``
    entry per (mfc, model_shape, layout, batch_shape), one ``step``
    entry per master step window, and one ``topo`` entry with the
    execution levels inferred from span timing (two MFCs whose spans
    overlap a step window concurrently share a level — the DFG topology
    as actually scheduled).

    ``skip_warmup`` drops the first N step windows entirely (spans and
    step entries): warm-up steps carry jit-compile time no roofline can
    transfer, so calibration harvests skip them."""
    windows = _profile_step_windows(trace)
    cut_ts = (
        windows[skip_warmup - 1][2]
        if 0 < skip_warmup <= len(windows)
        else None
    )
    if cut_ts is not None:
        windows = windows[skip_warmup:]
    recs: Dict[ProfileKey, ProfileRecord] = {}
    per_mfc_spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for e in _mfc_spans(trace):
        if cut_ts is not None and int(e["ts"]) < cut_ts:
            continue
        a = e.get("args") or {}
        mfc = str(a["mfc"])
        tokens = int(a.get("tokens") or 0)
        seqs = int(a.get("seqs") or 0) or 1
        key = ProfileKey(
            mfc=mfc,
            model_shape=str(a.get("model_shape", "")),
            layout=str(a.get("layout", "")),
            batch_shape=batch_shape_of(seqs, tokens),
        )
        r = recs.setdefault(key, ProfileRecord(key=key))
        # Streamed train MFCs stamp their summed busy seconds (the end
        # span wraps only the optimizer step; chunk work happened in
        # separate :train_chunk spans) — prefer that over span duration.
        wall = (
            float(a["wall_s"])
            if a.get("wall_s") is not None
            else int(e.get("dur", 0)) / 1e6
        )
        r.calls += 1
        r.wall_s_sum += wall
        r.tokens_sum += tokens
        r.seqs_sum += seqs
        if a.get("tflops") is not None:
            r.tflops_sum += float(a["tflops"])
            r.tflops_n += 1
        if a.get("mfu") is not None:
            r.mfu_sum += float(a["mfu"])
            r.mfu_n += 1
        for wk in _WATERMARK_ARGS:
            if a.get(wk) is not None:
                r.watermarks[wk] = max(
                    float(r.watermarks.get(wk, 0.0)), float(a[wk])
                )
        per_mfc_spans[mfc].append(
            (int(e["ts"]), int(e["ts"]) + int(e.get("dur", 0)))
        )

    # Transfer attribution: xfer:data spans stamped with the consuming
    # MFC (system/master.py _ensure_data).  Mean bytes per call of that
    # MFC — every record of the mfc shares the attribution (transfers
    # are keyed by consumer, not by batch shape).
    xfer_by_mfc: Dict[str, float] = defaultdict(float)
    realloc_bytes = 0.0
    realloc_s = 0.0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        a = e.get("args") or {}
        name = str(e.get("name", ""))
        if name == "xfer:data" and a.get("mfc"):
            xfer_by_mfc[str(a["mfc"])] += float(a.get("bytes") or 0)
        elif name.startswith(("param_realloc:", "reshard")):
            realloc_bytes += float(a.get("bytes") or 0)
            realloc_s += int(e.get("dur", 0)) / 1e6
    for key, r in recs.items():
        total = xfer_by_mfc.get(key.mfc, 0.0)
        if total:
            # Split the mfc's total over its records by call share.
            calls_all = sum(
                x.calls for k, x in recs.items() if k.mfc == key.mfc
            )
            r.xfer_bytes_sum = total * r.calls / max(calls_all, 1)

    entries: List[Dict[str, Any]] = [
        recs[k].to_entry(meta) for k in sorted(recs, key=lambda k: k.mfc)
    ]

    for step, lo, hi in windows:
        e: Dict[str, Any] = {
            "v": PROFILE_VERSION,
            "kind": "step",
            "step": step,
            "wall_s": round((hi - lo) / 1e6, 6),
        }
        if realloc_bytes:
            e["realloc_bytes"] = realloc_bytes / max(len(windows), 1)
            e["realloc_s"] = realloc_s / max(len(windows), 1)
        entries.append(e)

    levels = infer_levels(per_mfc_spans, windows)
    if levels:
        entries.append(
            {"v": PROFILE_VERSION, "kind": "topo", "levels": levels}
        )
    return entries


def infer_levels(
    spans_by_mfc: Dict[str, List[Tuple[int, int]]],
    windows: List[Tuple[Optional[int], int, int]],
) -> List[List[str]]:
    """Execution levels from measured concurrency: within each step
    window, sort MFCs by first span start; an MFC that starts before the
    current level's earliest end joins it (they ran concurrently), else
    it opens the next level.  Majority vote across steps keeps one noisy
    window from scrambling the topology."""
    if not spans_by_mfc:
        return []
    if not windows:
        lo = min(s for iv in spans_by_mfc.values() for s, _ in iv)
        hi = max(e for iv in spans_by_mfc.values() for _, e in iv)
        windows = [(None, lo, hi)]
    votes: Dict[Tuple[Tuple[str, ...], ...], int] = defaultdict(int)
    for _, lo, hi in windows:
        starts: List[Tuple[int, int, str]] = []
        for mfc, iv in spans_by_mfc.items():
            inside = [(s, e) for s, e in iv if s >= lo and s < hi]
            if inside:
                starts.append(
                    (min(s for s, _ in inside),
                     min(e for _, e in inside), mfc)
                )
        if not starts:
            continue
        starts.sort()
        levels: List[List[str]] = [[starts[0][2]]]
        level_end = starts[0][1]
        for s, e, mfc in starts[1:]:
            if s < level_end:
                levels[-1].append(mfc)
                level_end = min(level_end, e)
            else:
                levels.append([mfc])
                level_end = e
        votes[tuple(tuple(sorted(lv)) for lv in levels)] += 1
    if not votes:
        return []
    best = max(votes.items(), key=lambda kv: (kv[1], kv[0]))[0]
    return [list(lv) for lv in best]


# v4 is additive over v3: rows/bubbles/pipeline/lineage unchanged,
# "profile" added (see module docstring).
JSON_VERSION = 4


def json_report(trace, top: int = 5) -> Dict[str, Any]:
    """Machine-readable report, schema v4 (see module docstring).  The
    internal ``_covered`` interval list is stripped from rows — it is an
    implementation detail of the precedence subtraction, not contract."""
    rows = [
        {k: v for k, v in r.items() if not k.startswith("_")}
        for r in attribute(trace)
    ]
    return {
        "version": JSON_VERSION,
        "rows": rows,
        "bubbles": bubbles(trace, top=top),
        "pipeline": pipeline_rows(trace),
        "lineage": {
            "summary": lineage_summary(trace),
            "traces": lineage_rows(trace),
        },
        "profile": harvest_profile(trace),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.trace_report")
    p.add_argument(
        "path",
        help="trace dir (shards are merged into trace.json) or a merged "
        "trace.json",
    )
    p.add_argument("--top", type=int, default=5, help="bubbles to print")
    p.add_argument(
        "--out", default=None,
        help="where to write the merged trace.json (dir input only)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="emit the stable v3 JSON report instead of tables",
    )
    p.add_argument(
        "--pipeline", action="store_true",
        help="per-stage fill/overlap of the pipelined step executor "
        "(from pipe:* spans) instead of the stall tables",
    )
    p.add_argument(
        "--lineage", action="store_true",
        help="per-sample causal timelines joined by trace_id "
        "(dispatch -> ... -> trained) instead of the stall tables",
    )
    p.add_argument(
        "--flight", action="store_true",
        help="render flightrec_*.json dumps around the fault instant "
        "(skips merge + validation: the trace may be torn)",
    )
    p.add_argument(
        "--window", type=float, default=10.0,
        help="seconds of flight-recorder history to render (--flight)",
    )
    args = p.parse_args(argv)
    if args.flight:
        d = (
            args.path
            if os.path.isdir(args.path)
            else os.path.dirname(os.path.abspath(args.path))
        )
        print(format_flight(d, window_s=args.window))
        return 0
    if os.path.isdir(args.path):
        out = args.out or os.path.join(args.path, "trace.json")
        trace = tracer.merge_shards(args.path, out_path=out)
        if not args.json:
            print(f"merged {args.path} -> {out}")
    else:
        trace = load_trace(args.path)
    errors = tracer.validate_trace(trace)
    if errors:
        print("trace schema problems:", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(json_report(trace, top=args.top)))
    elif args.pipeline:
        print(format_pipeline(trace))
    elif args.lineage:
        print(format_lineage(trace))
    else:
        print(format_report(trace, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
