"""Fleet-health poller + SLO watchdog over the live metrics plane (port of
areal_tpu/apps/metrics_report.py; host code that never touches the card).

    python -m areal_tpu_torch.apps.metrics_report --experiment e --trial t \
        [--count 5] [--interval 2] \
        [--slo "crit: staleness_p99 <= 4"] \
        [--slo "warn: drop(goodput) < 0.2 over 5"]

Discovers every process role of a trial via ``name_resolve`` (each role
announces its ``/metrics`` base URL under ``names.metrics_root``;
``--url role=http://host:port`` adds/overrides endpoints statically),
scrapes them on an interval, renders one fleet-health table per scrape
(per-server goodput, staleness p50/p99, idle fraction, weight-version
skew), and evaluates declarative SLO rules against the scrape history,
emitting ``WARN``/``CRIT`` lines — the watchdog signal the fleet
supervisor (`system/fleet.py FleetSupervisor`) acts on.

SLO rule grammar (one rule per ``--slo`` / per line of ``--slo-file``;
``#`` comments and blank lines ignored)::

    [warn:|crit:] SIGNAL OP VALUE          # threshold on the latest scrape
    [warn:|crit:] drop(SIGNAL) OP FRAC over N   # relative drop over a window

``OP`` is one of ``<= < >= > == !=``.  The rule states the REQUIREMENT;
a violation fires at the rule's severity (default ``crit``).  Threshold
rules read the newest scrape; ``drop(s) < f over N`` requires the
relative drop of ``s`` from its max over the last ``N`` scrapes to stay
under ``f`` (e.g. ``drop(goodput) < 0.2 over 5`` = goodput must not
fall more than 20% below its recent peak).

Fleet signals available to rules: ``goodput`` (tokens/s summed over gen
servers, rate of ``areal_gen_tokens_total`` between scrapes),
``staleness_p50`` / ``staleness_p99`` (from the
``areal_replay_staleness`` histogram), ``sample_e2e_p50`` /
``sample_e2e_p99`` / ``sample_admit_p99`` (per-sample causal-lineage
latencies: dispatch → train consumption and dispatch → replay
admission, from the ``areal_sample_e2e_seconds`` /
``areal_sample_admit_seconds`` histograms — e.g. ``warn:
sample_e2e_p99 <= 30`` alerts when the slowest samples take more than
30 s dispatch-to-train), ``queue_depth``,
``kv_utilization``, ``idle_frac``, ``version_skew`` (max-min serving
weight version across gen servers), ``backpressure`` (rate of
``areal_rollout_backpressure_total``), ``in_flight``,
``pipeline_fill`` / ``pipeline_bubble`` (pipelined-step occupancy: the
busiest stage's ``areal_master_pipeline_fill_ratio`` and the summed
``areal_master_pipeline_bubble_seconds`` over stages — e.g.
``warn: pipeline_fill >= 0.6`` alerts when the overlapped step leaves
the dominant stage mostly idle), ``ckpt_age`` (seconds since the last
committed recover checkpoint — ``crit: ckpt_age < 900`` requires a
crash to lose at most 15 minutes of work), ``anomalies`` /
``quarantine_streak`` / ``push_rejected`` (numerical-integrity guard
plane: sentinel trips summed over kinds, the master's live run of
consecutive quarantined steps, and checksum-rejected weight pushes —
e.g. ``crit: quarantine_streak <= 2`` pages one step before the
escalation ladder rolls the trial back to the last good checkpoint),
``weight_version_skew`` / ``push_p99`` (parameter distribution fabric,
system/paramstore.py: max-min serving weight version across gen servers
— an alias of ``version_skew`` named for fabric SLOs — and the p99 of
``areal_param_push_seconds``, one observation per whole-fleet broadcast
or cross-set realloc push — e.g. ``warn: weight_version_skew <= 1``
requires laggards to stay within the v-1 staleness bound the store's
refcounts guarantee, and ``crit: push_p99 <= 30`` pages when weight
distribution is eating the training step), ``advisor_pred_err`` /
``mfc_mfu_min`` / ``mfc_mfu_max`` (placement-advisor plane; the
advisor itself is ROADMAP queue 1 item 10: the master's online cost-model residual
``areal_master_advisor_pred_err_ratio`` and the min/max of the labeled
per-MFC MFU gauges — e.g. ``warn: advisor_pred_err <= 0.5`` flags when
the DFG-composed prediction stops tracking the measured step, so the
advisor's offline rankings are running on stale physics, and ``warn:
mfc_mfu_min >= 0.02`` surfaces an MFC whose current placement is
starving it), ``grade_latency_p99`` / ``verifier_queue_depth`` /
``verifier_servers`` / ``verifier_breaker_open`` (verifier fleet,
system/verifier_pool.py: the p99 of ``areal_verifier_grade_seconds``
over all backends, the pool client's in-flight grade items, live
members, and open breakers — e.g. ``crit: grade_latency_p99 <= 5``
tells the supervisor's verifier lane to spawn a worker when sandboxed
grading starts eating the sample pipeline, and ``crit:
verifier_queue_depth <= 64`` catches a backed-up pool before episode
completion stalls on rewards), ``task_reward_min`` (task-mixture
curriculum, data/mixture.py: the min over the labeled per-task reward
EMAs ``areal_mixture_task_reward`` — e.g. ``warn: task_reward_min >=
0.2`` pages when any task stream's reward collapses), plus any raw
unlabeled series name.

Exit status: 0 if no CRIT fired over the run, 1 otherwise (``--count``
bounds the run; without it the poller runs until interrupted).
"""

import argparse
import dataclasses
import json
import math
import re
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.base.metrics import parse_prometheus_text, quantile_from_buckets

_OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

_RULE_RE = re.compile(
    r"^\s*(?:(warn|crit)\s*:\s*)?"
    r"(?:drop\(\s*(?P<dsig>[a-zA-Z_][a-zA-Z0-9_]*)\s*\)"
    r"|(?P<sig>[a-zA-Z_][a-zA-Z0-9_]*))"
    r"\s*(?P<op><=|>=|==|!=|<|>)\s*(?P<val>[-+0-9.eE%]+)"
    r"(?:\s+over\s+(?P<win>\d+))?\s*$"
)


@dataclasses.dataclass
class SLORule:
    severity: str  # "warn" | "crit"
    signal: str
    op: str
    value: float
    window: Optional[int] = None  # set => drop(signal) rule
    is_drop: bool = False
    text: str = ""

    def evaluate(self, history: List[Dict[str, float]]) -> Optional[str]:
        """Return a violation message, or None when the rule holds.
        A signal absent from the scrape is not a violation (the role may
        not have started yet) — the watchdog reports coverage separately."""
        if not history:
            return None
        if self.is_drop:
            win = history[-(self.window or 1):]
            vals = [h[self.signal] for h in win if self.signal in h]
            if len(vals) < 2:
                return None
            peak, cur = max(vals), vals[-1]
            if peak <= 0:
                return None
            drop = (peak - cur) / peak
            if not _OPS[self.op](drop, self.value):
                return (
                    f"{self.text}: {self.signal} dropped "
                    f"{100 * drop:.1f}% from its window peak "
                    f"({peak:.4g} -> {cur:.4g} over last {len(vals)} scrapes)"
                )
            return None
        cur = history[-1].get(self.signal)
        if cur is None or (isinstance(cur, float) and math.isnan(cur)):
            return None
        if not _OPS[self.op](cur, self.value):
            return f"{self.text}: {self.signal}={cur:.4g} (want {self.op} {self.value:g})"
        return None


def parse_slo_rule(text: str) -> SLORule:
    m = _RULE_RE.match(text)
    if not m:
        raise ValueError(
            f"unparseable SLO rule {text!r} (grammar: "
            f"'[warn:|crit:] SIGNAL OP VALUE [over N]' or "
            f"'[warn:|crit:] drop(SIGNAL) OP FRAC over N')"
        )
    raw = m.group("val")
    value = float(raw[:-1]) / 100.0 if raw.endswith("%") else float(raw)
    is_drop = m.group("dsig") is not None
    win = m.group("win")
    if is_drop and win is None:
        raise ValueError(f"drop() rule needs an 'over N' window: {text!r}")
    return SLORule(
        severity=m.group(1) or "crit",
        signal=m.group("dsig") or m.group("sig"),
        op=m.group("op"),
        value=value,
        window=int(win) if win else None,
        is_drop=is_drop,
        text=text.strip(),
    )


# ---------------------------------------------------------------------------
# Scraping


def scrape_url(url: str, timeout: float = 5.0) -> Tuple[
        List[Tuple[str, Dict[str, str], float]], Dict[str, str]]:
    target = url if url.endswith("/metrics") else url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(target, timeout=timeout) as r:
        return parse_prometheus_text(r.read().decode())


def discover(experiment: str, trial: str) -> Dict[str, str]:
    """role -> base URL, from the trial's announced metrics subtree."""
    root = names.metrics_root(experiment, trial)
    out: Dict[str, str] = {}
    for key in sorted(name_resolve.find_subtree(root)):
        role = key[len(root) + 1:]
        try:
            out[role] = name_resolve.get(key)
        except Exception:
            continue
    return out


def _series_sum(samples, name: str) -> Optional[float]:
    vals = [v for n, _, v in samples if n == name]
    return sum(vals) if vals else None


def _hist_quantile(samples, series: str, q: float) -> float:
    pts = [
        (float(labels["le"]), v)
        for n, labels, v in samples
        if n == f"{series}_bucket" and "le" in labels
    ]
    return quantile_from_buckets(pts, q)


def _staleness_quantile(samples, q: float) -> float:
    return _hist_quantile(samples, "areal_replay_staleness", q)


@dataclasses.dataclass
class RoleScrape:
    role: str
    t: float
    samples: list
    ok: bool = True
    error: str = ""

    def value(self, name: str) -> Optional[float]:
        return _series_sum(self.samples, name)


def scrape_fleet(endpoints: Dict[str, str]) -> List[RoleScrape]:
    out = []
    for role, url in endpoints.items():
        t = time.monotonic()
        try:
            samples, _ = scrape_url(url)
            out.append(RoleScrape(role, t, samples))
        except Exception as e:  # noqa: BLE001 — a dead role is a finding
            out.append(RoleScrape(role, t, [], ok=False, error=repr(e)))
    return out


def _rate(cur: RoleScrape, prev: Optional[RoleScrape], name: str) -> float:
    """Per-second rate of a counter between two scrapes of one role."""
    if prev is None or not prev.ok or not cur.ok:
        return 0.0
    c, p = cur.value(name), prev.value(name)
    if c is None or p is None:
        return 0.0
    dt = cur.t - prev.t
    return max(c - p, 0.0) / dt if dt > 0 else 0.0


def fleet_signals(
    roles: List[RoleScrape],
    prev: Optional[Dict[str, RoleScrape]],
) -> Tuple[Dict[str, float], List[Dict[str, object]]]:
    """(fleet-level signal dict, per-role table rows) for one scrape."""
    signals: Dict[str, float] = {}
    rows: List[Dict[str, object]] = []
    all_samples = [s for r in roles if r.ok for s in r.samples]
    gen_roles = [
        r for r in roles
        if r.ok and any(n.startswith("areal_gen_") for n, _, _ in r.samples)
    ]
    goodput_total = 0.0
    versions: List[float] = []
    idle_fracs: List[float] = []
    for r in roles:
        p = prev.get(r.role) if prev else None
        row: Dict[str, object] = {"role": r.role, "ok": r.ok}
        if not r.ok:
            row["error"] = r.error
            rows.append(row)
            continue
        if r in gen_roles:
            gp = _rate(r, p, "areal_gen_tokens_total")
            if gp == 0.0:
                gp = r.value("areal_gen_goodput_tokens_per_second") or 0.0
            goodput_total += gp
            live = r.value("areal_gen_live_slots") or 0.0
            cap = r.value("areal_gen_capacity_slots") or 0.0
            idle = 1.0 - (live / cap) if cap > 0 else 1.0
            idle_fracs.append(idle)
            v = r.value("areal_gen_weight_version")
            if v is not None:
                versions.append(v)
            row.update(
                goodput=round(gp, 2),
                queue_depth=r.value("areal_gen_queue_depth") or 0.0,
                kv_util=round(
                    r.value("areal_gen_kv_utilization_ratio") or 0.0, 3
                ),
                live_slots=live,
                idle_frac=round(idle, 3),
                version=v,
            )
        steps = r.value("areal_master_steps_total")
        if steps is not None:
            row["steps"] = steps
        rows.append(row)
    signals["goodput"] = goodput_total
    signals["queue_depth"] = _series_sum(
        all_samples, "areal_gen_queue_depth"
    ) or 0.0
    kv = [
        r.value("areal_gen_kv_utilization_ratio") or 0.0 for r in gen_roles
    ]
    signals["kv_utilization"] = sum(kv) / len(kv) if kv else 0.0
    signals["idle_frac"] = (
        sum(idle_fracs) / len(idle_fracs) if idle_fracs else 0.0
    )
    signals["version_skew"] = (
        max(versions) - min(versions) if versions else 0.0
    )
    # Fabric alias: the same spread, named for parameter-distribution
    # SLOs (``warn: weight_version_skew <= 1`` asserts the store's
    # staleness bound — orphaned subtrees serve head-1, never head-2).
    signals["weight_version_skew"] = signals["version_skew"]
    p50 = _staleness_quantile(all_samples, 0.50)
    p99 = _staleness_quantile(all_samples, 0.99)
    if not math.isnan(p50):
        signals["staleness_p50"] = p50
    if not math.isnan(p99):
        signals["staleness_p99"] = p99
    # Per-sample lineage latencies (seconds): dispatch -> train
    # consumption and dispatch -> replay admission, from the replay
    # buffer's stage histograms.  Absent until the first sample trains.
    for sig, series, q in (
        ("sample_e2e_p50", "areal_sample_e2e_seconds", 0.50),
        ("sample_e2e_p99", "areal_sample_e2e_seconds", 0.99),
        ("sample_admit_p99", "areal_sample_admit_seconds", 0.99),
    ):
        v = _hist_quantile(all_samples, series, q)
        if not math.isnan(v):
            signals[sig] = v
    bp = _series_sum(all_samples, "areal_rollout_backpressure_total")
    if bp is not None:
        signals["backpressure"] = bp
    inf = _series_sum(all_samples, "areal_rollout_in_flight")
    if inf is not None:
        signals["in_flight"] = inf
    # Elastic-fleet health: total prompt re-dispatches (all failure
    # reasons) and currently-open circuit breakers — a rising redispatch
    # rate or any stuck-open breaker is a capacity/SLO signal the fleet
    # supervisor and watchdog can alert or scale on.
    rd = _series_sum(all_samples, "areal_rollout_redispatch_total")
    if rd is not None:
        signals["redispatch"] = rd
    bo = _series_sum(all_samples, "areal_rollout_breaker_open")
    if bo is not None:
        signals["breaker_open"] = bo
    # Pipelined-step occupancy (labeled per-stage gauges -> computed
    # fleet signals): wall-clock of an overlapped step ~= the busiest
    # stage, so that stage's fill approaching 1.0 means the pipeline is
    # tight; the summed per-stage bubble seconds is the idle the
    # overlap exists to shrink.  Absent when pipeline_overlap is off.
    fills = [
        v for n, labels, v in all_samples
        if n == "areal_master_pipeline_fill_ratio"
    ]
    if fills:
        signals["pipeline_fill"] = max(fills)
    bubs = [
        v for n, labels, v in all_samples
        if n == "areal_master_pipeline_bubble_seconds"
    ]
    if bubs:
        signals["pipeline_bubble"] = sum(bubs)
    # Checkpoint freshness: seconds since the master last committed a
    # recover checkpoint (the atomic flip stamps
    # areal_ckpt_last_success_timestamp_seconds).  A rule like
    # ``crit: ckpt_age < 900`` requires recoverability to stay under 15
    # minutes of lost work.  Absent until the first flip.
    ts = [
        v for n, labels, v in all_samples
        if n == "areal_ckpt_last_success_timestamp_seconds" and v > 0
    ]
    if ts:
        signals["ckpt_age"] = max(0.0, time.time() - max(ts))
    # Numerical-integrity guard plane: sentinel trips summed over kinds
    # (the raw series is labeled, so rules can't address it directly),
    # the master's live quarantine streak, and checksum-rejected weight
    # pushes.  ``warn: anomalies <= 0`` surfaces the first quarantined
    # step; ``crit: quarantine_streak <= 2`` pages one step before the
    # escalation ladder rolls the trial back; ``crit: push_rejected == 0``
    # means a generation server saw a corrupt weight payload.
    an = _series_sum(all_samples, "areal_train_anomaly_total")
    if an is not None:
        signals["anomalies"] = an
    qs = _series_sum(all_samples, "areal_master_consecutive_quarantines")
    if qs is not None:
        signals["quarantine_streak"] = qs
    pr = _series_sum(all_samples, "areal_gen_weight_push_rejected_total")
    if pr is not None:
        signals["push_rejected"] = pr
    # Parameter distribution fabric: whole-push latency p99 (one
    # areal_param_push_seconds observation per fleet broadcast or
    # cross-set realloc push).  ``crit: push_p99 <= 30`` pages when
    # weight distribution starts eating the training step.  Absent
    # until the first push.
    pp = _hist_quantile(all_samples, "areal_param_push_seconds", 0.99)
    if not math.isnan(pp):
        signals["push_p99"] = pp
    # Verifier fleet (system/verifier_pool.py): grade round-trip p99
    # over all backends and the pool client's in-flight item count —
    # the capacity signals the supervisor's verifier lane scales on.
    # ``crit: grade_latency_p99 <= 5`` spawns a worker when sandboxed
    # grading starts eating the sample pipeline; ``crit:
    # verifier_queue_depth <= 64`` catches a backed-up pool before
    # episode completion stalls on rewards.  Absent until the first
    # pooled grade.
    gl = _hist_quantile(all_samples, "areal_verifier_grade_seconds", 0.99)
    if not math.isnan(gl):
        signals["grade_latency_p99"] = gl
    vq = _series_sum(all_samples, "areal_verifier_queue_depth")
    if vq is not None:
        signals["verifier_queue_depth"] = vq
    vs = _series_sum(all_samples, "areal_verifier_pool_servers")
    if vs is not None:
        signals["verifier_servers"] = vs
    vb = _series_sum(all_samples, "areal_verifier_breaker_open")
    if vb is not None:
        signals["verifier_breaker_open"] = vb
    # Per-task reward curves (labeled areal_mixture_task_reward gauges
    # -> computed min): ``warn: task_reward_min >= 0.2`` pages when any
    # task stream's reward EMA collapses — the curriculum's floor.
    trs = [
        v for n, labels, v in all_samples
        if n == "areal_mixture_task_reward"
    ]
    if trs:
        signals["task_reward_min"] = min(trs)
    # Placement-advisor health: the master's online cost-model residual
    # (DFG-composed per-MFC walls vs the measured step,
    # areal_master_advisor_pred_err_ratio) and the spread of per-MFC MFU
    # (the labeled areal_mfc_mfu_ratio gauges -> computed min/max).
    # ``warn: advisor_pred_err <= 0.5`` flags when the advisor's
    # composition stops tracking reality (its rankings are then stale);
    # ``warn: mfc_mfu_min >= 0.02`` surfaces an MFC whose placement is
    # starving it.  Absent until the first completed step.
    ae = [
        v for n, labels, v in all_samples
        if n == "areal_master_advisor_pred_err_ratio"
    ]
    if ae:
        signals["advisor_pred_err"] = max(ae)
    mfus = [
        v for n, labels, v in all_samples
        if n == "areal_mfc_mfu_ratio" and labels.get("mfc") != "all"
    ]
    if mfus:
        signals["mfc_mfu_min"] = min(mfus)
        signals["mfc_mfu_max"] = max(mfus)
    # Raw unlabeled series become rule-addressable too (last wins on
    # duplicates; labeled series need the computed signals above).
    for n, labels, v in all_samples:
        if not labels and n not in signals:
            signals[n] = v
    return signals, rows


# ---------------------------------------------------------------------------
# Rendering


_COLS = (
    ("role", 24), ("ok", 3), ("goodput", 9), ("queue_depth", 11),
    ("kv_util", 8), ("live_slots", 10), ("idle_frac", 9),
    ("version", 8), ("steps", 6),
)


def render_table(rows: List[Dict[str, object]],
                 signals: Dict[str, float]) -> str:
    lines = []
    hdr = "  ".join(name.ljust(w) for name, w in _COLS)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for row in rows:
        cells = []
        for name, w in _COLS:
            v = row.get(name, "")
            if isinstance(v, bool):
                v = "y" if v else "N"
            elif isinstance(v, float) and v == int(v):
                v = int(v)
            cells.append(str(v).ljust(w))
        lines.append("  ".join(cells).rstrip())
        if row.get("error"):
            lines.append(f"    !! {row['error']}")
    keys = (
        "goodput", "staleness_p50", "staleness_p99", "sample_e2e_p50",
        "sample_e2e_p99", "sample_admit_p99", "queue_depth",
        "kv_utilization", "idle_frac", "version_skew", "backpressure",
        "pipeline_fill", "pipeline_bubble", "anomalies",
        "quarantine_streak", "push_rejected", "weight_version_skew",
        "push_p99", "grade_latency_p99", "verifier_queue_depth",
        "verifier_servers", "verifier_breaker_open", "task_reward_min",
    )
    fleet = ", ".join(
        f"{k}={signals[k]:.4g}" for k in keys if k in signals
    )
    lines.append(f"fleet: {fleet}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Driver


def run_watchdog(
    endpoints: Dict[str, str],
    rules: List[SLORule],
    count: Optional[int],
    interval: float,
    as_json: bool = False,
    out=sys.stdout,
) -> int:
    """Poll, render, evaluate.  Returns the number of CRIT violations."""
    history: List[Dict[str, float]] = []
    prev: Optional[Dict[str, RoleScrape]] = None
    crits = 0
    i = 0
    while count is None or i < count:
        if i > 0:
            time.sleep(interval)
        roles = scrape_fleet(endpoints)
        signals, rows = fleet_signals(roles, prev)
        history.append(signals)
        prev = {r.role: r for r in roles}
        violations = []
        for rule in rules:
            msg = rule.evaluate(history)
            if msg is not None:
                violations.append((rule.severity, msg))
                if rule.severity == "crit":
                    crits += 1
        if as_json:
            print(json.dumps({
                "scrape": i,
                "signals": signals,
                "roles": rows,
                "violations": [
                    {"severity": s, "message": m} for s, m in violations
                ],
            }), file=out)
        else:
            print(f"--- scrape {i} ---", file=out)
            print(render_table(rows, signals), file=out)
            for sev, msg in violations:
                print(f"{sev.upper()}: {msg}", file=out)
        i += 1
    return crits


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.metrics_report")
    p.add_argument("--experiment", default="")
    p.add_argument("--trial", default="trial")
    p.add_argument(
        "--url", action="append", default=[],
        metavar="ROLE=URL",
        help="static endpoint (repeatable); bare URLs get role names "
             "server0, server1, ...",
    )
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--count", type=int, default=None,
                   help="scrapes to run (default: until interrupted)")
    p.add_argument("--slo", action="append", default=[],
                   help="SLO rule (repeatable); see module docstring")
    p.add_argument("--slo-file", default=None)
    p.add_argument("--json", action="store_true",
                   help="one JSON object per scrape instead of tables")
    args = p.parse_args(argv)

    endpoints: Dict[str, str] = {}
    if args.experiment:
        endpoints.update(discover(args.experiment, args.trial))
    for j, spec in enumerate(args.url):
        if "=" in spec and not spec.split("=", 1)[0].startswith("http"):
            role, url = spec.split("=", 1)
        else:
            role, url = f"server{j}", spec
        endpoints[role] = url
    if not endpoints:
        print("no endpoints: pass --experiment (announced roles) or --url",
              file=sys.stderr)
        return 2

    rule_texts = list(args.slo)
    if args.slo_file:
        with open(args.slo_file) as f:
            rule_texts += [
                ln for ln in (l.strip() for l in f)
                if ln and not ln.startswith("#")
            ]
    rules = [parse_slo_rule(t) for t in rule_texts]

    crits = run_watchdog(
        endpoints, rules, args.count, args.interval, as_json=args.json
    )
    return 1 if crits else 0


if __name__ == "__main__":
    raise SystemExit(main())
