"""The port's metrics plane against the JAX package's, on the CPU:

- `base/metrics.py`: twins of tests/test_metrics.py's TestRegistry,
  TestExposition, TestWindows and TestServer, run on both packages; the
  same operations give the same `expose()` text, and each package's
  text parses by both packages' `parse_prometheus_text` into the same
  samples; `quantile_from_buckets` agrees on seeded random bucket sets;
- `apps/metrics_report.py`: twins of TestSLO; `parse_slo_rule` over
  good and bad rules (the same `SLORule`s, the same errors);
  `fleet_signals` and `render_table` equal on the same scrapes with the
  clock fixed; `run_watchdog --json` lines and `main`'s exit codes
  equal against the same `MetricsServer` endpoints;
- the series of a tiny trial: the quarantine-rollback trial of
  tests/test_torch_recover.py (a NONFINITE step, recover checkpoints,
  a rollback) in each package, each on a registry of its own, exports
  the same series names and label sets with the same counts; the
  master's `_export_step_metrics` fed the same stats sets the same
  gauges; a seeded serving-plane `generate` with n > 1 bumps the same
  ``areal_kv_*`` and ``areal_gen_*`` series.

The process-wide default registries are never reset: a test that reads
them compares deltas or swaps in registries of its own."""

import contextlib
import dataclasses
import functools
import io
import json
import math
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.apps import metrics_report as jmr
from areal_tpu.base import integrity as jintegrity
from areal_tpu.base import metrics as jmetrics
from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.base import names as jnames
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.system import master as jmaster
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.apps import metrics_report as mr
from areal_tpu_torch.base import integrity, metrics, name_resolve, names
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.system import master as tmaster
from tests.test_torch_generator import _samples
from tests.test_torch_recover import _reward, _trial, ckpt  # noqa: F401 (fixture)

torch.set_num_threads(2)

PKGS = {
    "jax": types.SimpleNamespace(metrics=jmetrics, mr=jmr, name_resolve=jname_resolve,
                                 names=jnames, integrity=jintegrity, master=jmaster),
    "port": types.SimpleNamespace(metrics=metrics, mr=mr, name_resolve=name_resolve,
                                  names=names, integrity=integrity, master=tmaster),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def reg(pkg):
    return pkg.metrics.Registry(window=4)


@pytest.fixture()
def store_root(tmp_path, monkeypatch):
    """Both packages' default name_resolve on one file store."""
    root = str(tmp_path / "nr")
    monkeypatch.setattr(name_resolve, "_default", name_resolve.FileNameResolveRepository(root))
    monkeypatch.setattr(jname_resolve, "_default", jname_resolve.FileNameResolveRepository(root))
    return root


# ---------------- the registry (twins of tests/test_metrics.py) ----------------


class TestRegistry:
    def test_counter_monotonic(self, reg):
        c = reg.counter("areal_t_events_total", "h")
        c.inc()
        c.inc(2.5)
        assert c.get() == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        assert c.get() == 3.5

    def test_counter_name_must_end_total(self, reg):
        with pytest.raises(ValueError, match="_total"):
            reg.counter("areal_t_events", "h")

    def test_bad_names_rejected(self, reg):
        with pytest.raises(ValueError):
            reg.gauge("0bad", "h")
        with pytest.raises(ValueError):
            reg.gauge("areal_ok", "h", labelnames=("bad-label",))

    def test_get_or_create_and_conflict(self, reg):
        g1 = reg.gauge("areal_t_depth", "h")
        g2 = reg.gauge("areal_t_depth", "other help tolerated")
        assert g1 is g2
        with pytest.raises(ValueError, match="conflicting"):
            reg.gauge("areal_t_depth", "h", labelnames=("x",))
        with pytest.raises(ValueError, match="conflicting"):
            reg.histogram("areal_t_depth", "h", buckets=(1,))
        h = reg.histogram("areal_t_h_seconds", "h", buckets=(1, 2))
        assert reg.histogram("areal_t_h_seconds", "h", buckets=(2, 1)) is h
        with pytest.raises(ValueError, match="conflicting"):
            reg.histogram("areal_t_h_seconds", "h", buckets=(1, 3))

    def test_histogram_bucketing(self, reg):
        h = reg.histogram("areal_t_lat_seconds", "h", buckets=(0.1, 1, 10))
        for v in (0.05, 0.5, 0.5, 5, 50):
            h.observe(v)
        counts, s, n = h.snapshot()
        assert counts == (1, 2, 1, 1)
        assert n == 5
        assert s == pytest.approx(56.05)

    def test_gauge_set_inc_dec(self, reg):
        g = reg.gauge("areal_t_gauge", "h")
        g.set(5)
        g.inc(2)
        g.dec()
        assert g.get() == 6

    def test_label_cardinality_guard(self, reg, pkg):
        c = reg.counter("areal_t_lbl_total", "h", labelnames=("k",))
        for i in range(pkg.metrics.MAX_LABEL_SETS + 10):
            c.labels(f"v{i}").inc()
        kids = dict(c.children())
        assert len(kids) == pkg.metrics.MAX_LABEL_SETS + 1  # the cap and _overflow
        assert kids[("_overflow",)].get() == 10
        assert c.dropped_label_sets == 10

    def test_labels_positional_and_kw(self, reg):
        c = reg.counter("areal_t_kw_total", "h", labelnames=("a", "b"))
        c.labels("x", "y").inc()
        c.labels(a="x", b="y").inc()
        assert c.labels("x", "y").get() == 2
        with pytest.raises(ValueError, match="not both"):
            c.labels("x", b="y")
        with pytest.raises(ValueError, match="unknown label"):
            c.labels(a="x")

    def test_disabled_registry_is_inert(self, reg, pkg):
        c = reg.counter("areal_t_off_total", "h")
        g = reg.gauge("areal_t_off", "h")
        h = reg.histogram("areal_t_off_seconds", "h", buckets=(1,))
        pkg.metrics.configure(enabled=False)
        try:
            assert not pkg.metrics.enabled()
            c.inc(100)
            g.set(3)
            h.observe(0.5)
        finally:
            pkg.metrics.configure(enabled=True)
        assert pkg.metrics.enabled()
        assert (c.get(), g.get(), h.snapshot()[2]) == (0, 0, 0)
        c.inc()
        assert c.get() == 1

    def test_names_lists_the_registered(self, reg):
        reg.gauge("areal_t_b", "h")
        reg.counter("areal_t_a_total", "h")
        assert reg.names() == ["areal_t_a_total", "areal_t_b"]
        assert reg.get("areal_t_b").kind == "gauge" and reg.get("areal_t_none") is None


class TestExposition:
    def test_round_trip(self, reg, pkg):
        c = reg.counter("areal_t_req_total", "h", labelnames=("status",))
        c.labels("ok").inc(3)
        c.labels('we"ird\n').inc()
        reg.gauge("areal_t_depth", "queue depth").set(7)
        h = reg.histogram("areal_t_lat_seconds", "h", buckets=(1, 10))
        h.observe(0.5)
        h.observe(20)
        samples, types_ = pkg.metrics.parse_prometheus_text(reg.expose())
        assert types_ == {
            "areal_t_req_total": "counter",
            "areal_t_depth": "gauge",
            "areal_t_lat_seconds": "histogram",
        }
        sd = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
        assert sd[("areal_t_req_total", (("status", "ok"),))] == 3
        assert sd[("areal_t_req_total", (("status", 'we"ird\n'),))] == 1
        assert sd[("areal_t_depth", ())] == 7
        assert sd[("areal_t_lat_seconds_bucket", (("le", "1"),))] == 1
        assert sd[("areal_t_lat_seconds_bucket", (("le", "10"),))] == 1
        assert sd[("areal_t_lat_seconds_bucket", (("le", "+Inf"),))] == 2
        assert sd[("areal_t_lat_seconds_count", ())] == 2
        assert sd[("areal_t_lat_seconds_sum", ())] == pytest.approx(20.5)

    def test_quantile_from_buckets(self, pkg):
        q = pkg.metrics.quantile_from_buckets
        pairs = [(0.1, 1), (1.0, 1), (10.0, 2), (float("inf"), 2)]
        assert q(pairs, 0.5) == pytest.approx(0.1)
        assert q(pairs, 0.99) == pytest.approx(9.82, abs=0.01)
        assert math.isnan(q([], 0.5))
        assert math.isnan(q([(1.0, 0), (float("inf"), 0)], 0.5))

    def test_malformed_line_raises(self, pkg):
        with pytest.raises(ValueError, match="unparseable"):
            pkg.metrics.parse_prometheus_text("areal_x{a=\"b\" 1 2\n")
        with pytest.raises(ValueError, match="bad sample value"):
            pkg.metrics.parse_prometheus_text("areal_x one\n")


def _populate(reg, m):
    """The same operations on a registry of either package."""
    c = reg.counter("areal_x_req_total", "requests", labelnames=("status", "path"))
    c.labels("ok", "/a").inc(3)
    c.labels(status='we"ird\\', path="x\ny").inc(0.25)
    for i in range(m.MAX_LABEL_SETS + 3):
        reg.counter("areal_x_many_total", "many", ("k",)).labels(f"k{i}").inc(i)
    g = reg.gauge("areal_x_depth", "depth")
    g.set(1e20)
    reg.gauge("areal_x_ratio", "a ratio").set(1 / 3)
    reg.gauge("areal_x_nan", "odd values", ("v",)).labels("nan").set(float("nan"))
    reg.gauge("areal_x_nan", "odd values", ("v",)).labels("inf").set(float("-inf"))
    h = reg.histogram("areal_x_lat_seconds", "latency", ("role",), buckets=(0.5, 0.05, 5))
    rng = np.random.default_rng(3)
    for v in rng.exponential(1.0, size=40):
        h.labels("gen").observe(float(v))
    h.labels("train").observe(7.0)
    reg.histogram("areal_x_unused_seconds", "no observations")


def test_exposition_equal_across_packages():
    regs = {k: p.metrics.Registry() for k, p in PKGS.items()}
    for k, r in regs.items():
        _populate(r, PKGS[k].metrics)
    texts = {k: r.expose() for k, r in regs.items()}
    assert texts["port"] == texts["jax"]
    for text in texts.values():
        got = [p.metrics.parse_prometheus_text(text) for p in PKGS.values()]
        assert repr(got[0]) == repr(got[1])  # NaN-safe equality
    assert len(got[0][0]) > 150


def test_default_exposition_parses_alike():
    """Each package's process-wide registry (every series the modules
    imported so far registered) parses by both parsers into the same
    samples."""
    for p in PKGS.values():
        text = p.metrics.default_registry().expose()
        a, b = (q.metrics.parse_prometheus_text(text) for q in PKGS.values())
        assert repr(a) == repr(b)


@pytest.mark.parametrize("seed", range(6))
def test_quantile_from_buckets_agrees(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    bounds = sorted(set(np.round(rng.exponential(2.0, size=n), 3).tolist()))
    counts = np.cumsum(rng.integers(0, 5, size=len(bounds) + 1)).tolist()
    pts = list(zip(bounds + [float("inf")], counts))
    rng.shuffle(pts)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        got = [p.metrics.quantile_from_buckets(list(pts), q) for p in PKGS.values()]
        assert repr(got[0]) == repr(got[1]), (pts, q)


class TestWindows:
    def test_ring_buffer_window(self, reg):
        g = reg.gauge("areal_t_w", "h")
        for i in range(6):  # window=4: the first two scrapes fall off
            g.set(i)
            reg.scrape(now=float(i))
        assert reg.window("areal_t_w") == [(2.0, 2.0), (3.0, 3.0), (4.0, 4.0), (5.0, 5.0)]
        assert reg.scrapes == 6

    def test_histogram_scalar_series(self, reg):
        h = reg.histogram("areal_t_h_seconds", "h", buckets=(1,))
        h.observe(0.5)
        reg.scrape(now=1.0)
        h.observe(2.0)
        snap = reg.scrape(now=2.0)
        assert reg.window("areal_t_h_seconds_count") == [(1.0, 1.0), (2.0, 2.0)]
        assert reg.window("areal_t_h_seconds_sum")[-1] == (2.0, 2.5)
        assert snap[("areal_t_h_seconds_count", ())] == 2.0

    def test_labeled_window(self, reg):
        c = reg.counter("areal_t_lw_total", "h", labelnames=("s",))
        c.labels("a").inc()
        reg.scrape(now=1.0)
        assert reg.window("areal_t_lw_total", ("a",)) == [(1.0, 1.0)]
        assert reg.window("areal_t_lw_total", ("zz",)) == []


class TestServer:
    def test_http_scrape_and_announce(self, pkg, store_root):
        reg = pkg.metrics.Registry()
        reg.gauge("areal_t_live", "h").set(3)
        srv = pkg.metrics.MetricsServer(registry=reg)
        key = pkg.names.metrics_endpoint("e2e_t", "t0", "gen_server/1")
        try:
            with urllib.request.urlopen(srv.url + "/metrics", timeout=5) as r:
                body = r.read().decode()
                ctype = r.headers["Content-Type"]
            assert "text/plain" in ctype and "version=0.0.4" in ctype
            samples, _ = pkg.metrics.parse_prometheus_text(body)
            assert ("areal_t_live", {}, 3.0) in samples
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(srv.url + "/nope", timeout=5)
            srv.announce("e2e_t", "t0", "gen_server/1")
            assert pkg.name_resolve.get(key) == srv.url
            # Either package's discovery finds it in the shared store.
            for p in PKGS.values():
                assert p.mr.discover("e2e_t", "t0") == {"gen_server/1": srv.url}
        finally:
            srv.close()
        with pytest.raises(pkg.name_resolve.NameEntryNotFoundError):
            pkg.name_resolve.get(key)

    def test_announce_at_construction(self, pkg, store_root):
        srv = pkg.metrics.MetricsServer(registry=pkg.metrics.Registry(),
                                        announce=("e", "t", "master"))
        try:
            assert mr.discover("e", "t") == {"master": srv.url}
        finally:
            srv.close()
        assert mr.discover("e", "t") == {}


# ---------------- SLO rules (twins of TestSLO) ----------------


class TestSLO:
    def test_parse_defaults_to_crit(self, pkg):
        r = pkg.mr.parse_slo_rule("staleness_p99 <= 4")
        assert (r.severity, r.signal, r.op, r.value) == ("crit", "staleness_p99", "<=", 4.0)

    def test_threshold_violation_and_pass(self, pkg):
        r = pkg.mr.parse_slo_rule("warn: queue_depth < 10")
        assert r.evaluate([{"queue_depth": 12.0}]) is not None
        assert r.evaluate([{"queue_depth": 3.0}]) is None
        assert r.evaluate([{}]) is None  # an absent signal is no violation
        assert r.evaluate([{"queue_depth": float("nan")}]) is None
        assert r.evaluate([]) is None

    def test_drop_rule_percent_and_window(self, pkg):
        r = pkg.mr.parse_slo_rule("crit: drop(goodput) < 20% over 3")
        assert r.value == pytest.approx(0.2)
        msg = r.evaluate([{"goodput": 50.0}, {"goodput": 100.0}, {"goodput": 75.0}])
        assert msg is not None and "25.0%" in msg
        assert r.evaluate([{"goodput": 100.0}, {"goodput": 90.0}]) is None
        assert r.evaluate([{"goodput": 100.0}] + [{"goodput": 60.0}] * 3) is None
        assert r.evaluate([{"goodput": 0.0}, {"goodput": 0.0}]) is None  # no peak

    def test_parse_errors(self, pkg):
        with pytest.raises(ValueError):
            pkg.mr.parse_slo_rule("drop(goodput) < 0.2")  # no window
        with pytest.raises(ValueError):
            pkg.mr.parse_slo_rule("fatal: x < 1")  # unknown severity
        with pytest.raises(ValueError):
            pkg.mr.parse_slo_rule("x ~ 1")

    def test_advisor_slo_rules_evaluate(self, pkg):
        err = pkg.mr.parse_slo_rule("warn: advisor_pred_err <= 0.5")
        mfu = pkg.mr.parse_slo_rule("warn: mfc_mfu_min >= 0.02")
        assert err.evaluate([{"advisor_pred_err": 0.7}]) is not None
        assert err.evaluate([{"advisor_pred_err": 0.2}]) is None
        assert mfu.evaluate([{"mfc_mfu_min": 0.01}]) is not None
        assert mfu.evaluate([{"mfc_mfu_min": 0.05}]) is None
        assert err.evaluate([{}]) is None


GOOD_RULES = (
    "staleness_p99 <= 4", "warn: queue_depth < 10", "crit:goodput>=1e3",
    "  crit : drop(goodput) < 20% over 3  ", "warn: drop( goodput ) <= 0.5 over 10",
    "kv_utilization != 1", "version_skew == 0", "ckpt_age < 900", "x > -2.5e-1",
    "warn: mfc_mfu_min >= 2%", "idle_frac <= 0.95 over 4",
)
BAD_RULES = (
    "drop(goodput) < 0.2", "fatal: x < 1", "x ~ 1", "", "x <", "warn: 1x < 2",
    "x < 1 over", "drop(goodput) < 0.2 over x", "x < abc", "x < 1.2.3",
)


@pytest.mark.parametrize("text", GOOD_RULES + BAD_RULES)
def test_parse_slo_rule_matches_jax(text):
    out = {}
    for k, p in PKGS.items():
        try:
            out[k] = ("ok", dataclasses.asdict(p.mr.parse_slo_rule(text)))
        except ValueError as e:
            out[k] = ("error", str(e))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("ok" if text in GOOD_RULES else "error")


@pytest.mark.parametrize("text", GOOD_RULES)
def test_rule_verdicts_match_jax(text):
    rng = np.random.default_rng(len(text))
    sig = dataclasses.asdict(mr.parse_slo_rule(text))["signal"]
    hist = [{sig: float(v)} for v in rng.normal(1.0, 2.0, size=12)]
    for i in range(1, len(hist) + 1):
        got = [p.mr.parse_slo_rule(text).evaluate(hist[:i]) for p in PKGS.values()]
        assert got[0] == got[1]


# ---------------- fleet signals and the watchdog ----------------


def _fleet_registries(m):
    """A generation server's, the master's, a verifier's and the replay
    buffer's series, in registries of package `m`."""
    gen, master, ver = m.Registry(), m.Registry(), m.Registry()
    gen.counter("areal_gen_tokens_total", "h").inc(480)
    gen.gauge("areal_gen_goodput_tokens_per_second", "h").set(32.5)
    gen.gauge("areal_gen_queue_depth", "h").set(2)
    gen.gauge("areal_gen_kv_utilization_ratio", "h").set(0.4375)
    gen.gauge("areal_gen_live_slots", "h").set(3)
    gen.gauge("areal_gen_capacity_slots", "h").set(8)
    gen.gauge("areal_gen_weight_version", "h").set(3)
    gen.counter("areal_gen_weight_push_rejected_total", "h").inc(1)
    master.counter("areal_master_steps_total", "h").inc(7)
    master.gauge("areal_master_advisor_pred_err_ratio", "h").set(0.125)
    mfu = master.gauge("areal_mfc_mfu_ratio", "h", ("mfc",))
    for k, v in (("actor_gen", 0.02), ("actor_train", 0.31), ("all", 0.9)):
        mfu.labels(k).set(v)
    master.gauge("areal_ckpt_last_success_timestamp_seconds", "h").set(990.0)
    master.counter("areal_train_anomaly_total", "h", ("kind",)).labels("nonfinite").inc(2)
    master.gauge("areal_master_consecutive_quarantines", "h").set(1)
    fill = master.gauge("areal_master_pipeline_fill_ratio", "h", ("stage",))
    bub = master.gauge("areal_master_pipeline_bubble_seconds", "h", ("stage",))
    for st, f, b in (("gen", 0.5, 1.25), ("train", 0.75, 0.5)):
        fill.labels(st).set(f)
        bub.labels(st).set(b)
    st = master.histogram("areal_replay_staleness", "h", buckets=(0, 1, 2, 4))
    for v in (0, 1, 1, 2, 3):
        st.observe(v)
    e2e = master.histogram("areal_sample_e2e_seconds", "h", buckets=(1, 10, 100))
    for v in (0.5, 5, 50):
        e2e.observe(v)
    master.histogram("areal_sample_admit_seconds", "h", buckets=(1, 10)).observe(2)
    master.histogram("areal_param_push_seconds", "h", buckets=(1, 10)).observe(3)
    master.counter("areal_rollout_backpressure_total", "h").inc(4)
    master.gauge("areal_rollout_in_flight", "h").set(5)
    master.counter("areal_rollout_redispatch_total", "h", ("reason",)).labels("dead").inc(2)
    master.gauge("areal_rollout_breaker_open", "h").set(1)
    tr = master.gauge("areal_mixture_task_reward", "h", ("task",))
    tr.labels("math").set(0.25)
    tr.labels("code").set(-0.5)
    ver.histogram("areal_verifier_grade_seconds", "h", ("backend",),
                  buckets=(0.1, 1, 5)).labels("v0").observe(0.7)
    ver.gauge("areal_verifier_queue_depth", "h").set(6)
    ver.gauge("areal_verifier_pool_servers", "h").set(2)
    ver.gauge("areal_verifier_breaker_open", "h").set(0)
    return {"gen_server/8101": gen, "master": master, "verifier/v0": ver}


def _scrapes(p, texts, t, fail=()):
    out = []
    for role, text in texts.items():
        if role in fail:
            out.append(p.mr.RoleScrape(role, t, [], ok=False, error="URLError('refused')"))
        else:
            out.append(p.mr.RoleScrape(role, t, p.metrics.parse_prometheus_text(text)[0]))
    return out


@contextlib.contextmanager
def _fixed_clock(*mods, now=1000.0):
    """Each module's `time` replaced: time() fixed at `now`, monotonic()
    counting scrapes one second apart, sleep() a no-op."""
    saved = [m.time for m in mods]

    def fake():
        tick = iter(range(10**6))
        return types.SimpleNamespace(time=lambda: now, monotonic=lambda: float(next(tick)),
                                     sleep=lambda s: None)

    try:
        for m in mods:
            m.time = fake()
        yield
    finally:
        for m, t in zip(mods, saved):
            m.time = t


@pytest.mark.parametrize("fail", [(), ("verifier/v0",)])
def test_fleet_signals_and_table_match_jax(fail):
    texts = {role: r.expose() for role, r in _fleet_registries(metrics).items()}
    # The previous scrape 10 s earlier, with 160 tokens fewer.
    prev_texts = dict(texts)
    prev_texts["gen_server/8101"] = texts["gen_server/8101"].replace(
        "areal_gen_tokens_total 480", "areal_gen_tokens_total 160")
    out = {}
    with _fixed_clock(jmr, mr):
        for k, p in PKGS.items():
            roles = _scrapes(p, texts, 10.0, fail)
            prev = {r.role: r for r in _scrapes(p, prev_texts, 0.0)}
            first = p.mr.fleet_signals(roles, None)
            second = p.mr.fleet_signals(roles, prev)
            out[k] = (first, second, p.mr.render_table(second[1], second[0]))
    assert out["port"] == out["jax"]
    (sig0, _), (sig, rows), _ = out["port"]
    assert sig0["goodput"] == 32.5  # the gauge without a previous scrape
    assert sig["goodput"] == pytest.approx(32.0)  # (480 - 160) / 10
    assert sig["ckpt_age"] == 10.0 and sig["mfc_mfu_min"] == 0.02
    assert sig["mfc_mfu_max"] == 0.31 and sig["task_reward_min"] == -0.5
    assert ("grade_latency_p99" in sig) == (not fail)
    assert [r["ok"] for r in rows] == [True, True, not fail]


def test_fleet_signals_without_series_match_jax():
    with _fixed_clock(jmr, mr):
        got = [p.mr.fleet_signals([p.mr.RoleScrape("master", 1.0, [])], None)
               for p in PKGS.values()]
    assert got[0] == got[1]
    assert set(got[0][0]) == {"goodput", "queue_depth", "kv_utilization", "idle_frac",
                              "version_skew", "weight_version_skew"}


@pytest.fixture()
def endpoints():
    """The fleet's registries served by the port's MetricsServer, plus a
    role whose server is down."""
    servers = [metrics.MetricsServer(registry=r) for r in _fleet_registries(metrics).values()]
    roles = list(_fleet_registries(metrics))
    eps = {role: s.url for role, s in zip(roles, servers)}
    dead = metrics.MetricsServer(registry=metrics.Registry())
    eps["gen_server/dead"] = dead.url
    dead.close()
    yield eps
    for s in servers:
        s.close()


def test_run_watchdog_json_matches_jax(endpoints):
    rules = ["crit: queue_depth <= 1", "warn: goodput >= 100", "kv_utilization <= 0.9",
             "warn: drop(goodput) < 10% over 3"]
    out = {}
    with _fixed_clock(jmr, mr):
        for k, p in PKGS.items():
            buf = io.StringIO()
            crits = p.mr.run_watchdog(endpoints, [p.mr.parse_slo_rule(r) for r in rules],
                                      count=3, interval=0.0, as_json=True, out=buf)
            out[k] = (crits, [json.loads(line) for line in buf.getvalue().splitlines()])
    assert out["port"] == out["jax"]
    crits, lines = out["port"]
    assert crits == 3 and [ln["scrape"] for ln in lines] == [0, 1, 2]
    assert [r["ok"] for r in lines[0]["roles"]] == [True, True, True, False]


@pytest.mark.parametrize("rule,code", [("crit: queue_depth <= 5", 0),
                                       ("crit: queue_depth <= 1", 1),
                                       ("warn: queue_depth <= 1", 0)])
def test_main_exit_codes_match_jax(endpoints, rule, code):
    urls = [f"{role}={url}" for role, url in endpoints.items() if "dead" not in role]
    args = [a for u in urls for a in ("--url", u)] + ["--count", "2", "--interval", "0",
                                                      "--slo", rule]
    with _fixed_clock(jmr, mr):
        got = [p.mr.main(args) for p in PKGS.values()]
    assert got == [code, code]


def test_main_discovers_and_refuses_without_endpoints(store_root, capsys, tmp_path):
    """`main` over the announced roles with a rule file (one CRIT: exit
    1), and exit 2 when nothing is announced."""
    rules = tmp_path / "rules.txt"
    rules.write_text("# a comment\n\ncrit: queue_depth <= 0\n")
    reg = metrics.Registry()
    reg.gauge("areal_gen_queue_depth", "h").set(2)
    reg.counter("areal_gen_tokens_total", "h")
    srv = metrics.MetricsServer(registry=reg, announce=("exp", "tr", "gen_server/1"))
    out = {}
    try:
        with _fixed_clock(jmr, mr):
            for k, p in PKGS.items():
                rc = p.mr.main(["--experiment", "exp", "--trial", "tr", "--count", "1",
                                "--json", "--slo-file", str(rules)])
                none = p.mr.main(["--experiment", "other", "--count", "1"])
                out[k] = (rc, none, capsys.readouterr().err)
    finally:
        srv.close()
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (1, 2) and "no endpoints" in out["port"][2]


# ---------------- the series of a tiny trial ----------------


@contextlib.contextmanager
def _own_registries():
    """Both packages' default registry swapped for a fresh one (what is
    built inside registers there), restored after."""
    saved = {k: p.metrics._default for k, p in PKGS.items()}
    fresh = {k: p.metrics.Registry() for k, p in PKGS.items()}
    try:
        for k, p in PKGS.items():
            p.metrics._default = fresh[k]
        yield fresh
    finally:
        for k, p in PKGS.items():
            p.metrics._default = saved[k]


def _series(p, reg):
    samples, _ = p.metrics.parse_prometheus_text(reg.expose())
    return {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}


def _anomalies(p):
    return {k: c.get() for (k,), c in p.integrity.M_ANOMALY.children()}


# Series whose values depend on wall time: compared by name and labels only.
_TIMED = ("areal_master_step_seconds_sum", "areal_master_step_seconds_bucket",
          "areal_worker_mfc_seconds_sum", "areal_worker_mfc_seconds_bucket",
          "areal_mfc_wall_seconds", "areal_mfc_tflops", "areal_master_advisor_pred_err_ratio",
          "areal_ckpt_last_success_timestamp_seconds", "areal_gen_goodput_tokens_per_second")


def test_tiny_trial_series_match_jax(tmp_path, ckpt):  # noqa: F811 (fixture)
    """The quarantine-rollback trial (NaN rewards at the second reward
    call quarantine step 2 with a NONFINITE verdict; recover checkpoints
    every step; the streak of one rolls back to step 1 and replays): the
    same series names and label sets in both packages, the same counts."""
    series, anomalies = {}, {}
    with _own_registries() as regs:
        with _reward(nan_calls={2}):
            for k in ("jax", "port"):
                before = _anomalies(PKGS[k])
                _trial(k, ckpt, tmp_path / k, 12, 3, ckpt_freq=1, mcq=1)
                after = _anomalies(PKGS[k])
                anomalies[k] = {kind: after[kind] - before.get(kind, 0.0) for kind in after
                                if after[kind] != before.get(kind, 0.0)}
                series[k] = _series(PKGS[k], regs[k])
    # One trip a minibatch of the quarantined step (two), in both packages.
    assert anomalies["port"] == anomalies["jax"] == {"nonfinite": 2.0}
    assert set(series["port"]) == set(series["jax"])
    exact = {key: v for key, v in series["port"].items() if key[0] not in _TIMED}
    assert exact == {key: series["jax"][key] for key in exact}
    s = series["port"]
    assert s[("areal_master_steps_total", ())] == 4  # three steps, one replayed
    assert s[("areal_master_quarantined_steps_total", ())] == 1
    assert s[("areal_master_quarantine_rollbacks_total", ())] == 1
    assert s[("areal_master_recoveries_total", ())] == 1
    assert s[("areal_master_consecutive_quarantines", ())] == 0
    assert s[("areal_ckpt_flips_total", ())] == 3  # steps 1, 2 (replayed) and 3
    assert s[("areal_ckpt_last_success_timestamp_seconds", ())] > 0
    calls = {dict(key[1])["mfc"]: v for key, v in s.items()
             if key[0] == "areal_worker_mfc_seconds_count"}
    assert calls and all(v == 4 for v in calls.values()), calls
    tokens = {dict(key[1])["mfc"]: v for key, v in s.items()
              if key[0] == "areal_worker_mfc_tokens_total"}
    assert set(tokens) == set(calls) and all(v > 0 for v in tokens.values())
    assert s[("areal_gen_tokens_total", ())] == 4 * 8 * 8  # 4 x (4 prompts x 2) x 8 new
    walls = {dict(key[1])["mfc"] for key in s if key[0] == "areal_mfc_wall_seconds"}
    assert walls == {"actor_gen", "actor_train", "ref_inf", "rew_inf"}
    assert set(calls) == {"actor@0:train_step", "actor_gen@0:generate", "ref@0:inference",
                          "reward@0:inference"}
    # No MFU off the card, in either package.
    assert not any(key[0] in ("areal_mfc_mfu_ratio", "areal_worker_mfc_mfu_ratio")
                   for key in s)


class _Node:
    def __init__(self, name):
        self.name = name


class _DFG:
    def __init__(self, levels):
        self._levels = [[_Node(n) for n in lvl] for lvl in levels]
        self.nodes = [n for lvl in self._levels for n in lvl]

    def topological_order(self):
        return self._levels


def _export_stub(p, reg, levels):
    reg_m = types.SimpleNamespace(dfg=_DFG(levels))
    reg_m._m_steps = reg.counter("areal_master_steps_total", "h")
    reg_m._m_step_seconds = reg.histogram("areal_master_step_seconds", "h",
                                          buckets=(0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 300))
    reg_m._m_mfc_seconds = reg.gauge("areal_mfc_wall_seconds", "h", ("mfc",))
    reg_m._m_mfc_mfu = reg.gauge("areal_mfc_mfu_ratio", "h", ("mfc",))
    reg_m._m_mfc_tflops = reg.gauge("areal_mfc_tflops", "h", ("mfc",))
    reg_m._m_advisor_err = reg.gauge("areal_master_advisor_pred_err_ratio", "h")
    cls = p.master.MasterWorker
    reg_m._export_advisor_residual = functools.partial(cls._export_advisor_residual, reg_m)
    return functools.partial(cls._export_step_metrics, reg_m)


@pytest.mark.parametrize("levels", [[["gen"], ["rew", "ref"], ["train"]], [["train"]]])
def test_export_step_metrics_matches_jax(levels):
    """The MFU and TFLOP/s gauges (set only where a step has perf/mfu, on
    the card) from the same stats dict: the same exposition."""
    names_ = [n for lvl in levels for n in lvl]
    texts = {}
    for k, p in PKGS.items():
        rng = np.random.default_rng(len(levels))
        reg = p.metrics.Registry()
        export = _export_stub(p, reg, levels)
        for step_s in (1.5, 0.25):
            stats = {"time/step_s": step_s, "perf/mfu": 0.5, "perf/tflops": 9.75}
            for n in names_:
                stats[f"{n}/perf/time_s"] = float(rng.uniform(0.01, 0.5))
                stats[f"{n}/perf/mfu"] = float(rng.uniform(0.01, 0.6))
                stats[f"{n}/perf/tflops"] = float(rng.uniform(1, 400))
                stats[f"{n}/loss"] = 1.0
            if len(levels) == 1:
                stats["perf/time_s"] = stats.pop("train/perf/time_s")
            export(stats, step_s)
        texts[k] = reg.expose()
    assert texts["port"] == texts["jax"]
    assert "\nareal_master_advisor_pred_err_ratio " in texts["port"]
    assert 'areal_mfc_mfu_ratio{mfc="all"} 0.5' in texts["port"]


def test_serving_plane_generate_series_match_jax():
    """A seeded serving-plane generate with n = 2 (prompt pages shared in
    each group, copy-on-write at the shared tail): the same
    ``areal_kv_*`` counts, tokens, live slots and KV gauges."""
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    kw = dict(kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2, eos_token_id=7)
    js, ts = _samples((4, 11, 6, 9, 5), seed=5)
    series = {}
    with _own_registries() as regs:
        je = JEngine(jtiny(), pj, mesh, kv_paged=True, **kw)
        te = GeneratorEngine(tiny_config(), pt, "cpu", **kw)
        je.generate(js, JSpec(), JGen(n=2, max_new_tokens=8, greedy=True), inflight=True)
        te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(
            n=2, max_new_tokens=8, greedy=True), inflight=True)
        for k in PKGS:
            series[k] = _series(PKGS[k], regs[k])
        compiles = {"jax": je.decode_compiles, "port": te.decode_compiles}
    assert set(series["port"]) == set(series["jax"])
    for key, v in series["port"].items():
        if key[0] in ("areal_gen_goodput_tokens_per_second", "areal_gen_decode_compiles_total"):
            continue
        assert v == series["jax"][key], key
    s = series["port"]
    kv = {key[0]: v for key, v in s.items() if key[0].startswith("areal_kv_")}
    assert set(kv) == {"areal_kv_prefix_hits_total", "areal_kv_prefix_misses_total",
                       "areal_kv_cow_copies_total", "areal_kv_shared_mappings_total"}
    assert kv["areal_kv_shared_mappings_total"] > 0
    assert s[("areal_gen_tokens_total", ())] == 5 * 2 * 8
    assert s[("areal_gen_goodput_tokens_per_second", ())] > 0
    assert s[("areal_gen_live_slots", ())] == 0
    assert 0 < s[("areal_gen_kv_utilization_ratio", ())] <= 1
    for k in PKGS:
        assert series[k][("areal_gen_decode_compiles_total", ())] == compiles[k]


# ---------------- /metrics in every process of a multi-process trial ----------------


def test_multiprocess_trial_serves_metrics_in_every_process(tmp_path):
    """`apps.main.run_experiment` on the CPU: while the workers still
    serve, the trial's metrics subtree lists exactly master,
    model_worker/0 and model_worker/1; `python -m
    areal_tpu_torch.apps.metrics_report --json` over them exits 0 and
    reads the master's step count; each worker's MFC calls are the steps;
    after the trial every key is gone (each server closed)."""
    import os
    import subprocess
    import sys

    from areal_tpu.models.hf import registry as jhf
    from areal_tpu_torch.apps import main as runner
    from tests import fixtures
    from tests.test_torch_multiprocess import ONE_THREAD, _port_cfg, _port_plan

    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    data = tmp_path / "math.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in fixtures.build_math_rows(8, seed=4)))
    plan = _port_plan(_port_cfg((tmp_path, ckpt, str(data)), "mp"))
    E, T = plan.experiment_name, plan.trial_name
    seen = {}
    steps = metrics.default_registry().get("areal_master_steps_total")
    steps_before = steps.get() if steps is not None else 0.0

    def on_finish(master):
        seen["roles"] = mr.discover(E, T)
        seen["scrape"] = {x.role: x for x in mr.scrape_fleet(seen["roles"])}
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        r = subprocess.run([sys.executable, "-m", "areal_tpu_torch.apps.metrics_report",
                            "--experiment", E, "--trial", T, "--count", "2", "--interval", "0.2",
                            "--json", "--slo", "crit: version_skew <= 0"],
                           capture_output=True, text=True, timeout=120, env=env)
        seen["rc"], seen["out"], seen["err"] = r.returncode, r.stdout, r.stderr
        seen["steps"] = len(master.stats_history)

    saved = {k: os.environ.get(k) for k in ("AREAL_NAME_RESOLVE", "AREAL_NAME_RESOLVE_ROOT",
                                            "AREAL_TRIAL_AUTHKEY")}
    default = name_resolve._default
    try:
        runner.run_experiment(plan, device="cpu", worker_env=ONE_THREAD, on_finish=on_finish)
        after = mr.discover(E, T)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        name_resolve._default = default
    assert sorted(seen["roles"]) == ["master", "model_worker/0", "model_worker/1"]
    assert seen["rc"] == 0, seen["err"]
    lines = [json.loads(x) for x in seen["out"].splitlines()]
    last = lines[-1]
    assert [r["role"] for r in last["roles"]] == ["master", "model_worker/0", "model_worker/1"]
    assert all(r["ok"] for r in last["roles"]) and not last["violations"]
    assert seen["steps"] == 2
    assert last["signals"]["areal_master_steps_total"] == steps_before + 2
    assert "advisor_pred_err" in last["signals"]
    for w in ("model_worker/0", "model_worker/1"):
        calls = {lb["mfc"]: v for n, lb, v in seen["scrape"][w].samples
                 if n == "areal_worker_mfc_seconds_count"}
        assert calls and all(v == 2 for v in calls.values()), (w, calls)
    assert after == {}
