"""The port's fleet supervisor against the JAX package's, on the CPU:

- twins of tests/test_fleet.py's TestFleetSupervisor and
  TestRecoverFleetState and of tests/test_verifier_pool.py's
  TestVerifierLane, run on both packages on a fake clock;
- seeded signal histories drive both packages' `FleetSupervisor` (with
  a verifier `SupervisorLane`) on one fake clock: the same decision
  sequence (action, reason, victim), epochs and persisted fleet state;
  `run()` over a served, announced registry takes the same actions;
- three behaviours of the reference this slice settles:
  (1) a drain through `apps.fleet.main` (stub servers that announce
  ``s<port>`` and serve a scripted ``/metrics``): the JAX entrypoint
  deregisters the drained server but leaves its process running, the
  port's also stops the process (its gen-server fleet is keyed
  ``s<port>``), the deliberate difference;
  (2) ``areal_gen_queue_depth`` is not the live queue in either
  package: requests that pile up behind a running generate call show
  in the gauge only after ``/health`` or the next batch pick;
  (3) after traffic stops the goodput signal holds the last call's
  gauge, so a server that has served never reads idle under the
  default ``idle_goodput`` (copied, in both packages)."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.apps import fleet as jfleet_app
from areal_tpu.apps import metrics_report as jmr
from areal_tpu.base import metrics as jmetrics
from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.base import recover as jrecover
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.system import fleet as jfleet
from areal_tpu.system import gen_server as jgen_server
from areal_tpu_torch.apps import fleet as fleet_app
from areal_tpu_torch.apps import metrics_report as mr
from areal_tpu_torch.base import metrics, name_resolve, names, recover
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.system import fleet
from areal_tpu_torch.system import gen_server

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(fleet=jfleet, mr=jmr, name_resolve=jname_resolve,
                                 recover=jrecover, app=jfleet_app, metrics=jmetrics,
                                 gen_server=jgen_server),
    "port": types.SimpleNamespace(fleet=fleet, mr=mr, name_resolve=name_resolve,
                                  recover=recover, app=fleet_app, metrics=metrics,
                                  gen_server=gen_server),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def store_root(tmp_path, monkeypatch):
    """Both packages' default name_resolve on one file store, and the
    environment that points child processes at it."""
    root = str(tmp_path / "nr")
    monkeypatch.setenv("AREAL_NAME_RESOLVE", "file")
    monkeypatch.setenv("AREAL_NAME_RESOLVE_ROOT", root)
    monkeypatch.setattr(name_resolve, "_default", name_resolve.FileNameResolveRepository(root))
    monkeypatch.setattr(jname_resolve, "_default", jname_resolve.FileNameResolveRepository(root))
    return root


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _announce(sid, trial="t"):
    name_resolve.add(names.gen_server("e", trial, sid), f"http://h/{sid}", replace=True)


# ---------------- twins of TestFleetSupervisor ----------------


class TestFleetSupervisor:
    def _sup(self, pkg, **kw):
        kw.setdefault("rules", [pkg.mr.parse_slo_rule("crit: staleness_p99 <= 4")])
        kw.setdefault("clock", _Clock())
        return pkg.fleet.FleetSupervisor(
            "e", "t", spawn=kw.pop("spawn", None), drain=kw.pop("drain", None), **kw,
        )

    def test_crit_capacity_violation_spawns(self, pkg):
        spawned = []
        _announce("s1")
        sup = self._sup(pkg, spawn=lambda: spawned.append("x"), max_servers=2)
        d = sup.evaluate({"staleness_p99": 9.0, "goodput": 100.0})
        assert d.action == "spawn"
        sup.apply(d)
        assert spawned == ["x"] and sup.membership_epoch == 1

    def test_spawn_respects_max_servers_and_cooldown(self, pkg):
        clk = _Clock()
        _announce("s1")
        _announce("s2")
        sup = self._sup(pkg, max_servers=2, clock=clk)
        d = sup.evaluate({"staleness_p99": 9.0})
        assert d.action == "hold" and "max_servers" in d.reason
        sup2 = self._sup(pkg, spawn=lambda: None, max_servers=8, action_cooldown_s=30.0,
                         clock=clk)
        sup2.apply(sup2.evaluate({"staleness_p99": 9.0}))
        d = sup2.evaluate({"staleness_p99": 9.0})
        assert d.action == "hold" and "cooling down" in d.reason
        clk.t = 31.0
        assert sup2.evaluate({"staleness_p99": 9.0}).action == "spawn"

    def test_sustained_idle_drains_but_not_below_min(self, pkg):
        drained = []
        _announce("s1")
        _announce("s2")
        idle = {"staleness_p99": 0.0, "goodput": 0.0, "idle_frac": 1.0, "in_flight": 0.0}
        sup = self._sup(pkg, drain=drained.append, min_servers=1, idle_rounds=3)
        assert sup.evaluate(dict(idle)).action == "hold"
        assert sup.evaluate(dict(idle)).action == "hold"
        d = sup.evaluate(dict(idle))
        assert d.action == "drain" and d.victim == "s2"
        sup.apply(d)
        assert drained == ["s2"]
        sup2 = self._sup(pkg, min_servers=1, idle_rounds=2)
        sup2.evaluate(dict(idle))
        sup2.evaluate({"staleness_p99": 0.0, "goodput": 50.0, "idle_frac": 0.1,
                       "in_flight": 4.0})
        assert sup2.evaluate(dict(idle)).action == "hold"
        name_resolve.delete(names.gen_server("e", "t", "s2"))
        sup3 = self._sup(pkg, min_servers=1, idle_rounds=1)
        assert sup3.evaluate(dict(idle)).action == "hold"

    def test_membership_epoch_persists_through_recover_info(self, pkg, tmp_path):
        _announce("s1")
        root = str(tmp_path)
        sup = self._sup(pkg, spawn=lambda: None, recover_root=root, max_servers=4)
        sup.apply(sup.evaluate({"staleness_p99": 9.0}))
        assert sup.membership_epoch == 1
        info = pkg.recover.load(root)
        assert info.fleet_state["membership_epoch"] == 1
        assert info.fleet_state["servers"] == ["s1"]
        assert self._sup(pkg, recover_root=root).membership_epoch == 1

    def test_persist_merges_with_existing_recover_info(self, pkg, tmp_path):
        root = str(tmp_path)
        pkg.recover.dump(pkg.recover.RecoverInfo(rollout_state={"cursor": 7}), root)
        _announce("s1")
        sup = self._sup(pkg, spawn=lambda: None, recover_root=root)
        sup.apply(sup.evaluate({"staleness_p99": 9.0}))
        info = pkg.recover.load(root)
        assert info.rollout_state == {"cursor": 7}
        assert info.fleet_state["membership_epoch"] == 1

    def test_unconfigured_actions_hold_the_epoch(self, pkg):
        _announce("s1")
        _announce("s2")
        sup = self._sup(pkg, max_servers=4, idle_rounds=1)
        sup.apply(sup.evaluate({"staleness_p99": 9.0}))
        sup.apply(sup.evaluate({"goodput": 0.0, "idle_frac": 1.0}))
        assert sup.membership_epoch == 0

    def test_param_repair_runs_each_round_and_failures_are_advisory(self, pkg):
        calls = []

        def repair():
            calls.append(1)
            raise RuntimeError("a subtree is down")

        _announce("s1")
        sup = self._sup(pkg, param_repair=repair)
        assert sup.run(count=3, interval=0.0) == []
        assert len(calls) == 3 and len(sup.history) == 3


# ---------------- twins of TestRecoverFleetState ----------------


class TestRecoverFleetState:
    def test_fleet_state_round_trip(self, pkg, tmp_path):
        info = pkg.recover.RecoverInfo(
            replay_watermarks={"version": 5},
            rollout_state={"cursor": 40, "membership_epoch": 3},
            fleet_state={"membership_epoch": 3, "servers": ["s1", "s2"]},
        )
        pkg.recover.dump(info, str(tmp_path))
        back = pkg.recover.load(str(tmp_path))
        assert back.fleet_state == {"membership_epoch": 3, "servers": ["s1", "s2"]}
        assert back.rollout_state["membership_epoch"] == 3
        assert back.replay_watermarks == {"version": 5}

    def test_old_pickle_without_fleet_state_backfills(self, pkg, tmp_path):
        import pickle

        info = pkg.recover.RecoverInfo()
        del info.__dict__["fleet_state"]
        with open(tmp_path / pkg.recover.RECOVER_FILE, "wb") as f:
            pickle.dump(info, f)
        assert pkg.recover.load(str(tmp_path)).fleet_state == {}

    def test_default_is_empty(self, pkg):
        assert pkg.recover.RecoverInfo().fleet_state == {}
        assert pkg.recover.RecoverInfo().fleet_state is not pkg.recover.RecoverInfo().fleet_state


# ---------------- twins of TestVerifierLane ----------------


class TestVerifierLane:
    def _lane(self, pkg, live, clk, **kw):
        kw.setdefault("rules", [pkg.mr.parse_slo_rule("crit: grade_latency_p99 <= 5")])
        return pkg.fleet.SupervisorLane(
            name="verifier",
            list_servers=lambda: list(live),
            spawn=lambda: live.append(f"v{len(live)}"),
            drain=lambda sid: live.remove(sid),
            clock=clk,
            **kw,
        )

    def test_crit_latency_violation_spawns(self, pkg):
        live = ["v0"]
        lane = self._lane(pkg, live, _Clock(), max_servers=4)
        d = lane.evaluate([{"grade_latency_p99": 9.0}])
        assert d.action == "spawn" and "grade_latency_p99" in d.reason
        lane.apply(d)
        assert live == ["v0", "v1"] and lane.epoch == 1

    def test_spawn_respects_max_servers_and_cooldown(self, pkg):
        clk = _Clock()
        hot = [{"grade_latency_p99": 9.0}]
        lane = self._lane(pkg, ["v0", "v1"], clk, max_servers=2)
        d = lane.evaluate(hot)
        assert d.action == "hold" and "max_servers" in d.reason
        live = ["v0"]
        lane2 = self._lane(pkg, live, clk, max_servers=8, action_cooldown_s=30.0)
        lane2.step(hot)
        assert live == ["v0", "v1"]
        assert lane2.evaluate(hot).action == "hold"
        clk.t = 31.0
        assert lane2.evaluate(hot).action == "spawn"

    def test_refill_after_ttl_eviction_bypasses_cooldown(self, pkg):
        clk = _Clock()
        live = ["v0", "v1"]
        lane = self._lane(pkg, live, clk, min_servers=2, action_cooldown_s=1000.0)
        lane.step([{"grade_latency_p99": 9.0}])
        assert len(live) == 3
        live.clear()
        live.append("v0")
        d = lane.evaluate([{"grade_latency_p99": 0.0}])
        assert d.action == "spawn" and "refill" in d.reason
        lane.apply(d)
        assert len(live) == 2

    def test_sustained_idle_drains_but_not_below_min(self, pkg):
        live = ["v0", "v1"]
        lane = self._lane(pkg, live, _Clock(), min_servers=1, idle_rounds=2,
                          action_cooldown_s=0.0)
        idle = [{"grade_latency_p99": 0.1, "verifier_queue_depth": 0.0}]
        assert lane.step(idle).action == "hold"
        d = lane.step(idle)
        assert d.action == "drain" and d.victim == "v1"
        assert live == ["v0"]
        for _ in range(5):
            assert lane.step(idle).action == "hold"

    def test_traffic_resets_the_idle_streak(self, pkg):
        lane = self._lane(pkg, ["v0", "v1"], _Clock(), min_servers=1, idle_rounds=2,
                          action_cooldown_s=0.0)
        idle = {"grade_latency_p99": 0.1, "verifier_queue_depth": 0.0}
        busy = {"grade_latency_p99": 0.1, "verifier_queue_depth": 7.0}
        assert lane.step([idle]).action == "hold"
        assert lane.step([busy]).action == "hold"
        assert lane.step([idle]).action == "hold"
        assert lane.step([idle]).action == "drain"


# ---------------- one decision sequence in both packages ----------------


def _signals(rng, n):
    """Signal histories in regimes: pressure, calm traffic, idle."""
    out = []
    for i in range(n):
        regime = (i // 6) % 3
        s = {
            "staleness_p99": float(rng.uniform(5, 9) if regime == 0 else rng.uniform(0, 3)),
            "queue_depth": float(rng.integers(0, 20) if regime == 0 else 0),
            "goodput": float(0.0 if regime == 2 else rng.uniform(10, 500)),
            "idle_frac": float(1.0 if regime == 2 else rng.uniform(0, 0.9)),
            "grade_latency_p99": float(rng.uniform(0, 9)),
            "verifier_queue_depth": float(0 if regime == 2 else rng.integers(0, 80)),
        }
        if regime != 2 and rng.random() < 0.5:
            s["in_flight"] = float(rng.integers(1, 9))
        if rng.random() < 0.3:
            s["backpressure"] = float(rng.integers(0, 6))
        out.append(s)
    return out


def _drive(p, trial, history, root):
    clk = _Clock()
    seq = {"n": 0}
    live = ["v0"]

    def spawn():
        seq["n"] += 1
        p.name_resolve.add(names.gen_server("e", trial, f"s{100 + seq['n']}"), "http://h",
                           replace=True)

    def drain(sid):
        p.name_resolve.delete(names.gen_server("e", trial, sid))

    lane = p.fleet.SupervisorLane(
        "verifier", list_servers=lambda: sorted(live),
        rules=[p.mr.parse_slo_rule(r) for r in ("crit: grade_latency_p99 <= 5",
                                                 "crit: verifier_queue_depth <= 64",
                                                 "warn: grade_latency_p99 <= 1")],
        spawn=lambda: live.append(f"v{len(live) + seq['n']}"), drain=live.remove,
        min_servers=1, max_servers=3, action_cooldown_s=12.0, idle_rounds=2, clock=clk)
    p.name_resolve.add(names.gen_server("e", trial, "s100"), "http://h", replace=True)
    sup = p.fleet.FleetSupervisor(
        "e", trial,
        rules=[p.mr.parse_slo_rule(r) for r in ("crit: staleness_p99 <= 4",
                                                 "warn: queue_depth <= 2",
                                                 "crit: queue_depth <= 8",
                                                 "crit: backpressure <= 3",
                                                 "crit: drop(goodput) < 90% over 4")],
        spawn=spawn, drain=drain, min_servers=1, max_servers=4, action_cooldown_s=12.0,
        idle_rounds=2, recover_root=root, clock=clk, lanes=[lane])
    out = []
    for i, s in enumerate(history):
        clk.t = 5.0 * i
        d = sup.evaluate(dict(s))
        sup.apply(d)
        out.append(("fleet", d.action, d.reason, d.victim))
        ld = lane.step(sup.history)
        if ld.action != "hold":
            sup.persist()
        out.append(("lane", ld.action, ld.reason, ld.victim))
    info = p.recover.load(root)
    return out, sup.membership_epoch, lane.epoch, info.fleet_state


@pytest.mark.parametrize("seed", range(4))
def test_decision_sequences_match_jax(tmp_path, seed):
    history = _signals(np.random.default_rng(seed), 36)
    got = {k: _drive(p, f"t{k}", history, str(tmp_path / k)) for k, p in PKGS.items()}
    assert got["port"] == got["jax"]
    seq, epoch, lane_epoch, state = got["port"]
    actions = {a for _, a, _, _ in seq}
    assert {"spawn", "drain", "hold"} <= actions
    assert epoch > 0 and lane_epoch > 0
    assert state["membership_epoch"] == epoch
    assert state["lanes"]["verifier"]["epoch"] == lane_epoch
    # A restarted supervisor resumes both epochs.
    for k, p in PKGS.items():
        lane = p.fleet.SupervisorLane("verifier", list_servers=list)
        sup = p.fleet.FleetSupervisor("e", f"t{k}", recover_root=str(tmp_path / k),
                                      lanes=[lane])
        assert (sup.membership_epoch, lane.epoch) == (epoch, lane_epoch)


def test_run_over_served_metrics_matches_jax(tmp_path):
    """`run()` scrapes the announced roles through the metrics report: a
    CRIT on the served queue depth spawns, in both packages alike."""
    reg = metrics.Registry()
    reg.gauge("areal_gen_queue_depth", "h").set(12)
    reg.counter("areal_gen_tokens_total", "h").inc(5)
    reg.gauge("areal_gen_capacity_slots", "h").set(4)
    out = {}
    for k, p in PKGS.items():
        srv = metrics.MetricsServer(registry=reg, announce=("e", f"r{k}", "gen_server/1"))
        p.name_resolve.add(names.gen_server("e", f"r{k}", "s1"), srv.url, replace=True)
        spawned = []
        sup = p.fleet.FleetSupervisor(
            "e", f"r{k}", rules=[p.mr.parse_slo_rule("crit: queue_depth <= 8")],
            spawn=lambda: spawned.append(1), max_servers=3, action_cooldown_s=0.0,
            recover_root=str(tmp_path / k))
        try:
            acts = sup.run(count=3, interval=0.0)
        finally:
            srv.close()
        out[k] = ([dataclasses.asdict(a) for a in acts], len(spawned),
                  [{s: h[s] for s in ("queue_depth", "goodput", "idle_frac")}
                   for h in sup.history])
    assert out["port"] == out["jax"]
    assert out["port"][1] == 3


# ---------------- behaviour 1: the drain, through apps.fleet.main ----------------

_STUB = r'''
import argparse, http.server, os, threading, time
from areal_tpu_torch.base import name_resolve, names

p = argparse.ArgumentParser()
p.add_argument("--port", type=int)
p.add_argument("--experiment")
p.add_argument("--trial")
p.add_argument("--busy")
a = p.parse_args()


class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        q = 5 if os.path.exists(a.busy) else 0
        body = (f"areal_gen_queue_depth {q}\nareal_gen_tokens_total 0\n"
                "areal_gen_live_slots 0\nareal_gen_capacity_slots 4\n").encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


srv = http.server.ThreadingHTTPServer(("127.0.0.1", a.port), H)
url = f"http://127.0.0.1:{a.port}"
key = names.gen_server(a.experiment, a.trial, f"s{a.port}")
name_resolve.add(names.metrics_endpoint(a.experiment, a.trial, f"gen_server/{a.port}"), url,
                 replace=True)
name_resolve.add(key, url, keepalive_ttl=30.0, replace=True)


def beat():
    while True:
        time.sleep(1.0)
        name_resolve.default().touch(key)


threading.Thread(target=beat, daemon=True).start()
srv.serve_forever()
'''


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = sorted(s.getsockname()[1] for s in socks)
    for s in socks:
        s.close()
    return ports


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _recording_fleet(base, rec):
    """`base` (a package's LocalProcessFleet) that records, at the
    supervisor's drain, whether the drained server's process is still
    running, then interrupts the supervisor as an operator's Ctrl-C would
    (main shuts the fleet down and returns)."""

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.drain_grace_s = 1.0
            self.spawned = {}
            rec["fleet"] = self

        def spawn(self):
            sid = super().spawn()
            self.spawned[sid] = self.procs[sid]
            return sid

        def drain(self, server_id):
            if "victim" in rec:  # the shutdown's drains
                return super().drain(server_id)
            t0 = time.monotonic()
            super().drain(server_id)
            (proc,) = self.spawned.values()
            try:
                proc.wait(timeout=self.drain_grace_s + 3.0)
                alive = False
            except subprocess.TimeoutExpired:
                alive = True
            rec.update(victim=server_id, alive=alive, drain_s=time.monotonic() - t0,
                       listed=fleet.fleet_discovery(self.experiment, self.trial)())
            raise KeyboardInterrupt

    return Recording


@pytest.mark.parametrize("name,alive", [("jax", True), ("port", False)])
def test_supervisor_drain_stops_the_process_only_in_the_port(tmp_path, monkeypatch, name,
                                                             alive):
    """One stub server runs (s<p1>), announced and busy: the CRIT
    spawns s<p2> through `apps.fleet.main`'s LocalProcessFleet; the
    queue then empties, and once s<p2> announces, the idle rounds drain
    it, the last in sorted order.  Its key goes in both packages; its process
    exits within the drain grace only in the port."""
    p = PKGS[name]
    stub = tmp_path / "stub.py"
    stub.write_text(_STUB)
    busy = tmp_path / "busy"
    busy.write_text("1")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rec = {}
    monkeypatch.setattr(p.app, "LocalProcessFleet", _recording_fleet(p.fleet.LocalProcessFleet,
                                                                      rec))
    p1, p2 = _free_ports(2)
    assert len(str(p1)) == len(str(p2))
    trial = f"drain-{name}"
    cmd = [sys.executable, str(stub), "--experiment", "e", "--trial", trial, "--busy", str(busy)]
    first = subprocess.Popen(cmd + ["--port", str(p1)])
    view = fleet.fleet_discovery("e", trial)

    def go_idle():
        # The queue empties as soon as the supervisor has spawned: a round
        # that still lists one server sees no CRIT to spawn again on.
        _wait(lambda: rec.get("fleet") is not None and rec["fleet"].spawned, 60, "the spawn")
        os.remove(busy)

    helper = threading.Thread(target=go_idle, daemon=True)
    try:
        _wait(lambda: f"s{p1}" in view(), 60, "the first server")
        helper.start()
        spawn_cmd = " ".join(cmd + ["--port", "{port}"])
        rc = p.app.main(["--experiment", "e", "--trial", trial, "--slo", "crit: queue_depth <= 0",
                         "--spawn-cmd", spawn_cmd, "--base-port", str(p2), "--min-servers", "1",
                         "--max-servers", "2", "--interval", "0.2", "--count", "300",
                         "--action-cooldown", "2", "--idle-rounds", "3"])
        helper.join(timeout=60)
        assert rc == 0
        assert rec["victim"] == f"s{p2}"
        assert rec["listed"] == {f"s{p1}": f"http://127.0.0.1:{p1}"}
        assert rec["alive"] is alive
        # main's shutdown stops every process it spawned, in both packages.
        (proc,) = rec["fleet"].spawned.values()
        assert proc.wait(timeout=30) is not None
        assert first.poll() is None
    finally:
        first.kill()
        first.wait(timeout=30)
        for proc in rec.get("fleet", types.SimpleNamespace(spawned={})).spawned.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_cli_keys_the_gen_fleet_by_the_server_id(monkeypatch):
    """The port's CLI builds its gen-server fleet with sid_prefix "s";
    the class keeps the reference's default "port"."""
    made = {}

    class Spy(fleet.LocalProcessFleet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.setdefault("fleets", []).append(self)

    for p in PKGS.values():
        made.clear()
        monkeypatch.setattr(p.app, "LocalProcessFleet", Spy)
        assert p.app.main(["--experiment", "e", "--trial", "k", "--spawn-cmd", "true {port}",
                           "--verifier-spawn-cmd", "true {port}", "--count", "1",
                           "--interval", "0"]) == 0
        gen, ver = made["fleets"]
        assert ver.sid_prefix == "v"
        assert gen.sid_prefix == ("s" if p is PKGS["port"] else "port")
    assert fleet.LocalProcessFleet(["x"], "e", "t").sid_prefix == "port"


# ---------------- behaviour 2: the queue-depth gauge ----------------


def _queue_gauge(url):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith("areal_gen_queue_depth "):
            return float(line.split()[1])
    raise AssertionError("no areal_gen_queue_depth")


def _post(url, payload):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", ["jax", "port"])
def test_queue_depth_gauge_lags_the_live_queue(name):
    """A request blocks in the engine; three more queue behind it.  The
    gauge still reads the depth left at the last batch pick (0) until
    `/health` is polled, which sets it to 3; once the engine returns,
    the next batch pick takes all three and the gauge reads 0."""
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(3))
    kw = dict(eos_token_id=7, kv_page_size=8, max_decode_batch=4)
    if name == "jax":
        mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
        engine = JEngine(jtiny(), pj, mesh, **kw)
        srv = jgen_server.GenerationServer(engine, max_wait_ms=5.0, zmq_port=None)
    else:
        pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
        engine = GeneratorEngine(tiny_config(), pt, "cpu", **kw)
        srv = gen_server.GenerationServer(engine, max_wait_ms=5.0)
    entered, gate = threading.Event(), threading.Event()
    real = engine.generate

    def blocking(*a, **k):
        entered.set()
        assert gate.wait(120)
        return real(*a, **k)

    engine.generate = blocking
    req = lambda i: dict(qid=f"q{i}", prompt_ids=[11 + i, 12, 13], n=1, max_new_tokens=2,
                         greedy=True)
    threads, replies = [], {}
    try:
        def send(i):
            replies[i] = _post(srv.url, req(i))

        threads.append(threading.Thread(target=send, args=(0,), daemon=True))
        threads[0].start()
        assert entered.wait(60)
        entered.clear()
        for i in (1, 2, 3):
            threads.append(threading.Thread(target=send, args=(i,), daemon=True))
            threads[-1].start()
        _wait(lambda: srv._queue.qsize() == 3, 60, "three queued requests")
        assert _queue_gauge(srv.url) == 0  # not the live queue
        with urllib.request.urlopen(srv.url + "/health", timeout=30) as r:
            assert json.loads(r.read())["queue_depth"] == 3
        assert _queue_gauge(srv.url) == 3
        gate.set()
        for t in threads:
            t.join(timeout=120)
        assert sorted(replies) == [0, 1, 2, 3]
        assert _queue_gauge(srv.url) == 0  # the next pick took all three
    finally:
        gate.set()
        srv.close()


# ---------------- behaviour 3: the goodput signal after traffic stops ----------------


def test_goodput_signal_holds_the_last_call_after_traffic_stops(pkg):
    """Between two scrapes of an idle server its token counter does not
    move, so `fleet_signals` falls back to the goodput gauge, which holds
    the last completed call's tokens/s: a server that has served never
    reads idle under the default `idle_goodput`, in either package.  A
    supervisor that should drain on idleness alone passes
    ``idle_goodput=inf`` (idle_frac and in_flight still decide)."""
    samples = [("areal_gen_tokens_total", {}, 5120.0),
               ("areal_gen_goodput_tokens_per_second", {}, 812.5),
               ("areal_gen_live_slots", {}, 0.0), ("areal_gen_capacity_slots", {}, 32.0),
               ("areal_gen_queue_depth", {}, 0.0)]
    prev = {"gen_server/1": pkg.mr.RoleScrape("gen_server/1", 0.0, samples)}
    sig, _ = pkg.mr.fleet_signals([pkg.mr.RoleScrape("gen_server/1", 2.0, samples)], prev)
    assert sig["goodput"] == 812.5 and sig["idle_frac"] == 1.0
    _announce("s1")
    _announce("s2")
    rule = [pkg.mr.parse_slo_rule("crit: queue_depth <= 8")]
    default = pkg.fleet.FleetSupervisor("e", "t", rules=rule, drain=lambda s: None,
                                        idle_rounds=3, clock=_Clock())
    assert all(default.evaluate(dict(sig)).action == "hold" for _ in range(10))
    frac_only = pkg.fleet.FleetSupervisor("e", "t", rules=rule, drain=lambda s: None,
                                          idle_rounds=3, idle_goodput=float("inf"),
                                          clock=_Clock())
    got = [frac_only.evaluate(dict(sig)) for _ in range(3)]
    assert [d.action for d in got] == ["hold", "hold", "drain"] and got[-1].victim == "s2"


def test_a_spawn_counts_only_once_it_announces(pkg):
    """The supervisor counts the announced servers only: a spawn that
    has not announced by the end of the cooldown is spawned again under
    the same CRIT, in both packages (a harness that starts slow servers
    counts its pending spawns itself, as chip_smoke's supervisor phase
    does)."""
    clk = _Clock()
    spawned = []
    _announce("s1")
    sup = pkg.fleet.FleetSupervisor(
        "e", "t", rules=[pkg.mr.parse_slo_rule("crit: queue_depth <= 8")],
        spawn=lambda: spawned.append(len(spawned)), max_servers=2, action_cooldown_s=10.0,
        clock=clk)
    hot = {"queue_depth": 30.0}
    sup.apply(sup.evaluate(dict(hot)))
    clk.t = 5.0
    assert sup.evaluate(dict(hot)).action == "hold"  # cooling down
    clk.t = 11.0
    d = sup.evaluate(dict(hot))
    assert d.action == "spawn"  # the first spawn never announced
    sup.apply(d)
    assert spawned == [0, 1] and sup.membership_epoch == 2
