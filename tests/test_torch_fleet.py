"""The port's fleet membership against the JAX package's, on the CPU:

- `fleet_discovery` lists the servers announced in either package's
  file store, and a key whose keepalive stops beating drops out;
- the port's ``python -m areal_tpu_torch.system.gen_server`` CLI on
  ``--device cpu``, spawned by `LocalProcessFleet` beside the JAX CLI
  spawned by the JAX `LocalProcessFleet`: both announce (the fleet key
  and the ``/metrics`` endpoint), answer ``/health``, take the same
  traffic (generates and a fabric push) and expose the same
  ``areal_gen_*`` and ``areal_param*`` metric names, but for the JAX
  engine's own gauges; a drain deregisters each and stops its process;
- with the default ``sid_prefix`` a drain deletes no key (a server
  announces ``s<port>``) and the key expires by its TTL: the
  reference's behaviour, pinned in both packages;
- a CLI server killed at ``kill@point=param_push`` orphans its subtree,
  its key expires by its TTL and its process exits (the port's CLI
  leaves when its server stops; the JAX CLI's process lingers);
- a `RolloutController(discovery=fleet_discovery(...), paramstore=...)`
  over in-process port servers gives the JAX controller's outcomes: a
  late join, a leave drained and reaped, and the version pins moving
  with a fabric push."""

import asyncio
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.engines import generator as jgenerator
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system import fleet as jfleet
from areal_tpu.system import paramstore as jps
from areal_tpu.system import replay as jreplay
from areal_tpu.system import rollout as jrollout
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.system import fleet as tfleet
from areal_tpu_torch.system import paramstore as tps
from areal_tpu_torch.system import replay as treplay
from areal_tpu_torch.system import rollout as trollout
from areal_tpu_torch.system.gen_server import GenerationServer
from areal_tpu_torch.models.config import tiny_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 7
PKGS = {
    "jax": (jname_resolve, jfleet, jps, jmodel_api, jreplay, jrollout),
    "port": (name_resolve, tfleet, tps, tmodel_api, treplay, trollout),
}


@pytest.fixture()
def store_root(tmp_path, monkeypatch):
    """Both packages' default name_resolve on one file store (and the
    environment that points child processes at it)."""
    root = str(tmp_path / "nr")
    monkeypatch.setenv("AREAL_NAME_RESOLVE", "file")
    monkeypatch.setenv("AREAL_NAME_RESOLVE_ROOT", root)
    monkeypatch.setattr(name_resolve, "_default", name_resolve.FileNameResolveRepository(root))
    monkeypatch.setattr(jname_resolve, "_default", jname_resolve.FileNameResolveRepository(root))
    return root


def _np_params(seed):
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(seed)))


def _wait(cond, timeout=120.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_discovery_over_either_store(store_root, writer):
    nr = PKGS[writer][0]
    nr.add(names.gen_server("e", "t", "s1"), "http://127.0.0.1:1", keepalive_ttl=0.6,
           replace=True)
    nr.add(names.gen_server("e", "t", "s2"), "http://127.0.0.1:2", keepalive_ttl=0.6,
           replace=True)
    views = [tfleet.fleet_discovery("e", "t"), jfleet.fleet_discovery("e", "t")]
    want = {"s1": "http://127.0.0.1:1", "s2": "http://127.0.0.1:2"}
    assert [v() for v in views] == [want, want]
    assert tfleet.fleet_discovery("e", "other")() == {}
    for _ in range(8):  # s1 keeps beating, s2 stops
        time.sleep(0.1)
        nr.default().touch(names.gen_server("e", "t", "s1"))
    time.sleep(0.2)
    nr.default().touch(names.gen_server("e", "t", "s1"))
    assert [v() for v in views] == [{"s1": "http://127.0.0.1:1"}] * 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    jhf.save_hf_checkpoint(str(path), jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(0)),
                           model_type="qwen2")
    return str(path)


def _command(pkg, ckpt, ttl, *extra):
    module = "areal_tpu_torch.system.gen_server" if pkg == "port" else "areal_tpu.system.gen_server"
    cmd = [sys.executable, "-m", module, "--path", ckpt, "--port", "{port}", "--experiment",
           "{experiment}", "--trial", "{trial}", "--keepalive-ttl", str(ttl),
           "--eos-token-id", str(EOS), *extra]
    return cmd + (["--device", "cpu"] if pkg == "port" else [])


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _metric_names(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _post(url, payload):
    import json

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120.0) as r:
        return json.loads(r.read())


@pytest.fixture()
def child_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_cli_servers_announce_serve_and_drain(store_root, ckpt, child_env):
    fleets = {pkg: PKGS[pkg][1].LocalProcessFleet(
        _command(pkg, ckpt, 10.0), "e", "t", base_port=_free_port(), drain_grace_s=0.5,
        sid_prefix="s") for pkg in ("port", "jax")}
    try:
        sids = {pkg: f.spawn() for pkg, f in fleets.items()}
        view = tfleet.fleet_discovery("e", "t")
        _wait(lambda: set(view()) == set(sids.values()), what="both CLIs to announce")
        assert jfleet.fleet_discovery("e", "t")() == view()
        urls = {pkg: view()[sid] for pkg, sid in sids.items()}
        for pkg, url in urls.items():
            port = url.rsplit(":", 1)[1]
            assert name_resolve.get(names.metrics_endpoint("e", "t", f"gen_server/{port}")) == url
            h = tmodel_api.LLMAPIClient(url).health()
            assert h["status"] == "ok" and h["version"] == 0 and not h["paused"]
        # The same traffic on both: two generates around a fabric push.
        req = dict(qid="q", prompt_ids=[9, 10, 11, 12], n=2, max_new_tokens=4, greedy=True)
        before = {pkg: _post(url + "/generate", req) for pkg, url in urls.items()}
        assert before["port"]["output_ids"] == before["jax"]["output_ids"]
        fabric = tps.BroadcastFabric(tps.ParamStore(), discovery=view, fanout=1)
        fabric.store.publish(params_from_numpy(_np_params(3), device="cpu"))
        report = fabric.push()
        assert report.ok and report.depth == 2
        after = {pkg: _post(url + "/generate", req) for pkg, url in urls.items()}
        assert after["port"]["output_ids"] == after["jax"]["output_ids"]
        assert all(a["version"] == 1 for a in after.values())
        got = {pkg: _metric_names(_get(url + "/metrics")) for pkg, url in urls.items()}
        own = {pkg: {n for n in got[pkg] if n.startswith(("areal_gen_", "areal_param"))}
               for pkg in got}
        # The engine's own series (tokens, goodput, KV use) are registered
        # by both packages' engines too, so the two sets are equal.
        engine = set(re.findall(r'"(areal_gen_\w+)"', open(jgenerator.__file__).read()))
        assert engine and engine <= own["port"] and own["port"] == own["jax"]
        assert {"areal_gen_weight_version", "areal_gen_requests_total",
                "areal_param_push_bytes_total"} <= own["port"]
        text = _get(urls["port"] + "/metrics")
        assert "areal_gen_weight_version 1" in text and "areal_gen_weight_updates_total 1" in text
        for pkg, f in fleets.items():
            proc = f.procs[sids[pkg]]
            f.drain(sids[pkg])  # deregisters now, then stops the process
            assert sids[pkg] not in view()
            proc.wait(timeout=30)
        assert view() == {}
    finally:
        for f in fleets.values():
            f.shutdown()


ANNOUNCER = """
import sys, time
sys.path.insert(0, {repo!r})
from areal_tpu_torch.base import name_resolve, names
key = names.gen_server("e", "t", "s" + sys.argv[1])
name_resolve.add(key, "http://127.0.0.1:" + sys.argv[1], keepalive_ttl=1.0, replace=True)
while True:
    time.sleep(0.2)
    name_resolve.default().touch(key)
"""


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_default_sid_prefix_leaves_the_key_to_its_ttl(store_root, tmp_path, pkg, child_env):
    """A behaviour of the reference, pinned in both packages: a server
    announces ``s<port>``, but `LocalProcessFleet`'s default sid prefix
    is ``port``, so `drain` deletes no key; the process stops, its
    heartbeat with it, and the key leaves the listing by its TTL."""
    script = tmp_path / "announce.py"
    script.write_text(ANNOUNCER.format(repo=REPO))
    fleet = PKGS[pkg][1].LocalProcessFleet([sys.executable, str(script), "{port}"], "e", "t",
                                           base_port=_free_port(), drain_grace_s=0.0)
    sid = fleet.spawn()
    view = tfleet.fleet_discovery("e", "t")
    port = sid.removeprefix("port")
    assert sid == f"port{port}"
    try:
        _wait(lambda: f"s{port}" in view(), timeout=60, what="the announcement")
        proc = fleet.procs[sid]
        fleet.drain(sid)
        proc.wait(timeout=30)
        assert f"s{port}" in view()  # the drain deleted nothing
        _wait(lambda: view() == {}, timeout=10, what="the TTL expiry")
    finally:
        fleet.shutdown()


def test_killed_cli_relay_orphans_its_subtree_and_exits(store_root, ckpt, child_env,
                                                        monkeypatch):
    monkeypatch.setenv("AREAL_FAULTS", "kill@point=param_push&times=1")
    base = _free_port()
    doomed = tfleet.LocalProcessFleet(_command("port", ckpt, 1.5), "e", "t", base_port=base,
                                      sid_prefix="s")
    sid = doomed.spawn()  # the fault is armed in its environment only
    monkeypatch.delenv("AREAL_FAULTS")
    view = tfleet.fleet_discovery("e", "t")
    try:
        _wait(lambda: sid in view(), what="the CLI to announce")
        child = GenerationServer(GeneratorEngine(tiny_config(), params_from_numpy(
            _np_params(5), device="cpu"), "cpu", eos_token_id=EOS), max_wait_ms=2.0)
        try:
            members = dict(view(), tail=child.url)  # "tail" sorts after the CLI's "s<port>"
            fabric = tps.BroadcastFabric(tps.ParamStore(), discovery=lambda: members, fanout=1,
                                         timeout_s=30.0)
            fabric.store.publish(params_from_numpy(_np_params(6), device="cpu"))
            report = fabric.push()
            assert report.applied == [] and sorted(o["sid"] for o in report.orphans) == sorted(
                [sid, "tail"])
            assert doomed.procs[sid].wait(timeout=30) == 0  # the CLI left with its server
            _wait(lambda: sid not in view(), timeout=10, what="the TTL expiry")
            assert child.version == 0
        finally:
            child.close()
    finally:
        doomed.shutdown()


def _controller_run(pkg):
    """A fleet of in-process port servers under one package's controller
    and fabric: s_a at the start, s_b joins, s_a leaves; versions pushed
    in between.  Returns the outcomes with the sids named by role."""
    nr, fleet_mod, ps, api, replay, rollout = PKGS[pkg]
    servers = {}
    roles = {}

    def start(role):
        srv = GenerationServer(GeneratorEngine(tiny_config(), params_from_numpy(
            _np_params(40), device="cpu"), "cpu", eos_token_id=EOS), max_wait_ms=2.0)
        roles[srv.announce(f"e{pkg}", "t", ttl=30.0)] = role
        servers[role] = srv

    start("a")
    store = ps.ParamStore(retain=1)
    view = fleet_mod.fleet_discovery(f"e{pkg}", "t")
    fabric = ps.BroadcastFabric(store, discovery=view, fanout=2)
    tree = params_from_numpy(_np_params(41), device="cpu") if pkg == "port" else _np_params(41)
    store.publish(tree)
    fabric.push()
    rb = replay.ReplayBuffer(capacity=64, max_head_offpolicyness=8)
    g = api.GenerationHyperparameters(n=1, max_new_tokens=3, greedy=True)
    ctl = rollout.RolloutController(replay=rb, gconfig=g, discovery=view, paramstore=store,
                                    health_refresh_s=0.0)
    out = {}

    def named(xs):
        return sorted(roles.get(str(x).split(":", 1)[-1], x) for x in xs)

    async def go():
        await ctl.run([("p%d" % i, [1, 2, 3]) for i in range(2)])
        out["first"] = dict(members=named(s.sid for s in ctl.servers), v1=named(store.pins(1)),
                            epoch=ctl.membership_epoch)
        start("b")  # a late join at version 0
        await ctl.run([("q%d" % i, [1, 2, 3]) for i in range(4)])
        out["joined"] = dict(members=named(s.sid for s in ctl.servers), v1=named(store.pins(1)),
                             epoch=ctl.membership_epoch)
        store.publish(tree)
        report = fabric.push()
        out["push"] = dict(applied=named(report.applied), depth=report.depth)
        await ctl._refresh_health()
        out["pushed"] = dict(live=store.live_versions(), v2=named(store.pins(2)))
        servers["a"].close()  # a graceful leave: drained, then reaped
        await ctl.run([("r%d" % i, [1, 2, 3]) for i in range(2)])
        out["left"] = dict(members=named(s.sid for s in ctl.servers), v2=named(store.pins(2)),
                           epoch=ctl.membership_epoch, stat=ctl.stat.as_dict())

    try:
        asyncio.run(go())
    finally:
        for s in servers.values():
            s.close()
    out["versions"] = {role: s.version for role, s in servers.items()}
    return out


def test_controller_over_the_fleet_matches_jax(store_root):
    got = _controller_run("port")
    assert got == _controller_run("jax")
    assert got["first"] == dict(members=["a"], v1=["a"], epoch=1)
    assert got["joined"]["members"] == ["a", "b"] and got["joined"]["v1"] == ["a"]
    assert got["push"] == dict(applied=["a", "b"], depth=1)
    assert got["pushed"] == dict(live=[2], v2=["a", "b"])
    assert got["left"]["members"] == ["b"] and got["left"]["v2"] == ["b"]
    assert got["left"]["stat"]["accepted"] == 8 and got["versions"] == {"a": 2, "b": 2}


@pytest.mark.parametrize("flags,item", [
    (["--zmq-port", "0"], "item 7.8"),
    (["--parallel", "d2"], "item 8"),
], ids=["zmq_port", "parallel"])
def test_cli_refuses_what_is_not_ported(flags, item):
    from areal_tpu_torch.system import gen_server

    with pytest.raises(SystemExit, match=f"ROADMAP queue 1, {item}"):
        gen_server.main(["--path", "/nonexistent", *flags])
