"""The port's param store and broadcast-tree push
(`areal_tpu_torch/system/paramstore.py`) against the JAX package's, on
the CPU:

- the wire format: the port's manifest and payload are byte-equal to
  `areal_tpu.system.paramstore.serialize_params` on the same carried-over
  weights, fp32 and bf16; each package's `deserialize_params` reads the
  other's payload bit for bit; a wrong leaf count, shape or length raises
  in both; the framed body is the JAX body;
- `plan_tree`, `subtree_sids` and `tree_depth` equal the JAX functions
  for 0-20 members and fanout 1-4 (hypothesis);
- `ParamStore` pins, TTL and retire: one sequence of operations under
  one fake clock gives equal results and `state_dict`s in both;
- over in-process HTTP servers: a port fabric pushing into JAX servers,
  a JAX fabric into port servers, and a mixed tree, each landing the
  pushed weights bit for bit at the pushed version; idempotence at a
  version; the v-1 `push_to`; a killed relay orphaning only its subtree
  and `repair` bringing the survivor to the head, as the JAX fabric
  does; `p2p`; the bytes counter a hop; a wrong checksum refused
  everywhere; and the reference's version no-op after a trainer restart
  (a fresh store's v1 against servers at version 3), pinned in both."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from areal_tpu.base import integrity as jintegrity
from areal_tpu.base.faults import FaultInjector as JFaults
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.system import paramstore as jps
from areal_tpu.system.gen_server import GenerationServer as JServer
from areal_tpu_torch.base import integrity
from areal_tpu_torch.base.faults import FaultInjector
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from areal_tpu_torch.system import paramstore as tps
from areal_tpu_torch.system.gen_server import GenerationServer

torch.set_num_threads(2)

EOS = 7


def _np_params(seed):
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(seed)))


def _flat(tree):
    """Leaves in sorted-key order as numpy (bf16 widened exactly)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [params_to_numpy(tree)]
    return [np.asarray(tree, np.float32) if tree.dtype == jnp.bfloat16 else np.asarray(tree)]


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


# ---------------------------------------------------------------------------
# Wire format


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_bytes_equal_jax(dtype):
    src = _np_params(3)
    jtree = jax.tree.map(lambda x: jnp.asarray(x, dtype), src)
    ttree = params_from_numpy(src, device="cpu", dtype=getattr(torch, dtype))
    jm, jp = jps.serialize_params(jtree)
    tm, tp = tps.serialize_params(ttree)
    assert tm == jm and tm[0]["dtype"] == dtype
    assert bytes(tp) == jp
    # Each package reads the other's payload bit for bit.
    assert _equal(tps.deserialize_params(ttree, jm, jp), ttree)
    assert _equal(jps.deserialize_params(jtree, tm, tp), jtree)
    # The checksum carried beside it verifies across the packages.
    jintegrity.verify_checksum(jtree, integrity.params_checksum(ttree))
    integrity.verify_checksum(ttree, jintegrity.params_checksum(jtree))


@pytest.mark.parametrize("case", ["leaf_count", "shape", "truncated", "long"])
def test_bad_payloads_raise_in_both(case):
    src = _np_params(4)
    ttree = params_from_numpy(src, device="cpu")
    manifest, payload = jps.serialize_params(src)
    payload = bytes(payload)
    if case == "leaf_count":
        manifest = manifest[:-1]
    elif case == "shape":
        manifest = [dict(manifest[0], shape=[1, 2, 3])] + manifest[1:]
    elif case == "truncated":
        payload = payload[:-4]
    else:
        payload = payload + b"\0" * 4
    for like, deserialize in ((src, jps.deserialize_params), (ttree, tps.deserialize_params)):
        with pytest.raises(ValueError):
            deserialize(like, manifest, payload)


def test_framing_matches_jax():
    meta = {"cmd": "param_push", "version": 3, "manifest": [{"dtype": "int8", "shape": [4]}]}
    payload = bytes(range(4))
    body = jps.frame_push_body(meta, payload)
    assert tps.frame_push_body(meta, payload) == body
    assert tps.push_prefix(meta) + payload == body
    got_meta, got_payload = tps.unframe_push_body(body)
    assert got_meta == meta and bytes(got_payload) == payload
    assert jps.unframe_push_body(tps.frame_push_body(meta, payload)) == (meta, payload)
    for bad in (b"\0" * 4, (100).to_bytes(8, "big") + b"{}"):
        for unframe in (jps.unframe_push_body, tps.unframe_push_body):
            with pytest.raises(ValueError):
                unframe(bad)


# ---------------------------------------------------------------------------
# The tree


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 20), fanout=st.integers(1, 4), seed=st.integers(0, 2**16))
def test_plan_tree_matches_jax(n, fanout, seed):
    members = [(f"s{i:02d}", f"http://127.0.0.1:{9000 + i}") for i in range(n)]
    np.random.default_rng(seed).shuffle(members)
    got = tps.plan_tree(members, fanout)
    assert got == jps.plan_tree(members, fanout)
    assert tps.tree_depth(got) == jps.tree_depth(got)
    assert sorted(s for r in got for s in tps.subtree_sids(r)) == sorted(s for s, _ in members)
    for r in got:
        assert tps.subtree_sids(r) == jps.subtree_sids(r)


# ---------------------------------------------------------------------------
# The store's reference counts


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


_STORE_SCRIPT = [
    ("publish",), ("pin", 1, "server:a", True), ("pin", 1, "dispatch:q0", False),
    ("publish",), ("publish",), ("live",), ("pins", 1), ("pin", 3, "server:a", True),
    ("live",), ("release", 1, "dispatch:q0"), ("live",), ("pin", 3, "server:b", True),
    ("tick", 20.0), ("pin", 3, "server:b", True), ("publish",), ("tick", 15.0), ("retire",),
    ("live",), ("pins", 3), ("pin", 1, "server:c", True), ("pin", 4, "dispatch:q1", False),
    ("publish",), ("release_holder", "dispatch:q1"), ("live",), ("tick", 40.0), ("retire",),
    ("live",), ("state",),
]


def _run_store(mod):
    clock = _Clock()
    store = mod.ParamStore(retain=2, pin_ttl_s=30.0, clock=clock)
    out = []
    for op, *args in _STORE_SCRIPT:
        if op == "publish":
            out.append(store.publish(manifest=[{"dtype": "uint8", "shape": [8]}],
                                     payload=bytes(8)))
        elif op == "pin":
            out.append(store.pin(args[0], args[1], exclusive=args[2]))
        elif op == "release":
            out.append(store.release(*args))
        elif op == "release_holder":
            out.append(store.release_holder(*args))
        elif op == "retire":
            out.append(store.retire())
        elif op == "live":
            out.append(store.live_versions())
        elif op == "pins":
            out.append(store.pins(*args))
        elif op == "tick":
            clock.t += args[0]
        elif op == "state":
            out.append(store.state_dict())
    restored = mod.ParamStore()
    restored.load_state_dict(store.state_dict())
    restored.load_state_dict({"head": 1})  # a stale state never rewinds
    out.append((restored.head, restored.publish(manifest=[], payload=b"")))
    return out


def test_store_refcounts_match_jax():
    got = _run_store(tps)
    assert got == _run_store(jps)
    assert got[-2] == {"head": 5} and got[-1] == (5, 6)


# ---------------------------------------------------------------------------
# Pushes over HTTP


def _port_server(seed, **kw):
    eng = GeneratorEngine(tiny_config(), params_from_numpy(_np_params(seed), device="cpu"),
                          "cpu", eos_token_id=EOS)
    return GenerationServer(eng, max_wait_ms=2.0, **kw)


def _jax_server(seed, **kw):
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    eng = JEngine(jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(seed)), mesh,
                  eos_token_id=EOS)
    return JServer(eng, max_wait_ms=2.0, zmq_port=None, **kw)


@pytest.fixture()
def fleet():
    made = []

    def make(kinds, **kw):
        for i, k in enumerate(kinds):
            made.append((_port_server if k == "port" else _jax_server)(20 + len(made), **kw))
        return made[-len(kinds):]

    yield make
    for s in made:
        s.close()


def _sid(s):
    return f"s{s.port}"


def _members(servers):
    return {_sid(s): s.url for s in servers}


def _fabric(mod, servers, **kw):
    return mod.BroadcastFabric(mod.ParamStore(), discovery=lambda: _members(servers), **kw)


def _publish_weights(mod, fabric, src):
    tree = params_from_numpy(src, device="cpu") if mod is tps else src
    return fabric.store.publish(tree)


@pytest.mark.parametrize("pusher,kinds", [
    ("port", ["jax", "jax", "jax"]),
    ("jax", ["port", "port", "port"]),
    ("port", ["jax", "port", "jax", "port"]),
    ("jax", ["port", "jax", "port"]),
], ids=["port_into_jax", "jax_into_port", "mixed_port_pusher", "mixed_jax_pusher"])
def test_tree_push_lands_the_weights_bit_for_bit(fleet, pusher, kinds):
    servers = fleet(kinds)
    mod = tps if pusher == "port" else jps
    fabric = _fabric(mod, servers, fanout=2)
    src = _np_params(5)
    _publish_weights(mod, fabric, src)
    report = fabric.push()
    assert report.ok and report.version == 1 and report.depth == 2
    assert sorted(report.applied) == sorted(_members(servers))
    assert fabric.store.pins(1) == sorted(f"server:{_sid(s)}" for s in servers)
    for s in servers:
        assert s.version == 1 and s.inmem_updates == 1
        assert _equal(s.engine.params, params_from_numpy(src, device="cpu"))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_push_is_idempotent_at_a_version(fleet, pkg):
    (srv,) = fleet([pkg])
    fabric = _fabric(tps, [srv])
    _publish_weights(tps, fabric, _np_params(6))
    fabric.push()
    again = fabric.push()  # the same version: no second swap
    assert again.ok and srv.version == 1 and srv.inmem_updates == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_version_no_op_after_a_trainer_restart(fleet, pkg):
    """The reference's behaviour, pinned in both packages: a server at
    version 3 takes a fresh store's v1 as an idempotent no-op, and the
    push counts it applied (the store starts at head 0 and no code
    writes `RecoverInfo.paramstore_state`).  Its weights do not change."""
    (srv,) = fleet([pkg], version=3)
    before = params_to_numpy(srv.engine.params) if pkg == "port" else jax.tree.map(
        np.asarray, srv.engine.params)
    for mod in (tps, jps):
        fabric = _fabric(mod, [srv])
        _publish_weights(mod, fabric, _np_params(7))
        report = fabric.push()
        assert report.ok and report.applied == [_sid(srv)] and report.version == 1
        assert srv.version == 3 and srv.inmem_updates == 0
    assert _equal(srv.engine.params, before)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_push_to_the_previous_version(fleet, pkg):
    (srv,) = fleet([pkg])
    store = tps.ParamStore(retain=2)
    store.publish(params_from_numpy(_np_params(8), device="cpu"))
    store.publish(params_from_numpy(_np_params(9), device="cpu"))
    fabric = tps.BroadcastFabric(store, discovery=lambda: {})
    ack = fabric.push_to(_sid(srv), srv.url, store.head - 1)
    assert ack == {"version": 1, "applied": [_sid(srv)], "failed": []}
    assert srv.version == 1 and store.pins(1) == [f"server:{_sid(srv)}"]
    assert _equal(srv.engine.params, params_from_numpy(_np_params(8), device="cpu"))


def _killed_relay(mod, make_server, faults_cls):
    """Three servers; the first root (it has a child) dies at its
    param_push.  Returns what the push, the polls and repair report, with
    the sids replaced by each server's place in sorted order."""
    servers = [make_server(30, faults=faults_cls.parse("kill@point=param_push&times=1"))]
    servers += [make_server(31 + i) for i in range(2)]
    members = _members(servers)
    dead = _sid(servers[0])
    # The killed server sorts first, so it is the root with a child.
    members = {("a" + sid if sid == dead else "b" + sid): url for sid, url in members.items()}
    order = {k: i for i, k in enumerate(sorted(members))}
    try:
        fabric = mod.BroadcastFabric(mod.ParamStore(), discovery=lambda: members, fanout=2,
                                     timeout_s=30.0)
        src = _np_params(10)
        _publish_weights(mod, fabric, src)
        report = fabric.push()
        orphans = sorted(order[o["sid"]] for o in report.orphans)
        applied = sorted(order[s] for s in report.applied)
        versions_after = {order[k]: v for k, v in fabric.poll_versions().items()}
        repaired = sorted(order[s] for s in fabric.repair())
        versions_repaired = {order[k]: v for k, v in fabric.poll_versions().items()}
        landed = all(_equal(s.engine.params, params_from_numpy(src, device="cpu"))
                     for s in servers[1:])
        return dict(ok=report.ok, depth=report.depth, orphans=orphans, applied=applied,
                    after=versions_after, repaired=repaired, final=versions_repaired,
                    landed=landed, killed=servers[0]._crashed)
    finally:
        for s in servers:
            s.close()


def test_killed_relay_orphans_only_its_subtree():
    port = _killed_relay(tps, _port_server, FaultInjector)
    assert port == _killed_relay(jps, _jax_server, JFaults)
    # The dead root and its child are orphaned; the third server applies;
    # repair brings the surviving orphan to the head; the dead stays None.
    assert port == dict(ok=False, depth=2, orphans=[0, 1], applied=[2],
                        after={0: None, 1: 0, 2: 1}, repaired=[1],
                        final={0: None, 1: 1, 2: 1}, landed=True, killed=True)


def test_p2p_mode_and_bytes_per_hop(fleet):
    servers = fleet(["port", "jax", "port"])
    src = _np_params(11)
    out = {}
    for mode in ("tree", "p2p"):
        fabric = _fabric(tps, servers, fanout=2, mode=mode)
        fabric.store.load_state_dict({"head": 0 if mode == "tree" else 1})
        v = _publish_weights(tps, fabric, src)
        pv = fabric.store.get(v)
        def counted():  # a JAX relay counts into the JAX package's counter
            return tps.M_PUSH_BYTES.get() + jps.M_PUSH_BYTES._default().get()

        before = counted()
        report = fabric.push()
        moved = counted() - before
        assert report.ok and all(s.version == v for s in servers)
        # Every hop counts its payload and its own meta (each names its
        # subtree): three hops in either mode, the payload serialized once.
        roots = (tps.plan_tree(sorted(_members(servers).items()), 2) if mode == "tree" else
                 [{"sid": s, "url": u, "children": []} for s, u in sorted(_members(servers).items())])

        def hops(nodes):
            return [(n, fabric._base_meta(pv)) for n in nodes] + [
                h for n in nodes for h in hops(n["children"])]

        want = sum(pv.nbytes + len(json.dumps(dict(meta, subtree=n)).encode())
                   for n, meta in hops(roots))
        assert moved == want and len(hops(roots)) == 3
        out[mode] = report.depth
    assert out == {"tree": 2, "p2p": 1}


def test_wrong_checksum_is_refused_everywhere(fleet):
    servers = fleet(["port", "jax", "port"])
    fabric = _fabric(tps, servers, fanout=2)
    src = _np_params(12)
    tree = params_from_numpy(src, device="cpu")
    bad = integrity.params_checksum(tree)
    bad[2:] *= 1.01  # every leaf norm 1% off
    fabric.store.publish(tree, checksum=bad)
    report = fabric.push()
    assert not report.ok and report.applied == []
    assert sorted(o["sid"] for o in report.orphans) == sorted(_members(servers))
    assert all("checksum" in o["error"] for o in report.orphans)
    assert all(s.version == 0 and s.inmem_updates == 0 for s in servers)


def test_published_payload_is_not_copied():
    store = tps.ParamStore()
    manifest, payload = tps.serialize_params(params_from_numpy(_np_params(13), device="cpu"))
    store.publish(manifest=manifest, payload=payload)
    pv = store.get(1)
    assert pv.payload is payload and pv.nbytes == len(bytes(payload)) and pv.version == 1


def test_recover_info_carries_the_store_head(tmp_path):
    """`RecoverInfo.paramstore_state` round-trips `ParamStore.state_dict()`,
    and a record written before the field existed loads with its
    default (as the JAX package's does)."""
    from areal_tpu.base import recover as jrecover
    from areal_tpu_torch.base import recover

    store = tps.ParamStore()
    store.publish(manifest=[], payload=b"")
    info = recover.RecoverInfo(paramstore_state=store.state_dict())
    recover.dump(info, str(tmp_path / "new"))
    fresh = tps.ParamStore()
    fresh.load_state_dict(recover.load(str(tmp_path / "new")).paramstore_state)
    assert fresh.head == 1
    old = recover.RecoverInfo()
    del old.paramstore_state  # a record from before the field
    recover.dump(old, str(tmp_path / "old"))
    assert recover.load(str(tmp_path / "old")).paramstore_state == {}
    assert jrecover.RecoverInfo().paramstore_state == recover.RecoverInfo().paramstore_state


def test_checksum_of_a_large_leaf_matches_across_devices():
    """The fault of the reference this port fixes (ROADMAP queue 3): the
    JAX package's host checksum sums a leaf's squares in float32, which
    drifts 2.5e-4 from the exact norm at 64M elements (past the 1e-4
    tolerance), so its host verify refuses its own device checksum of the
    same weights; qwen2-1.5B's stacked leaves hold 233M-385M elements.
    The port's tensor checksum sums in float64 and agrees with the exact
    norm and with the JAX device checksum."""
    x = (np.random.default_rng(0).standard_normal(1 << 26) * 0.02).astype(np.float32)
    exact = float(np.sqrt(sum(float(c @ c) for c in np.split(x.astype(np.float64), 64))))
    jdev = jintegrity.params_checksum({"w": jnp.asarray(x)})
    jhost = jintegrity.params_checksum({"w": x})
    port = integrity.params_checksum({"w": torch.from_numpy(x)})
    assert not jintegrity.checksum_matches(jdev, jhost)  # the reference's fault
    assert abs(port[2] - exact) / exact < 1e-12
    assert integrity.checksum_matches(port, jdev) and jintegrity.checksum_matches(jdev, port)


def test_push_carries_the_token_and_announces_the_head(monkeypatch):
    """A server bound with a token takes a push only with it (the
    ``X-Areal-Token`` header, 403 without), and a fabric with an
    experiment publishes its store's head under ``names.param_store``."""
    from areal_tpu_torch.base import name_resolve, names

    monkeypatch.setattr(name_resolve, "_default", name_resolve.MemoryNameResolveRepository())
    srv = _port_server(50, token="s3cret")
    try:
        store = tps.ParamStore()
        store.publish(params_from_numpy(_np_params(51), device="cpu"))
        denied = tps.BroadcastFabric(store, discovery=lambda: {_sid(srv): srv.url})
        report = denied.push()
        assert not report.applied and "403" in report.orphans[0]["error"]
        fabric = tps.BroadcastFabric(store, discovery=lambda: {_sid(srv): srv.url},
                                     token="s3cret", experiment="e", trial="t")
        assert fabric.push().ok and srv.version == 1
        assert name_resolve.get(names.param_store("e", "t")) == "1"
    finally:
        srv.close()
