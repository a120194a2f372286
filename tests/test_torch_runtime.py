"""The port's multi-process runtime, layer by layer, against the JAX
package's: the name-resolve keys (`base/names.py`) and either package's
file store reading the other's entries with TTL expiry
(`base/name_resolve.py`); the local scheduler's lifecycle (twin of
tests/test_runtime_zmq.py:28); the pools' liveness semantics on the
standard-library transport (twins of tests/test_crash_safety.py:205-369:
a plain await without a deadline, death and `revive`, slow-not-dead
while beating, orphan replies by reason, `close()` failing pending
requests); and the worker control panel (twin of
tests/test_worker_control.py)."""

import asyncio
import inspect
import json
import sys
import threading
import time
from unittest import mock

import pytest

from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.base import names as jnames
from areal_tpu_torch.base import metrics, name_resolve, names, network
from areal_tpu_torch.scheduler import JobException, JobState, make_scheduler
from areal_tpu_torch.system.master import (
    InProcessPool,
    PoolClosedError,
    WorkerDeadError,
)
from areal_tpu_torch.system.stream import ConnWorkerPool, connect
from areal_tpu_torch.system.worker_control import (
    WorkerControlPanel,
    WorkerServer,
    WorkerState,
)

# ---------------- names and name_resolve ----------------

NAME_FUNCS = sorted(
    n for n, f in inspect.getmembers(jnames, inspect.isfunction) if f.__module__ == jnames.__name__
)


@pytest.mark.parametrize("fn", NAME_FUNCS)
def test_names_equal_jax(fn):
    jf, tf = getattr(jnames, fn), getattr(names, fn)
    args = []
    for p in inspect.signature(jf).parameters.values():
        args.append(7 if p.annotation is int or p.name.endswith("index") else f"x_{p.name}")
    assert tf(*args) == jf(*args)
    assert names.USER_NAMESPACE == jnames.USER_NAMESPACE


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_store_read_across_packages(tmp_path, writer):
    """Entries, subtrees and a TTL written by one package's file store
    read the same in the other's; an entry that outlives its TTL expires
    for both."""
    w = (jname_resolve if writer == "jax" else name_resolve).FileNameResolveRepository(str(tmp_path))
    r = (name_resolve if writer == "jax" else jname_resolve).FileNameResolveRepository(str(tmp_path))
    root = names.trial_root("exp", "t0")
    w.add(names.worker_control("exp", "t0", "model_worker/0"), "127.0.0.1:1")
    w.add(names.worker_control("exp", "t0", "model_worker/1"), "127.0.0.1:2")
    w.add(names.worker_keepalive("exp", "t0", "model_worker/0"), "alive", keepalive_ttl=0.5)
    assert r.get(names.worker_control("exp", "t0", "model_worker/1")) == "127.0.0.1:2"
    assert r.get_subtree(f"{root}/control") == ["127.0.0.1:1", "127.0.0.1:2"]
    assert r.find_subtree(f"{root}/control") == w.find_subtree(f"{root}/control")
    assert r.get(names.worker_keepalive("exp", "t0", "model_worker/0")) == "alive"
    time.sleep(0.8)
    for repo, err in ((r, (name_resolve.NameEntryNotFoundError,
                           jname_resolve.NameEntryNotFoundError)),):
        with pytest.raises(err):
            repo.get(names.worker_keepalive("exp", "t0", "model_worker/0"))
    with pytest.raises((name_resolve.NameEntryExistsError, jname_resolve.NameEntryExistsError)):
        r.add(names.worker_control("exp", "t0", "model_worker/0"), "other")
    r.add(names.worker_control("exp", "t0", "model_worker/0"), "127.0.0.1:3", replace=True)
    assert w.get(names.worker_control("exp", "t0", "model_worker/0")) == "127.0.0.1:3"


def test_memory_store_and_module_default(tmp_path, monkeypatch):
    """The module API over the default repository, chosen by
    AREAL_NAME_RESOLVE as in the JAX package; `wait` times out."""
    monkeypatch.setenv("AREAL_NAME_RESOLVE", "file")
    monkeypatch.setenv("AREAL_NAME_RESOLVE_ROOT", str(tmp_path))
    monkeypatch.setattr(name_resolve, "_default", None)
    assert isinstance(name_resolve.default(), name_resolve.FileNameResolveRepository)
    name_resolve.add("a/b", "1", keepalive_ttl=30)
    assert jname_resolve.FileNameResolveRepository(str(tmp_path)).get("a/b") == "1"
    with pytest.raises(TimeoutError):
        name_resolve.wait("a/missing", timeout=0.2, poll_frequency=0.05)
    mem = name_resolve.MemoryNameResolveRepository()
    mem.add("k/x", "1", keepalive_ttl=0.2)
    assert mem.get_subtree("k") == ["1"]
    time.sleep(0.3)
    assert mem.get_subtree("k") == []
    name_resolve.set_default(mem)
    assert name_resolve.default() is mem
    monkeypatch.setattr(name_resolve, "_default", None)


def test_network_helpers():
    port = network.find_free_port()
    assert 0 < port < 65536
    assert 20000 <= network.find_free_port(20000, 20100) < 20100
    assert network.gethostname()
    ip = network.gethostip()
    import socket

    with socket.socket() as s:
        s.bind((ip, 0))  # an address of this host


# ---------------- the local scheduler ----------------


def test_local_scheduler_lifecycle(tmp_path):
    """Twin of tests/test_runtime_zmq.py:28."""
    sched = make_scheduler("local", "t", "s", log_root=str(tmp_path))
    sched.submit("ok", [sys.executable, "-c", "print('done')"])
    sched.wait(timeout=30)
    info = sched.find("ok")
    assert info.state == JobState.COMPLETED
    with open(info.log_path) as f:
        assert f.read().strip() == "done"

    sched2 = make_scheduler("local", "t", "s2", log_root=str(tmp_path))
    sched2.submit("bad", [sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(JobException):
        sched2.wait(timeout=30)
    assert sched2.find("bad").exit_code == 3

    sched3 = make_scheduler("local", "t", "s3", log_root=str(tmp_path))
    sched3.submit("hang", [sys.executable, "-c", "import time; time.sleep(600)"])
    sched3.stop_all()
    assert sched3.find("hang").state == JobState.CANCELLED
    assert [i.name for i in sched3.find_all()] == ["hang"]
    assert sched3.find("other").state == JobState.NOT_FOUND


@pytest.mark.parametrize("mode", ["slurm", "tpu-pod"])
def test_other_schedulers_name_item_10(mode):
    with pytest.raises(NotImplementedError, match="item 10"):
        make_scheduler(mode, "t", "s")


# ---------------- the pools' liveness ----------------


class _SlowWorker:
    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s

    def handle_request(self, req):
        if req["type"] == "mfc":
            time.sleep(self.delay_s)
        return {"ok": req["type"]}


def test_inprocess_no_timeout_is_plain_await():
    pool = InProcessPool([_SlowWorker()])
    assert asyncio.run(pool.request(0, {"type": "ping"})) == {"ok": "ping"}


def test_inprocess_deadline_declares_dead_then_revive():
    pool = InProcessPool([_SlowWorker(delay_s=2.0)], mfc_timeout_s=0.2)

    async def go():
        with pytest.raises(WorkerDeadError) as ei:
            await pool.request(0, {"type": "mfc"})
        assert ei.value.worker_id == 0 and pool.dead_workers == {0}
        with pytest.raises(WorkerDeadError):  # a dead worker fails fast
            await pool.request(0, {"type": "ping"})
        pool.revive(0)
        assert pool.dead_workers == set()
        return await pool.request(0, {"type": "ping"}, timeout=None)

    assert asyncio.run(go()) == {"ok": "ping"}


def _fake_worker(pool, worker_index, lane="stream"):
    """A worker's connection to the pool, as run_worker_stream makes it."""
    conn = connect(pool._addr, pool.authkey)
    conn.send({"type": "hello", "worker_index": worker_index, "lane": lane})
    return conn


def _orphan_counts():
    out = {"timed_out": 0.0, "unknown": 0.0}
    for line in metrics.default_registry().expose().splitlines():
        if line.startswith("areal_master_orphan_replies_total{"):
            name_part, val = line.rsplit(" ", 1)
            for reason in out:
                if f'reason="{reason}"' in name_part:
                    out[reason] = float(val)
    return out


@pytest.fixture
def conn_pool():
    made = []

    def make(**kw):
        pool = ConnWorkerPool("crash-test", f"t{len(made)}", 1, **kw)
        made.append(pool)
        return pool

    yield make
    for pool in made:
        pool.close()


def test_close_fails_pending_with_pool_closed(conn_pool):
    async def go():
        pool = conn_pool()
        conn = _fake_worker(pool, 0)
        try:
            await pool.wait_workers(timeout=10)
            task = asyncio.ensure_future(pool.request(0, {"type": "ping"}))
            await asyncio.sleep(0.2)  # sent; no reply comes
            assert conn.poll(5) and conn.recv()["request"] == {"type": "ping"}
            pool.close()
            with pytest.raises(PoolClosedError):
                await asyncio.wait_for(task, timeout=5)
        finally:
            conn.close()

    asyncio.run(go())


def test_requests_matched_by_id(conn_pool):
    """Many requests in flight to one worker, answered out of order,
    each resolves its own future; a worker-side error re-raises."""

    async def go():
        pool = conn_pool()
        conn = _fake_worker(pool, 0)
        try:
            await pool.wait_workers(timeout=10)
            tasks = [asyncio.ensure_future(pool.request(0, {"type": "ping", "i": i}))
                     for i in range(8)]
            got = []
            while len(got) < 8:
                await asyncio.sleep(0.01)
                while conn.poll(0):
                    got.append(conn.recv())
            for msg in reversed(got):
                i = msg["request"]["i"]
                if i == 3:
                    conn.send({"req_id": msg["req_id"], "error": "ValueError('boom')"})
                else:
                    conn.send({"req_id": msg["req_id"], "result": {"i": i}})
            out = await asyncio.gather(*tasks, return_exceptions=True)
            assert [o["i"] for j, o in enumerate(out) if j != 3] == [0, 1, 2, 4, 5, 6, 7]
            assert isinstance(out[3], RuntimeError) and "boom" in str(out[3])
        finally:
            conn.close()

    asyncio.run(go())


def test_orphan_replies_accounted(conn_pool):
    async def go():
        pool = conn_pool(mfc_timeout_s=0.3, worker_heartbeat_s=0.05)
        conn = _fake_worker(pool, 0)
        try:
            await pool.wait_workers(timeout=10)
            before = _orphan_counts()
            # No beats after the hello: the deadline declares worker 0 dead.
            with pytest.raises(WorkerDeadError):
                await pool.request(0, {"type": "mfc"})
            # The dead worker's lane is closed; its replacement reconnects
            # and answers late (timed out) and never-asked (unknown) ids.
            conn.close()
            conn = _fake_worker(pool, 0)
            await pool.wait_workers(timeout=10)
            conn.send({"req_id": 0, "result": {}})
            conn.send({"req_id": 999, "result": {}})
            await asyncio.sleep(0.3)
            after = _orphan_counts()
            assert after["timed_out"] == before["timed_out"] + 1
            assert after["unknown"] == before["unknown"] + 1
        finally:
            conn.close()

    asyncio.run(go())


def test_beating_worker_is_slow_not_dead(conn_pool, caplog):
    """A worker that beats past the deadline stays alive (the deadline
    re-arms and the log says so); one that stops beating is declared
    dead, and its slot re-arms for a relaunched worker."""

    async def go():
        pool = conn_pool(mfc_timeout_s=0.3, worker_heartbeat_s=0.05)
        conn = _fake_worker(pool, 0)
        beats = _fake_worker(pool, 0, lane="beat")
        try:
            await pool.wait_workers(timeout=10)
            task = asyncio.ensure_future(pool.request(0, {"type": "mfc"}))
            for _ in range(18):  # ~3 deadline windows
                beats.send({"type": "beat", "worker_index": 0})
                await asyncio.sleep(0.05)
            assert not task.done() and pool.dead_workers == set()
            msg = conn.recv()
            conn.send({"req_id": msg["req_id"], "result": {"ok": 1}})
            assert await asyncio.wait_for(task, timeout=5) == {"ok": 1}
            with pytest.raises(WorkerDeadError):
                await pool.request(0, {"type": "mfc"})
            assert pool.dead_workers == {0}
            with pytest.raises(WorkerDeadError):  # fails fast
                await pool.request(0, {"type": "ping"})
            relaunched = _fake_worker(pool, 0)
            await pool.wait_workers(timeout=10)
            assert pool.dead_workers == set()
            relaunched.close()
        finally:
            conn.close()
            beats.close()

    with caplog.at_level("WARNING", logger="areal_tpu_torch.stream"):
        asyncio.run(go())
    assert "slow, not dead" in caplog.text


def test_wrong_authkey_is_refused(conn_pool):
    from multiprocessing.connection import AuthenticationError

    pool = conn_pool()
    with pytest.raises((AuthenticationError, EOFError, ConnectionError)):
        connect(pool._addr, b"not the trial's key")


# ---------------- worker control ----------------


@pytest.fixture
def panel_and_servers():
    servers = [WorkerServer("ctltest", "t0", f"model_worker/{i}", keepalive_ttl=1.0)
               for i in range(2)]
    panel = WorkerControlPanel("ctltest", "t0")
    panel.connect([s.worker_name for s in servers], timeout=10.0)
    yield panel, servers
    for s in servers:
        s.stop()
    panel.close()


def test_lifecycle_commands(panel_and_servers):
    panel, servers = panel_and_servers
    out = panel.group_request("ping")
    assert all(r["state"] == "ready" for r in out.values())
    out = panel.group_request(
        "configure", payloads={s.worker_name: {"config": {"seed": 7}} for s in servers})
    assert all(r["state"] == "configured" for r in out.values())
    assert servers[0].config == {"seed": 7}
    panel.group_request("start")
    assert servers[0].state == WorkerState.RUNNING
    panel.request(servers[0].worker_name, "pause")
    assert servers[0].paused and not servers[1].paused
    panel.request(servers[0].worker_name, "resume")
    assert not servers[0].paused
    panel.group_request("exit")
    for s in servers:
        assert s.state == WorkerState.EXITING
    assert panel.request(servers[0].worker_name, "ping")["state"] == "exiting"
    for s in servers:
        s.stop()
        assert s.exited.wait(timeout=5.0)


def test_custom_handler_and_errors(panel_and_servers):
    panel, servers = panel_and_servers
    servers[0].register_handler("stats", lambda p: {"echo": p["x"] * 2})
    assert panel.request(servers[0].worker_name, "stats", {"x": 21}) == {"echo": 42}
    with pytest.raises(RuntimeError, match="unknown control command"):
        panel.request(servers[0].worker_name, "nope")


def test_pause_gates_work(panel_and_servers):
    panel, servers = panel_and_servers
    s = servers[0]
    panel.request(s.worker_name, "pause")
    done = threading.Event()

    def worker_loop():
        s.wait_if_paused()
        done.set()

    t = threading.Thread(target=worker_loop, daemon=True)
    t.start()
    assert not done.wait(timeout=0.3)
    panel.request(s.worker_name, "resume")
    assert done.wait(timeout=5.0)
    t.join(timeout=5.0)


def test_timeout_recovers_the_channel(panel_and_servers):
    panel, servers = panel_and_servers
    servers[0].stop()  # never answers again
    for _ in range(2):
        with pytest.raises(TimeoutError):
            panel.request(servers[0].worker_name, "ping", timeout=0.3)
    assert panel.request(servers[1].worker_name, "ping")["state"] == "ready"


def test_group_timeout_does_not_poison_others(panel_and_servers):
    panel, servers = panel_and_servers
    servers[0].stop()
    with pytest.raises(RuntimeError, match="model_worker/0"):
        panel.group_request("ping", timeout=0.5)
    assert panel.request(servers[1].worker_name, "ping")["state"] == "ready"


def test_keepalive_liveness(panel_and_servers):
    panel, servers = panel_and_servers
    assert panel.check_liveness() == {s.worker_name: True for s in servers}
    servers[0].stop()
    time.sleep(1.5)
    alive = panel.check_liveness()
    assert alive[servers[0].worker_name] is False and alive[servers[1].worker_name] is True


def test_cli_status_and_pause(capsys, tmp_path, monkeypatch):
    """The operator CLI on the file store: discover, status, pause,
    resume, liveness; the authkey from a file."""
    from areal_tpu_torch.system import stream
    from areal_tpu_torch.system import worker_control as wc

    key = "ab" * 32
    monkeypatch.setenv(stream.ENV_AUTHKEY, key)
    keyfile = tmp_path / "authkey"
    keyfile.write_text(key)
    name_resolve.set_default(name_resolve.FileNameResolveRepository(str(tmp_path)))
    servers = [WorkerServer("clicontrol", "t0", f"model_worker/{i}") for i in range(2)]
    monkeypatch.delenv(stream.ENV_AUTHKEY)
    try:
        def run(cmd):
            wc.main([cmd, "--experiment", "clicontrol", "--trial", "t0", "--root", str(tmp_path),
                     "--authkey-file", str(keyfile)])
            return json.loads(capsys.readouterr().out)

        out = run("status")
        assert set(out) == {"model_worker/0", "model_worker/1"}
        assert all(v["state"] == "ready" for v in out.values())
        run("pause")
        assert all(s.paused for s in servers)
        run("resume")
        assert not any(s.paused for s in servers)
        assert all(run("liveness").values())
    finally:
        for s in servers:
            s.stop()
        name_resolve.set_default(name_resolve.MemoryNameResolveRepository())


def test_the_stream_honours_pause_and_control_exit(tmp_path):
    """run_worker_stream parks requests while its control server is
    paused and leaves its loop on a control-side exit."""
    from areal_tpu_torch.system.stream import run_worker_stream

    class W:
        config = mock.Mock(worker_index=0)

        def handle_request(self, req):
            return {"ok": req["type"]}

    name_resolve.set_default(name_resolve.MemoryNameResolveRepository())
    control = WorkerServer("pausetest", "t0", "model_worker/0")

    async def go():
        pool = ConnWorkerPool("pausetest", "t0", 1, worker_heartbeat_s=0.1)
        th = threading.Thread(target=run_worker_stream,
                              args=(W(), "pausetest", "t0"),
                              kwargs=dict(control=control, heartbeat_s=0.1), daemon=True)
        th.start()
        try:
            await pool.wait_workers(timeout=10)
            assert await pool.request(0, {"type": "ping"}) == {"ok": "ping"}
            control._handle("pause", {})
            task = asyncio.ensure_future(pool.request(0, {"type": "ping"}))
            await asyncio.sleep(0.5)
            assert not task.done()
            control._handle("resume", {})
            assert await asyncio.wait_for(task, 5) == {"ok": "ping"}
            control._handle("exit", {})
            await asyncio.to_thread(th.join, 5)
            assert not th.is_alive()
        finally:
            pool.close()
            control.stop()

    asyncio.run(go())
