"""The port's rollout controller against the JAX package's: the same fake
clients (tests/test_rollout.py's `_FakeClient` and friends, one copy a
package) through both controllers give equal outcomes: dispatch and
version stamps, balancing on /health, a dead server, backpressure, the
state_dict's prompt cursor, failed dispatches, retries to a different
server, deadlines, the breaker's open and probe, a hung health poll,
`completed_groups`, the episode-runner hook, fleet discovery (a late
join, a leave drained and reaped) and the param store's version pins
(each server's, each dispatch's, moving as a laggard catches up).  Also
the circuit breaker on a fake clock.  The controller's task mixtures:
tests/test_torch_mixture.py."""

import asyncio
import time

import pytest

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.system import fleet as jfleet
from areal_tpu.system import paramstore as jparamstore
from areal_tpu.system import replay as jreplay
from areal_tpu.system import rollout as jrollout
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.system import fleet as tfleet
from areal_tpu_torch.system import paramstore as tparamstore
from areal_tpu_torch.system import replay as treplay
from areal_tpu_torch.system import rollout as trollout

PKGS = {
    "jax": (jmodel_api, jreplay, jrollout),
    "port": (tmodel_api, treplay, trollout),
}


class _FakeClient:
    """LLMAPIClient-shaped: records dispatches, serves a canned health
    signal and stamps outputs with its weight version."""

    def __init__(self, api, version=0, queue_depth=0, capacity=4, delay=0.0,
                 health_error=False):
        self.api = api
        self.version = version
        self.queue_depth = queue_depth
        self.capacity = capacity
        self.delay = delay
        self.health_error = health_error
        self.max_inflight = 1
        self.calls = []

    def health(self):
        if self.health_error:
            raise ConnectionError("server down")
        return {"status": "ok", "version": self.version, "queue_depth": self.queue_depth,
                "live_slots": 0, "kv_utilization": 0.0, "capacity": self.capacity,
                "paused": False}

    async def agenerate(self, inp):
        self.calls.append(inp.qid)
        if self.delay:
            await asyncio.sleep(self.delay)
        return self.api.APIGenerateOutput(
            qid=inp.qid, prompt_ids=list(inp.prompt_ids), output_ids=[[1, 2]],
            output_logprobs=[[-0.1, -0.2]], no_eos=[False], version=self.version + 1,
            version_start=self.version,
        )


class _FailingClient(_FakeClient):
    def __init__(self, api, fail_times=10**9, **kw):
        super().__init__(api, **kw)
        self.fail_times = fail_times
        self.failures = 0

    async def agenerate(self, inp):
        if self.fail_times > 0:
            self.fail_times -= 1
            self.failures += 1
            raise RuntimeError("boom")
        return await super().agenerate(inp)


class _HungHealthClient(_FakeClient):
    def __init__(self, api, hang_s=1.0, **kw):
        super().__init__(api, **kw)
        self.hang_s = hang_s

    def health(self):
        time.sleep(self.hang_s)
        return super().health()


def _g(api):
    return api.GenerationHyperparameters(n=1, max_new_tokens=4)


def _outcome(ctl, stat, rb, clients):
    return dict(stat=stat.as_dict(), cursor=ctl.cursor, calls=[sorted(c.calls) for c in clients],
                resident=[(t.qid, t.version_start, t.version_end) for t in _drain(rb)])


def _drain(rb):
    out = []
    while True:
        try:
            out.extend(rb.get_batch(1, timeout=0))
        except TimeoutError:
            return out


def _scenario(pkg, name):
    api, replay, rollout = PKGS[pkg]
    g = _g(api)
    if name == "stamps":
        c = _FakeClient(api, version=3)
        rb = replay.ReplayBuffer(capacity=8, max_head_offpolicyness=8)
        rb.set_version(3)
        ctl = rollout.RolloutController([c], rb, g)
        stat = asyncio.run(ctl.run([[5, 6, 7]] * 4))
        return _outcome(ctl, stat, rb, [c])
    if name == "balance":
        busy, idle = _FakeClient(api, queue_depth=100), _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([busy, idle], rb, g)
        stat = asyncio.run(ctl.run([("q%d" % i, [1, 2]) for i in range(6)]))
        return dict(_outcome(ctl, stat, rb, [busy, idle]), inflight=idle.max_inflight)
    if name == "dead_server":
        dead, alive = _FakeClient(api, health_error=True), _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([dead, alive], rb, g)
        stat = asyncio.run(ctl.run([[1, 2]] * 4))
        return _outcome(ctl, stat, rb, [dead, alive])
    if name == "backpressure":
        c = _FakeClient(api, delay=0.001)
        rb = replay.ReplayBuffer(capacity=1, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([c], rb, g, backpressure_poll_s=0.005)
        consumed = []

        async def go():
            async def consume():
                while len(consumed) < 4:
                    try:
                        consumed.extend(rb.get_batch(1, timeout=0))
                    except TimeoutError:
                        pass
                    await asyncio.sleep(0.05)

            task = asyncio.create_task(consume())
            stat = await ctl.run([[1, 2]] * 4)
            await task
            return stat

        stat = asyncio.run(go())
        waited = stat.backpressure_waits > 0
        s = stat.as_dict()
        s.pop("backpressure_waits")
        return dict(stat=s, waited=waited, evicted=rb.evicted, consumed=len(consumed))
    if name == "cursor":
        prompts = [("q%d" % i, [1, 2]) for i in range(6)]
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        c1, c2 = _FakeClient(api), _FakeClient(api)
        ctl1 = rollout.RolloutController([c1], rb, g)
        asyncio.run(ctl1.run(prompts, max_prompts=2))
        sd = ctl1.state_dict()
        ctl2 = rollout.RolloutController([c2], rb, g)
        ctl2.load_state_dict(sd)
        stat = asyncio.run(ctl2.run(prompts))
        return dict(sd=sd, calls=c2.calls, cursor=ctl2.cursor, stat=stat.as_dict())
    if name == "failed":
        bad = _FailingClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([bad], rb, g, max_dispatch_retries=0,
                                        breaker_threshold=10**9)
        stat = asyncio.run(ctl.run([[1, 2]] * 3))
        return _outcome(ctl, stat, rb, [bad])
    if name == "redispatch":
        bad, good = _FailingClient(api), _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([bad, good], rb, g, max_dispatch_retries=2,
                                        retry_backoff_s=0.001, breaker_threshold=10**9)
        stat = asyncio.run(ctl.run([[1, 2]] * 4))
        return dict(accepted=stat.accepted, failed=stat.failed, retried=stat.redispatched >= 1,
                    good=len(good.calls), bad_failed=bad.failures >= 1)
    if name == "deadline":
        slow, fast = _FakeClient(api, delay=30.0), _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([slow, fast], rb, g, dispatch_timeout_s=0.1,
                                        max_dispatch_retries=2, retry_backoff_s=0.001,
                                        breaker_threshold=10**9)
        t0 = time.monotonic()
        stat = asyncio.run(ctl.run([[1, 2]] * 2))
        return dict(fast_enough=time.monotonic() - t0 < 10.0, accepted=stat.accepted,
                    failed=stat.failed, retried=stat.redispatched >= 1, fast=len(fast.calls))
    if name == "breaker":
        healing = _FailingClient(api, fail_times=2)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([healing], rb, g, max_dispatch_retries=3,
                                        retry_backoff_s=0.001, breaker_threshold=2,
                                        breaker_cooldown_s=0.05, health_refresh_s=0.02)
        stat = asyncio.run(ctl.run([[1, 2]]))
        br = ctl.server("static0").breaker
        return dict(opens=br.opens, reclosed=br.closes >= 1, state=br.state,
                    accepted=stat.accepted, failed=stat.failed, retried=stat.redispatched)
    if name == "hung_health":
        hung, alive = _HungHealthClient(api, hang_s=1.0), _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([hung, alive], rb, g, health_poll_timeout_s=0.05)

        async def go():
            t0 = time.monotonic()
            stat = await ctl.run([[1, 2]] * 4)
            return stat, time.monotonic() - t0

        stat, elapsed = asyncio.run(go())
        st = ctl.server("static0")
        return dict(quick=elapsed < hung.hang_s, accepted=stat.accepted,
                    alive=len(alive.calls), healthy=st.healthy, health=st.health)
    if name == "stale_rejected":
        # Responses whose head version lags the trainer past the cap are
        # rejected at put (waiting would not freshen them).
        c = _FakeClient(api, version=0)
        rb = replay.ReplayBuffer(capacity=8, max_head_offpolicyness=1)
        rb.set_version(3)
        ctl = rollout.RolloutController([c], rb, g)
        stat = asyncio.run(ctl.run([[1, 2]] * 3))
        return dict(_outcome(ctl, stat, rb, [c]), rejected=rb.rejected)
    if name == "completed_groups":
        c = _FakeClient(api, delay=0.01)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController([c], rb, g)

        async def go():
            pump = asyncio.create_task(ctl.run([("g%d" % i, [1, 2]) for i in range(5)]))
            got = [t.qid async for t in ctl.completed_groups(5, timeout_per_group=10.0)]
            await pump
            return got

        got = asyncio.run(go())
        return dict(order=sorted(got), stat=ctl.stat.as_dict())
    if name == "episode_runner":
        class _Episode:
            def __init__(self, qid, prompt):
                self.qid, self.prompt = qid, prompt

            def to_trajectory(self, qid, birth_time=0.0):
                return replay.Trajectory(qid=qid, prompt_ids=list(self.prompt),
                                         output_ids=[[9]], output_logprobs=[[0.0]],
                                         no_eos=[False], version_start=2, version_end=3,
                                         data={"episode": True})

        seen = []

        def runner(client, qid, prompt_ids):
            seen.append((qid, list(prompt_ids)))
            return _Episode(qid, prompt_ids)

        c = _FakeClient(api)
        rb = replay.ReplayBuffer(capacity=8, max_head_offpolicyness=8)
        rb.set_version(2)
        ctl = rollout.RolloutController([c], rb, g, episode_runner=runner)
        stat = asyncio.run(ctl.run([("e%d" % i, [i, 1]) for i in range(3)]))
        trajs = _drain(rb)
        return dict(stat=stat.as_dict(), seen=sorted(seen), calls=c.calls,
                    trajs=[(t.qid, t.version_start, t.data) for t in trajs])
    if name == "discovery":
        # A late join and a leave between two runs: the joiner takes the
        # second run's dispatches, the leaver is drained and reaped.
        a, b = _FakeClient(api), _FakeClient(api, version=1)
        view = {"a": a}
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        ctl = rollout.RolloutController(replay=rb, gconfig=g, discovery=lambda: dict(view),
                                        health_refresh_s=0.0)
        async def go():  # one loop: the controller's refresh lock belongs to it
            first = (await ctl.run([("p%d" % i, [1, 2]) for i in range(3)])).as_dict()
            members = [(s.sid, s.dynamic, s.draining) for s in ctl.servers]
            view["b"] = b
            del view["a"]
            second = (await ctl.run([("q%d" % i, [1, 2]) for i in range(3)])).as_dict()
            return first, members, second

        first, members, second = asyncio.run(go())
        return dict(first=first, second=second, members=members, calls=[a.calls, sorted(b.calls)],
                    after=[(s.sid, s.dynamic, s.draining) for s in ctl.servers],
                    epoch=ctl.membership_epoch, sd=ctl.state_dict()["membership_epoch"])
    if name == "paramstore":
        # Health polls pin each server's version (exclusive), dispatches
        # pin the trainer's version until they end, and a laggard's pin
        # moves when it catches up, retiring the old version.
        ps = jparamstore if pkg == "jax" else tparamstore
        store = ps.ParamStore(retain=1)
        store.publish(manifest=[{"dtype": "uint8", "shape": [4]}], payload=bytes(4))
        lag, head = _FakeClient(api, version=1), _FakeClient(api, version=1)
        rb = replay.ReplayBuffer(capacity=16, max_head_offpolicyness=8)
        rb.set_version(2)
        ctl = rollout.RolloutController([lag, head], rb, g, paramstore=store,
                                        health_refresh_s=0.0)
        asyncio.run(ctl._refresh_health())  # both pin v1
        store.publish(manifest=[{"dtype": "uint8", "shape": [4]}], payload=bytes(4))
        head.version = 2  # v1 stays: the laggard still pins it
        seen = []
        real = head.agenerate

        async def agenerate(inp):
            seen.append((inp.qid, store.pins(2)))
            return await real(inp)

        head.agenerate = lag.agenerate = agenerate
        async def go():
            stat = (await ctl.run([("q%d" % i, [1, 2]) for i in range(2)])).as_dict()
            before = dict(live=store.live_versions(), v1=store.pins(1), v2=store.pins(2))
            lag.version = 2
            await ctl._refresh_health()
            return stat, before

        stat, before = asyncio.run(go())
        return dict(stat=stat, seen=sorted(seen), before=before, live=store.live_versions(),
                    v1=store.pins(1), v2=store.pins(2))
    raise KeyError(name)


SCENARIOS = ["stamps", "balance", "dead_server", "backpressure", "cursor", "failed",
             "redispatch", "deadline", "breaker", "hung_health", "stale_rejected",
             "completed_groups", "episode_runner", "discovery", "paramstore"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_matches_jax(name):
    got, want = _scenario("port", name), _scenario("jax", name)
    assert got == want


def test_controller_outcomes_are_the_reference_cases():
    """A few of tests/test_rollout.py's own assertions, on the port."""
    s = _scenario("port", "stamps")
    assert s["stat"]["accepted"] == 4 and s["cursor"] == 4
    assert [q for q, _, _ in s["resident"]] == [f"prompt{i}" for i in range(4)]
    assert all(v0 == 3 and v1 == 4 for _, v0, v1 in s["resident"])
    b = _scenario("port", "balance")
    assert b["calls"][0] == [] and len(b["calls"][1]) == 6 and b["inflight"] == 4
    c = _scenario("port", "cursor")
    assert c["calls"] == ["q2", "q3", "q4", "q5"] and c["stat"]["submitted"] == 6
    br = _scenario("port", "breaker")
    assert br == dict(opens=1, reclosed=True, state="closed", accepted=1, failed=0, retried=2)


def test_breaker_transitions_match_jax():
    """Both breakers on one fake clock through the same events."""
    log = {}
    for pkg, mod in (("jax", jfleet), ("port", tfleet)):
        now = [0.0]
        seen = []
        br = mod.CircuitBreaker(threshold=2, cooldown_s=1.0, on_transition=seen.append,
                                clock=lambda: now[0])
        trace = []
        for ev, dt in [("f", 0), ("f", 0), ("probe?", 0.5), ("f", 0.2), ("probe?", 0.9),
                       ("probe?", 0.2), ("begin", 0), ("f", 0), ("probe?", 1.1), ("begin", 0),
                       ("s", 0), ("f", 0)]:
            now[0] += dt
            if ev == "f":
                br.record_failure()
            elif ev == "s":
                br.record_success()
            elif ev == "begin":
                br.begin_probe()
            trace.append((br.state, br.probe_due(), br.allow_dispatch(), br.consecutive_failures))
        log[pkg] = (trace, seen, br.opens, br.closes)
    assert log["port"] == log["jax"]
    assert log["port"][2] == 2 and log["port"][3] == 1
    with pytest.raises(ValueError):
        tfleet.CircuitBreaker(threshold=0)
