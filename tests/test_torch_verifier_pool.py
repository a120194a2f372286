"""The port's verifier fleet (`areal_tpu_torch/system/verifier_pool.py`)
against the JAX package's: twins of tests/test_verifier_pool.py (the
membership under names.verifier_servers with keepalive TTL eviction,
per-attempt deadlines, the retry on a different server, the typed shape
mismatch, the breaker's life on a fake clock with the probe's priority,
and the fall back to the in-process registry), either package's worker
behind either package's pool, and the two pools' breaker states and
choices through one scripted run on a fake clock.  (The supervisor's
verifier lane comes with the supervisor.)"""

import time

import pytest

from areal_tpu.base import faults as jfaults
from areal_tpu.interfaces import reward_service as jrs
from areal_tpu.system import verifier_pool as jvp
from areal_tpu_torch.base import faults as faults_mod
from areal_tpu_torch.base import metrics, name_resolve, names
from areal_tpu_torch.interfaces import reward_service
from areal_tpu_torch.system.fleet import CircuitBreaker
from areal_tpu_torch.system.verifier_pool import (
    VerifierPool,
    VerifierWorker,
    list_verifiers,
    verifier_discovery,
)

MATH_OK = {"task": "math", "text": r"the answer is \boxed{7}",
           "payload": {"solutions": [r"\boxed{7}"]}}
MATH_BAD = {"task": "math", "text": r"\boxed{3}", "payload": {"solutions": [r"\boxed{7}"]}}

# Nothing listens here: a connection is refused at once, so a dead
# backend's attempt fails fast.
DEAD_URL = "http://127.0.0.1:1"

PKGS = {
    "port": dict(pool=VerifierPool, worker=VerifierWorker, faults=faults_mod.FaultInjector,
                 rs=reward_service),
    "jax": dict(pool=jvp.VerifierPool, worker=jvp.VerifierWorker, faults=jfaults.FaultInjector,
                rs=jrs),
}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean_fleet():
    name_resolve.clear_subtree(names.verifier_servers("e", "t"))
    yield
    name_resolve.clear_subtree(names.verifier_servers("e", "t"))


@pytest.fixture
def worker():
    w = VerifierWorker()
    yield w
    w.close()


def _announce(sid, url="http://h:1", ttl=None):
    kw = {"keepalive_ttl": ttl} if ttl is not None else {}
    name_resolve.add(names.verifier_server("e", "t", sid), url, replace=True, **kw)


# ---------------- membership ----------------


def test_discovery_lists_announced_verifiers():
    _announce("a", "http://h:1")
    _announce("b", "http://h:2")
    discover = verifier_discovery("e", "t")
    assert discover() == {"a": "http://h:1", "b": "http://h:2"}
    assert list_verifiers("e", "t") == ["a", "b"]
    name_resolve.delete(names.verifier_server("e", "t", "a"))
    assert list_verifiers("e", "t") == ["b"]


def test_ttl_expiry_evicts_dead_worker():
    _announce("dying", ttl=0.05)
    pool = VerifierPool(discovery=verifier_discovery("e", "t"), refresh_s=0.0)
    assert "dying" in pool.servers()
    time.sleep(0.15)
    assert "dying" not in pool.servers()
    # The breaker outlives the eviction: a rejoin on the same sid is
    # re-admitted through it, not as a stranger.
    assert "dying" in pool.breakers


def test_late_join_picks_up_within_one_refresh():
    _announce("a")
    pool = VerifierPool(discovery=verifier_discovery("e", "t"), refresh_s=0.0)
    assert set(pool.servers()) == {"a"}
    _announce("b")
    assert set(pool.servers()) == {"a", "b"}
    assert isinstance(pool.breakers["b"], CircuitBreaker)


def test_worker_announce_heartbeat_and_deregister(worker):
    sid = worker.announce("e", "t", ttl=0.3)
    assert sid == f"v{worker.port}"
    time.sleep(0.6)  # the heartbeat outlives the TTL window
    assert sid in list_verifiers("e", "t")
    worker.close()
    assert sid not in list_verifiers("e", "t")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_needs_discovery_or_servers(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg]["pool"]()


# ---------------- pooled grading ----------------


def test_round_trip_through_one_worker(worker):
    pool = VerifierPool(servers={"w": worker.url})
    assert pool.verify_batch([MATH_OK, MATH_BAD]) == [True, False]
    assert pool.graded_pooled == 2 and pool.graded_local == 0
    assert worker.graded == 2


@pytest.mark.parametrize("pool_pkg", ["port", "jax"])
@pytest.mark.parametrize("worker_pkg", ["port", "jax"])
def test_either_worker_behind_either_pool(pool_pkg, worker_pkg):
    """One wire format: each package's pool grades through each
    package's worker, with the in-process registry's grades."""
    w = PKGS[worker_pkg]["worker"]()
    try:
        pool = PKGS[pool_pkg]["pool"](servers={"w": w.url})
        items = [MATH_OK, MATH_BAD, {**MATH_BAD, "text": r"\boxed{7}"}]
        want = [reward_service.grade_item(it) for it in items]
        assert want == [True, False, True]
        assert pool.verify_batch(items) == want
        assert pool.graded_pooled == 3 and pool.graded_local == 0 and w.graded == 3
    finally:
        w.close()


def test_attempt_deadline_cuts_off_slow_backend():
    w = VerifierWorker(faults=faults_mod.FaultInjector.parse("slow@ms=500&point=grade"))
    try:
        pool = VerifierPool(servers={"slow": w.url}, attempt_timeout_s=0.1, max_attempts=2,
                            backoff_s=0.0)
        t0 = time.monotonic()
        assert pool.verify_batch([MATH_OK]) == [True]
        # The deadline fired and the pool degraded rather than wait out
        # the 500 ms grade.
        assert time.monotonic() - t0 < 0.45
        assert pool.graded_local == 1 and pool.graded_pooled == 0
    finally:
        w.close()


def test_retry_lands_on_a_different_server(worker):
    bad = VerifierWorker(faults=faults_mod.FaultInjector.parse("error@point=grade"))
    try:
        # The sorted tie-break sends to "a" (the erroring backend) first;
        # the retry must land on "z".
        pool = VerifierPool(servers={"a": bad.url, "z": worker.url}, max_attempts=3,
                            backoff_s=0.0, breaker_threshold=5)
        assert pool.verify_batch([MATH_OK, MATH_BAD]) == [True, False]
        assert pool.redispatches >= 1
        assert pool.graded_pooled == 2 and pool.graded_local == 0
        assert worker.graded == 2 and bad.graded == 0
        assert pool.breakers["a"].state == CircuitBreaker.CLOSED  # one failure < threshold
    finally:
        bad.close()


def test_shape_mismatch_is_typed_and_counted(worker):
    from areal_tpu.base.metrics import parse_prometheus_text as jax_parse

    def shape_errors():
        text = metrics.default_registry().expose()
        samples, types = metrics.parse_prometheus_text(text)
        # The port's parser reads its own exposition as the JAX one does.
        assert (samples, types) == jax_parse(text)
        return sum(v for name, labels, v in samples
                   if name == "areal_reward_remote_errors_total"
                   and labels.get("reason") == "shape")

    worker.grade_batch = lambda items: [True] * (len(items) + 1)
    with pytest.raises(reward_service.VerifierShapeError) as ei:
        reward_service.post_verify(worker.url, [MATH_OK], 5.0)
    assert reward_service._error_reason(ei.value) == "shape"
    before = shape_errors()
    pool = VerifierPool(servers={"w": worker.url}, max_attempts=1, backoff_s=0.0)
    # Typed, retryable, counted, and the pool still answers.
    assert pool.verify_batch([MATH_OK]) == [True]
    assert pool.graded_local == 1
    assert shape_errors() == before + 1


# ---------------- the breaker on a fake clock ----------------


def _fake_clock_pool(pkg, urls, clk, **kw):
    kw.setdefault("attempt_timeout_s", 0.5)
    kw.setdefault("max_attempts", 1)
    kw.setdefault("backoff_s", 0.0)
    kw.setdefault("breaker_threshold", 1)
    kw.setdefault("breaker_cooldown_s", 5.0)
    return PKGS[pkg]["pool"](discovery=lambda: dict(urls), refresh_s=0.0, clock=clk, **kw)


def test_open_breaker_blocks_until_probe_recloses(worker):
    urls = {"a": DEAD_URL}
    clk = _Clock()
    pool = _fake_clock_pool("port", urls, clk)
    assert pool.verify_batch([MATH_OK]) == [True]  # the local fallback
    br = pool.breakers["a"]
    assert br.state == CircuitBreaker.OPEN and br.opens == 1
    # Inside the cooldown the open breaker blocks dispatch.
    assert pool.verify_batch([MATH_OK]) == [True]
    assert pool.graded_local == 2 and br.opens == 1
    # The backend heals; past the cooldown the next batch is the probe.
    urls["a"] = worker.url
    clk.t = 5.0
    assert pool.verify_batch([MATH_OK]) == [True]
    assert br.state == CircuitBreaker.CLOSED and br.closes == 1
    assert pool.graded_pooled == 1


def test_failed_probe_reopens_with_fresh_cooldown():
    urls = {"a": DEAD_URL}
    clk = _Clock()
    pool = _fake_clock_pool("port", urls, clk)
    pool.verify_batch([MATH_OK])
    clk.t = 5.0
    # The probe rides the batch, fails on the still-dead backend and
    # re-opens with a fresh cooldown.
    assert pool.verify_batch([MATH_OK]) == [True]
    br = pool.breakers["a"]
    assert br.state == CircuitBreaker.OPEN and br.opens == 2
    clk.t = 9.0
    assert not br.probe_due()
    clk.t = 10.0
    assert br.probe_due()


def test_probe_takes_priority_over_healthy_backends(worker):
    urls = {"a": DEAD_URL, "z": worker.url}
    clk = _Clock()
    pool = _fake_clock_pool("port", urls, clk, max_attempts=2)
    assert pool.verify_batch([MATH_OK]) == [True]  # a fails -> z
    br = pool.breakers["a"]
    assert br.state == CircuitBreaker.OPEN
    assert pool.redispatches == 1 and pool.graded_pooled == 1
    urls["a"] = worker.url
    clk.t = 5.0
    assert pool.verify_batch([MATH_OK]) == [True]
    assert br.state == CircuitBreaker.CLOSED and br.closes == 1


def _scripted_run(pkg, monkeypatch, live_url):
    """One scripted life through a pool on a fake clock: a dead member,
    a healthy one and a late joiner; every POST attempt's member and,
    after each batch, each breaker's (state, opens, closes) and the
    pool's counters."""
    rs = PKGS[pkg]["rs"]
    sent = []
    real = rs.post_verify
    by_url = {}

    def record(url, items, timeout_s, token=""):
        sent.append(by_url.get(url, url))
        return real(url, items, timeout_s, token)

    monkeypatch.setattr(rs, "post_verify", record)
    urls = {"a": DEAD_URL, "b": live_url}
    by_url.update({DEAD_URL: "dead", live_url: "live"})
    clk = _Clock()
    pool = _fake_clock_pool(pkg, urls, clk, max_attempts=2, breaker_threshold=2,
                            breaker_cooldown_s=3.0)
    log = []

    def batch(label):
        out = pool.verify_batch([MATH_OK, MATH_BAD])
        log.append((label, out, tuple(sent), pool.graded_pooled, pool.graded_local,
                    pool.redispatches, tuple(
                        (sid, b.state, b.opens, b.closes) for sid, b in sorted(pool.breakers.items())
                    )))
        sent.clear()

    for i in range(3):
        batch(f"warm{i}")
    clk.t = 1.0
    urls["c"] = live_url
    batch("join")
    clk.t = 4.0
    batch("probe_fails")
    urls["a"] = live_url
    clk.t = 8.0
    batch("probe_heals")
    del urls["b"], urls["c"]
    batch("leave")
    urls.clear()
    batch("empty")
    return log


def test_breaker_life_and_choices_match_jax(worker, monkeypatch):
    """Both pools, one script on a fake clock: the same members chosen
    attempt by attempt, the same breaker states and counters."""
    got = _scripted_run("port", monkeypatch, worker.url)
    want = _scripted_run("jax", monkeypatch, worker.url)
    assert got == want
    assert [row[0] for row in got][-1] == "empty" and got[-1][4] > 0  # local at the end


# ---------------- degradation ----------------


def test_empty_fleet_degrades_to_local_registry():
    pool = VerifierPool(servers={})
    assert pool.verify_batch([MATH_OK, MATH_BAD]) == [True, False]
    assert pool.graded_local == 2 and pool.graded_pooled == 0


def test_recovery_clears_degraded_flag(worker):
    urls = {}
    pool = VerifierPool(discovery=lambda: dict(urls), refresh_s=0.0)
    pool.verify_batch([MATH_OK])
    assert pool._degraded
    urls["w"] = worker.url
    assert pool.verify_batch([MATH_OK]) == [True]
    assert not pool._degraded and pool.graded_pooled == 1


def test_local_fallback_disabled_raises():
    pool = VerifierPool(servers={}, local_fallback=False)
    with pytest.raises(RuntimeError):
        pool.verify_batch([MATH_OK])
    dead = VerifierPool(servers={"a": DEAD_URL}, local_fallback=False, max_attempts=1,
                        attempt_timeout_s=0.5, backoff_s=0.0)
    with pytest.raises(reward_service._RETRYABLE):
        dead.verify_batch([MATH_OK])


# ---------------- the worker's faults and the reward interface ----------------


def test_kill_crashes_without_deregistering(tmp_path):
    """A due `kill` crashes the worker as a preempted node: the flight
    ring is dumped beside the trace shards (the JAX package's file), the
    announcement is left to its TTL and the server stops answering."""
    from areal_tpu_torch.base import tracer

    tracer._reset_for_tests()
    try:
        tracer.configure(role="verifier", rank=0, dir=str(tmp_path), enabled=False, force=True)
        w = VerifierWorker(faults=faults_mod.FaultInjector.parse("kill@t=0.3s"))
        sid = w.announce("e", "t", ttl=0.4)
        deadline = time.monotonic() + 10
        while not w._crashed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w._crashed
        assert sid in list_verifiers("e", "t")  # no deregistration
        time.sleep(0.6)
        assert sid not in list_verifiers("e", "t")  # the TTL evicted it
        dumps = jvp.tracer.read_flight_dumps(str(tmp_path))
        assert [d["reason"] for d in dumps] == ["fault_kill"]
        assert dumps[0]["role"] == "verifier" and dumps[0]["events"][-1]["kind"] == "kill"
        with pytest.raises(Exception):
            reward_service.post_verify(w.url, [MATH_OK], 1.0)
    finally:
        tracer._reset_for_tests()


def test_reward_interface_grades_through_the_fleet(worker):
    """`verifier_pool=True`: the interface discovers the trial's fleet
    and grades there, with the in-process rewards."""
    import numpy as np

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import Model
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface

    worker.announce("e", "t", "w0", ttl=30.0)
    tok = CharTokenizer(512)
    rows = {"m0": {"query_id": "m0", "task": "math", "solutions": [r"\boxed{2}"]},
            "m1": {"query_id": "m1", "task": "math", "solutions": [r"\boxed{5}"]}}
    prompt = tok.encode("q: ")
    seqs, lens = [], []
    for resp in (r"\boxed{2}", r"\boxed{3}", r"\boxed{5}", "none"):
        ids = prompt + tok.encode(resp)
        seqs.append(ids)
        lens.append(len(ids))
    pmask = np.concatenate([[1] * len(prompt) + [0] * (n - len(prompt)) for n in lens])
    sample = SequenceSample(
        keys={"packed_input_ids", "prompt_mask"}, ids=["m0", "m1"],
        seqlens={"packed_input_ids": [lens[:2], lens[2:]], "prompt_mask": [lens[:2], lens[2:]]},
        data={"packed_input_ids": np.concatenate(seqs).astype(np.int64),
              "prompt_mask": pmask.astype(bool)},
    )
    model = Model(name="reward", engine=None, tokenizer=tok, config=None)
    local = MultiTaskRewardInterface(id2info=rows).inference(model, sample, MicroBatchSpec())
    pooled_if = MultiTaskRewardInterface(id2info=rows, verifier_pool=True,
                                         pool_experiment="e", pool_trial="t")
    pooled = pooled_if.inference(model, sample, MicroBatchSpec())
    assert pooled.data["rewards"].tolist() == local.data["rewards"].tolist() == [5, -5, 5, -5]
    assert worker.graded == 4 and pooled_if._pool.graded_pooled == 4
