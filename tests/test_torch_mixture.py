"""The port's task-mixture scheduler (`areal_tpu_torch/data/mixture.py`)
against the JAX package's: twins of tests/test_mixture.py in both
packages (weights, proportions, emitted items, state round trips, the
old-record backfill by `fast_forward`, the adaptive curriculum, the
starvation bound, `build_mixture`, the controller's namespaced qids and
its recover path), the two schedulers' draws, states and adaptive
weights equal bit for bit on seeded mixtures, and a port controller with
``mixture=`` on a stub client dispatching the JAX controller's qids."""

import asyncio
import math

import numpy as np
import pytest

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.data import mixture as jmix
from areal_tpu.system import replay as jreplay
from areal_tpu.system import rollout as jrollout
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.data import mixture as tmix
from areal_tpu_torch.system import replay as treplay
from areal_tpu_torch.system import rollout as trollout

PKGS = {
    "jax": (jmix, jmodel_api, jreplay, jrollout),
    "port": (tmix, tmodel_api, treplay, trollout),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def _src(mix, name, n=4, weight=1.0, wm=0.5):
    return mix.TaskSource(name=name, prompts=[[i, i + 1] for i in range(n)], weight=weight,
                          reward_watermark=wm)


def _schedule(stream, n):
    """(task, epoch, index) of the next n draws."""
    out = []
    for _ in range(n):
        it = next(stream)
        out.append((it["task"], it["epoch"], it["index"]))
    return out


# ---------------- weights ----------------


@BOTH
def test_weights_normalize_to_one(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a", weight=2.0), _src(mix, "b"), _src(mix, "c")])
    assert m.weights == {"a": 0.5, "b": 0.25, "c": 0.25}
    assert math.isclose(sum(m.weights.values()), 1.0)


@BOTH
def test_draw_proportions_match_weights_exactly(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a", weight=2.0), _src(mix, "b"), _src(mix, "c")])
    counts = {"a": 0, "b": 0, "c": 0}
    for _ in range(400):
        counts[next(m)["task"]] += 1
    assert counts == {"a": 200, "b": 100, "c": 100}


@BOTH
@pytest.mark.parametrize("bad", ["empty", "duplicate", "zero", "negative", "no_prompts"])
def test_invalid_mixtures_fail_loudly(pkg, bad):
    mix = PKGS[pkg][0]
    sources = {
        "empty": [],
        "duplicate": [_src(mix, "a"), _src(mix, "a")],
        "zero": [_src(mix, "a", weight=0.0)],
        "negative": [_src(mix, "a", weight=-1.0)],
        "no_prompts": [mix.TaskSource(name="a", prompts=[])],
    }[bad]
    with pytest.raises(ValueError):
        mix.TaskMixtureStream(sources)


# ---------------- emitted items ----------------


@BOTH
def test_items_carry_task_epoch_index_and_ids(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a", n=2)])
    assert _schedule(m, 4) == [("a", 0, 0), ("a", 0, 1), ("a", 1, 0), ("a", 1, 1)]


@BOTH
def test_dict_and_pair_sources(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([mix.TaskSource("a", [{"qid": "q7", "prompt_ids": [1, 2],
                                                      "meta": "x"}])])
    it = next(m)
    assert it["qid"] == "q7" and it["meta"] == "x"
    assert it["prompt_ids"] == [1, 2] and it["task"] == "a"
    m = mix.TaskMixtureStream([mix.TaskSource("a", [("q0", [3, 4])])])
    it = next(m)
    assert it["qid"] == "q0" and it["prompt_ids"] == [3, 4]


# ---------------- persistence ----------------


def _two(mix):
    return mix.TaskMixtureStream([_src(mix, "a", n=3, weight=2.0), _src(mix, "b", n=2)])


@BOTH
def test_state_dict_round_trip_resumes_exactly(pkg):
    mix = PKGS[pkg][0]
    ref = _two(mix)
    _schedule(ref, 7)
    sd = ref.state_dict()
    expected = _schedule(ref, 10)
    fresh = _two(mix)
    fresh.load_state_dict(sd)
    assert _schedule(fresh, 10) == expected
    assert fresh.drawn == ref.drawn


@BOTH
def test_old_record_backfill_via_fast_forward(pkg):
    mix = PKGS[pkg][0]
    ref = _two(mix)
    _schedule(ref, 7)
    fresh = _two(mix)
    fresh.fast_forward(7)
    assert _schedule(fresh, 10) == _schedule(ref, 10)


@BOTH
def test_shrunk_dataset_wraps_the_restored_cursor(pkg):
    mix = PKGS[pkg][0]
    big = mix.TaskMixtureStream([_src(mix, "a", n=10)])
    _schedule(big, 7)
    small = mix.TaskMixtureStream([_src(mix, "a", n=3)])
    small.load_state_dict(big.state_dict())
    assert small._cursors["a"] == 7 % 3
    next(small)


@BOTH
def test_unknown_tasks_dropped_and_new_tasks_kept(pkg):
    mix = PKGS[pkg][0]
    sd = _two(mix).state_dict()
    sd["cursors"]["gone"] = 99
    other = mix.TaskMixtureStream([_src(mix, "a", n=3), _src(mix, "new", n=2)])
    other.load_state_dict(sd)
    assert "gone" not in other._cursors and other._cursors["new"] == 0


# ---------------- the adaptive curriculum ----------------


@BOTH
def test_below_watermark_task_is_upweighted(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a"), _src(mix, "b")], adaptive=True)
    for _ in range(5):
        m.observe_reward("a", 0.0)
        m.observe_reward("b", 1.0)
    w = m.weights
    assert w["a"] > w["b"] and math.isclose(sum(w.values()), 1.0)


@BOTH
def test_boost_is_capped(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a"), _src(mix, "b")], adaptive=True,
                              adapt_gain=100.0, max_boost=3.0)
    m.observe_reward("a", 0.0)
    m.observe_reward("b", 1.0)
    assert math.isclose(m.weights["a"] / m.weights["b"], 3.0)


@BOTH
def test_passing_and_unobserved_tasks_keep_base_weights(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a"), _src(mix, "b")], adaptive=True)
    m.observe_reward("a", 0.9)
    m.observe_reward("b", 0.8)
    assert m.weights == {"a": 0.5, "b": 0.5}
    m = mix.TaskMixtureStream([_src(mix, "a"), _src(mix, "b")], adaptive=True)
    m.observe_reward("b", 1.0)  # "a" never graded yet
    assert m.weights == {"a": 0.5, "b": 0.5}


@BOTH
def test_reward_ema_blends(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a")], ema_alpha=0.5)
    assert m.reward_ema("a") is None
    m.observe_reward("a", 1.0)
    assert m.reward_ema("a") == 1.0
    m.observe_reward("a", 0.0)
    assert m.reward_ema("a") == 0.5
    m.observe_reward("nope", 1.0)
    assert m.reward_ema("nope") is None


@BOTH
def test_sync_replay_folds_staleness_watermarks(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a"), _src(mix, "b")])
    m.sync_replay({"a": {"staleness_mean": 2.0}, "b": {"staleness_mean": 0.5},
                   "ghost": {"staleness_mean": 9.0}})
    assert m._staleness_ema == {"a": 2.0, "b": 0.5}


@BOTH
def test_low_weight_task_is_never_starved_past_bound(pkg):
    mix = PKGS[pkg][0]
    m = mix.TaskMixtureStream([_src(mix, "a", weight=10.0), _src(mix, "b")])
    bound = m.starvation_bound("b")
    assert bound == math.ceil(11.0) + 1
    last = 0
    for i in range(1, 301):
        if next(m)["task"] == "b":
            assert i - last <= bound
            last = i
    assert last > 300 - bound


@BOTH
def test_build_mixture(pkg):
    mix = PKGS[pkg][0]
    m = mix.build_mixture({"math": 3.0, "code": 1.0}, {"math": [[1]], "code": [[2]]},
                          reward_watermarks={"code": 0.8})
    assert m.weights == {"math": 0.75, "code": 0.25}
    assert m.sources["code"].reward_watermark == 0.8
    assert m.sources["math"].reward_watermark == 0.5
    with pytest.raises(ValueError):
        mix.build_mixture({"math": 1.0}, {})


# ---------------- the controller's qids ----------------


@BOTH
def test_mixture_items_get_namespaced_qids(pkg):
    mix, _, _, rollout = PKGS[pkg]
    norm = rollout._normalize_prompt
    assert norm({"task": "math", "epoch": 1, "index": 3, "prompt_ids": [1, 2]}, cursor=99) == (
        "math:e1:p3", [1, 2], "math")
    m = mix.TaskMixtureStream([_src(mix, "a", n=2)])
    assert [norm(next(m), i)[0] for i in range(4)] == ["a:e0:p0", "a:e0:p1", "a:e1:p0", "a:e1:p1"]
    assert norm({"qid": "mine", "task": "code", "epoch": 2, "index": 0, "prompt_ids": [5]},
                cursor=0)[0] == "mine"
    assert norm([1, 2, 3], 5) == ("prompt5", [1, 2, 3], "")
    assert norm(("q", [4]), 0) == ("q", [4], "")
    assert norm({"prompt_ids": [7]}, 2)[0] == "prompt2"
    assert norm({"epoch": 0, "index": 1, "prompt_ids": [1]}, cursor=8) == ("task:e0:p1", [1], "")


def _ctl(pkg, m, clients=()):
    _, api, replay, rollout = PKGS[pkg]
    kw = {} if clients else {"discovery": lambda: {}}
    return rollout.RolloutController(
        list(clients), replay=replay.ReplayBuffer(capacity=64, max_head_offpolicyness=1),
        gconfig=api.GenerationHyperparameters(n=1, max_new_tokens=4), mixture=m, **kw)


@BOTH
def test_mixture_state_rides_controller_state_dict(pkg):
    mix = PKGS[pkg][0]
    ref = _two(mix)
    ctl = _ctl(pkg, ref)
    _schedule(ref, 5)
    ctl.cursor = 5
    sd = ctl.state_dict()
    assert sd["mixture"]["drawn"] == 5
    expected = _schedule(ref, 6)
    fresh = _two(mix)
    ctl2 = _ctl(pkg, fresh)
    ctl2.load_state_dict(sd)
    assert _schedule(fresh, 6) == expected
    assert ctl2._skip_on_run == 0  # the stream resumed itself


@BOTH
def test_old_record_without_mixture_fast_forwards(pkg):
    mix = PKGS[pkg][0]
    ref = _two(mix)
    _schedule(ref, 5)
    expected = _schedule(ref, 6)
    fresh = _two(mix)
    ctl = _ctl(pkg, fresh)
    ctl.load_state_dict({"cursor": 5, "stat": {}})
    assert _schedule(fresh, 6) == expected
    assert ctl._skip_on_run == 0


# ---------------- the two packages bit for bit ----------------


def _seeded_sources(mix, seed):
    rng = np.random.default_rng(seed)
    n_tasks = int(rng.integers(2, 5))
    return [
        mix.TaskSource(name=f"t{k}",
                       prompts=[[int(x) for x in rng.integers(0, 100, size=3)]
                                for _ in range(int(rng.integers(1, 6)))],
                       weight=float(rng.uniform(0.1, 5.0)),
                       reward_watermark=float(rng.uniform(0.2, 0.9)))
        for k in range(n_tasks)
    ]


def _life(mix, seed):
    """Draws, state round trips, a fast-forwarded twin and adaptive
    feedback from seeded rewards, recorded."""
    rng = np.random.default_rng(seed + 1000)
    m = mix.TaskMixtureStream(_seeded_sources(mix, seed), adaptive=True, adapt_gain=1.5,
                              max_boost=3.0, ema_alpha=0.3)
    log = [dict(m.weights)]
    for _ in range(6):
        for _ in range(int(rng.integers(1, 9))):
            it = next(m)
            log.append((it["task"], it["epoch"], it["index"], it["prompt_ids"]))
            m.observe_reward(it["task"], float(rng.choice([0.0, 1.0])))
        m.observe_staleness(f"t{int(rng.integers(0, 2))}", float(rng.uniform(0, 3)))
        log.append(dict(m.weights))
        log.append(m.state_dict())
    twin = mix.TaskMixtureStream(_seeded_sources(mix, seed))
    twin.fast_forward(7)
    log.append(_schedule(twin, 5))
    restored = mix.TaskMixtureStream(_seeded_sources(mix, seed), adaptive=True)
    restored.load_state_dict(m.state_dict())
    log.append(_schedule(restored, 9))
    log.append([restored.starvation_bound(t) for t in sorted(restored.sources)])
    return log


@pytest.mark.parametrize("seed", range(6))
def test_mixture_lives_equal_jax_bit_for_bit(seed):
    assert _life(tmix, seed) == _life(jmix, seed)


class _StubClient:
    """LLMAPIClient-shaped: answers every prompt with one token."""

    def __init__(self, api):
        self.api = api
        self.max_inflight = 4
        self.calls = []

    def health(self):
        return {"status": "ok", "version": 0, "queue_depth": 0, "live_slots": 0,
                "capacity": 4}

    async def agenerate(self, inp):
        self.calls.append(inp.qid)
        return self.api.APIGenerateOutput(
            qid=inp.qid, prompt_ids=list(inp.prompt_ids), output_ids=[[1]],
            output_logprobs=[[-0.1]], no_eos=[False], version=0, version_start=0)


def _controller_run(pkg):
    mix, api, _, _ = PKGS[pkg]
    client = _StubClient(api)
    m = mix.build_mixture({"math": 3.0, "code": 1.0},
                          {"math": [[1, 2], [3, 4], [5]], "code": [("c-own", [6, 7]), [8]]})
    ctl = _ctl(pkg, m, clients=[client])
    asyncio.run(ctl.run(max_prompts=6))
    first = sorted(client.calls)
    sd = ctl.state_dict()
    m2 = mix.build_mixture({"math": 3.0, "code": 1.0},
                           {"math": [[1, 2], [3, 4], [5]], "code": [("c-own", [6, 7]), [8]]})
    client2 = _StubClient(api)
    ctl2 = _ctl(pkg, m2, clients=[client2])
    ctl2.load_state_dict(sd)
    asyncio.run(ctl2.run(max_prompts=6))
    tasks = sorted((t.qid, t.task) for t in ctl.replay._entries)
    return first, sorted(client2.calls), tasks, ctl.stat.as_dict()


def test_controller_with_a_mixture_dispatches_jax_qids():
    """`run()` with no source pumps the mixture; a controller restored
    from `state_dict()` draws the remaining qids; the trajectories carry
    their task; all as the JAX controller does."""
    got = _controller_run("port")
    assert got == _controller_run("jax")
    first, rest, tasks, stat = got
    assert len(first) == len(rest) == 6 and not set(first) & set(rest) - {"c-own"}
    assert {t for _, t in tasks} == {"math", "code"} and stat["accepted"] == 6
