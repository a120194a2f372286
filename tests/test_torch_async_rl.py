"""The port's asynchronous RL on the CPU against the JAX package's:

- `rollout_ahead=1` through both packages' `run_experiment` (one tiny
  checkpoint written by the JAX package, greedy generation, the query-id
  reward of tests/test_torch_experiments.py's parity case): equal graded
  tokens, the per-step train stats within rtol 1e-4, atol 1e-6, and the
  final checkpoints within the same;
- `max_head_offpolicyness=0` bit for bit the port's synchronous trial;
- `max_head_offpolicyness=1`: the invariants tests/test_rollout.py:553
  holds the JAX pipeline to;
- the mutual exclusions, in the port's check and master as in JAX's;
- `anomaly_imp_ratio_max`'s verdicts against the JAX interface's on
  equal `aux`, and a trial it quarantines;
- a recover round trip under cap 1;
- a static burst binds its weights once: a weight swap from another
  thread between decode steps leaves the burst's tokens those of the old
  weights."""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.model_api import GenerationHyperparameters as JGenerationHyperparameters
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.interfaces.ppo import PPOActorInterface as JPPOActorInterface
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.base import integrity
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.interfaces.ppo import PPOActorInterface
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.system.master import (
    ExperimentSaveEvalControl,
    InProcessPool,
    MasterWorker,
)
from tests import fixtures
from tests.test_torch_experiments import _PARITY_REWARD, _SEEN, _flat

torch.set_num_threads(2)


def _cfg(tmp_path, rows, **kw):
    """tests/test_rollout.py:526's trial, in the port."""
    kw.setdefault("ctrl", ExperimentSaveEvalControl())
    kw.setdefault("ppo_kwargs", {"n_minibatches": 1, "kl_ctl": 0.0})
    return exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": ttiny()}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": {r["query_id"]: r for r in rows}},
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8),
        optimizer=OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0),
        batch_size=4,
        total_train_epochs=1,
        seed=1,
        fileroot=str(tmp_path),
        **kw,
    )


def _run(cfg, threads=None):
    tok = CharTokenizer(512)
    old = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        return exps.run_experiment(exps.build_ppo_math(cfg, tok), tokenizer=tok, device="cpu")
    finally:
        torch.set_num_threads(old)


# ---------------- rollout_ahead=1 against the JAX trial ----------------

def _ahead_both(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(13)),
                           model_type="qwen2")
    rows = fixtures.build_math_rows(12, seed=5)
    common = dict(batch_size=4, total_train_epochs=1, rollout_ahead=1,
                  ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.0})
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("hf", {"path": ckpt}),
        dataset=JDatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=JInterfaceAbstraction(_PARITY_REWARD),
        gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=JOptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        ctrl=JCtrl(save_freq_steps=3), fileroot=str(tmp_path / "jax"), **common,
    )
    tcfg = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=ModelInterfaceAbstraction(_PARITY_REWARD),
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        ctrl=ExperimentSaveEvalControl(save_freq_steps=3), fileroot=str(tmp_path / "port"),
        **common,
    )
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    _, jstats = jexps.run_experiment(jexps.build_ppo_math(jcfg),
                                     tokenizer=fixtures.make_tokenizer())
    tmaster, tstats = exps.run_experiment(exps.build_ppo_math(tcfg), tokenizer=CharTokenizer(512),
                                          device="cpu")
    seen = {k: list(v) for k, v in _SEEN.items()}
    return ckpt, jstats, tstats, seen, tmaster


@pytest.fixture(scope="module")
def ahead_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ahead")
    return tmp, _ahead_both(tmp)


def test_rollout_ahead_tokens_match_jax(ahead_runs):
    _, (_, _, _, seen, master) = ahead_runs
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for (tids, ttoks), (jids, jtoks) in zip(seen["port"], seen["jax"]):
        assert tids == jids
        np.testing.assert_array_equal(ttoks, jtoks)
    # Each batch was generated under one version: the generator took
    # exactly the syncs of steps 1 and 2 (none of step 3, which no
    # prefetch followed) and ran three generate calls.
    assert master.pool.workers[0].models["actor_gen@0"].version == 3
    assert master._ahead_task is None


def test_rollout_ahead_stats_match_jax(ahead_runs):
    _, (_, jstats, tstats, _, _) = ahead_runs
    assert len(tstats) == len(jstats) == 3
    for step, (got, want) in enumerate(zip(tstats, jstats)):
        keys = [k for k in got if k.startswith("actor_train/")
                and "/perf/" not in k and "/time/" not in k]
        assert len(keys) > 10
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")
    # Steps 2 and 3 train on rollouts one version stale: their ratio
    # moves off 1, as in the JAX trial.
    assert abs(tstats[0]["actor_train/importance_weight"] - 1.0) < 1e-4


def test_rollout_ahead_weights_match_jax(ahead_runs):
    tmp, (ckpt, _, _, _, _) = ahead_runs
    path = [os.path.join(tmp, pkg, "checkpoints", "ppo-math", "trial", "actor@0", "step_3")
            for pkg in ("port", "jax")]
    _, got = hf.load_hf_checkpoint(path[0], dtype=torch.float32, device="cpu")
    _, want = hf.load_hf_checkpoint(path[1], dtype=torch.float32, device="cpu")
    _, init = hf.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu")
    flat_got, flat_want, flat_init = dict(_flat(got)), dict(_flat(want)), dict(_flat(init))
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_allclose(flat_got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert max(float((flat_got[k] - v).abs().max()) for k, v in flat_init.items()) > 1e-5


# ---------------- the replay pipeline ----------------

STAT_KEYS = ("actor_train/loss", "actor_train/actor_loss", "actor_train/approx_kl",
             "actor_train/importance_weight", "actor_train/grad_norm",
             "actor_train/task_reward")


def test_cap_zero_is_the_synchronous_trial_bit_for_bit(tmp_path):
    """Twin of tests/test_rollout.py:588: equal per-step stats and equal
    final weights, bit for bit (one CPU thread: the multi-threaded CPU
    kernels reduce in a varying order)."""
    rows = fixtures.build_math_rows(8, seed=3)
    m_sync, s_sync = _run(_cfg(tmp_path / "sync", rows), threads=1)
    m_async, s_async = _run(_cfg(tmp_path / "async", rows, max_head_offpolicyness=0),
                            threads=1)
    assert len(s_sync) == len(s_async) == 2
    for a, b in zip(s_sync, s_async):
        keys = [k for k in a if "/perf/" not in k and "/time" not in k and "time/" not in k]
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        assert b["replay/staleness"] == 0 and b["replay/rejected"] == 0
    pa = m_sync.pool.workers[0].models["actor@0"].engine.get_params()
    pb = m_async.pool.workers[0].models["actor@0"].engine.get_params()
    for (ka, x), (kb, y) in zip(_flat(pa), _flat(pb)):
        assert ka == kb and torch.equal(x, y), ka


def test_cap_one_bounded_staleness_and_decoupled_stats(tmp_path):
    """Twin of tests/test_rollout.py:553: every consumed batch within the
    bound, no admission rejections in steady state, the decoupled-PPO
    stats present, and staleness at the cap at the end."""
    rows = fixtures.build_math_rows(16, seed=7)
    master, stats = _run(_cfg(tmp_path, rows, max_head_offpolicyness=1, replay_capacity=4))
    assert len(stats) == 4
    for s in stats:
        assert np.isfinite(s["actor_train/actor_loss"])
        assert s["replay/staleness"] <= 1
        assert s["replay/rejected"] == 0 and s["replay/dropped_stale"] == 0
        assert np.isfinite(s["actor_train/behav_imp_weight"])
        assert 0.0 <= s["actor_train/behav_cap_clip"] <= 1.0
        assert "buffer/size" in s and "buffer/max_age" in s
    assert stats[-1]["replay/staleness"] == 1
    assert stats[-1]["replay/accepted"] == 4
    assert master._trainer_version == 4 and master.replay.version == 4
    # The cap's default reached the actor: decoupled PPO is on.
    assert master.pool.workers[0].interfaces["actor@0"].behav_imp_weight_cap == 5.0


@pytest.mark.parametrize("kw,match", [
    (dict(max_head_offpolicyness=1, rollout_ahead=1), "mutually exclusive"),
    (dict(rollout_ahead=2), "rollout_ahead must be 0 or 1"),
    (dict(max_head_offpolicyness=-1), "max_head_offpolicyness must be >= 0"),
    (dict(replay_capacity=0, max_head_offpolicyness=1), "replay_capacity must be >= 1"),
    (dict(pipeline_overlap=True, rollout_ahead=1), "mutually exclusive"),
    (dict(pipeline_overlap=True, max_head_offpolicyness=0), "mutually exclusive"),
    (dict(gen_server_url="http://127.0.0.1:1", kv_pool_pages=64), "ignored under gen_server_url"),
], ids=["ahead_and_cap", "ahead_2", "cap_negative", "capacity_0", "overlap_ahead",
        "overlap_cap", "remote_kv_knob"])
def test_mutual_exclusions_match_jax(tmp_path, kw, match):
    rows = fixtures.build_math_rows(8, seed=3)
    with pytest.raises(ValueError, match=match):
        exps.build_ppo_math(_cfg(tmp_path, rows, **kw), CharTokenizer(512))
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("random", {"config": jtiny()}),
        dataset=JDatasetAbstraction("prompt", {"dataset_builder": lambda: rows}), **kw)
    with pytest.raises(ValueError):
        jexps.build_ppo_math(jcfg, fixtures.make_tokenizer())


@pytest.mark.parametrize("kw", [
    dict(max_head_offpolicyness=1, rollout_ahead=1),
    dict(rollout_ahead=2),
    dict(max_head_offpolicyness=-1),
    dict(pipeline_overlap=True, rollout_ahead=1),
], ids=["ahead_and_cap", "ahead_2", "cap_negative", "overlap_ahead"])
def test_master_refuses_what_the_jax_master_refuses(tmp_path, kw):
    plan = exps.build_ppo_math(_cfg(tmp_path, fixtures.build_math_rows(8)))
    with pytest.raises(ValueError):
        MasterWorker(plan.dfg, InProcessPool([object()]), plan.model_placement, [0],
                     plan.ctrl, fileroot=str(tmp_path), **kw)


# ---------------- anomaly_imp_ratio_max ----------------

@pytest.mark.parametrize("behav", [None, 0.2, 0.49, 0.5, 1.0, 1.7, 2.0, 2.01, 9.0])
@pytest.mark.parametrize("cap", [None, 2.0])
def test_imp_ratio_verdict_matches_jax(behav, cap):
    g = GenerationHyperparameters(n=2, max_new_tokens=4)
    kw = dict(n_minibatches=1, disable_value=True, kl_ctl=0.0, anomaly_imp_ratio_max=cap)
    t = PPOActorInterface(gconfig=g, **kw)
    j = JPPOActorInterface(gconfig=JGenerationHyperparameters(n=2, max_new_tokens=4), **kw)
    aux = dict(kl_abs_mean=None, behav_imp_mean=behav, degenerate_var=False)
    assert t._batch_verdict(aux) == j._batch_verdict(aux)
    assert bool(t._batch_verdict(aux) & integrity.IMP_RATIO) == (
        cap is not None and behav is not None and not 0.5 <= behav <= 2.0)


def test_imp_ratio_sentinel_quarantines_a_stale_batch(tmp_path):
    """A cap 1 trial whose sentinel bound is so tight that a batch
    generated before the last update trips it: step 2 (the batch of
    version 0, trained after step 1's update) is quarantined, with no
    optimizer step, and the trial goes on.  Step 3's batch was generated
    after step 1's update, and step 2 changed no weight: its behaviour
    weight is 1 and it is clean, as is the on-policy step 1."""
    rows = fixtures.build_math_rows(12, seed=7)
    cfg = _cfg(tmp_path, rows, max_head_offpolicyness=1,
               ppo_kwargs={"n_minibatches": 1, "kl_ctl": 0.0,
                           "anomaly_imp_ratio_max": 1.0 + 1e-9},
               max_consecutive_quarantines=0)
    master, stats = _run(cfg)
    assert len(stats) == 3
    assert [s["replay/staleness"] for s in stats] == [0.0, 1.0, 1.0]
    assert [s["actor_train/quarantined"] for s in stats] == [0.0, 1.0, 0.0]
    assert int(stats[1]["actor_train/anomaly_verdict"]) == integrity.IMP_RATIO
    assert stats[2]["actor_train/behav_imp_weight"] == 1.0


# ---------------- recover under cap 1 ----------------

def test_recover_round_trip_under_cap_one(tmp_path):
    """Stop a cap 1 trial after step 2 with a recover checkpoint each
    step, rerun it: the rerun restores the replay watermarks and the
    trainer version, runs steps 3-4 within the bound, and its counters
    continue from the saved ones."""
    rows = fixtures.build_math_rows(16, seed=7)
    first = _cfg(tmp_path, rows, max_head_offpolicyness=1,
                 ctrl=ExperimentSaveEvalControl(ckpt_freq_steps=1, benchmark_steps=2))
    m1, s1 = _run(first)
    assert len(s1) == 2 and m1._trainer_version == 2
    from areal_tpu_torch.base import recover

    info = recover.load(recover.recover_root(str(tmp_path), "ppo-math", "trial"))
    assert info.rollout_state == {"trainer_version": 2, "batch_seq": m1._batch_seq}
    assert info.replay_watermarks["version"] == 2 and info.replay_watermarks["consumed"] == 2
    second = _cfg(tmp_path, rows, max_head_offpolicyness=1,
                  ctrl=ExperimentSaveEvalControl(ckpt_freq_steps=1))
    m2, s2 = _run(second)
    assert len(s2) == 2 and m2.step_info.global_step == 4
    assert m2._trainer_version == 4 and m2.replay.version == 4
    assert m2.replay.consumed == 4 and s2[-1]["replay/accepted"] == 4
    assert all(s["replay/staleness"] <= 1 and s["replay/rejected"] == 0 for s in s2)


# ---------------- a static burst binds its weights once ----------------

def test_static_burst_binds_its_weights_once(monkeypatch):
    """A weight swap from another thread between decode steps of a
    static burst: the burst's tokens are those of the burst under the
    old weights (the JAX program takes the weights once a burst), and
    differ from the new weights' burst, so the swap would show."""
    cfg = ttiny()
    old = tfm.init_params(cfg, 3, device="cpu")
    new = tfm.init_params(cfg, 4, device="cpu")
    rng = np.random.default_rng(0)
    lens = [5, 7, 6]
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(3)],
        seqlens={"packed_prompts": [[n] for n in lens]},
        data={"packed_prompts": rng.integers(3, cfg.vocab_size, sum(lens)).astype(np.int32)},
    )
    g = GenerationHyperparameters(n=2, max_new_tokens=12, greedy=True)

    def burst(params, swap_to=None):
        eng = GeneratorEngine(cfg, params, "cpu", eos_token_id=cfg.vocab_size + 1)
        if swap_to is not None:
            real = tfm.decode_step
            calls = []

            def decode_step(*a, **k):
                calls.append(1)
                if len(calls) == 3:
                    t = threading.Thread(target=eng.set_params, args=(swap_to,))
                    t.start()
                    t.join(timeout=60)
                    assert not t.is_alive()
                return real(*a, **k)

            monkeypatch.setattr(tfm, "decode_step", decode_step)
        out = eng.generate(sample, MicroBatchSpec(), g, seed=0, inflight=False)
        monkeypatch.undo()
        assert eng.static_chunks == 1 and eng.static_decode_steps == 11
        return np.asarray(out.data["packed_input_ids"]), eng

    want, _ = burst(old)
    swapped, eng = burst(old, swap_to=new)
    other, _ = burst(new)
    np.testing.assert_array_equal(swapped, want)
    assert not np.array_equal(want, other)
    # The swap landed: the next burst runs on the new weights.
    nxt = eng.generate(sample, MicroBatchSpec(), g, seed=0, inflight=False)
    np.testing.assert_array_equal(np.asarray(nxt.data["packed_input_ids"]), other)
