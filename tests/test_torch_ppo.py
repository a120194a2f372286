"""The port's PPO step against the JAX package's, on the CPU in fp32:
the twins of tests/test_ppo.py:206 `test_ppo_full_step` (GRPO, and PPO
with a critic and a reference model: generate -> reward -> ref_inf ->
critic_inf -> actor and critic train_step, first-update ratio ~1); one
actor `train_step` and its advantages (GRPO, and GAE with the critic's
values) against the JAX step fed the same rollout and weights; the
critic's train sample, value norm and two train steps; `inference`,
the reward interface, math grading and the KL controllers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import Model as JModel
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.interfaces import kl as jkl
from areal_tpu.interfaces import math_sympy as jms
from areal_tpu.interfaces import math_verify as jmv
from areal_tpu.interfaces.ppo import PPOActorInterface as JPPOActorInterface
from areal_tpu.interfaces.ppo import PPOCriticInterface as JPPOCriticInterface
from areal_tpu.interfaces.reward import MultiTaskRewardInterface as JReward
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    GenerationHyperparameters,
    Model,
    OptimizerConfig,
)
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces import kl as tkl
from areal_tpu_torch.interfaces import math_sympy as tms
from areal_tpu_torch.interfaces import math_verify as tmv
from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy
from tests import fixtures

torch.set_num_threads(2)

OPT = dict(lr=1e-4, warmup_steps_proportion=0.0)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(5)))


def _prompt_batch(tok, n_prompts=2):
    """tests/test_ppo.py's prompt batch: math rows from the fixtures."""
    ids, toks, seqlens, id2info = [], [], [], {}
    for r in fixtures.build_math_rows(n_prompts, seed=3):
        ids.append(r["query_id"])
        id2info[r["query_id"]] = r
        t = tok.encode(r["prompt"])
        toks.append(np.asarray(t, np.int32))
        seqlens.append([len(t)])
    return SequenceSample(
        keys={"packed_prompts"}, ids=ids, seqlens={"packed_prompts": seqlens},
        data={"packed_prompts": np.concatenate(toks)},
    ), id2info


def _port_models(weights):
    tok = CharTokenizer(vocab_size=512)
    params = params_from_numpy(weights, device="cpu")
    actor = Model("actor", TrainEngine(
        ttiny(), params, "cpu", optimizer_config=OptimizerConfig(**OPT),
        ftspec=FinetuneSpec(1, 8, 8),
    ), tok, ttiny())
    gen = Model("actor_gen", GeneratorEngine(
        ttiny(), params, "cpu", eos_token_id=tok.eos_token_id,
    ), tok, ttiny())
    return actor, gen, tok


def _jax_actor(weights, tok):
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    return JModel("actor", JTrainEngine(
        jtiny(), jax.tree.map(jnp.array, weights), mesh,
        optimizer_config=JOptimizerConfig(**OPT), ftspec=JFinetuneSpec(1, 8, 8),
    ), tok, jtiny())


def _to_jax(sample: SequenceSample) -> JSequenceSample:
    return JSequenceSample(
        keys=set(sample.keys), ids=list(sample.ids),
        seqlens={k: [list(s) for s in v] for k, v in sample.seqlens.items()},
        data={k: np.array(v) for k, v in sample.data.items()},
    )


@pytest.fixture(scope="module")
def critic_weights():
    return jax.tree.map(
        np.asarray, jtfm.init_params(jtiny(is_critic=True), jax.random.PRNGKey(6))
    )


def _port_critic(cw, tok=None):
    return Model("critic", TrainEngine(
        ttiny(is_critic=True), params_from_numpy(cw, device="cpu"), "cpu",
        optimizer_config=OptimizerConfig(**OPT), ftspec=FinetuneSpec(1, 8, 8),
    ), tok, ttiny(is_critic=True))


def _jax_critic(cw, tok=None):
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    return JModel("critic", JTrainEngine(
        jtiny(is_critic=True), jax.tree.map(jnp.array, cw), mesh,
        optimizer_config=JOptimizerConfig(**OPT), ftspec=JFinetuneSpec(1, 8, 8),
    ), tok, jtiny(is_critic=True))


def _copy(sample: SequenceSample) -> SequenceSample:
    return SequenceSample(
        keys=set(sample.keys), ids=list(sample.ids),
        seqlens={k: [list(s) for s in v] for k, v in sample.seqlens.items()},
        data={k: np.array(v) for k, v in sample.data.items()},
    )


def _add_token_key(sample: SequenceSample, key: str, values: np.ndarray) -> None:
    """A key aligned with packed_input_ids (one entry per token)."""
    sample.update_(SequenceSample(
        keys={key}, ids=list(sample.ids),
        seqlens={key: [list(s) for s in sample.seqlens["packed_input_ids"]]},
        data={key: values.astype(np.float32)},
    ))


def _value_sample(rollout, seed=10, dense=False):
    """The rollout with seeded critic values (and dense per-token
    scores), and seq_no_eos_mask alternating 1, 0 so that GAE both
    bootstraps from the last token's value and does not."""
    sample = _copy(rollout)
    rng = np.random.default_rng(seed)
    total = sample.total_len("packed_input_ids")
    _add_token_key(sample, "values", 2.0 * rng.standard_normal(total))
    if dense:
        _add_token_key(sample, "dense_rewards", 3.0 * rng.standard_normal(total))
    n = len(sample.data["seq_no_eos_mask"])
    sample.data["seq_no_eos_mask"] = (np.arange(n) % 2 == 0).astype(
        sample.data["seq_no_eos_mask"].dtype
    )
    return sample


@pytest.fixture(scope="module")
def rollout(weights):
    """One generated GRPO batch (2 prompts x n=4, 16 new tokens) with
    graded rewards, then seeded +-5 scores so advantages are non-zero."""
    actor, gen, tok = _port_models(weights)
    prompts, id2info = _prompt_batch(tok)
    mb = MicroBatchSpec()
    ai = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=4, max_new_tokens=16, temperature=1.0),
        n_minibatches=1, disable_value=True,
    )
    out = ai.generate(gen, prompts, mb)
    out.update_(MultiTaskRewardInterface(id2info=id2info).inference(actor, out, mb))
    rng = np.random.default_rng(9)
    out.data["rewards"] = rng.choice([-5.0, 5.0], out.data["rewards"].shape).astype(np.float32)
    return out


def test_ppo_full_step_grpo(weights):
    """Twin of tests/test_ppo.py:206 with disable_value=True: generate ->
    math reward -> train_step; the first update's importance ratio is ~1
    (|w - 1| < 1e-2) and its approx-KL ~0 (< 1e-3)."""
    actor, gen, tok = _port_models(weights)
    prompts, id2info = _prompt_batch(tok)
    g = GenerationHyperparameters(n=4, max_new_tokens=16, temperature=1.0)
    actor_if = PPOActorInterface(gconfig=g, n_minibatches=1, disable_value=True,
                                 adv_norm=True, kl_ctl=0.0)
    rw_if = MultiTaskRewardInterface(id2info=id2info)
    mb = MicroBatchSpec()
    rollout = actor_if.generate(gen, prompts, mb)
    assert rollout.bs == prompts.bs
    rollout.update_(rw_if.inference(actor, rollout, mb))
    stats = actor_if.train_step(actor, rollout, mb)
    assert np.isfinite(stats["actor_loss"])
    assert abs(stats["importance_weight"] - 1.0) < 1e-2, stats
    assert abs(stats["approx_kl"]) < 1e-3, stats
    assert stats["n_response_tokens"] > 0
    assert actor.version == 1


@pytest.mark.parametrize("variant", ["plain", "group_adv_norm", "kl_ref", "decoupled", "gae"])
def test_train_step_matches_jax(weights, rollout, variant):
    """The same rollout and weights through both packages' train_step:
    every stat within rtol 1e-4 (atol 1e-6), including loss,
    importance_weight, approx_kl and grad_norm; "gae" is value mode
    (GAE over the critic's values, γ 0.99, λ 0.95)."""
    kw = dict(gconfig=GenerationHyperparameters(n=4, max_new_tokens=16),
              n_minibatches=2, disable_value=True)
    if variant == "group_adv_norm":
        kw["group_adv_norm"] = True
    elif variant == "kl_ref":
        kw["kl_ctl"] = 0.1
    elif variant == "decoupled":
        kw["behav_imp_weight_cap"] = 5.0
    elif variant == "gae":
        kw.update(disable_value=False, discount=0.99, gae_lambda=0.95)
    sample = _value_sample(rollout) if variant == "gae" else _copy(rollout)
    if variant == "kl_ref":
        lp = sample.data["packed_logprobs"]
        sample.update_(SequenceSample(
            keys={"packed_ref_logprobs"}, ids=list(sample.ids),
            seqlens={"packed_ref_logprobs": sample.seqlens["packed_logprobs"]},
            data={"packed_ref_logprobs": (lp - 0.2).astype(np.float32)},
        ))
    actor, _, tok = _port_models(weights)
    got = PPOActorInterface(**kw).train_step(actor, sample, MicroBatchSpec())
    jactor = _jax_actor(weights, tok)
    want = JPPOActorInterface(**kw).train_step(jactor, _to_jax(sample), JMicroBatchSpec())
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert {"loss", "importance_weight", "approx_kl", "grad_norm"} <= set(got)


@pytest.mark.parametrize("generation_size", [None, 4])
def test_prepare_train_sample_matches_jax(weights, rollout, generation_size):
    """GRPO advantages, loss mask and old logprobs: atol 1e-6; best-of-k
    (train on the top 2 of 4) keeps the same sequences."""
    kw = dict(gconfig=GenerationHyperparameters(n=2 if generation_size else 4),
              generation_size=generation_size, disable_value=True)
    actor, _, tok = _port_models(weights)
    ts, keys, _ = PPOActorInterface(**kw)._prepare_train_sample(actor, rollout, MicroBatchSpec())
    js, jkeys, _ = JPPOActorInterface(**kw)._prepare_train_sample(
        None, _to_jax(rollout), JMicroBatchSpec()
    )
    assert keys == jkeys and ts.seqlens == js.seqlens
    for k in keys + ("packed_input_ids", "prompt_mask"):
        np.testing.assert_allclose(ts.data[k], np.asarray(js.data[k]), atol=1e-6, err_msg=k)


def test_inference_matches_jax(weights, rollout):
    """Recomputed logprobs (TrainEngine.forward): atol 1e-5, and equal to
    the generator's behaviour logprobs on the response (atol 1e-4)."""
    actor, _, tok = _port_models(weights)
    ai = PPOActorInterface(disable_value=True)
    got = ai.inference(actor, rollout, MicroBatchSpec())
    want = JPPOActorInterface(disable_value=True).inference(
        _jax_actor(weights, tok), _to_jax(rollout), JMicroBatchSpec()
    )
    assert got.seqlens["logprobs"] == rollout.seqlens["packed_input_ids"]
    np.testing.assert_allclose(got.data["logprobs"], np.asarray(want.data["logprobs"]),
                               atol=1e-5, rtol=0)
    _, _, aux = ai._prepare_train_sample(actor, rollout, MicroBatchSpec())
    m = aux["loss_mask"] > 0
    np.testing.assert_allclose(got.data["logprobs"][m], aux["old_logp"][m], atol=1e-4)


def test_unported_branches_raise(weights, critic_weights, tmp_path):
    """The branches once refused here run: the critic's streamed train
    step, the imp-ratio sentinel, remote grading, code grading and the
    verifier fleet (tests/test_torch_stream.py,
    tests/test_torch_async_rl.py, tests/test_torch_reward_service.py and
    tests/test_torch_verifier_pool.py hold them against the JAX
    package)."""
    critic = _port_critic(critic_weights)
    state = PPOCriticInterface().train_stream_begin(critic, MicroBatchSpec())
    assert state["engine"]["n_chunks"] == 0
    assert PPOActorInterface(anomaly_imp_ratio_max=2.0).anomaly_imp_ratio_max == 2.0
    assert MultiTaskRewardInterface(remote_url="http://localhost:1").remote_url
    assert MultiTaskRewardInterface().verify("code", "print(1)", {}) is False  # no fence
    pooled = MultiTaskRewardInterface(verifier_pool=True, pool_experiment="e", pool_trial="t")
    assert pooled.verifier_pool and pooled._pool is None  # the client is built at first use


VALUE_VARIANTS = {
    "plain": {},
    "gamma_lambda": dict(discount=0.99, gae_lambda=0.95, adv_norm=False),
    "group_adv_norm": dict(group_adv_norm=True),
    "kl_ref": dict(kl_ctl=0.1),
    "dense_delta": dict(use_dense_reward=True, reward_delta=True),
    "dense_no_delta": dict(use_dense_reward=True, reward_delta=False,
                           mask_no_eos_with_zero=True, discount=0.9, gae_lambda=0.5),
}


@pytest.mark.parametrize("variant", sorted(VALUE_VARIANTS))
def test_prepare_train_sample_value_mode_matches_jax(weights, rollout, variant):
    """Value mode (a critic's values, GAE over each response window with
    the seq_no_eos_mask bootstrap): KL-shaped terminal or dense rewards,
    advantage normalization over the batch or per group; advantages,
    loss mask and old logprobs against JAX, atol 1e-5."""
    kw = dict(gconfig=GenerationHyperparameters(n=4), disable_value=False,
              **VALUE_VARIANTS[variant])
    sample = _value_sample(rollout, dense=variant.startswith("dense"))
    if variant == "kl_ref":
        lp = sample.data["packed_logprobs"]
        sample.update_(SequenceSample(
            keys={"packed_ref_logprobs"}, ids=list(sample.ids),
            seqlens={"packed_ref_logprobs": sample.seqlens["packed_logprobs"]},
            data={"packed_ref_logprobs": (lp - 0.3).astype(np.float32)},
        ))
    actor, _, _ = _port_models(weights)
    ts, keys, aux = PPOActorInterface(**kw)._prepare_train_sample(actor, sample, MicroBatchSpec())
    js, jkeys, _ = JPPOActorInterface(**kw)._prepare_train_sample(
        None, _to_jax(sample), JMicroBatchSpec()
    )
    assert keys == jkeys and ts.seqlens == js.seqlens
    for k in keys + ("packed_input_ids", "prompt_mask"):
        np.testing.assert_allclose(ts.data[k], np.asarray(js.data[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    adv = ts.data["advantages"][aux["loss_mask"] > 0]
    assert np.abs(adv).max() > 0.1


def test_value_mode_bootstrap_reads_the_last_token(weights, rollout):
    """Unnormalized GAE advantages at γ = λ = 1 with zero rewards: at a
    response window's last position t = L-2, adv = no_eos * V[L-1] -
    V[L-2], so changing V at the LAST token moves exactly the truncated
    sequences' advantages."""
    kw = dict(gconfig=GenerationHyperparameters(n=4), disable_value=False, adv_norm=False)
    sample = _value_sample(rollout)
    sample.data["rewards"] = np.zeros_like(sample.data["rewards"])
    actor, _, _ = _port_models(weights)
    ai = PPOActorInterface(**kw)
    base, _, aux = ai._prepare_train_sample(actor, sample, MicroBatchSpec())
    bounds = sample.cu_seqlens("packed_input_ids")
    no_eos = sample.data["seq_no_eos_mask"]
    assert 0 < no_eos.sum() < len(no_eos)
    for i in range(len(no_eos)):
        last = int(bounds[i + 1]) - 1
        moved = _copy(sample)
        moved.data["values"][last] += 1.0
        got, _, _ = ai._prepare_train_sample(actor, moved, MicroBatchSpec())
        delta = got.data["advantages"] - base.data["advantages"]
        np.testing.assert_allclose(delta[last - 1], float(no_eos[i]), atol=1e-5)
        others = np.ones_like(delta, bool)
        others[bounds[i] : bounds[i + 1]] = False
        assert (delta[others] == 0).all()


@pytest.mark.parametrize("value_norm", [False, True])
def test_critic_prepare_train_sample_matches_jax(weights, critic_weights, rollout, value_norm):
    """The critic's train sample (KL-shaped terminal rewards -> GAE
    returns; under value_norm the moments updated, then the returns and
    old values normalized): old_values, returns and loss_mask against
    JAX (atol 1e-5), and the running moments (rtol 1e-6: the fp32
    returns come from two different scan orders)."""
    kw = dict(value_norm=value_norm, discount=0.99, gae_lambda=0.95, kl_ctl=0.05)
    sample = _value_sample(rollout)
    lp = sample.data["packed_logprobs"]
    sample.update_(SequenceSample(
        keys={"packed_ref_logprobs"}, ids=list(sample.ids),
        seqlens={"packed_ref_logprobs": sample.seqlens["packed_logprobs"]},
        data={"packed_ref_logprobs": (lp + 0.2).astype(np.float32)},
    ))
    tci, jci = PPOCriticInterface(**kw), JPPOCriticInterface(**kw)
    ts = tci._prepare_train_sample(_port_critic(critic_weights), sample, MicroBatchSpec())
    js = jci._prepare_train_sample(None, _to_jax(sample), JMicroBatchSpec())
    assert ts.seqlens == js.seqlens
    for k in ("old_values", "returns", "loss_mask", "packed_input_ids"):
        np.testing.assert_allclose(ts.data[k], np.asarray(js.data[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert tci.state_dict().keys() == jci.state_dict().keys()
    for k, v in jci.state_dict().items():
        np.testing.assert_allclose(tci.state_dict()[k], v, rtol=1e-6, err_msg=k)
    if value_norm:
        m = ts.data["loss_mask"] > 0
        assert abs(float(ts.data["returns"][m].mean())) < 1.0


@pytest.mark.parametrize("value_norm", [False, True])
def test_critic_two_steps_match_jax(weights, critic_weights, rollout, value_norm):
    """Two critic steps (inference -> train_step, twice) through both
    packages on the same weights and rollout: the values (denormalized
    under value_norm) atol 1e-5, every train stat rtol 1e-4 (atol 1e-6),
    and the value-norm moments after each step rtol 1e-6."""
    kw = dict(n_minibatches=2, value_norm=value_norm, value_norm_beta=0.9)
    sample = _value_sample(rollout)
    sample.keys.discard("values")
    del sample.data["values"], sample.seqlens["values"]
    tci, jci = PPOCriticInterface(**kw), JPPOCriticInterface(**kw)
    tc, jc = _port_critic(critic_weights), _jax_critic(critic_weights)
    ts, js = _copy(sample), _to_jax(sample)
    for step in range(2):
        tv = tci.inference(tc, ts, MicroBatchSpec())
        jv = jci.inference(jc, js, JMicroBatchSpec())
        np.testing.assert_allclose(tv.data["values"], np.asarray(jv.data["values"]),
                                   atol=1e-5, rtol=1e-5)
        ts.update_(tv)
        js.update_(jv)
        got = tci.train_step(tc, ts, MicroBatchSpec())
        want = jci.train_step(jc, js, JMicroBatchSpec())
        assert set(got) <= set(want) and {"value_loss", "grad_norm"} <= set(got)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1} {k}")
        for k, v in jci.state_dict().items():
            np.testing.assert_allclose(tci.state_dict()[k], v, rtol=1e-6, err_msg=k)
        assert np.isfinite(got["value_loss"]) and got["grad_norm"] > 0
    assert tc.version == 2
    if value_norm:
        sd = tci.state_dict()
        fresh = PPOCriticInterface(**kw)
        fresh.load_state_dict(sd)
        assert fresh.state_dict() == sd


def test_ppo_full_step_ppo(weights, critic_weights):
    """Twin of tests/test_ppo.py:206 with disable_value=False, and a
    reference model (an InferenceEngine on the actor's initial weights,
    offloaded after its call): generate -> reward -> ref_inf ->
    critic_inf -> actor train_step -> critic train_step, the graded
    rewards replaced by seeded +-5 (a random model solves nothing, and
    constant returns leave every normalized target in the value clip).
    Step 1's importance ratio ~1 (< 1e-2), approx-KL and ref-KL ~0
    (< 1e-3); the critic's value_loss finite and its grad_norm > 0."""
    actor, gen, tok = _port_models(weights)
    critic = _port_critic(critic_weights, tok)
    ref = Model("ref", InferenceEngine(ttiny(), actor.engine.get_params(), "cpu"), tok, ttiny())
    prompts, id2info = _prompt_batch(tok)
    g = GenerationHyperparameters(n=4, max_new_tokens=16, temperature=1.0)
    actor_if = PPOActorInterface(gconfig=g, n_minibatches=1, disable_value=False,
                                 adv_norm=True, kl_ctl=0.1)
    critic_if = PPOCriticInterface(n_minibatches=1, value_norm=True, kl_ctl=0.1)
    mb = MicroBatchSpec()
    rollout = actor_if.generate(gen, prompts, mb)
    assert rollout.bs == prompts.bs
    rollout.update_(MultiTaskRewardInterface(id2info=id2info).inference(actor, rollout, mb))
    rng = np.random.default_rng(9)
    rollout.data["rewards"] = rng.choice([-5.0, 5.0], rollout.data["rewards"].shape).astype(
        np.float32)
    ref_out = actor_if.inference(ref, rollout, mb)
    ref_out.remap_keys_({"logprobs": "packed_ref_logprobs"})
    rollout.update_(ref_out)
    ref.engine.offload()
    rollout.update_(critic_if.inference(critic, rollout, mb))
    assert rollout.data["values"].shape == rollout.data["packed_input_ids"].shape
    stats = actor_if.train_step(actor, rollout, mb)
    assert np.isfinite(stats["actor_loss"])
    assert abs(stats["importance_weight"] - 1.0) < 1e-2, stats
    assert abs(stats["approx_kl"]) < 1e-3, stats
    assert abs(stats["ref_kl"]) < 1e-3, stats
    assert stats["n_response_tokens"] > 0 and actor.version == 1
    cstats = critic_if.train_step(critic, rollout, mb)
    assert np.isfinite(cstats["value_loss"]) and cstats["grad_norm"] > 0
    assert critic.version == 1
    # The ref, reloaded after the actor's update, still gives its step-1
    # logprobs.
    again = actor_if.inference(ref, rollout, mb)
    np.testing.assert_array_equal(again.data["logprobs"],
                                  rollout.data["packed_ref_logprobs"])


def _reward_sample(tok):
    """tests/test_ppo.py's fake generated batch: 2 prompts x 2 responses."""
    rows = [
        ("q0", "Compute 3 + 4. ", [r"\boxed{7}"], ["so \\boxed{7}", "it is 9"]),
        ("q1", "Compute 2 + 2. ", [r"\boxed{4}"], ["\\boxed{4}", "\\boxed{4}!"]),
    ]
    ids, seqs, masks, seqlens, id2info = [], [], [], [], {}
    for qid, prompt, sols, resps in rows:
        ids.append(qid)
        id2info[qid] = {"task": "math", "solutions": sols}
        lens = []
        for r in resps:
            p, c = tok.encode(prompt), tok.encode(r)
            seqs.append(np.asarray(p + c, np.int32))
            masks.append(np.arange(len(p) + len(c)) < len(p))
            lens.append(len(p) + len(c))
        seqlens.append(lens)
    kw = dict(
        keys={"packed_input_ids", "prompt_mask"}, ids=ids,
        seqlens={"packed_input_ids": seqlens, "prompt_mask": [list(x) for x in seqlens]},
    )
    data = {"packed_input_ids": np.concatenate(seqs), "prompt_mask": np.concatenate(masks)}
    return (
        SequenceSample(data=dict(data), **kw), JSequenceSample(data=dict(data), **kw),
        id2info,
    )


def test_math_rewards_match_jax():
    """Twin of tests/test_ppo.py TestRewardInterface: [5, -5, 5, 5]."""
    tok = CharTokenizer(vocab_size=512)
    ts, js, id2info = _reward_sample(tok)
    got = MultiTaskRewardInterface(id2info=id2info).inference(
        Model("reward", None, tok, None), ts, MicroBatchSpec()
    )
    want = JReward(id2info=id2info).inference(
        JModel("reward", engine=None, tokenizer=tok, config=None), js, JMicroBatchSpec()
    )
    np.testing.assert_array_equal(got.data["rewards"], [5.0, -5.0, 5.0, 5.0])
    np.testing.assert_array_equal(got.data["rewards"], np.asarray(want.data["rewards"]))
    assert got.seqlens["rewards"] == [[1, 1], [1, 1]]


class TestMathVerify:
    """Twins of tests/test_ppo.py TestMathVerify and tests/test_math_sympy.py,
    each also against the JAX package's grader at its default grading
    (sympy layer on)."""

    @pytest.mark.parametrize("text", [
        r"so \boxed{42}", r"\boxed{\frac{1}{2}}", r"\boxed{a{b}c} later", "no box",
    ])
    def test_boxed_extraction(self, text):
        assert tmv.extract_boxed(text) == jmv.extract_boxed(text)

    @pytest.mark.parametrize("pred,gold,ok", [
        ("42", "42", True), ("42.0", "42", True), (r"\frac{1}{2}", "0.5", True),
        ("1/2", r"\frac{1}{2}", True), ("  42 ", "42", True), ("43", "42", False),
        ("x+1", "x + 1", True), ("2,100", "2100", True),
    ])
    def test_answers_match(self, pred, gold, ok):
        assert tmv.answers_match(pred, gold) == ok == jmv.answers_match(pred, gold)

    @pytest.mark.parametrize("text,ok", [
        (r"... \boxed{7}", True), ("the answer is 7", True), (r"\boxed{8}", False),
        ("The answer is (B). I am sure.", False),
    ])
    def test_verify_math(self, text, ok):
        sol = [r"The sum is \boxed{7}."]
        assert tmv.verify_math(text, sol) == ok == jmv.verify_math(text, sol)

    @pytest.mark.parametrize("text,gold", [
        ("The answer is (B). I am sure.", "B"), ("(A) is wrong, the answer is C", "C"),
        ("the answers are A, C and D", "ACD"),
    ])
    def test_choice_golds(self, text, gold):
        assert tmv.verify_math(text, [gold]) == jmv.verify_math(text, [gold])
        assert tmv.verify_math(text, [gold])

    @pytest.mark.parametrize("pred,gold,ok", [
        (r"\frac{\sqrt{2}}{2}", r"\frac{1}{\sqrt{2}}", True),
        (r"2\sqrt{3}", r"\sqrt{12}", True),
        (r"x^2 - 1", r"(x-1)(x+1)", True),
        (r"x = 5", r"5", True),
        (r"(1,2] \cup [3,4)", r"(1,2] \cup [3,4)", True),
        (r"\{\frac{1}{2}, 2\}", r"\{2, 0.5\}", True),
        (r"\begin{pmatrix} 1 & \frac{1}{2} \\ 0 & 1 \end{pmatrix}",
         r"\begin{pmatrix} 1 & 0.5 \\ 0 & 1 \end{pmatrix}", True),
        ("-34x-45y+20z-100=0", "34x+45y-20z+100=0", True),
        (r"[0, 1)", r"[0, 1]", False),
        (r"\frac{22}{7}", r"\pi", False),
        (r"x = 5", r"4", False),
    ])
    def test_sympy_pairs_match_jax(self, pred, gold, ok):
        """The sympy comparator in-process, port against JAX."""
        assert tms.sympy_match_worker(pred, gold) == ok == jms.sympy_match_worker(pred, gold)
        assert tms.latex_to_expr(pred) == jms.latex_to_expr(pred)

    @pytest.mark.parametrize("text,gold", [
        (r"the answer is \boxed{\frac{\sqrt{2}}{2}}", r"\boxed{\frac{1}{\sqrt{2}}}"),
        (r"so \boxed{(0.6,2.6667]}", r"\boxed{(\frac{3}{5},\frac{8}{3}]}"),
        (r"the answer is \boxed{\sqrt{2}}", r"\boxed{2}"),
    ])
    def test_default_grading_matches_jax(self, text, gold):
        """`verify_math` at its default (the sympy stage through the
        worker process), port against JAX: answers the string/Fraction
        path cannot decide."""
        want = jmv.verify_math(text, [gold])
        assert tmv.verify_math(text, [gold]) == want
        assert tmv.verify_math(text, [gold], use_sympy=False) is False


@pytest.mark.parametrize("observed", [5.0, 0.0, 1.05, 1.0])
def test_kl_controllers_match_jax(observed):
    """Twin of tests/test_ppo.py TestKLController: the adaptive rule and
    the fixed controller, and the state round trip."""
    t = tkl.AdaptiveKLController(value=0.1, target=1.0, horizon=100.0)
    j = jkl.AdaptiveKLController(value=0.1, target=1.0, horizon=100.0)
    t.update(observed, n_steps=10)
    j.update(observed, n_steps=10)
    assert t.value == j.value
    f = tkl.make_kl_controller(0.3, False, 1.0, 100.0)
    f.update(observed, n_steps=10)
    assert f.value == 0.3
    t2 = tkl.AdaptiveKLController(value=0.7, target=1.0, horizon=100.0)
    t2.load_state_dict(t.state_dict())
    assert t2.value == t.value
