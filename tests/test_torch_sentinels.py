"""The tunable sentinels in the port against the JAX package's, on the
CPU in fp32 (twins of tests/test_anomaly.py's `TestEngineSentinels` and
`TestPPOSentinels`): the same weights and batches through both
packages' engines and interfaces give the same verdicts, and every
quarantined step leaves the parameters and Adam's moments bit for bit.

The engine's cases: the constructor's refusal of a multiplier in
(0, 1], a clean step, the grad-norm spike after the EWMA's warm-up
(the gradient sum scaled by 100 through each package's seam), the EWMA
and its clean-step count moving only on clean steps, the update-norm
ceiling, the stream's external trip, and the guard state kept out of
the optimizer checkpoint.  The interface's: the batch verdict's bits,
degenerate variance and KL blowup quarantined before any gradient
work, and a KL blowup mid-stream discarding the streamed sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base import integrity as jintegrity
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.interfaces.ppo import PPOActorInterface as JPPOActorInterface
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.ops import functional as jF
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import FinetuneSpec, GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.base import integrity
from areal_tpu_torch.engines.train import TrainEngine, _leaves
from areal_tpu_torch.interfaces.ppo import PPOActorInterface
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.ops import functional as tF
from tests.test_torch_ppo import _copy, _jax_actor, _port_models, _to_jax, rollout  # noqa: F401
from tests.test_torch_train import _samples

torch.set_num_threads(2)

SFT = dict(token_key="packed_input_ids", extra_keys=("prompt_mask",))


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(0)))


def _engines(weights, lr=1e-2, **kw):
    oc = dict(lr=lr, warmup_steps_proportion=0.0)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(), jax.tree.map(jnp.array, weights), mesh,
                      optimizer_config=JOptimizerConfig(**oc), ftspec=JFinetuneSpec(1, 32, 32), **kw)
    te = TrainEngine(ttiny(), params_from_numpy(weights, device="cpu"), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 32, 32), **kw)
    return je, te


def _sft_samples(seed=0, n=6):
    """tests/test_anomaly.py's SFT batch: random tokens, the first two of
    each sequence a prompt."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(4, 21, n)]
    arrays = dict(
        packed_input_ids=rng.integers(0, ttiny().vocab_size, sum(lens)).astype(np.int32),
        prompt_mask=np.concatenate([np.arange(l) < 2 for l in lens]),
    )
    return _samples(arrays, lens)


def _train(je, te, ts, js):
    want = je.train_batch(js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count, **SFT)
    got = te.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    return got, want


def _state(te):
    return [{k: v.clone() for k, v in _leaves(t)} for t in (te.params, te._mu, te._nu)]


def _assert_state_equal(te, snap):
    for s, tree in zip(snap, (te.params, te._mu, te._nu)):
        for k, v in _leaves(tree):
            assert torch.equal(v, s[k]), k


def _spike(je, te):
    """Scale each package's gradient sum by 100 before its guarded step:
    the JAX engine's poison seam, the port's gradients in p.grad."""
    je._poison_grads = lambda acc: jax.tree.map(lambda g: g * np.float32(100.0), acc)
    orig = te._guarded_step

    def spiked(*a, **k):
        for _, p in _leaves(te.params):
            p.grad.mul_(100.0)
        return orig(*a, **k)

    te._guarded_step = spiked


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("mult", [0.5, 1.0])
def test_constructor_rejects_mult_at_most_one(weights, package, mult):
    with pytest.raises(ValueError, match="anomaly_grad_norm_mult"):
        if package == "jax":
            mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
            JTrainEngine(jtiny(), jax.tree.map(jnp.array, weights), mesh,
                         anomaly_grad_norm_mult=mult)
        else:
            TrainEngine(ttiny(), params_from_numpy(weights, device="cpu"), "cpu",
                        anomaly_grad_norm_mult=mult)


def test_clean_step_applies(weights):
    """Both sentinels on, far from tripping: verdict 0, the update
    applied, one host transfer a call; the stats within the engine
    twins' tolerances."""
    je, te = _engines(weights, anomaly_grad_norm_mult=10.0, anomaly_update_norm_max=1e6)
    ts, js = _sft_samples()
    snap = _state(te)
    got, want = _train(je, te, ts, js)
    assert got["anomaly_verdict"] == want["anomaly_verdict"] == 0.0
    assert got["quarantined"] == 0.0 and te.host_transfers == 1
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert any(not torch.equal(v, snap[0][k]) for k, v in _leaves(te.params))


def test_grad_spike_after_warmup_and_ewma_on_clean_steps(weights):
    """Warm-up 2: two clean steps, then a spiked one (quarantined in both
    packages, GRAD_SPIKE, state bit for bit), then a clean one again:
    the spike did not move the EWMA.  The guard's (EWMA, clean count)
    equals the JAX engine's after every step."""
    je, te = _engines(weights, lr=1e-4, anomaly_grad_norm_mult=2.0, anomaly_ewma_warmup=2)
    ts, js = _sft_samples()

    def guards():
        np.testing.assert_allclose(te._guard_state.numpy(), np.asarray(je._guard_state),
                                   rtol=1e-5)

    for _ in range(2):
        got, want = _train(je, te, ts, js)
        assert got["quarantined"] == want["quarantined"] == 0.0
        guards()
    assert te._guard_state[1].item() == 2.0
    counts = {k: c.get() for (k,), c in integrity.M_ANOMALY.children()}
    orig_j, orig_t = je._poison_grads, te._guarded_step
    _spike(je, te)
    snap = _state(te)
    got, want = _train(je, te, ts, js)
    assert int(got["anomaly_verdict"]) == int(want["anomaly_verdict"]) == integrity.GRAD_SPIKE
    assert got["quarantined"] == want["quarantined"] == 1.0
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    _assert_state_equal(te, snap)
    assert integrity.M_ANOMALY.labels("grad_spike").get() == counts.get("grad_spike", 0) + 1
    assert te.opt_count == 2
    guards()
    assert te._guard_state[1].item() == 2.0
    je._poison_grads, te._guarded_step = orig_j, orig_t
    got, want = _train(je, te, ts, js)
    assert got["quarantined"] == want["quarantined"] == 0.0
    guards()
    assert te.opt_count == 3


def test_update_norm_ceiling(weights):
    """A ceiling of 1e-12 trips UPDATE_NORM in both packages; the port
    judges it before writing anything (p, mu, nu bit for bit), and its
    reported update norm equals the JAX engine's."""
    je, te = _engines(weights, anomaly_update_norm_max=1e-12)
    ts, js = _sft_samples()
    snap = _state(te)
    got, want = _train(je, te, ts, js)
    assert int(got["anomaly_verdict"]) == int(want["anomaly_verdict"]) == integrity.UPDATE_NORM
    assert got["quarantined"] == want["quarantined"] == 1.0
    np.testing.assert_allclose(got["update_norm"], want["update_norm"], rtol=1e-4)
    _assert_state_equal(te, snap)
    assert te.opt_count == 0 and te.host_transfers == 1


def test_stream_external_trip_discards_partial_grads(weights):
    je, te = _engines(weights)
    ts, js = _sft_samples()
    snap = _state(te)
    outs = []
    for eng, s, mb, loss, weight in ((je, js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count),
                                     (te, ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count)):
        state = eng.train_stream_begin()
        eng.train_stream_chunk(state, s, mb, loss, weight, **SFT)
        outs.append(eng.train_stream_end(state, quarantine=True))
    want, got = outs
    assert got["quarantined"] == want["quarantined"] == 1.0
    assert got["anomaly_verdict"] == want["anomaly_verdict"] == 0.0  # the interface's bit
    _assert_state_equal(te, snap)
    assert te.host_transfers == je.host_transfers == 2 and te.opt_count == 0
    assert all(p.grad is None for _, p in _leaves(te.params))


def test_guard_state_is_not_checkpointed(weights, tmp_path):
    """As in the JAX package, the guard's (EWMA, count) is in no
    checkpoint: the optimizer state file holds only Adam's moments and
    the count, and an engine restored from it starts a fresh guard (the
    spike sentinel waits out its warm-up again)."""
    from areal_tpu_torch.models.hf import safetensors_io

    _, te = _engines(weights, lr=1e-4, anomaly_grad_norm_mult=2.0, anomaly_ewma_warmup=1)
    ts, _ = _sft_samples()
    for _ in range(2):
        te.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    assert te._guard_state[1].item() == 2.0
    path = str(tmp_path / "opt.safetensors")
    te.save_optimizer_state(path)
    assert {k.split(".")[0] for k in safetensors_io.load_file(path)} == {"mu", "nu"}
    _, fresh = _engines(weights, lr=1e-4, anomaly_grad_norm_mult=2.0, anomaly_ewma_warmup=1)
    fresh.load_optimizer_state(path)
    assert fresh._guard_state is None and fresh.opt_count == 2
    fresh.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    assert fresh._guard_state[1].item() == 1.0


# ---------------- the PPO batch sentinels ----------------

GCONF = GenerationHyperparameters(n=4, max_new_tokens=16)


def _ifaces(**kw):
    kw = dict(gconfig=GCONF, n_minibatches=1, disable_value=True, kl_ctl=0.0, **kw)
    return PPOActorInterface(**kw), JPPOActorInterface(**kw)


@pytest.mark.parametrize("aux,on", [
    (dict(kl_abs_mean=0.01, degenerate_var=False), True),
    (dict(kl_abs_mean=0.5, degenerate_var=False), True),
    (dict(kl_abs_mean=0.01, degenerate_var=True), True),
    (dict(kl_abs_mean=0.5, degenerate_var=True), True),
    (dict(kl_abs_mean=None, degenerate_var=None), True),
    (dict(kl_abs_mean=9.0, degenerate_var=True), False),
], ids=["clean", "kl", "degenerate", "both", "none", "off"])
def test_batch_verdict_bits_match_jax(aux, on):
    kw = dict(anomaly_kl_max=0.1, anomaly_degenerate_variance=True) if on else {}
    t, j = _ifaces(**kw)
    assert t._batch_verdict(aux) == j._batch_verdict(dict(aux, behav_imp_mean=None))


def test_imp_ratio_sentinel_is_refused():
    """Refused until asynchronous RL came (ROADMAP queue 1 item 7.7): the
    sentinel now judges decoupled PPO's mean behaviour weight as the JAX
    interface does, and a batch without one (no proximal logprobs) is
    never judged by it."""
    t, j = _ifaces(anomaly_imp_ratio_max=2.0)
    for behav in (None, 0.4, 0.5, 1.3, 2.0, 2.5):
        aux = dict(kl_abs_mean=None, degenerate_var=None, behav_imp_mean=behav)
        assert t._batch_verdict(aux) == j._batch_verdict(aux)
    assert t._batch_verdict(dict(behav_imp_mean=0.4)) == integrity.IMP_RATIO
    assert t._batch_verdict(dict(behav_imp_mean=None)) == 0


def _with_ref(sample, offset):
    lp = sample.data["packed_logprobs"]
    sample.update_(SequenceSample(
        keys={"packed_ref_logprobs"}, ids=list(sample.ids),
        seqlens={"packed_ref_logprobs": [list(s) for s in sample.seqlens["packed_logprobs"]]},
        data={"packed_ref_logprobs": (lp + offset).astype(np.float32)},
    ))
    return sample


@pytest.mark.parametrize("case", ["degenerate_variance", "kl_blowup"])
def test_batch_sentinel_quarantines_before_dispatch(weights, rollout, case):  # noqa: F811
    """Constant scores (every GRPO group degenerate), or reference
    logprobs 0.5 below the behaviour's (|KL| mean 0.5 > 0.1): both
    packages quarantine the step with the same stats, before any
    gradient work (no host transfer, the weights bit for bit)."""
    sample = _copy(rollout)
    if case == "degenerate_variance":
        sample.data["rewards"] = np.zeros_like(sample.data["rewards"])
        kw = dict(anomaly_degenerate_variance=True)
    else:
        sample = _with_ref(sample, -0.5)
        kw = dict(anomaly_kl_max=0.1)
    t_if, j_if = _ifaces(**kw)
    actor, _, tok = _port_models(weights)
    snap = _state(actor.engine)
    got = t_if.train_step(actor, sample, MicroBatchSpec())
    want = j_if.train_step(_jax_actor(weights, tok), _to_jax(sample), JMicroBatchSpec())
    bit = integrity.DEGENERATE_VAR if case == "degenerate_variance" else integrity.KL_BLOWUP
    assert bit == (jintegrity.DEGENERATE_VAR if case == "degenerate_variance"
                   else jintegrity.KL_BLOWUP)
    assert got.keys() == want.keys() and int(got["anomaly_verdict"]) == bit
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert actor.engine.host_transfers == 0 and actor.version == 1
    _assert_state_equal(actor.engine, snap)


def test_kl_blowup_mid_stream_discards_the_sum(weights, rollout):  # noqa: F811
    """A stream of two chunks whose second carries |KL| 0.5: chunk 1
    accumulates, chunk 2 trips the sentinel, and the stream's end
    discards the sum in both packages (same verdict and stats; p, mu and
    nu bit for bit)."""
    t_if, j_if = _ifaces(anomaly_kl_max=0.1)
    actor, _, tok = _port_models(weights)
    jactor = _jax_actor(weights, tok)
    first, second = (_copy(c) for c in rollout.split_balanced(2))
    _with_ref(first, 0.0)
    _with_ref(second, -0.5)
    snap = _state(actor.engine)
    outs = []
    for iface, model, mb, conv in ((t_if, actor, MicroBatchSpec(), lambda s: s),
                                   (j_if, jactor, JMicroBatchSpec(), _to_jax)):
        state = iface.train_stream_begin(model, mb)
        chunks = [iface.train_stream_chunk(model, state, conv(c), mb) for c in (first, second)]
        assert chunks[1] == {"n_chunks_skipped": 1.0, "anomaly_verdict": float(integrity.KL_BLOWUP)}
        outs.append(iface.train_stream_end(model, state, mb))
    got, want = outs
    assert got["quarantined"] == want["quarantined"] == 1.0
    assert int(got["anomaly_verdict"]) == int(want["anomaly_verdict"]) == integrity.KL_BLOWUP
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_state_equal(actor.engine, snap)
    assert actor.engine.opt_count == 0
