"""The port's InferenceEngine and host offload, fp32 on the CPU:
`forward` against the JAX package's InferenceEngine (logprobs of an LM,
values of a critic; atol 1e-5), an offload round trip that changes
nothing (bit-identical outputs, and a TrainEngine's next `train_batch`
bit-identical to one without the offload), and a reference model built
from a TrainEngine's live weights that does not drift when the trainer
updates its masters in place."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.inference import InferenceEngine as JInferenceEngine
from areal_tpu.interfaces.ppo import _logprob_post as jlogprob_post
from areal_tpu.interfaces.ppo import _value_post as jvalue_post
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.offload import buffers_alias
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import (
    _logprob_post,
    _mask_count,
    _ppo_actor_loss_factory,
    _value_post,
)
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

EXTRA = ("old_logp", "advantages", "loss_mask")


@pytest.fixture(scope="module", params=["actor", "critic"])
def model(request):
    """(kind, numpy weights) of the tiny LM or the tiny critic."""
    critic = request.param == "critic"
    pj = jtfm.init_params(jtiny(is_critic=critic), jax.random.PRNGKey(21))
    return request.param, jax.tree.map(np.asarray, pj)


def _cfgs(kind):
    critic = kind == "critic"
    return jtiny(is_critic=critic), ttiny(is_critic=critic)


def _posts(kind):
    return (_value_post, jvalue_post) if kind == "critic" else (_logprob_post, jlogprob_post)


def _samples(rng, lens, extra=None):
    arrays = {"packed_input_ids": rng.integers(0, 512, sum(lens)).astype(np.int32)}
    arrays.update(extra or {})
    kw = dict(keys=set(arrays), ids=[f"s{i}" for i in range(len(lens))],
              seqlens={k: [[n] for n in lens] for k in arrays})
    return (
        SequenceSample(data={k: v.copy() for k, v in arrays.items()}, **kw),
        JSequenceSample(data={k: v.copy() for k, v in arrays.items()}, **kw),
    )


def _ppo_extra(rng, lens):
    total = sum(lens)
    return dict(
        prompt_mask=np.concatenate([np.arange(n) < 3 for n in lens]),
        old_logp=(-6.0 + 0.3 * rng.standard_normal(total)).astype(np.float32),
        advantages=rng.standard_normal(total).astype(np.float32),
        loss_mask=np.concatenate(
            [(np.arange(n) >= 2) & (np.arange(n) < n - 1) for n in lens]
        ).astype(np.float32),
    )


def _fwd(eng, sample, kind, mb=None):
    post = _posts(kind)[0]
    out = eng.forward(sample, mb or MicroBatchSpec(), post_fn=post, output_key="out")
    return out.data["out"]


def test_forward_matches_jax(model, rng):
    """The same weights and packed sample through both InferenceEngines
    (two micro-batches): atol 1e-5, in the sample's id order."""
    kind, w = model
    jcfg, tcfg = _cfgs(kind)
    lens = [int(x) for x in rng.integers(3, 40, 5)]
    ts, js = _samples(rng, lens)
    eng = InferenceEngine(tcfg, params_from_numpy(w, device="cpu"), "cpu")
    assert eng.compute_dtype == torch.float32
    got = eng.forward(ts, MicroBatchSpec(n_mbs=2), post_fn=_posts(kind)[0], output_key="out")
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JInferenceEngine(jcfg, jax.tree.map(jnp.array, w), mesh)
    want = je.forward(js, JMicroBatchSpec(n_mbs=2), post_fn=_posts(kind)[1], output_key="out")
    assert got.ids == ts.ids and got.seqlens["out"] == ts.seqlens["packed_input_ids"]
    np.testing.assert_allclose(got.data["out"], np.asarray(want.data["out"]), atol=1e-5, rtol=0)


def test_offload_round_trip_is_exact(model, rng):
    """offload() drops the params; the next forward restores them and
    gives bit-identical outputs; set_params supersedes an offloaded copy."""
    kind, w = model
    _, tcfg = _cfgs(kind)
    ts, _ = _samples(rng, [17, 30, 4])
    eng = InferenceEngine(tcfg, params_from_numpy(w, device="cpu"), "cpu")
    before = _fwd(eng, ts, kind)
    eng.offload()
    assert eng.params is None
    eng.offload()  # a second offload is a no-op
    np.testing.assert_array_equal(_fwd(eng, ts, kind), before)
    assert eng.params is not None and eng._host_offload is None
    eng.offload()
    first = eng._host_offload
    eng._ensure_loaded()
    eng.offload()  # the host buffers are reused
    for a, b in zip(first[0]["blocks"].values(), eng._host_offload[0]["blocks"].values()):
        assert a is b
    eng.set_params(params_from_numpy(w, device="cpu"))
    assert eng._host_offload is None
    np.testing.assert_array_equal(_fwd(eng, ts, kind), before)


def test_ref_from_live_trainer_weights_does_not_drift(model, rng):
    """A ref built from `TrainEngine.get_params()` (the masters
    themselves on the CPU, where fp32 -> fp32 casts return the same
    tensor) keeps its outputs after the trainer updates in place."""
    kind, w = model
    _, tcfg = _cfgs(kind)
    lens = [12, 20, 9]
    ts, _ = _samples(rng, lens, _ppo_extra(rng, lens))
    train = TrainEngine(tcfg, params_from_numpy(w, device="cpu"), "cpu",
                        optimizer_config=OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0),
                        ftspec=FinetuneSpec(1, 8, 8))
    live = train.get_params()
    ref = InferenceEngine(tcfg, live, "cpu")
    for name, p in ref.params["blocks"].items():
        assert not buffers_alias(p, live["blocks"][name]), name
    before = _fwd(ref, ts, kind)
    train.train_batch(ts, MicroBatchSpec(), _ppo_actor_loss_factory(0.2), _mask_count,
                      extra_keys=EXTRA)
    assert not np.array_equal(_fwd(train, ts, kind), before)  # the actor moved
    np.testing.assert_array_equal(_fwd(ref, ts, kind), before)


def test_train_batch_after_offload_is_bit_identical(rng):
    """Two TrainEngines on the same weights take the same two steps; one
    is offloaded (params, Adam's mu and nu) before each: the stats, the
    weights and the moments after them are bit-identical."""
    w = jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(22)))
    lens = [12, 20, 9, 15]
    ts, _ = _samples(rng, lens, _ppo_extra(rng, lens))
    oc = OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0)
    engines = [TrainEngine(ttiny(), params_from_numpy(w, device="cpu"), "cpu",
                           optimizer_config=oc, ftspec=FinetuneSpec(1, 8, 8))
               for _ in range(2)]
    stats = []
    for i, eng in enumerate(engines):
        out = []
        for _ in range(2):
            if i == 1:
                eng.offload()
                assert eng.params is None and eng._mu is None and eng._nu is None
            out.append(eng.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                                       _mask_count, extra_keys=EXTRA))
        stats.append(out)
    assert stats[0] == stats[1]
    for tree in ("params", "_mu", "_nu"):
        a, b = getattr(engines[0], tree), getattr(engines[1], tree)
        for name in a["blocks"]:
            assert torch.equal(a["blocks"][name], b["blocks"][name]), (tree, name)
        assert torch.equal(a["embed"], b["embed"])
    assert all(p.requires_grad for p in engines[1].params["blocks"].values())
    engines[1].offload()
    engines[1].set_params(params_from_numpy(w, device="cpu"))  # restores mu/nu first
    assert engines[1]._mu is not None and engines[1].opt_count == 2


def test_buffers_alias():
    x = torch.arange(12.0)
    assert buffers_alias(x, x)
    assert buffers_alias(x[6:], x[:3])  # views of one storage
    assert buffers_alias(x.to(torch.float32), x)  # a no-op cast is the same tensor
    assert not buffers_alias(x.clone(), x)
    assert not buffers_alias(x.to(torch.float64), x)


def test_inference_engine_cannot_train(rng):
    w = jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(23)))
    eng = InferenceEngine(ttiny(), params_from_numpy(w, device="cpu"), "cpu")
    with pytest.raises(NotImplementedError):
        eng.train_batch()
