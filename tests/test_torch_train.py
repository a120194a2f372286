"""The port's TrainEngine against the JAX package's, fp32 on the CPU, on
one set of weights: the lr schedule against optax, one `train_batch` of
the PPO actor loss and of a critic's clipped value loss (loss,
grad_norm, update_norm, stats, weights after the step), twins of tests/test_engine.py :193 (micro-batch invariance),
:246 (fused logprobs) and :279 (forward alignment), the non-finite guard
(bit-identical state), and the packing / data helpers the engine uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base import datapack as jdatapack
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines import packing as jpacking
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.engines.train import make_lr_schedule as jschedule
from areal_tpu.interfaces.ppo import _ppo_actor_loss_factory as jloss_factory
from areal_tpu.interfaces.ppo import _ppo_critic_loss_factory as jcritic_loss_factory
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
from areal_tpu_torch.base import datapack, integrity
from areal_tpu_torch.engines import packing
from areal_tpu_torch.engines.train import TrainEngine, make_lr_schedule
from areal_tpu_torch.interfaces.ppo import (
    _mask_count,
    _ppo_actor_loss_factory,
    _ppo_critic_loss_factory,
)
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from areal_tpu_torch.ops import functional as tF

torch.set_num_threads(2)

EXTRA = ("old_logp", "advantages", "loss_mask")


@pytest.fixture(scope="module")
def jparams():
    """The weights as numpy: each engine gets its own copy (the JAX
    engine donates its buffers)."""
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(7)))


def _jp(w):
    return jax.tree.map(jnp.array, w)


def _tparams(w):
    return params_from_numpy(w, device="cpu")


def _ppo_arrays(rng, lens, vocab):
    """A PPO train batch (packed_input_ids, prompt_mask and the aligned
    old_logp / advantages / loss_mask keys) as numpy."""
    total = sum(lens)
    pmask = np.concatenate([np.arange(l) < 3 for l in lens])
    lmask = np.concatenate([(np.arange(l) >= 2) & (np.arange(l) < l - 1) for l in lens])
    return dict(
        packed_input_ids=rng.integers(0, vocab, total).astype(np.int32),
        prompt_mask=pmask,
        old_logp=(-6.0 + 0.3 * rng.standard_normal(total)).astype(np.float32),
        advantages=rng.standard_normal(total).astype(np.float32),
        loss_mask=lmask.astype(np.float32),
    )


def _samples(arrays, lens):
    kw = dict(
        keys=set(arrays), ids=[f"s{i}" for i in range(len(lens))],
        seqlens={k: [[l] for l in lens] for k in arrays},
    )
    return (
        SequenceSample(data={k: v.copy() for k, v in arrays.items()}, **kw),
        JSequenceSample(data={k: v.copy() for k, v in arrays.items()}, **kw),
    )


def _flat(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0.0, 0.2])
def test_lr_schedule_matches_optax(kind, warmup):
    """20 updates, counts 0..19 (count 0 = the first update): rtol 1e-6."""
    kw = dict(lr=3e-4, lr_scheduler_type=kind, warmup_steps_proportion=warmup,
              min_lr_ratio=0.1)
    want = jschedule(JOptimizerConfig(**kw), 20)
    got = make_lr_schedule(OptimizerConfig(**kw), 20)
    for c in range(20):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=1e-12)


def test_lr_schedule_rejects_unknown():
    with pytest.raises(ValueError):
        make_lr_schedule(OptimizerConfig(lr_scheduler_type="step"), 10)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_train_batch_matches_jax(jparams, rng, clip):
    """One train_batch of the PPO actor loss on the same weights and
    batch, then a second on a fresh batch (Adam's moments carried):
    loss and stats rtol 1e-5, grad and update norms rtol 1e-4, weights
    after each step within lr/100 of JAX's (Adam moves each by ~lr)."""
    lr = 1e-3
    oc = dict(lr=lr, warmup_steps_proportion=0.0, gradient_clipping=clip,
              weight_decay=0.05)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(), _jp(jparams), mesh, optimizer_config=JOptimizerConfig(**oc),
                      ftspec=JFinetuneSpec(1, 8, 8))
    te = TrainEngine(ttiny(), _tparams(jparams), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8))
    for _ in range(2):
        lens = [int(x) for x in rng.integers(6, 40, 5)]
        ts, js = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
        want = je.train_batch(js, JMicroBatchSpec(n_mbs=2), jloss_factory(0.2),
                              _mask_count, extra_keys=EXTRA)
        got = te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                             _mask_count, extra_keys=EXTRA)
        assert set(got) == set(want)
        for k in want:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        pj = _flat(je.get_params())
        pt = _flat(params_to_numpy(te.get_params()))
        assert set(pj) == set(pt)
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], atol=lr / 100, rtol=0, err_msg=k)
    assert te.opt_count == 2 and te.host_transfers == 2


def test_critic_train_batch_matches_jax(rng):
    """Two train_batch calls of a critic (value head) with the clipped
    value loss on the same weights and batches as the JAX engine: loss
    and stats rtol 1e-5, grad and update norms rtol 1e-4, weights after
    each step within lr/100 of JAX's."""
    lr = 1e-3
    oc = dict(lr=lr, warmup_steps_proportion=0.0, weight_decay=0.05)
    w = jax.tree.map(np.asarray, jtfm.init_params(jtiny(is_critic=True), jax.random.PRNGKey(8)))
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(is_critic=True), _jp(w), mesh,
                      optimizer_config=JOptimizerConfig(**oc), ftspec=JFinetuneSpec(1, 8, 8))
    te = TrainEngine(ttiny(is_critic=True), _tparams(w), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8))
    keys = ("old_values", "returns", "loss_mask")
    for _ in range(2):
        lens = [int(x) for x in rng.integers(6, 40, 5)]
        arrays = _ppo_arrays(rng, lens, ttiny().vocab_size)
        total = sum(lens)
        arrays["old_values"] = (0.3 * rng.standard_normal(total)).astype(np.float32)
        arrays["returns"] = rng.standard_normal(total).astype(np.float32)
        ts, js = _samples(arrays, lens)
        want = je.train_batch(js, JMicroBatchSpec(n_mbs=2), jcritic_loss_factory(0.2),
                              _mask_count, extra_keys=keys)
        got = te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_critic_loss_factory(0.2),
                             _mask_count, extra_keys=keys)
        assert set(got) == set(want) and {"value_loss", "value_clip_ratio"} <= set(got)
        for k in want:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        assert got["grad_norm"] > 0
        pj = _flat(je.get_params())
        pt = _flat(params_to_numpy(te.get_params()))
        assert set(pj) == set(pt) and "value_head" in pt
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], atol=lr / 100, rtol=0, err_msg=k)


def test_train_batch_mb_invariance(jparams, rng):
    """Twin of tests/test_engine.py:193: the update does not depend on the
    micro-batch split (token-weighted normalization): 1 vs 4
    micro-batches, rtol 2e-4 atol 1e-5."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0, gradient_clipping=0.0,
                         weight_decay=0.0)
    lens = [int(x) for x in rng.integers(6, 24, 8)]
    ts, _ = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
    params = []
    for n_mbs in (1, 4):
        e = TrainEngine(ttiny(), _tparams(jparams), "cpu", optimizer_config=oc,
                        ftspec=FinetuneSpec(1, 8, 8))
        out = e.train_batch(ts, MicroBatchSpec(n_mbs=n_mbs), _ppo_actor_loss_factory(0.2),
                            _mask_count, extra_keys=EXTRA)
        assert out["n_micro_batches"] == n_mbs
        params.append(_flat(params_to_numpy(e.get_params())))
    for k in params[0]:
        np.testing.assert_allclose(params[0][k], params[1][k], rtol=2e-4, atol=1e-5)


def test_fused_next_token_logprobs_matches_dense(jparams, rng):
    """Twin of tests/test_engine.py:246: chunked head + logsumexp equals
    the dense log-softmax path, values and parameter grads (rtol 1e-4,
    atol 1e-5)."""
    cfg = ttiny()
    b, s = 2, 20
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    seg = torch.from_numpy(
        np.where(np.arange(s)[None, :] < [[15], [20]], 1, 0).astype(np.int32)
    )
    results = []
    for fused in (False, True):
        p = _tparams(jparams)
        for _, v in _leaf_items(p):
            v.requires_grad_(True)
        if fused:
            x = ttfm.hidden_states(p, cfg, tokens, seg)
            lp = tF.fused_next_token_logprobs(x, ttfm.head_weights(p, cfg), tokens, seg, 8)
        else:
            lp = tF.next_token_logprobs(ttfm.forward(p, cfg, tokens, seg), tokens, seg)
        lp.sum().backward()
        results.append((lp.detach().numpy(), {k: v.grad.numpy() for k, v in _leaf_items(p)}))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5, atol=1e-5)
    for k in results[0][1]:
        np.testing.assert_allclose(results[0][1][k], results[1][1][k], rtol=1e-4, atol=1e-5)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_forward_returns_aligned_logprobs(jparams, rng):
    """Twin of tests/test_engine.py:279, and equal to JAX's
    TrainEngine.forward on the same weights (atol 1e-5)."""
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(), _jp(jparams), mesh, ftspec=JFinetuneSpec(1, 4, 4))
    te = TrainEngine(ttiny(), _tparams(jparams), "cpu", ftspec=FinetuneSpec(1, 4, 4))
    lens = [int(x) for x in rng.integers(2, 30, 3)]
    toks = rng.integers(0, 100, sum(lens)).astype(np.int32)
    ts, js = _samples({"packed_input_ids": toks}, lens)

    def post(logp, batch):
        return logp

    out = te.forward(ts, MicroBatchSpec(), post_fn=post, output_key="logprobs")
    assert out.ids == ts.ids
    assert out.seqlens["logprobs"] == ts.seqlens["packed_input_ids"]
    lp = out.data["logprobs"]
    assert lp.shape[0] == ts.total_len("packed_input_ids")
    assert (lp <= 0).all()
    want = je.forward(js, JMicroBatchSpec(), post_fn=post, output_key="logprobs")
    np.testing.assert_allclose(lp, np.asarray(want.data["logprobs"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("poison", ["loss", "grad"])
def test_nonfinite_step_leaves_state_bit_identical(jparams, rng, poison):
    """A NaN loss (or a NaN in the gradient) is quarantined: params, Adam
    moments and the step count are bit-identical afterwards, the verdict
    says NONFINITE, and the next clean step applies normally."""
    te = TrainEngine(ttiny(), _tparams(jparams), "cpu",
                     optimizer_config=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
                     ftspec=FinetuneSpec(1, 8, 8))
    lens = [12, 20, 9]
    ts, _ = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
    clean = _ppo_actor_loss_factory(0.2)
    te.train_batch(ts, MicroBatchSpec(), clean, _mask_count, extra_keys=EXTRA)

    def bad(logp, batch):
        loss, stats = clean(logp, batch)
        if poison == "loss":
            return loss * float("nan"), stats
        return loss + (logp * float("nan")).sum() * 0.0 + logp.sum() * 0.0, stats

    if poison == "grad":
        ts.data["advantages"][:] = np.float32("inf")
    before = [
        {k: v.clone() for k, v in _leaf_items(t)} for t in (te.params, te._mu, te._nu)
    ]
    counts = {k: c.get() for (k,), c in integrity.M_ANOMALY.children()}
    out = te.train_batch(ts, MicroBatchSpec(), bad, _mask_count, extra_keys=EXTRA)
    assert out["anomaly_verdict"] == integrity.NONFINITE and out["quarantined"] == 1.0
    assert integrity.M_ANOMALY.labels("nonfinite").get() == counts.get("nonfinite", 0) + 1
    for snap, tree in zip(before, (te.params, te._mu, te._nu)):
        for k, v in _leaf_items(tree):
            assert torch.equal(v, snap[k]), k
    assert te.opt_count == 1
    ts.data["advantages"][:] = 1.0
    out = te.train_batch(ts, MicroBatchSpec(), clean, _mask_count, extra_keys=EXTRA)
    assert out["quarantined"] == 0.0 and te.opt_count == 2


def test_engine_rejects_unported_configs(jparams):
    """An unknown remat policy or master dtype is refused when the engine
    is built ("dots" and "dots_small", once refused here, run:
    tests/test_torch_remat.py; MoE, once refused here, trains:
    tests/test_torch_moe.py)."""
    with pytest.raises(ValueError, match="remat"):
        TrainEngine(ttiny(), _tparams(jparams), "cpu", remat_policy="bogus")
    with pytest.raises(ValueError, match="master_dtype"):
        TrainEngine(ttiny(), _tparams(jparams), "cpu", master_dtype="float16")


# ---------------- packing and data helpers ----------------


def _random_sample(rng, n, max_len=20):
    lens = [int(rng.integers(1, max_len)) for _ in range(n)]
    toks = rng.integers(0, 100, sum(lens)).astype(np.int32)
    return _samples({"packed_input_ids": toks}, lens)


@pytest.mark.parametrize("max_tokens", [None, 25, 40])
def test_pack_sample_matches_jax(rng, max_tokens):
    ts, js = _random_sample(rng, 9)
    got = packing.pack_sample(ts, "packed_input_ids", max_tokens_per_row=max_tokens)
    want = jpacking.pack_sample(js, "packed_input_ids", max_tokens_per_row=max_tokens)
    assert got.seq_map == want.seq_map and got.row_len == want.row_len
    assert got.row_len % 128 == 0
    for k in want.arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
    np.testing.assert_array_equal(got.unpack(got.arrays["tokens"]), ts.data["packed_input_ids"])


@pytest.mark.parametrize("n", [1, 128, 129, 1000, 1025, 30000])
def test_bucket_len_matches_jax(n):
    assert packing.bucket_len(n) == jpacking.bucket_len(n)


@pytest.mark.parametrize("min_groups", [1, 3, 6])
def test_ffd_and_partition_match_jax(rng, min_groups):
    sizes = [int(x) for x in rng.integers(1, 50, 11)]
    assert datapack.ffd_allocate(sizes, 60, min_groups) == jdatapack.ffd_allocate(
        sizes, 60, min_groups
    )
    assert datapack.partition_balanced(sizes, min_groups) == jdatapack.partition_balanced(
        sizes, min_groups
    )


@pytest.mark.parametrize("spec", [(1, None), (3, None), (1, 30)])
def test_split_and_balanced_split_match_jax(rng, spec):
    ts, js = _random_sample(rng, 8)
    n_mbs, cap = spec
    got = [m.ids for m in ts.split(MicroBatchSpec(n_mbs=n_mbs, max_tokens_per_mb=cap))]
    want = [m.ids for m in js.split(JMicroBatchSpec(n_mbs=n_mbs, max_tokens_per_mb=cap))]
    assert got == want
    assert [m.ids for m in ts.split_balanced(3)] == [m.ids for m in js.split_balanced(3)]
    gathered = SequenceSample.gather(ts.split_balanced(3))
    assert sorted(gathered.ids) == sorted(ts.ids)
    assert gathered.total_len("packed_input_ids") == ts.total_len("packed_input_ids")
