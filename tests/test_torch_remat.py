"""The port's remat policies ("none", "full", "dots", "dots_small")
against the JAX package's, fp32 on the CPU, one set of weights:

- each policy's `train_batch` (loss, stats, grad and update norms, the
  weights after each of two steps) against JAX's
  `TrainEngine(remat_policy=...)` within tests/test_torch_train.py's
  tolerances;
- the port's gradients bit for bit equal across its four policies;
- what each policy keeps for the backward of one layer: the tensors
  autograd saves (`torch.autograd.graph.saved_tensors_hooks`) and, for
  "dots", the products the selective checkpoint keeps
  (`transformer._dots_policy`)."""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.interfaces.ppo import _ppo_actor_loss_factory as jloss_factory
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import _mask_count, _ppo_actor_loss_factory
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from areal_tpu_torch.ops.norms import rope_cos_sin
from tests.test_torch_train import EXTRA, _flat, _jp, _ppo_arrays, _samples

torch.set_num_threads(2)

POLICIES = ("none", "full", "dots", "dots_small")
OC = dict(lr=1e-3, warmup_steps_proportion=0.0, gradient_clipping=1.0, weight_decay=0.05)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(5)))


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        lens = [int(x) for x in rng.integers(6, 40, 5)]
        out.append((_ppo_arrays(rng, lens, ttiny().vocab_size), lens))
    return out


def _port_engine(jparams, policy):
    return TrainEngine(ttiny(), params_from_numpy(jparams, device="cpu"), "cpu",
                       optimizer_config=OptimizerConfig(**OC), ftspec=FinetuneSpec(1, 8, 8),
                       remat_policy=policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_train_batch_matches_jax(jparams, policy):
    """Two train_batch steps of the PPO actor loss under one policy in
    both packages: loss and stats rtol 1e-5, grad and update norms rtol
    1e-4, the weights after each step within lr/100 of JAX's."""
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(), _jp(jparams), mesh, optimizer_config=JOptimizerConfig(**OC),
                      ftspec=JFinetuneSpec(1, 8, 8), remat_policy=policy)
    te = _port_engine(jparams, policy)
    for arrays, lens in _batches(3):
        ts, js = _samples(arrays, lens)
        want = je.train_batch(js, JMicroBatchSpec(n_mbs=2), jloss_factory(0.2),
                              _mask_count, extra_keys=EXTRA)
        got = te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                             _mask_count, extra_keys=EXTRA)
        assert set(got) == set(want)
        for k in want:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        pj, pt = _flat(je.get_params()), _flat(params_to_numpy(te.get_params()))
        assert set(pj) == set(pt)
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=OC["lr"] / 100, err_msg=k)


def test_policies_equal_bit_for_bit(jparams):
    """Recompute does not change values: the gradients of one backward
    and the weights after two train_batch steps are equal bit for bit
    under the four policies."""
    rng = np.random.default_rng(0)
    cfg = ttiny()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int64))
    seg = torch.ones(2, 32, dtype=torch.long)
    seg[0, 20:] = 2
    seg[1, 27:] = 0
    grads, weights = {}, {}
    for policy in POLICIES:
        params = params_from_numpy(jparams, device="cpu")
        leaves = [params["embed"], *params["blocks"].values()]
        for p in leaves:
            p.requires_grad_(True)
        x = ttfm.hidden_states(params, cfg, tokens, seg, remat=policy)
        ttfm.per_token_output(params, cfg, x, tokens, seg).sum().backward()
        grads[policy] = [p.grad for p in leaves]
        te = _port_engine(jparams, policy)
        for arrays, lens in _batches(4):
            ts, _ = _samples(arrays, lens)
            te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                           _mask_count, extra_keys=EXTRA)
        weights[policy] = _flat(params_to_numpy(te.get_params()))
    for policy in POLICIES[1:]:
        for a, b in zip(grads["none"], grads[policy]):
            assert torch.equal(a, b), policy
        for k, v in weights["none"].items():
            np.testing.assert_array_equal(weights[policy][k], v, err_msg=f"{policy} {k}")


def _saved_by_one_layer(jparams, policy, monkeypatch):
    """The shapes one layer keeps for its backward: the tensors autograd
    saves other than the weights, segment ids and RoPE tables every
    policy takes as they are, and the products the "dots" checkpoint
    keeps."""
    cfg = ttiny()
    params = params_from_numpy(jparams, device="cpu")
    blk = {name: w[0] for name, w in params["blocks"].items()}
    b, s = 2, 16
    seg = torch.ones(b, s, dtype=torch.long)
    pos = ttfm.positions_from_segments(seg)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    x = torch.randn(b, s, cfg.hidden_dim, requires_grad=True)
    shared = {t.untyped_storage().data_ptr() for t in (*blk.values(), seg, cos, sin)}
    saved, kept = [], []

    def pack(t):
        if t.untyped_storage().data_ptr() not in shared:
            saved.append(tuple(t.shape))
        return t

    policy_fn = ttfm._dots_policy

    def counting_policy(ctx, op, *args, **kwargs):
        out = policy_fn(ctx, op, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(tuple(ctx.op_output.shape))
        return out

    monkeypatch.setattr(ttfm, "_dots_policy", counting_policy)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = ttfm._layer(x, blk, cfg, seg, cos, sin, policy)  # (output, MoE aux)
    y.sum().backward()  # the kept tensors serve a backward
    return saved, kept, (b * s, cfg.hidden_dim)


def test_what_each_policy_keeps(jparams, monkeypatch):
    """"full" keeps the layer input; "dots_small" its two branch inputs,
    x and x + attn_out (JAX keeps three [*, D]: the input, "attn_out"
    and "mlp_out"); "dots" the layer input and the seven projections'
    outputs (q, k, v, wo, gate, up, down), as JAX's
    dots_with_no_batch_dims_saveable; "none" keeps more than "dots"."""
    cfg = ttiny()
    sizes = {}
    for policy in POLICIES:
        saved, kept, (n, d) = _saved_by_one_layer(jparams, policy, monkeypatch)
        sizes[policy] = sum(int(np.prod(t)) for t in saved + kept)
        layer_input = (2, 16, d)
        if policy == "full":
            assert saved == [layer_input] and kept == []
        if policy == "dots_small":
            assert saved == [layer_input, layer_input] and kept == []
        if policy == "dots":
            assert saved == [layer_input]
            f = cfg.intermediate_dim
            assert sorted(kept) == sorted([(n, cfg.q_dim), (n, cfg.kv_dim), (n, cfg.kv_dim),
                                           (n, d), (n, f), (n, f), (n, d)])
    assert sizes["none"] > sizes["dots"] > sizes["dots_small"] > sizes["full"]
