"""bf16 optimizer masters (`TrainEngine(master_dtype="bfloat16")`)
against the JAX package's, on the CPU (fp32 compute over bf16 masters in
both, as the JAX package's CPU rule asks):

- the guarded step alone: the same bf16 gradients through the port's
  `_guarded_step` and the JAX engine's (optax's clip_by_global_norm and
  adamw in bf16), jitted with XLA's excess precision off, so each op
  rounds to bf16 as its jaxpr says: params, mu, nu and the norms equal
  bit for bit over three steps, with and without clipping;
- three `train_batch` steps end to end: the gradients differ in the
  last fp32 bits (the two packages reduce in other orders), which moves
  a few bf16 roundings of the gradient.  Measured here: at most 3.3e-5
  of the params' elements and 3.8e-4 of mu's or nu's differ, each by at
  most half a bf16 ulp of its leaf's largest element (1.4e-4 and
  4.2e-3, and one such ulp, without clipping); held to 1e-3 and 1e-2
  of the elements and one such ulp;
- the optimizer state's save/load and the host offload round trip keep
  bf16, bit for bit;
- the streamed step keeps bf16 moments where the JAX package's turns
  them fp32 (a deliberate difference)."""

import jax
import jax.numpy as jnp
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
from areal_tpu_torch.engines.train import TrainEngine, _leaves
from areal_tpu_torch.interfaces.ppo import _mask_count, _ppo_actor_loss_factory
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy
from tests.test_torch_train import EXTRA, _flat, _jp, _ppo_arrays, _samples

torch.set_num_threads(2)

BF16_ULP = 2.0**-7  # spacing of bf16 in [1, 2)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(5)))


def _engines(jparams, clip):
    oc = dict(lr=1e-3, warmup_steps_proportion=0.0, gradient_clipping=clip, weight_decay=0.05)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    je = JTrainEngine(jtiny(), _jp(jparams), mesh, optimizer_config=JOptimizerConfig(**oc),
                      ftspec=JFinetuneSpec(1, 8, 8), master_dtype="bfloat16")
    te = TrainEngine(ttiny(), params_from_numpy(jparams, device="cpu"), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8),
                     master_dtype="bfloat16")
    return je, te


def _adam(opt_state):
    """optax's ScaleByAdamState inside the chain's state."""
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))


def _trees(je_params, opt_state, te):
    adam = _adam(opt_state)
    return (("params", _flat(je_params), te.params), ("mu", _flat(adam.mu), te._mu),
            ("nu", _flat(adam.nu), te._nu))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().view(torch.int16).numpy()


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_guarded_step_matches_optax_bit_for_bit(jparams, clip):
    je, te = _engines(jparams, clip)
    step = jax.jit(lambda p, o, g, guard, loss: je._guarded_step(
        p, o, g, guard, loss, jnp.float32(0.0)))
    params, opt, guard = je.params, je.opt_state, jnp.zeros(2, jnp.float32)
    rng = np.random.default_rng(0)
    for it in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05 * (it + 1), jnp.bfloat16),
            jparams)
        loss = jnp.float32(1.0)
        run = step.lower(params, opt, grads, guard, loss).compile(
            compiler_options={"xla_allow_excess_precision": False})
        params, opt, guard, packed = run(params, opt, grads, guard, loss)
        flat_g = _flat(grads)
        for n, p in _leaves(te.params):
            p.grad = torch.from_numpy(np.asarray(flat_g[n.replace(".", "/")], np.float32)).to(
                torch.bfloat16)
        got = te._guarded_step(torch.tensor(1.0))
        te.opt_count += 1
        np.testing.assert_array_equal(got.numpy(), np.asarray(packed))
        for name, want, tree in _trees(params, opt, te):
            for n, t in _leaves(tree):
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    _bits(t), np.asarray(want[n.replace(".", "/")]).view(np.int16),
                    err_msg=f"step {it + 1} {name} {n}")


def test_three_train_batch_steps_match_jax(jparams):
    je, te = _engines(jparams, 1.0)
    rng = np.random.default_rng(3)
    for step in range(3):
        lens = [int(x) for x in rng.integers(6, 40, 5)]
        ts, js = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
        want = je.train_batch(js, JMicroBatchSpec(n_mbs=2), jloss_factory(0.2),
                              _mask_count, extra_keys=EXTRA)
        got = te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                             _mask_count, extra_keys=EXTRA)
        # The JAX engine reports its bf16 norms at fp32 precision (XLA
        # keeps the excess precision up to the fp32 output).
        for k in want:
            tol = BF16_ULP if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        for name, jtree, tree in _trees(je.get_params(), je.opt_state, te):
            n_diff = n_all = 0
            for n, t in _leaves(tree):
                assert t.dtype == torch.bfloat16
                w = np.asarray(jtree[n.replace(".", "/")], np.float32)
                g = t.detach().float().numpy()
                n_diff += int((g != w).sum())
                n_all += g.size
                top = float(np.abs(w).max())
                ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
                assert float(np.abs(g - w).max()) <= ulp, f"step {step + 1} {name} {n}"
            share = 1e-3 if name == "params" else 1e-2
            assert n_diff <= share * n_all, (step + 1, name, n_diff / n_all)


def _state(te):
    return [(n, t.detach().clone()) for tree in (te.params, te._mu, te._nu)
            for n, t in _leaves(tree)]


def test_optimizer_state_and_offload_keep_bf16(jparams, tmp_path):
    _, te = _engines(jparams, 1.0)
    rng = np.random.default_rng(4)
    lens = [9, 17, 30]
    ts, _ = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
    te.train_batch(ts, MicroBatchSpec(), _ppo_actor_loss_factory(0.2), _mask_count,
                   extra_keys=EXTRA)
    before = _state(te)
    assert all(t.dtype == torch.bfloat16 for _, t in before)
    path = str(tmp_path / "opt.safetensors")
    te.save_optimizer_state(path)
    _, fresh = _engines(jparams, 1.0)
    fresh.load_optimizer_state(path)
    assert fresh.opt_count == te.opt_count == 1
    for (n, a), (_, b) in zip(_state(te)[len(_state(te)) // 3:],
                              _state(fresh)[len(_state(fresh)) // 3:]):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n
    te.offload()
    assert te.params is None
    te.get_params()  # reloads the masters and the moments
    after = _state(te)
    for (n, a), (_, b) in zip(before, after):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n
    # An fp32 engine refuses bf16 moments rather than widening them.
    fp32 = TrainEngine(ttiny(), params_from_numpy(jparams, device="cpu"), "cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        fp32.load_optimizer_state(path)


def test_streamed_step_keeps_bf16_moments(jparams):
    """A deliberate difference, pinned in both packages: with bf16
    masters the JAX engine's streamed step scales the gradient sum by a
    strong fp32 scalar, which promotes it, so optax computes in fp32 and
    its moments stay fp32 after the step; the port scales the bf16 sum in
    place (rounded once) and keeps the moments, like the masters, bf16."""
    je, te = _engines(jparams, 1.0)
    rng = np.random.default_rng(6)
    lens = [12, 25, 7]
    ts, js = _samples(_ppo_arrays(rng, lens, ttiny().vocab_size), lens)
    state = je.train_stream_begin()
    je.train_stream_chunk(state, js, JMicroBatchSpec(), jloss_factory(0.2), _mask_count,
                          extra_keys=EXTRA)
    je.train_stream_end(state)
    adam = _adam(je.opt_state)
    assert {np.asarray(x).dtype for x in jax.tree.leaves(adam.mu)} == {np.dtype(np.float32)}
    assert {np.asarray(x).dtype for x in jax.tree.leaves(je.get_params())} == {
        np.dtype(jnp.bfloat16)}
    state = te.train_stream_begin()
    te.train_stream_chunk(state, ts, MicroBatchSpec(), _ppo_actor_loss_factory(0.2), _mask_count,
                          extra_keys=EXTRA)
    out = te.train_stream_end(state)
    assert out["quarantined"] == 0.0 and te.opt_count == 1
    assert all(t.dtype == torch.bfloat16 for _, t in _state(te))
