"""The port's MoE against the JAX package's on the CPU, fp32, one set of
weights (`tiny_config(n_experts=4)` made by the JAX package from a seed
and carried by `params_from_numpy`), twins of tests/test_model.py:93-228:

- the router (`_moe_route`): top-k weights and indices, the aux, and
  ties ordered lower expert first, as `jax.lax.top_k`;
- each dispatch ("dense", "topk" at capacity factor 1.25 and 0.5,
  "grouped") against the JAX package's same dispatch: output, aux and
  the gradients of one layer; within the port, grouped and topk at
  capacity factor E equal the dense oracle, and topk at 0.5 drops;
- `forward_with_aux` over the layers under each remat policy (logits,
  aux and gradients);
- greedy generation on every path a MoE model runs (the static path's
  prefill + decode_step, the serving plane, the two-program paged path,
  the dense window, spec decoding on the dense window and on the serving
  plane), and topk on two of them: tokens identical to the JAX engine's;
- the behaviours copied from the JAX package (ROADMAP queue 3): the
  experts' SiLU whatever `hidden_act` says, padding taking topk
  capacity, and the grouped combine's order at k = 3;
- a TrainEngine step with the aux in the loss, and the InferenceEngine,
  against the JAX engines; the FLOPs count against the JAX monitor's.

Tolerances: outputs, aux and logits atol 1e-5 (fp32 rounding of products
summed in another order: observed <= 3e-6); gradients atol 1e-5, rtol
1e-4; generation logprobs 5e-4 (tests/test_torch_genmodes.py's); the
train step as tests/test_torch_train.py's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base import monitor as jmonitor
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.engines.inference import InferenceEngine as JInferenceEngine
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.interfaces.ppo import _ppo_actor_loss_factory as jloss_factory
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    GenerationHyperparameters,
    OptimizerConfig,
)
from areal_tpu_torch.base import monitor
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import _mask_count, _ppo_actor_loss_factory
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from tests.test_torch_generator import EOS, LENS, _assert_same, _samples
from tests.test_torch_train import EXTRA, _flat, _ppo_arrays
from tests.test_torch_train import _samples as _train_samples

torch.set_num_threads(2)

E = 4
OUT_TOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOGP_TOL = 5e-4
DISPATCHES = {  # name: (moe_dispatch, moe_capacity_factor)
    "dense": ("dense", 1.25),
    "topk": ("topk", 1.25),
    "topk_cf0.5": ("topk", 0.5),
    "grouped": ("grouped", 1.25),
}


def _cfgs(**kw):
    return (dataclasses.replace(jtiny(n_experts=E), **kw),
            dataclasses.replace(ttiny(n_experts=E), **kw))


@pytest.fixture(scope="module")
def weights():
    pj = jtfm.init_params(jtiny(n_experts=E), jax.random.PRNGKey(2))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def layer(weights):
    """Layer 1's blocks in both packages."""
    pj, pt = weights
    return (jax.tree.map(lambda a: a[1], pj["blocks"]),
            {k: v[1].clone() for k, v in pt["blocks"].items()})


def _h(rng, b=2, s=24, d=64):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def test_init_params_leaves_match_jax():
    """The MoE leaves (router [L, D, E], wg/wu [L, E, D, FM], wd
    [L, E, FM, D]) by name, shape and dtype; no dense MLP leaf."""
    pj = jtfm.init_params(jtiny(n_experts=E), jax.random.PRNGKey(0))
    pt = ttfm.init_params(ttiny(n_experts=E), 0, device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(pj).items()}
    got = {k: (v.shape, str(v.dtype)) for k, v in _flat(params_to_numpy(pt)).items()}
    assert got == want
    assert pt["blocks"]["wg"].shape == (4, E, 64, 64)


def test_route_matches_jax(layer, rng):
    bj, bt = layer
    x = rng.standard_normal((48, 64)).astype(np.float32)
    jc, tc = _cfgs()
    wj, ij, oj, aj = jtfm._moe_route(jnp.asarray(x), bj, jc)
    wt, it, ot, at = ttfm._moe_route(torch.from_numpy(x), bt, tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def test_route_ties_order_the_lower_expert_first(layer):
    """A zero router gives uniform probabilities: every token picks
    experts 0 and 1, weights 1/2 each, as jax.lax.top_k orders ties."""
    bj, bt = layer
    bj = dict(bj, router=jnp.zeros_like(bj["router"]))
    bt = dict(bt, router=torch.zeros_like(bt["router"]))
    x = np.ones((5, 64), np.float32)
    jc, tc = _cfgs()
    _, ij, _, aj = jtfm._moe_route(jnp.asarray(x), bj, jc)
    wt, it, _, at = ttfm._moe_route(torch.from_numpy(x), bt, tc)
    assert it.tolist() == np.asarray(ij).tolist() == [[0, 1]] * 5
    assert wt.tolist() == [[0.5, 0.5]] * 5
    assert float(at) == float(aj)


@pytest.mark.parametrize("name", sorted(DISPATCHES))
def test_dispatch_matches_jax(layer, rng, name):
    """One MoE MLP, both packages' same dispatch: output and aux."""
    bj, bt = layer
    disp, cf = DISPATCHES[name]
    jc, tc = _cfgs(moe_dispatch=disp, moe_capacity_factor=cf)
    h = _h(rng)
    oj, aj = jtfm._mlp_moe(jnp.asarray(h), bj, jc)
    ot, at = ttfm._mlp(torch.from_numpy(h), bt, tc)
    assert ot.shape == h.shape
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(DISPATCHES))
def test_dispatch_grads_match_jax(layer, rng, name):
    """d(sum(out * g) + aux) by the layer's input, router and experts:
    autograd against jax.grad."""
    bj, bt = layer
    disp, cf = DISPATCHES[name]
    jc, tc = _cfgs(moe_dispatch=disp, moe_capacity_factor=cf)
    h = _h(rng)
    g = rng.standard_normal(h.shape).astype(np.float32)
    keys = ("router", "wg", "wu", "wd")

    def jloss(hh, ws):
        out, aux = jtfm._mlp_moe(hh, dict(bj, **ws), jc)
        return jnp.sum(out * g) + aux

    gh_j, gw_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), {k: bj[k] for k in keys})
    ht = torch.from_numpy(h).requires_grad_(True)
    ws = {k: bt[k].clone().requires_grad_(True) for k in keys}
    out, aux = ttfm._mlp(ht, dict(bt, **ws), tc)
    (torch.sum(out * torch.from_numpy(g)) + aux).backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j), **GRAD_TOL)
    for k in keys:
        np.testing.assert_allclose(ws[k].grad.numpy(), np.asarray(gw_j[k]), err_msg=k,
                                   **GRAD_TOL)
    assert float(ws["router"].grad.abs().max()) > 0  # routing is learned


@pytest.mark.parametrize("disp,cf", [("grouped", 1.25), ("topk", float(E))])
def test_dropless_dispatch_equals_dense_oracle(layer, rng, disp, cf):
    """Grouped (dropless) and topk at capacity factor E (room for every
    choice) equal the all-expert oracle within the port; the aux and the
    routing are identical."""
    _, bt = layer
    _, tc = _cfgs(moe_dispatch=disp, moe_capacity_factor=cf)
    _, td = _cfgs(moe_dispatch="dense")
    h = torch.from_numpy(_h(rng))
    o, a = ttfm._mlp(h, bt, tc)
    od, ad = ttfm._mlp(h, bt, td)
    np.testing.assert_allclose(o.numpy(), od.numpy(), atol=OUT_TOL, rtol=0)
    assert float(a) == float(ad)


def test_topk_drops_over_capacity(layer, rng):
    """At capacity factor 0.5 some choices drop: the output differs from
    the oracle exactly on the tokens with a dropped choice, and equals
    a recount of the rule (choice-slot-major queues, cap slots an
    expert) computed here on the host."""
    _, bt = layer
    _, tc = _cfgs(moe_dispatch="topk", moe_capacity_factor=0.5)
    h = torch.from_numpy(_h(rng))
    x = h.reshape(-1, 64)
    T, k = x.shape[0], tc.n_experts_per_tok
    cap = int(np.ceil(T * k / E * 0.5))
    _, idx, _, _ = ttfm._moe_route(x, bt, tc)
    fill = [0] * E
    kept = np.zeros((T, k), bool)
    for j in range(k):
        for t in range(T):
            e = int(idx[t, j])
            kept[t, j] = fill[e] < cap
            fill[e] += 1
    assert not kept.all()
    out, _ = ttfm._mlp(h, bt, tc)
    want = torch.zeros_like(x)
    w, _, _, _ = ttfm._moe_route(x, bt, tc)
    for t in range(T):
        for j in range(k):
            if kept[t, j]:
                e = int(idx[t, j])
                hid = torch.nn.functional.silu(x[t] @ bt["wg"][e]) * (x[t] @ bt["wu"][e])
                want[t] += w[t, j] * (hid @ bt["wd"][e])
    np.testing.assert_allclose(out.reshape(T, -1).numpy(), want.numpy(), atol=OUT_TOL, rtol=0)


def test_moe_mlp_is_silu_whatever_hidden_act(layer, rng):
    """Pinned from the JAX package: the experts' activation is SiLU even
    when `hidden_act` names another (the dense MLP's switch); the port's
    output under "gelu_tanh" equals its output under "silu" bit for bit,
    and JAX's under "gelu_tanh"."""
    bj, bt = layer
    h = _h(rng)
    jc, tc = _cfgs(hidden_act="gelu_tanh")
    got = ttfm._mlp(torch.from_numpy(h), bt, tc)[0]
    assert torch.equal(got, ttfm._mlp(torch.from_numpy(h), bt, _cfgs()[1])[0])
    want = jtfm._mlp_moe(jnp.asarray(h), bj, jc)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=0)


def test_padding_tokens_take_topk_capacity(layer, rng):
    """Pinned from the JAX package: every row of h routes, padding
    included, and takes topk capacity.  Padding rows appended after 24
    real tokens claim slots before the real tokens' second choices
    (choice-slot-major queues), so the real tokens' outputs change; both
    packages alike."""
    bj, bt = layer
    jc, tc = _cfgs(moe_dispatch="topk", moe_capacity_factor=0.5)
    real = _h(rng, b=1, s=24)
    padded = np.concatenate([real, _h(rng, b=1, s=24)], axis=1)
    alone = ttfm._mlp(torch.from_numpy(real), bt, tc)[0]
    with_pad = ttfm._mlp(torch.from_numpy(padded), bt, tc)[0][:, :24]
    assert float((alone - with_pad).abs().max()) > 1e-3
    want = jtfm._mlp_moe(jnp.asarray(padded), bj, jc)[0][:, :24]
    np.testing.assert_allclose(with_pad.numpy(), np.asarray(want), atol=OUT_TOL, rtol=0)


def test_grouped_k3_matches_jax_within_rounding(weights, rng):
    """k = 3: the port sums a token's three outputs in choice order where
    JAX's scatter-add sums them in its update order (ROADMAP queue 3):
    equal within fp32 rounding."""
    pj, pt = weights
    jc, tc = _cfgs(n_experts_per_tok=3)
    h = _h(rng)
    bj = jax.tree.map(lambda a: a[0], pj["blocks"])
    bt = {k: v[0] for k, v in pt["blocks"].items()}
    oj, aj = jtfm._mlp_moe(jnp.asarray(h), bj, jc)
    ot, at = ttfm._mlp(torch.from_numpy(h), bt, tc)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def _batch(rng, cfg, b=2, s=32):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, 20:] = 2
    seg[1, 25:] = 0
    return tokens, seg


@pytest.mark.parametrize("remat", ["none", "full", "dots", "dots_small"])
def test_forward_with_aux_matches_jax(weights, rng, remat):
    """Logits and the aux summed over the 4 layers, and the gradients of
    sum(logits * c) + aux, under each remat policy (the port's grads are
    the same under every policy; JAX's too)."""
    pj, pt = weights
    jc, tc = _cfgs()
    tokens, seg = _batch(rng, tc)
    c = (1e-3 * rng.standard_normal((2, 32, tc.vocab_size))).astype(np.float32)

    def jloss(p):
        lo, aux = jtfm.forward_with_aux(p, jc, jnp.asarray(tokens), jnp.asarray(seg),
                                        remat=False if remat == "none" else remat)
        return jnp.sum(lo * c) + aux, (lo, aux)

    (_, (lj, aj)), gj = jax.value_and_grad(jloss, has_aux=True)(pj)
    ptg = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
               if isinstance(v, dict) else v.clone().requires_grad_(True))
           for k, v in pt.items()}
    lt, at = ttfm.forward_with_aux(ptg, tc, torch.from_numpy(tokens), torch.from_numpy(seg),
                                   remat=remat)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(float(at.detach()), float(aj), rtol=1e-6)
    assert float(at.detach()) > 0
    (torch.sum(lt * torch.from_numpy(c)) + at).backward()
    want = _flat(gj)
    got = {}
    for k, v in ptg.items():
        for n, w in (v.items() if isinstance(v, dict) else [(None, v)]):
            got[f"{k}/{n}" if n else k] = w.grad.numpy()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_hidden_states_with_aux(weights, rng):
    """`hidden_states` keeps its one output; `hidden_states_with_aux`
    gives the JAX `hidden_states`' pair."""
    pj, pt = weights
    jc, tc = _cfgs()
    tokens, seg = _batch(rng, tc)
    xj, aj = jtfm.hidden_states(pj, jc, jnp.asarray(tokens), jnp.asarray(seg))
    xt, at = ttfm.hidden_states_with_aux(pt, tc, torch.from_numpy(tokens),
                                         torch.from_numpy(seg))
    x1 = ttfm.hidden_states(pt, tc, torch.from_numpy(tokens), torch.from_numpy(seg))
    assert torch.equal(x1, xt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    dense = ttfm.hidden_states_with_aux(
        ttfm.init_params(ttiny(), 0, device="cpu"), ttiny(),
        torch.from_numpy(tokens), torch.from_numpy(seg))[1]
    assert dense.dtype == torch.float32 and float(dense) == 0.0


# ---------------- generation ----------------

DENSE = dict(kv_paged=False)
PAGED2 = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=0)
SERVING = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4)
GEN_MODES = {  # name: (engine kwargs, generation kwargs, inflight, config changes)
    "static": (dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4), {}, False, {}),
    "serving": (SERVING, {}, True, {}),
    "paged2": (PAGED2, {}, True, {}),
    "dense": (DENSE, {}, True, {}),
    "dense_spec_k2": (DENSE, dict(spec_decode_k=2, spec_ngram=2), True, {}),
    "serving_spec_k2": (SERVING, dict(spec_decode_k=2), True, {}),
    # topk couples the tokens of a forward: padding rows and dead lanes
    # take capacity in both packages.  3 slots, so an admission of 3
    # prompts pads to 4 rows.
    "dense_topk": (dict(DENSE, max_decode_batch=3), {}, True,
                   dict(moe_dispatch="topk", moe_capacity_factor=0.5)),
    "serving_topk": (dict(SERVING, max_decode_batch=3), {}, True,
                     dict(moe_dispatch="topk", moe_capacity_factor=0.5)),
}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])


@pytest.mark.parametrize("mode", sorted(GEN_MODES))
def test_greedy_generation_matches_jax(weights, mesh, mode):
    """5 requests through 2 slots, greedy, the grouped dispatch (and topk
    at capacity factor 0.5 on two paths, 3 slots): the JAX engine's tokens, its
    logprobs within 5e-4.  The static path runs prefill + decode_step,
    the serving plane decode_step_ragged_paged, the two-program path
    prefill_into_pages + decode_step_paged, the dense window
    prefill_into_slots + decode_step_inflight, the spec modes
    decode_step_spec and the serving plane's spec lanes."""
    pj, pt = weights
    ekw, gkw, inflight, change = GEN_MODES[mode]
    jc, tc = _cfgs(**change)
    js, ts = _samples(LENS)
    ekw = dict(dict(max_decode_batch=2), **ekw)
    je = JEngine(jc, pj, mesh, eos_token_id=EOS, **ekw)
    te = GeneratorEngine(tc, pt, "cpu", eos_token_id=EOS, **ekw)
    g = dict(n=1, max_new_tokens=10, greedy=True, **gkw)
    oj = je.generate(js, JSpec(), JGen(**g), inflight=inflight)
    ot = te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g), inflight=inflight)
    _assert_same(oj, ot, atol=LOGP_TOL)


# ---------------- engines ----------------


def test_train_batch_with_aux_matches_jax(weights, rng):
    """Two train_batch steps of the PPO actor loss on a MoE model: the
    loss (the PPO loss plus moe_aux_loss_coef x the aux, as the JAX
    engine reports it) and the stats rtol 1e-5, the norms rtol 1e-4, the
    weights after each step within lr/100 of JAX's; the aux moves the
    gradient (a step with coef 0 differs)."""
    pj, _ = weights
    w = jax.tree.map(np.asarray, pj)
    lr = 1e-3
    oc = dict(lr=lr, warmup_steps_proportion=0.0, gradient_clipping=1.0, weight_decay=0.05)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    jc, tc = _cfgs(moe_aux_loss_coef=0.1)
    je = JTrainEngine(jc, jax.tree.map(jnp.array, w), mesh,
                      optimizer_config=JOptimizerConfig(**oc), ftspec=JFinetuneSpec(1, 8, 8))
    te = TrainEngine(tc, params_from_numpy(w, device="cpu"), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8))
    t0 = TrainEngine(dataclasses.replace(tc, moe_aux_loss_coef=0.0),
                     params_from_numpy(w, device="cpu"), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8))
    for step in range(2):
        lens = [int(x) for x in rng.integers(6, 40, 5)]
        arrays = _ppo_arrays(rng, lens, tc.vocab_size)
        ts, js = _train_samples(arrays, lens)
        want = je.train_batch(js, JSpec(n_mbs=2), jloss_factory(0.2), _mask_count,
                              extra_keys=EXTRA)
        got = te.train_batch(ts, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                             _mask_count, extra_keys=EXTRA)
        assert set(got) == set(want)
        for k in want:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        pw, ptt = _flat(je.get_params()), _flat(params_to_numpy(te.get_params()))
        for k in pw:
            np.testing.assert_allclose(ptt[k], pw[k], atol=lr / 100, rtol=0, err_msg=k)
        if step == 0:
            ts0, _ = _train_samples(arrays, lens)
            got0 = t0.train_batch(ts0, MicroBatchSpec(n_mbs=2), _ppo_actor_loss_factory(0.2),
                                  _mask_count, extra_keys=EXTRA)
            assert got0["loss"] < got["loss"] and got0["grad_norm"] != got["grad_norm"]
            assert got0["actor_loss"] == pytest.approx(got["actor_loss"], rel=1e-6)


def test_inference_engine_matches_jax(weights):
    """The reference model's logprobs on a MoE model: within 1e-5."""
    from areal_tpu.api.data_api import SequenceSample as JSample
    from areal_tpu_torch.api.data_api import SequenceSample

    pj, pt = weights
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    lens = [9, 14, 5]
    data = np.random.default_rng(3).integers(0, 512, sum(lens)).astype(np.int32)
    kw = dict(keys={"packed_input_ids"}, ids=["a", "b", "c"],
              seqlens={"packed_input_ids": [[n] for n in lens]})
    post = lambda out, batch: out  # noqa: E731
    want = JInferenceEngine(jtiny(n_experts=E), pj, mesh).forward(
        JSample(data={"packed_input_ids": data.copy()}, **kw), JSpec(), post, "logp")
    got = InferenceEngine(ttiny(n_experts=E), pt, "cpu").forward(
        SequenceSample(data={"packed_input_ids": data.copy()}, **kw), MicroBatchSpec(),
        post, "logp")
    np.testing.assert_allclose(got.data["logp"], np.asarray(want.data["logp"]), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_flops_count_active_experts_as_jax(k):
    jc, tc = _cfgs(n_experts_per_tok=k)
    assert monitor.matmul_params(tc) == jmonitor.matmul_params(jc)
    assert monitor.flops_train(tc, 1000, 2.5e5) == jmonitor.flops_train(jc, 1000, 2.5e5)
    assert monitor.matmul_params(tc) < monitor.matmul_params(
        dataclasses.replace(tc, n_experts_per_tok=E))
