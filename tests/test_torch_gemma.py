"""The port's gemma family against the JAX package's and against
`transformers` (installed here; the port needs neither), fp32 on the CPU:

- the config both ways over the model-shape keys of Gemma-2B's and
  Gemma-7B's `config.json`, equal to the JAX reader's and writer's;
- the behaviours copied from the JAX package (ROADMAP queue 3), pinned
  in both packages: `hidden_act` is not read (the MLP is gelu_tanh), and
  the embedding normalizer is computed in fp32 (`transformers` rounds it
  to the weights' dtype first);
- state dicts equal across the packages both ways, bit for bit and in
  the JAX package's key order, and checkpoint directories written by
  either package loading in the other;
- a tiny gemma at head_dim 256 (2 layers, hidden 128, 2 q heads over 1
  kv head: a query width of 512, not the hidden width) against the tiny
  `transformers` `GemmaForCausalLM` (within 2e-4, as tests/test_model.py
  holds the JAX package), and against the JAX package with its Pallas
  flash kernel in interpret mode: the packed forward and its gradients,
  the reference model's logprobs, greedy tokens on the static path, the
  serving plane and the two-program paged path (`decode_step_paged`),
  a TrainEngine step, and one `quickstart ppo-math` step from a gemma
  checkpoint (every stat within rtol 1e-4, atol 1e-6, as
  tests/test_torch_hf_families.py holds the other families);
- the kernel wrappers' head-dim checks: 64, 128 and 256 taken, 16 and
  96 refused with a message naming ROADMAP queue 1 item 9.3.

Tolerances: logits 5e-5 (fp32 products over head_dim 256 summed in
another order, on logits of up to ~5 from embeddings scaled by
sqrt(hidden): observed <= 2.3e-5);
gradients atol 1e-5, rtol 1e-4; generation logprobs 5e-4
(tests/test_torch_genmodes.py's); the train step as
tests/test_torch_train.py's."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.engines.inference import InferenceEngine as JInferenceEngine
from areal_tpu.engines.train import TrainEngine as JTrainEngine
from areal_tpu.interfaces.ppo import _ppo_actor_loss_factory as jloss_factory
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.hf import registry as jhf
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    GenerationHyperparameters,
    OptimizerConfig,
)
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import _mask_count, _ppo_actor_loss_factory
from areal_tpu_torch.kernels import flash_attention as tfa
from areal_tpu_torch.kernels import ragged_paged_attention as rpa
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from tests import fixtures
from tests.test_torch_generator import EOS, LENS, _assert_same, _samples
from tests.test_torch_hf_families import _assert_params_equal, _assert_sd_equal
from tests.test_torch_train import EXTRA, _flat, _ppo_arrays
from tests.test_torch_train import _samples as _train_samples

torch.set_num_threads(2)

OUT_TOL = 5e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOGP_TOL = 5e-4
HF_TOL = 2e-4

# The model-shape keys of google/gemma-2b's and google/gemma-7b's config.json.
GEMMA_2B = {
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "vocab_size": 256000,
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "hidden_act": "gelu", "hidden_activation": None, "tie_word_embeddings": True,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "bfloat16",
}
GEMMA_7B = dict(GEMMA_2B, hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
                num_attention_heads=16, num_key_value_heads=16)
# A tiny gemma at Gemma's head_dim: q width 2 x 256 = 512, hidden 128.
TINY = dict(model_type="gemma", num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1, head_dim=256, intermediate_size=256, vocab_size=512,
            max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6)


def _cfgs(**kw):
    """The tiny config as each package reads it, fp32 weights."""
    jc = jhf.HF_FAMILIES["gemma"].config_from_hf(TINY)
    tc = hf.get_family("gemma").config_from_hf(TINY)
    return (dataclasses.replace(jc, param_dtype="float32", **kw),
            dataclasses.replace(tc, param_dtype="float32", **kw))


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs()
    pj = jtfm.init_params(jc, jax.random.PRNGKey(3))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def hf_model():
    import transformers

    torch.manual_seed(0)
    m = transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **{k: v for k, v in TINY.items() if k != "model_type"},
        hidden_act="gelu_pytorch_tanh", hidden_activation="gelu_pytorch_tanh",
        attention_dropout=0.0, tie_word_embeddings=True))
    m.eval()
    return m


def _hf_config(model):
    return json.loads(model.config.to_json_string())


# ---------------- config, checkpoint IO ----------------


@pytest.mark.parametrize("name,published", [("gemma-2b", GEMMA_2B), ("gemma-7b", GEMMA_7B)])
def test_config_both_ways_matches_jax(name, published):
    got = hf.get_family("gemma").config_from_hf(published)
    want = jhf.HF_FAMILIES["gemma"].config_from_hf(published)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == 256 and got.tied_embeddings and got.rms_norm_offset
    assert got.embed_scale and got.hidden_act == "gelu_tanh"
    if name == "gemma-7b":
        assert got.q_dim == 4096 != got.hidden_dim
    else:
        assert (got.n_q_heads, got.n_kv_heads) == (8, 1)
    out = hf.get_family("gemma").config_to_hf(got)
    assert out == jhf.HF_FAMILIES["gemma"].config_to_hf(want)
    assert out["hidden_activation"] == "gelu_pytorch_tanh" and "lm_head" not in json.dumps(out)
    assert hf.get_family("gemma").config_from_hf(out) == got
    assert hf.infer_model_type(got) == jhf.infer_model_type(want) == "gemma"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_pinned_hidden_act_is_not_read(package):
    """Copied from the JAX reader: a gemma config.json's `hidden_act` is
    not read; the MLP is gelu_tanh whatever it says."""
    for act in ("silu", "gelu", "gelu_pytorch_tanh"):
        published = dict(GEMMA_2B, hidden_act=act, hidden_activation=act)
        reader = (jhf.HF_FAMILIES["gemma"] if package == "jax" else hf.get_family("gemma"))
        assert reader.config_from_hf(published).hidden_act == "gelu_tanh"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_pinned_embed_normalizer_in_fp32(package, rng):
    """Copied from the JAX model: bf16 embeddings are scaled by
    sqrt(hidden) in fp32 and then rounded once; `transformers` rounds the
    normalizer to bf16 first (sqrt(128) = 11.3137... -> 11.3125), which
    gives other values.  The two packages agree bit for bit."""
    _, tc = _cfgs()
    jc, _ = _cfgs()
    table = torch.from_numpy(rng.standard_normal((64, tc.hidden_dim)).astype(np.float32))
    table = table.to(torch.bfloat16)
    tokens = torch.arange(64)[None]
    want = (table.float() * math.sqrt(tc.hidden_dim)).to(torch.bfloat16)
    hf_way = table * torch.tensor(math.sqrt(tc.hidden_dim), dtype=torch.bfloat16)
    if package == "port":
        got = ttfm._embed({"embed": table}, tc, tokens, tokens)[0]
    else:
        jt = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
        out = jtfm._embed({"embed": jt}, jc, jnp.asarray(tokens.numpy()), jnp.asarray(tokens.numpy()))
        got = torch.from_numpy(np.asarray(out[0].astype(jnp.float32))).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert not torch.equal(got, hf_way)


def test_state_dicts_match_jax_both_ways(hf_model):
    """transformers' tensors -> params (the JAX loader's bit for bit; no
    lm_head) -> HF tensors (the JAX writer's bit for bit, in its order;
    the norm weights raw)."""
    hcfg = _hf_config(hf_model)
    cfg = hf.get_family("gemma").config_from_hf(hcfg)
    jcfg = jhf.HF_FAMILIES["gemma"].config_from_hf(hcfg)
    sd = {k: v.detach().float().contiguous() for k, v in hf_model.state_dict().items()
          if k != "lm_head.weight"}
    params = hf.get_family("gemma").params_from_sd(cfg, sd, dtype=torch.float32, device="cpu")
    jparams = jhf.HF_FAMILIES["gemma"].params_from_sd(
        jcfg, {k: v.numpy() for k, v in sd.items()}, dtype=jnp.float32)
    _assert_params_equal(params, jparams)
    assert "lm_head" not in params
    assert torch.equal(params["final_ln"], sd["model.norm.weight"])
    out = hf.get_family("gemma").params_to_sd(cfg, params)
    _assert_sd_equal(out, jhf.HF_FAMILIES["gemma"].params_to_sd(jcfg, jparams))
    assert "lm_head.weight" not in out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_dirs_cross_load(tmp_path, weights, writer):
    jcfg, tcfg = _cfgs()
    pj, pt = weights
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jhf.save_hf_checkpoint(path, jcfg, pj, model_type="gemma")
        cfg, params = hf.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jhf.load_model_config(path))
        _assert_params_equal(params, pj)
    else:
        hf.save_hf_checkpoint(path, tcfg, pt, model_type="gemma")
        cfg, back = jhf.load_hf_checkpoint(path, dtype=jnp.float32)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            dataclasses.replace(tcfg, param_dtype="bfloat16"))
        _assert_params_equal(pt, back)
    assert hf.load_hf_config(path)["model_type"] == "gemma"


def test_forward_matches_transformers(hf_model, rng):
    cfg = hf.get_family("gemma").config_from_hf(_hf_config(hf_model))
    sd = {k: v.detach().float() for k, v in hf_model.state_dict().items()}
    params = hf.get_family("gemma").params_from_sd(cfg, sd, dtype=torch.float32, device="cpu")
    toks = rng.integers(0, 512, size=(1, 17)).astype(np.int64)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(toks)).logits.numpy()
        got = ttfm.forward(params, cfg, torch.from_numpy(toks), torch.ones(1, 17, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)


# ---------------- the model at head_dim 256 against the JAX package ----------------


def _batch(rng, cfg, b=2, s=64):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, 40:] = 2
    seg[1, 50:] = 0
    return tokens, seg


def test_packed_forward_and_grads_match_jax(weights, rng):
    """Logits and the gradients of sum(logits * c) over 2 packed rows (two
    segments, padding), the JAX side through its Pallas flash kernel in
    interpret mode at head_dim 256."""
    pj, pt = weights
    jc, tc = _cfgs()
    tokens, seg = _batch(rng, tc)
    c = (1e-3 * rng.standard_normal((2, 64, tc.vocab_size))).astype(np.float32)

    def jloss(p):
        lo = jtfm.forward(p, jc, jnp.asarray(tokens), jnp.asarray(seg), use_flash=True)
        return jnp.sum(lo * c), lo

    (_, lj), gj = jax.value_and_grad(jloss, has_aux=True)(pj)
    ptg = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
               if isinstance(v, dict) else v.clone().requires_grad_(True))
           for k, v in pt.items()}
    lt = ttfm.forward(ptg, tc, torch.from_numpy(tokens), torch.from_numpy(seg))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=OUT_TOL, rtol=0)
    torch.sum(lt * torch.from_numpy(c)).backward()
    want = _flat(gj)
    got = {}
    for k, v in ptg.items():
        for n, w in (v.items() if isinstance(v, dict) else [(None, v)]):
            got[f"{k}/{n}" if n else k] = w.grad.numpy()
    assert set(got) == set(want) and "blocks/wq" in got
    assert got["blocks/wq"].shape[-1] == 512 != tc.hidden_dim
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_inference_engine_matches_jax(weights):
    """The reference model's logprobs: within 1e-5."""
    pj, pt = weights
    jc, tc = _cfgs()
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    lens = [9, 14, 5]
    data = np.random.default_rng(3).integers(0, 512, sum(lens)).astype(np.int32)
    kw = dict(keys={"packed_input_ids"}, ids=["a", "b", "c"],
              seqlens={"packed_input_ids": [[n] for n in lens]})
    post = lambda out, batch: out  # noqa: E731
    want = JInferenceEngine(jc, pj, mesh).forward(
        JSample(data={"packed_input_ids": data.copy()}, **kw), JSpec(), post, "logp")
    got = InferenceEngine(tc, pt, "cpu").forward(
        SequenceSample(data={"packed_input_ids": data.copy()}, **kw), MicroBatchSpec(),
        post, "logp")
    np.testing.assert_allclose(got.data["logp"], np.asarray(want.data["logp"]), atol=1e-5,
                               rtol=0)


GEN_MODES = {  # name: (engine kwargs, inflight)
    "static": (dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4), False),
    "serving": (dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4), True),
    "paged2": (dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=0), True),
}


@pytest.mark.parametrize("mode", sorted(GEN_MODES))
def test_greedy_generation_matches_jax(weights, mode):
    """5 requests through 2 slots, greedy: the JAX engine's tokens, its
    logprobs within 5e-4.  The static path runs prefill + decode_step
    (K1f and K4 on the card), the serving plane decode_step_ragged_paged
    (K2), the two-program path prefill_into_pages + decode_step_paged
    (K3's Q=1 entry point)."""
    pj, pt = weights
    jc, tc = _cfgs()
    ekw, inflight = GEN_MODES[mode]
    ekw = dict(max_decode_batch=2, **ekw)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    js, ts = _samples(LENS)
    je = JEngine(jc, pj, mesh, eos_token_id=EOS, **ekw)
    te = GeneratorEngine(tc, pt, "cpu", eos_token_id=EOS, **ekw)
    g = dict(n=1, max_new_tokens=10, greedy=True)
    oj = je.generate(js, JSpec(), JGen(**g), inflight=inflight)
    ot = te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g), inflight=inflight)
    _assert_same(oj, ot, atol=LOGP_TOL)


def test_train_batch_matches_jax(weights, rng):
    """Two train_batch steps of the PPO actor loss: the loss and stats
    rtol 1e-5, the norms rtol 1e-4, the weights after each step within
    lr/100 of JAX's."""
    pj, _ = weights
    w = jax.tree.map(np.asarray, pj)
    lr = 1e-3
    oc = dict(lr=lr, warmup_steps_proportion=0.0, gradient_clipping=1.0, weight_decay=0.05)
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    jc, tc = _cfgs()
    je = JTrainEngine(jc, jax.tree.map(jnp.array, w), mesh,
                      optimizer_config=JOptimizerConfig(**oc), ftspec=JFinetuneSpec(1, 8, 8))
    te = TrainEngine(tc, params_from_numpy(w, device="cpu"), "cpu",
                     optimizer_config=OptimizerConfig(**oc), ftspec=FinetuneSpec(1, 8, 8))
    for _ in range(2):
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


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "math.jsonl"
    with open(path, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return str(path)


def test_quickstart_step_matches_jax(tmp_path, weights, data_path, monkeypatch, capsys):
    """One ppo-math step from a JAX-written gemma checkpoint at head_dim
    256, with a ref model and KL control, greedy, the query-id reward and
    a critic from the same checkpoint (tests/test_torch_hf_families.py's
    case): the graded tokens equal, every actor_train and critic_train
    stat within rtol 1e-4, atol 1e-6, and the saved actor a gemma
    checkpoint."""
    from areal_tpu.api.config import ModelAbstraction as JModel
    from areal_tpu.api.config import ModelInterfaceAbstraction as JInterface
    from areal_tpu.apps import quickstart as jquickstart
    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from tests.test_torch_experiments import _PARITY_REWARD, _SEEN

    jcfg, _ = _cfgs()
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jcfg, weights[0], model_type="gemma")
    for mod, interface, model in ((jquickstart.exps, JInterface, JModel),
                                  (quickstart.exps, ModelInterfaceAbstraction, ModelAbstraction)):
        def build(cfg, *a, _real=mod.build_ppo_math, _interface=interface, _model=model, **k):
            cfg = dataclasses.replace(
                cfg, gconfig=cfg.gconfig.new(greedy=True),
                reward_interface=_interface(_PARITY_REWARD),
                critic=_model("hf", {"path": ckpt, "is_critic": True}))
            return _real(cfg, *a, **k)

        monkeypatch.setattr(mod, "build_ppo_math", build)
    _SEEN["jax"].clear()
    _SEEN["port"].clear()

    def argv(root):
        return ["ppo-math", "--model.path", ckpt, "--dataset.path", data_path,
                "--tokenizer-path", "char:512", "--batch-size", "4", "--group-size", "2",
                "--max-new-tokens", "8", "--benchmark-steps", "1", "--fileroot", str(root),
                "--ref-path", ckpt, "--kl-ctl", "0.1", "--save-freq-steps", "1"]

    capsys.readouterr()
    jquickstart.main(argv(tmp_path / "jax"))
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tstats = quickstart.main(argv(tmp_path / "port"), device="cpu")
    assert len(tstats) == 1
    (tids, ttoks), (jids, jtoks) = _SEEN["port"][0], _SEEN["jax"][0]
    assert tids == jids
    np.testing.assert_array_equal(ttoks, jtoks)
    keys = [k for k in tstats[0] if k.split("/")[0] in ("actor_train", "critic_train")
            and "/perf/" not in k and "/time/" not in k]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_allclose(tstats[0][k], jstats[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert tstats[0]["actor_train/grad_norm"] > 1e-3
    saved = tmp_path / "port" / "checkpoints" / "ppo-math" / "trial0" / "actor@0" / "step_1"
    assert hf.load_hf_config(str(saved))["model_type"] == "gemma"


# ---------------- the kernel wrappers' head dims ----------------


@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
def test_wrappers_take_head_dims_64_128_256(d):
    """Every attention kernel's wrapper takes head_dim 64, 128 and 256
    (the flash kernels' check and the paged kernels' shared one) and
    refuses any other with a message naming ROADMAP queue 1 item 9.3."""
    q = torch.zeros(1, 64, 2, d)
    kv = torch.zeros(1, 64, 1, d)
    seg = torch.ones(1, 64, dtype=torch.int32)
    pool = torch.zeros(2, 8, 1, d)
    checks = (lambda: rpa.check_head_dim(d),
              lambda: tfa._check_cuda(q, kv, kv, seg),
              lambda: rpa.check_paged_inputs(q[0], pool, pool, None, None, 3))
    for fn in checks:
        if d in (64, 128, 256):
            fn()
        else:
            with pytest.raises(ValueError, match="ROADMAP queue 1 item 9.3"):
                fn()
