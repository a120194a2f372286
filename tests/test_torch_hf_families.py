"""The port's mistral, gemma, mixtral and gpt2 HF families against the JAX
package's and against `transformers` (installed here; the port needs
neither), fp32 on the CPU:

- configs both ways equal the JAX package's (dataclass and dict), with
  the JAX reader's pinned behaviours: mixtral's `router_aux_loss_coef`
  is not read, mistral's `sliding_window` is dropped (written as null);
- state dicts equal across the packages both ways, bit for bit and in
  the JAX package's key order; gpt2's `transformer.` prefix accepted on
  load and not written on save;
- a checkpoint directory written by either package loads in the other;
- the port's forward within 2e-4 of the tiny `transformers` models of
  tests/test_model.py:345-427 (mixtral on the dense oracle, as there;
  the grouped dispatch within 2e-4 too);
- one tiny `quickstart ppo-math` step from a gemma, a mixtral and a gpt2
  checkpoint through both packages' CLI, with a critic: graded tokens
  equal, every actor_train and critic_train stat within rtol 1e-4, atol
  1e-6 (the parity case of tests/test_torch_experiments.py)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from tests import fixtures
from tests.test_model import _tiny_hf_model

torch.set_num_threads(2)

FAMILIES = ("mistral", "gemma", "mixtral", "gpt2")
HF_TOL = 2e-4


def _hf_config(model):
    return json.loads(model.config.to_json_string())


@pytest.fixture(scope="module")
def hf_models():
    torch.manual_seed(0)
    out = {}
    for fam in FAMILIES:
        m = _tiny_hf_model(fam)
        m.eval()
        out[fam] = m
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_params_equal(port_params, jax_params):
    got = _flat(params_to_numpy(port_params))
    want = {k: np.asarray(v) for k, v in _flat(jax_params).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _assert_sd_equal(port_sd, jax_sd):
    assert list(port_sd) == list(jax_sd)  # the JAX package's key order
    for k in jax_sd:
        t = port_sd[k]
        assert t.dtype == torch.float32 and t.is_contiguous(), k
        assert np.array_equal(t.numpy(), np.asarray(jax_sd[k])), k


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_match_jax(hf_models, family):
    hcfg = _hf_config(hf_models[family])
    got = hf.get_family(family).config_from_hf(hcfg)
    want = jhf.HF_FAMILIES[family].config_from_hf(hcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hf.get_family(family).config_to_hf(got) == jhf.HF_FAMILIES[family].config_to_hf(want)
    assert hf.infer_model_type(got) == jhf.infer_model_type(want)
    back = hf.get_family(family).config_from_hf(hf.get_family(family).config_to_hf(got))
    assert back == got


def test_pinned_config_behaviours():
    """Copied from the JAX reader: Mixtral-8x7B's router_aux_loss_coef
    0.02 is not read (the aux coefficient stays 0.001), and mistral's
    sliding window is not modeled (dropped on load, null on save)."""
    import transformers

    mix = json.loads(transformers.MixtralConfig(router_aux_loss_coef=0.02).to_json_string())
    cfg = hf.get_family("mixtral").config_from_hf(mix)
    assert cfg.moe_aux_loss_coef == 0.001
    assert cfg.moe_aux_loss_coef == jhf.HF_FAMILIES["mixtral"].config_from_hf(mix).moe_aux_loss_coef
    mis = json.loads(transformers.MistralConfig(sliding_window=4096).to_json_string())
    cfg = hf.get_family("mistral").config_from_hf(mis)
    assert not cfg.qkv_bias and "sliding" not in json.dumps(dataclasses.asdict(cfg))
    assert hf.get_family("mistral").config_to_hf(cfg)["sliding_window"] is None


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dicts_match_jax_both_ways(hf_models, family):
    """transformers' tensors -> params (the JAX loader's bit for bit) ->
    HF tensors (the JAX writer's bit for bit, in its order)."""
    hcfg = _hf_config(hf_models[family])
    cfg = hf.get_family(family).config_from_hf(hcfg)
    jcfg = jhf.HF_FAMILIES[family].config_from_hf(hcfg)
    sd = {k: v.detach().float().contiguous() for k, v in hf_models[family].state_dict().items()}
    params = hf.get_family(family).params_from_sd(cfg, sd, dtype=torch.float32, device="cpu")
    jparams = jhf.HF_FAMILIES[family].params_from_sd(
        jcfg, {k: v.numpy() for k, v in sd.items()}, dtype=jnp.float32)
    _assert_params_equal(params, jparams)
    _assert_sd_equal(hf.get_family(family).params_to_sd(cfg, params),
                     jhf.HF_FAMILIES[family].params_to_sd(jcfg, jparams))


def test_gpt2_prefix_on_load_not_on_save(hf_models):
    m = hf_models["gpt2"]
    cfg = hf.get_family("gpt2").config_from_hf(_hf_config(m))
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    assert any(k.startswith("transformer.") for k in sd)
    bare = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    a = hf.get_family("gpt2").params_from_sd(cfg, sd, dtype=torch.float32, device="cpu")
    b = hf.get_family("gpt2").params_from_sd(cfg, bare, dtype=torch.float32, device="cpu")
    for k, v in _flat(a).items():
        assert torch.equal(v, _flat(b)[k]), k
    out = hf.get_family("gpt2").params_to_sd(cfg, a)
    assert not any(k.startswith("transformer.") or k.startswith("lm_head") for k in out)
    critic = hf.get_family("gpt2").params_from_sd(cfg.as_critic(), sd, dtype=torch.float32,
                                                  device="cpu")
    assert torch.equal(critic["value_head"], torch.zeros(cfg.hidden_dim, 1))


def _tiny(family):
    """A tiny config of each family (vocab 512 for the char tokenizer)."""
    base = jtiny()
    if family == "mistral":
        return dataclasses.replace(base, qkv_bias=False)
    if family == "mixtral":
        return dataclasses.replace(jtiny(n_experts=4), qkv_bias=False)
    if family == "gemma":  # tests/test_torch_gemma.py runs its head_dim of 256
        return dataclasses.replace(jhf.HF_FAMILIES["gemma"].config_from_hf(dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128, vocab_size=512, max_position_embeddings=256)),
            param_dtype="float32")
    return dataclasses.replace(jhf.HF_FAMILIES["gpt2"].config_from_hf(dict(
        n_layer=2, n_embd=64, n_head=4, n_inner=128, vocab_size=512, n_positions=256,
        layer_norm_epsilon=1e-5)), param_dtype="float32")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_dirs_cross_load(tmp_path, family, writer):
    """A directory written by one package loads in the other: config and
    every leaf bit for bit (fp32 files)."""
    jcfg = _tiny(family)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jhf.save_hf_checkpoint(path, jcfg, jparams, model_type=family)
        cfg, params = hf.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jhf.load_model_config(path))
        _assert_params_equal(params, jparams)
    else:
        tcfg = hf.get_family(family).config_from_hf(jhf.HF_FAMILIES[family].config_to_hf(jcfg))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        hf.save_hf_checkpoint(path, tcfg, params, model_type=family)
        cfg, back = jhf.load_hf_checkpoint(path, dtype=jnp.float32)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        _assert_params_equal(params, back)


def test_mixtral_sharded_checkpoint_streams(tmp_path):
    """A mixtral state dict past the shard cap writes shards and an
    index, and loads back bit for bit (each expert streamed to its slot)."""
    jcfg = _tiny("mixtral")
    params = params_from_numpy(jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.PRNGKey(6))), device="cpu")
    tcfg = hf.get_family("mixtral").config_from_hf(jhf.HF_FAMILIES["mixtral"].config_to_hf(jcfg))
    hf.save_hf_checkpoint(str(tmp_path), tcfg, params, model_type="mixtral",
                          max_shard_bytes=200_000)
    assert len(list(tmp_path.glob("model-*-of-*.safetensors"))) > 2
    cfg, back = hf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert cfg == tcfg
    for k, v in _flat(params).items():
        assert torch.equal(_flat(back)[k], v), k


@pytest.mark.parametrize("family,dispatch", [
    ("mistral", None), ("gemma", None), ("mixtral", "dense"), ("mixtral", "grouped"),
    ("gpt2", None)])
def test_forward_matches_transformers(hf_models, rng, family, dispatch):
    m = hf_models[family]
    cfg = hf.get_family(family).config_from_hf(_hf_config(m))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    params = hf.get_family(family).params_from_sd(cfg, sd, dtype=torch.float32, device="cpu")
    toks = rng.integers(0, 199, size=(1, 17)).astype(np.int64)
    with torch.no_grad():
        want = m(torch.from_numpy(toks)).logits.numpy()
        got = tfm.forward(params, cfg, torch.from_numpy(toks), torch.ones(1, 17, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "math.jsonl"
    with open(path, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return str(path)


@pytest.mark.parametrize("family", ["gemma", "mixtral", "gpt2"])
def test_quickstart_step_matches_jax(tmp_path, data_path, monkeypatch, capsys, family):
    """One ppo-math step from a JAX-written checkpoint of the family, with
    a ref model and KL control, greedy, the query-id reward and a critic
    from the same checkpoint (set by wrapping build_ppo_math, as the CLI
    has no flag for it: with GRPO and greedy groups the advantages cancel
    and leave only rounding to train on): the graded tokens equal, every
    actor_train and critic_train stat (the actor's loss with mixtral's
    aux in it) within rtol 1e-4, atol 1e-6 (tests/test_torch_experiments.py's
    parity case), and the saved actor a checkpoint of the family."""
    from areal_tpu.api.config import ModelAbstraction as JModel
    from areal_tpu.api.config import ModelInterfaceAbstraction as JInterface
    from areal_tpu.apps import quickstart as jquickstart
    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from tests.test_torch_experiments import _PARITY_REWARD, _SEEN

    jcfg = _tiny(family)
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jcfg, jtfm.init_params(jcfg, jax.random.PRNGKey(11)),
                           model_type=family)
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
    assert len(_SEEN["port"]) == len(_SEEN["jax"]) == 1
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
    assert hf.load_hf_config(str(saved))["model_type"] == family
