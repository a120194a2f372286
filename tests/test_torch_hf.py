"""The port's HF checkpoint IO against the JAX package's and against the
`safetensors` and `transformers` packages (installed here; the port
needs neither): safetensors files both ways for F32, F16, BF16 and I64,
single and sharded checkpoints, tiny qwen2/llama models built in-process
(params equal to the JAX loader's bit for bit, logits within 2e-4 of
transformers'), cross-package round trips with tied and untied
embeddings and a critic, and gemma, the family not yet ported
(tests/test_torch_hf_families.py holds mistral, mixtral and gpt2)."""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch

from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu_torch.api.model_api import Model
from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.models.hf import safetensors_io
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        make = lambda *s: torch.randint(-2**40, 2**40, s, generator=g, dtype=dtype)  # noqa: E731
    return {"a.weight": make(3, 5), "b": make(7), "c.scalar": make(), "d.empty": make(0, 4),
            "e.f32": torch.randn(2, 3, generator=g)}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_writes_what_safetensors_reads(tmp_path, name):
    t = _tensors(DTYPES[name])
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(t, path, metadata={"format": "pt", "step": 3})
    _assert_same(st.load_file(path), t)
    with st.safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt", "step": "3"}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_reads_what_safetensors_writes(tmp_path, name):
    t = _tensors(DTYPES[name], seed=1)
    path = str(tmp_path / "x.safetensors")
    st.save_file(t, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    _assert_same(got, t)
    header, _ = safetensors_io.read_header(path)
    assert header["__metadata__"] == {"format": "pt"}


def test_misaligned_tensor_is_copied(tmp_path):
    """A file whose F32 tensor starts off a 4-byte boundary (allowed by
    the format) reads correctly."""
    a = torch.arange(3, dtype=torch.float16)
    b = torch.arange(5, dtype=torch.float32) + 0.5
    header = {"a": {"dtype": "F16", "shape": [3], "data_offsets": [0, 6]},
              "b": {"dtype": "F32", "shape": [5], "data_offsets": [6, 26]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "m.safetensors"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        f.write(a.numpy().tobytes() + b.numpy().tobytes())
    got = safetensors_io.load_file(str(path))
    assert torch.equal(got["a"], a) and torch.equal(got["b"], b)


# ---------------- tiny HF models built in-process ----------------


def _tiny_hf_model(family, tied):
    """tests/test_model.py's tiny llama/qwen2 oracle (no download)."""
    import transformers

    kw = dict(
        vocab_size=199, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=tied,
        attention_dropout=0.0,
    )
    torch.manual_seed(3)
    if family == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw))
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**kw))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_params_equal(port, jax_params):
    p = dict(_flat(params_to_numpy(port)))
    j = dict(_flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jax_params)))
    assert sorted(p) == sorted(j)
    for k in j:
        assert p[k].shape == j[k].shape, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


CASES = [("qwen2", False), ("qwen2", True), ("llama", False)]


@pytest.mark.parametrize("family,tied", CASES)
@pytest.mark.parametrize("dtype", ["float32", "default"])
def test_loader_equals_jax_loader(tmp_path, family, tied, dtype):
    """transformers' checkpoint of a tiny model: the port's params equal
    the JAX loader's exactly, in fp32 and in the config's dtype (bf16)."""
    _tiny_hf_model(family, tied).save_pretrained(str(tmp_path), safe_serialization=True)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (None, None)
    cfg, params = hf.load_hf_checkpoint(str(tmp_path), dtype=tdt, device="cpu")
    jcfg, jparams = jhf.load_hf_checkpoint(str(tmp_path), dtype=jdt)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ("lm_head" in params) == (not tied)
    _assert_params_equal(params, jparams)


@pytest.mark.parametrize("family,tied", CASES)
def test_logits_match_transformers(tmp_path, family, tied):
    model = _tiny_hf_model(family, tied).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, params = hf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(0).integers(0, 199, size=(1, 17))
    with torch.no_grad():
        want = model(torch.from_numpy(toks)).logits.numpy()
        got = tfm.forward(params, cfg, torch.from_numpy(toks),
                          torch.ones((1, 17), dtype=torch.long)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bin_checkpoint_loads_like_safetensors(tmp_path):
    model = _tiny_hf_model("qwen2", False)
    model.save_pretrained(str(tmp_path / "st"), safe_serialization=True)
    os.makedirs(tmp_path / "bin")
    torch.save(model.state_dict(), tmp_path / "bin" / "pytorch_model.bin")
    model.config.to_json_file(str(tmp_path / "bin" / "config.json"))
    _, a = hf.load_hf_checkpoint(str(tmp_path / "st"), dtype=torch.float32, device="cpu")
    _, b = hf.load_hf_checkpoint(str(tmp_path / "bin"), dtype=torch.float32, device="cpu")
    for (k, x), (_, y) in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y), k


# ---------------- cross-package round trips ----------------


def _configs(kind):
    j, t = jtiny(), ttiny()
    if kind == "tied":
        j, t = dataclasses.replace(j, tied_embeddings=True), dataclasses.replace(t, tied_embeddings=True)
    elif kind == "critic":
        j, t = jtiny(is_critic=True), ttiny(is_critic=True)
    return j, t


KINDS = ["untied", "tied", "critic"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shard_bytes", [None, 60_000])
def test_jax_saves_port_loads(tmp_path, kind, shard_bytes):
    jcfg, tcfg = _configs(kind)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    kw = {} if shard_bytes is None else {"max_shard_bytes": shard_bytes}
    jhf.save_hf_checkpoint(str(tmp_path), jcfg, jparams, model_type="qwen2", **kw)
    if shard_bytes is not None:
        assert os.path.exists(tmp_path / "model.safetensors.index.json")
    cfg, params = hf.load_hf_checkpoint(str(tmp_path), is_critic=tcfg.is_critic,
                                        dtype=torch.float32, device="cpu")
    assert dataclasses.replace(cfg, param_dtype="float32") == tcfg
    _assert_params_equal(params, jparams)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shard_bytes", [None, 60_000])
def test_port_saves_jax_loads(tmp_path, kind, shard_bytes):
    jcfg, tcfg = _configs(kind)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = {} if shard_bytes is None else {"max_shard_bytes": shard_bytes}
    hf.save_hf_checkpoint(str(tmp_path / "port"), tcfg, params, model_type="qwen2", **kw)
    jhf.save_hf_checkpoint(str(tmp_path / "jax"), jcfg, jparams, model_type="qwen2", **kw)
    for name in ("config.json",) + (("model.safetensors.index.json",) if shard_bytes else ()):
        with open(tmp_path / "port" / name) as a, open(tmp_path / "jax" / name) as b:
            assert json.load(a) == json.load(b), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    _, back = jhf.load_hf_checkpoint(str(tmp_path / "port"), is_critic=jcfg.is_critic,
                                     dtype=jnp.float32)
    _assert_params_equal(params, back)
    for f in os.listdir(tmp_path / "port"):
        if f.endswith(".safetensors"):  # every tensor fp32, as JAX writes
            assert {v.dtype for v in st.load_file(str(tmp_path / "port" / f)).values()} == {
                torch.float32}


@pytest.mark.parametrize("critic", [False, True])
def test_interface_save_writes_a_checkpoint_jax_reads(tmp_path, critic):
    """PPOActorInterface.save / PPOCriticInterface.save (through
    SFTInterface.save): the engine's weights, the critic's value head
    included."""
    cfg = ttiny(is_critic=critic)
    params = tfm.init_params(cfg, 4, device="cpu")

    class _Engine:
        def get_params(self):
            return params

    iface = PPOCriticInterface() if critic else PPOActorInterface()
    iface.save(Model("m", _Engine(), None, cfg), str(tmp_path))
    _, back = jhf.load_hf_checkpoint(str(tmp_path), is_critic=critic, dtype=jnp.float32)
    _assert_params_equal(params, back)
    assert ("value_head" in back) == critic


@pytest.mark.parametrize("package", ["jax", "port"])
def test_unknown_model_type_raises(tmp_path, package):
    """Every HF family of the JAX package is ported; a `model_type` that
    neither package knows raises KeyError in both, from the family
    lookup, the loader and the writer."""
    assert set(hf.HF_FAMILIES) == set(jhf.HF_FAMILIES)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "falcon"}, f)
    out = str(tmp_path / "out")
    if package == "jax":
        jcfg = jtiny()
        with pytest.raises(KeyError):
            jhf.HF_FAMILIES["falcon"]
        with pytest.raises(KeyError):
            jhf.load_hf_checkpoint(str(tmp_path))
        with pytest.raises(KeyError):
            jhf.save_hf_checkpoint(out, jcfg, jtfm.init_params(jcfg, jax.random.PRNGKey(0)),
                                   model_type="falcon")
    else:
        cfg = ttiny()
        with pytest.raises(KeyError, match="falcon"):
            hf.get_family("falcon")
        with pytest.raises(KeyError, match="falcon"):
            hf.load_hf_checkpoint(str(tmp_path), device="cpu")
        with pytest.raises(KeyError, match="falcon"):
            hf.save_hf_checkpoint(out, cfg, tfm.init_params(cfg, 0, device="cpu"),
                                  model_type="falcon")


def test_loader_runs_on_the_card_unless_told(tmp_path):
    cfg = ttiny()
    hf.save_hf_checkpoint(str(tmp_path), cfg, tfm.init_params(cfg, 0, device="cpu"))
    if torch.cuda.is_available():
        assert hf.load_hf_checkpoint(str(tmp_path))[1]["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hf.load_hf_checkpoint(str(tmp_path))
