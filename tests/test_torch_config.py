"""The port's model config equals the JAX package's field for field, and
one set of weights passes between the two packages exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from areal_tpu.models import config as jcfg
from areal_tpu.models import transformer as jtfm
from areal_tpu_torch.models import config as tcfg
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

PRESETS = [
    ("tiny_config", ()),
    ("qwen2_config", ("1.5b",)),
    ("qwen2_config", ("7b",)),
    ("qwen2_config", ("32b",)),
    ("llama_config", ("7b",)),
    ("llama_config", ("8b",)),
]


def test_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.ModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.ModelConfig)}
    assert jf == tf


@pytest.mark.parametrize("fn,args", PRESETS)
def test_presets_match(fn, args):
    j = getattr(jcfg, fn)(*args)
    t = getattr(tcfg, fn)(*args)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.q_dim, t.kv_dim, t.is_moe) == (j.q_dim, j.kv_dim, j.is_moe)


def test_dtype_map():
    assert tcfg.tiny_config().dtype == torch.float32
    assert tcfg.qwen2_config("1.5b").dtype == torch.bfloat16
    assert tcfg.tiny_config(param_dtype="float16").dtype == torch.float16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize(
    "variant",
    [{}, {"tied_embeddings": True}, {"norm_type": "layernorm", "proj_bias": True}],
)
def test_init_params_layout_matches(variant):
    """Same keys, shapes and dtypes as the JAX package's init_params."""
    cfg_j = dataclasses.replace(jcfg.tiny_config(), **variant)
    cfg_t = dataclasses.replace(tcfg.tiny_config(), **variant)
    pj = _leaves(jtfm.init_params(cfg_j, jax.random.PRNGKey(0)))
    pt = _leaves(ttfm.init_params(cfg_t, seed=0, device="cpu"))
    assert pj.keys() == pt.keys()
    for k in pj:
        assert tuple(pj[k].shape) == tuple(pt[k].shape), k
        assert pt[k].dtype == torch.float32


def test_init_params_seeded():
    cfg = tcfg.tiny_config()
    a, b, c = (ttfm.init_params(cfg, seed=s, device="cpu") for s in (3, 3, 4))
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert not torch.equal(a["blocks"]["wq"], c["blocks"]["wq"])
    # Truncated normal at fan-in scale, like the JAX package.
    w = a["blocks"]["wg"]
    assert float(w.abs().max()) <= 2.0 * cfg.hidden_dim**-0.5 + 1e-6


def test_params_numpy_roundtrip_exact():
    cfg = jcfg.tiny_config()
    pj = jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.PRNGKey(5)))
    pt = params_from_numpy(pj, device="cpu")
    back = params_to_numpy(pt)
    lj, lb = _leaves(pj), _leaves(back)
    assert lj.keys() == lb.keys()
    for k in lj:
        np.testing.assert_array_equal(lj[k], lb[k])
    # bf16 leaves widen to float32 and come back exactly.
    pb = params_from_numpy(pj, device="cpu", dtype=torch.bfloat16)
    again = params_from_numpy(params_to_numpy(pb), device="cpu", dtype=torch.bfloat16)
    assert torch.equal(pb["embed"], again["embed"])
