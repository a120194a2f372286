"""HuggingFace checkpoint conversion (port of areal_tpu/models/hf/registry.py,
the llama and qwen2 families).

Config <-> config.json and state dict <-> the layer-stacked params dict,
and checkpoint directories of safetensors shards (`safetensors_io`, since
the port needs no `safetensors` package) or torch `.bin` files.  Loading
streams each tensor from the file's map straight into its slot of the
stacked tensor on the target device and dtype, so a load holds one
device copy and no host copy of the model.  Saving writes fp32, as the
JAX package does, and splits a state dict larger than `max_shard_bytes`
into `model-XXXXX-of-YYYYY.safetensors` shards plus
`model.safetensors.index.json`.

gemma, gpt2, mistral and mixtral are not yet ported (ROADMAP queue 1,
item 9): naming one raises NotImplementedError.
"""

import json
import logging
import os
from typing import Any, Callable, Dict, Optional

import torch

from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.models.hf import safetensors_io

logger = logging.getLogger("areal_tpu_torch.hf_registry")

Params = Dict[str, Any]


class HFFamily:
    def __init__(
        self,
        name: str,
        config_from_hf: Callable[[dict], ModelConfig],
        config_to_hf: Callable[[ModelConfig], dict],
    ):
        self.name = name
        self.config_from_hf = config_from_hf
        self.config_to_hf = config_to_hf


HF_FAMILIES: Dict[str, HFFamily] = {}
UNPORTED_FAMILIES = ("gemma", "gpt2", "mistral", "mixtral")


def register_hf_family(family: HFFamily) -> None:
    HF_FAMILIES[family.name] = family


def get_family(model_type: str) -> HFFamily:
    if model_type in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"the {model_type} HF family is not yet ported (ROADMAP queue 1, item 9)"
        )
    if model_type not in HF_FAMILIES:
        raise KeyError(f"unknown HF model_type {model_type!r}")
    return HF_FAMILIES[model_type]


# ---------------- llama / qwen2 ----------------


def _llama_like_config_from_hf(hf: dict) -> ModelConfig:
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return ModelConfig(
        n_layers=hf["num_hidden_layers"],
        hidden_dim=hf["hidden_size"],
        n_q_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        qkv_bias=hf["model_type"] == "qwen2",
        tied_embeddings=hf.get("tie_word_embeddings", False),
    )


def _llama_like_config_to_hf(cfg: ModelConfig, model_type: str) -> dict:
    return {
        "model_type": model_type,
        "num_hidden_layers": cfg.n_layers,
        "hidden_size": cfg.hidden_dim,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tied_embeddings,
        "torch_dtype": "bfloat16",
        "architectures": [
            "LlamaForCausalLM" if model_type == "llama" else "Qwen2ForCausalLM"
        ],
    }


register_hf_family(HFFamily(
    "llama", _llama_like_config_from_hf, lambda cfg: _llama_like_config_to_hf(cfg, "llama"),
))
register_hf_family(HFFamily(
    "qwen2", _llama_like_config_from_hf, lambda cfg: _llama_like_config_to_hf(cfg, "qwen2"),
))


# ---------------- state dict conversion (llama-like naming) ----------------

_LAYER = "model.layers.{}."
# (params key, HF name under the layer prefix, transposed: HF linears are
# [out, in], the port's are [in, out])
_BLOCK_TENSORS = (
    ("ln1", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("ln2", "post_attention_layernorm.weight", False),
    ("wg", "mlp.gate_proj.weight", True),
    ("wu", "mlp.up_proj.weight", True),
    ("wd", "mlp.down_proj.weight", True),
)
_BIAS_TENSORS = (
    ("bq", "self_attn.q_proj.bias"),
    ("bk", "self_attn.k_proj.bias"),
    ("bv", "self_attn.v_proj.bias"),
)


def params_from_hf_state_dict(
    cfg: ModelConfig, sd: Dict[str, torch.Tensor], dtype=None, device=None
) -> Params:
    """HF tensors (host tensors, e.g. views of a mapped file) -> the
    layer-stacked params on `device` (the CUDA card unless told
    otherwise) in `dtype` (default: the config's).  Each layer's tensor
    is copied into its slot of the stacked tensor on the device, cast
    and transposed on the way."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def get(name):
        if name not in sd:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        return sd[name]

    def one(name, transpose=False):
        src = get(name)
        src = src.t() if transpose else src
        out = torch.empty(src.shape, dtype=dtype, device=device)
        return out.copy_(src)

    def stack(name, transpose):
        first = get(_LAYER.format(0) + name)
        shape = first.shape[::-1] if transpose else first.shape
        out = torch.empty((cfg.n_layers, *shape), dtype=dtype, device=device)
        for i in range(cfg.n_layers):
            src = get(_LAYER.format(i) + name)
            out[i].copy_(src.t() if transpose else src)
        return out

    blocks = {key: stack(name, tr) for key, name, tr in _BLOCK_TENSORS}
    if cfg.qkv_bias:
        blocks.update({key: stack(name, False) for key, name in _BIAS_TENSORS})
    params: Params = {
        "embed": one("model.embed_tokens.weight"),
        "blocks": blocks,
        "final_ln": one("model.norm.weight"),
    }
    if cfg.is_critic:
        if "value_head.weight" in sd:
            # The port's and the JAX package's own critic checkpoints
            # carry the trained head.
            params["value_head"] = one("value_head.weight")
        else:
            # A critic built from an actor's checkpoint: a fresh head.
            params["value_head"] = torch.zeros((cfg.hidden_dim, 1), dtype=dtype, device=device)
    elif not cfg.tied_embeddings:
        params["lm_head"] = one("lm_head.weight", transpose=True)
    return params


def params_to_hf_state_dict(cfg: ModelConfig, params: Params) -> Dict[str, torch.Tensor]:
    """The params -> HF-named fp32 host tensors, each contiguous."""

    def host(x):
        return x.detach().to("cpu", torch.float32)

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_ln"]),
    }
    if cfg.is_critic:
        # Not an HF key: kept so a critic checkpoint round-trips its head.
        out["value_head.weight"] = host(params["value_head"])
    elif not cfg.tied_embeddings:
        out["lm_head.weight"] = host(params["lm_head"]).t().contiguous()
    blocks = params["blocks"]
    tensors = list(_BLOCK_TENSORS)
    if cfg.qkv_bias:
        tensors += [(key, name, False) for key, name in _BIAS_TENSORS]
    for key, name, transpose in tensors:
        arr = host(blocks[key])
        for i in range(cfg.n_layers):
            out[_LAYER.format(i) + name] = arr[i].t().contiguous() if transpose else arr[i]
    return out


def infer_model_type(cfg: ModelConfig) -> str:
    """Best-fit HF family for a ModelConfig (the save path's default)."""
    if cfg.norm_type == "layernorm":
        return "gpt2"
    if cfg.is_moe:
        return "mixtral"
    if cfg.rms_norm_offset:
        return "gemma"
    if cfg.qkv_bias:
        return "qwen2"
    return "llama"


# ---------------- checkpoint IO ----------------


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_model_config(path: str, is_critic: bool = False) -> ModelConfig:
    """Config-only load (no weights)."""
    hf_cfg = load_hf_config(path)
    cfg = get_family(hf_cfg["model_type"]).config_from_hf(hf_cfg)
    return cfg.as_critic() if is_critic else cfg


def load_hf_checkpoint(
    path: str, is_critic: bool = False, dtype=None, device=None
) -> "tuple[ModelConfig, Params]":
    """Load an HF checkpoint dir (safetensors shards, else torch `.bin`
    files) onto `device` (the CUDA card unless told otherwise)."""
    hf_cfg = load_hf_config(path)
    family = get_family(hf_cfg["model_type"])
    cfg = family.config_from_hf(hf_cfg)
    if is_critic:
        cfg = cfg.as_critic()
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            sd.update(safetensors_io.load_file(os.path.join(path, f)))
    else:
        bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
        if not bins:
            raise FileNotFoundError(f"no safetensors/bin shards in {path}")
        for f in bins:
            sd.update(torch.load(
                os.path.join(path, f), map_location="cpu", weights_only=True, mmap=True,
            ))
    params = params_from_hf_state_dict(cfg, sd, dtype=dtype, device=device)
    logger.info(f"loaded HF checkpoint from {path} ({hf_cfg['model_type']})")
    return cfg, params


def save_hf_checkpoint(
    path: str,
    cfg: ModelConfig,
    params: Params,
    model_type: str = "qwen2",
    tokenizer=None,
    max_shard_bytes: int = 5 * 1024**3,
) -> None:
    """Write an HF-format checkpoint dir (fp32 safetensors + config.json)
    that the JAX package, transformers and serving engines read."""
    family = get_family(model_type)
    sd = params_to_hf_state_dict(cfg, params)
    os.makedirs(path, exist_ok=True)
    nbytes = {k: v.numel() * v.element_size() for k, v in sd.items()}
    total = sum(nbytes.values())
    if total <= max_shard_bytes:
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    else:
        shards: list = [[]]
        size = 0
        for k in sd:
            if size + nbytes[k] > max_shard_bytes and shards[-1]:
                shards.append([])
                size = 0
            shards[-1].append(k)
            size += nbytes[k]
        n = len(shards)
        weight_map = {}
        for i, keys in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            safetensors_io.save_file({k: sd[k] for k in keys}, os.path.join(path, fname))
            weight_map.update({k: fname for k in keys})
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(family.config_to_hf(cfg), f, indent=2)
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(path)
