"""HuggingFace checkpoint conversion (port of areal_tpu/models/hf/registry.py:
the llama, qwen2, mistral, gemma, mixtral and gpt2 families).

Config <-> config.json and state dict <-> the layer-stacked params dict,
and checkpoint directories of safetensors shards (`safetensors_io`, since
the port needs no `safetensors` package) or torch `.bin` files.  Loading
streams each tensor from the file's map straight into its slot of the
stacked tensor on the target device and dtype, so a load holds one
device copy and no host copy of the model.  Saving writes fp32, as the
JAX package does, and splits a state dict larger than `max_shard_bytes`
into `model-XXXXX-of-YYYYY.safetensors` shards plus
`model.safetensors.index.json`.

- mistral: llama's naming without qkv bias; sliding-window attention is
  not modeled (full causal attention, exact within the window), as in
  the JAX package.
- mixtral: llama's attention and norms; the router
  (`block_sparse_moe.gate`) and the experts (`experts.{e}.w1/w3/w2` ->
  `wg`/`wu`/`wd`, stacked [L, E, ...]).  `router_aux_loss_coef` is not
  read (the config keeps its 0.001), as in the JAX package.
- gemma: llama's naming without `lm_head` (embeddings always tied);
  head_dim is read from `head_dim` (256 for Gemma-2B and -7B, whose
  query width need not be the hidden width); the norm weights are
  written and read raw (the model applies `1 + w`); the MLP is always
  gelu_tanh, whatever `hidden_act` says, and the embeddings are scaled
  by sqrt(hidden) in fp32, as in the JAX package.
- gpt2: learned positions, LayerNorm with biases, the fused `c_attn`
  split into q/k/v, Conv1D weights kept as [in, out]; tensors load with
  or without the `transformer.` prefix and save without it.

An unknown `model_type` raises KeyError.
"""

import dataclasses
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
        # State-dict converters; None = the llama-like naming.
        params_from_sd: Optional[Callable] = None,
        params_to_sd: Optional[Callable] = None,
    ):
        self.name = name
        self.config_from_hf = config_from_hf
        self.config_to_hf = config_to_hf
        self._params_from_sd = params_from_sd
        self._params_to_sd = params_to_sd

    def params_from_sd(self, cfg, sd, dtype=None, device=None) -> Params:
        fn = self._params_from_sd or params_from_hf_state_dict
        return fn(cfg, sd, dtype=dtype, device=device)

    def params_to_sd(self, cfg, params) -> Dict[str, torch.Tensor]:
        fn = self._params_to_sd or params_to_hf_state_dict
        return fn(cfg, params)


HF_FAMILIES: Dict[str, HFFamily] = {}


def register_hf_family(family: HFFamily) -> None:
    HF_FAMILIES[family.name] = family


def get_family(model_type: str) -> HFFamily:
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
_MLP_KEYS = ("wg", "wu", "wd")  # the dense MLP's (mixtral has experts instead)
_BIAS_TENSORS = (
    ("bq", "self_attn.q_proj.bias"),
    ("bk", "self_attn.k_proj.bias"),
    ("bv", "self_attn.v_proj.bias"),
)


class _Reader:
    """Streams HF tensors (host tensors, e.g. views of a mapped file)
    into device tensors: each goes to `device` as it lies in the file
    (one contiguous copy) and is cast and transposed there, into its slot
    of the output."""

    def __init__(self, sd: Dict[str, torch.Tensor], dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, device

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        if name not in self.sd:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        src = self.sd[name].to(self.device)
        return src.t() if transpose else src

    def empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def one(self, name: str, transpose: bool = False) -> torch.Tensor:
        src = self.get(name, transpose)
        return self.empty(src.shape).copy_(src)

    def stack(self, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
        """[n, ...] from the tensors named fmt.format(0 .. n-1)."""
        first = self.get(fmt.format(0), transpose)
        out = self.empty((n, *first.shape))
        out[0].copy_(first)
        for i in range(1, n):
            out[i].copy_(self.get(fmt.format(i), transpose))
        return out


def params_from_hf_state_dict(
    cfg: ModelConfig, sd: Dict[str, torch.Tensor], dtype=None, device=None,
    skip_mlp: bool = False,
) -> Params:
    """HF tensors (host tensors, e.g. views of a mapped file) -> the
    layer-stacked params on `device` (the CUDA card unless told
    otherwise) in `dtype` (default: the config's), streamed by `_Reader`.
    `skip_mlp` leaves out the dense MLP (mixtral reads its experts)."""
    rd = _Reader(sd, dtype or cfg.dtype, resolve_device(device))

    def stack(name, transpose):
        return rd.stack(_LAYER + name, cfg.n_layers, transpose)

    blocks = {key: stack(name, tr) for key, name, tr in _BLOCK_TENSORS
              if not (skip_mlp and key in _MLP_KEYS)}
    if cfg.qkv_bias:
        blocks.update({key: stack(name, False) for key, name in _BIAS_TENSORS})
    params: Params = {
        "embed": rd.one("model.embed_tokens.weight"),
        "blocks": blocks,
        "final_ln": rd.one("model.norm.weight"),
    }
    if cfg.is_critic:
        if "value_head.weight" in sd:
            # The port's and the JAX package's own critic checkpoints
            # carry the trained head.
            params["value_head"] = rd.one("value_head.weight")
        else:
            # A critic built from an actor's checkpoint: a fresh head.
            params["value_head"] = rd.empty((cfg.hidden_dim, 1)).zero_()
    elif not cfg.tied_embeddings:
        params["lm_head"] = rd.one("lm_head.weight", transpose=True)
    return params


def _host(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """fp32 on the host, contiguous: cast and transposed where the tensor
    lies (on the card, its copy engines and cores), then copied once."""
    x = x.detach().to(torch.float32)
    if transpose:
        x = x.transpose(-1, -2).contiguous()
    return x.to("cpu")


def params_to_hf_state_dict(
    cfg: ModelConfig, params: Params, skip_mlp: bool = False
) -> Dict[str, torch.Tensor]:
    """The params -> HF-named fp32 host tensors, each contiguous
    (`_host`).  `skip_mlp` leaves out the dense MLP (mixtral writes its
    experts)."""
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": _host(params["embed"]),
        "model.norm.weight": _host(params["final_ln"]),
    }
    if cfg.is_critic:
        # Not an HF key: kept so a critic checkpoint round-trips its head.
        out["value_head.weight"] = _host(params["value_head"])
    elif not cfg.tied_embeddings:
        out["lm_head.weight"] = _host(params["lm_head"], transpose=True)
    blocks = params["blocks"]
    tensors = [t for t in _BLOCK_TENSORS if not (skip_mlp and t[0] in _MLP_KEYS)]
    if cfg.qkv_bias:
        tensors += [(key, name, False) for key, name in _BIAS_TENSORS]
    for key, name, transpose in tensors:
        arr = _host(blocks[key], transpose)
        for i in range(cfg.n_layers):
            out[_LAYER.format(i) + name] = arr[i]
    return out


# ---------------- mistral ----------------
# Llama naming without qkv bias.  Sliding-window attention is not modeled
# (full causal attention: exact for sequences within the window).


def _mistral_config_from_hf(hf: dict) -> ModelConfig:
    return dataclasses.replace(_llama_like_config_from_hf(hf), qkv_bias=False)


def _mistral_config_to_hf(cfg: ModelConfig) -> dict:
    return {
        **_llama_like_config_to_hf(cfg, "mistral"),
        "model_type": "mistral",
        "architectures": ["MistralForCausalLM"],
        "sliding_window": None,
    }


register_hf_family(HFFamily("mistral", _mistral_config_from_hf, _mistral_config_to_hf))


# ---------------- gemma ----------------
# Llama naming, embeddings always tied (no lm_head).  `hidden_act` is not
# read: the MLP is gelu_tanh, as in the JAX package.


def _gemma_config_from_hf(hf: dict) -> ModelConfig:
    return ModelConfig(
        n_layers=hf["num_hidden_layers"],
        hidden_dim=hf["hidden_size"],
        n_q_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf["head_dim"],
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        tied_embeddings=True,
        hidden_act="gelu_tanh",  # gelu_pytorch_tanh
        rms_norm_offset=True,  # the norm scales by (1 + w)
        embed_scale=True,  # embeddings scaled by sqrt(hidden)
    )


def _gemma_config_to_hf(cfg: ModelConfig) -> dict:
    return {
        "model_type": "gemma",
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
        "tie_word_embeddings": True,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh",
        "torch_dtype": "bfloat16",
        "architectures": ["GemmaForCausalLM"],
    }


register_hf_family(HFFamily("gemma", _gemma_config_from_hf, _gemma_config_to_hf))


# ---------------- mixtral ----------------

_MOE = "model.layers.{}.block_sparse_moe"  # .format(layer)
# (params key, expert tensor): HF's [out, in] experts transpose to [in, out]
_EXPERT_TENSORS = (("wg", "w1"), ("wd", "w2"), ("wu", "w3"))


def _mixtral_config_from_hf(hf: dict) -> ModelConfig:
    return dataclasses.replace(
        _llama_like_config_from_hf(hf),
        qkv_bias=False,
        n_experts=hf["num_local_experts"],
        n_experts_per_tok=hf["num_experts_per_tok"],
        moe_intermediate_dim=hf["intermediate_size"],
    )


def _mixtral_config_to_hf(cfg: ModelConfig) -> dict:
    out = _llama_like_config_to_hf(cfg, "mixtral")
    out.update(
        model_type="mixtral",
        architectures=["MixtralForCausalLM"],
        num_local_experts=cfg.n_experts,
        num_experts_per_tok=cfg.n_experts_per_tok,
        intermediate_size=cfg.moe_intermediate_dim or cfg.intermediate_dim,
    )
    return out


def _mixtral_params_from_sd(cfg: ModelConfig, sd, dtype=None, device=None) -> Params:
    """Attention and norms by the llama naming; the router [L, D, E] and
    the experts stacked [L, E, ...], each expert tensor streamed into its
    slot out[i, e] on the device."""
    rd = _Reader(sd, dtype or cfg.dtype, resolve_device(device))
    params = params_from_hf_state_dict(cfg, sd, dtype=rd.dtype, device=rd.device, skip_mlp=True)
    blocks = params["blocks"]
    blocks["router"] = rd.stack(_MOE + ".gate.weight", cfg.n_layers, transpose=True)
    for key, name in _EXPERT_TENSORS:
        first = rd.get(f"{_MOE.format(0)}.experts.0.{name}.weight", transpose=True)
        out = rd.empty((cfg.n_layers, cfg.n_experts, *first.shape))
        for i in range(cfg.n_layers):
            for e in range(cfg.n_experts):
                out[i, e].copy_(rd.get(f"{_MOE.format(i)}.experts.{e}.{name}.weight", True))
        blocks[key] = out
    return params


def _mixtral_params_to_sd(cfg: ModelConfig, params: Params) -> Dict[str, torch.Tensor]:
    out = params_to_hf_state_dict(cfg, params, skip_mlp=True)
    blocks = params["blocks"]
    router = _host(blocks["router"], transpose=True)  # [L, E, D]
    experts = {name: _host(blocks[key], transpose=True) for key, name in _EXPERT_TENSORS}
    for i in range(cfg.n_layers):
        pre = _MOE.format(i)
        out[pre + ".gate.weight"] = router[i]
        for e in range(cfg.n_experts):
            for _, name in _EXPERT_TENSORS:
                out[f"{pre}.experts.{e}.{name}.weight"] = experts[name][i, e]
    return out


register_hf_family(HFFamily(
    "mixtral", _mixtral_config_from_hf, _mixtral_config_to_hf,
    params_from_sd=_mixtral_params_from_sd, params_to_sd=_mixtral_params_to_sd,
))


# ---------------- gpt2 ----------------
# Learned positions, LayerNorm with biases, the fused c_attn, a plain gelu
# MLP, biases everywhere; Conv1D weights are [in, out], the port's layout.

# (params key, HF name under "h.{layer}.")
_GPT2_BLOCK_TENSORS = (
    ("ln1", "ln_1.weight"), ("ln1_b", "ln_1.bias"),
    ("wo", "attn.c_proj.weight"), ("bo", "attn.c_proj.bias"),
    ("ln2", "ln_2.weight"), ("ln2_b", "ln_2.bias"),
    ("wg", "mlp.c_fc.weight"), ("bfc", "mlp.c_fc.bias"),
    ("wd", "mlp.c_proj.weight"), ("bproj", "mlp.c_proj.bias"),
)


def _gpt2_config_from_hf(hf: dict) -> ModelConfig:
    d, heads = hf["n_embd"], hf["n_head"]
    return ModelConfig(
        n_layers=hf["n_layer"],
        hidden_dim=d,
        n_q_heads=heads,
        n_kv_heads=heads,
        head_dim=d // heads,
        intermediate_dim=hf.get("n_inner") or 4 * d,
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("n_positions", 1024),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        qkv_bias=True,
        tied_embeddings=True,
        hidden_act="gelu_tanh",  # gelu_new
        norm_type="layernorm",
        pos_emb="learned",
        mlp_gated=False,
        proj_bias=True,
    )


def _gpt2_config_to_hf(cfg: ModelConfig) -> dict:
    return {
        "model_type": "gpt2",
        "n_layer": cfg.n_layers,
        "n_embd": cfg.hidden_dim,
        "n_head": cfg.n_q_heads,
        "n_inner": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "n_positions": cfg.max_position_embeddings,
        "n_ctx": cfg.max_position_embeddings,
        "layer_norm_epsilon": cfg.rms_norm_eps,
        "activation_function": "gelu_new",
        "tie_word_embeddings": True,
        "torch_dtype": "float32",
        "architectures": ["GPT2LMHeadModel"],
    }


def _gpt2_params_from_sd(cfg: ModelConfig, sd, dtype=None, device=None) -> Params:
    """The blocks stacked over layers, `c_attn` [D, 3D] split into
    wq/wk/wv and its bias into bq/bk/bv on the device.  A critic gets a
    fresh value head (a gpt2 checkpoint carries none, as in the JAX
    package)."""
    rd = _Reader(sd, dtype or cfg.dtype, resolve_device(device))
    L, D = cfg.n_layers, cfg.hidden_dim

    def name(n):  # with or without the "transformer." prefix
        return n if n in sd else "transformer." + n

    def stack(n):
        out = rd.empty((L, *rd.get(name(f"h.0.{n}")).shape))
        for i in range(L):
            out[i].copy_(rd.get(name(f"h.{i}.{n}")))
        return out

    qkv_w = [rd.empty((L, D, D)) for _ in range(3)]
    qkv_b = [rd.empty((L, D)) for _ in range(3)]
    for i in range(L):
        w = rd.get(name(f"h.{i}.attn.c_attn.weight"))  # [D, 3D]
        b = rd.get(name(f"h.{i}.attn.c_attn.bias"))
        for j in range(3):
            qkv_w[j][i].copy_(w[:, j * D:(j + 1) * D])
            qkv_b[j][i].copy_(b[j * D:(j + 1) * D])
    named = {key: stack(n) for key, n in _GPT2_BLOCK_TENSORS}
    blocks = {
        "ln1": named["ln1"], "ln1_b": named["ln1_b"],
        "wq": qkv_w[0], "wk": qkv_w[1], "wv": qkv_w[2],
        "bq": qkv_b[0], "bk": qkv_b[1], "bv": qkv_b[2],
        **{k: named[k] for k in ("wo", "bo", "ln2", "ln2_b", "wg", "bfc", "wd", "bproj")},
    }
    params: Params = {
        "embed": rd.one(name("wte.weight")),
        "pos_embed": rd.one(name("wpe.weight")),
        "blocks": blocks,
        "final_ln": rd.one(name("ln_f.weight")),
        "final_ln_b": rd.one(name("ln_f.bias")),
    }
    if cfg.is_critic:
        params["value_head"] = rd.empty((D, 1)).zero_()
    return params


def _gpt2_params_to_sd(cfg: ModelConfig, params: Params) -> Dict[str, torch.Tensor]:
    """The inverse, without the `transformer.` prefix (no lm_head: gpt2
    ties it; no value head, as in the JAX package)."""
    blocks = params["blocks"]
    out = {
        "wte.weight": _host(params["embed"]),
        "wpe.weight": _host(params["pos_embed"]),
        "ln_f.weight": _host(params["final_ln"]),
        "ln_f.bias": _host(params["final_ln_b"]),
    }
    c_attn_w = _host(torch.cat([blocks["wq"], blocks["wk"], blocks["wv"]], dim=-1))
    c_attn_b = _host(torch.cat([blocks["bq"], blocks["bk"], blocks["bv"]], dim=-1))
    named = {key: _host(blocks[key]) for key, _ in _GPT2_BLOCK_TENSORS}
    for i in range(cfg.n_layers):
        pre = f"h.{i}."
        for key, n in _GPT2_BLOCK_TENSORS[:2]:
            out[pre + n] = named[key][i]
        out[pre + "attn.c_attn.weight"] = c_attn_w[i]
        out[pre + "attn.c_attn.bias"] = c_attn_b[i]
        for key, n in _GPT2_BLOCK_TENSORS[2:]:
            out[pre + n] = named[key][i]
    return out


register_hf_family(HFFamily(
    "gpt2", _gpt2_config_from_hf, _gpt2_config_to_hf,
    params_from_sd=_gpt2_params_from_sd, params_to_sd=_gpt2_params_to_sd,
))


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
    params = family.params_from_sd(cfg, sd, dtype=dtype, device=device)
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
    sd = family.params_to_sd(cfg, params)
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
