"""The transformer (port of areal_tpu/models/transformer.py): the
packed-row forward that training and inference run, the static generate
path's forwards over a dense KV cache, and the serving forward over a
paged KV pool.

- Parameters are a plain dict with per-layer tensors STACKED on a leading
  axis under "blocks" — the JAX package's layout, so one set of weights
  can be handed to both (`models/weights.py`).  Layers run as a Python
  loop over that axis.
- The llama/qwen2/mistral, mixtral and gpt2 layers (qkv bias, tied
  embeddings, LayerNorm with biases, learned positions, a plain MLP); a
  critic (`cfg.is_critic`) swaps the LM head for a scalar value head
  `value_head` [D, 1].
- MoE (`cfg.is_moe`): a router [D, E] and stacked experts wg/wu [E, D,
  FM], wd [E, FM, D] a layer, top-k routing with the switch-style aux
  loss, and the JAX package's three dispatches (`moe_dispatch`): "dense"
  (every expert on every token: the oracle), "topk" (GShard capacity
  slots; choices over capacity drop) and "grouped" (the default: tokens
  sorted by expert, the three expert products as one grouped GEMM each,
  `torch._grouped_mm`).  Every forward runs the MoE MLP; the packed-row
  forward sums the aux over layers (`forward_with_aux`), the generation
  paths drop it.  No dispatch reads a device value on the host.
- Packed rows: [B, S] tokens with segment ids (0 = padding) run through
  `flash_attention` (the flash kernels on the card), under a remat
  policy ("none", "full", "dots" or "dots_small"; `_layer`).
- Over a device mesh (`hidden_states_sharded`, `per_token_output_sharded`)
  the same layers run on DTensors: the params in their compute layout
  (`parallel/sharding.compute_params`), the rows sharded over (data,
  fsdp), q/k/v heads and the MLP hidden over `model`, and the attention
  through `flash_attention_sharded` (the JAX package's `packed_attention`
  with `use_flash` a mesh).  The embedding, RoPE tables and the head run
  on each rank's own rows with their tables gathered whole.
- The LM head gives fp32 logits, and the value head fp32 values, of the
  product in the weights' dtype (`ops/functional.matmul_fp32_out`), as
  the JAX package asks XLA for.
- The static generate path over a dense cache `KVCache` [L, B, S, ...]
  with right-aligned prompts: `prefill` (packed attention through the
  flash kernels' wrapper, each layer's K/V written to cache[:, :, :S])
  and `decode_step` (one write at a slot shared by every row, attention
  through K4's wrapper over [valid_from, slot]).  The dense cache is
  updated IN PLACE.
- The dense inflight window (left-aligned rows at their own depths):
  `prefill_into_slots` (one batched prefill scattered into the admitted
  rows), `decode_step_inflight` (a write at each row's own slot, K4 at
  Q=1 over [0, valid_to)) and `decode_step_spec` (Q = K+1 tokens per
  row, K4's chunk form).  Its int8 form keeps int8 codes and bf16
  per-(layer, row, slot, head) scales (`ops/quant.py`); `prefill(
  quantize_kv=True)` quantizes once and attends over the dequantized
  values, so every read sees dequant(quant(fresh)).
- The serving forwards over the paged pool: `decode_step_ragged_paged`
  (the packed lane stream, K2's wrapper) and `decode_step_spec_paged`
  (Q tokens per slot, the resume replay, K3's wrapper); the two-program
  admit path's `prefill_into_pages` and `decode_step_paged` (one token
  per slot, K3's Q=1 wrapper).
- The KV pool is updated IN PLACE (the JAX package donates it instead).
  It holds one trash page past its `n_pages` real pages: torch has no
  drop-mode scatter, so every write the JAX package drops (dead lanes,
  positions past the page table, sentinel entries) lands on the trash
  page, which no read reaches — reads clamp sentinels to the last REAL
  page (`ops/attention.clamp_page_table`).
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.kernels.decode_attention import decode_attention_kernel, decode_window
from areal_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_sharded
from areal_tpu_torch.kernels.decode_attention import decode_attention_chunk_kernel
from areal_tpu_torch.kernels.paged_chunk_attention import (
    paged_decode_attention_chunk,
    paged_decode_attention_kernel,
)
from areal_tpu_torch.kernels.ragged_paged_attention import ragged_paged_attention_kernel
from areal_tpu_torch.ops.functional import fused_next_token_logprobs, matmul_fp32_out
from areal_tpu_torch.ops.norms import apply_rotary, rms_norm, rope_cos_sin
from areal_tpu_torch.ops.quant import kv_dequant, kv_quant

Params = Dict[str, Any]

# The JAX package's out-of-range page index: writes through it drop.
# Here it (and every index >= n_pages) is routed to the trash page.
_DROP_PAGE = 2**30


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, seed: int = 0, device=None
) -> Params:
    """Random init (truncated-normal fan-in scaling), layer-stacked, made
    on `device` (the CUDA card unless told otherwise) from a
    `torch.Generator` seeded with `seed`.  The numbers differ from the
    JAX package's `init_params` (other generator); hand one set of
    weights to both with `models/weights.py`."""
    device = resolve_device(device)
    dtype = cfg.dtype
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def dense(shape, fan_in):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * fan_in**-0.5).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    L, D, F_ = cfg.n_layers, cfg.hidden_dim, cfg.intermediate_dim
    blocks = {
        "ln1": ones(L, D),
        "wq": dense((L, D, cfg.q_dim), D),
        "wk": dense((L, D, cfg.kv_dim), D),
        "wv": dense((L, D, cfg.kv_dim), D),
        "wo": dense((L, cfg.q_dim, D), cfg.q_dim),
        "ln2": ones(L, D),
    }
    if cfg.qkv_bias:
        blocks["bq"] = zeros(L, cfg.q_dim)
        blocks["bk"] = zeros(L, cfg.kv_dim)
        blocks["bv"] = zeros(L, cfg.kv_dim)
    if cfg.norm_type == "layernorm":
        blocks["ln1_b"] = zeros(L, D)
        blocks["ln2_b"] = zeros(L, D)
    if cfg.proj_bias:
        blocks["bo"] = zeros(L, D)
        blocks["bproj"] = zeros(L, D)
        if not cfg.mlp_gated:
            blocks["bfc"] = zeros(L, F_)
    if cfg.is_moe:
        E, FM = cfg.n_experts, cfg.moe_intermediate_dim
        blocks["router"] = dense((L, D, E), D)
        blocks["wg"] = dense((L, E, D, FM), D)
        blocks["wu"] = dense((L, E, D, FM), D)
        blocks["wd"] = dense((L, E, FM, D), FM)
    else:
        blocks["wg"] = dense((L, D, F_), D)
        if cfg.mlp_gated:
            blocks["wu"] = dense((L, D, F_), D)
        blocks["wd"] = dense((L, F_, D), F_)

    params: Params = {
        "embed": dense((cfg.vocab_size, D), D),
        "blocks": blocks,
        "final_ln": ones(D),
    }
    if cfg.norm_type == "layernorm":
        params["final_ln_b"] = zeros(D)
    if cfg.pos_emb == "learned":
        params["pos_embed"] = dense((cfg.max_position_embeddings, D), D)
    if cfg.is_critic:
        params["value_head"] = dense((D, 1), D)
    elif not cfg.tied_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size), D)
    return params


# --------------------------------------------------------------------------
# Model helpers
# --------------------------------------------------------------------------


def _act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.hidden_act == "silu":
        return F.silu(x)
    if cfg.hidden_act == "gelu":
        return F.gelu(x, approximate="none")
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {cfg.hidden_act!r}")


def _norm(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], cfg: ModelConfig
) -> torch.Tensor:
    if cfg.norm_type == "rms":
        scale = w.float() + 1.0 if cfg.rms_norm_offset else w
        return rms_norm(x, scale, cfg.rms_norm_eps)
    # LayerNorm (gpt2): mean-centered, with bias, fp32 accumulation.
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + cfg.rms_norm_eps) * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(dtype)


def _embed(
    params: Params, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    # Clamp like jnp.take(mode="clip"): out-of-vocab ids (pad / eos
    # sentinels) must embed to FINITE values — dead lanes still run the
    # stack, and NaN there would reach the logits buffer's untouched rows.
    emb = params["embed"]
    x = emb[torch.clamp(tokens, 0, emb.shape[0] - 1)]
    if cfg.embed_scale:  # gemma normalizer, computed in fp32
        x = (x.float() * (cfg.hidden_dim**0.5)).to(x.dtype)
    if cfg.pos_emb == "learned":
        pe = params["pos_embed"]
        x = x + pe[torch.clamp(positions, 0, pe.shape[0] - 1)]
    return x


def _mlp_dense(h: torch.Tensor, blk: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_gated:
        gate = _act(h @ blk["wg"], cfg)
        out = (gate * (h @ blk["wu"])) @ blk["wd"]
    else:  # plain fc -> act -> proj (gpt2)
        hmid = h @ blk["wg"]
        if cfg.proj_bias:
            hmid = hmid + blk["bfc"]
        out = _act(hmid, cfg) @ blk["wd"]
    if cfg.proj_bias:
        out = out + blk["bproj"]
    return out


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: rows of zeros for indices outside [0, n).  A
    comparison, so it never checks the indices on the host (F.one_hot
    does on the CPU, and raises where JAX gives zeros)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _moe_route(x: torch.Tensor, blk: Params, cfg: ModelConfig):
    """The router over x [T, D]: fp32 logits and softmax, the top-k
    weights renormalised to sum to 1, the choices as a one-hot [T, k, E],
    and the switch-style load-balancing aux E * sum_e load_e * importance_e.
    Ties order the lower expert first, as `jax.lax.top_k` does (a stable
    descending sort; `torch.topk` leaves their order open)."""
    probs = torch.softmax(x.float() @ blk["router"].float(), dim=-1)  # [T, E]
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    one_hot = _one_hot(top_idx, cfg.n_experts, probs.dtype)  # [T, k, E]
    load = torch.mean(one_hot.sum(dim=1), dim=0)  # the share routed to each expert
    importance = torch.mean(probs, dim=0)
    aux = cfg.n_experts * torch.sum(load * importance)
    return top_w, top_idx, one_hot, aux


def _mlp_moe_dense(h: torch.Tensor, blk: Params, cfg: ModelConfig):
    """The oracle: every expert on every token, combined with the sparse
    router weights (E/k times the products of a real dispatch, and equal
    to dropless top-k routing).  The experts' activation is SiLU whatever
    `hidden_act` says, as in the JAX package."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])  # [T, D]
    top_w, _, one_hot, aux = _moe_route(x, blk, cfg)
    comb = torch.einsum("tk,tke->te", top_w, one_hot)  # [T, E]
    gate = F.silu(torch.einsum("td,edf->etf", x, blk["wg"]))
    up = torch.einsum("td,edf->etf", x, blk["wu"])
    expert_out = torch.einsum("etf,efd->etd", gate * up, blk["wd"])  # [E, T, D]
    out = torch.einsum("te,etd->td", comb.to(expert_out.dtype), expert_out)
    return out.reshape(shape), aux


def _mlp_moe_topk(h: torch.Tensor, blk: Params, cfg: ModelConfig):
    """Capacity dispatch (GShard): the expert products run on [E, C, D]
    gathered slots, C = ceil(T * k / E * capacity_factor) from the static
    shapes.  Queue positions are choice-slot-major, so first choices claim
    capacity before second ones; a choice past its expert's capacity is
    dropped (its combine weight is 0).  Every row of h routes and takes
    capacity, padding included, as in the JAX package."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])  # [T, D]
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    top_w, _, one_hot, aux = _moe_route(x, blk, cfg)
    cap = max(int(math.ceil(T * k / E * cfg.moe_capacity_factor)), 1)
    sel = one_hot.transpose(0, 1).reshape(k * T, E)  # [k*T, E]
    pos = torch.cumsum(sel, dim=0) - sel  # the queue position BEFORE this entry
    keep = sel * (pos < cap)
    slot = _one_hot(pos.to(torch.int32), cap, x.dtype)  # [k*T, E, C]
    disp = (keep.to(x.dtype)[..., None] * slot).reshape(k, T, E, cap)
    dispatch = disp.sum(dim=0)  # [T, E, C] of 0/1
    combine = torch.einsum("tk,ktec->tec", top_w.to(x.dtype), disp)
    xe = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, D]
    gate = F.silu(torch.einsum("ecd,edf->ecf", xe, blk["wg"]))
    up = torch.einsum("ecd,edf->ecf", xe, blk["wu"])
    ye = torch.einsum("ecf,efd->ecd", gate * up, blk["wd"])  # [E, C, D]
    out = torch.einsum("tec,ecd->td", combine, ye)
    return out.reshape(shape), aux


def _mlp_moe_grouped(h: torch.Tensor, blk: Params, cfg: ModelConfig):
    """Dropless grouped-GEMM dispatch (the default): the T*k choices
    sorted by expert (a stable sort, token-major within an expert), the
    group offsets computed on the device, and each expert product one
    `torch._grouped_mm` over the sorted rows (3 T k D F multiply-adds in
    all: proportional to the tokens, not to E).  The k outputs of a token
    are gathered back through the inverse permutation and summed over k in
    order (choice 0 + choice 1 + ...), never scattered with atomic adds:
    for k <= 2 this is the JAX package's scatter-add from zeros bit for
    bit."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])  # [T, D]
    T = x.shape[0]
    k = cfg.n_experts_per_tok
    top_w, top_idx, one_hot, aux = _moe_route(x, blk, cfg)
    order = torch.argsort(top_idx.reshape(-1), stable=True)  # [T*k]
    offs = torch.cumsum(one_hot.sum(dim=(0, 1)), dim=0).to(torch.int32)  # [E]
    xs = x[torch.div(order, k, rounding_mode="floor")]  # [T*k, D], by expert
    gate = F.silu(torch._grouped_mm(xs, blk["wg"], offs=offs))
    up = torch._grouped_mm(xs, blk["wu"], offs=offs)
    ys = torch._grouped_mm(gate * up, blk["wd"], offs=offs)  # [T*k, D]
    ys = ys * top_w.reshape(-1)[order].to(ys.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    per_choice = ys[inv].reshape(T, k, -1)  # token-major again
    out = per_choice[:, 0]
    for j in range(1, k):
        out = out + per_choice[:, j]
    return out.reshape(shape), aux


_MOE_DISPATCH = {"dense": _mlp_moe_dense, "topk": _mlp_moe_topk, "grouped": _mlp_moe_grouped}


def _mlp(h: torch.Tensor, blk: Params, cfg: ModelConfig):
    """The MLP on normed h [..., D] -> (out, the MoE aux or None).  An
    unknown `moe_dispatch` runs "topk", as in the JAX package."""
    if cfg.is_moe:
        return _MOE_DISPATCH.get(cfg.moe_dispatch, _mlp_moe_topk)(h, blk, cfg)
    return _mlp_dense(h, blk, cfg), None


def head_weights(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """[D, V] LM-head matrix (transposed embedding when tied)."""
    return params["embed"].T if cfg.tied_embeddings else params["lm_head"]


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits [..., V], or a critic's fp32 values [...]: an fp32
    result of the product in the weights' dtype, as the JAX package's
    `preferred_element_type`."""
    if cfg.is_critic:
        return matmul_fp32_out(x, params["value_head"])[..., 0]
    return matmul_fp32_out(x, head_weights(params, cfg))


def _block_kv(
    h: torch.Tensor, blk: Params, cfg: ModelConfig, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [..., D] -> q [..., n_q, d], k/v [..., n_kv, d] (RoPE applied)."""
    lead = h.shape[:-1]
    q = h @ blk["wq"]
    k = h @ blk["wk"]
    v = h @ blk["wv"]
    if cfg.qkv_bias:
        q, k, v = q + blk["bq"], k + blk["bk"], v + blk["bv"]
    q = q.reshape(*lead, cfg.n_q_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        q, k = apply_rotary(q, k, cos, sin)
    return q, k, v


def _attn_out(attn: torch.Tensor, blk: Params, cfg: ModelConfig, lead) -> torch.Tensor:
    """The attention output projection: attn [*lead, n_q, d] -> [*lead, D]."""
    ao = attn.reshape(*lead, cfg.q_dim) @ blk["wo"]
    if cfg.proj_bias:
        ao = ao + blk["bo"]
    return ao


def _mlp_branch(x: torch.Tensor, blk: Params, cfg: ModelConfig):
    """The MLP residual branch: norm, then the MLP.  x [..., D] ->
    (out, the MoE aux or None)."""
    return _mlp(_norm(x, blk["ln2"], blk.get("ln2_b"), cfg), blk, cfg)


def _attn_mlp(
    x: torch.Tensor, attn: torch.Tensor, blk: Params, cfg: ModelConfig
) -> torch.Tensor:
    """The rest of a layer after attention: output projection, residual,
    norm, MLP, residual (the generation paths: a MoE aux is dropped).
    attn [..., n_q, d], x [..., D]."""
    x = x + _attn_out(attn, blk, cfg, x.shape[:-1])
    return x + _mlp_branch(x, blk, cfg)[0]


# --------------------------------------------------------------------------
# Packed rows: the training and inference forward
# --------------------------------------------------------------------------


def packed_attention(q, k, v, segment_ids) -> torch.Tensor:
    """Causal segment attention over packed rows: K1 through
    `flash_attention`, or, on DTensors, `flash_attention_sharded` over
    their mesh (the JAX package's `packed_attention` with `use_flash` a
    mesh)."""
    if isinstance(q, DTensor):
        return flash_attention_sharded(q, k, v, segment_ids, q.device_mesh, causal=True)
    return flash_attention(q, k, v, segment_ids, causal=True)


def positions_from_segments(segment_ids: torch.Tensor) -> torch.Tensor:
    """Within-segment positions for packed rows [B, S]: segments are
    contiguous runs, and the position resets to 0 at each boundary."""
    s = segment_ids.shape[-1]
    idx = torch.arange(s, device=segment_ids.device).expand_as(segment_ids)
    prev = F.pad(segment_ids[..., :-1], (1, 0), value=-1)
    start_idx = torch.where(segment_ids != prev, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start_idx, dim=-1).values


def _attn_branch(
    x: torch.Tensor,  # [B, S, D]
    blk: Params,
    cfg: ModelConfig,
    segment_ids: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    """The attention residual branch of a packed-row layer: norm, q/k/v,
    flash attention, output projection (the JAX package's "attn_out")."""
    h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
    q, k, v = _block_kv(h, blk, cfg, cos, sin)
    attn = packed_attention(q, k, v, segment_ids)
    return _attn_out(attn, blk, cfg, x.shape[:-1])


def _block_forward(
    x: torch.Tensor,  # [B, S, D]
    blk: Params,
    cfg: ModelConfig,
    segment_ids: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """One packed-row layer -> (its output, the MoE aux or None)."""
    h = x + _attn_branch(x, blk, cfg, segment_ids, cos, sin)
    mlp_out, aux = _mlp_branch(h, blk, cfg)
    return h + mlp_out, aux


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products with no batch dimension, the dots that JAX's
    `dots_with_no_batch_dims_saveable` keeps: a layer's seven projections
    (`x @ w` of a [B, S, D] x and a 2-D w) reach `aten.mm.default` and
    nothing else (probed under a TorchDispatchMode in fp32 and bf16; on
    the card `chip_smoke.py` counts seven a layer).  The attention's
    products (`bmm` in the plain version on the CPU, the flash kernels
    behind a ctypes call on the card) are recomputed, as JAX recomputes
    its einsum or `pallas_call`."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    # `_dots_policy` is looked up at each call, so a test can wrap it.
    return create_selective_checkpoint_contexts(_dots_policy)


REMAT_POLICIES = ("none", "full", "dots", "dots_small")


def _remat_layers(remat) -> str:
    """The layer remat policy that `remat` names (REMAT_POLICIES), as the
    JAX package reads it: True is "full"; False and None are "none"."""
    if remat is True:
        return "full"
    if remat is False or remat is None:
        return "none"
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    return remat


def _layer(x, blk, cfg, segment_ids, cos, sin, policy: str):
    """One packed-row layer under a remat policy -> (its output, the MoE
    aux or None; the aux leaves each checkpointed function as its second
    output).  Non-reentrant checkpoints, so every policy runs the same
    ops on the same values:
    - "none": autograd's own residuals;
    - "full": the layer input only; backward recomputes the layer;
    - "dots": the layer input and the seven projections' outputs
      (`_dots_policy`); backward recomputes the norms, RoPE, the
      attention and the activation;
    - "dots_small": one checkpoint a residual branch, so the two branch
      inputs x and x + attn_out ([*, D] each) are kept and each branch
      is recomputed in its own backward (a MoE layer's MLP branch output
      is the MoE output).  JAX keeps three [*, D] a layer (its layer
      input, "attn_out" and "mlp_out"); the values are the same."""
    if policy == "none":
        return _block_forward(x, blk, cfg, segment_ids, cos, sin)
    if policy == "full":
        return checkpoint(_block_forward, x, blk, cfg, segment_ids, cos, sin,
                          use_reentrant=False)
    if policy == "dots":
        return checkpoint(_block_forward, x, blk, cfg, segment_ids, cos, sin,
                          use_reentrant=False, context_fn=_dots_contexts)
    h = x + checkpoint(_attn_branch, x, blk, cfg, segment_ids, cos, sin,
                       use_reentrant=False)
    mlp_out, aux = checkpoint(_mlp_branch, h, blk, cfg, use_reentrant=False)
    return h + mlp_out, aux


def _backbone(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    segment_ids: torch.Tensor,
    positions: torch.Tensor,
    remat=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-normed hidden states and the MoE aux summed over layers
    (a 0 for a dense model)."""
    policy = _remat_layers(remat) if torch.is_grad_enabled() else "none"
    positions = positions.long()
    x = _embed(params, cfg, tokens.long(), positions)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    # unbind, not w[li]: its backward stacks the L layer gradients once,
    # where L index backwards would each add a full [L, ...] gradient.
    layers = {name: w.unbind(0) for name, w in params["blocks"].items()}
    auxes = []
    for li in range(cfg.n_layers):
        blk = {name: ws[li] for name, ws in layers.items()}
        x, aux = _layer(x, blk, cfg, segment_ids, cos, sin, policy)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.sum(torch.stack(auxes)) if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return _norm(x, params["final_ln"], params.get("final_ln_b"), cfg), aux


def hidden_states_sharded(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B_local, S] int: this rank's own rows
    segment_ids: torch.Tensor,
    positions: torch.Tensor,
    mesh,
    remat=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`hidden_states_with_aux` over a device mesh: `params` are DTensors
    in their compute layout (`parallel/sharding.compute_params`), the
    batch arrays this rank's own rows.  The embedding lookup and the RoPE
    tables run on the local rows (the table gathered whole,
    `local_replica`); the layers and the final norm run on DTensors, the
    rows sharded over (data, fsdp).  Returns this rank's final-normed
    hidden states [B_local, S, D] (local; their gradient comes back
    batch-sharded) and the MoE aux."""
    from areal_tpu_torch.parallel import sharding as shd

    policy = _remat_layers(remat) if torch.is_grad_enabled() else "none"
    positions = positions.long()
    tables = {k: shd.local_replica(params[k], mesh) for k in ("embed", "pos_embed") if k in params}
    x = _embed(tables, cfg, tokens.long(), positions)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x, seg, cos, sin = (shd.rows_dtensor(t, mesh) for t in (x, segment_ids, cos, sin))
    layers = {name: w.unbind(0) for name, w in params["blocks"].items()}
    auxes = []
    for li in range(cfg.n_layers):
        blk = {name: ws[li] for name, ws in layers.items()}
        x, aux = _layer(x, blk, cfg, seg, cos, sin, policy)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.sum(torch.stack(auxes)) if auxes
           else torch.zeros((), dtype=torch.float32, device=tokens.device))
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return shd.rows_local(x), aux


def per_token_output_sharded(
    params: Params, cfg: ModelConfig, x: torch.Tensor, tokens: torch.Tensor,
    segment_ids: torch.Tensor, mesh,
) -> torch.Tensor:
    """`per_token_output` of this rank's rows (`hidden_states_sharded`'s
    local x), the head's table gathered whole (`local_replica`)."""
    from areal_tpu_torch.parallel import sharding as shd

    keys = ("value_head",) if cfg.is_critic else (
        ("embed",) if cfg.tied_embeddings else ("lm_head",))
    head = {k: shd.local_replica(params[k], mesh) for k in keys}
    return per_token_output(head, cfg, x, tokens, segment_ids)


def hidden_states(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    segment_ids: torch.Tensor,  # [B, S] int, 0 = pad
    positions: Optional[torch.Tensor] = None,
    remat=False,
) -> torch.Tensor:
    """Backbone only: final-normed hidden states [B, S, D], without the
    LM head (the JAX function's first output; `hidden_states_with_aux`
    also returns the MoE aux)."""
    return hidden_states_with_aux(params, cfg, tokens, segment_ids, positions, remat)[0]


def hidden_states_with_aux(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    segment_ids: torch.Tensor,  # [B, S] int, 0 = pad
    positions: Optional[torch.Tensor] = None,
    remat=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-normed hidden states [B, S, D], the MoE aux loss summed over
    layers: fp32, 0 for a dense model), as the JAX `hidden_states`."""
    if positions is None:
        positions = positions_from_segments(segment_ids)
    return _backbone(params, cfg, tokens, segment_ids, positions, remat)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    segment_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    remat=False,
) -> torch.Tensor:
    """Full forward over packed rows -> fp32 logits [B, S, V] (a
    critic's values [B, S])."""
    return forward_with_aux(params, cfg, tokens, segment_ids, positions, remat)[0]


def forward_with_aux(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    segment_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    remat=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`forward` and the MoE aux loss summed over layers."""
    x, aux = hidden_states_with_aux(params, cfg, tokens, segment_ids, positions, remat)
    return _head(params, cfg, x), aux


def per_token_output(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D] from hidden_states()
    tokens: torch.Tensor,
    segment_ids: torch.Tensor,
    chunk_size: int = 512,
) -> torch.Tensor:
    """The engine-facing per-token output [B, S] fp32: a critic's
    values, else fused chunked next-token logprobs, never [B, S, V]
    logits."""
    if cfg.is_critic:
        return _head(params, cfg, x)
    return fused_next_token_logprobs(
        x, head_weights(params, cfg), tokens, segment_ids, chunk_size
    )


# --------------------------------------------------------------------------
# Dense KV cache: the static generate path
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV cache: k/v [L, B, S_max, n_kv, head_dim], row b
    holding its prompt and then its generated tokens.  int8 mode: int8
    k/v and bf16 per-(layer, row, slot, head) scales [L, B, S_max, n_kv],
    so `k_scale[li]` is the [B, S, n_kv] that K4 takes."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def s_max(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.k, self.v, self.k_scale, self.v_scale)
            if a is not None
        )


def init_kv_cache(
    cfg: ModelConfig, batch: int, s_max: int, dtype=None, device=None
) -> KVCache:
    """A zeroed dense cache on `device` (the CUDA card unless told
    otherwise), in `dtype` (default the model's; "int8" adds bf16
    scales)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    if dtype in (torch.int8, "int8"):
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int — one sequence per row
    segment_ids: torch.Tensor,  # [B, S] int — 1 where valid, 0 pad
    cache: KVCache,
    quantize_kv: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompts through the model, writing each layer's K/V to
    cache[:, :, :S] (in place), and return fp32 logits [B, V] at each
    row's LAST valid position only (the distribution over the first
    generated token).  Attention is `flash_attention` (K1f on the card),
    causal within each row's segment; padding positions give zeros.

    quantize_kv=True (an int8 cache) quantizes each layer's fresh K/V
    once, writes those codes and scales, and attends over their
    dequantized values: the prefill then sees what every later read of
    the cache sees.  A dequantized value is never quantized again
    (round(126 s / 127 / s') flips codes)."""
    if quantize_kv != cache.quantized:
        raise ValueError("quantize_kv must be set exactly when the cache is int8")
    b, s = tokens.shape
    positions = positions_from_segments(segment_ids).long()
    x = _embed(params, cfg, tokens.long(), positions)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        blk = {name: w[li] for name, w in blocks.items()}
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, S, h, d]
        if quantize_kv:
            kq, ksc = kv_quant(k)
            vq, vsc = kv_quant(v)
            cache.k[li, :, :s], cache.k_scale[li, :, :s] = kq, ksc
            cache.v[li, :, :s], cache.v_scale[li, :, :s] = vq, vsc
            k, v = kv_dequant(kq, ksc, k.dtype), kv_dequant(vq, vsc, v.dtype)
        else:
            cache.k[li, :, :s] = k.to(cache.k.dtype)
            cache.v[li, :, :s] = v.to(cache.v.dtype)
        attn = flash_attention(q, k, v, segment_ids, causal=True)
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    # Each row's last valid position (right- or left-aligned rows alike),
    # gathered before the head: [B, V] logits, never [B, S, V].
    idx = torch.arange(s, device=tokens.device)
    last = torch.amax(torch.where(segment_ids > 0, idx, 0), dim=-1)
    x_last = x[torch.arange(b, device=tokens.device), last]
    return _head(params, cfg, x_last), cache


def layer_views(params: Params):
    """Each layer's dict of weight views ({name: w[li]}), for a caller
    that runs many decode steps on one set of weights to bind once
    instead of at every step."""
    blocks = params["blocks"]
    n = len(next(iter(blocks.values())))
    return [{name: w[li] for name, w in blocks.items()} for li in range(n)]


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] int — current token per row
    positions: torch.Tensor,  # [B] int — its RoPE position per row
    cache: KVCache,
    slot: int,  # cache slot written for ALL rows
    valid_from: torch.Tensor,  # [B] int — first valid cache slot per row
    layers=None,  # layer_views(params), bound once a burst
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: write each row's new K/V at cache slot `slot`
    (the same for every row: prompts are right-aligned), attend over the
    live window [valid_from, slot] through `decode_attention_kernel` (K4
    on the card), and return fp32 logits [B, V] and the cache — the same
    object, updated in place.  The step's windows (and, on the CPU, the
    plain version's mask) are built once for all layers."""
    b = tokens.shape[0]
    slot = int(slot)
    positions = positions.long()
    x = _embed(params, cfg, tokens.long(), positions)[:, None, :]  # [B, 1, D]
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    # The attention kernel takes int32 windows.
    vf = valid_from.to(torch.int32).contiguous()
    vt = torch.full((b,), slot + 1, dtype=torch.int32, device=tokens.device)
    window = decode_window(vf, vt, 1, cache.k.shape[2])
    k_layers, v_layers = cache.k.unbind(0), cache.v.unbind(0)
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, 1, h, d]
        k_l, v_l = k_layers[li], v_layers[li]
        k_l[:, slot] = k[:, 0].to(k_l.dtype)
        v_l[:, slot] = v[:, 0].to(v_l.dtype)
        attn = decode_attention_kernel(q.contiguous(), k_l, v_l, vf, vt, window=window)
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x)[:, 0], cache


def _dense_update_read(cache: KVCache, k: torch.Tensor, v: torch.Tensor, li: int, idx):
    """Write this layer's new K/V entries at (row, slot) `idx` of the
    dense cache in place (quantizing when it is int8), and return the
    layer's raw views [B, S, n_kv, d] plus its scales (None unless int8).
    Every index must be in range: the callers clamp their slots."""
    if cache.quantized:
        kq, ks = kv_quant(k)
        vq, vs = kv_quant(v)
        cache.k[li].index_put_(idx, kq)
        cache.v[li].index_put_(idx, vq)
        cache.k_scale[li].index_put_(idx, ks)
        cache.v_scale[li].index_put_(idx, vs)
        return cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li]
    cache.k[li].index_put_(idx, k.to(cache.k.dtype))
    cache.v[li].index_put_(idx, v.to(cache.v.dtype))
    return cache.k[li], cache.v[li], None, None


def decode_step_inflight(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int — RoPE positions
    cache: KVCache,
    slots: torch.Tensor,  # [B] int — per-row cache write slot
    valid_to: torch.Tensor,  # [B] int — one past the last valid slot (incl. new)
    layers=None,  # layer_views(params), bound once a chunk
) -> Tuple[torch.Tensor, KVCache]:
    """Decode step with PER-ROW write slots (left-aligned rows at their
    own depths, the inflight window): each row's new K/V is written at
    (row, slots[row]) (int8 codes and scales for an int8 cache), then it
    attends [0, valid_to) through `decode_attention_kernel` (K4 at Q=1 on
    the card).  Returns fp32 logits [B, V] and the cache, updated in
    place.  The JAX function's `unroll` (a layer loop the XLA compiler
    could alias) has no counterpart: here the layers are always a Python
    loop over in-place views."""
    b = tokens.shape[0]
    positions = positions.long()
    x = _embed(params, cfg, tokens.long(), positions)[:, None, :]  # [B, 1, D]
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    idx = (torch.arange(b, device=tokens.device), slots.long())
    # The attention kernel takes int32 windows.
    vf = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    vt = valid_to.to(torch.int32)
    window = decode_window(vf, vt, 1, cache.k.shape[2])
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, 1, h, d]
        k_l, v_l, ks_l, vs_l = _dense_update_read(cache, k[:, 0], v[:, 0], li, idx)
        attn = decode_attention_kernel(
            q.contiguous(), k_l, v_l, vf, vt, k_scale=ks_l, v_scale=vs_l, window=window
        )
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x)[:, 0], cache


def decode_step_spec(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Q] int — pending token + Q-1 drafts per row
    positions: torch.Tensor,  # [B, Q] int — RoPE positions
    cache: KVCache,
    slots0: torch.Tensor,  # [B] int — write slot of tokens[:, 0]
    layers=None,  # layer_views(params), bound once a chunk
) -> Tuple[torch.Tensor, KVCache]:
    """Speculative decode step: Q consecutive tokens per row in one
    forward, their K/V written at slots0 .. slots0 + Q - 1 (in range: the
    caller clamps slots0 to S - Q), query j attending [0, slots0 + 1 + j)
    through `decode_attention_chunk_kernel` (K4's chunk form on the card).
    Each layer writes before it reads, so rejected drafts' stale entries
    past a row's accepted prefix are overwritten when those positions are
    consumed for real.  Returns fp32 logits [B, Q, V] (logits[:, j] = the
    next-token distribution after tokens[:, :j+1]) and the cache, updated
    in place."""
    b, q_len = tokens.shape
    dev = tokens.device
    positions = positions.long()
    x = _embed(params, cfg, tokens.reshape(-1).long(), positions.reshape(-1))
    x = x.reshape(b, q_len, cfg.hidden_dim)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    slots0 = slots0.long()
    idx = (
        torch.arange(b, device=dev)[:, None].expand(b, q_len),
        slots0[:, None] + torch.arange(q_len, device=dev)[None, :],
    )
    vf = torch.zeros((b,), dtype=torch.int32, device=dev)
    vt0 = (slots0 + 1).to(torch.int32)
    window = decode_window(vf, vt0, q_len, cache.k.shape[2])
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, Q, h, d]
        k_l, v_l, ks_l, vs_l = _dense_update_read(cache, k, v, li, idx)
        attn = decode_attention_chunk_kernel(
            q.contiguous(), k_l, v_l, vf, vt0, k_scale=ks_l, v_scale=vs_l, window=window
        )
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x), cache


def _prefill_row_cache(cfg: ModelConfig, m: int, sp: int, cache) -> KVCache:
    """Scratch per-row dense cache for a batched admission prefill, in
    the target's quantization (int8 codes and scales when the target is
    int8, so the scatters move codes verbatim)."""
    dtype = "int8" if cache.quantized else cache.k.dtype
    return init_kv_cache(cfg, m, sp, dtype=dtype, device=cache.k.device)


def prefill_into_slots(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [M, SP] int — left-aligned prompts (padding right)
    prompt_lens: torch.Tensor,  # [M] int
    cache: KVCache,  # [L, n_slots, S_max, h, d]
    slot_rows: torch.Tensor,  # [M] int — target cache row per prompt
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill M requests into their cache rows in one forward; returns
    fp32 logits [M, V] at each row's last prompt token.  Rows whose
    `slot_rows` entry is out of range (>= n_slots) are padding: they are
    selected out BEFORE the forward (torch has no drop-mode scatter, and
    a clamped index would overwrite a live row), and their logits are 0.
    A "topk" MoE couples the rows (every token takes capacity), so there
    the padding rows run in the forward, as in the JAX package, and only
    the live rows are written.  `slot_rows` is read on the host, so pass
    it on the CPU (as the engine does) and nothing waits for the card.
    An int8 cache gets the codes the prefill computed, never re-quantized
    values."""
    m, sp = tokens.shape
    dev = tokens.device
    rows = slot_rows.to("cpu").long()
    keep = torch.nonzero((rows >= 0) & (rows < cache.k.shape[1]))[:, 0]
    logits_all = torch.zeros((m, cfg.vocab_size), dtype=torch.float32, device=dev)
    if keep.numel() == 0:
        return logits_all, cache
    keep_dev = keep.to(dev)
    coupled = cfg.is_moe and cfg.moe_dispatch not in ("dense", "grouped")
    run = torch.arange(m, device=dev) if coupled else keep_dev  # the rows the forward runs
    if run.numel() < m:
        tokens, prompt_lens = tokens[run], prompt_lens[run]
    seg = (
        torch.arange(sp, device=dev)[None, :] < prompt_lens.long()[:, None]
    ).long()
    row_cache = _prefill_row_cache(cfg, run.numel(), sp, cache)
    logits, row_cache = prefill(
        params, cfg, tokens, seg, row_cache, quantize_kv=cache.quantized
    )
    live = keep_dev if coupled else slice(None)  # the live rows among those run
    dst = rows[keep].to(dev)
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(cache, name)
        if a is not None:
            a[:, dst, :sp] = getattr(row_cache, name)[:, live]
    logits_all[keep_dev] = logits[live]
    return logits_all, cache


# --------------------------------------------------------------------------
# Paged KV cache
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Block-paged KV pool: k/v [L, n_pages + 1, page_size, n_kv, head_dim].

    Page index `n_pages` is the UNMAPPED sentinel.  Here it is also a real
    (trash) page of the tensors: writes through it, or through any index
    past it, land there, and no read reaches it.  int8 mode: int8 k/v +
    bf16 per-(layer, page, slot, head) scales, the quantizer of
    `ops/quant.py`."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, n_pages + 1, ps, n_kv] bf16
    v_scale: Optional[torch.Tensor] = None
    page_size: int = 128

    @property
    def n_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.k, self.v, self.k_scale, self.v_scale)
            if a is not None
        )


def init_paged_kv_cache(
    cfg: ModelConfig, n_pages: int, page_size: int, dtype=None, device=None
) -> PagedKVCache:
    """A zeroed page pool of n_pages + 1 pages (the last is the trash
    page) on `device` (the CUDA card unless told otherwise), in `dtype`
    (default the model's; "int8" adds bf16 scales)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    if dtype in (torch.int8, "int8"):
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            page_size=page_size,
        )
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        page_size=page_size,
    )


def _page_of(page_table: torch.Tensor, pos: torch.Tensor, page_size: int):
    """Per-row (page, offset) write coordinates for flat positions `pos`
    ([B] or [B, Q]) through `page_table` [B, max_pages].  Positions past
    the table width get `_DROP_PAGE` (the JAX package's drop index),
    never the clipped last entry."""
    pos2 = pos if pos.dim() == 2 else pos[:, None]
    col = torch.div(pos2, page_size, rounding_mode="floor")
    mp = page_table.shape[1]
    pages = torch.gather(page_table.long(), 1, torch.clamp(col, 0, mp - 1))
    pages = torch.where(col >= mp, torch.full_like(pages, _DROP_PAGE), pages)
    off = pos2 - col * page_size
    if pos.dim() == 1:
        return pages[:, 0], off[:, 0]
    return pages, off


def _cache_update_read(
    cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor, li: int, idx
):
    """Write this layer's new K/V entries [T, n_kv, d] at (page, offset)
    `idx` in place (quantizing when the pool is int8; indices past the
    real pages go to the trash page), and return the layer's RAW pool
    views over the real pages plus its scales (None unless int8)."""
    page, off = idx
    page = torch.clamp(page, max=cache.n_pages)
    n = cache.n_pages
    if cache.quantized:
        kq, ks = kv_quant(k)
        vq, vs = kv_quant(v)
        cache.k[li].index_put_((page, off), kq)
        cache.v[li].index_put_((page, off), vq)
        cache.k_scale[li].index_put_((page, off), ks)
        cache.v_scale[li].index_put_((page, off), vs)
        return (
            cache.k[li, :n], cache.v[li, :n],
            cache.k_scale[li, :n], cache.v_scale[li, :n],
        )
    cache.k[li].index_put_((page, off), k.to(cache.k.dtype))
    cache.v[li].index_put_((page, off), v.to(cache.v.dtype))
    return cache.k[li, :n], cache.v[li, :n], None, None


def decode_step_ragged_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] int — PACKED token stream
    positions: torch.Tensor,  # [T] int — flat cache position (== RoPE pos)
    cache: PagedKVCache,
    page_table: torch.Tensor,  # [B, max_pages] int, sentinel = n_pages
    row_of: torch.Tensor,  # [T] int — owning slot per token; >= B = dead lane
    layers=None,  # layer_views(params), bound once a chunk
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One forward of a packed [T] stream of query lanes with per-token
    windows.  Token t writes its K/V at flat position `positions[t]` of
    slot `row_of[t]` and attends [0, positions[t]] through that slot's
    page-table row (`ragged_paged_attention_kernel`).  Dead lanes (row_of >= B)
    write only to the trash page, get zero attention, and produce
    logits the caller never reads.  Returns (fp32 logits [T, V], cache)
    — the cache is the same object, updated in place."""
    b = page_table.shape[0]
    live = row_of < b
    rid = torch.clamp(row_of.long(), max=b - 1)
    pt_tok = page_table[rid]  # [T, max_pages]
    positions = torch.where(live, positions, torch.zeros_like(positions)).long()
    x = _embed(params, cfg, tokens.long(), positions)  # [T, D]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    wp_page, wp_off = _page_of(pt_tok, positions, cache.page_size)
    # Dead lanes must not write a real page.
    wp_page = torch.where(live, wp_page, torch.full_like(wp_page, _DROP_PAGE))
    # The attention kernel takes int32 tables and windows.
    pt_attn = pt_tok.to(torch.int32).contiguous()
    valid_to = torch.where(
        live, positions + 1, torch.zeros_like(positions)
    ).to(torch.int32)
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [T, h, d]
        k_pool_l, v_pool_l, ks_l, vs_l = _cache_update_read(
            cache, k, v, li, (wp_page, wp_off)
        )
        attn = ragged_paged_attention_kernel(
            q.contiguous(), k_pool_l, v_pool_l, pt_attn, valid_to,
            k_scale=ks_l, v_scale=vs_l,
        )
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x), cache


def decode_step_spec_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Q] int — Q consecutive tokens per row
    positions: torch.Tensor,  # [B, Q] int — RoPE positions
    cache: PagedKVCache,
    page_table: torch.Tensor,  # [B, max_pages] int, sentinel = n_pages
    write_pos0: torch.Tensor,  # [B] int — flat position of tokens[:, 0]
    q_lens: torch.Tensor,  # [B] int — live queries per row
    layers=None,  # layer_views(params), bound once a chunk
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Q consecutive tokens per row in one forward: k/v written at flat
    positions write_pos0 .. write_pos0 + Q - 1 through the page table,
    query i attending [0, write_pos0 + 1 + i) (`paged_decode_attention_chunk`,
    K3 on the card).  The step is ragged: row b's queries
    i >= q_lens[b] are dead — their K/V writes go to the trash page only
    (never a clamped real page, which may belong to another sequence)
    and their attention gives zeros; their logits are garbage the caller
    ignores.  Returns (fp32 logits [B, Q, V], cache) — the cache is the
    same object, updated in place."""
    b, q_len = tokens.shape
    dev = tokens.device
    positions = positions.long()
    x = _embed(params, cfg, tokens.reshape(-1).long(), positions.reshape(-1))
    x = x.reshape(b, q_len, cfg.hidden_dim)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    write_pos0 = write_pos0.long()
    col = write_pos0[:, None] + torch.arange(q_len, device=dev)[None, :]
    wp_page, wp_off = _page_of(page_table, col, cache.page_size)
    dead = torch.arange(q_len, device=dev)[None, :] >= q_lens.long()[:, None]
    wp_page = torch.where(dead, torch.full_like(wp_page, _DROP_PAGE), wp_page)
    idx = (wp_page.reshape(-1), wp_off.reshape(-1))
    # The attention kernel takes int32 tables, windows and query counts.
    pt_attn = page_table.to(torch.int32).contiguous()
    valid_to0 = (write_pos0 + 1).to(torch.int32)
    ql_attn = q_lens.to(torch.int32).contiguous()
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, Q, h, d]
        k_pool_l, v_pool_l, ks_l, vs_l = _cache_update_read(
            cache, k.reshape(b * q_len, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b * q_len, cfg.n_kv_heads, cfg.head_dim), li, idx,
        )
        attn = paged_decode_attention_chunk(
            q.contiguous(), k_pool_l, v_pool_l, pt_attn, valid_to0, ql_attn,
            k_scale=ks_l, v_scale=vs_l,
        )
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x), cache


def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int — RoPE positions
    cache: PagedKVCache,
    page_table: torch.Tensor,  # [B, max_pages] int, sentinel = n_pages
    write_pos: torch.Tensor,  # [B] int — flat cache position to write
    valid_to: torch.Tensor,  # [B] int — one past the last valid position
    layers=None,  # layer_views(params), bound once a chunk
) -> Tuple[torch.Tensor, PagedKVCache]:
    """`decode_step_inflight` over the paged pool (the two-program admit
    path's decode step): each row's K/V written at (page_table[row,
    pos // ps], pos % ps) (writes through a sentinel go to the trash
    page), attention over [0, valid_to) through the page table with
    `paged_decode_attention_kernel` (K2's kernel on the card).  Returns fp32
    logits [B, V] and the pool, updated in place."""
    positions = positions.long()
    x = _embed(params, cfg, tokens.long(), positions)[:, None, :]  # [B, 1, D]
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    idx = _page_of(page_table, write_pos.long(), cache.page_size)
    # The attention kernel takes int32 tables and windows.
    pt_attn = page_table.to(torch.int32).contiguous()
    vt = valid_to.to(torch.int32)
    for li, blk in enumerate(layers if layers is not None else layer_views(params)):
        h = _norm(x, blk["ln1"], blk.get("ln1_b"), cfg)
        q, k, v = _block_kv(h, blk, cfg, cos, sin)  # [B, 1, h, d]
        k_pool_l, v_pool_l, ks_l, vs_l = _cache_update_read(
            cache, k[:, 0], v[:, 0], li, idx
        )
        attn = paged_decode_attention_kernel(
            q.contiguous(), k_pool_l, v_pool_l, pt_attn, vt,
            k_scale=ks_l, v_scale=vs_l,
        )
        x = _attn_mlp(x, attn, blk, cfg)
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg)
    return _head(params, cfg, x)[:, 0], cache


def prefill_into_pages(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [M, SP] int — left-aligned prompts, SP % page_size == 0
    prompt_lens: torch.Tensor,  # [M] int
    cache: PagedKVCache,
    page_rows: torch.Tensor,  # [M, SP // page_size] int — pool page ids
) -> Tuple[torch.Tensor, PagedKVCache]:
    """`prefill_into_slots` for the paged pool: one batched forward of M
    admitted prompts, whose per-row caches are cut into page_size chunks
    and scattered to their pool pages.  `page_rows` entries >= n_pages
    (the sentinel: chunks past a prompt, padding rows) go to the trash
    page, which no read reaches.  The tail of a prompt's last page holds
    the padding's K/V until decode writes overwrite it; `valid_to` masks
    it meanwhile.  Returns fp32 logits [M, V] at each row's last prompt
    token and the pool, updated in place."""
    m, sp = tokens.shape
    ps = cache.page_size
    if sp % ps:
        raise ValueError(f"prefill width {sp} not a multiple of page_size {ps}")
    dev = tokens.device
    seg = (
        torch.arange(sp, device=dev)[None, :] < prompt_lens.long()[:, None]
    ).long()
    row_cache = _prefill_row_cache(cfg, m, sp, cache)
    logits, row_cache = prefill(
        params, cfg, tokens, seg, row_cache, quantize_kv=cache.quantized
    )
    flat = torch.clamp(page_rows.reshape(-1).long(), max=cache.n_pages)
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(cache, name)
        if a is not None:
            r = getattr(row_cache, name)  # [L, M, SP, ...] -> [L, M * SP/ps, ps, ...]
            a[:, flat] = r.reshape(r.shape[0], m * (sp // ps), ps, *r.shape[3:])
    return logits, cache


def copy_pages(
    cache: PagedKVCache,
    src_pages: torch.Tensor,  # [N] int pool page ids (sentinel = padding)
    dst_pages: torch.Tensor,  # [N] int pool page ids (sentinel = padding)
) -> PagedKVCache:
    """Copy whole KV pages src -> dst inside the pool, in place (all
    layers, one gather + scatter per tensor) — the device half of
    copy-on-write.  Padding pairs use the sentinel: their gather clamps
    to a real page and their scatter lands on the trash page."""
    n = cache.n_pages
    src = torch.clamp(src_pages.long(), max=n - 1)
    dst = torch.clamp(dst_pages.long(), max=n)
    for a in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if a is not None:
            a[:, dst] = a[:, src]
    return cache
