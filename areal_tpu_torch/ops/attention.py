"""Packed and paged attention (port of areal_tpu/ops/attention.py).

- The plain versions of packed attention (`make_packed_mask`,
  `repeat_kv`, `packed_attention_reference`): causal-within-segment
  attention over packed rows [B, S].  The model calls the flash kernels'
  wrapper (`areal_tpu_torch/kernels/flash_attention.py`), which takes
  this plain version for CPU tensors and the kernels for CUDA tensors.
- The plain versions of decode attention over a dense window
  (`decode_attention`, Q=1; `decode_attention_chunk`, Q queries per row,
  ragged with `q_lens`) and the paged gather (`clamp_page_table`,
  `paged_gather_layer`).  The dense decode kernel's wrapper
  (`kernels/decode_attention.py`) takes `decode_attention_chunk` as its
  plain version; the paged attention kernels' wrappers
  (`kernels/ragged_paged_attention.py`, `kernels/paged_chunk_attention.py`)
  build theirs from these.  The model calls the wrappers.
- `paged_decode_attention`: single-query decode through a page table,
  plain formulation (the gather, then `decode_attention` over windows
  from position 0): the JAX function's non-kernel branch, the same
  arithmetic as the plain version of K3's Q=1 wrapper
  (`kernels/paged_chunk_attention.py paged_decode_attention_kernel`, which
  `decode_step_paged` calls and which runs K2's kernel).
- `split_window_attention`: the split-KV arithmetic of K2 and K4 (a
  block's warps walking a span tile by tile, partials per span, then the
  merge; the int8 scales and bf16 P' of the tensor-core path), which the
  tests and chip_smoke.py hold against the plain versions and the
  kernels.
"""

import math
from typing import Optional

import torch

NEG_INF = -2.3819763e38  # close to bf16 min, the JAX package's mask value


def make_packed_mask(segment_ids: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """[B, S] segment ids -> [B, 1, S, S] boolean mask (True = attend)."""
    seg_q = segment_ids[:, :, None]
    seg_k = segment_ids[:, None, :]
    mask = (seg_q == seg_k) & (seg_q > 0)
    if causal:
        idx = torch.arange(segment_ids.shape[-1], device=segment_ids.device)
        mask = mask & (idx[:, None] >= idx[None, :])
    return mask[:, None, :, :]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, n_kv, d] -> [B, S, n_kv*n_rep, d] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def packed_attention_reference(
    q: torch.Tensor,  # [B, S, n_q, d]
    k: torch.Tensor,  # [B, S, n_kv, d]
    v: torch.Tensor,  # [B, S, n_kv, d]
    segment_ids: torch.Tensor,  # [B, S] int, 0 = pad
    causal: bool = True,
) -> torch.Tensor:
    """The plain version: dense masked softmax in fp32; padding rows give
    exact zeros.  Returns [B, S, n_q, d] in q's dtype."""
    n_q, n_kv = q.shape[2], k.shape[2]
    k = repeat_kv(k, n_q // n_kv)
    v = repeat_kv(v, n_q // n_kv)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = make_packed_mask(segment_ids, causal=causal)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked (padding) rows produce uniform probs; zero them out.
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, n_q, d] — one new token per row
    k_cache: torch.Tensor,  # [B, S_max, n_kv, d]
    v_cache: torch.Tensor,  # [B, S_max, n_kv, d]
    valid_from: torch.Tensor,  # [B] int — first valid cache slot per row
    valid_to: torch.Tensor,  # [B] int — one past the last valid slot
    k_scale: Optional[torch.Tensor] = None,  # [B, S_max, n_kv]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA decode attention, plain formulation: query heads
    grouped per KV head, operands in q's dtype with fp32 products and
    accumulation, window [valid_from, valid_to).  Rows with an empty
    window give exact zeros."""
    if k_scale is not None:
        from areal_tpu_torch.ops.quant import kv_dequant

        k_cache = kv_dequant(k_cache, k_scale, q.dtype)
        v_cache = kv_dequant(v_cache, v_scale, q.dtype)
    b, _, n_q, d = q.shape
    n_kv = k_cache.shape[2]
    n_rep = n_q // n_kv
    qh = q[:, 0].reshape(b, n_kv, n_rep, d)
    scale = d**-0.5
    logits = (
        torch.einsum(
            "bgrd,bsgd->bgrs", qh.float(), k_cache.to(q.dtype).float()
        )
        * scale
    )  # [B, n_kv, n_rep, S] fp32
    idx = torch.arange(k_cache.shape[1], device=q.device)
    valid = (idx[None, :] >= valid_from[:, None]) & (
        idx[None, :] < valid_to.expand(b)[:, None]
    )  # [B, S]
    logits = torch.where(
        valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF)
    )
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked rows (empty live window) softmax into a uniform
    # distribution over garbage; zero them, matching the kernel.
    probs = torch.where(
        valid.any(dim=-1)[:, None, None, None], probs, torch.zeros_like(probs)
    )
    out = torch.einsum(
        "bgrs,bsgd->bgrd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(b, 1, n_q, d).to(q.dtype)


def decode_attention_chunk(
    q: torch.Tensor,  # [B, Q, n_q, d] — Q consecutive new tokens per row
    k_cache: torch.Tensor,  # [B, S_max, n_kv, d]
    v_cache: torch.Tensor,  # [B, S_max, n_kv, d]
    valid_from: torch.Tensor,  # [B] int — first valid cache slot per row
    valid_to0: torch.Tensor,  # [B] int — one past query 0's last visible slot
    q_lens: torch.Tensor,  # [B] int — live queries per row
    k_scale: Optional[torch.Tensor] = None,  # [B, S_max, n_kv]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-query decode attention, plain formulation: query i attends
    the window [valid_from, valid_to0 + i), the causal extension of
    `decode_attention` to Q consecutive positions.  The chunk is ragged:
    only queries i < q_lens[row] are live, and dead queries (and live
    ones with an empty window) give exact zeros."""
    if k_scale is not None:
        from areal_tpu_torch.ops.quant import kv_dequant

        k_cache = kv_dequant(k_cache, k_scale, q.dtype)
        v_cache = kv_dequant(v_cache, v_scale, q.dtype)
    b, nq_tok, n_q, d = q.shape
    n_kv = k_cache.shape[2]
    n_rep = n_q // n_kv
    qh = q.reshape(b, nq_tok, n_kv, n_rep, d)
    scale = d**-0.5
    logits = (
        torch.einsum(
            "bqgrd,bsgd->bgqrs", qh.float(), k_cache.to(q.dtype).float()
        )
        * scale
    )  # [B, n_kv, Q, n_rep, S] fp32
    idx = torch.arange(k_cache.shape[1], device=q.device)
    qi = torch.arange(nq_tok, device=q.device)
    valid = (
        (idx[None, None, :] >= valid_from[:, None, None])
        & (idx[None, None, :] < (valid_to0[:, None] + qi[None, :])[:, :, None])
        & (qi[None, :, None] < q_lens[:, None, None])
    )  # [B, Q, S]
    logits = torch.where(
        valid[:, None, :, None, :], logits, torch.full_like(logits, NEG_INF)
    )
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked queries: zero, as in decode_attention.
    probs = torch.where(
        valid.any(dim=-1)[:, None, :, None, None], probs, torch.zeros_like(probs)
    )
    out = torch.einsum(
        "bgqrs,bsgd->bqgrd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(b, nq_tok, n_q, d).to(q.dtype)


# The split kernels' walk (csrc/split_kv_attention.cuh): a block's warps
# and the positions of a warp tile.
SPLIT_WARPS = 4
SPLIT_TILE = 16
LOG2E = math.log2(math.e)


def split_window_attention(
    q: torch.Tensor,  # [B, Q, n_q, d]
    k_cache: torch.Tensor,  # [B, S, n_kv, d]
    v_cache: torch.Tensor,  # [B, S, n_kv, d]
    valid_from: torch.Tensor,  # [B] int >= 0 — first valid slot per row
    valid_to_q: torch.Tensor,  # [B, Q] int — one past each query's last slot
    span: int,  # positions a split covers, counted from valid_from
    k_scale: Optional[torch.Tensor] = None,  # [B, S, n_kv]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Split-KV (flash-decoding) attention: the model of the split
    kernels K2 and K4, their arithmetic in plain PyTorch.  Each query's
    window [valid_from, valid_to_q) is cut at valid_from + z * span; a
    block walks span z with SPLIT_WARPS warps, warp w taking its tiles w,
    w + 4, ... of SPLIT_TILE positions with an online softmax in the log2
    domain: score = (q . k) * s_k * d^-0.5 * log2(e), m the running
    maximum, l = l * 2^(m_old - m) + sum(p), o = o * 2^(m_old - m) +
    P'.v with P' = p * s_v (s_k = s_v = 1 without scales).  K and V enter
    in their own type (int8 as its integer codes), and P' is rounded to
    bf16 where the kernel runs on the tensor cores (bf16 q over a bf16 or
    an int8 cache).  The warps merge rescaled to their largest m, then the
    spans (each with l > 0, rescaled to the largest m) sum and divide by
    max(l, 1e-30): a query no span saw gives exact zeros, and an empty
    span adds no mass.  Returns fp32 [B, Q, n_q, d]: the kernel's output
    before its rounding to q's dtype."""
    b, nq_tok, n_q, d = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    rep = n_q // n_kv
    dev = q.device
    mma = q.dtype == torch.bfloat16 and k_cache.dtype in (torch.bfloat16, torch.int8)
    n_z = -(-s // span)
    n_tiles = -(-span // SPLIT_TILE)
    n_t = -(-n_tiles // SPLIT_WARPS)  # tiles of a span a warp walks
    # Position of (span z, step t, warp w, slot j) in each row: [B, Z, T, W, J].
    z = torch.arange(n_z, device=dev)[:, None, None, None]
    t = torch.arange(n_t, device=dev)[None, :, None, None]
    w = torch.arange(SPLIT_WARPS, device=dev)[None, None, :, None]
    j = torch.arange(SPLIT_TILE, device=dev)[None, None, None, :]
    off = (t * SPLIT_WARPS + w) * SPLIT_TILE + j  # within the span
    pos = valid_from.long()[:, None, None, None, None] + z * span + off
    ok = (off < span) & (pos < s)
    idx = torch.where(ok, pos, torch.zeros_like(pos)).reshape(b, -1)  # [B, N]
    rows = torch.arange(b, device=dev)[:, None]
    kg, vg = k_cache[rows, idx].float(), v_cache[rows, idx].float()  # [B, N, n_kv, d]
    qh = q.float().reshape(b, nq_tok, n_kv, rep, d)
    score = torch.einsum("bqgrd,bngd->bgqrn", qh, kg)  # [B, n_kv, Q, rep, N]
    if k_scale is not None:
        score = score * k_scale[rows, idx].float().transpose(1, 2)[:, :, None, None, :]
    scale_log2 = float(torch.tensor(d**-0.5) * torch.tensor(LOG2E))  # fp32, as the kernel
    score = score * scale_log2
    seen = (ok.reshape(b, 1, -1) & (idx[:, None, :] < valid_to_q.long()[:, :, None])
            & (idx[:, None, :] >= valid_from.long()[:, None, None]))  # [B, Q, N]
    neg = torch.tensor(-1e30, device=dev)  # the kernel's sentinel
    score = torch.where(seen[:, None, :, None, :], score, neg)
    score = score.reshape(b, n_kv, nq_tok, rep, n_z, n_t, SPLIT_WARPS, SPLIT_TILE)
    vg = vg.reshape(b, n_z, n_t, SPLIT_WARPS, SPLIT_TILE, n_kv, d)
    vs = None
    if v_scale is not None:  # [B, n_kv, 1, 1, Z, T, W, J]
        vs = v_scale[rows, idx].float().transpose(1, 2)
        vs = vs.reshape(b, n_kv, 1, 1, n_z, n_t, SPLIT_WARPS, SPLIT_TILE)
    m = torch.full(score.shape[:5] + (SPLIT_WARPS,), -1e30, device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros(m.shape + (d,), device=dev)
    for ti in range(n_t):
        sc = score[:, :, :, :, :, ti]  # [B, n_kv, Q, rep, Z, W, J]
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where((m_new > -1e30)[..., None], torch.exp2(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        if vs is not None:
            p = p * vs[:, :, :, :, :, ti]
        if mma:
            p = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bgqrzwj,bzwjgd->bgqrzwd", p, vg[:, :, ti])
        m = m_new
    # The block's warps, then the spans.
    m_blk = m.amax(-1)  # [B, n_kv, Q, rep, Z]
    f = torch.exp2(m - m_blk[..., None])
    l_blk = (f * l).sum(-1)
    o_blk = (f[..., None] * o).sum(-2)
    live = l_blk > 0
    m_all = torch.where(live, m_blk, neg).amax(-1)
    f = torch.where(live, torch.exp2(m_blk - m_all[..., None]), 0.0)
    out = (f[..., None] * o_blk).sum(-2) / (f * l_blk).sum(-1).clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, nq_tok, n_q, d)


def clamp_page_table(page_table: torch.Tensor, n_pool: int) -> torch.Tensor:
    """The one sentinel rule for paged reads, shared by the kernel and the
    plain gather: unmapped entries (>= n_pool) clamp to the LAST pool
    page so every dereference is legal; the window mask removes what
    they address (pages are mapped contiguously from position 0)."""
    return torch.clamp(page_table.long(), max=n_pool - 1)


def paged_gather_layer(
    pool_layer: torch.Tensor,  # [P, ps, ...] one layer's pool view
    page_table: torch.Tensor,  # [B, max_pages] int (sentinel >= P)
) -> torch.Tensor:
    """Gather a row-major dense window [B, max_pages*ps, ...] from the
    pool through the page table (sentinels clamped, see
    `clamp_page_table`)."""
    pt = clamp_page_table(page_table, pool_layer.shape[0])
    g = pool_layer[pt]  # [B, mp, ps, ...]
    b, mp, ps = g.shape[:3]
    return g.reshape(b, mp * ps, *pool_layer.shape[2:])


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, n_q, d]
    k_pool: torch.Tensor,  # [P, ps, n_kv, d] — one layer's pool view
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int (sentinel >= P)
    valid_to: torch.Tensor,  # [B] int — one past the last valid position
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv]: int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token decode attention through a page table, plain
    formulation: paged rows are left-aligned from flat position 0, so the
    window is [0, valid_to)."""
    ks = None if k_scale is None else paged_gather_layer(k_scale, page_table)
    vs = None if v_scale is None else paged_gather_layer(v_scale, page_table)
    return decode_attention(
        q, paged_gather_layer(k_pool, page_table),
        paged_gather_layer(v_pool, page_table),
        torch.zeros_like(valid_to, dtype=torch.long), valid_to.long(),
        k_scale=ks, v_scale=vs,
    )
