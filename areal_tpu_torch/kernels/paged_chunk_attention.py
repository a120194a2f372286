"""Per-slot paged chunk attention (K3): the CUDA kernel's wrapper and its
plain version.

Replaces the TPU kernel `paged_decode_attention_chunk_kernel`
(areal_tpu/ops/pallas/paged_attention.py, body `_paged_chunk_kernel`)
and the function that dispatches to it, `paged_decode_attention_chunk`
(areal_tpu/ops/attention.py).  Slot b carries Q queries; query i attends
flat positions [0, valid_to0[b] + i) through `page_table[b]`, and only
queries i < q_lens[b] are live (dead ones give exact zeros).  The kernel
is hand-written CUDA C++ for Hopper
(`areal_tpu_torch/csrc/paged_chunk_attention.cu`), built by `nvcc` at
first launch (`kernels/build.py`) and bound through ctypes.  `LAUNCHES`
counts the kernel's launches and nothing else.  The same file's Q=1
entry point `paged_decode_attention_kernel` (the chunk kernel at Q=1 in
the JAX package) computes the ragged stream attention's function with
one token a slot, so here it is K2's split-KV kernel
(`kernels/ragged_paged_attention.py`), which serves one query a slot
with every SM busy, where the chunk kernel's 64-row blocks would hold 6
live rows each.

On a CPU tensor the wrapper computes the plain version
(`paged_chunk_attention_reference`); on a CUDA tensor it launches the
kernel or raises — there is no fallback.
`paged_chunk_attention_tiled_reference` is the kernel's own arithmetic
(tiles of TILE_POSITIONS positions, online softmax in the log2 domain,
bf16 P on the tensor-core path) in plain PyTorch, for the tests and
`chip_smoke.py`.
"""

import ctypes
import functools
import math
import os
from typing import Optional

import torch

from areal_tpu_torch.kernels import build
from areal_tpu_torch.kernels.ragged_paged_attention import (
    check_aligned,
    check_paged_inputs,
    ragged_paged_attention_kernel,
)
from areal_tpu_torch.ops.attention import decode_attention_chunk, paged_gather_layer

SOURCE = os.path.join(build.CSRC_DIR, "paged_chunk_attention.cu")

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TILE_POSITIONS = 32  # key positions per ring stage of the kernel (kPos)


def paged_chunk_attention_reference(
    q: torch.Tensor,  # [B, Q, n_q, d]
    k_pool: torch.Tensor,  # [P, ps, n_kv, d]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] (sentinel >= P)
    valid_to0: torch.Tensor,  # [B] — one past query 0's window
    q_lens: torch.Tensor,  # [B] live queries per row
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16: int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: gather each slot's window through its page row
    (`paged_gather_layer`), then `decode_attention_chunk` over windows
    that start at position 0."""
    k_cache = paged_gather_layer(k_pool, page_table)
    v_cache = paged_gather_layer(v_pool, page_table)
    ks = None if k_scale is None else paged_gather_layer(k_scale, page_table)
    vs = None if v_scale is None else paged_gather_layer(v_scale, page_table)
    return decode_attention_chunk(
        q, k_cache, v_cache, torch.zeros_like(valid_to0, dtype=torch.long),
        valid_to0.long(), q_lens.long(),
        k_scale=ks, v_scale=vs,
    )


def paged_chunk_attention_tiled_reference(
    q: torch.Tensor,  # [B, Q, n_q, d]
    k_pool: torch.Tensor,  # [P, ps, n_kv, d]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] (sentinel >= P)
    valid_to0: torch.Tensor,  # [B]
    q_lens: torch.Tensor,  # [B]
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16: int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  A slot's rows are
    flattened across queries (row r = query r // rep, head r % rep of its
    kv group), as the kernel's 64-row blocks take them; a row's result
    does not depend on the block it falls in.  Row r sees positions
    [0, min(valid_to0 + i, max_pages * page_size)) while its query i <
    q_lens, none otherwise.  Scores are in the log2 domain, and the
    window is walked in tiles of TILE_POSITIONS from 0 with an online
    softmax: m = the running maximum, l = l * 2^(m_old - m) + sum(p),
    o = o * 2^(m_old - m) + P.V.  On the tensor-core paths P goes to
    bf16 before P.V: bf16 q over a bf16 pool, and bf16 q over an int8
    pool, where K and V stay integer codes (exact in bf16), each score is
    multiplied by its position's s_k before the maximum, l sums the
    unscaled P and P.V takes P' = bf16(P * s_v).  Every other type pair
    stays in fp32, with int8 pools dequantized by their scales.  A row
    that sees no position gives exact zeros.  Returns fp32 [B, Q, n_q, d]:
    the kernel's output before it is rounded to q's dtype."""
    b, nq_tok, n_q, d = q.shape
    n_kv = k_pool.shape[2]
    rep = n_q // n_kv
    bf16_path = q.dtype == torch.bfloat16 and k_pool.dtype in (torch.bfloat16, torch.int8)
    kc = paged_gather_layer(k_pool, page_table).float()  # [B, S, n_kv, d]
    vc = paged_gather_layer(v_pool, page_table).float()
    ks = vs = None  # [B, n_kv, 1, S]: the scales the tensor-core walk applies
    if k_scale is not None:
        ksg = paged_gather_layer(k_scale, page_table).float()  # [B, S, n_kv]
        vsg = paged_gather_layer(v_scale, page_table).float()
        if bf16_path:
            ks, vs = (x.permute(0, 2, 1)[:, :, None, :] for x in (ksg, vsg))
        else:
            kc = kc * ksg[..., None]
            vc = vc * vsg[..., None]
    s_len = kc.shape[1]
    qf = q.float().reshape(b, nq_tok, n_kv, rep, d).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, n_kv, nq_tok * rep, d)
    qi = torch.arange(nq_tok, device=q.device).repeat_interleave(rep)  # [R]
    lim = torch.where(
        qi[None, :] < q_lens.long()[:, None],
        (valid_to0.long()[:, None] + qi[None, :]).clamp(0, s_len),
        0,
    )  # [B, R]
    scale_log2 = d**-0.5 * math.log2(math.e)
    scores = torch.einsum("bgrd,bsgd->bgrs", qf, kc)
    scores = scores * (scale_log2 if ks is None else ks * scale_log2)
    seen = torch.arange(s_len, device=q.device)[None, None, :] < lim[:, None, :, None]
    neg = torch.tensor(-1e30, device=q.device)
    m = torch.full(qf.shape[:3], -1e30, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    tile = TILE_POSITIONS
    for t0 in range(0, s_len, tile):
        s = torch.where(seen[..., t0 : t0 + tile], scores[..., t0 : t0 + tile], neg)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where((m_new > -1e30)[..., None], torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        if vs is not None:
            p = p * vs[..., t0 : t0 + tile]
        if bf16_path:
            p = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bgrs,bsgd->bgrd", p, vc[:, t0 : t0 + tile])
        m = m_new
    o = o / l.clamp(min=1e-30)[..., None]
    o = o.reshape(b, n_kv, nq_tok, rep, d).permute(0, 2, 1, 3, 4)
    return o.reshape(b, nq_tok, n_q, d)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(build.build_library(SOURCE))
    fn = lib.paged_chunk_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn  # the CDLL stays referenced with its function


def _check(q, k_pool, v_pool, page_table, valid_to0, q_lens, k_scale, v_scale):
    check_paged_inputs(
        q, k_pool, v_pool, k_scale, v_scale, 4,
        page_table=page_table, valid_to0=valid_to0, q_lens=q_lens,
    )
    b = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b or page_table.shape[1] < 1:
        raise ValueError(
            f"page_table must be [B={b}, max_pages >= 1], got "
            f"{tuple(page_table.shape)}"
        )
    for name, x in (("valid_to0", valid_to0), ("q_lens", q_lens)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be [B={b}], got {tuple(x.shape)}")
    check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)


def paged_decode_attention_chunk(
    q: torch.Tensor,  # [B, Q, n_q, d] float32/bfloat16
    k_pool: torch.Tensor,  # [P, ps, n_kv, d] float32/bfloat16/int8
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32 (sentinel >= P)
    valid_to0: torch.Tensor,  # [B] int32 — one past query 0's window
    q_lens: torch.Tensor,  # [B] int32 — live queries per row
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, Q, n_q, d] in q's dtype.  CPU tensors: the plain version.  CUDA
    tensors: the sm_90a kernel, on the current stream, or an error."""
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_pool, v_pool, page_table, valid_to0, q_lens, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no paged_decode_attention_chunk for device {q.device}")
    b, nq_tok, n_q, d = q.shape
    _check(q, k_pool, v_pool, page_table, valid_to0, q_lens, k_scale, v_scale)
    n_pool, ps, n_kv, _ = k_pool.shape
    out = torch.empty_like(q)
    _, launch = _launcher()
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            page_table.data_ptr(), valid_to0.data_ptr(), q_lens.data_ptr(),
            out.data_ptr(),
            b, nq_tok, n_q, n_kv, d, n_pool, ps, page_table.shape[1],
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"paged_chunk_attention kernel launch failed: cudaError {rc}"
        )
    build.count_launch(globals(), "LAUNCHES")
    return out


def paged_decode_attention_kernel(
    q: torch.Tensor,  # [B, 1, n_q, d] float32/bfloat16
    k_pool: torch.Tensor,  # [P, ps, n_kv, d] float32/bfloat16/int8
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32 (sentinel >= P)
    valid_to: torch.Tensor,  # [B] int32 — one past the last valid position
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token paged decode attention: slot b's one query sees [0,
    valid_to[b]) through page_table[b], bounded by the table; a parked
    slot (valid_to 0) gives exact zeros.  That is the ragged stream
    attention with one token a slot, so this is K2's wrapper
    (`ragged_paged_attention_kernel`) on q[:, 0]: its split-KV kernel on
    the card, its launches counted in that module's LAUNCHES (not in
    this one's), and its plain version on CPU tensors."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"want q [B, 1, n_q, d], got {tuple(q.shape)}")
    return ragged_paged_attention_kernel(
        q[:, 0], k_pool, v_pool, page_table, valid_to, k_scale, v_scale
    )[:, None]
