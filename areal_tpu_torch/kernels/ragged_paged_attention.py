"""Ragged paged attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel `ragged_paged_attention_kernel`
(areal_tpu/ops/pallas/paged_attention.py), and serves that file's
`paged_decode_attention_kernel` too (through
`kernels/paged_chunk_attention.py`: one token a slot).  The kernel is
hand-written CUDA C++ for Hopper
(`areal_tpu_torch/csrc/ragged_paged_attention.cu`),
built by `nvcc` at first launch (`kernels/build.py`) and bound through
ctypes.  `LAUNCHES` counts the wrapper's calls that launched the kernel
and nothing else, so a run can show that its main path went through it.

The kernel is split-KV: each (token, kv head) is served by `n_splits`
blocks, each over a span of whole pages (`split_plan`, from the shapes
alone), and a merge kernel launched by the same C entry point combines
their partials.  `ragged_paged_attention_split_reference` is
that arithmetic in plain PyTorch, for the tests and `chip_smoke.py`.

On a CPU tensor the wrapper computes the plain version
(`ragged_paged_attention_reference`); on a CUDA tensor it launches the
kernel or raises — there is no fallback.
"""

import ctypes
import functools
import os
from typing import Optional

import torch

from areal_tpu_torch.kernels import build
from areal_tpu_torch.ops.attention import (
    decode_attention,
    paged_gather_layer,
    split_window_attention,
)

SOURCE = os.path.join(build.CSRC_DIR, "ragged_paged_attention.cu")

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_REP = 16  # kMaxRep in the CUDA source
HEAD_DIMS = (64, 128, 256)  # every attention kernel's instances
# Positions a block covers, rounded to whole pages (kMaxSpanPages = 256 in
# the CUDA source bounds the pages a span).
SPLIT_POSITIONS = 256
# The H100's SMs: a grid of fewer blocks leaves SMs idle, so it takes
# shorter spans (split_plan).
SPLIT_MIN_BLOCKS = 132


def split_plan(max_pages: int, page_size: int, pairs: int = 0):
    """(span_pages, n_splits): the kernel's blocks per (token, kv head)
    each cover `span_pages` whole pages, about SPLIT_POSITIONS positions,
    and together the whole table.  Given `pairs` (tokens x kv heads), the
    span halves while the grid would hold fewer than SPLIT_MIN_BLOCKS
    blocks (16 one-token slots of a 6-page table: one-page spans).
    Shapes only: no device read."""
    span_pages = max(1, SPLIT_POSITIONS // page_size)
    while pairs and span_pages > 1 and pairs * -(-max_pages // span_pages) < SPLIT_MIN_BLOCKS:
        span_pages //= 2
    return span_pages, -(-max_pages // span_pages)


def ragged_paged_attention_reference(
    q: torch.Tensor,  # [T, n_q, d]
    k_pool: torch.Tensor,  # [P, ps, n_kv, d]
    v_pool: torch.Tensor,
    page_table_tok: torch.Tensor,  # [T, max_pages] (sentinel >= P)
    valid_to: torch.Tensor,  # [T]; 0 = dead lane
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16: int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: gather each token's window through its page
    row, then the Q=1 decode formulation with T rows (dead lanes have an
    empty window and give exact zeros)."""
    t = q.shape[0]
    k_cache = paged_gather_layer(k_pool, page_table_tok)  # [T, mp*ps, ...]
    v_cache = paged_gather_layer(v_pool, page_table_tok)
    ks = None if k_scale is None else paged_gather_layer(k_scale, page_table_tok)
    vs = None if v_scale is None else paged_gather_layer(v_scale, page_table_tok)
    out = decode_attention(
        q[:, None], k_cache, v_cache,
        torch.zeros((t,), dtype=torch.long, device=q.device),
        valid_to.long(), k_scale=ks, v_scale=vs,
    )
    return out[:, 0]


def ragged_paged_attention_split_reference(
    q: torch.Tensor,  # [T, n_q, d]
    k_pool: torch.Tensor,  # [P, ps, n_kv, d]
    v_pool: torch.Tensor,
    page_table_tok: torch.Tensor,  # [T, max_pages] (sentinel >= P)
    valid_to: torch.Tensor,  # [T]; 0 = dead lane
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    span: int,  # positions a split covers (the kernel: span_pages * ps)
) -> torch.Tensor:
    """The kernel's split-KV arithmetic in plain PyTorch
    (`ops/attention.split_window_attention`): each token's window
    (bounded by its table) cut into spans of `span` positions from 0,
    each walked as the kernel's warps walk it, one partial (o, m, l) a
    span, then the merge; fp32, before the kernel's rounding to q's
    dtype.  For the tests and chip_smoke.py; the wrapper's CPU path is
    the plain version."""
    k_cache = paged_gather_layer(k_pool, page_table_tok)  # [T, mp*ps, ...]
    v_cache = paged_gather_layer(v_pool, page_table_tok)
    ks = None if k_scale is None else paged_gather_layer(k_scale, page_table_tok)
    vs = None if v_scale is None else paged_gather_layer(v_scale, page_table_tok)
    t = q.shape[0]
    out = split_window_attention(
        q[:, None], k_cache, v_cache,
        torch.zeros((t,), dtype=torch.long, device=q.device),
        valid_to.long()[:, None], span, k_scale=ks, v_scale=vs,
    )
    return out[:, 0]


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(build.build_library(SOURCE))
    fn = lib.ragged_paged_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn  # the CDLL stays referenced with its function


def check_paged_inputs(q, k_pool, v_pool, k_scale, v_scale, q_dims, **index):
    """The checks the paged attention kernels (K2, K3) share: q float32
    or bfloat16 with `q_dims` dims and a head_dim the kernels take; pools
    [P, ps, n_kv, d] of one of float32/bfloat16/int8, with bfloat16
    [P, ps, n_kv] scales exactly when int8; `index` tensors int32; every
    tensor contiguous on q's device."""
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, **index}
    quant = k_pool.dtype == torch.int8
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 pool needs k_scale and v_scale")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    elif k_scale is not None or v_scale is not None:
        raise ValueError("k_scale/v_scale are only taken with an int8 pool")
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"pools must share one of float32/bfloat16/int8, got "
            f"{k_pool.dtype}/{v_pool.dtype}"
        )
    if quant and (
        k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16
    ):
        raise TypeError("int8 pool scales must be bfloat16")
    for name, x in index.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if q.dim() != q_dims or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"want q with {q_dims} dims and pools [P, ps, n_kv, d], got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}"
        )
    n_q, d = q.shape[-2:]
    n_pool, ps, n_kv, d_kv = k_pool.shape
    if n_pool < 1 or ps < 1:
        raise ValueError("the pool must not be empty")
    if d != d_kv:
        raise ValueError(f"q's head_dim {d} differs from the pools' {d_kv}")
    check_head_dim(d)
    if n_q % n_kv or n_q // n_kv > _MAX_REP:
        raise ValueError(
            f"n_q={n_q} must be a multiple of n_kv={n_kv}, at most "
            f"{_MAX_REP} per kv head"
        )
    if quant and (
        tuple(k_scale.shape) != (n_pool, ps, n_kv)
        or tuple(v_scale.shape) != (n_pool, ps, n_kv)
    ):
        raise ValueError("int8 pool scales must be [P, ps, n_kv]")


def check_head_dim(d: int) -> None:
    """The head dims the attention kernels (K1f, K1dq, K1dkv, K2, K3, K4)
    are built for; the JAX package's Pallas kernels take any."""
    if d not in HEAD_DIMS:
        raise ValueError(
            f"head_dim must be one of {HEAD_DIMS}, got {d}: the kernels for other "
            "head dims are ROADMAP queue 1 item 9.3"
        )


def check_aligned(**tensors):
    """The kernels that copy rows as 16-byte vectors (K2, K3, K4 and the
    flash kernels K1f, K1dq, K1dkv): each tensor must start on a 16-byte
    boundary."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check(q, k_pool, v_pool, page_table_tok, valid_to, k_scale, v_scale):
    check_paged_inputs(
        q, k_pool, v_pool, k_scale, v_scale, 3,
        page_table_tok=page_table_tok, valid_to=valid_to,
    )
    t = q.shape[0]
    if (page_table_tok.dim() != 2 or page_table_tok.shape[0] != t
            or page_table_tok.shape[1] < 1):
        raise ValueError(
            f"page_table_tok must be [T={t}, max_pages >= 1], got "
            f"{tuple(page_table_tok.shape)}"
        )
    if tuple(valid_to.shape) != (t,):
        raise ValueError(f"valid_to must be [T={t}], got {tuple(valid_to.shape)}")


def ragged_paged_attention_kernel(
    q: torch.Tensor,  # [T, n_q, d] float32/bfloat16
    k_pool: torch.Tensor,  # [P, ps, n_kv, d] float32/bfloat16/int8
    v_pool: torch.Tensor,
    page_table_tok: torch.Tensor,  # [T, max_pages] int32 (sentinel >= P)
    valid_to: torch.Tensor,  # [T] int32 — one past each window; 0 = dead
    k_scale: Optional[torch.Tensor] = None,  # [P, ps, n_kv] bf16 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[T, n_q, d] in q's dtype.  CPU tensors: the plain version.  CUDA
    tensors: the sm_90a kernel, on the current stream, or an error.
    One call adds one to LAUNCHES: the split pass and, when the table
    takes more than one span, the merge launched after it.  Nothing is
    read from the device on the host."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, page_table_tok, valid_to, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_paged_attention for device {q.device}")
    _check(q, k_pool, v_pool, page_table_tok, valid_to, k_scale, v_scale)
    check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    t, n_q, d = q.shape
    n_pool, ps, n_kv, _ = k_pool.shape
    mp = page_table_tok.shape[1]
    span_pages, n_splits = split_plan(mp, ps, t * n_kv)
    out = torch.empty_like(q)
    scratch = None  # partials: o [n_splits, T*n_q, d], then m and l
    if n_splits > 1:
        scratch = torch.empty(
            n_splits * t * n_q * (d + 2), dtype=torch.float32, device=q.device
        )
    _, launch = _launcher()
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            page_table_tok.data_ptr(), valid_to.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            t, n_q, n_kv, d, n_pool, ps, mp, span_pages, n_splits,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {rc}"
        )
    build.count_launch(globals(), "LAUNCHES")
    return out
