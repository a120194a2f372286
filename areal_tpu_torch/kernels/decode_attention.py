"""Dense decode attention (K4): the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel `decode_attention_chunk_kernel` (body
`_chunk_kernel`) of areal_tpu/ops/pallas/decode_attention.py and its Q=1
call `decode_attention_kernel`.  Row b carries Q queries over a dense KV
window [B, S, n_kv, d]; query i attends positions [valid_from[b],
valid_to0[b] + i), and an empty window gives exact zeros.  The Q=1 form
is the chunk form's call, as in the JAX package, so one kernel body
serves both and a masking fix cannot split them.  The kernel is
hand-written CUDA C++ for Hopper (`areal_tpu_torch/csrc/decode_attention.cu`),
built by `nvcc` at first launch (`kernels/build.py`) and bound through
ctypes.  `LAUNCHES` counts the wrapper's calls that launched the kernel
and nothing else.  The kernel is split-KV: each (row, kv head, query
tile) is served by `n_splits` blocks of SPLIT_POSITIONS positions from
`valid_from` (`split_plan`, from S alone), and a merge kernel launched by
the same C entry point combines their partials.
`decode_attention_chunk_split_reference` is that arithmetic in plain
PyTorch, for the tests and `chip_smoke.py`.

On a CPU tensor the wrapper computes the plain version (the function of
`ops/attention.decode_attention_chunk` with every query live) over the
span of the rows' windows, as two batched matmuls under a mask that
`decode_window` builds once for every layer of a decode step; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
"""

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import torch

from areal_tpu_torch.kernels import build
from areal_tpu_torch.kernels.ragged_paged_attention import (
    check_aligned,
    check_paged_inputs,
)
from areal_tpu_torch.ops.attention import NEG_INF, split_window_attention
from areal_tpu_torch.ops.quant import kv_dequant

SOURCE = os.path.join(build.CSRC_DIR, "decode_attention.cu")

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SPLIT_POSITIONS = 256  # positions a block covers


def split_plan(s: int):
    """(span, n_splits): the kernel's blocks per (row, kv head, query
    tile) each cover `span` positions from valid_from, and together any
    window of the S-position cache.  Shapes only: no device read."""
    return SPLIT_POSITIONS, -(-s // SPLIT_POSITIONS)


def decode_attention_chunk_split_reference(
    q: torch.Tensor,  # [B, Q, n_q, d]
    k_cache: torch.Tensor,  # [B, S, n_kv, d]
    v_cache: torch.Tensor,
    valid_from: torch.Tensor,  # [B]
    valid_to0: torch.Tensor,  # [B]
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    span: int,  # positions a split covers (the kernel: SPLIT_POSITIONS)
) -> torch.Tensor:
    """The kernel's split-KV arithmetic in plain PyTorch
    (`ops/attention.split_window_attention`): each row's window cut into
    spans of `span` positions from valid_from, each walked as the
    kernel's warps walk it, one partial (o, m, l) a span, then the merge;
    fp32, before the kernel's rounding to q's dtype.  For the tests and
    chip_smoke.py; the wrapper's CPU path is the plain version."""
    qi = torch.arange(q.shape[1], device=q.device)
    valid_to_q = (valid_to0.long()[:, None] + qi[None, :]).clamp(max=k_cache.shape[1])
    return split_window_attention(
        q, k_cache, v_cache, valid_from.long().clamp(min=0), valid_to_q, span,
        k_scale=k_scale, v_scale=v_scale,
    )


@dataclasses.dataclass
class DecodeWindow:
    """What the CPU's plain version needs of a step's windows, built once
    for all its layers (`decode_window`): the span [lo, hi) of the cache
    that holds every row's window, `masked` [B, 1, Q, 1, hi - lo] (True
    outside query i's window [valid_from, valid_to0 + i)) and `live`
    [B, 1, Q, 1, 1] (0.0 for a query with an empty window, else 1.0)."""

    lo: int
    hi: int
    masked: torch.Tensor
    live: torch.Tensor


def decode_window(
    valid_from: torch.Tensor, valid_to0: torch.Tensor, n_queries: int, s: int
) -> Optional[DecodeWindow]:
    """The plain version's window over an S-position cache for Q =
    `n_queries` queries a row, or None on the card, whose kernel reads
    the windows itself.  Only the span of the rows' windows enters the
    products: a slot outside every window takes weight exactly 0, and a
    dense cache is mostly such slots (a burst's prompt padding and its
    undecoded tail).  Reads the windows' bounds on the host."""
    if valid_from.device.type != "cpu":
        return None
    vf, vt = valid_from.long(), valid_to0.long()
    lo = min(max(int(vf.min()), 0), s - 1)
    hi = min(max(int(vt.max()) + n_queries - 1, lo + 1), s)
    idx = torch.arange(lo, hi)
    qi = torch.arange(n_queries)
    valid = (idx[None, None, :] >= vf[:, None, None]) & (
        idx[None, None, :] < (vt[:, None] + qi[None, :])[:, :, None]
    )  # [B, Q, hi - lo]
    live = valid.any(dim=-1).to(torch.float32)
    return DecodeWindow(lo, hi, ~valid[:, None, :, None, :], live[:, None, :, None, None])


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _plain_over_window(q, k_cache, v_cache, k_scale, v_scale, win: DecodeWindow):
    """`ops/attention.decode_attention_chunk` with every query live, on
    the span of `win`, as two batched matmuls: q [B, n_kv, Q * rep, d]
    against k [B, n_kv, d, span], the mask and the empty-window zeros
    from `win`.  An int8 cache is dequantized to q's dtype first, and the
    probabilities meet v in v's dtype, as in the plain version."""
    k_cache, v_cache = k_cache[:, win.lo:win.hi], v_cache[:, win.lo:win.hi]
    if k_scale is not None:
        k_cache = kv_dequant(k_cache, k_scale[:, win.lo:win.hi], q.dtype)
        v_cache = kv_dequant(v_cache, v_scale[:, win.lo:win.hi], q.dtype)
    b, nq_tok, n_q, d = q.shape
    span, n_kv = k_cache.shape[1], k_cache.shape[2]
    rep = n_q // n_kv
    qh = _float(q).reshape(b, nq_tok, n_kv, rep, d).transpose(1, 2)
    kt = _float(k_cache.to(q.dtype)).permute(0, 2, 3, 1)  # [B, n_kv, d, span]
    logits = torch.matmul(qh.reshape(b, n_kv, nq_tok * rep, d), kt) * d**-0.5
    logits = logits.view(b, n_kv, nq_tok, rep, span).masked_fill(win.masked, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * win.live
    if v_cache.dtype != torch.float32:
        probs = probs.to(v_cache.dtype).float()
    out = torch.matmul(
        probs.view(b, n_kv, nq_tok * rep, span), _float(v_cache).transpose(1, 2)
    )  # [B, n_kv, Q * rep, d]
    return out.view(b, n_kv, nq_tok, rep, d).transpose(1, 2).reshape(b, nq_tok, n_q, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(build.build_library(SOURCE))
    fn = lib.decode_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn  # the CDLL stays referenced with its function


def _check(q, k_cache, v_cache, valid_from, valid_to0, k_scale, v_scale):
    # The dense cache [B, S, n_kv, d] has the paged pool's layout with
    # rows for pages and positions for page slots, so the paged kernels'
    # checks apply as they are.
    check_paged_inputs(
        q, k_cache, v_cache, k_scale, v_scale, 4,
        valid_from=valid_from, valid_to0=valid_to0,
    )
    b = q.shape[0]
    if k_cache.shape[0] != b:
        raise ValueError(
            f"k/v caches must have B={b} rows, got {tuple(k_cache.shape)}"
        )
    for name, x in (("valid_from", valid_from), ("valid_to0", valid_to0)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be [B={b}], got {tuple(x.shape)}")


def decode_attention_chunk_kernel(
    q: torch.Tensor,  # [B, Q, n_q, d] float32/bfloat16
    k_cache: torch.Tensor,  # [B, S, n_kv, d] float32/bfloat16/int8
    v_cache: torch.Tensor,
    valid_from: torch.Tensor,  # [B] int32 — first valid position
    valid_to0: torch.Tensor,  # [B] int32 — one past query 0's window
    k_scale: Optional[torch.Tensor] = None,  # [B, S, n_kv] bf16 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    window: Optional["DecodeWindow"] = None,  # decode_window(valid_from, valid_to0, Q, S)
) -> torch.Tensor:
    """[B, Q, n_q, d] in q's dtype.  CPU tensors: the plain version, over
    `window` when the caller built it once for all its layers.  CUDA
    tensors: the sm_90a kernel, on the current stream, or an error (the
    kernel reads valid_from and valid_to0 itself; `window` is unused).
    One call adds one to LAUNCHES: the split pass and, when S takes more
    than one span, the merge launched after it.  Nothing is read from the
    device on the host."""
    if q.device.type == "cpu":
        if window is None:
            window = decode_window(valid_from, valid_to0, q.shape[1], k_cache.shape[1])
        return _plain_over_window(q, k_cache, v_cache, k_scale, v_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    _check(q, k_cache, v_cache, valid_from, valid_to0, k_scale, v_scale)
    check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    b, nq_tok, n_q, d = q.shape
    _, s, n_kv, _ = k_cache.shape
    span, n_splits = split_plan(s)
    out = torch.empty_like(q)
    scratch = None  # partials: o [n_splits, B*Q*n_q, d], then m and l
    if n_splits > 1:
        scratch = torch.empty(
            n_splits * out.numel() // d * (d + 2), dtype=torch.float32,
            device=q.device,
        )
    _, launch = _launcher()
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            valid_from.data_ptr(), valid_to0.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, nq_tok, n_q, n_kv, d, s, span, n_splits,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {rc}")
    build.count_launch(globals(), "LAUNCHES")
    return out


def decode_attention_kernel(
    q: torch.Tensor,  # [B, 1, n_q, d]
    k_cache: torch.Tensor,  # [B, S, n_kv, d]
    v_cache: torch.Tensor,
    valid_from: torch.Tensor,  # [B] int32
    valid_to: torch.Tensor,  # [B] int32 — one past the last valid position
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional["DecodeWindow"] = None,
) -> torch.Tensor:
    """Single-token decode attention: the chunk kernel at Q=1, whose
    query 0 sees [valid_from, valid_to)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"want q [B, 1, n_q, d], got {tuple(q.shape)}")
    return decode_attention_chunk_kernel(
        q, k_cache, v_cache, valid_from, valid_to, k_scale, v_scale, window
    )
