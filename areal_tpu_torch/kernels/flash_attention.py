"""Segment-aware causal flash attention: the CUDA kernels' wrapper (a
`torch.autograd.Function`) and its plain version.

Replaces the TPU kernels of areal_tpu/ops/pallas/flash_attention.py: the
forward `_fwd` (K1f, which also returns the fp32 logsumexp) and the two
backward kernels of `_bwd`, `_dq_kernel` (K1dq) and `_dkv_kernel`
(K1dkv).  The kernels are hand-written CUDA C++ for Hopper
(`areal_tpu_torch/csrc/flash_attention.cu`), built by `nvcc` at first
launch (`kernels/build.py`) and bound through ctypes.  `LAUNCHES` counts
each kernel's launches and nothing else.

`flash_attention(q, k, v, segment_ids)` on CPU tensors computes the plain
version (`ops/attention.packed_attention_reference`, differentiated by
autograd); on CUDA tensors it runs the kernels — forward K1f, backward
Δ = rowsum(o∘dO) then K1dq and K1dkv — or raises.  There is no fallback.
`flash_bwd_reference` is the plain version of K1dq and K1dkv: the same
gradients from the same Δ, dense, in fp32.  The bf16 kernels run on the
tensor cores, and their own arithmetic is modelled for the tests and
`chip_smoke.py`: `flash_fwd_bf16_reference` (the online softmax over
64-key tiles, P rounded to bf16 before P·V), `flash_dq_bf16_reference`
(dS split into a bf16 hi + lo pair before dS·K) and
`flash_dkv_bf16_reference` (P and dS rounded to bf16 before their
products).
"""

import ctypes
import functools
import math
import os

import torch

from areal_tpu_torch.kernels import build
from areal_tpu_torch.kernels.ragged_paged_attention import check_aligned
from areal_tpu_torch.ops.attention import (
    NEG_INF,
    make_packed_mask,
    packed_attention_reference,
    repeat_kv,
)

SOURCE = os.path.join(build.CSRC_DIR, "flash_attention.cu")

LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
DEFAULT_BLOCK = 128  # the JAX package's block size, for its shape rule


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = ctypes.CDLL(build.build_library(SOURCE))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 7 + [ctypes.c_float, ptr]  # B S Hq Hkv D dtype causal scale stream
    fns = {
        "fwd": (lib.flash_attention_fwd, [ptr] * 6 + tail),
        "dq": (lib.flash_attention_bwd_dq, [ptr] * 8 + tail),
        "dkv": (lib.flash_attention_bwd_dkv, [ptr] * 9 + tail),
    }
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, {name: fn for name, (fn, _) in fns.items()}


def check_inputs(q, k, v, segment_ids) -> None:
    """The shape rule of the JAX wrapper (`flash_attention.py:461-470`):
    rows of S positions with S a multiple of min(128, S), plus what the
    kernels take: [B, S, H, D] q/k/v of one float dtype, GQA head counts,
    int segment ids [B, S]."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B, S, Hq, D] and k/v [B, S, Hkv, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"n_q={hq} must be a multiple of n_kv={hkv}")
    if tuple(segment_ids.shape) != (b, s):
        raise ValueError(
            f"segment_ids must be [B={b}, S={s}], got {tuple(segment_ids.shape)}"
        )
    block = min(DEFAULT_BLOCK, s)
    if s % block:
        raise ValueError(
            f"sequence length {s} must be a multiple of block sizes "
            f"({block}, {block})"
        )


def _check_cuda(q, k, v, segment_ids) -> None:
    for name, x in (("k", k), ("v", v), ("segment_ids", segment_ids)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS}, got {q.shape[3]}")


def _check_buffers(seg, *tensors) -> None:
    """What the kernels read through raw pointers: contiguous tensors,
    int32 segment ids, fp32 lse/delta (checked by the callers' dtypes)."""
    if seg.dtype != torch.int32:
        raise TypeError(f"segment ids must be int32, got {seg.dtype}")
    for x in (seg, *tensors):
        if not x.is_contiguous():
            raise ValueError("the flash attention kernels take contiguous tensors")


def _launch(name: str, *args) -> None:
    _, fns = _launchers()
    rc = fns[name](*args)
    if rc != 0:
        raise RuntimeError(f"flash attention {name} kernel launch failed: cudaError {rc}")
    build.count_launch(LAUNCHES, name)


def _dims(q, k, causal):
    b, s, hq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b, s, hq, k.shape[2], d, _DTYPE_CODE[q.dtype], int(causal), d**-0.5, stream)


def flash_fwd(q, k, v, seg, causal: bool):
    """K1f: (o [B, S, Hq, D] in q's dtype, lse [B, S, Hq] fp32).  bf16
    runs on the tensor cores (`flash_fwd_bf16_reference` is its
    arithmetic), fp32 on the CUDA cores."""
    _check_buffers(seg, q, k, v)
    check_aligned(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(
            "fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *_dims(q, k, causal),
        )
    return o, lse


def _bwd_ptrs(q, k, v, seg, do, lse, delta):
    _check_buffers(seg, q, k, v, do, lse, delta)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 or do.dtype != q.dtype:
        raise TypeError("lse and delta must be float32 and do in q's dtype")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())


def flash_dq(q, k, v, seg, do, lse, delta, causal: bool):
    """K1dq: dq in q's dtype.  bf16 runs on the tensor cores
    (`flash_dq_bf16_reference` is its arithmetic), fp32 on the CUDA
    cores."""
    ptrs = _bwd_ptrs(q, k, v, seg, do, lse, delta)
    check_aligned(q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("dq", *ptrs, dq.data_ptr(), *_dims(q, k, causal))
    return dq


def flash_dkv(q, k, v, seg, do, lse, delta, causal: bool):
    """K1dkv: dk, dv in k's dtype, summed over each kv head's q heads.
    bf16 runs on the tensor cores (`flash_dkv_bf16_reference` is its
    arithmetic), fp32 on the CUDA cores."""
    ptrs = _bwd_ptrs(q, k, v, seg, do, lse, delta)
    check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *_dims(q, k, causal))
    return dk, dv


def flash_delta(o, do):
    """Δ = rowsum(o∘dO) in fp32, [B, S, Hq] (outside the kernels, as in
    `_bwd`)."""
    return (o.float() * do.float()).sum(-1).contiguous()


def flash_bwd(q, k, v, seg, o, lse, do, causal: bool):
    """Δ, then K1dq and K1dkv.  Returns dq, dk, dv in their inputs'
    dtypes."""
    delta = flash_delta(o, do)
    dq = flash_dq(q, k, v, seg, do, lse, delta, causal)
    dk, dv = flash_dkv(q, k, v, seg, do, lse, delta, causal)
    return dq, dk, dv


def flash_bwd_reference(q, k, v, seg, do, delta, causal: bool = True):
    """The plain version of K1dq and K1dkv, dense and in fp32: P from the
    masked softmax, dS = P∘(dP − Δ)·scale with dP = dO·Vᵀ and the GIVEN
    Δ [B, S, Hq] (so a bf16 caller passes Δ of its rounded o, as the
    kernels get it), dq = dS·K, and dk = dSᵀ·Q, dv = Pᵀ·dO summed over
    each kv head's q heads.  Returns fp32 dq, dk, dv."""
    n_rep = q.shape[2] // k.shape[2]
    qf, dof = q.float(), do.float()
    kf, vf = repeat_kv(k.float(), n_rep), repeat_kv(v.float(), n_rep)
    scale = q.shape[-1] ** -0.5
    mask = make_packed_mask(seg, causal=causal)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float().transpose(1, 2)[..., None]) * scale
    b, s, hq, d = q.shape
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, s, -1, n_rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, s, -1, n_rep, d).sum(3)
    return dq, dk, dv


KEY_TILE = 64  # keys per tile of the bf16 forward kernel's walk
KERNEL_NEG = -1e30  # the kernels' mask value, and the lse of a row that attends nothing


def flash_fwd_bf16_reference(q, k, v, seg, causal: bool = True):
    """The bf16 K1f kernel's arithmetic in plain PyTorch: the online
    softmax over tiles of KEY_TILE keys in order, in the log2 domain
    (scores S·scale·log2e, masked to -1e30; running max m, α = 2^(m_old −
    m)), with l summing the fp32 probabilities and P rounded to bf16
    before P·V (fp32 sums).  q, k and v enter with the values they hold
    (bf16 on the kernel's path).  Returns fp32 o [B, S, Hq, D] (0 on rows
    that attend nothing) and lse [B, S, Hq] = m·ln 2 + ln l (-1e30 there)."""
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float()
    kf, vf = repeat_kv(k.float(), n_rep), repeat_kv(v.float(), n_rep)
    b, s, hq, d = q.shape
    scale_log2 = d**-0.5 * math.log2(math.e)
    mask = make_packed_mask(seg, causal=causal)  # [B, 1, S, S]
    m = torch.full((b, hq, s, 1), KERNEL_NEG, device=q.device)
    l = torch.zeros((b, hq, s, 1), device=q.device)
    acc = torch.zeros((b, hq, s, d), device=q.device)
    for k0 in range(0, s, KEY_TILE):
        kt, vt = kf[:, k0 : k0 + KEY_TILE], vf[:, k0 : k0 + KEY_TILE]
        st = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * scale_log2
        st = torch.where(mask[..., k0 : k0 + KEY_TILE], st, KERNEL_NEG)
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(m_new > KERNEL_NEG, torch.exp2(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vt
        )
        m = m_new
    live = l > 0
    o = torch.where(live, acc / torch.where(live, l, 1.0), 0.0)
    lse = torch.where(live, m * math.log(2.0) + torch.log(torch.where(live, l, 1.0)),
                      KERNEL_NEG)
    return o.transpose(1, 2), lse[..., 0].transpose(1, 2)


def _bf16_p_ds(q, k, v, seg, do, lse, delta, causal):
    """The bf16 backward kernels' P and dS, dense and in fp32 [B, Hq, S,
    S]: from the GIVEN lse [B, S, Hq] (the forward's) and Δ, P = 2^(S·scale
    ·log2e − lse·log2e) under the mask and dS = P∘(dP − Δ)·scale.  Also
    returns q, dO and the repeated k as fp32."""
    n_rep = q.shape[2] // k.shape[2]
    qf, dof = q.float(), do.float()
    kf, vf = repeat_kv(k.float(), n_rep), repeat_kv(v.float(), n_rep)
    scale = q.shape[-1] ** -0.5
    log2e = math.log2(math.e)
    mask = make_packed_mask(seg, causal=causal)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    lse2 = lse.float().transpose(1, 2)[..., None] * log2e
    p = torch.where(mask, torch.exp2(logits * (scale * log2e) - lse2), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float().transpose(1, 2)[..., None]) * scale
    return p, ds, qf, dof, kf


def flash_dq_bf16_reference(q, k, v, seg, do, lse, delta, causal: bool = True):
    """The bf16 K1dq kernel's arithmetic, dense, in plain PyTorch: dS as
    in `_bf16_p_ds`, split as the kernel splits it for its tensor-core
    products into hi = bf16(dS) and lo = bf16(dS − hi), then dq = hi·K +
    lo·K (fp32 sums).  q, k, v and do enter with the values they hold
    (bf16 on the kernel's path).  Returns fp32 dq."""
    _, ds, _, _, kf = _bf16_p_ds(q, k, v, seg, do, lse, delta, causal)
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", hi, kf) + torch.einsum("bhqk,bkhd->bqhd", lo, kf)


def flash_dkv_bf16_reference(q, k, v, seg, do, lse, delta, causal: bool = True):
    """The bf16 K1dkv kernel's arithmetic, dense, in plain PyTorch: P and
    dS as in `_bf16_p_ds`, rounded to bf16 as the kernel rounds them for
    its two tensor-core products, then dv = Pᵀ·dO and dk = dSᵀ·Q (fp32
    sums), summed over each kv head's q heads.  q, k, v and do enter with
    the values they hold (bf16 on the kernel's path).  Returns fp32 dk,
    dv."""
    p, ds, qf, dof, _ = _bf16_p_ds(q, k, v, seg, do, lse, delta, causal)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    b, s, hq, d = q.shape
    n_rep = hq // k.shape[2]
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, s, -1, n_rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, s, -1, n_rep, d).sum(3)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, causal):
        o, lse = flash_fwd(q, k, v, seg, causal)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, seg, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, n_q, d]
    k: torch.Tensor,  # [B, S, n_kv, d]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, S] int, 0 = pad
    causal: bool = True,
) -> torch.Tensor:
    """Segment-aware causal attention over packed rows, [B, S, n_q, d] in
    q's dtype.  CPU tensors: the plain version.  CUDA tensors: K1f
    forward, K1dq/K1dkv backward, on the current stream, or an error."""
    check_inputs(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, segment_ids, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check_cuda(q, k, v, segment_ids)
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids.to(torch.int32).contiguous(), bool(causal),
    )
