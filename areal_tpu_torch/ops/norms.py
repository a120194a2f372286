"""Normalization + rotary embedding numerics (port of
areal_tpu/ops/norms.py): HF llama/qwen2 semantics, fp32 inside."""

from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to x.dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] for integer `positions` [...], HF
    convention: the d/2 frequencies repeated twice along the last dim."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    freqs = positions.float()[..., None] * inv_freq  # [..., d/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., d]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-style RoPE. q/k: [..., n_heads, head_dim]; cos/sin: [..., head_dim]
    (broadcast over the heads axis)."""
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
