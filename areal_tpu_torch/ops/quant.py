"""Symmetric per-head int8 quantization for KV caches (port of
areal_tpu/ops/quant.py).  The scale rule is bit-identical to the JAX
package's: int8 greedy parity between the two depends on it."""

from typing import Tuple

import torch


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d] float -> (int8 [..., d], bf16 scale [...]).

    The scale is rounded to bf16 BEFORE quantizing so quantize and
    dequantize use the identical value."""
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=-1) / 127.0
    s = torch.clamp(s, min=1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / s.float()[..., None]), -127, 127)
    return q.to(torch.int8), s


def kv_dequant(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * s.float()[..., None]).to(dtype)
