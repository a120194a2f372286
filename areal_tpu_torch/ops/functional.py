"""Log-prob and normalization numerics over dense packed rows (port of
areal_tpu/ops/functional.py).  Rows are [B, S] with segment ids (0 =
padding); index t carries the quantity for predicting token t+1."""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class _MatmulFp32OutBf16(torch.autograd.Function):
    """bf16 x [N, D] @ bf16 w [D, V] with an fp32 result on the card
    (`torch.mm(..., out_dtype=float32)`: cuBLAS accumulates in fp32 and
    writes fp32, no bf16 rounding of the logits).  The backward runs
    ordinary bf16 products of the fp32 cotangent rounded to bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_fp32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, V] -> fp32 [..., V]: an fp32 result of the
    product in the operands' dtype, the JAX package's
    `preferred_element_type=jnp.float32`.  A dtype rule, not a device
    fallback: two bf16 operands go through the fp32-output product on
    the card; anything else (fp32 operands, or bf16 on the CPU, which has
    no such product) is widened to fp32 first."""
    if x.dtype == w.dtype == torch.bfloat16 and x.device.type == "cuda":
        lead = x.shape[:-1]
        out = _MatmulFp32OutBf16.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


def shifted_label_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """True at position t when (t, t+1) belong to the same segment, i.e.
    position t predicts a real next token.  [B, S] bool."""
    nxt = F.pad(segment_ids[:, 1:], (0, 1), value=0)
    return (segment_ids > 0) & (segment_ids == nxt)


def _next_labels(tokens: torch.Tensor) -> torch.Tensor:
    return F.pad(tokens[:, 1:], (0, 1), value=0).long()


def next_token_logprobs(
    logits: torch.Tensor, tokens: torch.Tensor, segment_ids: torch.Tensor
) -> torch.Tensor:
    """log p(tokens[t+1] | prefix) at each position t, [B, S] fp32; 0 at
    the last position of every segment and on padding."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gathered = torch.gather(logp, -1, _next_labels(tokens)[..., None])[..., 0]
    return torch.where(shifted_label_mask(segment_ids), gathered, 0.0)


def _chunk_logprobs(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor):
    logits = matmul_fp32_out(x, head)  # [c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    return torch.gather(logits, -1, labels[:, None])[:, 0] - lse


def fused_next_token_logprobs(
    x: torch.Tensor,  # [B, S, D] final hidden states (compute dtype)
    head: torch.Tensor,  # [D, V] LM head (embed.T when tied)
    tokens: torch.Tensor,  # [B, S] int
    segment_ids: torch.Tensor,  # [B, S] int, 0 = pad
    chunk_size: int = 512,
) -> torch.Tensor:
    """`next_token_logprobs` of the head's logits WITHOUT materializing
    [B, S, V]: the head product and logsumexp run per chunk of positions,
    each chunk checkpointed when autograd records (its [chunk, V] logits
    are recomputed in backward), so peak memory is one [chunk, V] fp32
    block.  [B, S] fp32."""
    b, s, d = x.shape
    t = b * s
    c = min(chunk_size, t)
    xf = x.reshape(t, d)
    lf = _next_labels(tokens).reshape(t)
    parts = []
    for i in range(0, t, c):
        if torch.is_grad_enabled():
            lp = checkpoint(
                _chunk_logprobs, xf[i : i + c], head, lf[i : i + c],
                use_reentrant=False,
            )
        else:
            lp = _chunk_logprobs(xf[i : i + c], head, lf[i : i + c])
        parts.append(lp)
    lp = torch.cat(parts).reshape(b, s)
    return torch.where(shifted_label_mask(segment_ids), lp, 0.0)


def masked_normalization(
    x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Whiten x over the masked entries (global mean and std), 0
    elsewhere; fp32 (the JAX package widens to fp64 only when x64 is
    enabled, which it is not by default)."""
    xf = x.float()
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (xf * m).sum() / n
    var = (torch.square(xf - mean) * m).sum() / n
    out = (xf - mean) * torch.rsqrt(var + eps)
    return torch.where(mask.bool(), out, 0.0)
