"""Token sampling: temperature / top-k / top-p warpers + inverse-CDF draw
(port of areal_tpu/ops/sampling.py).

Randomness comes from a `torch.Generator` (JAX's keys have no torch
counterpart, so sampled tokens differ from the JAX package's).  The
uniform draw is separate from the transform: `sample_token` takes an
optional `u`, so a test can hand both packages the same uniforms.
"""

from typing import Optional, Tuple

import torch

NEG_INF = -1e10


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row; mask the rest.  k<=0 disables."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of sorted probs with
    cumulative mass >= p.  p>=1 disables."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens whose cumulative mass (exclusive) is < p.
    keep_sorted = (cum - probs) < p
    # Threshold logit = smallest kept logit.
    thresh = torch.amin(
        torch.where(
            keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ),
        dim=-1, keepdim=True,
    )
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def sample_token(
    logits: torch.Tensor,  # [B, V] fp32
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    greedy: bool = False,
    u: Optional[torch.Tensor] = None,  # [B] uniforms in [0, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (token [B] int64, logprob [B] fp32 of the chosen token under
    the temperature-scaled, UNWARPED distribution — the behaviour density
    PPO's importance ratios need).  A non-greedy draw uses `u` when given,
    else one uniform per row from `generator`."""
    scaled = logits / max(temperature, 1e-6)
    if greedy:
        tok = torch.argmax(logits, dim=-1)
    else:
        warped = apply_top_p(apply_top_k(scaled, top_k), top_p)
        if u is None:
            u = torch.rand(
                (logits.shape[0],), generator=generator, device=logits.device
            )
        tok = _inverse_cdf_draw(warped, u)
    lse = torch.logsumexp(scaled, dim=-1)
    chosen = torch.gather(scaled, -1, tok[:, None])[:, 0]
    return tok, chosen - lse


def _inverse_cdf_draw(warped: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One inverse-CDF draw per row from warped logits [B, V], u in [0,1).
    `r` stays strictly below the total mass (u*total can round up to it)."""
    m = torch.amax(warped, dim=-1, keepdim=True)
    p = torch.exp(warped - m)
    cdf = torch.cumsum(p, dim=-1)
    total = cdf[:, -1]
    r = torch.minimum(u * total, total * (1.0 - 1e-6))
    tok = torch.sum(cdf <= r[:, None], dim=-1)
    return torch.clamp(tok, max=warped.shape[-1] - 1)
