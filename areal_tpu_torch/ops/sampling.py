"""Token sampling: temperature / top-k / top-p warpers, the inverse-CDF
draw and the exact verification of speculative drafts (port of
areal_tpu/ops/sampling.py).

Randomness comes from a `torch.Generator` (JAX's keys have no torch
counterpart, so sampled tokens differ from the JAX package's).  The
uniform draws are separate from the transforms: `sample_token` takes an
optional `u` and `spec_accept` optional `u_acc` and `u_res`, so a test
can hand both packages the same uniforms.
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


def spec_accept(
    logits: torch.Tensor,  # [B, K+1, V] fp32 — model dists after each draft
    drafts: torch.Tensor,  # [B, K] int — proposed tokens
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    greedy: bool = False,
    n_valid: Optional[torch.Tensor] = None,  # [B] int — live logit positions
    u_acc: Optional[torch.Tensor] = None,  # [B, K] uniforms in [0, 1)
    u_res: Optional[torch.Tensor] = None,  # [B] uniforms in [0, 1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact speculative verification of K deterministic drafts.

    logits[:, j] is the next-token distribution after drafts[:, :j]
    (logits[:, K] is the bonus position).  Returns (emitted [B, K+1]
    int64, logps [B, K+1] fp32, n_emitted [B]): per row the first
    n_emitted entries are valid, the accepted drafts then one closing
    token (the rejection resample, or the bonus draw when all K drafts
    were accepted).  Draft d is accepted with probability p(d) under the
    warped distribution; on a rejection the closing token is drawn from
    p with d's mass removed, so the emitted sequence is distributed as
    K+1 sequential draws.  Logps follow `sample_token`: the unwarped,
    temperature-scaled log-density of each emitted token.

    `n_valid` makes the verification ragged: row b forwarded only its
    first n_valid[b] positions, so drafts at j >= n_valid - 1 count as
    rejected and the closing draw stays at a position < n_valid.  A
    sampled call draws u_acc, then u_res, from `generator` unless they
    are given."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    drafts = drafts.long()
    scaled = logits / max(temperature, 1e-6)
    live_draft = None
    if n_valid is not None and k > 0:
        live_draft = torch.arange(k, device=dev)[None, :] < (n_valid.long() - 1)[:, None]
    rows = torch.arange(b, device=dev)
    if greedy:
        argm = torch.argmax(logits, dim=-1)  # [B, K+1]
        acc = drafts == argm[:, :k]
        if live_draft is not None:
            acc = acc & live_draft
        n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        # Closing token: the argmax at the first rejected position (or bonus).
        close = torch.gather(argm, 1, n_acc[:, None])[:, 0]
        tail = close[:, None]
    else:
        warped = apply_top_p(apply_top_k(scaled, top_k), top_p)
        log_z = torch.logsumexp(warped, dim=-1)  # [B, K+1]
        d_logit = torch.gather(warped[:, :k], 2, drafts[:, :, None])[..., 0]
        p_draft = torch.exp(d_logit - log_z[:, :k])  # [B, K] accept probs
        if u_acc is None:
            u_acc = torch.rand((b, k), generator=generator, device=dev)
        acc = u_acc < p_draft
        if live_draft is not None:
            acc = acc & live_draft
        n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        # The closing draw at position n_acc: from the residual (the
        # rejected draft masked out), or untouched at the bonus position.
        close_logits = torch.gather(
            warped, 1, n_acc[:, None, None].expand(-1, 1, v)
        )[:, 0]
        if k > 0:
            rejected = torch.gather(drafts, 1, n_acc.clamp(max=k - 1)[:, None])[:, 0]
        else:
            rejected = torch.zeros((b,), dtype=torch.long, device=dev)
        onehot = (torch.arange(v, device=dev)[None, :] == rejected[:, None]) & (
            n_acc < k
        )[:, None]
        close_logits = torch.where(
            onehot, torch.full_like(close_logits, NEG_INF), close_logits
        )
        if u_res is None:
            u_res = torch.rand((b,), generator=generator, device=dev)
        close = _inverse_cdf_draw(close_logits, u_res)
        tail = torch.zeros((b, 1), dtype=torch.long, device=dev)
    emitted = torch.cat([drafts, tail], dim=1)
    emitted[rows, n_acc] = close
    lse = torch.logsumexp(scaled, dim=-1)  # [B, K+1]
    chosen = torch.gather(scaled, 2, emitted[:, :, None])[..., 0]
    return emitted, chosen - lse, n_acc + 1
