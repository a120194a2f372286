"""N-gram draft proposal for speculative decoding, prompt lookup (port of
areal_tpu/ops/ngram.py).

Drafts the next K tokens of each row by matching its trailing m-gram
against its own earlier history (prompt + generated prefix) and copying
the continuation of the most recent match.  Proposal quality only moves
speed: the verifier (`ops/sampling.spec_accept`) keeps the emitted
distribution the model's.  Shapes are fixed and everything runs on the
tensors' device: the serving chunk calls it between forwards with no
host read.
"""

import torch


def propose_ngram(
    tokens: torch.Tensor,  # [B, S] int — history buffer (garbage past lens)
    lens: torch.Tensor,  # [B] int — valid history length per row
    k: int,  # number of draft tokens
    m: int = 3,  # gram length to match
) -> torch.Tensor:
    """Drafts [B, k] (tokens' dtype) continuing each row's history.  Rows
    with fewer than m + 1 tokens, or no earlier occurrence of their
    trailing m-gram, draft a repeat of their last token."""
    b, s = tokens.shape
    dev = tokens.device
    lens = lens.long()
    pos = torch.arange(s, device=dev)
    gram_idx = lens[:, None] - m + torch.arange(m, device=dev)[None, :]  # [B, m]
    gram = torch.gather(tokens, 1, gram_idx.clamp(0, s - 1))
    # The window starting at i matches iff tokens[i + j] == gram[j] for
    # every j < m.
    match = torch.ones((b, s), dtype=torch.bool, device=dev)
    for j in range(m):
        t_j = tokens[:, (pos + j).clamp(max=s - 1)]  # tokens shifted left by j
        match &= t_j == gram[:, j : j + 1]
    # Inside the history and before the trailing gram itself.
    match &= (pos[None, :] < lens[:, None] - m) & (lens[:, None] >= m + 1)
    best = torch.amax(torch.where(match, pos[None, :], -1), dim=1)  # most recent
    has_match = match.any(dim=1)
    cont_idx = best[:, None] + m + torch.arange(k, device=dev)[None, :]  # [B, k]
    cont = torch.gather(tokens, 1, cont_idx.clamp(0, s - 1))
    last = torch.gather(tokens, 1, (lens - 1).clamp(0, s - 1)[:, None])  # [B, 1]
    cont = torch.where(cont_idx < lens[:, None], cont, last)
    return torch.where(has_match[:, None], cont, last)
