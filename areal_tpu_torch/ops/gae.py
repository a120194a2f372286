"""Generalized Advantage Estimation over packed sequences (port of
areal_tpu/ops/gae.py).

The backward linear recurrence  adv[t] = delta[t] + γλ·adv[t+1]  runs as
a log-depth (Hillis–Steele) inclusive scan over the reversed buffer with
the carry coefficient zeroed at sequence boundaries: ceil(log2 T) rounds
of elementwise work on the tensors' device, no loop over T.  Each round
combines (a_l, b_l) with (a_r, b_r) into (a_l·a_r, a_r·b_l + b_r), the
JAX package's `associative_scan` operator; products of coefficients only
ever shrink toward 0, nothing is divided, so γλ < 1 cannot underflow
into a 0/0.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gae_packed(
    rewards: torch.Tensor,  # [T] fp32 per-token rewards (terminal included)
    values: torch.Tensor,  # [T] fp32 V(s_t), 0 on padding
    segment_ids: torch.Tensor,  # [T] int, 0 = pad; sequences contiguous
    bootstrap: torch.Tensor,  # [T] fp32, V(s_T) at each sequence's LAST position
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages [T], returns [T]) on the inputs' device; zeros
    on padding.  delta[t] = r[t] + γ·V[t+1] − V[t], where V past a
    sequence's last position is `bootstrap` there (0 for a terminated
    episode, V_last for a truncated one: the caller decides)."""
    seg = segment_ids
    same_next = F.pad(seg[1:] == seg[:-1], (0, 1), value=False) & (seg > 0)
    v_next = torch.where(same_next, F.pad(values[1:], (0, 1)), bootstrap)
    delta = rewards + gamma * v_next - values
    coef = torch.where(same_next, gamma * lam, 0.0).to(delta.dtype)

    # Inclusive scan of the reversed pairs: after the round with offset d,
    # element i holds the combination of elements i-2d+1 .. i.
    a, b = coef.flip(0), delta.flip(0)
    d = 1
    while d < a.shape[0]:
        a_l, b_l = a[:-d], b[:-d]
        a_r, b_r = a[d:], b[d:]
        a = torch.cat([a[:d], a_l * a_r])
        b = torch.cat([b[:d], a_r * b_l + b_r])
        d *= 2
    adv = b.flip(0)
    valid = seg > 0
    adv = torch.where(valid, adv, 0.0)
    returns = torch.where(valid, adv + values, 0.0)
    return adv, returns


def pygae_packed(
    rewards: np.ndarray,
    values: np.ndarray,
    seqlens,
    bootstrap_per_seq: np.ndarray,
    gamma: float,
    lam: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy oracle (the JAX package's `pygae_packed`) for parity
    tests: one backward loop per sequence, fp64 accumulation."""
    adv = np.zeros_like(rewards, dtype=np.float64)
    ret = np.zeros_like(rewards, dtype=np.float64)
    off = 0
    for si, L in enumerate(seqlens):
        run = 0.0
        for t in reversed(range(L)):
            v_next = bootstrap_per_seq[si] if t == L - 1 else values[off + t + 1]
            delta = rewards[off + t] + gamma * v_next - values[off + t]
            run = delta + gamma * lam * run
            adv[off + t] = run
            ret[off + t] = run + values[off + t]
        off += L
    return adv.astype(np.float32), ret.astype(np.float32)
