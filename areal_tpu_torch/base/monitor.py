"""Observability: FLOPs accounting, MFU, timing marks and the per-step
stats sink (port of areal_tpu/base/monitor.py).

The FLOP formulas are the JAX package's, analytic over packed sequences
(the attention term uses the exact sum of per-sequence s^2).  MFU divides
by the card's published dense bf16 peak, looked up by
`torch.cuda.get_device_name`; the CPU has no entry, so an MFC on the CPU
reports no MFU.  The stats sink writes jsonl only (the JAX package's
optional tensorboard and wandb sinks are not ported)."""

import contextlib
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch


# ---------------- FLOPs ----------------


def matmul_params(cfg) -> int:
    """Parameters that take part in matmuls for ONE token's forward pass
    (active experts only for MoE; the embedding lookup excluded)."""
    h = cfg.hidden_dim
    d = cfg.head_dim
    attn = h * (cfg.n_q_heads * d + 2 * cfg.n_kv_heads * d) + cfg.n_q_heads * d * h
    n_mats = 3 if getattr(cfg, "mlp_gated", True) else 2
    if cfg.is_moe:
        inter = cfg.moe_intermediate_dim or cfg.intermediate_dim
        mlp = n_mats * h * inter * cfg.n_experts_per_tok
    else:
        mlp = n_mats * h * cfg.intermediate_dim
    per_layer = attn + mlp
    head = 0 if cfg.is_critic else h * cfg.vocab_size
    return cfg.n_layers * per_layer + head


def flops_forward(cfg, n_tokens: int, sum_sq_seqlens: Optional[float] = None) -> float:
    """Forward FLOPs over packed sequences: 2 N per token for the matmuls
    plus the attention term 4 h_q d sum_i(s_i^2) per layer."""
    mm = 2.0 * matmul_params(cfg) * n_tokens
    if sum_sq_seqlens is None:
        sum_sq_seqlens = float(n_tokens) ** 2
    attn = 2.0 * 2.0 * cfg.n_q_heads * cfg.head_dim * sum_sq_seqlens * cfg.n_layers
    return mm + attn


def flops_train(cfg, n_tokens: int, sum_sq_seqlens: Optional[float] = None) -> float:
    """Forward + backward ~= 3 x forward."""
    return 3.0 * flops_forward(cfg, n_tokens, sum_sq_seqlens)


def flops_generate(cfg, prompt_lens: Sequence[int], gen_lens: Sequence[int]) -> float:
    """Prefill (a packed forward over the prompts) + incremental decode:
    each new token costs 2 N matmul FLOPs plus attention over its live
    prefix."""
    p_tokens = float(sum(prompt_lens))
    p_sq = float(sum(p * p for p in prompt_lens))
    total = flops_forward(cfg, int(p_tokens), p_sq)
    n = 2.0 * matmul_params(cfg)
    attn_c = 4.0 * cfg.n_q_heads * cfg.head_dim * cfg.n_layers
    for p, g in zip(prompt_lens, gen_lens):
        total += n * g
        total += attn_c * (g * p + g * g / 2.0)
    return total


# Published dense bf16 TFLOP/s per card (NVIDIA's data sheets), matched
# in this order against the lower-cased device name.
_PEAK_TFLOPS = {
    "h100 pcie": 756.0,
    "h100": 989.0,  # H100 SXM5 ("NVIDIA H100 80GB HBM3")
}


def peak_tflops(device_name: str) -> Optional[float]:
    name = device_name.lower()
    for key, val in _PEAK_TFLOPS.items():
        if key in name:
            return val
    return None


def mfu(flops: float, seconds: float, device: torch.device) -> Optional[float]:
    """Model FLOP utilization of one MFC on `device`; None on the CPU or
    on a card with no entry in the peak table."""
    if device.type != "cuda" or seconds <= 0:
        return None
    peak = peak_tflops(torch.cuda.get_device_name(device))
    if peak is None:
        return None
    return flops / seconds / (peak * 1e12)


# ---------------- timing marks ----------------


class Timers:
    """Named wall-clock marks: accumulate durations, drain as a stats dict."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def record(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def drain(self, prefix: str = "time/") -> Dict[str, float]:
        """Export accumulated marks and reset: per key the total seconds,
        the call count (`<key>_cnt`) and the mean (`<key>_avg`)."""
        out: Dict[str, float] = {}
        for k, total in self._acc.items():
            n = self._count.get(k, 0)
            out[f"{prefix}{k}"] = total
            out[f"{prefix}{k}_cnt"] = float(n)
            out[f"{prefix}{k}_avg"] = total / n if n else 0.0
        self._acc.clear()
        self._count.clear()
        return out


# ---------------- stats sink ----------------


class StatsLogger:
    """Per-step scalar sink: one json line per step under
    <fileroot>/logs/<experiment>/<trial>/stats.jsonl."""

    def __init__(self, fileroot: str, experiment_name: str, trial_name: str):
        self.dir = os.path.join(fileroot, "logs", experiment_name, trial_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "stats.jsonl")
        self._jsonl = open(self.path, "a")

    def log(self, step: int, stats: Dict[str, float]) -> None:
        row = {"global_step": step, "ts": time.time(), **stats}
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self):
        if not self._jsonl.closed:
            self._jsonl.close()

