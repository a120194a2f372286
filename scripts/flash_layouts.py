#!/usr/bin/env python3
"""Device time of the bf16 flash attention kernels (K1f, K1dq, K1dkv) of
the PyTorch port on a few segment layouts, at qwen2-1.5B's attention
shape (B=4 rows of S=2048, Hq=12, Hkv=2, D=128), on one CUDA card:

    python3 scripts/flash_layouts.py

- packed: chip_smoke.py's flash-phase rows (segments of 64-640 tokens,
  the last row all padding);
- one_segment: one causal segment a row (long walks, the tile rate);
- all_padding: every position padding (a block's fixed cost alone);
- half_padding: one segment of S/2 a row, then padding.

Each line gives the number of live 64 x 64 (query, key) tile pairs (the
tiles the kernels list after the causal and segment skips) and each
kernel's device time (a CUDA graph replayed, as chip_smoke.py's
time_graph) with the rate that time gives on those tiles' flops (4 D
per pair and q head for K1f, 6 D for K1dq, 8 D for K1dkv: products
counted as the math needs them, not as the kernels run them).  Imports
no JAX.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.kernels import flash_attention as fa  # noqa: E402

B, S, HQ, HKV, D = 4, 2048, 12, 2, 128
TILE = 64


def live_tile_pairs(seg):
    """Causal (query tile, key tile) pairs whose non-zero segment ranges
    meet, as the kernels' listing finds them."""
    n = 0
    for row in seg:
        for qt in range(S // TILE):
            q = row[qt * TILE : (qt + 1) * TILE]
            if q.max() == 0:
                continue
            qlo, qhi = q[q > 0].min(), q.max()
            for kt in range(qt + 1):
                k = row[kt * TILE : (kt + 1) * TILE]
                if k.max() > 0 and k[k > 0].min() <= qhi and k.max() >= qlo:
                    n += 1
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_layouts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    half = np.ones((B, S), np.int32)
    half[:, S // 2 :] = 0
    layouts = {
        "packed": cs._packed_rows(np.random.default_rng(7), B, S)[0],
        "one_segment": np.ones((B, S), np.int32),
        "all_padding": np.zeros((B, S), np.int32),
        "half_padding": half,
    }
    rng = np.random.default_rng(0)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32))
        .to(dev).to(torch.bfloat16)
        for h in (HQ, HKV, HKV, HQ)
    )
    name_card = torch.cuda.get_device_name(0)
    print(f"card: {name_card}", flush=True)
    for name, seg_np in layouts.items():
        seg = torch.from_numpy(seg_np).to(dev)
        o, lse = fa.flash_fwd(q, k, v, seg, True)
        delta = fa.flash_delta(o, do)
        times = {
            "fwd": cs.time_graph(lambda: fa.flash_fwd(q, k, v, seg, True)),
            "dq": cs.time_graph(lambda: fa.flash_dq(q, k, v, seg, do, lse, delta, True)),
            "dkv": cs.time_graph(lambda: fa.flash_dkv(q, k, v, seg, do, lse, delta, True)),
        }
        pairs = live_tile_pairs(seg_np)
        flops = {"fwd": 4, "dq": 6, "dkv": 8}
        parts = []
        for kernel, ms in times.items():
            tflops = pairs * TILE * TILE * D * flops[kernel] * HQ / (ms * 1e9)
            parts.append(f"{kernel} {ms:.4f} ms ({tflops:.0f} TFLOP/s)")
        print(f"{name}: {pairs} live tile pairs; " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
