#!/usr/bin/env python3
"""Device time of K3's bf16-q-over-int8 body in two designs, at the
resume replay's shape (chip_smoke.py's `_replay_slots`: 64 slots of
Q=32 queries at qwen2-1.5B width, windows of 64-640 positions), on one
CUDA card:

    python3 scripts/k3_int8_registers.py [--seed 0]

- shared: the kernel the port ships
  (areal_tpu_torch/csrc/paged_chunk_attention.cu), the block widening
  each int8 ring tile once into a bf16 tile in shared memory;
- registers: scripts/k3_int8_registers.cu, each warp widening its K and
  V bytes in registers (split-KV's walk).

Both are first held within the bf16 row tolerance of the plain version
and of the tiled model (`paged_chunk_attention_tiled_reference`), on the
replay shape and on chip_smoke.py's edge slots.  Then each design's
device time (a CUDA graph replayed, as chip_smoke.py's time_graph) is
taken in turns, shared, registers, registers, shared, twice over, and
the median of each design's four readings is printed beside SDPA's over
the same windows dequantized to bf16.  Imports no JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.kernels import build  # noqa: E402
from areal_tpu_torch.kernels import paged_chunk_attention as pca  # noqa: E402
from areal_tpu_torch.ops.attention import paged_gather_layer  # noqa: E402
from areal_tpu_torch.ops.quant import kv_dequant  # noqa: E402

VARIANT = os.path.join(REPO, "scripts", "k3_int8_registers.cu")


def _variant_launcher():
    """Build the variant into the port's build directory and bind it."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "k3_int8_registers.so")
    subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", out, VARIANT],
        check=True,
    )
    fn = ctypes.CDLL(out).k3_int8_registers_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, pt, hi0, ql, ks, vs):
        b, nq_tok, n_q, d = q.shape
        n_pool, ps, n_kv, _ = k.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                pt.data_ptr(), hi0.data_ptr(), ql.data_ptr(), out.data_ptr(),
                b, nq_tok, n_q, n_kv, d, n_pool, ps, pt.shape[1], d**-0.5,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"k3_int8_registers launch failed: cudaError {rc}")
        return out

    return run


def _inputs(s):
    dev = torch.device("cuda")
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()}
    return (t["q"].to(torch.bfloat16), t["k8"], t["v8"], t["pt"], t["hi0"], t["ql"],
            t["ks"].to(torch.bfloat16), t["vs"].to(torch.bfloat16))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_int8_registers: no CUDA device", file=sys.stderr)
        return 2
    cs.log_card()
    designs = {"shared": pca.paged_decode_attention_chunk, "registers": _variant_launcher()}
    tol = cs.FLASH_ROW_TOL["bf16"]
    ok = True
    slots = {"replay": cs._replay_slots(args.seed)}
    for nq_tok in (13, 1):
        slots[f"edges Q={nq_tok}"] = cs._k3_edge_slots(args.seed, nq_tok)
    for tag, s in slots.items():
        x = _inputs(s)
        ref = pca.paged_chunk_attention_reference(x[0].float(), *x[1:])
        tiled = pca.paged_chunk_attention_tiled_reference(*x)
        for name, fn in designs.items():
            out = fn(*x)
            rel, _ = cs._row_err(out, ref)
            rel_t, _ = cs._row_err(out, tiled)
            good = bool(torch.isfinite(out).all()) and rel <= tol and rel_t <= tol
            ok &= good
            print(f"{tag} {name}: row_err={rel:.3e}, against the tiled model {rel_t:.3e} "
                  f"(tolerance {tol:.3e}){'' if good else ' FAILED'}", flush=True)
    if not ok:
        return 1
    x = _inputs(slots["replay"])
    q, k, v, pt, hi0, ql, ks, vs = x
    nq_tok = q.shape[1]
    dead = torch.arange(nq_tok, device=q.device)[None, :] >= ql[:, None]
    kd = kv_dequant(paged_gather_layer(k, pt), paged_gather_layer(ks, pt), torch.bfloat16)
    vd = kv_dequant(paged_gather_layer(v, pt), paged_gather_layer(vs, pt), torch.bfloat16)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    pos = torch.arange(kd.shape[2], device=q.device)
    qi = torch.arange(nq_tok, device=q.device)
    mask = (pos[None, None, :] < (hi0[:, None] + qi[None, :])[:, :, None]) & ~dead[:, :, None]
    q4 = q.transpose(1, 2).contiguous()
    times = {name: [] for name in designs}
    for _ in range(2):
        for name in list(designs) + list(designs)[::-1]:
            times[name].append(cs.time_graph(lambda: designs[name](*x)))
    sdpa = cs.time_graph(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask[:, None], enable_gqa=True))
    for name, ms in times.items():
        print(f"replay {name}: device ms median {sorted(ms)[len(ms) // 2]:.4f} "
              f"(in turns: {', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    print(f"replay SDPA over the dequantized windows: device ms {sdpa:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
