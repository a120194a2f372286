#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`areal_tpu_torch`) once on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,serve,parity]

Phases (all by default; any failed check exits non-zero and prints no
result):

1. build   — build every CUDA kernel from the sources in this checkout
             (nvcc, sm_90a) and print the card's name and power limit.
2. kernel  — the ragged paged attention kernel against its plain PyTorch
             version on the card, at qwen2-1.5B's attention shape over a
             96-lane serving stream (fp32, bf16, int8 pools; dead lanes
             exactly 0; a poisoned last pool page changes nothing), and
             its time beside the plain version, one library call and the
             card's bound.
3. serve   — the serving path at full qwen2-1.5B size (28 layers, bf16,
             random weights from --seed): GenerationServer over
             GeneratorEngine answers 16 concurrent /generate requests
             (n=4 groups, 128 new tokens); replies and engine counters are
             checked, and the kernel's launch count must equal 28 x the
             inner steps the engine ran.
4. parity  — greedy tokens at qwen2-1.5B width and 2 layers in fp32: the
             engine on the card (the kernel) against the engine on the CPU
             (the plain path).

The line before the last is one JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.  Needs one CUDA card; imports no JAX.
"""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "serve", "parity")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_cuda(fn, warmup: int = 5, iters: int = 25) -> float:
    """Median milliseconds of `fn()` over `iters` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def phase_build():
    from areal_tpu_torch.kernels import build

    t0 = time.monotonic()
    info = build.build_all()
    secs = time.monotonic() - t0
    for name, r in info.items():
        log(f"[build] {name} -> {os.path.relpath(r['path'], REPO)}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] seconds={secs:.2f}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[card] {smi}")


# --------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# --------------------------------------------------------------------------


def _stream(seed):
    """A 96-lane serving stream at qwen2-1.5B's attention shape: 56 decode
    lanes and 4 prefill slices of 8 lanes with windows of 1..2048 that
    cross page boundaries (one decode window, 2100, runs past its 16-page
    table, which then bounds it), then 8 dead lanes; page tables carry
    sentinel entries past each row's mapped pages.  The last pool page is
    never mapped, so poisoning it must change nothing."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_q, n_kv, d, ps, mp = 12, 2, 128, 128, 16
    rows = []  # (positions of the row's lanes)
    fixed = [1, 2, 127, 128, 129, 255, 256, 1000, 2047, 2048, 2100]
    for i in range(56):
        vt = fixed[i] if i < len(fixed) else int(rng.integers(1, 2049))
        rows.append([vt - 1])
    for p0 in (0, 124, 1020, 2040):
        rows.append(list(range(p0, p0 + 8)))
    pages_per_row = [min(mp, -(-(max(r) + 1) // ps)) for r in rows]
    n_pool = sum(pages_per_row) + 8
    perm = rng.permutation(n_pool - 1)  # page n_pool-1 stays unmapped
    pt_rows, used = [], 0
    for k in pages_per_row:
        row = np.full((mp,), n_pool, np.int32)  # sentinel
        row[:k] = perm[used : used + k]
        used += k
        pt_rows.append(row)
    pt_tok, vt = [], []
    for r, pos in zip(pt_rows, rows):
        for p in pos:
            pt_tok.append(r)
            vt.append(p + 1)
    for _ in range(8):  # dead lanes: a row's table, window 0
        pt_tok.append(pt_rows[0])
        vt.append(0)
    pt_tok = np.stack(pt_tok).astype(np.int32)
    vt = np.asarray(vt, np.int32)
    T = len(vt)
    q = rng.standard_normal((T, n_q, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002)
    vs = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002)
    return dict(
        q=q, k=k, v=v, k8=k8, v8=v8, ks=ks.astype(np.float32),
        vs=vs.astype(np.float32), pt=pt_tok, vt=vt, n_live=T - 8,
    )


def _bound(s, elem_bytes):
    """Least time for the call: unique K/V bytes the windows need (each
    position once, though many lanes of a row read it), q in, out back,
    tables; against the flops of QK and PV at the bf16 tensor rate."""
    ps = s["k"].shape[1]
    n_kv, d = s["k"].shape[2], s["k"].shape[3]
    n_q = s["q"].shape[1]
    need = {}  # page -> positions needed
    flops = 0
    for row, vt in zip(s["pt"], s["vt"]):
        vt = min(int(vt), len(row) * ps)  # the table bounds the window
        flops += 4 * vt * n_q * d
        for j in range(-(-int(vt) // ps)):
            page = int(row[j])
            need[page] = max(need.get(page, 0), min(ps, vt - j * ps))
    kv_bytes = 2 * sum(need.values()) * n_kv * d * elem_bytes
    io_bytes = 2 * s["q"].size * elem_bytes + s["pt"].size * 4 + s["vt"].size * 4
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_kernel(report, seed):
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import paged_gather_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    s = _stream(seed)
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()
         if key != "n_live"}
    n_live = s["n_live"]
    ks = t["ks"].to(torch.bfloat16)
    vs = t["vs"].to(torch.bfloat16)
    cases = {
        "fp32": (t["q"], t["k"], t["v"], None, None, 1e-4),
        "bf16": (
            t["q"].to(torch.bfloat16), t["k"].to(torch.bfloat16),
            t["v"].to(torch.bfloat16), None, None, 2e-2,
        ),
        "int8": (t["q"], t["k8"], t["v8"], ks, vs, 1e-3),
    }
    errs = {}
    for name, (q, k, v, ksc, vsc, tol) in cases.items():
        out = rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"], ksc, vsc)
        ref = rpa.ragged_paged_attention_reference(
            q, k, v, t["pt"], t["vt"], ksc, vsc
        )
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
        err = float((out.float() - ref.float()).abs().max())
        errs[name] = err
        log(f"[kernel] {name}: max_abs_err={err:.3e} (tolerance {tol:g})")
        check(err <= tol, f"{name} kernel disagrees with the plain version")
        check(
            float(out[n_live:].float().abs().max()) == 0.0,
            f"{name}: dead lanes are not exactly 0",
        )
        # Poison the never-mapped last page: a sentinel-clamped read that
        # leaked mass would change the output.
        k_bad, v_bad = k.clone(), v.clone()
        if k.dtype == torch.int8:
            k_bad[-1], v_bad[-1] = 127, 127
            ks_bad, vs_bad = ksc.clone(), vsc.clone()
            ks_bad[-1], vs_bad[-1] = 1e9, 1e9
        else:
            k_bad[-1], v_bad[-1] = 1e9, 1e9
            ks_bad, vs_bad = ksc, vsc
        out_bad = rpa.ragged_paged_attention_kernel(
            q, k_bad, v_bad, t["pt"], t["vt"], ks_bad, vs_bad
        )
        check(
            torch.equal(out, out_bad),
            f"{name}: poisoning the last pool page changed the output",
        )
    # Times at the main path's dtype (bf16 q and pool).
    q, k, v = cases["bf16"][:3]
    kernel_ms = time_cuda(
        lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"])
    )
    plain_ms = time_cuda(
        lambda: rpa.ragged_paged_attention_reference(q, k, v, t["pt"], t["vt"])
    )
    # Library yardstick: one SDPA call over the pre-gathered windows.
    T, n_q, d = q.shape
    n_kv = k.shape[2]
    kc = paged_gather_layer(k, t["pt"]).transpose(1, 2)  # [T, n_kv, S, d]
    vc = paged_gather_layer(v, t["pt"]).transpose(1, 2)
    kc = kc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
    vc = vc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
    mask = (
        torch.arange(kc.shape[2], device=dev)[None, :] < t["vt"][:, None]
    )[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_cuda(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)
    )
    bound_ms, bound_by = _bound(s, 2)
    log(
        f"[kernel] bf16 T={T}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})"
    )
    report["kernel"] = dict(
        max_abs_err=errs, kernel_ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, T=T,
    )


# --------------------------------------------------------------------------
# Phase 3: the serving path at full size
# --------------------------------------------------------------------------


def _post(url, payload, timeout=900.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(report, seed):
    import numpy as np
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = qwen2_config("1.5b")
    n_req, n, max_new = 16, 4, 128
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] qwen2-1.5b random init ({cfg.n_layers} layers, bf16): "
        f"{time.monotonic() - t0:.1f} s")
    engine = GeneratorEngine(cfg, params, eos_token_id=151643)
    check(engine.device.type == "cuda", "the engine is not on the card")
    per_call = []
    real_generate = engine.generate

    def generate_and_record(sample, *a, **k):  # observe each call's counters
        out = real_generate(sample, *a, **k)
        per_call.append(dict(
            requests=sample.bs,
            decode_compiles=engine.decode_compiles,
            prefill_dispatches=engine.prefill_dispatches,
            dead_live_lanes=engine.dead_live_lanes,
            lanes_live=engine.lanes_live, lanes_slack=engine.lanes_slack,
            lanes_dispatched=engine.lanes_dispatched,
            shared_mappings=engine.last_pool_stats.get("shared_mappings", 0),
            cow_copies=engine.last_pool_stats.get("cow_copies", 0),
        ))
        return out

    engine.generate = generate_and_record
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(n_req)
    ]
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    start = threading.Barrier(n_req)
    replies, lat, errors = [None] * n_req, [0.0] * n_req, []
    try:
        health = json.loads(urllib.request.urlopen(server.url + "/health").read())
        check(health["status"] == "ok", "/health is not ok")
        torch.cuda.reset_peak_memory_stats()
        rpa.LAUNCHES = 0
        steps0 = engine.steps_total

        def client(i):
            start.wait(timeout=60.0)  # post together: one batched call
            t_req = time.monotonic()
            try:
                replies[i] = _post(server.url + "/generate", dict(
                    qid=f"q{i}", prompt_ids=prompts[i], n=n,
                    max_new_tokens=max_new, temperature=1.0,
                ))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"q{i}: {e!r}")
            lat[i] = time.monotonic() - t_req

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = rpa.LAUNCHES
        steps = engine.steps_total - steps0
    finally:
        server.close()
    check(not errors, f"requests failed: {errors}")
    check(all(r is not None for r in replies), "a request got no reply")
    n_tok = 0
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"q{i}: {len(ids)} tokens")
            check(len(lps) == len(ids), f"q{i}: logprobs/ids length mismatch")
            check(all(math.isfinite(x) for x in lps), f"q{i}: non-finite logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"q{i}: id out of vocab")
            n_tok += len(ids)
    for c in per_call:
        check(c["dead_live_lanes"] == 0, f"dead_live_lanes {c}")
        check(c["lanes_live"] + c["lanes_slack"] == c["lanes_dispatched"],
              f"lane partition broken {c}")
        check(c["prefill_dispatches"] == 0, f"prefill dispatches {c}")
        check(c["decode_compiles"] == 1, f"chunk builds per call {c}")
    check(any(c["shared_mappings"] > 0 for c in per_call),
          "no prompt page was shared (CoW) in any call")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} x {steps} inner steps")
    lat.sort()
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        requests=n_req, n=n, max_new_tokens=max_new, generate_calls=len(per_call),
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        latency_p50_s=lat[len(lat) // 2],
        latency_p99_s=lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)],
        inner_steps=steps, launches=launches, peak_mem_bytes=peak,
        lane_budget=engine.serving_lane_budget, per_call=per_call,
        launches_per_chunk=cfg.n_layers * min(32, max_new),
    )
    log(
        f"[serve] {n_req} requests x n={n}: {n_tok} tokens in {wall:.2f} s = "
        f"{out['tokens_per_s']:.1f} tok/s; latency p50={out['latency_p50_s']:.2f} s "
        f"p99={out['latency_p99_s']:.2f} s; generate calls={len(per_call)}; "
        f"inner steps={steps}; K2 launches={launches}; lanes T={engine.serving_lane_budget}; "
        f"peak mem={peak / 2**30:.2f} GiB"
    )
    out["profile"] = _profile_generate(engine, cfg, rng)
    report["serve"] = out
    del engine, params
    torch.cuda.empty_cache()


def _profile_generate(engine, cfg, rng):
    """Device time by kernel over one smaller generate call (4 prompts of
    128 tokens x n=4, 32 new tokens) under torch.profiler, and the card's
    idle share of that call's wall time."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters

    data = rng.integers(0, cfg.vocab_size, 4 * 128).astype("int32")
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(4)],
        seqlens={"packed_prompts": [[128]] * 4}, data={"packed_prompts": data},
    )
    g = GenerationHyperparameters(n=4, max_new_tokens=32, temperature=1.0)
    steps0 = engine.steps_total
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(sample, MicroBatchSpec(), g, seed=1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6
    top = [
        dict(name=name[:90], ms=us / 1e3, calls=n, share=us / 1e6 / max(busy_s, 1e-12))
        for us, n, name in kernels[:8]
    ]
    steps = engine.steps_total - steps0
    log(f"[profile] 1 generate call, {steps} inner steps: wall {wall:.3f} s, "
        f"device busy {busy_s:.3f} s, idle share {1 - busy_s / wall:.3f} "
        f"(profiler on)")
    for k in top:
        log(f"[profile]   {k['share']:.3f} {k['ms']:10.2f} ms {k['calls']:7d}x {k['name']}")
    return dict(wall_s=wall, busy_s=busy_s, idle_share=1 - busy_s / wall,
                inner_steps=steps, top_kernels=top)


# --------------------------------------------------------------------------
# Phase 4: greedy parity, card against CPU
# --------------------------------------------------------------------------


def phase_parity(seed):
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=2)
    params = init_params(cfg, seed, device="cpu")
    lens = (37, 150, 300, 129)
    rng = np.random.default_rng(seed + 1)
    data = np.concatenate(
        [rng.integers(0, cfg.vocab_size, size=l) for l in lens]
    ).astype(np.int32)

    def sample():
        return SequenceSample(
            keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
            seqlens={"packed_prompts": [[l] for l in lens]},
            data={"packed_prompts": data.copy()},
        )

    g = GenerationHyperparameters(n=2, max_new_tokens=16, greedy=True)
    kw = dict(eos_token_id=151643, kv_page_size=128, prefill_chunk_tokens=8)
    outs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        eng = GeneratorEngine(cfg, params, dev, compute_dtype=torch.float32, **kw)
        rpa.LAUNCHES = 0
        t0 = time.monotonic()
        outs[dev] = eng.generate(sample(), MicroBatchSpec(), g)
        secs[dev] = time.monotonic() - t0
        if dev == "cuda":
            check(rpa.LAUNCHES > 0, "the card's engine never launched the kernel")
        del eng
    a, b = outs["cuda"], outs["cpu"]
    same = (
        a.seqlens["packed_input_ids"] == b.seqlens["packed_input_ids"]
        and np.array_equal(a.data["packed_input_ids"], b.data["packed_input_ids"])
    )
    lp_err = float(np.abs(a.data["packed_logprobs"] - b.data["packed_logprobs"]).max())
    log(f"[parity] 2 layers fp32 greedy: tokens identical={same}, "
        f"max logprob diff={lp_err:.2e} (cuda {secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s)")
    check(same, "greedy tokens differ between the card and the CPU")
    check(lp_err <= 1e-3, f"logprobs differ by {lp_err} > 1e-3")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "areal_tpu_torch")):
        print("chip_smoke: areal_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.monotonic()
    report = {}  # the kernel and serve phases' numbers for the kernels line
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        phase_kernel(report, args.seed)
    if "serve" in phases:
        phase_serve(report, args.seed)
    if "parity" in phases:
        phase_parity(args.seed)
    log(f"[done] {time.monotonic() - t_start:.1f} s")

    k = report.get("kernel", {})
    s = report.get("serve", {})
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "areal_tpu/ops/pallas/paged_attention.py:276",
        "launches": s.get("launches"),
        "max_abs_err": k.get("max_abs_err", {}).get("bf16"),
        "max_abs_err_fp32": k.get("max_abs_err", {}).get("fp32"),
        "max_abs_err_int8": k.get("max_abs_err", {}).get("int8"),
        "ms": k.get("kernel_ms"),
        "kernel_ms": k.get("kernel_ms"),
        "plain_ms": k.get("plain_ms"),
        "bound_ms": k.get("bound_ms"),
        "bound_by": k.get("bound_by"),
        "library_ms": k.get("library_ms"),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
