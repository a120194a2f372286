#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`areal_tpu_torch`) once on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,flash,...]

Phases (all by default, in this order; any failed check exits non-zero
and prints no result):

build        — build every CUDA kernel from the sources in this checkout
               (nvcc, sm_90a, one process per source, all at once) and
               print the card's name and power limit.
kernel       — the ragged paged attention kernel (K2) against its plain
               PyTorch version and its split reference at qwen2-1.5B's
               attention shape over a 96-lane serving stream (fp32, bf16,
               int8 pools; dead lanes exactly 0; a poisoned last pool page
               changes nothing), over windows at its span's edges +-1 and
               over a one-span table; one call under
               torch.cuda.set_sync_debug_mode("error"); its time beside
               the plain version, one library call and the card's bound
               (device time from CUDA-graph replays, and the eager call's
               time with its host work).  Then the paged chunk attention
               kernel (K3) at the resume replay's shape (64 slots of 32 queries,
               windows 64-640, ragged q_lens with some 0) and on edge slots
               (Q=13 and Q=1; windows ending at tile and page edges and
               past the table; a ragged and an all-dead slot): fp32, bf16
               and int8 pools, each output row within a tolerance of its
               own magnitude of its plain version and of its tiled model,
               dead queries exactly 0, a poisoned last pool page changing
               nothing; one call under the sync debug mode; and its times
               (device and eager, as for K2).  Then the dense
               decode attention kernel (K4) at the static path's decode
               shape (32 rows of S=1024, prompts 64-512 right-aligned at
               512, window to 576), a Q=4 chunk, a 1280 window, rows
               with empty windows, windows at its span's edges +-1 and a
               one-span cache: fp32, bf16 and int8 caches, each output
               row within a tolerance of its own magnitude of its plain
               version and of its split reference, empty windows exactly
               0, poisoned positions outside every window changing
               nothing; one call under the sync debug mode; and its times
               at 32 rows and at the static phase's 64.  Then the forms
               the generator's other inflight modes run: K3's Q=1 entry
               point (the two-program path's decode step, which runs K2's
               kernel; 16 and 64 slots, windows 64-640, fp32/bf16/int8
               pools and bf16 q over int8, equal to K2's wrapper and held
               against the plain paged_decode_attention), K4 at Q=1 and
               Q=5 with bf16 q over an int8 cache and at Q=5 in bf16
               (dense spec, K=4), 16 rows of a 1024 window; each with one
               call under the sync debug mode and its times beside the
               plain version, SDPA and the bound.  bf16 q over an int8
               cache or pool (the tensor-core int8 path of K2 and K4) is
               held in every K2 and K4 case against the plain version
               and, within MODEL_TOL, its split reference.
flash        — the flash attention kernels (K1f forward, K1dq and K1dkv
               backward) against the plain version and its autograd on
               fp32 copies of the same inputs, at qwen2-1.5B's attention
               shape over rows of S=2048 packed with segments of 64-640
               tokens and one all-padding row, fp32 and bf16 (each output
               row within a tolerance of its own magnitude; padding
               outputs and grads exactly 0), and in bf16 against the
               kernels' models (o and lse: the online softmax with P in
               bf16; dq: dS as a bf16 hi + lo pair; dk, dv: P and dS in
               bf16); all three also at their edges (S=256 rows of
               segments of 1-129 tokens, rep 6 and 1, causal and not; an
               S=40 row; D=64), lse against the dense logsumexp; one call
               of each under the sync debug mode; and their times
               (device and eager) beside the plain version, SDPA with the
               packed mask and the card's bound.
serve        — the serving path at full qwen2-1.5B size (28 layers, bf16,
               random weights from --seed): GenerationServer over
               GeneratorEngine answers 16 concurrent /generate requests
               (n=4 groups, 128 new tokens); replies and engine counters
               are checked, and K2's launch count must equal 28 x the
               inner steps the engine ran.  The engine's
               static_path_max_new is 0, so by the JAX package's own rule
               every call takes the serving plane (as in push and
               resume_parity).
static       — the static generate path at full qwen2-1.5B: the same
               burst (64 requests) through GenerationServer over a
               default engine, which takes the static path (prefill with
               K1f, then one decode_step with K4 per token); replies are
               checked, K1f launches = 28 x static chunks, K4 launches =
               28 x decode steps, K2 launches 0; tokens/s, the prefill
               and decode step times, peak memory and a profiled call's
               K4 and idle shares are printed.
train        — two GRPO steps at full qwen2-1.5B (fp32 masters, bf16
               compute, remat "full"): PPOActorInterface.generate (the
               static path: K1f prefill, K4 decode) ->
               MultiTaskRewardInterface -> PPOActorInterface.train_step
               (K1f, K1dq, K1dkv), 8 prompts x n=4, 128 new tokens, the
               generator taking the trained weights after step 1; the
               importance ratio and approx-KL, grad_norm and the K1 launch
               counts are checked, and one train_step is profiled.  Before
               the first update, PPOActorInterface.inference recomputes the
               rollout's logprobs (each response token held against the
               generator's), and K1f/K1dq/K1dkv are held against the plain
               version on layer 0's q/k/v at the step's packed [B, S].
ppo          — two full PPO steps of ppo-math at qwen2-1.5B with all four
               models: the actor (TrainEngine + GeneratorEngine), a critic
               (TrainEngine on the value head, value norm "exp") and a
               reference model (InferenceEngine on the actor's initial
               weights, offloaded to host memory after each call);
               kl_ctl 0.1.  Each step: generate (static path) -> reward
               (seeded +-5) -> ref_inf (K1f) -> critic_inf (K1f) -> actor
               train_step -> critic train_step (K1f, K1dq, K1dkv) -> the
               generator takes the actor's weights.  Step 1: each
               response token's ref logprob within 0.125 of the
               generator's and their mean within 1e-2, importance ratio
               and approx-KL as in train, value_loss finite, the critic's
               grad_norm > 0.  Step 2: step 1's sample through the ref
               after its offload round trips gives step 1's logprobs bit
               for bit, and the ref is farther from the behaviour policy
               than at step 1.  K1 launches per model call = 28 x its
               micro-batches (x (2, 1, 1) for a train step); each call's
               seconds, peak memory and the value-norm moments printed.
quickstart   — the system's own entry point at qwen2-1.5B: a seeded random
               checkpoint written by the port's save_hf_checkpoint (fp32,
               two shards and an index; free disk checked first), 64 math
               rows written here, then `quickstart.main(["ppo-math", ...])`
               in this process with a ref model from the same checkpoint,
               kl_ctl 0.1, 8 prompts x 4 responses, 128 new tokens, two
               steps and a save at step 2 (rewards replaced by seeded +-5).
               The master runs the DFG: generate (static path) -> reward
               and ref_inf -> actor train_step -> the generator's weight
               sync.  Checked: three checkpoint loads; step 1's first
               minibatch importance ratio and approx-KL and the ref's
               logprobs against the behaviour policy's (the three loads
               hold one set of weights); finite stats; the launches of
               each step equal to 28 x the engines' calls of each MFC in
               the DFG (K2, K3 0); the saved checkpoint's keys, shapes and
               fp32; a non-zero update within AdamW's bound.  Step and
               per-MFC seconds, MFU, peak and resident memory, checkpoint
               write, load and save seconds are printed.
recover      — kill-and-resume at qwen2-1.5B through quickstart.main: the
               quickstart trial with the EMA reference model
               (--ref-ema-eta 0.9 --offload-ref) and the difficulty filter,
               run uninterrupted for three steps (U), for one step with a
               recover checkpoint (R1), and rerun under R1's trial name
               (R2: restores step 1, runs steps 2-3); free disk checked
               first (~25 GiB).  Checked: every EMA bit for bit and the ref
               back on host, the filter's exact drop set and the loader's
               top-up, R1's manifest, R2's restore of R1's masters, Adam
               state, ref, versions, controls and filter state bit for bit,
               R2's steps fetching U's ids with U's tokens and stats (U's
               and R1's step-1 masters compared bit for bit first), and
               each step's launches = 28 x the engines' calls.  The save's
               and restore's seconds, each trial's steps and the peak are
               printed.
push         — the in-memory weight push mid-generation at full qwen2-1.5B
               (28 layers, bf16): GenerationServer serves 16 GRPO requests
               (n=4, prompts 64-512, 128 new tokens) while
               update_weights_inmem pushes new random weights with their
               checksum; the call parks at a chunk boundary, the weights
               are swapped, every live row's last chunk is replayed
               through K3 and the call finishes on its pages.  Spanned
               requests (version 0 -> 1), K3 launches = 28 x replays, the
               change against an uninterrupted old-weights run, and a
               refused bad-checksum push are checked.
resume_parity — park at the second serving chunk and resume under
               unchanged weights at full qwen2-1.5B (rows decoding, a row
               mid-prefill, a follower mapping shared prompt pages): each
               replayed row's logits (K3) against the ones before the
               replay (K2), and in fp32 greedy tokens identical to an
               uninterrupted run.
genmodes     — the generator's other inflight modes at full qwen2-1.5B in
               bf16: the serve burst's first 8 prompts (x n=4, 128 new
               tokens, greedy) through GenerationServer over engines of
               16 slots,
               (a) the dense window (kv_paged=False) in bf16 and int8,
               (b) dense spec K=4, (c) the two-program paged path
               (prefill_chunk_tokens=0) in bf16 and int8, (d) spec K=4 on
               the serving plane, then (e) one quickstart ppo-math step
               with --no-paged-kv --spec-decode-k 4 --kv-cache-dtype int8.
               Replies, launches (K4 = 28 x decode steps in (a), (b); K2
               = 28 x decode steps in (c) and 28 x inner steps in (d);
               K1f = 28 x prefill dispatches; the rest 0), one decode
               chunk of each mode under the sync debug mode, and int8
               against bf16 token agreement >= 0.85 (teacher-forced along
               the bf16 run) are checked; tokens/s,
               the decode step's time, spec acceptance, cache copy bytes
               and peak memory are printed.
parity       — greedy tokens at qwen2-1.5B width and 2 layers in fp32: the
               engine on the card against the engine on the CPU (the
               plain path), on the serving plane (inflight=True, K2), on
               the static path (inflight=False, K1f and K4) and in each
               mode of genmodes (a)-(d); every full-precision mode's
               tokens equal the static path's.
train_parity — one train_batch at qwen2-1.5B width, 2 layers, fp32, of
               the actor (PPO loss) and of a critic (value loss): the card
               (K1) against the CPU (plain path): loss, grad_norm and the
               weights after the step.

`python3 chip_smoke.py --phases build,flash` is the quick call after
editing a flash kernel, `--phases build,kernel` after editing K2, K3 or
K4 (about 20 s of command on an H100), `--phases build,ppo` for the PPO
step with the critic and the reference model, `--phases build,quickstart`
for the quickstart entry point, `--phases build,recover` for
kill-and-resume, `--phases build,kernel,parity,genmodes` for the
generator's other inflight modes.  The line before the last is one JSON object
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.  Needs one
CUDA card; imports no JAX.
"""

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "flash", "serve", "static", "push", "resume_parity",
          "train", "ppo", "quickstart", "recover", "genmodes", "parity", "train_parity")
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


def time_graph(fn, iters: int = 50) -> float:
    """Device milliseconds of one `fn()`: the call captured once in a CUDA
    graph, replayed `iters` times between two CUDA events.  Unlike
    time_cuda, no host work of the call (Python, checks, launches) is in
    the reading, so a call the host cannot keep the card busy with still
    reads its device time."""
    import torch

    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def timings(fn, plain, library, iters=25) -> dict:
    """A kernel's wrapper, its plain version and its library yardstick on
    the same inputs: device time (graph replays) and the time of an eager
    call (CUDA events around it, host work included) of each."""
    out = {}
    for key, f in (("kernel", fn), ("plain", plain), ("library", library)):
        out[f"{key}_ms"] = time_graph(f)
        out[f"{key}_eager_ms"] = time_cuda(f, iters=iters)
    return out


def no_host_sync(name: str, fn) -> None:
    """One call of a wrapper under torch.cuda.set_sync_debug_mode("error"):
    a host read of a device tensor inside it fails the run."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        check(False, f"{name}: the wrapper synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[kernel] {name}: one call under set_sync_debug_mode('error'): no host sync")


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def _ptxas_lines(log_text):
    """One line per compiled kernel from nvcc's -Xptxas -v report: its
    name (demangled with c++filt where the toolkit host has it), registers,
    spill stores/loads and static shared memory."""
    import re
    import shutil

    rows, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append([name, f"{m.group(1)} registers, {spill or 'spills ?'}"
                         + (f", {smem.group(1)} B static smem" if smem else "")])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
            text=True, timeout=60,
        ).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [f"{n}: {rest}" for n, rest in rows]




def phase_build():
    from areal_tpu_torch.kernels import build

    t0 = time.monotonic()
    info = build.build_all()
    secs = time.monotonic() - t0
    for name, r in info.items():
        log(f"[build] {name} -> {os.path.relpath(r['path'], REPO)}")
        for line in _ptxas_lines(r["log"]):
            log(f"[build]   {line}")
    log(f"[build] seconds={secs:.2f}")
    log_card()


def log_card() -> None:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[card] {smi}")


# --------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# --------------------------------------------------------------------------


def _stream(seed, fixed=(1, 2, 127, 128, 129, 255, 256, 1000, 2047, 2048, 2100), mp=16):
    """A 96-lane serving stream at qwen2-1.5B's attention shape: 56 decode
    lanes and 4 prefill slices of 8 lanes with windows of 1..2048 that
    cross page boundaries (one decode window, 2100, runs past its 16-page
    table, which then bounds it), then 8 dead lanes; page tables carry
    sentinel entries past each row's mapped pages.  The last pool page is
    never mapped, so poisoning it must change nothing.  `fixed` gives the
    first decode lanes' windows, `mp` the table's pages."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_q, n_kv, d, ps = 12, 2, 128, 128
    rows = []  # (positions of the row's lanes)
    fixed = list(fixed)
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


def _bound(s, elem_bytes, kv_bytes=None):
    """Least time for the call: unique K/V bytes the windows need (each
    position once, though many lanes of a row read it; `kv_bytes` a
    position and kv head of K, and of V, default d * elem_bytes), q in,
    out back, tables; against the flops of QK and PV at the bf16 tensor
    rate."""
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
    kv_bytes = 2 * sum(need.values()) * n_kv * (kv_bytes or d * elem_bytes)
    io_bytes = 2 * s["q"].size * elem_bytes + s["pt"].size * 4 + s["vt"].size * 4
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


K2_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 1e-3}  # max abs error


def _hold_k2(tag, s, poison):
    """K2 on stream `s` against its plain version and its split reference
    (at the kernel's own span) on the same inputs, fp32, bf16 and int8
    pools (fp32 q), each within K2_TOL; bf16 q over the int8 pool (the
    tensor-core int8 path) within FLASH_ROW_TOL["bf16"] of the plain
    version on an fp32 copy of q and within MODEL_TOL of the split
    reference (`_model_err`); window-0 lanes exactly 0; with `poison`,
    the never-mapped last pool page set to 1e9 (127 and scale 1e9 for
    int8) changing nothing.  Returns {dtype: error} and the tensors."""
    import torch

    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()
         if key != "n_live"}
    ks, vs = t["ks"].to(bf), t["vs"].to(bf)
    cases = {
        "fp32": (t["q"], t["k"], t["v"], None, None),
        "bf16": (t["q"].to(bf), t["k"].to(bf), t["v"].to(bf), None, None),
        "int8": (t["q"], t["k8"], t["v8"], ks, vs),
        "bf16q_int8": (t["q"].to(bf), t["k8"], t["v8"], ks, vs),
    }
    ps, mp = s["k"].shape[1], s["pt"].shape[1]
    span_pages, n_splits = rpa.split_plan(mp, ps, s["q"].shape[0] * s["k"].shape[2])
    dead = t["vt"] == 0
    errs = {}
    for name, (q, k, v, ksc, vsc) in cases.items():
        args = (q, k, v, t["pt"], t["vt"], ksc, vsc)
        out = rpa.ragged_paged_attention_kernel(*args)
        split = rpa.ragged_paged_attention_split_reference(*args, span=span_pages * ps)
        quant_mma = name == "bf16q_int8"
        ref = rpa.ragged_paged_attention_reference(q.float() if quant_mma else q, *args[1:])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 {tag} {name}: non-finite kernel output")
        spans = f"{n_splits} span(s) of {span_pages} page(s)"
        if quant_mma:
            rel, err = _row_err(out, ref)
            rel_m = _model_err(out, split)
            errs[name], errs[f"{name}_row"], errs[f"{name}_model"] = err, rel, rel_m
            log(f"[kernel] K2 {tag} {name}: row_err={rel:.3e} against the plain version "
                f"(tolerance {FLASH_ROW_TOL['bf16']:.3e}), {rel_m:.3e} against the split "
                f"reference beyond the output's rounding (tolerance {MODEL_TOL:g}); "
                f"max_abs_err={err:.3e}; {spans}")
            check(rel <= FLASH_ROW_TOL["bf16"], f"K2 {tag} {name} disagrees with the plain "
                  f"version: {rel:.3e}")
            check(rel_m <= MODEL_TOL, f"K2 {tag} {name} disagrees with the split reference: "
                  f"{rel_m:.3e}")
        else:
            tol = K2_TOL[name]
            err = float((out.float() - ref.float()).abs().max())
            err_s = float((out.float() - split.float()).abs().max())
            errs[name], errs[f"{name}_split"] = err, err_s
            log(f"[kernel] K2 {tag} {name}: max_abs_err={err:.3e} against the plain version, "
                f"{err_s:.3e} against the split reference (tolerance {tol:g}; {spans})")
            check(err <= tol, f"K2 {tag} {name} disagrees with the plain version")
            check(err_s <= tol, f"K2 {tag} {name} disagrees with the split reference")
        check(float(out[dead].float().abs().max()) == 0.0,
              f"K2 {tag} {name}: dead lanes are not exactly 0")
        if not poison:
            continue
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
            f"K2 {tag} {name}: poisoning the last pool page changed the output",
        )
    return errs, t, cases


def phase_kernel(report, seed):
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import paged_gather_layer
    from areal_tpu_torch.ops.quant import kv_dequant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16
    s = _stream(seed)
    errs, t, cases = _hold_k2("stream", s, poison=True)
    # Windows at the 256-position span's edges, +-1; and a 2-page table
    # (one span: the split pass writes the output, no merge) whose longer
    # windows run past it.
    edges = _stream(seed + 7, fixed=(255, 256, 257, 511, 512, 513, 767, 768, 769, 1, 2))
    for tag, es in (("span edges", edges), ("one span", _stream(seed + 8, mp=2))):
        e, _, _ = _hold_k2(tag, es, poison=False)
        errs.update({f"{tag}_{key}": val for key, val in e.items()})
    q, k, v = cases["bf16"][:3]
    no_host_sync("K2", lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"]))
    # Times at the main path's dtype (bf16 q and pool).  Library
    # yardstick: one SDPA call over the pre-gathered windows.
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
    times = timings(
        lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"]),
        lambda: rpa.ragged_paged_attention_reference(q, k, v, t["pt"], t["vt"]),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
    )
    bound_ms, bound_by = _bound(s, 2)
    log(
        f"[kernel] K2 bf16 T={T}: kernel_ms={times['kernel_ms']:.4f} "
        f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
        f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
        f"bound_ms={bound_ms:.5f} ({bound_by})"
    )
    report["kernel"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by,
                            T=T, **times)
    # bf16 q over the int8 pool (the serving plane with an int8 cache):
    # SDPA over the same windows dequantized to bf16; the bound reads one
    # byte a K/V element and its bf16 scale.
    q8, k8, v8, ks8, vs8 = cases["bf16q_int8"]
    no_host_sync("K2 bf16q_int8", lambda: rpa.ragged_paged_attention_kernel(
        q8, k8, v8, t["pt"], t["vt"], ks8, vs8))
    kd = kv_dequant(paged_gather_layer(k8, t["pt"]), paged_gather_layer(ks8, t["pt"]), bf)
    vd = kv_dequant(paged_gather_layer(v8, t["pt"]), paged_gather_layer(vs8, t["pt"]), bf)
    kd = kd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
    vd = vd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
    times8 = timings(
        lambda: rpa.ragged_paged_attention_kernel(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
        lambda: rpa.ragged_paged_attention_reference(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask),
    )
    bound8, by8 = _bound(s, 2, kv_bytes=d + 2)
    log(
        f"[kernel] K2 bf16q_int8 T={T}: kernel_ms={times8['kernel_ms']:.4f} "
        f"plain_ms={times8['plain_ms']:.4f} library_ms={times8['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times8['kernel_eager_ms']:.4f} "
        f"plain={times8['plain_eager_ms']:.4f} library={times8['library_eager_ms']:.4f}; "
        f"bound_ms={bound8:.5f} ({by8})"
    )
    report["kernel"]["bf16q_int8"] = dict(bound_ms=bound8, bound_by=by8, **times8)
    _kernel_k3(report, seed)
    _kernel_k3_q1(report, seed)
    _kernel_k4(report, seed)
    _kernel_k4_inflight(report, seed)
    _split_sweep(report, seed)


def _split_sweep(report, seed):
    """K2 (the 96-lane stream) and K4 (the 32-row decode case), bf16, and
    K2 at K3's Q=1 shape (16 slots; bf16, and bf16 q over int8): device
    time (graph replays) at forced spans around the wrappers' own, and
    one profiled call of each at its own plan's span, split into the
    split pass and the merge kernel."""
    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    dev, bf = torch.device("cuda"), torch.bfloat16
    s = _stream(seed)
    q2, k2, v2 = (torch.from_numpy(s[key]).to(dev).to(bf) for key in ("q", "k", "v"))
    pt, vt2 = torch.from_numpy(s["pt"]).to(dev), torch.from_numpy(s["vt"]).to(dev)
    q_np, vf_np, vt_np, S = _k4_cases(seed)["decode"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q4 = torch.from_numpy(q_np).to(dev).to(bf)
    k4, v4 = (torch.randn((32, S, 2, 128), generator=gen, device=dev).to(bf)
              for _ in range(2))
    vf, vt4 = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
    # K2 at K3's Q=1 shape (16 slots, windows 64-640, a 6-page table of
    # 128: the two-program path's decode step), bf16 and bf16 q over int8.
    rng = np.random.default_rng(seed + 41)
    L = rng.integers(64, 641, 16)
    L[:2] = (64, 640)
    sl = _k3_slots(rng, 1, L, np.ones(16, np.int32), [-(-int(x) // 128) for x in L], 6)
    q1 = torch.from_numpy(sl["q"][:, 0]).to(dev).to(bf)
    k1, v1 = (torch.from_numpy(sl[key]).to(dev).to(bf) for key in ("k", "v"))
    k18, v18 = (torch.from_numpy(sl[key]).to(dev) for key in ("k8", "v8"))
    ks1, vs1 = (torch.from_numpy(sl[key]).to(dev).to(bf) for key in ("ks", "vs"))
    pt1, vt1 = torch.from_numpy(sl["pt"]).to(dev), torch.from_numpy(sl["hi0"]).to(dev)
    own2 = rpa.split_plan(pt.shape[1], 128, q2.shape[0] * 2)[0] * 128
    own1 = rpa.split_plan(pt1.shape[1], 128, 16 * 2)[0] * 128
    runs = (
        ("K2", rpa, lambda: rpa.ragged_paged_attention_kernel(q2, k2, v2, pt, vt2),
         (128, 256, 512), own2),
        ("K4", da, lambda: da.decode_attention_kernel(q4, k4, v4, vf, vt4),
         (64, 128, 256), da.SPLIT_POSITIONS),
        ("K2 Q=1 B=16", rpa, lambda: rpa.ragged_paged_attention_kernel(q1, k1, v1, pt1, vt1),
         (128, 256, 384), own1),
        ("K2 Q=1 B=16 bf16q_int8", rpa,
         lambda: rpa.ragged_paged_attention_kernel(q1, k18, v18, pt1, vt1, ks1, vs1),
         (128, 256, 384), own1),
    )
    out = {}
    for name, mod, fn, spans, own in runs:
        # Each span forced: K2's plan keeps it whatever the grid's size.
        saved = {key: getattr(mod, key) for key in ("SPLIT_POSITIONS", "SPLIT_MIN_BLOCKS")
                 if hasattr(mod, key)}
        try:
            for span in spans:
                mod.SPLIT_POSITIONS = span
                if "SPLIT_MIN_BLOCKS" in saved:
                    mod.SPLIT_MIN_BLOCKS = 0
                out[f"{name}_span{span}_ms"] = time_graph(fn)
        finally:
            for key, val in saved.items():
                setattr(mod, key, val)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        parts = {"split": 0.0, "merge": 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "attention" in e.key:
                us = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if us is None else us
                parts["merge" if "merge" in e.key else "split"] += us / 20
        out[f"{name}_split_us"], out[f"{name}_merge_us"] = parts["split"], parts["merge"]
        log(f"[kernel] {name} spans (positions: device ms) "
            + ", ".join(f"{sp}: {out[f'{name}_span{sp}_ms']:.4f}" for sp in spans)
            + f"; at its own span {own}, one call = split pass {parts['split']:.1f} us"
            f" + merge {parts['merge']:.1f} us (profiler)")
    report["split_sweep"] = out


def _k3_slots(rng, nq_tok, hi0, ql, n_pages, mp, n_q=12, n_kv=2, d=128, ps=128):
    """K3's inputs at qwen2-1.5B width: slot s maps n_pages[s] pages of a
    shuffled pool, then sentinels; query i of slot s attends [0, hi0[s] +
    i) while i < ql[s].  The last pool page is never mapped, so poisoning
    it must change nothing."""
    import numpy as np

    b = len(hi0)
    n_pool = sum(n_pages) + 8
    perm = rng.permutation(n_pool - 1)  # page n_pool-1 stays unmapped
    pt = np.full((b, mp), n_pool, np.int32)
    used = 0
    for s, k in enumerate(n_pages):
        pt[s, :k] = perm[used : used + k]
        used += k
    return dict(
        q=rng.standard_normal((b, nq_tok, n_q, d)).astype(np.float32),
        k=rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32),
        v=rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32),
        k8=rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8),
        v8=rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8),
        ks=(np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002).astype(np.float32),
        vs=(np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002).astype(np.float32),
        pt=pt, hi0=np.asarray(hi0, np.int32), ql=np.asarray(ql, np.int32),
    )


def _replay_slots(seed):
    """The resume replay's shape at qwen2-1.5B width: B=64 slots of
    Q=chunk_t=32 queries; slot b has L forwarded tokens (64..640) and
    replays its last r (0..32, some 0), so query i attends
    [0, L - r + 1 + i) and valid_to0 = L - r + 1.  Each slot maps
    ceil(L / 128) pages of a shuffled pool."""
    import numpy as np

    rng = np.random.default_rng(seed + 21)
    b, nq_tok, ps = 64, 32, 128
    L = rng.integers(64, 641, b)
    L[:4] = (64, 127, 128, 640)
    r = rng.integers(0, nq_tok + 1, b)
    r[:8] = (32, 1, 0, 32, 0, 17, 32, 5)
    r = np.minimum(r, L)
    mp = -(-(640 + nq_tok) // ps)
    return _k3_slots(rng, nq_tok, L - r + 1, r, [-(-int(x) // ps) for x in L], mp)


def _k3_edge_slots(seed, nq_tok):
    """K3's edge cases at qwen2-1.5B width, page 128, a 6-page table (768
    positions), against the kernel's 64-row blocks and 32-position tiles:
    8 slots of Q=13 queries (78 rows: one full block and one partial,
    straddling queries) or of Q=1.  The last live query's window ends at
    32 (a tile edge), 128 (a page edge), 129, 256, past the table (800,
    bounded to 768), at 13 in a ragged slot (2 of Q live), at 1, and
    nowhere in an all-dead slot (q_lens 0)."""
    import numpy as np

    rng = np.random.default_rng(seed + 22 + nq_tok)
    last = np.array([32, 128, 129, 256, 800, 13, 1, 300])
    ql = np.minimum(np.array([13, 13, 13, 13, 13, 2, 1, 0]), nq_tok)
    pages = [-(-min(int(x), 768) // 128) if n else 0 for x, n in zip(last, ql)]
    return _k3_slots(rng, nq_tok, last - np.maximum(ql - 1, 0), ql, pages, 6)


def _k3_bound(s, elem_bytes, kv_bytes=None):
    """Least time for K3 on these slots: the flops of QK and PV over every
    live query's window at the bf16 tensor rate, against each slot's
    unique K/V positions (its widest live window, read once for all its
    queries and heads; `kv_bytes` a position and kv head of K, and of V,
    default d * elem_bytes), the live queries' q in (a dead query's
    output is 0 whatever its q holds), every output row back and the
    tables at the HBM rate."""
    b, nq_tok, n_q, d = s["q"].shape
    n_kv = s["k"].shape[2]
    cap = s["pt"].shape[1] * s["k"].shape[1]
    flops = kv_pos = 0
    for hi0, ql in zip(s["hi0"].tolist(), s["ql"].tolist()):
        for i in range(ql):
            flops += 4 * d * n_q * min(hi0 + i, cap)
        if ql > 0:
            kv_pos += min(hi0 + ql - 1, cap)
    nbytes = (2 * kv_pos * n_kv * (kv_bytes or d * elem_bytes)
              + int(s["ql"].sum()) * n_q * d * elem_bytes + s["q"].size * elem_bytes
              + s["pt"].size * 4 + 2 * b * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _k3_poison(s, k, v, ks, vs):
    """Copies of a pool (and its scales) with every page no slot maps and,
    in each slot's mapped pages, every position at or past its widest
    live window (0 for a slot with no live query) set to a huge value
    (int8: code 127 with a scale of 1e9): no kernel read may reach them."""
    import numpy as np
    import torch

    n_pool, ps = k.shape[:2]
    bad = np.ones((n_pool, ps), bool)
    cap = s["pt"].shape[1] * ps
    for pt_row, hi0, ql in zip(s["pt"], s["hi0"].tolist(), s["ql"].tolist()):
        end = max(0, min(hi0 + ql - 1, cap)) if ql > 0 else 0
        for j, page in enumerate(pt_row.tolist()):
            if page < n_pool:
                bad[page, : max(0, min(end - j * ps, ps))] = False
    bad = torch.from_numpy(bad).to(k.device)
    huge = 127 if k.dtype == torch.int8 else 1e9
    k_bad, v_bad = (torch.where(bad[..., None, None], torch.full_like(x, huge), x)
                    for x in (k, v))
    if ks is None:
        return k_bad, v_bad, ks, vs
    ks_bad, vs_bad = (torch.where(bad[..., None], torch.full_like(x, 1e9), x) for x in (ks, vs))
    return k_bad, v_bad, ks_bad, vs_bad


def _hold_k3(tag, s):
    """K3 on slots `s` (see _k3_slots) in fp32, bf16, fp32 q over an int8
    pool and bf16 q over an int8 pool (the replay's int8 form), each
    output row (one position's head vector) within FLASH_ROW_TOL of that
    row's largest |value| (see _row_err) of its plain version, taken on
    fp32 copies of the same rounded inputs, and of its tiled model
    (`paged_chunk_attention_tiled_reference`, the kernel's own tiles and
    bf16 P or P'); bf16 q over int8 also within MODEL_TOL of the tiled
    model beyond the output's rounding (`_model_err`, as K2 and K4 hold
    the same arithmetic); dead queries and q_lens-0 slots exactly 0;
    poisoning what no window reaches (_k3_poison) changes nothing,
    bitwise.  Returns (errors, the cases, the device tensors)."""
    import torch

    from areal_tpu_torch.kernels import paged_chunk_attention as pca

    dev = torch.device("cuda")
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()}
    pt, hi0, ql = t["pt"], t["hi0"], t["ql"]
    nq_tok = s["q"].shape[1]
    dead = torch.arange(nq_tok, device=dev)[None, :] >= ql[:, None]  # [B, Q]
    ks, vs = t["ks"].to(torch.bfloat16), t["vs"].to(torch.bfloat16)
    bf = torch.bfloat16
    cases = {
        "fp32": (t["q"], t["k"], t["v"], None, None, FLASH_ROW_TOL["fp32"]),
        "bf16": (t["q"].to(bf), t["k"].to(bf), t["v"].to(bf), None, None,
                 FLASH_ROW_TOL["bf16"]),
        "int8": (t["q"], t["k8"], t["v8"], ks, vs, FLASH_ROW_TOL["fp32"]),
        "bf16q_int8": (t["q"].to(bf), t["k8"], t["v8"], ks, vs, FLASH_ROW_TOL["bf16"]),
    }
    errs = {}
    for name, (q, k, v, ksc, vsc, tol) in cases.items():
        out = pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql, ksc, vsc)
        f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
        ref = pca.paged_chunk_attention_reference(
            q.float(), f32(k), f32(v), pt, hi0, ql, ksc, vsc
        )
        tiled = pca.paged_chunk_attention_tiled_reference(q, k, v, pt, hi0, ql, ksc, vsc)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K3 {tag} {name}: non-finite output")
        rel, err = _row_err(out, ref)
        rel_t, _ = _row_err(out, tiled)
        errs[name], errs[f"{name}_row"], errs[f"{name}_tiled_row"] = err, rel, rel_t
        log(f"[kernel] K3 {tag} {name}: row_err={rel:.3e}, against the tiled model "
            f"{rel_t:.3e} (tolerance {tol:.3e}) max_abs_err={err:.3e}")
        check(rel <= tol, f"K3 {tag} {name} disagrees with the plain version")
        check(rel_t <= tol, f"K3 {tag} {name} disagrees with the tiled model")
        if name == "bf16q_int8":
            rel_m = _model_err(out, tiled)
            errs[f"{name}_model"] = rel_m
            log(f"[kernel] K3 {tag} {name}: {rel_m:.3e} against the tiled model beyond the "
                f"output's rounding (tolerance {MODEL_TOL:g})")
            check(rel_m <= MODEL_TOL, f"K3 {tag} {name} disagrees with the tiled model "
                  f"beyond the output's rounding: {rel_m:.3e}")
        if bool(dead.any()):
            check(float(out.float()[dead].abs().max()) == 0.0,
                  f"K3 {tag} {name}: dead queries are not exactly 0")
        k_bad, v_bad, ks_bad, vs_bad = _k3_poison(s, k, v, ksc, vsc)
        out_bad = pca.paged_decode_attention_chunk(q, k_bad, v_bad, pt, hi0, ql, ks_bad, vs_bad)
        check(torch.equal(out, out_bad),
              f"K3 {tag} {name}: poisoning what no window reaches changed the output")
    return errs, cases, t


def _kernel_k3(report, seed):
    """K3 held (see _hold_k3) at the replay's shape and on the edge slots
    at Q=13 and Q=1; one call under the sync debug mode; then, at the
    replay's shape in bf16 and in bf16 q over an int8 pool, the times of
    K3, its plain version and SDPA on the gathered windows with the
    boolean mask (device time from graph replays, and eager calls), and
    the bound."""
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.ops.attention import paged_gather_layer

    dev = torch.device("cuda")
    s = _replay_slots(seed)
    errs, cases, t = _hold_k3("replay", s)
    for nq_tok in (13, 1):
        e, _, _ = _hold_k3(f"edges Q={nq_tok}", _k3_edge_slots(seed, nq_tok))
        errs.update({f"edges{nq_tok}_{key}": val for key, val in e.items()})
    pt, hi0, ql = t["pt"], t["hi0"], t["ql"]
    b, nq_tok = s["q"].shape[:2]
    dead = torch.arange(nq_tok, device=dev)[None, :] >= ql[:, None]
    q, k, v = cases["bf16"][:3]
    no_host_sync("K3", lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql))
    # Library yardstick: one SDPA call over the gathered windows with the
    # boolean mask (query i of slot b sees [0, hi0[b] + i) while i < ql[b]).
    kc = paged_gather_layer(k, pt).transpose(1, 2).contiguous()  # [B, n_kv, S, d]
    vc = paged_gather_layer(v, pt).transpose(1, 2).contiguous()
    pos = torch.arange(kc.shape[2], device=dev)
    qi = torch.arange(nq_tok, device=dev)
    mask = (pos[None, None, :] < (hi0[:, None] + qi[None, :])[:, :, None]) & ~dead[:, :, None]
    q4 = q.transpose(1, 2).contiguous()  # [B, n_q, Q, d]
    times = timings(
        lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql),
        lambda: pca.paged_chunk_attention_reference(q, k, v, pt, hi0, ql),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask[:, None],
                                               enable_gqa=True),
        iters=10,
    )
    bound_ms, bound_by = _k3_bound(s, 2)
    log(f"[kernel] K3 bf16 B={b} Q={nq_tok}: kernel_ms={times['kernel_ms']:.4f} "
        f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
        f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
        f"bound_ms={bound_ms:.5f} ({bound_by}); {int((~dead).sum())} live queries")
    report["k3"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by, **times)
    # bf16 q over the int8 pool at the replay shape (the resume replay of
    # an int8 serving plane): held in _hold_k3; here one call under the
    # sync debug mode, then its times beside SDPA over the windows
    # dequantized to bf16; the bound reads one byte a K/V element and its
    # bf16 scale.
    from areal_tpu_torch.ops.quant import kv_dequant

    q8, k8, v8, ks8, vs8 = cases["bf16q_int8"][:5]
    no_host_sync("K3 bf16q_int8",
                 lambda: pca.paged_decode_attention_chunk(q8, k8, v8, pt, hi0, ql, ks8, vs8))
    kd = kv_dequant(paged_gather_layer(k8, pt), paged_gather_layer(ks8, pt), torch.bfloat16)
    vd = kv_dequant(paged_gather_layer(v8, pt), paged_gather_layer(vs8, pt), torch.bfloat16)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    times8 = timings(
        lambda: pca.paged_decode_attention_chunk(q8, k8, v8, pt, hi0, ql, ks8, vs8),
        lambda: pca.paged_chunk_attention_reference(q8, k8, v8, pt, hi0, ql, ks8, vs8),
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask[:, None],
                                               enable_gqa=True),
        iters=10,
    )
    bound8, by8 = _k3_bound(s, 2, kv_bytes=q.shape[-1] + 2)
    log(f"[kernel] K3 bf16q_int8 B={b} Q={nq_tok}: row_err="
        f"{errs['bf16q_int8_row']:.3e}, against the tiled model "
        f"{errs['bf16q_int8_tiled_row']:.3e} (tolerance {FLASH_ROW_TOL['bf16']:.3e}), "
        f"beyond the output's rounding {errs['bf16q_int8_model']:.3e} (tolerance "
        f"{MODEL_TOL:g}); "
        f"kernel_ms={times8['kernel_ms']:.4f} plain_ms={times8['plain_ms']:.4f} library_ms="
        f"{times8['library_ms']:.4f} (device, graph replays); eager calls kernel="
        f"{times8['kernel_eager_ms']:.4f} plain={times8['plain_eager_ms']:.4f} library="
        f"{times8['library_eager_ms']:.4f}; bound_ms={bound8:.5f} ({by8})")
    report["k3"]["bf16q_int8"] = dict(
        row_err=errs["bf16q_int8_row"], max_abs_err=errs["bf16q_int8"],
        row_err_tiled=errs["bf16q_int8_tiled_row"], model_err=errs["bf16q_int8_model"],
        bound_ms=bound8, bound_by=by8, **times8)


def _k4_cases(seed):
    """K4's inputs at qwen2-1.5B's attention shape (Hq=12, Hkv=2, D=128).
    decode: the static path's decode step — 32 rows of a S=1024 cache,
    prompts of 64..512 right-aligned at 512 (valid_from = 512 - prompt),
    64 tokens generated, so the window ends at valid_to = 576.  chunk:
    the same rows with Q=4 queries, the last seeing to 576.  w1280: a
    window of 1280 positions (no tile of 32 or block of 512 divides what
    the rows see), rows 2 and 3 empty.  empty: Q=2, rows 0-2 empty for
    both queries, row 3 for its first query only.  edges: windows of the
    256-position span +-1 (and 2 spans +-1, 1 and 0 positions) from
    random starts.  one_span: S=256, a single span (the split pass writes
    the output, no merge), Q=2, row 2's first query empty.  Returns
    {name: (q [B, Q, 12, 128], valid_from [B], valid_to0 [B], S)}."""
    import numpy as np

    rng = np.random.default_rng(seed + 31)
    n_q, d = 12, 128
    plen = rng.integers(64, 513, 32)
    plen[:2] = (64, 512)
    vf = (512 - plen).astype(np.int32)
    cases = {
        "decode": (1, vf, np.full(32, 576, np.int32), 1024),
        "chunk": (4, vf, np.full(32, 573, np.int32), 1024),
    }
    vf_w = rng.integers(0, 256, 4).astype(np.int32)
    vt_w = np.array([1280, 1031, 0, 5], np.int32)
    vf_w[3] = 9  # rows 2 and 3: valid_from >= valid_to
    cases["w1280"] = (1, vf_w, vt_w, 1280)
    vf_e = rng.integers(0, 300, 8).astype(np.int32)
    vt_e = rng.integers(300, 1000, 8).astype(np.int32)
    vf_e[:3] = (1000, 1023, 700)
    vt_e[:3] = (40, 1000, 699)  # every query of rows 0-2 empty
    vf_e[3], vt_e[3] = 500, 500  # query 0 empty, query 1 sees [500, 501)
    cases["empty"] = (2, vf_e, vt_e, 1024)
    vf_s = rng.integers(0, 200, 8).astype(np.int32)
    lens = np.array([255, 256, 257, 511, 512, 513, 1, 0], np.int32)
    cases["edges"] = (1, vf_s, vf_s + lens, 1024)
    cases["one_span"] = (2, np.array([0, 5, 100, 250], np.int32),
                         np.array([255, 200, 100, 255], np.int32), 256)
    return {
        name: (rng.standard_normal((len(f), nq, n_q, d)).astype(np.float32), f, t, S)
        for name, (nq, f, t, S) in cases.items()
    }


def _k4_windows(vf, vt0, nq, S):
    """[B, Q, S] bool: query i of row b sees [vf[b], vt0[b] + i) within S."""
    import torch

    pos = torch.arange(S, device=vf.device)
    hi = (vt0[:, None] + torch.arange(nq, device=vf.device)[None, :]).clamp(max=S)
    return (pos[None, None, :] >= vf[:, None, None]) & (pos[None, None, :] < hi[:, :, None])


def _k4_bound(vf, vt0, nq, S, n_q, n_kv, d, elem_bytes, kv_bytes=None):
    """Least time for K4 on these rows: the flops of QK and PV over each
    query's live window at the bf16 tensor rate, against each row's live
    K/V positions (the union of its queries' windows, read once for all
    its queries and heads; `kv_bytes` a position and kv head of K, and of
    V, default d * elem_bytes), q in, out back and the two window bounds,
    at the HBM rate."""
    flops = kv_pos = 0
    for f, t in zip(vf.tolist(), vt0.tolist()):
        lens = [max(0, min(t + i, S) - max(f, 0)) for i in range(nq)]
        flops += sum(4 * d * n_q * n for n in lens)
        kv_pos += max(lens)
    b = len(vf)
    nbytes = (2 * kv_pos * n_kv * (kv_bytes or d * elem_bytes)
              + 2 * b * nq * n_q * d * elem_bytes + 2 * b * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _kernel_k4(report, seed):
    """K4 against its plain version (`decode_attention_chunk` with every
    query live) and its split reference (at the kernel's span) on fp32
    copies of the same inputs, for each case of _k4_cases and fp32, bf16
    and int8 caches: each output row within FLASH_ROW_TOL of that row's
    largest |plain| value (int8: the fp32 bound), empty windows exactly
    0, K/V poisoned at every position outside every window of its row
    changing nothing; bf16 q over the int8 cache (the tensor-core int8
    path) also, within the bf16 row tolerance of the plain version and
    within MODEL_TOL of the split reference.  Then, at the decode case in bf16 (B=32, and the
    static phase's B=64), the times of K4, its plain version and SDPA on
    the same dense window with the boolean mask, and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.ops.attention import decode_attention_chunk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 32)
    bf = torch.bfloat16
    n_kv, d = 2, 128
    errs, n_zero = {}, 0
    for cname, (q_np, vf_np, vt_np, S) in _k4_cases(seed).items():
        b, nq = q_np.shape[:2]
        span, n_splits = da.split_plan(S)
        shape = (b, S, n_kv, d)
        base = {
            "q": torch.from_numpy(q_np).to(dev),
            "k": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            "v": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            "k8": torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev),
            "v8": torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev),
            "ks": torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
                  .to(dev).to(bf),
            "vs": torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
                  .to(dev).to(bf),
        }
        vf, vt = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
        win = _k4_windows(vf, vt, nq, S)  # [B, Q, S]
        empty = ~win.any(-1)  # [B, Q]
        outside = ~win.any(1)  # [B, S]: no query of the row sees it
        full = torch.full((b,), nq, dtype=torch.long, device=dev)
        cases = {
            "fp32": (base["q"], base["k"], base["v"], None, None, FLASH_ROW_TOL["fp32"]),
            "bf16": (base["q"].to(bf), base["k"].to(bf), base["v"].to(bf), None, None,
                     FLASH_ROW_TOL["bf16"]),
            "int8": (base["q"], base["k8"], base["v8"], base["ks"], base["vs"],
                     FLASH_ROW_TOL["fp32"]),
            "bf16q_int8": (base["q"].to(bf), base["k8"], base["v8"], base["ks"], base["vs"],
                           FLASH_ROW_TOL["bf16"]),
        }
        for tname, (q, k, v, ksc, vsc, tol) in cases.items():
            out = da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc)
            f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
            ref = decode_attention_chunk(
                q.float(), f32(k), f32(v), vf.long(), vt.long(), full, ksc, vsc
            )
            # The split reference takes the kernel's own q: its type picks
            # the arithmetic (bf16 q over int8 runs on the tensor cores).
            quant_mma = tname == "bf16q_int8"
            split = da.decode_attention_chunk_split_reference(
                q if quant_mma else q.float(), f32(k), f32(v), vf, vt, ksc, vsc, span=span
            )
            torch.cuda.synchronize()
            tag = f"{cname} {tname}"
            check(bool(torch.isfinite(out).all()), f"K4 {tag}: non-finite output")
            rel, err = _row_err(out, ref)
            rel_s = _model_err(out, split) if quant_mma else _row_err(out, split)[0]
            tol_s = MODEL_TOL if quant_mma else tol
            errs[f"{tname}_{cname}"], errs[f"{tname}_{cname}_row"] = err, rel
            errs[f"{tname}_{cname}_split_row"] = rel_s
            check(rel <= tol, f"K4 {tag} disagrees with the plain version: {rel:.3e}")
            check(rel_s <= tol_s,
                  f"K4 {tag} disagrees with the split reference: {rel_s:.3e}")
            if bool(empty.any()):
                check(float(out.float()[empty].abs().max()) == 0.0,
                      f"K4 {tag}: empty windows are not exactly 0")
                n_zero += int(empty.sum())
            k_bad, v_bad = k.clone(), v.clone()
            ks_bad, vs_bad = ksc, vsc
            if k.dtype == torch.int8:
                k_bad[outside], v_bad[outside] = 127, 127
                ks_bad, vs_bad = ksc.clone(), vsc.clone()
                ks_bad[outside], vs_bad[outside] = 1e9, 1e9
            else:
                k_bad[outside], v_bad[outside] = 1e9, 1e9
            out_bad = da.decode_attention_chunk_kernel(q, k_bad, v_bad, vf, vt, ks_bad, vs_bad)
            check(torch.equal(out, out_bad),
                  f"K4 {tag}: poisoning positions outside every window changed the output")
            log(f"[kernel] K4 {tag}: B={b} Q={nq} S={S} ({n_splits} span(s)) "
                f"row_err={rel:.3e} (tolerance {tol:.3e}), against the split reference "
                f"{rel_s:.3e} (tolerance {tol_s:.3e}"
                + (", beyond the output's rounding" if quant_mma else "")
                + f") max_abs_err={err:.3e}")
    log(f"[kernel] K4: {n_zero} empty-window query rows exactly 0; poisoned positions "
        f"outside every window changed nothing")
    # Times at the static path's decode shape, bf16 q and cache: the
    # decode case's 32 rows, then 64 rows (the static phase's batch) with
    # the same window rule.  Library yardstick: SDPA over the same dense
    # window, boolean mask, GQA native.
    q_np, vf_np, vt_np, S = _k4_cases(seed)["decode"]
    plen = rng.integers(64, 513, 64)
    per_b = {32: (q_np, vf_np, vt_np),
             64: (rng.standard_normal((64, 1, 12, d)).astype(np.float32),
                  (512 - plen).astype(np.int32), np.full(64, 576, np.int32))}
    for b, (q_np, vf_np, vt_np) in per_b.items():
        q = torch.from_numpy(q_np).to(dev).to(bf)
        k, v = (torch.from_numpy(rng.standard_normal((b, S, n_kv, d)).astype(np.float32))
                .to(dev).to(bf) for _ in range(2))
        vf, vt = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
        full = torch.full((b,), 1, dtype=torch.long, device=dev)
        if b == 32:
            no_host_sync("K4", lambda: da.decode_attention_kernel(q, k, v, vf, vt))
        mask = _k4_windows(vf, vt, 1, S)[:, None]  # [B, 1, 1, S]
        q4 = q.transpose(1, 2).contiguous()  # [B, 12, 1, D]
        kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        times = timings(
            lambda: da.decode_attention_kernel(q, k, v, vf, vt),
            lambda: decode_attention_chunk(q, k, v, vf.long(), vt.long(), full),
            lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                   enable_gqa=True),
            iters=10,
        )
        bound_ms, bound_by = _k4_bound(vf_np, vt_np, 1, S, 12, n_kv, d, 2)
        log(f"[kernel] K4 bf16 decode B={b} S={S}: kernel_ms={times['kernel_ms']:.4f} "
            f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
            f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
            f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
            f"bound_ms={bound_ms:.5f} ({bound_by}); {int((vt_np - vf_np).sum())} live "
            f"positions")
        if b == 32:
            report["k4"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by,
                                **times)
        else:
            report["k4"]["b64"] = dict(bound_ms=bound_ms, **times)


def _kernel_k3_q1(report, seed):
    """K3's Q=1 entry point (`paged_decode_attention_kernel`: the
    two-program path's decode attention, one query a slot), which runs
    K2's kernel, at the paged-decode shape: 16 and 64 slots, windows
    64-640 over shuffled pages of 128, a 6-page table.  The chunk kernel
    at Q=1 held as _hold_k3 holds it (fp32, bf16, int8 pools with fp32
    and with bf16 q; poison); then for the first four (bf16 q over the
    int8 pool: decode_step_paged's int8 form) the wrapper equal to K2's
    wrapper on the same inputs and within the row tolerance of the plain
    `paged_decode_attention` (on an fp32 copy of q), the bf16-q int8 form
    also within MODEL_TOL of K2's split reference; one call under the
    sync debug mode; then, for bf16 and bf16 q over int8, the times of
    the wrapper, the plain version and SDPA over the gathered windows
    (dequantized to bf16 for int8), beside the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import paged_decode_attention, paged_gather_layer
    from areal_tpu_torch.ops.quant import kv_dequant

    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(seed + 41)
    out = {}
    for b in (16, 64):
        L = rng.integers(64, 641, b)
        L[:2] = (64, 640)
        s = _k3_slots(rng, 1, L, np.ones(b, np.int32), [-(-int(x) // 128) for x in L], 6)
        errs, cases, t = _hold_k3(f"Q=1 B={b}", s)
        pt, vt = t["pt"], t["hi0"]
        cases = {name: cases[name][:6] for name in ("fp32", "bf16", "int8", "bf16q_int8")}
        span_pages, _ = rpa.split_plan(pt.shape[1], t["k8"].shape[1], b * t["k8"].shape[2])
        for name, (q, k, v, ksc, vsc, tol) in cases.items():
            got = pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc)
            k2 = rpa.ragged_paged_attention_kernel(q[:, 0], k, v, pt, vt, ksc, vsc)[:, None]
            f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
            plain = paged_decode_attention(q.float(), f32(k), f32(v), pt, vt, ksc, vsc)
            rel, err = _row_err(got, plain)
            errs[f"{name}_q1_row"], errs[f"{name}_q1"] = rel, err
            check(torch.equal(got, k2), f"K3 Q=1 B={b} {name}: the wrapper is not K2's "
                  "kernel on the same inputs")
            check(rel <= tol, f"K3 Q=1 B={b} {name} disagrees with paged_decode_attention: "
                  f"{rel:.3e}")
            if name == "bf16q_int8":
                model = rpa.ragged_paged_attention_split_reference(
                    q[:, 0], k, v, pt, vt, ksc, vsc, span=span_pages * k.shape[1])[:, None]
                rel_m = _model_err(got, model)
                errs[f"{name}_q1_model"] = rel_m
                check(rel_m <= MODEL_TOL, f"K3 Q=1 B={b} {name} disagrees with K2's split "
                      f"reference: {rel_m:.3e}")
            log(f"[kernel] K3 Q=1 B={b} {name}: the wrapper is K2's kernel (equal); row_err="
                f"{rel:.3e} against paged_decode_attention (tolerance {tol:.3e})"
                + (f", {rel_m:.3e} against K2's split reference beyond the output's rounding "
                   f"(tolerance {MODEL_TOL:g})" if name == "bf16q_int8" else ""))
        res = dict(max_abs_err=errs)
        for name in ("bf16", "bf16q_int8"):
            q, k, v, ksc, vsc = cases[name][:5]
            no_host_sync(f"K3 Q=1 B={b} {name}",
                         lambda: pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc))
            kc, vc = paged_gather_layer(k, pt), paged_gather_layer(v, pt)  # [B, S, n_kv, d]
            if ksc is not None:
                kc = kv_dequant(kc, paged_gather_layer(ksc, pt), bf)
                vc = kv_dequant(vc, paged_gather_layer(vsc, pt), bf)
            kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            mask = (torch.arange(kc.shape[2], device=dev)[None, :] < vt[:, None])[:, None, None, :]
            q4 = q.transpose(1, 2).contiguous()  # [B, n_q, 1, d]
            times = timings(
                lambda: pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc),
                lambda: paged_decode_attention(q, k, v, pt, vt, ksc, vsc),
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                       enable_gqa=True),
                iters=10,
            )
            bound_ms, bound_by = _k3_bound(s, 2, kv_bytes=k.shape[-1] + 2 if ksc is not None
                                           else None)
            log(f"[kernel] K3 Q=1 {name} B={b}: kernel_ms={times['kernel_ms']:.4f} "
                f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
                f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
                f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
                f"bound_ms={bound_ms:.5f} ({bound_by}); {int(L.sum())} live positions")
            entry = dict(bound_ms=bound_ms, bound_by=bound_by, **times)
            if name == "bf16":
                res.update(entry)
            else:
                res[name] = entry
        out[b] = res
    report["k3"]["q1"] = out


def _kernel_k4_inflight(report, seed):
    """K4 at the dense inflight window's shapes: 16 left-aligned rows of a
    S=1024 cache, windows [0, L) with L 64-640.  Q=1 and Q=5 with bf16 q
    over an int8 cache and bf16 scales (decode_step_inflight's and
    decode_step_spec's int8 forms), and Q=5 in bf16 (decode_step_spec at
    K=4: query j sees [0, L + j)).  Each held against
    `decode_attention_chunk` on the same inputs (q in fp32) within the
    bf16 row tolerance, the int8 forms also within MODEL_TOL of the split
    reference, positions past every window poisoned changing nothing;
    one call under the sync debug mode; then the times of K4, its plain
    version and SDPA (over the window dequantized to bf16 for the int8
    forms), beside the bound (int8: one byte a K/V element plus its row's
    bf16 scale)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.ops.attention import decode_attention_chunk
    from areal_tpu_torch.ops.quant import kv_dequant

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 42)
    b, S, n_q, n_kv, d = GENMODE_SLOTS, 1024, 12, 2, 128
    bf = torch.bfloat16
    L = rng.integers(64, 641, b).astype(np.int32)
    L[:2] = (64, 640)
    vf = torch.zeros(b, dtype=torch.int32, device=dev)
    vt = torch.from_numpy(L).to(dev)
    shape = (b, S, n_kv, d)
    k8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
    v8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
    ks, vs = (torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
              .to(dev).to(bf) for _ in range(2))
    k16, v16 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(bf)
                for _ in range(2))
    out = {}
    span = da.split_plan(S)[0]
    for tag, nq, k, v, ksc, vsc in (("int8_q1", 1, k8, v8, ks, vs),
                                    ("int8_q5", 5, k8, v8, ks, vs),
                                    ("q5", 5, k16, v16, None, None)):
        q = torch.from_numpy(rng.standard_normal((b, nq, n_q, d)).astype(np.float32)).to(dev)
        q = q.to(bf)
        full = torch.full((b,), nq, dtype=torch.long, device=dev)
        got = da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc)
        f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
        plain = decode_attention_chunk(q.float(), f32(k), f32(v), vf.long(), vt.long(), full,
                                       ksc, vsc)
        rel, err = _row_err(got, plain)
        check(bool(torch.isfinite(got).all()), f"K4 {tag}: non-finite output")
        check(rel <= FLASH_ROW_TOL["bf16"], f"K4 {tag} disagrees with the plain version: "
              f"{rel:.3e}")
        rel_m = None
        if ksc is not None:  # the tensor-core int8 path against its model
            rel_m = _model_err(got, da.decode_attention_chunk_split_reference(
                q, k, v, vf, vt, ksc, vsc, span=span))
            check(rel_m <= MODEL_TOL, f"K4 {tag} disagrees with the split reference: "
                  f"{rel_m:.3e}")
        outside = ~_k4_windows(vf, vt, nq, S).any(1)  # [B, S]
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[outside], v_bad[outside] = (127, 127) if k.dtype == torch.int8 else (1e4, 1e4)
        check(torch.equal(got, da.decode_attention_chunk_kernel(q, k_bad, v_bad, vf, vt,
                                                               ksc, vsc)),
              f"K4 {tag}: poisoning positions outside every window changed the output")
        no_host_sync(f"K4 {tag}", lambda: da.decode_attention_chunk_kernel(q, k, v, vf, vt,
                                                                          ksc, vsc))
        kd = kv_dequant(k, ksc, bf) if ksc is not None else k
        vd = kv_dequant(v, vsc, bf) if vsc is not None else v
        kc, vc = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        mask = _k4_windows(vf, vt, nq, S)[:, None]  # [B, 1, Q, S]
        q4 = q.transpose(1, 2).contiguous()
        times = timings(
            lambda: da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc),
            lambda: decode_attention_chunk(q, k, v, vf.long(), vt.long(), full, ksc, vsc),
            lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True),
            iters=10,
        )
        kv_bytes = d + 2 if k.dtype == torch.int8 else 2 * d
        bound_ms, bound_by = _k4_bound(np.zeros(b, np.int32), L, nq, S, n_q, n_kv, d, 2,
                                       kv_bytes=kv_bytes)
        log(f"[kernel] K4 {tag} B={b} Q={nq} S={S}: row_err={rel:.3e} (tolerance "
            f"{FLASH_ROW_TOL['bf16']:.3e})"
            + (f", against the split reference {rel_m:.3e} beyond the output's rounding "
               f"(tolerance {MODEL_TOL:g})" if rel_m is not None else "")
            + f" max_abs_err={err:.3e}; kernel_ms="
            f"{times['kernel_ms']:.4f} plain_ms={times['plain_ms']:.4f} library_ms="
            f"{times['library_ms']:.4f} (device, graph replays); eager calls kernel="
            f"{times['kernel_eager_ms']:.4f} plain={times['plain_eager_ms']:.4f} library="
            f"{times['library_eager_ms']:.4f}; bound_ms={bound_ms:.5f} ({bound_by})")
        out[tag] = dict(row_err=rel, max_abs_err=err, model_err=rel_m, bound_ms=bound_ms,
                        bound_by=bound_by, **times)
    report["k4"].update(out)


# --------------------------------------------------------------------------
# Phase: flash attention forward and backward against the plain version
# --------------------------------------------------------------------------


def _packed_rows(rng, b, s, lo=64, hi=640):
    """Segment ids [b, s]: rows 0..b-2 filled with segments of lo..hi
    tokens (a row's tail that cannot take a segment of lo stays padding),
    row b-1 all padding.  Returns (seg, per-segment lengths)."""
    import numpy as np

    seg = np.zeros((b, s), np.int32)
    lens = []
    for r in range(b - 1):
        off, sid = 0, 1
        while s - off >= lo:
            n = min(int(rng.integers(lo, hi + 1)), s - off)
            seg[r, off : off + n] = sid
            lens.append(n)
            off += n
            sid += 1
    return seg, lens


def _flash_bounds(lens, b, s, hq, hkv, d, elem):
    """Least times for K1f, K1dq, K1dkv at these segment lengths: the
    causal-within-segment flops (fwd 4d, dq 6d, dkv 8d per attended pair
    and q head) at the bf16 tensor rate, against every input read once
    and every output written once at the HBM rate."""
    pairs = sum(n * (n + 1) // 2 for n in lens)
    q_b = b * s * hq * d * elem
    kv_b = b * s * hkv * d * elem
    row_b = b * s * hq * 4  # lse or delta
    seg_b = b * s * 4
    work = {
        "fwd": (4 * d * hq * pairs, q_b + 2 * kv_b + seg_b + q_b + row_b),
        "dq": (6 * d * hq * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + seg_b + q_b),
        "dkv": (8 * d * hq * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + seg_b + 2 * kv_b),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes")
    return out


# Tolerances of the flash kernels against their plain versions, per
# output row (one position's head vector, D values) and relative to that
# row's largest |plain| value: fp32 differs by summation order only; a
# bf16 output is rounded once, to within half an ulp (2**-8 of each
# element's magnitude).  The bf16 bound is twice that rounding.
FLASH_ROW_TOL = {"fp32": 1e-4, "bf16": 2**-7}


def _row_err(got, want):
    """(largest error of a row relative to that row's largest |want|,
    largest absolute error).  A row smaller than the output's RMS (over
    its non-zero rows) takes the RMS instead: a row that is 0 in exact
    arithmetic, such as dq at a segment's first position (ds = P(dP - Δ)
    cancels there), carries only the rounding of its larger terms."""
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs().amax(-1)
    mag = w.abs().amax(-1)
    live = w[mag > 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 1.0
    return float((err / mag.clamp_min(rms)).max()), float(err.max())


# The split kernels' bf16-q int8 forms against their model
# (`split_window_attention`, fp32): the kernel's result before its one
# rounding to bf16 within MODEL_TOL of the row's magnitude.
MODEL_TOL = 1e-3


def _model_err(got, model):
    """Largest row error of a bf16 kernel output against its fp32 model
    beyond the output's rounding: each element's |got - model| less half
    a bf16 ulp of the larger of the two magnitudes, over the row's
    largest |model| (rows under the output's RMS take the RMS, as in
    _row_err)."""
    import torch

    g, w = got.detach().float(), model.detach().float()
    _, exp = torch.frexp(torch.maximum(g.abs(), w.abs()))
    half_ulp = torch.ldexp(torch.ones_like(w), exp - 9)  # bf16: 8 significant bits
    err = ((g - w).abs() - half_ulp).clamp_min(0).amax(-1)
    mag = w.abs().amax(-1)
    live = w[mag > 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 1.0
    return float((err / mag.clamp_min(rms)).max())


def _hold_flash(tag, q, k, v, seg, do, row_tol):
    """K1f, then K1dq and K1dkv through autograd, on (q, k, v, seg) with
    upstream gradient `do`.  Each kernel is held against its plain version
    on fp32 copies of the same (already rounded) inputs: o against
    `packed_attention_reference`, dq/dk/dv against `flash_bwd_reference`
    given the same Δ = rowsum(o∘dO) of the kernel's o.  Each output must
    lie within `row_tol` per row (see _row_err), be finite, and be exactly
    0 at padding.  In fp32 the gradients are also held against autograd
    through the plain forward; in bf16 that reading differs by design (Δ
    of the bf16 o, as the JAX kernel's `_bwd` has it) and is only printed.
    Returns {output: (row_err, max_abs_err)}."""
    import torch

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import packed_attention_reference

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention(q, k, v, seg)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    qr, kr, vr = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    o_ref = packed_attention_reference(qr, kr, vr, seg)
    plain_bwd = fa.flash_bwd_reference(qr, kr, vr, seg, do, fa.flash_delta(o, do))
    autograd = torch.autograd.grad(o_ref, (qr, kr, vr), do.float())
    torch.cuda.synchronize()
    pad = seg == 0
    out = {}
    for name, got, want, auto in (
        ("o", o, o_ref, None),
        ("dq", dq, plain_bwd[0], autograd[0]),
        ("dk", dk, plain_bwd[1], autograd[1]),
        ("dv", dv, plain_bwd[2], autograd[2]),
    ):
        check(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite")
        rel, err = _row_err(got, want)
        out[name] = (rel, err)
        line = (f"[flash] {tag} {name}: row_err={rel:.3e} (tolerance {row_tol:.3e}) "
                f"max_abs_err={err:.3e}")
        if auto is not None:
            auto_rel, auto_err = _row_err(got, auto)
            line += f"; against autograd: row_err={auto_rel:.3e} max_abs_err={auto_err:.3e}"
            if q.dtype == torch.float32:
                check(auto_rel <= row_tol, f"{tag} {name} disagrees with autograd")
        log(line)
        check(rel <= row_tol, f"{tag} {name} disagrees with the plain version")
        check(float(got.detach().float()[pad].abs().max()) == 0.0,
              f"{tag} {name}: padding positions are not exactly 0")
    return out


# lse is fp32 in every kernel and in its plain version (the dense
# logsumexp of the same rounded inputs): they differ by summation order.
# Tolerance on |got - want| / max(1, |want|), over rows that attend.
FLASH_LSE_TOL = 1e-4


def _dense_lse(q, k, seg, causal):
    """logsumexp of each row's masked fp32 logits, [B, S, Hq]."""
    import torch

    from areal_tpu_torch.ops.attention import make_packed_mask, repeat_kv

    logits = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), repeat_kv(k.float(), q.shape[2] // k.shape[2])
    ) * q.shape[-1] ** -0.5
    mask = make_packed_mask(seg, causal=causal)
    return torch.logsumexp(torch.where(mask, logits, -math.inf), -1).transpose(1, 2)


def _lse_err(got, want, seg):
    real = (seg > 0)[..., None].expand_as(want)
    diff = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1.0)
    return float(diff[real].max())


def _flash_edges(seed):
    """K1f, K1dq and K1dkv at their edges: three rows of S=256 packed with
    segments of 1, 63, 64 and 65 positions then padding; 127 and 129; 128
    then padding; rep 6 (Hq=12, Hkv=2) and rep 1 (Hq=Hkv=2), causal and
    not, at D=128; one row of S=40 (segments of 1, 23 and 9 then padding:
    a tail shorter than a tile), rep 2 (Hq=4, Hkv=2), causal and not; and
    the S=256 rows at D=64, rep 6, causal; each in fp32 and bf16 (the
    bf16 forward runs 3, 2 or 1 q heads a block for rep 6, 2 and 1).  o,
    lse, then dq and dk, dv given that lse and Δ of that o: each row within
    FLASH_ROW_TOL of its plain version (packed_attention_reference,
    flash_bwd_reference) and, in bf16, of the kernels' models
    (flash_fwd_bf16_reference, flash_dq_bf16_reference,
    flash_dkv_bf16_reference); lse within FLASH_LSE_TOL of the dense
    logsumexp (and of the model's in bf16); padding rows exactly 0, and
    lse -1e30 there.  Returns the largest row errors."""
    import numpy as np
    import torch

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import packed_attention_reference

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)

    def rows(s, layouts):
        seg_np = np.zeros((len(layouts), s), np.int32)
        for r, lens in enumerate(layouts):
            off = 0
            for sid, n in enumerate(lens, 1):
                seg_np[r, off : off + n] = sid
                off += n
        return torch.from_numpy(seg_np).to(dev)

    seg256 = rows(256, ((1, 63, 64, 65), (127, 129), (128,)))
    seg40 = rows(40, ((1, 23, 9),))
    cases = [(seg256, hq, hkv, 128, causal) for hq, hkv in ((12, 2), (2, 2))
             for causal in (True, False)]
    cases += [(seg40, 4, 2, 128, causal) for causal in (True, False)]
    cases += [(seg256, 12, 2, 64, True)]
    worst = {}
    for seg, hq, hkv, d, causal in cases:
        b, s = seg.shape
        pad = seg == 0
        base = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                .to(dev) for h in (hq, hkv, hkv, hq)]
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, do = (x.to(dtype) for x in base)
            o, lse = fa.flash_fwd(q, k, v, seg, causal)
            delta = fa.flash_delta(o, do)
            dq = fa.flash_dq(q, k, v, seg, do, lse, delta, causal)
            dk, dv = fa.flash_dkv(q, k, v, seg, do, lse, delta, causal)
            got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
            rq, rk, rv = fa.flash_bwd_reference(q, k, v, seg, do, delta, causal)
            held = [("plain", {
                "o": packed_attention_reference(q.float(), k.float(), v.float(), seg,
                                                causal=causal),
                "dq": rq, "dk": rk, "dv": rv}, _dense_lse(q, k, seg, causal))]
            if dtype == torch.bfloat16:
                mo, mlse = fa.flash_fwd_bf16_reference(q, k, v, seg, causal)
                mk, mv = fa.flash_dkv_bf16_reference(q, k, v, seg, do, lse, delta, causal)
                held.append(("bf16 model", {
                    "o": mo, "dq": fa.flash_dq_bf16_reference(q, k, v, seg, do, lse, delta,
                                                              causal),
                    "dk": mk, "dv": mv}, mlse))
            torch.cuda.synchronize()
            name = f"S={s} D={d} rep{hq // hkv} {'causal' if causal else 'full'} {tag}"
            parts = []
            for ref_name, want, want_lse in held:
                suffix = "_model" if ref_name != "plain" else ""
                for out, g in got.items():
                    rel, _ = _row_err(g, want[out])
                    key = f"{tag}_{out}{suffix}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    parts.append(f"{out} {rel:.3e}")
                    check(rel <= FLASH_ROW_TOL[tag],
                          f"K1 edges {name}: {out} disagrees with the {ref_name}: {rel:.3e}")
                lerr = _lse_err(lse, want_lse, seg)
                worst[f"{tag}_lse{suffix}"] = max(worst.get(f"{tag}_lse{suffix}", 0.0), lerr)
                parts.append(f"lse {lerr:.3e}")
                check(lerr <= FLASH_LSE_TOL,
                      f"K1 edges {name}: lse disagrees with the {ref_name}: {lerr:.3e}")
            for out, g in got.items():
                check(bool(torch.isfinite(g).all()), f"K1 edges {name}: {out} non-finite")
                check(float(g.float()[pad].abs().max()) == 0.0,
                      f"K1 edges {name}: {out} at padding is not exactly 0")
            check(bool((lse[pad] == fa.KERNEL_NEG).all()),
                  f"K1 edges {name}: lse at padding is not -1e30")
            log(f"[flash] K1 edges {name}: row_err against "
                + ", ".join(r[0] for r in held) + ": " + ", ".join(parts)
                + f" (tolerance {FLASH_ROW_TOL[tag]:.3e}, lse {FLASH_LSE_TOL:g}); "
                "padding exactly 0")
    return worst


def phase_flash(report, seed):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import make_packed_mask, packed_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    b, s, hq, hkv, d = 4, 2048, 12, 2, 128
    seg_np, lens = _packed_rows(rng, b, s)
    seg = torch.from_numpy(seg_np).to(dev)
    base = {
        name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        for name, shape in (
            ("q", (b, s, hq, d)), ("k", (b, s, hkv, d)), ("v", (b, s, hkv, d)),
            ("do", (b, s, hq, d)),
        )
    }
    errs = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (base[n].to(dtype) for n in ("q", "k", "v", "do"))
        fa.reset_launches()
        held = _hold_flash(tag, q, k, v, seg, do, FLASH_ROW_TOL[tag])
        check(fa.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1},
              f"{tag}: launches {fa.LAUNCHES}")
        for name, (rel, err) in held.items():
            errs[f"{tag}_{name}"] = err
            errs[f"{tag}_{name}_row"] = rel
    errs.update({f"edges_{key}": val for key, val in _flash_edges(seed).items()})

    # The main path's dtype (bf16): the tensor-core kernels against their
    # models, the sync checks, then the times.
    q, k, v, do = (base[n].to(torch.bfloat16) for n in ("q", "k", "v", "do"))
    seg32 = seg.to(torch.int32).contiguous()
    o, lse = fa.flash_fwd(q, k, v, seg32, True)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, seg32, do, lse, delta, True)
    dk, dv = fa.flash_dkv(q, k, v, seg32, do, lse, delta, True)
    mo, mlse = fa.flash_fwd_bf16_reference(q, k, v, seg)
    lerr = _lse_err(lse, mlse, seg)
    errs["bf16_lse_model"] = lerr
    log(f"[flash] bf16 lse against the kernel's model (flash_fwd_bf16_reference): "
        f"err={lerr:.3e} (tolerance {FLASH_LSE_TOL:g})")
    check(lerr <= FLASH_LSE_TOL, "bf16 lse disagrees with the kernel's model")
    models = {
        "flash_fwd_bf16_reference": lambda: {"o": mo},
        "flash_dq_bf16_reference": lambda: {
            "dq": fa.flash_dq_bf16_reference(q, k, v, seg, do, lse, delta)},
        "flash_dkv_bf16_reference": lambda: dict(zip(
            ("dk", "dv"), fa.flash_dkv_bf16_reference(q, k, v, seg, do, lse, delta))),
    }
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    for model, outputs in models.items():
        for name, want in outputs().items():
            rel, _ = _row_err(got[name], want)
            errs[f"bf16_{name}_model_row"] = rel
            log(f"[flash] bf16 {name} against the kernel's model ({model}): "
                f"row_err={rel:.3e} (tolerance {FLASH_ROW_TOL['bf16']:.3e})")
            check(rel <= FLASH_ROW_TOL["bf16"],
                  f"bf16 {name} disagrees with the kernel's model")
    del got, dq, dk, dv, mo, mlse
    kernels = {
        "fwd": lambda: fa.flash_fwd(q, k, v, seg32, True),
        "dq": lambda: fa.flash_dq(q, k, v, seg32, do, lse, delta, True),
        "dkv": lambda: fa.flash_dkv(q, k, v, seg32, do, lse, delta, True),
    }
    for name, fn in kernels.items():
        no_host_sync(f"K1{name}", fn)
    # Plain versions: packed_attention_reference (fwd) and
    # flash_bwd_reference (dq, dk and dv together, given Δ).  Library
    # yardstick: SDPA with the packed boolean mask (GQA native); its
    # backward (dq, dk and dv together) is the graph of forward+backward
    # less the forward's.
    mask = make_packed_mask(seg)
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    def plain_bwd():
        return fa.flash_bwd_reference(q, k, v, seg, do, delta)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)

    times = {
        "fwd": timings(kernels["fwd"], lambda: packed_attention_reference(q, k, v, seg),
                       sdpa, iters=10),
        "dq": timings(kernels["dq"], plain_bwd, sdpa_fwd_bwd, iters=10),
        "dkv": timings(kernels["dkv"], plain_bwd, sdpa_fwd_bwd, iters=10),
    }
    for name in ("dq", "dkv"):
        for key in ("library_ms", "library_eager_ms"):
            times[name][key] -= times["fwd"][key]
    bounds = _flash_bounds(lens, b, s, hq, hkv, d, 2)
    for name in ("fwd", "dq", "dkv"):
        t = times[name]
        log(f"[flash] bf16 {name}: kernel_ms={t['kernel_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} (device, graph replays); eager calls "
            f"kernel={t['kernel_eager_ms']:.4f} plain={t['plain_eager_ms']:.4f} "
            f"library={t['library_eager_ms']:.4f}; bound_ms={bounds[name][0]:.5f} "
            f"({bounds[name][1]})")
    log(f"[flash] (plain dq/dkv = flash_bwd_reference, dq+dk+dv; library fwd = SDPA, "
        f"library dq/dkv = SDPA's backward, dq+dk+dv); {len(lens)} segments, "
        f"{sum(lens)} real of {b * s} positions")
    report["flash"] = dict(
        max_abs_err=errs, times=times, bounds=bounds,
        segments=len(lens), real_tokens=sum(lens),
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
    # By the JAX package's rule a burst whose max_new_tokens exceeds
    # static_path_max_new takes the serving plane: at 0 every call does.
    engine.static_path_max_new = 0
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
    out["profile"] = _profile_generate(engine, cfg, rng, "ragged_paged_attention")
    report["serve"] = out
    # The recording wrapper closes a reference cycle through the engine:
    # drop it and collect now, or the weights stay allocated through the
    # later phases (and in their peak-memory readings).
    del engine.generate
    del engine, params, server
    gc.collect()
    torch.cuda.empty_cache()


def _profile_generate(engine, cfg, rng, attention):
    """Device time by kernel over one smaller generate call (4 prompts of
    128 tokens x n=4, 32 new tokens) under torch.profiler: the card's
    idle share of that call's wall time and the share of busy time of
    the kernels whose name holds `attention`."""
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
    steps0, decode0 = engine.steps_total, engine.static_decode_steps
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
    attn_s = sum(k[0] for k in kernels if attention in k[2]) / 1e6
    top = [
        dict(name=name[:90], ms=us / 1e3, calls=n, share=us / 1e6 / max(busy_s, 1e-12))
        for us, n, name in kernels[:8]
    ]
    steps = engine.steps_total - steps0
    decode = engine.static_decode_steps - decode0
    share = attn_s / max(busy_s, 1e-12)
    log(f"[profile] 1 generate call, {steps} serving inner steps, {decode} static decode "
        f"steps: wall {wall:.3f} s, device busy {busy_s:.3f} s, idle share "
        f"{1 - busy_s / wall:.3f}, {attention} share of busy {share:.3f} (profiler on)")
    for k in top:
        log(f"[profile]   {k['share']:.3f} {k['ms']:10.2f} ms {k['calls']:7d}x {k['name']}")
    return dict(wall_s=wall, busy_s=busy_s, idle_share=1 - busy_s / wall,
                inner_steps=steps, static_decode_steps=decode,
                attention_share=share, top_kernels=top)


# --------------------------------------------------------------------------
# Phase: the static generate path at full size
# --------------------------------------------------------------------------


def _timed(module, name, times):
    """Wrap module.name so each call records a pair of CUDA events into
    times (no synchronisation); returns the original for restoring."""
    import torch

    real = getattr(module, name)

    def run(*a, **k):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(*a, **k)
        t1.record()
        times.append((t0, t1))
        return out

    setattr(module, name, run)
    return real


def phase_static(report, seed):
    """The serve phase's burst (16 requests x n=4, prompts 64-512, 128 new
    tokens, the same prompts) through GenerationServer over a DEFAULT
    engine at full qwen2-1.5B: 64 requests fit max_decode_batch and 128
    new tokens fit static_path_max_new, so the call takes the static
    path — one prefill (K1f) and one decode_step (K4) per token.  The
    launch counts are set to 0 just before the burst and read just
    after it."""
    import numpy as np
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = qwen2_config("1.5b")
    n_req, n, max_new = 16, 4, 128
    engine = GeneratorEngine(cfg, init_params(cfg, seed, device="cuda"), eos_token_id=151643)
    check(engine.device.type == "cuda", "the engine is not on the card")
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(n_req)
    ]
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    pre_t, dec_t = [], []
    real_pre = _timed(tfm, "prefill", pre_t)
    real_dec = _timed(tfm, "decode_step", dec_t)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        da.LAUNCHES = rpa.LAUNCHES = 0
        chunks0, steps0 = engine.static_chunks, engine.static_decode_steps
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed + 15)
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k1 = dict(fa.LAUNCHES)
        k4, k2 = da.LAUNCHES, rpa.LAUNCHES
        chunks = engine.static_chunks - chunks0
        steps = engine.static_decode_steps - steps0
        peak = torch.cuda.max_memory_allocated()
    finally:
        tfm.prefill, tfm.decode_step = real_pre, real_dec
        server.close()
    prefill_s = sum(a.elapsed_time(b) for a, b in pre_t) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in dec_t) / 1e3
    check(not errors and all(r is not None for r in replies), f"requests failed: {errors}")
    n_tok = 0
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        check(r["version"] == r["version_start"] == 0, f"q{i}: version {r['version']}")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"q{i}: {len(ids)} tokens")
            check(len(ids) == max_new or ids[-1] == 151643, f"q{i}: short without EOS")
            check(len(lps) == len(ids), f"q{i}: logprobs/ids length mismatch")
            check(all(math.isfinite(x) and x <= 0 for x in lps), f"q{i}: bad logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"q{i}: id out of vocab")
            n_tok += len(ids)
    log(f"[static] {n_req} requests x n={n}: {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tok/s; {chunks} static chunk(s), {steps} decode steps; "
        f"prefill {prefill_s:.3f} s, decode {decode_s:.3f} s = "
        f"{1e3 * decode_s / max(steps, 1):.3f} ms a step (CUDA events around each call); "
        f"launches K1f {k1['fwd']} (dq {k1['dq']}, dkv {k1['dkv']}), K4 {k4}, K2 {k2}; "
        f"peak mem {peak / 2**30:.2f} GiB")
    check(chunks >= 1 and steps >= 1, "the burst did not take the static path")
    check(k1 == {"fwd": cfg.n_layers * chunks, "dq": 0, "dkv": 0},
          f"K1 launches {k1} != {cfg.n_layers} x {chunks} static chunks")
    check(k4 == cfg.n_layers * steps, f"K4 launches {k4} != {cfg.n_layers} x {steps}")
    check(k2 == 0, f"the static path launched K2 {k2} times")
    out = dict(
        requests=n_req, n=n, max_new_tokens=max_new, tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, static_chunks=chunks, decode_steps=steps,
        prefill_s=prefill_s, decode_s=decode_s, decode_step_ms=1e3 * decode_s / max(steps, 1),
        launches=k4, k1f_launches=k1["fwd"], peak_mem_bytes=peak,
    )
    out["profile"] = _profile_generate(engine, cfg, rng, "decode_attention")
    report["static"] = out
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase: the in-memory weight push mid-generation, at full size
# --------------------------------------------------------------------------


def _burst(url, prompts, n, max_new, seed, timeout=900.0, **options):
    """POST every prompt at once (one batched engine call: same gconfig
    and seed), with request `options` (greedy, spec_decode_k, ...) beside
    the sampling defaults; returns (threads, replies, errors)."""
    start = threading.Barrier(len(prompts))
    replies, errors = [None] * len(prompts), []

    def client(i):
        start.wait(timeout=60.0)
        try:
            replies[i] = _post(url + "/generate", dict(
                dict(qid=f"q{i}", prompt_ids=prompts[i], n=n, max_new_tokens=max_new,
                     temperature=1.0, seed=seed), **options,
            ))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"q{i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    return threads, replies, errors


def phase_push(report, seed):
    """GenerationServer at full qwen2-1.5B (28 layers, bf16) serving 16
    GRPO requests (n=4, prompts 64-512, 128 new tokens, one seed) while
    `update_weights_inmem` pushes init_params(seed + 1) with its checksum
    once live rows have run past their first chunk.  The running call
    parks, the weights are swapped, each live row's last chunk is replayed
    through K3, and the call finishes on its existing pages.  The same
    burst under the old weights, uninterrupted, is the reference.  Then a
    push with a wrong checksum is refused and version 1 keeps serving.
    Then the same over an int8 page pool (`kv_cache_dtype="int8"`: K2
    and K3 over int8 codes and bf16 scales) with the first 8 requests."""
    report["push"] = _push_run("push", seed, 16)
    report["push_int8"] = _push_run("push_int8", seed, 8, kv_cache_dtype="int8")


def _push_run(tag, seed, n_req, **engine_kw):
    """One run of phase_push with the burst's first `n_req` requests and
    GeneratorEngine options `engine_kw`; returns its numbers."""
    import numpy as np
    import torch

    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = qwen2_config("1.5b")
    n, max_new = 4, 128
    engine = GeneratorEngine(cfg, init_params(cfg, seed, device="cuda"), eos_token_id=151643,
                             **engine_kw)
    check(engine.device.type == "cuda", "the engine is not on the card")
    engine.static_path_max_new = 0  # the serving plane, which can park
    chunk_t = min(32, max_new)
    rng = np.random.default_rng(seed + 13)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(16)
    ][:n_req]
    # Time the swap and each replay (host clock, synchronized).
    timing = {"swap_s": [], "replay_s": []}
    real_set, real_replay = engine.set_params, engine._get_paged_replay_fn

    def timed_set(params):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        real_set(params)
        torch.cuda.synchronize()
        timing["swap_s"].append(time.monotonic() - t0)

    def timed_replay():
        fn = real_replay()

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn(*a)
            torch.cuda.synchronize()
            timing["replay_s"].append(time.monotonic() - t0)

        return run

    # Neither runs before the push: the reference burst is not affected.
    engine.set_params, engine._get_paged_replay_fn = timed_set, timed_replay
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        t0 = time.monotonic()
        threads, ref, errors = _burst(server.url, prompts, n, max_new, seed + 14)
        for th in threads:
            th.join(timeout=900.0)
        ref_s = time.monotonic() - t0
        check(not errors and all(r is not None for r in ref), f"{tag}: reference burst: {errors}")
        check(all(r["version"] == r["version_start"] == 0 for r in ref),
              f"{tag}: the reference burst did not run on version 0")
        new = init_params(cfg, seed + 1, device="cuda")
        checksum = integrity.params_checksum(new)
        pca.LAUNCHES = rpa.LAUNCHES = 0
        replays0, steps0 = engine.resume_replays, engine.steps_total
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed + 14)
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            live = json.loads(urllib.request.urlopen(server.url + "/health").read())["live_slots"]
            if live > 0 and engine.steps_total - steps0 >= 2 * chunk_t:
                break
            time.sleep(0.01)
        steps_at_push = engine.steps_total - steps0
        check(steps_at_push >= 2 * chunk_t, f"{tag}: generation never ran two chunks")
        t_push = time.monotonic()
        version = server.update_weights_inmem(new, checksum=checksum)
        push_s = time.monotonic() - t_push
        del new
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k3, k2 = pca.LAUNCHES, rpa.LAUNCHES
        replays = engine.resume_replays - replays0
        steps = engine.steps_total - steps0
        check(not errors and all(r is not None for r in replies), f"{tag}: push burst: {errors}")
        health = json.loads(urllib.request.urlopen(server.url + "/health").read())
        # A push with a corrupted checksum is refused; version 1 serves on.
        bad = checksum.copy()
        bad[2] *= 1.01
        try:
            server.update_weights_inmem(init_params(cfg, seed + 2, device="cuda"), checksum=bad)
            refused = False
        except integrity.WeightChecksumError:
            refused = True
        after = _post(server.url + "/generate", dict(
            qid="after", prompt_ids=prompts[0][:64], n=1, max_new_tokens=8, greedy=True,
        ))
    finally:
        del engine.set_params, engine._get_paged_replay_fn  # the timing wrappers
        server.close()
    check(version == 1, f"{tag}: the push returned version {version}")
    n_tok = n_spanned = n_changed = 0
    for i, (r, r0) in enumerate(zip(replies, ref)):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(len(ids) == max_new or (ids and ids[-1] == 151643),
                  f"q{i}: {len(ids)} tokens and no EOS")
            check(len(lps) == len(ids) and all(math.isfinite(x) for x in lps),
                  f"q{i}: logprobs malformed")
            n_tok += len(ids)
        if r["version_start"] == 0 and r["version"] == 1:
            n_spanned += 1
            n_changed += r["output_ids"] != r0["output_ids"]
    log(f"[{tag}] {engine_kw or ''} reference burst (old weights, uninterrupted) {ref_s:.2f} s; "
        f"push burst {wall:.2f} s, {n_tok} tokens; push after {steps_at_push} inner steps took "
        f"{push_s:.3f} s (swap {sum(timing['swap_s']):.3f} s, replays "
        f"{[round(x, 4) for x in timing['replay_s']]} s); resume_replays={replays}, "
        f"K3 launches={k3} ({cfg.n_layers} x {replays}), K2 launches={k2} "
        f"({cfg.n_layers} x {steps} inner steps); spanned requests {n_spanned}/{n_req}, "
        f"of which {n_changed} differ from the old-weights run; health after: "
        f"paused={health['paused']} version={health['version']}; bad-checksum push "
        f"refused={refused}, then version {after['version']}")
    check(n_spanned >= 1, f"{tag}: no request spanned the push (version_start 0, version 1)")
    check(n_changed >= 1, f"{tag}: no spanned request changed under the new weights")
    check(not health["paused"] and health["version"] == 1, f"{tag}: health after the push {health}")
    check(replays >= 1, f"{tag}: the push replayed nothing")
    check(k3 == cfg.n_layers * replays, f"{tag}: K3 launches {k3} != {cfg.n_layers} x {replays}")
    check(k2 == cfg.n_layers * steps, f"{tag}: K2 launches {k2} != {cfg.n_layers} x {steps}")
    check(refused, f"{tag}: a push with a wrong checksum was not refused")
    check(after["version"] == after["version_start"] == 1 and len(after["output_ids"][0]) == 8,
          f"{tag}: after the refused push: {after['version']}, {after['version_start']}")
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        launches=k3, k2_launches=k2, resume_replays=replays, push_s=push_s,
        swap_s=timing["swap_s"], replay_s=timing["replay_s"], wall_s=wall,
        reference_s=ref_s, tokens=n_tok, steps_at_push=steps_at_push,
        inner_steps=steps, spanned=n_spanned, changed=n_changed,
    )


# --------------------------------------------------------------------------
# Phase: resume under unchanged weights, at full size
# --------------------------------------------------------------------------

# The bf16 bound of resume_parity: each replayed row's logits before the
# replay (K2's forward in the serving chunk) against after it (K3's
# recompute of the same position), relative to the row's largest |logit|.
# Two bf16 paths through one model (other GEMM shapes, so other
# roundings of the same K/V): the first reading on the H100 was 1.56e-2;
# the bound is under 3x that.  fp32 read 1.9e-6 against its 1e-4.
RESUME_BF16_TOL = 4.5e-2
# The same bound over an int8 page pool (bf16 compute): before the
# replay K2 reads int8 codes, after it K3 does.  Everything of the bf16
# case holds, and the replay re-quantizes the tail it recomputes: a K/V
# element that the other GEMM shapes move by a bf16 ulp (~2^-9 of it)
# crosses a code boundary with probability ~|dx| / s (s = amax / 127,
# about 3 |x| / 127) and then moves by a whole step s, so the tail's
# K/V perturbation grows from E[dx^2] to about E|dx| * s: ~12x in
# variance, ~3.5x in RMS.  3.5 x the bf16 reading (1.56e-2) is 5.5e-2;
# the first bound, 1e-1, was under 2x that, written before the first
# int8 reading.  That reading on the H100 was 1.71e-2 (bf16 1.545e-2 in
# the same run): 1.1x bf16, not 3.5x, so the flips of codes move the
# logits far less than the estimate (most flipped elements meet small
# probabilities).  The bound is now the bf16 bound's margin, under 3x
# the reading.
RESUME_INT8_TOL = 5e-2


def _resume_parity_run(cfg, params, dtype, sample, g, **engine_kw):
    """One uninterrupted greedy generate and one parked at the second
    serving chunk, then resumed under unchanged weights, on a
    GeneratorEngine with options `engine_kw`.  Returns (the
    uninterrupted output, the resumed output, logits_buf before and
    after the replay, the replayed rows, what the park found)."""
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.engines.generator import GeneratorEngine

    eng = GeneratorEngine(cfg, params, compute_dtype=dtype, eos_token_id=151643, **engine_kw)
    eng.static_path_max_new = 0  # the serving plane, which can park
    ref = eng.generate(sample, MicroBatchSpec(), g, seed=0)
    real_get, real_replay = eng._get_serving_chunk_fn, eng._get_paged_replay_fn
    calls, cap = {"n": 0}, {}

    def hooked(*a, **kw):
        fn = real_get(*a, **kw)

        def wrapped(*fa, **fkw):
            calls["n"] += 1
            if calls["n"] == 2:
                eng.interrupt()
            return fn(*fa, **fkw)

        return wrapped

    def captured():
        fn = real_replay()

        def run(*a):
            cap["before"] = a[6].clone()
            fn(*a)
            cap["after"] = a[6].clone()
            cap["live"] = a[8].clone()

        return run

    eng._get_serving_chunk_fn, eng._get_paged_replay_fn = hooked, captured
    check(eng.generate(sample, MicroBatchSpec(), g, seed=0) is None,
          "the interrupted generate did not park")
    st = eng._session
    live = [s for s in range(st.n_slots) if st.active[s] is not None]
    park = dict(
        decoding=sum(int(st.prefill_rem[s] == 0) for s in live),
        prefilling=sum(int(st.prefill_rem[s] > 0) for s in live),
        followers=sum(int(st.shared_from[s] > 0 and st.alloc.is_shared(s, 0)) for s in live),
    )
    eng.clear_interrupt()
    out = eng.resume_generate()
    torch.cuda.synchronize()
    check(out is not None and eng.resume_replays == 1, "the resume did not finish")
    del eng
    return ref, out, cap["before"], cap["after"], cap["live"], park


def _log_first_flip(ref, res):
    """Print, for each sequence whose greedy tokens differ, the first
    differing position, both tokens and the logit gap there: the two
    chosen tokens' logprobs in their own runs, whose histories agree up
    to that position."""
    oa = ob = lpa = lpb = 0  # token and logprob offsets of each run
    for ln_a, ln_b in zip(ref.seqlens["packed_input_ids"], res.seqlens["packed_input_ids"]):
        for la, lb in zip(ln_a, ln_b):
            a = ref.data["packed_input_ids"][oa : oa + la]
            b = res.data["packed_input_ids"][ob : ob + lb]
            m = min(la, lb)
            diff = (a[:m] != b[:m]).nonzero()[0]
            if len(diff):
                j = int(diff[0])  # token j's logprob is entry j - 1
                ga = float(ref.data["packed_logprobs"][lpa + j - 1])
                gb = float(res.data["packed_logprobs"][lpb + j - 1])
                log(f"[resume_parity] token {j} of a sequence: {int(a[j])} (logprob "
                    f"{ga:.6f}) vs {int(b[j])} (logprob {gb:.6f}); gap {ga - gb:.3e}")
            oa, ob, lpa, lpb = oa + la, ob + lb, lpa + la - 1, lpb + lb - 1


def phase_resume_parity(report, seed):
    """Park at the second serving chunk and resume under UNCHANGED weights
    at full qwen2-1.5B (28 layers), with rows decoding, a row mid-prefill
    and a same-prompt follower mapping its owner's prompt pages.  Each
    replayed row's logits after the replay (K3) are held against the
    ones before it (K2, the uninterrupted run's next-token logits):
    relative 1e-4 in fp32, RESUME_BF16_TOL in bf16 and RESUME_INT8_TOL in
    bf16 over an int8 page pool; in fp32 the greedy tokens equal the
    uninterrupted run's."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 17)
    cfg = qwen2_config("1.5b", param_dtype="float32")
    # A 560-token prompt is still prefilling after two chunks (8 prompt
    # tokens a row per inner step); the 200-token prompt appears twice, so
    # its second copy maps the first's full prompt page once that one
    # has finished its prefill (the prefix cache of a GRPO group).
    lens = (560, 200, 200, 40)
    toks = [rng.integers(0, cfg.vocab_size, l) for l in lens[:2]]
    toks = [toks[0], toks[1], toks[1].copy(), rng.integers(0, cfg.vocab_size, lens[3])]
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": np.concatenate(toks).astype(np.int32)},
    )
    g = GenerationHyperparameters(n=1, max_new_tokens=48, greedy=True)
    params = init_params(cfg, seed + 3, device="cuda")
    out = {}
    runs = ((torch.float32, "fp32", {}), (torch.bfloat16, "bf16", {}),
            (torch.bfloat16, "bf16_int8", {"kv_cache_dtype": "int8"}))
    for dtype, tag, ekw in runs:
        ref, res, before, after, live, park = _resume_parity_run(
            cfg, params, dtype, sample, g, **ekw)
        gc.collect()  # the run's engine and its hooks
        torch.cuda.empty_cache()
        rows = live.nonzero()[:, 0]
        diff = (after[rows] - before[rows]).abs().amax(-1)
        rel = float((diff / before[rows].abs().amax(-1)).max())
        same = (ref.seqlens["packed_input_ids"] == res.seqlens["packed_input_ids"]
                and np.array_equal(ref.data["packed_input_ids"], res.data["packed_input_ids"]))
        log(f"[resume_parity] {tag}: park found {park}; {len(rows)} rows replayed; "
            f"logits after/before the replay: relative {rel:.3e}; greedy tokens "
            f"identical to the uninterrupted run: {same}")
        check(park["decoding"] > 0 and park["prefilling"] > 0 and park["followers"] > 0,
              f"{tag}: the park did not find decoding, prefilling and follower rows")
        out[tag] = dict(logits_rel=rel, tokens_identical=same, park=park, rows=len(rows))
        if tag == "fp32":
            check(rel <= 1e-4, f"fp32 replay logits differ by {rel:.3e} relative")
            if not same:
                _log_first_flip(ref, res)
            check(same, "fp32 greedy tokens after the resume differ from the uninterrupted run")
        else:
            tol = RESUME_INT8_TOL if ekw else RESUME_BF16_TOL
            check(rel <= tol, f"{tag} replay logits differ by {rel:.3e} > {tol}")
    report["resume_parity"] = out
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 4: greedy parity, card against CPU
# --------------------------------------------------------------------------


# (label, engine options, inflight, request options, the attention
# kernel a decode step launches once per layer) for phase_parity.
PARITY_MODES = (
    ("serving plane", {}, True, {}, "k2"),
    ("static path", {}, False, {}, "k4"),
    ("dense window", dict(kv_paged=False), True, {}, "k4"),
    ("dense window int8", dict(kv_paged=False, kv_cache_dtype="int8"), True, {}, "k4"),
    ("dense spec K=4", dict(kv_paged=False), True, dict(spec_decode_k=4), "k4"),
    ("two-program paged", dict(prefill_chunk_tokens=0), True, {}, "k2"),
    ("two-program paged int8", dict(prefill_chunk_tokens=0, kv_cache_dtype="int8"), True, {},
     "k2"),
    ("serving spec K=4", {}, True, dict(spec_decode_k=4), "k2"),
)


def phase_parity(seed):
    """Greedy tokens at qwen2-1.5B width and 2 layers in fp32 (TF32 off),
    each mode of PARITY_MODES on the card against the same mode on the
    CPU (the plain path): tokens identical, logprobs within 1e-3, and the
    card's launches = 2 layers x the engine's own steps (the static path:
    K1f per chunk, K4 per decode step; every other mode: K1f per prefill
    dispatch and its decode kernel per step).  Every full-precision
    mode's tokens equal the static path's, on the card and on the CPU."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engines.generator import GeneratorEngine
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

    kw = dict(eos_token_id=151643, kv_page_size=128, prefill_chunk_tokens=8)
    tokens = {}
    for path, ekw, inflight, gkw, kernel in PARITY_MODES:
        g = GenerationHyperparameters(n=2, max_new_tokens=16, greedy=True, **gkw)
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            eng = GeneratorEngine(cfg, params, dev, compute_dtype=torch.float32,
                                  **dict(kw, **ekw))
            _reset_counts()
            t0 = time.monotonic()
            outs[dev] = eng.generate(sample(), MicroBatchSpec(), g, inflight=inflight)
            secs[dev] = time.monotonic() - t0
            if dev == "cuda":
                counts, L = _trial_counts(), cfg.n_layers
                if inflight:
                    want = dict(fwd=L * eng.prefill_dispatches, dq=0, dkv=0, k2=0, k3=0, k4=0)
                    want[kernel] = L * eng.steps_total
                else:
                    want = dict(fwd=L * eng.static_chunks, dq=0, dkv=0, k2=0, k3=0,
                                k4=L * eng.static_decode_steps)
                check(counts == want and counts[kernel] > 0,
                      f"{path}: launches {counts} != {want}")
            del eng
        a, b = outs["cuda"], outs["cpu"]
        same = (
            a.seqlens["packed_input_ids"] == b.seqlens["packed_input_ids"]
            and np.array_equal(a.data["packed_input_ids"], b.data["packed_input_ids"])
        )
        lp_err = float(np.abs(a.data["packed_logprobs"] - b.data["packed_logprobs"]).max())
        log(f"[parity] {path}, 2 layers fp32 greedy: tokens identical={same}, max logprob "
            f"diff={lp_err:.2e} (cuda {secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s)")
        check(same, f"{path}: greedy tokens differ between the card and the CPU")
        check(lp_err <= 1e-3, f"{path}: logprobs differ by {lp_err} > 1e-3")
        tokens[path] = {dev: o.data["packed_input_ids"] for dev, o in outs.items()}
    static = tokens["static path"]
    for path, toks in tokens.items():
        if "int8" in path:
            continue
        same = all(np.array_equal(toks[dev], static[dev]) for dev in ("cuda", "cpu"))
        log(f"[parity] {path} against the static path: tokens identical={same}")
        check(same, f"{path}: greedy tokens differ from the static path's")


# --------------------------------------------------------------------------
# Phase: the GRPO train step at full size
# --------------------------------------------------------------------------

# Bounds of the train phase, between the generator's behaviour logprobs
# (bf16 weights, K2 over a bf16 pool) and the trainer's recompute (bf16
# casts of the same weights, K1f): two bf16 paths through one model.
# The first-minibatch importance ratio and approx-KL (means over the
# response tokens) read 2.6e-4 and 3.4e-4 at most on the H100, and each
# response token's |old_logp - new_logp| (held so that errors cannot
# cancel in a mean) 4.3e-2 at most; the bounds are about 3x that.
IMP_WEIGHT_TOL = 1e-3
APPROX_KL_TOL = 1e-3
TOKEN_LOGP_TOL = 0.125


def _train_prompts(rng, cfg, n_prompts):
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample

    lens = [int(rng.integers(64, 513)) for _ in range(n_prompts)]
    data = rng.integers(0, cfg.vocab_size, sum(lens)).astype(np.int32)
    ids = [f"q{i}" for i in range(n_prompts)]
    return SequenceSample(
        keys={"packed_prompts"}, ids=ids,
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": data},
    ), {i: {"task": "math", "solutions": [r"\boxed{7}"]} for i in ids}


def _profile_train_step(actor_if, actor, rollout, mb):
    """Device time by kernel over one train_step under torch.profiler:
    the card's idle share of its wall time, the K1 kernels' share of the
    busy time and each K1 kernel's device time a call."""
    import re

    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        actor_if.train_step(actor, rollout, mb)
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
    flash_s = sum(k[0] for k in kernels if "flash_" in k[2]) / 1e6
    top = [
        dict(name=name[:90], ms=us / 1e3, calls=n, share=us / 1e6 / max(busy_s, 1e-12))
        for us, n, name in kernels[:8]
    ]
    # Each K1 kernel's device time a call at the step's own packed shape.
    k1 = [
        dict(name=re.search(r"flash_\w+", name).group(0), ms=us / 1e3, calls=n,
             ms_per_call=us / 1e3 / max(n, 1))
        for us, n, name in kernels if "flash_" in name
    ]
    log(f"[profile] 1 train_step: wall {wall:.3f} s, device busy {busy_s:.3f} s, "
        f"idle share {1 - busy_s / wall:.3f}, K1 share of busy "
        f"{flash_s / max(busy_s, 1e-12):.3f} (profiler on)")
    for k in top:
        log(f"[profile]   {k['share']:.3f} {k['ms']:10.2f} ms {k['calls']:7d}x {k['name']}")
    for k in k1:
        log(f"[profile]   K1 {k['name']}: {k['ms']:.2f} ms in {k['calls']} launches = "
            f"{k['ms_per_call']:.4f} ms a call")
    return dict(wall_s=wall, busy_s=busy_s, idle_share=1 - busy_s / wall,
                k1_share=flash_s / max(busy_s, 1e-12), top_kernels=top, k1_per_call=k1)


def _train_recompute(actor_if, actor, rollout, mb):
    """Before the first update: PPOActorInterface.inference ->
    TrainEngine.forward (K1f only, no backward) recomputes the rollout's
    logprobs under the generator's weights; each response token's
    logprob is held against the generator's.  Layer 0's q/k/v and segment
    ids are taken from that forward, and K1f/K1dq/K1dkv are held against
    the plain version at the train step's own packed [B, S]."""
    import numpy as np
    import torch

    from areal_tpu_torch.interfaces.ppo import _extract_layout, _seq_align_minus1
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models import transformer as tfm

    captured = {}
    real_flash = tfm.flash_attention

    def capture(q, k, v, seg, causal=True):
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(), seg=seg.clone())
        return real_flash(q, k, v, seg, causal=causal)

    fa.reset_launches()
    tfm.flash_attention = capture
    try:
        t0 = time.monotonic()
        inf = actor_if.inference(actor, rollout, mb)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        tfm.flash_attention = real_flash
    launches = dict(fa.LAUNCHES)
    new_lp = inf.data["logprobs"]
    check(new_lp.shape == rollout.data["packed_input_ids"].shape
          and bool(np.isfinite(new_lp).all()), "inference logprobs malformed")
    check(launches["fwd"] > 0 and launches["dq"] == 0 and launches["dkv"] == 0,
          f"inference launches {launches}")
    old_lp = _seq_align_minus1(rollout, "packed_logprobs")
    resp = np.zeros(len(old_lp), bool)
    for s, length, pl in _extract_layout(rollout)[0]:
        resp[s + max(pl - 1, 0) : s + length - 1] = True
    diff = np.abs(old_lp - new_lp)[resp]
    tok_max, tok_p999 = float(diff.max()), float(np.quantile(diff, 0.999))
    log(f"[train] inference (TrainEngine.forward) before the update: {secs:.2f} s, "
        f"K1 launches {launches}; per-token |old_logp - new_logp| over {diff.size} "
        f"response tokens: max {tok_max:.4e} (bound {TOKEN_LOGP_TOL:g}), p99.9 "
        f"{tok_p999:.4e}, mean {float(diff.mean()):.4e}")
    check(tok_max < TOKEN_LOGP_TOL, f"a token's logprob differs by {tok_max}")
    q, k, v, seg = (captured[n] for n in ("q", "k", "v", "seg"))
    gen = torch.Generator(device=q.device).manual_seed(0)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    log(f"[flash] layer 0 of the train step: q {tuple(q.shape)} {q.dtype}, "
        f"{int((seg > 0).sum())} real of {seg.numel()} positions")
    held = _hold_flash("train", q, k, v, seg, do, FLASH_ROW_TOL["bf16"])
    return dict(
        inference_s=secs, inference_launches=launches, token_logp_max=tok_max,
        token_logp_p999=tok_p999, train_shape_errs=held,
    )


def phase_train(report, seed):
    """Two GRPO steps of the port at full qwen2-1.5B: generate (32
    requests, the static path as in the JAX package: K1f prefill, K4
    decode) -> reward -> train_step (K1f forward and remat recompute,
    K1dq/K1dkv backward), the generator taking the trained weights in
    between."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        FinetuneSpec, GenerationHyperparameters, Model, OptimizerConfig,
    )
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import PPOActorInterface
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = qwen2_config("1.5b")
    n_prompts, n, max_new = 8, 4, 128
    t0 = time.monotonic()
    params = init_params(cfg, seed + 2, device="cuda")
    train = TrainEngine(
        cfg, params,
        optimizer_config=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ftspec=FinetuneSpec(1, 64, n_prompts), remat_policy="full",
    )
    gen = GeneratorEngine(cfg, params, eos_token_id=151643)
    del params
    torch.cuda.synchronize()
    check(train.device.type == "cuda" and gen.device.type == "cuda",
          "the engines are not on the card")
    log(f"[train] qwen2-1.5b random init, TrainEngine (fp32 masters, bf16 compute, "
        f"remat full) + GeneratorEngine: {time.monotonic() - t0:.1f} s")
    tok = CharTokenizer(vocab_size=cfg.vocab_size)
    actor = Model("actor", train, tok, cfg)
    gen_model = Model("actor_gen", gen, tok, cfg)
    actor_if = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=n, max_new_tokens=max_new, temperature=1.0),
        n_minibatches=1, disable_value=True, adv_norm=True, kl_ctl=0.0,
    )
    mb = MicroBatchSpec()
    rng = np.random.default_rng(seed + 3)
    steps = []
    for step in range(2):
        prompts, id2info = _train_prompts(rng, cfg, n_prompts)
        rw_if = MultiTaskRewardInterface(id2info=id2info)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_gen = time.monotonic()
        fa.reset_launches()
        da.LAUNCHES = rpa.LAUNCHES = 0
        chunks0, dsteps0 = gen.static_chunks, gen.static_decode_steps
        rollout = actor_if.generate(gen_model, prompts, mb)
        torch.cuda.synchronize()
        t_rw = time.monotonic()
        gen_k1 = dict(fa.LAUNCHES)
        k4, k2 = da.LAUNCHES, rpa.LAUNCHES
        gen_chunks = gen.static_chunks - chunks0
        gen_steps = gen.static_decode_steps - dsteps0
        rollout.update_(rw_if.inference(actor, rollout, mb))
        graded = rollout.data["rewards"].copy()
        # A random model solves nothing: replace the graded scores with
        # seeded +-5 so the GRPO advantages are non-zero.
        rollout.data["rewards"] = rng.choice([-5.0, 5.0], size=graded.shape).astype(np.float32)
        t_rw_end = time.monotonic()
        peak = torch.cuda.max_memory_allocated()
        if step == 0:
            # Its dense plain attention is not the step's: keep it out of
            # the step's peak memory.
            inference = _train_recompute(actor_if, actor, rollout, mb)
            torch.cuda.reset_peak_memory_stats()
        t_train = time.monotonic()
        fa.reset_launches()
        stats = actor_if.train_step(actor, rollout, mb)
        torch.cuda.synchronize()
        t_end = time.monotonic()
        launches = dict(fa.LAUNCHES)
        chunks = train.last_pack_stats["n_micro_batches"]
        real = train.last_pack_stats["real_tokens"]
        grid = train.last_pack_stats["grid_tokens"]
        iw, akl, gn = stats["importance_weight"], stats["approx_kl"], stats["grad_norm"]
        rec = dict(
            step=step + 1, generate_s=t_rw - t_gen, reward_s=t_rw_end - t_rw,
            train_s=t_end - t_train, k4_launches=k4, gen_k1f_launches=gen_k1["fwd"],
            static_chunks=gen_chunks, decode_steps=gen_steps, launches=launches,
            micro_batches=chunks, real_tokens=real, grid_tokens=grid,
            train_tokens_per_s=real / (t_end - t_train),
            generated_tokens=int((~rollout.data["prompt_mask"].astype(bool)).sum()),
            graded_correct=int((graded > 0).sum()), importance_weight=iw,
            approx_kl=akl, grad_norm=gn, loss=stats["loss"],
            peak_mem_bytes=max(peak, torch.cuda.max_memory_allocated()),
        )
        if step == 0:
            rec.update(inference)
        steps.append(rec)
        log(f"[train] step {step + 1}: generate {rec['generate_s']:.2f} s "
            f"({rec['generated_tokens']} tokens; static path: {gen_chunks} chunk(s), "
            f"{gen_steps} decode steps, K1f launches {gen_k1['fwd']}, K4 {k4}, K2 {k2}), reward "
            f"{rec['reward_s']:.3f} s ({rec['graded_correct']}/{graded.size} graded "
            f"correct; rewards replaced by seeded +-5), train_step "
            f"{rec['train_s']:.2f} s = {rec['train_tokens_per_s']:.0f} tok/s "
            f"({real} real of {grid} grid tokens, {chunks} micro-batch); "
            f"importance_weight={iw:.6f} approx_kl={akl:.3e} grad_norm={gn:.4f} "
            f"loss={stats['loss']:.4e}; K1 launches {launches}; peak mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB")
        check(gen_chunks >= 1 and k2 == 0, "generate did not take the static path")
        check(gen_k1 == {"fwd": cfg.n_layers * gen_chunks, "dq": 0, "dkv": 0},
              f"generate's K1 launches {gen_k1} != {cfg.n_layers} x {gen_chunks} chunks")
        check(k4 == cfg.n_layers * gen_steps,
              f"generate's K4 launches {k4} != {cfg.n_layers} x {gen_steps} decode steps")
        check(math.isfinite(gn) and gn > 0, f"grad_norm {gn} is not finite and > 0")
        check(stats["quarantined"] == 0.0, "the step was quarantined")
        check(abs(iw - 1.0) < IMP_WEIGHT_TOL,
              f"|importance_weight - 1| = {abs(iw - 1.0)} >= {IMP_WEIGHT_TOL}")
        check(abs(akl) < APPROX_KL_TOL, f"|approx_kl| = {abs(akl)} >= {APPROX_KL_TOL}")
        want = {"fwd": cfg.n_layers * 2 * chunks, "dq": cfg.n_layers * chunks,
                "dkv": cfg.n_layers * chunks}
        check(launches == want, f"K1 launches {launches} != {want}")
        if step == 0:
            gen.set_params(train.get_params())
    total = {"fwd": 0, "dq": 0, "dkv": 0}
    for rec in steps:
        for k in total:
            total[k] += rec["launches"][k]
    prof = _profile_train_step(actor_if, actor, rollout, mb)
    report["train"] = dict(steps=steps, launches=total, profile=prof)
    del train, gen, actor, gen_model
    torch.cuda.empty_cache()


# Bound of the ppo phase's step-1 check between the ref's logprobs
# (InferenceEngine, bf16 casts of the actor's initial weights, K1f) and
# the generator's behaviour logprobs: the mean over response tokens of
# |ref_logp - old_logp|, two bf16 paths through one model.  The same
# comparison for the trainer's recompute (train phase) reads 9.8e-3 to
# 1.0e-2 on the H100, the ref's 1.01e-2; the bound is 3x that, as the
# train phase's are.  The ref is also held bit for bit against the
# trainer's own recompute, the same bf16 computation on the same weights.
REF_LOGP_MEAN_TOL = 3e-2


def _k1_check(tag, launches, n_layers, n_mbs, train):
    """K1 launches of one MFC: n_layers x micro-batches forwards, and for
    a train step (remat "full") a second forward, one dq and one dkv."""
    want = ({"fwd": 2 * n_layers * n_mbs, "dq": n_layers * n_mbs, "dkv": n_layers * n_mbs}
            if train else {"fwd": n_layers * n_mbs, "dq": 0, "dkv": 0})
    check(launches == want, f"{tag}: K1 launches {launches} != {want}")


def phase_ppo(report, seed):
    """Two full PPO steps of `ppo-math` at qwen2-1.5B with all four
    models: the actor (TrainEngine + GeneratorEngine), a critic
    (TrainEngine on the value head) and a reference model (an
    InferenceEngine on the actor's initial weights, offloaded to host
    memory after each call).  Each step: generate (static path) ->
    reward (seeded +-5) -> ref_inf -> critic_inf -> actor train_step ->
    critic train_step -> the generator takes the actor's weights."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        FinetuneSpec, GenerationHyperparameters, Model, OptimizerConfig,
    )
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import (
        PPOActorInterface, PPOCriticInterface, _extract_layout, _seq_align_minus1,
    )
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = qwen2_config("1.5b")
    ccfg = cfg.as_critic()
    n_prompts, n, max_new = 8, 4, 128
    # ppo-math's actor and critic lr (areal_tpu/experiments/common.py).
    oc = OptimizerConfig(lr=2e-5, warmup_steps_proportion=0.0)
    ft = FinetuneSpec(1, 64, n_prompts)
    t0 = time.monotonic()
    params = init_params(cfg, seed + 6, device="cuda")
    train = TrainEngine(cfg, params, optimizer_config=oc, ftspec=ft, remat_policy="full")
    gen = GeneratorEngine(cfg, params, eos_token_id=151643)
    del params
    # The ref from the trainer's live masters: set_params must copy, or
    # the ref would follow the actor's in-place updates.
    ref = InferenceEngine(cfg, train.get_params())
    cparams = init_params(ccfg, seed + 7, device="cuda")
    critic = TrainEngine(ccfg, cparams, optimizer_config=oc, ftspec=ft, remat_policy="full")
    del cparams
    torch.cuda.synchronize()
    check(all(e.device.type == "cuda" for e in (train, gen, ref, critic)),
          "the engines are not on the card")
    check(ref.compute_dtype == torch.bfloat16 and "value_head" in critic.params
          and "lm_head" not in critic.params, "ref dtype or critic head wrong")
    resident = torch.cuda.memory_allocated()
    log(f"[ppo] qwen2-1.5b actor (TrainEngine + GeneratorEngine), critic (TrainEngine, "
        f"value head [{ccfg.hidden_dim}, 1]), ref (InferenceEngine, bf16): "
        f"{time.monotonic() - t0:.1f} s, {resident / 2**30:.2f} GiB resident")
    tok = CharTokenizer(vocab_size=cfg.vocab_size)
    actor = Model("actor", train, tok, cfg)
    gen_model = Model("actor_gen", gen, tok, cfg)
    ref_model = Model("ref", ref, tok, cfg)
    critic_model = Model("critic", critic, tok, ccfg)
    actor_if = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=n, max_new_tokens=max_new, temperature=1.0),
        n_minibatches=1, disable_value=False, adv_norm=True, kl_ctl=0.1,
    )
    critic_if = PPOCriticInterface(n_minibatches=1, value_norm=True, value_norm_type="exp",
                                   kl_ctl=0.1)
    mb = MicroBatchSpec()
    rng = np.random.default_rng(seed + 8)
    steps, step1 = [], {}
    for step in range(2):
        rec = dict(step=step + 1)
        prompts, id2info = _train_prompts(rng, cfg, n_prompts)
        torch.cuda.reset_peak_memory_stats()

        def mfc(name, fn):
            torch.cuda.synchronize()
            fa.reset_launches()
            da.LAUNCHES = rpa.LAUNCHES = 0
            t = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            rec[f"{name}_s"] = time.monotonic() - t
            rec[f"{name}_launches"] = dict(fa.LAUNCHES)
            return out

        chunks0, dsteps0 = gen.static_chunks, gen.static_decode_steps
        rollout = mfc("generate", lambda: actor_if.generate(gen_model, prompts, mb))
        k4 = da.LAUNCHES
        gen_chunks = gen.static_chunks - chunks0
        gen_steps = gen.static_decode_steps - dsteps0
        check(gen_chunks >= 1 and rpa.LAUNCHES == 0, "generate did not take the static path")
        check(rec["generate_launches"] == {"fwd": cfg.n_layers * gen_chunks, "dq": 0, "dkv": 0}
              and k4 == cfg.n_layers * gen_steps,
              f"generate: K1 {rec['generate_launches']}, K4 {k4}")
        rollout.update_(MultiTaskRewardInterface(id2info=id2info).inference(actor, rollout, mb))
        rollout.data["rewards"] = rng.choice(
            [-5.0, 5.0], size=rollout.data["rewards"].shape).astype(np.float32)
        n_mbs = len(rollout.split(mb))

        # ref_inf (the JAX package's ppo-math: the actor interface's
        # inference on the ref, logprobs renamed), then its offload hook.
        ref_out = mfc("ref_inf", lambda: actor_if.inference(ref_model, rollout, mb))
        _k1_check("ref_inf", rec["ref_inf_launches"], cfg.n_layers, n_mbs, train=False)
        ref_out.remap_keys_({"logprobs": "packed_ref_logprobs"})
        rollout.update_(ref_out)
        if step == 0:
            # Before the actor's update its TrainEngine.forward (bf16
            # casts of the same masters) is the ref's computation.
            mine = actor_if.inference(actor, rollout, mb).data["logprobs"]
            rec["ref_equals_trainer_recompute"] = bool(
                np.array_equal(mine, rollout.data["packed_ref_logprobs"]))
        before = torch.cuda.memory_allocated()
        mfc("ref_offload", ref.offload)
        rec["ref_offload_freed_bytes"] = before - torch.cuda.memory_allocated()
        check(ref.params is None and rec["ref_offload_freed_bytes"] > 2.5e9,
              f"ref offload freed {rec['ref_offload_freed_bytes']} bytes")

        values = mfc("critic_inf", lambda: critic_if.inference(critic_model, rollout, mb))
        _k1_check("critic_inf", rec["critic_inf_launches"], cfg.n_layers, n_mbs, train=False)
        v = values.data["values"]
        check(v.shape == rollout.data["packed_input_ids"].shape and bool(np.isfinite(v).all()),
              "critic values malformed")
        rollout.update_(values)

        stats = mfc("actor_train", lambda: actor_if.train_step(actor, rollout, mb))
        _k1_check("actor_train", rec["actor_train_launches"], cfg.n_layers,
                  train.last_pack_stats["n_micro_batches"], train=True)
        cstats = mfc("critic_train", lambda: critic_if.train_step(critic_model, rollout, mb))
        _k1_check("critic_train", rec["critic_train_launches"], cfg.n_layers,
                  critic.last_pack_stats["n_micro_batches"], train=True)
        mfc("set_params", lambda: gen.set_params(train.get_params()))
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

        old_lp = _seq_align_minus1(rollout, "packed_logprobs")
        ref_lp = rollout.data["packed_ref_logprobs"]
        resp = np.zeros(len(old_lp), bool)
        for s0, length, pl in _extract_layout(rollout)[0]:
            resp[s0 + max(pl - 1, 0) : s0 + length - 1] = True
        diff = np.abs(ref_lp - old_lp)[resp]
        mean_v, std_v = critic_if.rms.mean_std()
        iw, akl = stats["importance_weight"], stats["approx_kl"]
        rec.update(
            ref_logp_max=float(diff.max()), ref_logp_mean=float(diff.mean()),
            importance_weight=iw, approx_kl=akl, ref_kl=stats["ref_kl"],
            actor_loss=stats["actor_loss"], actor_grad_norm=stats["grad_norm"],
            value_loss=cstats["value_loss"], value_clip_ratio=cstats["value_clip_ratio"],
            critic_grad_norm=cstats["grad_norm"], value_norm_mean=mean_v,
            value_norm_std=std_v, values_mean=float(v[resp].mean()),
            values_std=float(v[resp].std()), micro_batches=n_mbs,
            train_micro_batches=train.last_pack_stats["n_micro_batches"],
            real_tokens=train.last_pack_stats["real_tokens"],
            grid_tokens=train.last_pack_stats["grid_tokens"],
            static_chunks=gen_chunks, decode_steps=gen_steps, k4_launches=k4,
        )
        log(f"[ppo] step {step + 1}: generate {rec['generate_s']:.2f} s ({gen_chunks} static "
            f"chunk(s), {gen_steps} decode steps), ref_inf {rec['ref_inf_s']:.3f} s + offload "
            f"{rec['ref_offload_s']:.3f} s ({rec['ref_offload_freed_bytes'] / 2**30:.2f} GiB "
            f"freed), critic_inf {rec['critic_inf_s']:.3f} s, actor train "
            f"{rec['actor_train_s']:.2f} s, critic train {rec['critic_train_s']:.2f} s, "
            f"set_params {rec['set_params_s']:.2f} s; peak mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB")
        log(f"[ppo] step {step + 1}: K1 launches ref_inf {rec['ref_inf_launches']}, critic_inf "
            f"{rec['critic_inf_launches']}, actor train {rec['actor_train_launches']}, critic "
            f"train {rec['critic_train_launches']} ({n_mbs} forward micro-batch(es), "
            f"{rec['train_micro_batches']} train micro-batch(es) of {rec['real_tokens']} real / "
            f"{rec['grid_tokens']} grid tokens)")
        log(f"[ppo] step {step + 1}: |ref_logp - old_logp| over {diff.size} response tokens: "
            f"max {rec['ref_logp_max']:.4e}, mean {rec['ref_logp_mean']:.4e}; "
            f"importance_weight={iw:.6f} approx_kl={akl:.3e} ref_kl={stats['ref_kl']:.4e} "
            f"actor grad_norm={stats['grad_norm']:.4f}; value_loss={cstats['value_loss']:.4e} "
            f"value_clip_ratio={cstats['value_clip_ratio']:.3f} critic grad_norm="
            f"{cstats['grad_norm']:.4f}; value norm mean={mean_v:.6f} std={std_v:.6f}; "
            f"values (real scale) mean={rec['values_mean']:.4f} std={rec['values_std']:.4f}")
        check(stats["quarantined"] == 0.0 and cstats["quarantined"] == 0.0,
              "a step was quarantined")
        check(math.isfinite(cstats["value_loss"]), f"value_loss {cstats['value_loss']}")
        check(math.isfinite(cstats["grad_norm"]) and cstats["grad_norm"] > 0,
              f"critic grad_norm {cstats['grad_norm']} is not finite and > 0")
        check(math.isfinite(stats["grad_norm"]) and stats["grad_norm"] > 0,
              f"actor grad_norm {stats['grad_norm']} is not finite and > 0")
        if step == 0:
            log(f"[ppo] step 1: ref logprobs equal the trainer's recompute bit for bit: "
                f"{rec['ref_equals_trainer_recompute']}")
            check(rec["ref_equals_trainer_recompute"],
                  "the ref's logprobs differ from the trainer's recompute")
            check(abs(stats["ref_kl"]) < APPROX_KL_TOL,
                  f"|ref_kl| = {abs(stats['ref_kl'])} >= {APPROX_KL_TOL}")
            check(rec["ref_logp_max"] < TOKEN_LOGP_TOL,
                  f"a token's ref logprob differs by {rec['ref_logp_max']}")
            check(rec["ref_logp_mean"] < REF_LOGP_MEAN_TOL,
                  f"mean |ref - behavior logp| {rec['ref_logp_mean']} >= {REF_LOGP_MEAN_TOL}")
            check(abs(iw - 1.0) < IMP_WEIGHT_TOL,
                  f"|importance_weight - 1| = {abs(iw - 1.0)} >= {IMP_WEIGHT_TOL}")
            check(abs(akl) < APPROX_KL_TOL, f"|approx_kl| = {abs(akl)} >= {APPROX_KL_TOL}")
            step1 = dict(rollout=rollout, ref_lp=ref_lp.copy())
        else:
            # The ref went to host memory after step 1's call and came
            # back for this step's: step 1's sample through it again gives
            # step 1's logprobs bit for bit.
            again = actor_if.inference(ref_model, step1["rollout"], mb).data["logprobs"]
            same = bool(np.array_equal(again, step1["ref_lp"]))
            rec["ref_round_trip_bitwise"] = same
            log(f"[ppo] ref after the offload round trip: step 1's sample again, "
                f"bit-identical={same}; the actor moved: mean |ref - behavior logp| "
                f"{rec['ref_logp_mean']:.4e} against step 1's {steps[0]['ref_logp_mean']:.4e}")
            check(same, "the ref's logprobs changed across the offload round trip")
            check(rec["ref_logp_mean"] > steps[0]["ref_logp_mean"] and stats["ref_kl"] != 0.0,
                  "the KL term did not grow: the actor has not moved from the ref")
        steps.append(rec)
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    for rec in steps:
        for name in ("ref_inf", "critic_inf", "actor_train", "critic_train"):
            for k in launches:
                launches[k] += rec[f"{name}_launches"][k]
    report["ppo"] = dict(steps=steps, launches=launches, resident_bytes=resident)
    del train, gen, ref, critic, actor, gen_model, ref_model, critic_model, step1
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# quickstart: the system's own entry point
# --------------------------------------------------------------------------

QUICKSTART_DIR = os.path.join(REPO, ".quickstart_tmp")


def _math_rows(rng, n):
    """n math rows written here (nothing is downloaded), prompts of 64-512
    bytes: a sum to compute, padded with words."""
    words = "the quick brown fox jumps over lazy dog math proof integer prime sum".split()
    rows = []
    for i in range(n):
        a, b = (int(x) for x in rng.integers(1, 1000, 2))
        text = f"Compute {a} + {b}. "
        target = int(rng.integers(64, 513))
        while len(text) < target:
            text += words[int(rng.integers(len(words)))] + " "
        rows.append({"query_id": f"q{i}", "prompt": text[:target], "task": "math",
                     "solutions": [f"\\boxed{{{a + b}}}"]})
    return rows


def _adamw_bound(lrs, beta1, beta2, weight_decay, w_max):
    """The most AdamW can move one element in updates at learning rates
    `lrs`: update t moves it by at most lr_t (c_t + wd |w|), where
    c_t = sqrt(sum_i a_i^2 / b_i) bounds |m_hat / sqrt(v_hat)| (Cauchy-
    Schwarz over the bias-corrected weights a_i of the gradients in the
    first moment and b_i of their squares in the second; eps only
    shrinks it)."""
    total, w = 0.0, w_max
    for t, lr in enumerate(lrs, start=1):
        c2 = sum(
            ((1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)) ** 2
            / ((1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t))
            for i in range(1, t + 1)
        )
        step = lr * (math.sqrt(c2) + weight_decay * w)
        total, w = total + step, w + step
    return total


def _shard_headers(path):
    from areal_tpu_torch.models.hf import safetensors_io

    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors"):
            header, _ = safetensors_io.read_header(os.path.join(path, f))
            header.pop("__metadata__", None)
            out.update(header)
    return out


def _trial_counts():
    """Every kernel's launch count so far."""
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    return dict(fa.LAUNCHES, k4=da.LAUNCHES, k2=rpa.LAUNCHES, k3=pca.LAUNCHES)


def _reset_counts():
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    fa.reset_launches()
    da.LAUNCHES = rpa.LAUNCHES = pca.LAUNCHES = 0


def _fp32_model_bytes(cfg):
    """Bytes of a dense model's fp32 weights (tied embeddings)."""
    return 4 * (cfg.vocab_size * cfg.hidden_dim + cfg.n_layers * (
        2 * cfg.hidden_dim * cfg.q_dim + 2 * cfg.hidden_dim * cfg.kv_dim
        + 3 * cfg.hidden_dim * cfg.intermediate_dim))


def _check_disk(tag, path, need):
    import shutil

    free = shutil.disk_usage(path).free
    log(f"{tag} disk: {free / 2**30:.1f} GiB free under {path}, {need / 2**30:.1f} GiB needed")
    check(free >= need, f"{tag} only {free / 2**30:.1f} GiB free for the phase's "
          f"checkpoints; {need / 2**30:.1f} GiB needed")


def _write_random_checkpoint(tag, work, cfg, seed):
    """A seeded random checkpoint written by the port's
    save_hf_checkpoint into work/ckpt (fp32, two shards and an index);
    returns (path, seconds, bytes)."""
    import torch

    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.transformer import init_params

    ckpt = os.path.join(work, "ckpt")
    t = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    hf.save_hf_checkpoint(ckpt, cfg, params, model_type="qwen2")
    del params
    torch.cuda.empty_cache()
    write_s = time.monotonic() - t
    files = sorted(os.listdir(ckpt))
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
    shards = [f for f in files if f.endswith(".safetensors")]
    log(f"{tag} wrote a seeded random qwen2-1.5b checkpoint with save_hf_checkpoint: "
        f"{ckpt_bytes / 1e9:.3f} GB fp32 in {write_s:.2f} s "
        f"({ckpt_bytes / 1e9 / write_s:.2f} GB/s): {files}")
    check(len(shards) == 2 and "model.safetensors.index.json" in files,
          f"the checkpoint is not two shards and an index: {files}")
    return ckpt, write_s, ckpt_bytes


def _record_checkpoint_io(wrap, rec):
    """Time every checkpoint load (rec["loads"]: seconds) and every
    interface save (rec["saves"]: (dir, seconds))."""
    import functools

    import torch

    from areal_tpu_torch.interfaces import sft
    from areal_tpu_torch.models.hf import registry as hf

    def on_load(orig):
        @functools.wraps(orig)
        def load(*a, **k):
            t0 = time.monotonic()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            rec["loads"].append(time.monotonic() - t0)
            return out
        return load

    def on_save(orig):
        @functools.wraps(orig)
        def save(self, model, save_dir):
            t0 = time.monotonic()
            orig(self, model, save_dir)
            rec["saves"].append((save_dir, time.monotonic() - t0))
        return save

    wrap(hf, "load_hf_checkpoint", on_load)
    wrap(sft.SFTInterface, "save", on_save)


def _record_trial_steps(wrap, rec, cur):
    """Wrap (through `wrap`, which records what to restore) the master's
    step and the engines' calls, so each step of a `quickstart.main`
    trial appends a record to rec["steps"]: its number, the kernels'
    launches in the step, the static chunks and decode steps generate
    ran, the forward micro-batches of the ref and of the train engine,
    each train_batch call's stats, micro-batches and lr, and the step's
    peak memory.  `cur` is the step in progress."""
    import functools

    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.system.master import MasterWorker

    def on_step(orig):
        async def execute_step(self):
            torch.cuda.synchronize()
            if "resident_bytes" not in rec:
                rec["resident_bytes"] = torch.cuda.memory_allocated()
                rec["plan_nodes"] = [(nd.name, nd.interface_type) for nd in self.dfg.nodes]
            torch.cuda.reset_peak_memory_stats()
            cur.clear()
            cur.update(step=self.step_info.global_step + 1, gen_chunks=0, decode_steps=0,
                       ref_fwd_mbs=0, train_fwd_mbs=0, train_calls=[],
                       counts0=_trial_counts())
            stats = await orig(self)
            torch.cuda.synchronize()
            c1 = _trial_counts()
            cur["launches"] = {k: c1[k] - cur["counts0"][k] for k in c1}
            cur["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            cur["stats"] = stats
            rec["steps"].append(dict(cur))
            return stats
        return execute_step

    def on_generate(orig):
        @functools.wraps(orig)
        def generate(self, *a, **k):
            c0, s0 = self.static_chunks, self.static_decode_steps
            out = orig(self, *a, **k)
            cur["gen_chunks"] += self.static_chunks - c0
            cur["decode_steps"] += self.static_decode_steps - s0
            return out
        return generate

    def on_forward(key):
        def make(orig):
            @functools.wraps(orig)
            def forward(self, sample, mb_spec, *a, **k):
                cur[key] += len(sample.split(mb_spec))
                return orig(self, sample, mb_spec, *a, **k)
            return forward
        return make

    def on_train_batch(orig):
        @functools.wraps(orig)
        def train_batch(self, *a, **k):
            lr = self.lr_schedule(self.opt_count)
            out = orig(self, *a, **k)
            cur["train_calls"].append(dict(
                stats=out, mbs=self.last_pack_stats["n_micro_batches"], lr=lr,
                oc=self.optimizer_config))
            return out
        return train_batch

    wrap(MasterWorker, "execute_step", on_step)
    wrap(GeneratorEngine, "generate", on_generate)
    wrap(InferenceEngine, "forward", on_forward("ref_fwd_mbs"))
    wrap(TrainEngine, "forward", on_forward("train_fwd_mbs"))
    wrap(TrainEngine, "train_batch", on_train_batch)


def _check_step_launches(tag, step, st, nodes, n_layers, max_new):
    """A step's launches (st: one record of _record_trial_steps) against
    the launches each MFC of the DFG `nodes` must make, from the engines'
    own calls: generate one prefill (K1f) a static chunk and one K4 a
    decode step; ref_inf one K1f a forward micro-batch; each train_batch
    of actor_train two forwards (remat "full"), one dq and one dkv a
    micro-batch.  K2 and K3 (the serving plane) run no time."""
    from areal_tpu_torch.api.config import ModelInterfaceType

    L = n_layers
    train_mbs = sum(c["mbs"] for c in st["train_calls"])
    per_node = {}
    for name, itype in nodes:
        if itype == ModelInterfaceType.GENERATE:
            per_node[name] = dict(fwd=L * st["gen_chunks"], k4=L * st["decode_steps"])
        elif itype == ModelInterfaceType.TRAIN_STEP:
            per_node[name] = dict(fwd=L * (2 * train_mbs + st["train_fwd_mbs"]),
                                  dq=L * train_mbs, dkv=L * train_mbs)
        elif name == "ref_inf":
            per_node[name] = dict(fwd=L * st["ref_fwd_mbs"])
    want = {k: sum(d.get(k, 0) for d in per_node.values()) for k in ("fwd", "dq", "dkv", "k4")}
    want.update(k2=0, k3=0)
    log(f"{tag} step {step}: launches {st['launches']}; from the DFG {per_node} "
        f"({st['gen_chunks']} static chunk(s), {st['decode_steps']} decode steps, "
        f"{st['ref_fwd_mbs']} ref micro-batch(es), {len(st['train_calls'])} minibatch "
        f"train_batch call(s) of {train_mbs} micro-batch(es))")
    check(st["launches"] == want, f"{tag} step {step}: launches {st['launches']} != {want}")
    check(st["gen_chunks"] == 1 and 1 <= st["decode_steps"] <= max_new - 1,
          f"{tag} step {step}: generate took {st['gen_chunks']} static chunks, "
          f"{st['decode_steps']} decode steps")


def phase_quickstart(report, seed):
    """`python -m areal_tpu_torch.apps.quickstart ppo-math` at qwen2-1.5B,
    in this process: a seeded random checkpoint written by the port's
    save_hf_checkpoint (fp32, two shards and an index), 64 math rows
    written here, then quickstart.main over them with a ref model from the
    same checkpoint, KL control, 8 prompts x 4 responses, 128 new tokens,
    two steps and a save at step 2.  The graded rewards (all -5 for a
    random model, so no update) are replaced by seeded +-5."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.interfaces.ppo import (
        PPOActorInterface, _extract_layout, _seq_align_minus1,
    )
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import safetensors_io

    cfg = qwen2_config("1.5b")
    n_prompts, n, max_new, n_steps = 8, 4, 128, 2
    rng = np.random.default_rng(seed + 20)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    try:
        # Two fp32 copies of the model (the checkpoint, the step-2 save)
        # and the margin the trial's logs need.
        _check_disk("[quickstart]", work, 2 * _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, write_s, ckpt_bytes = _write_random_checkpoint("[quickstart]", work, cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(rng, 64):
                f.write(json.dumps(row) + "\n")

        # Instrumentation: per-step records from the engines' own calls.
        rec = {"steps": [], "loads": [], "saves": []}
        cur = {}
        _record_trial_steps(wrap, rec, cur)

        def on_actor_train(orig):
            @functools.wraps(orig)
            def train_step(self, model, sample, mb_spec):
                old_lp = _seq_align_minus1(sample, "packed_logprobs")
                ref_lp = _seq_align_minus1(sample, "packed_ref_logprobs")
                resp = np.zeros(len(old_lp), bool)
                for s0, length, pl in _extract_layout(sample)[0]:
                    resp[s0 + max(pl - 1, 0): s0 + length - 1] = True
                diff = np.abs(ref_lp - old_lp)[resp]
                cur["ref_logp_max"], cur["ref_logp_mean"] = float(diff.max()), float(diff.mean())
                cur["response_tokens"] = int(resp.sum())
                return orig(self, model, sample, mb_spec)
            return train_step

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                cur["graded_rewards"] = out.data["rewards"].tolist()
                out.data["rewards"] = rng.choice(
                    [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
                return out
            return inference

        wrap(PPOActorInterface, "train_step", on_actor_train)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        _record_checkpoint_io(wrap, rec)

        argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt,
            "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
            "--max-new-tokens", str(max_new), "--benchmark-steps", str(n_steps),
            "--save-freq-steps", str(n_steps), "--fileroot", os.path.join(work, "trial"),
            "--seed", str(seed + 22),
        ]
        log(f"[quickstart] python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
        log("[quickstart] the graded rewards are replaced by seeded +-5 (a random model's "
            "are all -5, which gives GRPO no advantage)")
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t = time.monotonic()
            stats = quickstart.main(argv)
            torch.cuda.synchronize()
            trial_s = time.monotonic() - t
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)
        check(len(stats) == n_steps and len(rec["steps"]) == n_steps,
              f"{len(stats)} steps of stats, {len(rec['steps'])} recorded")
        check(len(rec["loads"]) == 3, f"{len(rec['loads'])} checkpoint loads, want 3 "
              "(actor, actor_gen, ref)")
        nodes = rec["plan_nodes"]
        log(f"[quickstart] DFG: {[f'{nm} ({it.value})' for nm, it in nodes]}; "
            f"checkpoint loads {['%.2f s' % s for s in rec['loads']]}; trial {trial_s:.1f} s; "
            f"resident after setup {rec['resident_bytes'] / 2**30:.2f} GiB")
        L = cfg.n_layers
        steps_out = []
        for i, st in enumerate(rec["steps"]):
            s = st["stats"]
            check(all(math.isfinite(v) for v in s.values()),
                  f"step {i + 1}: non-finite stats {[k for k, v in s.items() if not math.isfinite(v)]}")
            check(s["actor_train/quarantined"] == 0.0, f"step {i + 1} was quarantined")
            _check_step_launches("[quickstart]", i + 1, st, nodes, L, max_new)
            first = st["train_calls"][0]["stats"]
            mfc = {k.split("/")[0]: v for k, v in s.items() if k.endswith("/perf/time_s")}
            rec_out = dict(
                step_s=s["time/step_s"], mfc_s=mfc,
                train_mfu=s.get("actor_train/perf/mfu"),
                generate_mfu=s.get("actor_gen/perf/mfu"), ref_mfu=s.get("ref_inf/perf/mfu"),
                train_tflops=s["actor_train/perf/tflops"],
                peak_mem_bytes=st["peak_mem_bytes"], launches=st["launches"],
                first_importance_weight=first["importance_weight"],
                first_approx_kl=first["approx_kl"],
                importance_weight=s["actor_train/importance_weight"],
                approx_kl=s["actor_train/approx_kl"], ref_kl=s["actor_train/ref_kl"],
                ref_logp_max=st["ref_logp_max"], ref_logp_mean=st["ref_logp_mean"],
                actor_loss=s["actor_train/actor_loss"], grad_norm=s["actor_train/grad_norm"],
                decode_steps=st["decode_steps"],
                train_micro_batches=sum(c["mbs"] for c in st["train_calls"]),
            )
            steps_out.append(rec_out)
            log(f"[quickstart] step {i + 1}: {s['time/step_s']:.2f} s; by MFC (s) "
                f"{ {k: round(v, 3) for k, v in mfc.items()} }; MFU actor_train "
                f"{rec_out['train_mfu']}, actor_gen {rec_out['generate_mfu']}, ref_inf "
                f"{rec_out['ref_mfu']}; peak {st['peak_mem_bytes'] / 2**30:.2f} GiB")
            log(f"[quickstart] step {i + 1}: first minibatch importance_weight="
                f"{first['importance_weight']:.6f} approx_kl={first['approx_kl']:.3e}; step "
                f"importance_weight={s['actor_train/importance_weight']:.6f} approx_kl="
                f"{s['actor_train/approx_kl']:.3e} ref_kl={s['actor_train/ref_kl']:.3e}; "
                f"|ref - behaviour logp| over {st['response_tokens']} response tokens: max "
                f"{st['ref_logp_max']:.4e} mean {st['ref_logp_mean']:.4e}; actor_loss="
                f"{s['actor_train/actor_loss']:.4e} grad_norm={s['actor_train/grad_norm']:.4f}")
            if i == 0:
                # Before any update actor, generator and ref hold the
                # checkpoint's weights: the first minibatch's ratio is 1.
                check(abs(first["importance_weight"] - 1.0) < IMP_WEIGHT_TOL,
                      f"|importance_weight - 1| = {abs(first['importance_weight'] - 1.0)}")
                check(abs(first["approx_kl"]) < APPROX_KL_TOL,
                      f"|approx_kl| = {abs(first['approx_kl'])}")
                check(abs(s["actor_train/ref_kl"]) < APPROX_KL_TOL,
                      f"|ref_kl| = {abs(s['actor_train/ref_kl'])}")
                check(st["ref_logp_max"] < TOKEN_LOGP_TOL and st["ref_logp_mean"] < REF_LOGP_MEAN_TOL,
                      f"|ref - behaviour logp| max {st['ref_logp_max']}, mean {st['ref_logp_mean']}")

        check(total == {k: sum(st["launches"][k] for st in rec["steps"]) for k in total}
              and all(total[k] > 0 for k in ("fwd", "dq", "dkv", "k4")),
              f"launches over the trial {total}: outside the steps, or a kernel never ran")

        # The step-2 save: the checkpoint's keys and shapes, fp32, and the
        # update: non-zero, within what AdamW can move an element.
        check(len(rec["saves"]) == 1, f"saves: {rec['saves']}")
        saved, save_s = rec["saves"][0]
        want_h, got_h = _shard_headers(ckpt), _shard_headers(saved)
        check({k: v["shape"] for k, v in got_h.items()} == {k: v["shape"] for k, v in want_h.items()},
              "the saved checkpoint's tensors differ from the loaded one's")
        check({v["dtype"] for v in got_h.values()} == {"F32"}, "the saved checkpoint is not fp32")
        updates = [c for st in rec["steps"] for c in st["train_calls"]
                   if c["stats"]["quarantined"] == 0.0]
        oc = updates[0]["oc"]
        lrs = [c["lr"] for c in updates]
        before, after = {}, {}
        for path, into in ((ckpt, before), (saved, after)):
            for f in sorted(os.listdir(path)):
                if f.endswith(".safetensors"):
                    into.update(safetensors_io.load_file(os.path.join(path, f)))
        largest, worst = 0.0, 0.0
        for name, w0 in before.items():
            w0 = w0.cuda()
            delta = float((after[name].cuda() - w0).abs().max())
            bound = _adamw_bound(lrs, oc.beta1, oc.beta2, oc.weight_decay, float(w0.abs().max()))
            largest, worst = max(largest, delta), max(worst, delta / bound)
            check(delta <= bound, f"{name}: moved {delta}, more than AdamW's bound {bound}")
        del before, after
        log(f"[quickstart] step-2 save: {saved} in {save_s:.2f} s; {len(updates)} AdamW updates "
            f"at lr {lrs[0]:g}: largest change {largest:.3e}, at most {worst:.3f} of its "
            f"tensor's bound")
        check(largest > 0.0, "the saved weights equal the loaded ones: no update")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    report["quickstart"] = dict(
        steps=steps_out, launches=total, resident_bytes=rec["resident_bytes"],
        ckpt_write_s=write_s, ckpt_bytes=ckpt_bytes, ckpt_load_s=rec["loads"],
        save_s=save_s, trial_s=trial_s, largest_update=largest,
    )


# --------------------------------------------------------------------------
# recover: kill-and-resume, the EMA reference model and the difficulty filter
# --------------------------------------------------------------------------

RECOVER_DIR = os.path.join(REPO, ".recover_tmp")
RECOVER_ETA = 0.9
RECOVER_FILTER = {"min_accuracy": 0.25, "max_accuracy": 0.75}
# Step 2's reward groups: the first 3 prompts of the batch score 4/4, the
# next 2 score 0/4 (the expected drop set); every other group 2/4.
RECOVER_ALL_GOOD, RECOVER_ALL_BAD = 3, 2
# Resumed against uninterrupted, when the step-1 masters agree bit for
# bit: every step-2/3 stat within this relative difference.
RESUME_STATS_RTOL = 1e-6


def _leaf_fingerprints(tree):
    """Per-leaf fingerprints of a tensor tree on the card, to compare two
    states bit for bit without a copy: each leaf's dtype, shape, and two
    int64 sums over its raw words (the words, and each word times its
    index mod 65521, plus 1), taken in chunks."""
    import torch

    out = {}
    for name, x in _flat_params(tree):
        w = x.detach().contiguous().view(-1)
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        s0 = torch.zeros((), dtype=torch.int64, device=w.device)
        s1 = torch.zeros((), dtype=torch.int64, device=w.device)
        for i in range(0, w.numel(), 1 << 24):
            c = w[i:i + (1 << 24)].to(torch.int64)
            idx = torch.arange(i, i + c.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
            s0 += c.sum()
            s1 += (c * idx).sum()
        out[name] = (str(x.dtype), tuple(x.shape), int(s0), int(s1))
    return out


def _trial_state(master):
    """What a recover checkpoint must carry over, read from a master and
    its one worker: counters, controls (their elapsed seconds aside),
    the filter's ids, the versions, the dataset's ids, and fingerprints
    of the actor's fp32 masters and Adam moments and of the ref."""
    w = master.pool.workers[0]
    actor = w.models["actor@0"].engine
    ref = w.models["ref@0"].engine
    ref_params = ref.get_params()
    out = dict(
        step_info=dataclasses.asdict(master.step_info),
        ctl={name: {k: v for k, v in ctl.state_dict().items() if k != "elapsed"}
             for name, ctl in (("save", master.save_ctl), ("ckpt", master.ckpt_ctl))},
        filtered_ids=list(master._filtered_ids),
        versions={k: m.version for k, m in w.models.items()},
        dataset_ids=list(w.datasets[0].ids),
        opt_count=actor.opt_count,
        masters=_leaf_fingerprints(actor.params),
        mu=_leaf_fingerprints(actor._mu),
        nu=_leaf_fingerprints(actor._nu),
        ref=_leaf_fingerprints(ref_params),
    )
    ref.offload()  # as the trial left it
    return out


def phase_recover(report, seed):
    """Kill-and-resume at qwen2-1.5B (28 layers, full width), through
    `quickstart.main(["ppo-math", ...])` in this process: the quickstart
    phase's trial (a seeded random fp32 checkpoint in two shards, 64 math
    rows, `char:151936`, a ref, `--kl-ctl 0.1`, 8 prompts x 4, 128 new
    tokens) with `--ref-ema-eta 0.9 --offload-ref` and the difficulty
    filter (`dataset_filter` {min 0.25, max 0.75}, which the CLI has no
    flag for: set by wrapping build_ppo_math).  Rewards are seeded +-5,
    2 of 4 positive in every group but at step 2, where the batch's first
    3 prompts score 4/4 and the next 2 score 0/4: the filter must drop
    exactly those 5.  Three trials:

    U   uninterrupted, three steps, no recover save;
    R1  one step with `--ckpt-freq-steps 1` (a recover checkpoint at 1);
    R2  the same trial name rerun to step 3: it restores step 1 and runs
        steps 2 and 3, with no recover save (so no `.prev`).

    (The drop comes at step 2, after the restart: a drop before a
    checkpoint makes the restored data cursor replay a permutation of the
    shrunken dataset, as the JAX package's does, and the resumed batches
    then differ from U's; the CPU tests pin that behaviour.)

    Checked: after every EMA (each step, and the restore's replay) each
    ref leaf equals 0.9 * actor + 0.1 * ref_before bit for bit (the
    coefficients in each leaf's dtype, as JAX's weak typing does) and the
    ref is back on host at the step's end; the filter drops exactly the 5
    expected ids at step 2, no dropped id comes back, every fetch holds
    >= 8 unique ids; R1's recover dir validates its manifest; R2 restores
    R1's fp32 masters, Adam moments, update count, ref, versions, step
    account, controls and filter state bit for bit; R2's steps 2 and 3
    fetch U's ids; U's and R1's step-1 masters are compared bit for bit
    and, where they agree, R2's tokens equal U's and its stats agree
    within RESUME_STATS_RTOL (the port's kernels use no atomics); each
    step's launches equal 28 x the engines' calls of each MFC."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.system.master import MasterWorker
    from areal_tpu_torch.system.worker import ModelWorker, _Cycler

    cfg = qwen2_config("1.5b")
    n_prompts, n, max_new = 8, 4, 128
    L = cfg.n_layers
    os.makedirs(RECOVER_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=RECOVER_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    rec, cur = {}, {}
    phase = {"ema": [], "times": {}, "states": {}, "host_step1": None, "in_restore": False}
    trials = {}
    try:
        model = _fp32_model_bytes(cfg)
        # The input checkpoint, the recover checkpoint (weights and both
        # Adam moments) and a margin.
        _check_disk("[recover]", work, 4 * model + 2 * 2**30)
        ckpt, write_s, ckpt_bytes = _write_random_checkpoint("[recover]", work, cfg, seed + 40)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(np.random.default_rng(seed + 41), 64):
                f.write(json.dumps(row) + "\n")

        _record_trial_steps(wrap, rec, cur)
        _record_checkpoint_io(wrap, rec)

        def on_build(orig):
            @functools.wraps(orig)
            def build_ppo_math(c, *a, **k):
                c.dataset_filter = dict(RECOVER_FILTER)
                return orig(c, *a, **k)
            return build_ppo_math

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                groups = [len(g) for g in sample.seqlens["packed_input_ids"]]
                step = cur["step"]
                r = np.random.default_rng([seed + 42, step])
                rewards = []
                for gi, k in enumerate(groups):
                    if step == 2 and gi < RECOVER_ALL_GOOD:
                        rewards += [5.0] * k
                    elif step == 2 and gi < RECOVER_ALL_GOOD + RECOVER_ALL_BAD:
                        rewards += [-5.0] * k
                    else:
                        rewards += list(r.permutation([5.0] * (k // 2) + [-5.0] * (k - k // 2)))
                out.data["rewards"] = np.asarray(rewards, np.float32)
                cur["reward_ids"] = list(sample.ids)
                cur["tokens"] = np.asarray(sample.data["packed_input_ids"]).copy()
                return out
            return inference

        def on_fetch(orig):
            @functools.wraps(orig)
            def fetch(self, req):
                cur["loader_batches"] = 0
                out = orig(self, req)
                cur["fetch_ids"] = list(out["meta"].ids)
                return out
            return fetch

        def on_cycler_next(orig):
            @functools.wraps(orig)
            def nxt(self):
                if "loader_batches" in cur:
                    cur["loader_batches"] += 1
                return orig(self)
            return nxt

        def on_param_sync(orig):
            @functools.wraps(orig)
            def param_sync(self, req):
                if req["dst"] != "ref@0":
                    return orig(self, req)
                ref = self.models["ref@0"].engine
                before = {k: v.clone() for k, v in _flat_params(ref.get_params())}
                out = orig(self, req)
                actor = dict(_flat_params(self.models[req["src"]].engine.get_params()))
                bad, worst = [], 0.0
                for k, after in _flat_params(ref.get_params()):
                    b, a = before.pop(k), actor[k]
                    # JAX's weak typing: each coefficient in its leaf's dtype.
                    want = (torch.tensor(req["eta"], dtype=a.dtype) * a
                            + torch.tensor(1 - req["eta"], dtype=b.dtype) * b).to(b.dtype)
                    if not torch.equal(after, want):
                        bad.append(k)
                        worst = max(worst, float((after.float() - want.float()).abs().max()))
                phase["ema"].append(dict(
                    trial=phase["trial"], step="restore" if phase["in_restore"] else cur["step"],
                    eta=req["eta"], bad=bad, worst=worst))
                return out
            return param_sync

        def on_step_end(orig):
            async def execute_step(self):
                stats = await orig(self)
                ref = self.pool.workers[0].models["ref@0"].engine
                rec["steps"][-1].update(ref_offloaded=ref._host_offload is not None,
                                        filtered=list(self._filtered_ids))
                if phase["trial"] in ("U", "R1") and rec["steps"][-1]["step"] == 1:
                    actor = self.pool.workers[0].models["actor@0"].engine
                    phase["states"][phase["trial"] + "_step1"] = _leaf_fingerprints(actor.params)
                    if phase["trial"] == "U":
                        phase["host_step1"] = {k: v.detach().to("cpu", copy=True)
                                               for k, v in _flat_params(actor.params)}
                    else:
                        phase["step1_gap"] = max(
                            float((v.detach() - phase["host_step1"][k].cuda()).abs().max())
                            for k, v in _flat_params(actor.params))
                        phase["host_step1"] = None
                return stats
            return execute_step

        def on_run(orig):
            async def run(self):
                out = await orig(self)
                phase["states"][phase["trial"] + "_exit"] = _trial_state(self)
                return out
            return run

        def on_restore(orig):
            async def restore_worker_state(self):
                t0 = time.monotonic()
                phase["in_restore"] = True
                await orig(self)
                phase["in_restore"] = False
                torch.cuda.synchronize()
                phase["times"]["restore_s"] = time.monotonic() - t0
                phase["states"]["R2_restored"] = _trial_state(self)
            return restore_worker_state

        def on_save_recover(orig):
            async def save_recover(self, step):
                t0 = time.monotonic()
                await orig(self, step)
                phase["times"]["recover_save_s"] = time.monotonic() - t0
            return save_recover

        wrap(exps, "build_ppo_math", on_build)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        wrap(ModelWorker, "_handle_fetch", on_fetch)
        wrap(_Cycler, "__next__", on_cycler_next)
        wrap(ModelWorker, "_handle_param_sync", on_param_sync)
        wrap(MasterWorker, "execute_step", on_step_end)
        wrap(MasterWorker, "run", on_run)
        wrap(MasterWorker, "_restore_worker_state", on_restore)
        wrap(MasterWorker, "_save_recover", on_save_recover)

        fileroot = os.path.join(work, "trial")
        base_argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt,
            "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
            "--max-new-tokens", str(max_new), "--ref-ema-eta", str(RECOVER_ETA),
            "--offload-ref", "--fileroot", fileroot, "--seed", str(seed + 43),
        ]
        plan = (("U", ["--benchmark-steps", "3", "--trial-name", "uninterrupted"]),
                ("R1", ["--benchmark-steps", "1", "--trial-name", "killed",
                        "--ckpt-freq-steps", "1"]),
                ("R2", ["--benchmark-steps", "3", "--trial-name", "killed"]))
        log(f"[recover] python -m areal_tpu_torch.apps.quickstart {' '.join(base_argv)} "
            f"with dataset_filter={RECOVER_FILTER}; trials {dict(plan)}")
        torch.cuda.synchronize()
        _reset_counts()
        try:
            for name, extra in plan:
                phase["trial"] = name
                rec.clear()
                rec.update(steps=[], loads=[], saves=[])
                c0 = _trial_counts()
                t = time.monotonic()
                stats = quickstart.main(base_argv + extra)
                torch.cuda.synchronize()
                c1 = _trial_counts()
                trials[name] = dict(
                    stats=stats, steps=list(rec["steps"]), loads=list(rec["loads"]),
                    saves=list(rec["saves"]), seconds=time.monotonic() - t,
                    launches={k: c1[k] - c0[k] for k in c1},
                    resident_bytes=rec.get("resident_bytes"), nodes=rec.get("plan_nodes"),
                )
                gc.collect()
                torch.cuda.empty_cache()
                log(f"[recover] trial {name}: {len(stats)} step(s) in "
                    f"{trials[name]['seconds']:.1f} s; checkpoint loads "
                    f"{['%.2f s' % s for s in rec['loads']]}; card memory after "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)

        # ---- every step: stats, launches, EMA, offload, fetches ----
        for name, tr in trials.items():
            check(len(tr["stats"]) == {"U": 3, "R1": 1, "R2": 2}[name],
                  f"[recover] trial {name}: {len(tr['stats'])} steps")
            check(tr["launches"] == {k: sum(st["launches"][k] for st in tr["steps"])
                                     for k in tr["launches"]},
                  f"[recover] trial {name}: launches outside its steps {tr['launches']}")
            for st in tr["steps"]:
                s, i = st["stats"], st["step"]
                check(all(math.isfinite(v) for v in s.values()),
                      f"[recover] {name} step {i}: non-finite stats")
                check(s["actor_train/quarantined"] == 0.0, f"[recover] {name} step {i} quarantined")
                _check_step_launches(f"[recover] {name}", i, st, tr["nodes"], L, max_new)
                check(st["ref_offloaded"], f"[recover] {name} step {i}: the ref is not on host")
                ids = st["fetch_ids"]
                check(len(ids) == len(set(ids)) >= n_prompts and len(st["reward_ids"]) == n_prompts,
                      f"[recover] {name} step {i}: fetched {ids}, graded {st['reward_ids']}")
                mfc = {k.split("/")[0]: round(v, 3) for k, v in s.items()
                       if k.endswith("/perf/time_s")}
                log(f"[recover] {name} step {i}: {s['time/step_s']:.2f} s; by MFC (s) {mfc}; "
                    f"peak {st['peak_mem_bytes'] / 2**30:.2f} GiB; fetched {len(ids)} ids in "
                    f"{st['loader_batches']} loader batch(es); filtered so far "
                    f"{len(st['filtered'])}")
        ema_bad = [e for e in phase["ema"] if e["bad"]]
        log(f"[recover] EMA checks: {[(e['trial'], e['step']) for e in phase['ema']]}; "
            f"leaves off the exact mix: {ema_bad}")
        check(len(phase["ema"]) == 3 + 1 + 3 and not ema_bad,
              f"[recover] EMA not bit for bit (or not 7 calls): {ema_bad or phase['ema']}")

        # ---- the filter ----
        u2, u3 = trials["U"]["steps"][1], trials["U"]["steps"][2]
        expected = u2["reward_ids"][:RECOVER_ALL_GOOD + RECOVER_ALL_BAD]
        log(f"[recover] filter: expected drop {expected}; U dropped {u2['filtered']}; "
            f"step-3 fetch {u3['fetch_ids']}")
        check(trials["U"]["steps"][0]["filtered"] == [] and u2["filtered"] == expected,
              f"[recover] U's filter dropped {u2['filtered']}, want {expected}")
        check(not set(expected) & set(u3["fetch_ids"]) and not set(expected) & set(
            trials["R2"]["steps"][1]["fetch_ids"]), "[recover] a dropped id was fetched again")
        st_u = phase["states"]["U_exit"]
        check(len(st_u["dataset_ids"]) == 64 - len(expected)
              and not set(expected) & set(st_u["dataset_ids"]),
              f"[recover] U's dataset holds {len(st_u['dataset_ids'])} rows")

        # ---- the recover checkpoint and the round trip ----
        base = os.path.join(fileroot, "checkpoints", "ppo-math", "killed", "actor@0",
                            "recover_checkpoint")
        manifest = recover.validate_manifest(base)
        check(manifest is not None and manifest["step"] == 1,
              f"[recover] R1's recover checkpoint {base} does not validate: {manifest}")
        check(not os.path.exists(base + recover.PREV_SUFFIX)
              and sorted(os.listdir(os.path.dirname(base))) == ["recover_checkpoint"],
              f"[recover] {os.listdir(os.path.dirname(base))} beside the checkpoint")
        rc_bytes = sum(f["size"] for f in manifest["files"])
        log(f"[recover] R1's recover checkpoint: {rc_bytes / 1e9:.3f} GB in "
            f"{len(manifest['files'])} files, saved in {phase['times']['recover_save_s']:.2f} s "
            f"({rc_bytes / 1e9 / phase['times']['recover_save_s']:.2f} GB/s); R2's restore "
            f"{phase['times']['restore_s']:.2f} s ({rc_bytes / 1e9 / phase['times']['restore_s']:.2f} "
            f"GB/s); manifest versions {manifest['model_versions']}")
        r1, r2 = phase["states"]["R1_exit"], phase["states"]["R2_restored"]
        for key in ("masters", "mu", "nu", "opt_count", "ref", "versions", "step_info", "ctl",
                    "filtered_ids", "dataset_ids"):
            check(r1[key] == r2[key], f"[recover] R2's restored {key} differs from R1's at exit")
        log(f"[recover] R2 restored R1's state bit for bit: masters, mu, nu "
            f"({len(r1['masters'])} leaves each), opt_count {r1['opt_count']}, the ref, "
            f"versions {r1['versions']}, step {r1['step_info']}, controls {r1['ctl']}")

        # ---- resumed against uninterrupted ----
        same = phase["states"]["U_step1"] == phase["states"]["R1_step1"]
        log(f"[recover] U's and R1's step-1 masters bitwise equal: {same} (largest "
            f"difference {phase['step1_gap']:.3e})")
        for (su, sr) in zip(trials["U"]["steps"][1:], trials["R2"]["steps"]):
            check(su["fetch_ids"] == sr["fetch_ids"],
                  f"[recover] step {sr['step']}: R2 fetched {sr['fetch_ids']}, U {su['fetch_ids']}")
        worst = {}
        for (su, sr) in zip(trials["U"]["steps"][1:], trials["R2"]["steps"]):
            for k, v in su["stats"].items():
                if "/perf/" in k or "/time/" in k or k.startswith("time/"):
                    continue
                d = abs(sr["stats"][k] - v) / max(abs(v), 1e-30)
                worst[k] = max(worst.get(k, 0.0), d)
        tokens_equal = [np.array_equal(su["tokens"], sr["tokens"])
                        for su, sr in zip(trials["U"]["steps"][1:], trials["R2"]["steps"])]
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
        log(f"[recover] R2 against U at steps 2-3: tokens equal {tokens_equal}; largest "
            f"relative stat differences {top}")
        check(same, f"[recover] U's and R1's step-1 masters differ (by up to "
              f"{phase['step1_gap']:.3e}): the train step is not deterministic on the card")
        check(all(tokens_equal) and max(worst.values()) <= RESUME_STATS_RTOL,
              f"[recover] the resumed trial left the uninterrupted one: tokens {tokens_equal}, "
              f"stats {top}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    steps_s = {name: [st["stats"]["time/step_s"] for st in tr["steps"]]
               for name, tr in trials.items()}
    report["recover"] = dict(
        launches=total, ckpt_write_s=write_s, ckpt_bytes=ckpt_bytes,
        recover_bytes=rc_bytes, times=phase["times"], steps_s=steps_s,
        peak_mem_bytes=max(st["peak_mem_bytes"] for tr in trials.values() for st in tr["steps"]),
        trial_s={name: tr["seconds"] for name, tr in trials.items()},
    )
    log(f"[recover] step seconds {steps_s}; peak {report['recover']['peak_mem_bytes'] / 2**30:.2f} "
        f"GiB; launches over the phase {total}")
    log_card()


def phase_train_parity(seed):
    """One train_batch at qwen2-1.5B width, 2 layers, fp32: the card (K1
    kernels, cuBLAS) against the CPU (plain versions), same weights and
    batch, same loss: the actor's PPO loss, then a critic's clipped value
    loss on the value head."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import (
        _mask_count, _ppo_actor_loss_factory, _ppo_critic_loss_factory,
    )
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=2)
    rng = np.random.default_rng(seed + 5)
    lens = [100, 300, 150, 200]
    total = sum(lens)
    pmask = np.concatenate([np.arange(l) < l // 3 for l in lens])
    lmask = np.concatenate([(np.arange(l) >= l // 3 - 1) & (np.arange(l) < l - 1) for l in lens])
    arrays = dict(
        packed_input_ids=rng.integers(0, base.vocab_size, total).astype(np.int32),
        prompt_mask=pmask,
        old_logp=(-12.0 + 0.5 * rng.standard_normal(total)).astype(np.float32),
        advantages=rng.standard_normal(total).astype(np.float32),
        loss_mask=lmask.astype(np.float32),
        old_values=(0.5 * rng.standard_normal(total)).astype(np.float32),
        returns=rng.standard_normal(total).astype(np.float32),
    )
    sample = SequenceSample(
        keys=set(arrays), ids=[f"s{i}" for i in range(len(lens))],
        seqlens={k: [[l] for l in lens] for k in arrays}, data=arrays,
    )
    lr = 1e-5
    runs = (
        ("actor", base, seed + 4, _ppo_actor_loss_factory(0.2),
         ("old_logp", "advantages", "loss_mask")),
        ("critic", base.as_critic(), seed + 9, _ppo_critic_loss_factory(0.2),
         ("old_values", "returns", "loss_mask")),
    )
    for kind, cfg, pseed, loss_fn, extra_keys in runs:
        params = init_params(cfg, pseed, device="cpu")
        out, after = {}, {}
        for dev in ("cuda", "cpu"):
            eng = TrainEngine(
                cfg, params, dev, compute_dtype=torch.float32,
                optimizer_config=OptimizerConfig(lr=lr, warmup_steps_proportion=0.0),
                ftspec=FinetuneSpec(1, 8, 8), remat_policy="full",
            )
            fa.reset_launches()
            t0 = time.monotonic()
            out[dev] = eng.train_batch(
                sample, MicroBatchSpec(), loss_fn, _mask_count, extra_keys=extra_keys,
            )
            secs = time.monotonic() - t0
            if dev == "cuda":
                check(fa.LAUNCHES == {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers,
                                      "dkv": cfg.n_layers},
                      f"{kind}: card launches {fa.LAUNCHES}")
            after[dev] = {k: v.detach().cpu() for k, v in _flat_params(eng.get_params())}
            log(f"[train_parity] {kind} {dev}: loss={out[dev]['loss']:.8e} "
                f"grad_norm={out[dev]['grad_norm']:.8e} ({secs:.1f} s)")
            del eng
        before = dict(_flat_params(params))
        rel = {
            k: abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
            for k in ("loss", "grad_norm")
        }
        # Adam's first step moves each weight by about lr * sign(g) (plus
        # decay): compare the two devices' moves.  A gradient element near
        # 0 (|g| ~ eps) may move by a different fraction of lr on each
        # side, so the bound is on the share of weights whose moves differ
        # by more than lr / 10, and on the largest difference (2 lr:
        # opposite signs).
        n_all = n_off = 0
        worst = 0.0
        for k, p0 in before.items():
            d = (after["cuda"][k] - p0) - (after["cpu"][k] - p0)
            worst = max(worst, float(d.abs().max()))
            n_off += int((d.abs() > lr / 10).sum())
            n_all += d.numel()
        frac = n_off / n_all
        log(f"[train_parity] {kind}, 2 layers fp32: loss rel diff {rel['loss']:.2e}, "
            f"grad_norm rel diff {rel['grad_norm']:.2e} (bound 1e-4); weight moves differing "
            f"by > lr/10: {n_off} of {n_all} ({frac:.2e}, bound 1e-3); largest "
            f"{worst:.3e} (bound {2 * lr:g})")
        check(rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-4,
              f"{kind}: loss/grad_norm differ card vs CPU: {rel}")
        check(frac <= 1e-3 and worst <= 2 * lr * (1 + 1e-3),
              f"{kind}: params after the step differ card vs CPU")


# --------------------------------------------------------------------------
# genmodes: the generator's other inflight modes at full size
# --------------------------------------------------------------------------

# (name, engine options, request options, the attention kernel a decode
# step of the mode launches once per layer)
GENMODES = (
    ("dense", dict(kv_paged=False), {}, "k4"),
    ("dense_int8", dict(kv_paged=False, kv_cache_dtype="int8"), {}, "k4"),
    ("dense_spec", dict(kv_paged=False), dict(spec_decode_k=4), "k4"),
    ("paged2", dict(prefill_chunk_tokens=0), {}, "k2"),
    ("paged2_int8", dict(prefill_chunk_tokens=0, kv_cache_dtype="int8"), {}, "k2"),
    ("serving_spec", {}, dict(spec_decode_k=4), "k2"),
)
# The decode-chunk getter of each mode's loop.
GENMODE_CHUNK_GETTER = {
    "dense": "_get_inflight_decode_fn", "dense_int8": "_get_inflight_decode_fn",
    "dense_spec": "_get_spec_decode_fn", "paged2": "_get_paged_decode_fn",
    "paged2_int8": "_get_paged_decode_fn", "serving_spec": "_get_serving_chunk_fn",
}
GENMODE_SLOTS = 16
INT8_AGREEMENT = 0.85  # tests/test_generator.py:316's bound


def _genmode_run(name, cfg, params, prompts, n, max_new, ekw, gkw, kernel, seed):
    """One mode: the burst (every prompt at once, n greedy responses of
    max_new tokens, the mode's request options) through GenerationServer
    over an engine with GENMODE_SLOTS slots.  The launch counts are set
    to 0 just before the burst and read just after it.  The mode's second
    decode chunk runs under torch.cuda.set_sync_debug_mode("error"); CUDA
    events bracket every chunk; a speculative step's emitted tokens are
    summed on the card."""
    import torch

    from areal_tpu_torch.engines import generator as gen_mod
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.gen_server import GenerationServer

    engine = GeneratorEngine(cfg, params, eos_token_id=151643,
                             max_decode_batch=GENMODE_SLOTS, **ekw)
    check(engine.device.type == "cuda", f"[genmodes] {name}: the engine is not on the card")
    engine.static_path_max_new = 0  # every mode is an inflight one
    calls, chunk_ev, held = [], [], {}
    real_generate = engine.generate

    def generate(sample, *a, **k):
        out = real_generate(sample, *a, **k)
        calls.append(dict(prefill_dispatches=engine.prefill_dispatches,
                          cache_copy_bytes=engine.cache_copy_bytes,
                          decode_compiles=engine.decode_compiles,
                          dead_live_lanes=engine.dead_live_lanes))
        return out

    getter_name = GENMODE_CHUNK_GETTER[name]
    real_getter = getattr(engine, getter_name)

    def getter(*a, **k):
        fn = real_getter(*a, **k)

        def run(*fa, **fk):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            hold = len(chunk_ev) == 1  # the second chunk: kernels loaded, warm
            if hold:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            ev[0].record()
            try:
                out = fn(*fa, **fk)
            except RuntimeError as e:
                if hold:
                    held["error"] = repr(e)
                raise
            finally:
                if hold:
                    torch.cuda.set_sync_debug_mode(0)
            ev[1].record()
            if hold:
                held["ok"] = True
            chunk_ev.append(ev)
            return out

        return run

    spec_acc = torch.zeros(2, dtype=torch.long, device=engine.device)  # (emitted, row-steps)
    real_emit = gen_mod._spec_emit

    def spec_emit(*a, **k):
        out = real_emit(*a, **k)
        gen0, gen1 = a[9], out[2]  # gen_count before and after the step
        emitted = gen1 - gen0
        spec_acc.add_(torch.stack([emitted.sum(), (emitted > 0).sum()]))
        return out

    engine.generate = generate
    setattr(engine, getter_name, getter)
    gen_mod._spec_emit = spec_emit
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = engine.steps_total
        _reset_counts()
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed,
                                          greedy=True, **gkw)
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _trial_counts()
        steps = engine.steps_total - steps0
        peak = torch.cuda.max_memory_allocated()
    finally:
        gen_mod._spec_emit = real_emit
        server.close()
    check(held.get("ok") and "error" not in held,
          f"[genmodes] {name}: a decode chunk synchronised with the host: {held}")
    check(not errors and all(r is not None for r in replies),
          f"[genmodes] {name}: requests failed: {errors[:3]}")
    n_tok, outputs = 0, []
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"[genmodes] {name} q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"[genmodes] {name} q{i}: {len(ids)} tokens")
            check(len(ids) == max_new or ids[-1] == 151643,
                  f"[genmodes] {name} q{i}: short without EOS")
            check(len(lps) == len(ids), f"[genmodes] {name} q{i}: logprobs/ids lengths")
            check(all(math.isfinite(x) and x <= 1e-6 for x in lps),
                  f"[genmodes] {name} q{i}: bad logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"[genmodes] {name} q{i}: bad id")
            n_tok += len(ids)
        outputs.append(r["output_ids"])
    prefill = sum(c["prefill_dispatches"] for c in calls)
    L = cfg.n_layers
    want = dict(fwd=L * prefill, dq=0, dkv=0, k2=0, k3=0, k4=0)
    want[kernel] = L * steps
    chunk_ms = sum(a.elapsed_time(b) for a, b in chunk_ev)
    emitted, row_steps = (int(x) for x in spec_acc.tolist())
    K = gkw.get("spec_decode_k", 0)
    out = dict(
        requests=len(prompts), n=n, max_new_tokens=max_new, generate_calls=len(calls),
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall, steps=steps,
        chunks=len(chunk_ev), chunk_s=chunk_ms / 1e3, decode_step_ms=chunk_ms / max(steps, 1),
        prefill_dispatches=prefill,
        cache_copy_bytes=sum(c["cache_copy_bytes"] for c in calls),
        decode_compiles=sum(c["decode_compiles"] for c in calls),
        launches=counts, peak_mem_bytes=peak, outputs=outputs,
    )
    if K:
        out.update(tokens_per_spec_step=emitted / max(row_steps, 1),
                   acceptance=(emitted - row_steps) / max(K * row_steps, 1))
    log(f"[genmodes] {name}: {len(prompts)} requests x n={n} greedy{f' K={K}' if K else ''}: "
        f"{n_tok} tokens in {wall:.2f} s = {out['tokens_per_s']:.1f} tok/s; {steps} decode "
        f"steps in {len(chunk_ev)} chunks, {out['decode_step_ms']:.3f} ms a step (CUDA events "
        f"around each chunk); prefill dispatches {prefill}; cache copy bytes "
        f"{out['cache_copy_bytes']}; chunk builds {out['decode_compiles']}; generate calls "
        f"{len(calls)}; launches {counts}; peak mem {peak / 2**30:.2f} GiB"
        + (f"; {out['tokens_per_spec_step']:.3f} tokens a verify step, acceptance "
           f"{out['acceptance']:.3f}" if K else ""))
    check(counts == want, f"[genmodes] {name}: launches {counts} != {want}")
    check(steps > 0 and counts[kernel] > 0, f"[genmodes] {name}: the mode ran no decode step")
    check(all(c["dead_live_lanes"] == 0 for c in calls), f"[genmodes] {name}: dead live lanes")
    log(f"[genmodes] {name}: chunk 2 of {len(chunk_ev)} ran under "
        f"set_sync_debug_mode('error'): no host sync")
    del engine.generate, server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _agreement(a, b):
    """Token agreement of two runs' outputs as tests/test_generator.py:316
    counts it (prompt + response of every sequence, positionally, where
    the lengths match), and over the responses alone."""
    import numpy as np

    same = total = r_same = r_total = 0
    first_flip = []
    for (prompt, outs_a), outs_b in zip(a, b):
        for x, y in zip(outs_a, outs_b):
            m = min(len(x), len(y))
            eq = np.asarray(x[:m]) == np.asarray(y[:m])
            r_same, r_total = r_same + int(eq.sum()), r_total + max(len(x), len(y))
            same, total = same + len(prompt) + int(eq.sum()), total + len(prompt) + max(len(x), len(y))
            first_flip.append(int(np.argmin(eq)) if not eq.all() else m)
    return same / total, r_same / r_total, first_flip


def _teacher_forced(cfg, params, prompts, outputs, paged):
    """Greedy tokens of the bf16 and of the int8 model along the bf16
    run's responses (each prompt's first), teacher-forced through the
    engine's own forwards: one batched prefill (K1f), then one decode step
    a position (dense: `decode_step_inflight`, K4; paged:
    `decode_step_paged`, K3) fed the bf16 run's token.  Returns (the
    fraction of response positions where the int8 model's token equals
    the bf16 model's, the fraction where the bf16 model's equals the bf16
    run's own)."""
    import numpy as np
    import torch

    from areal_tpu_torch.models import transformer as tfm

    dev = params["embed"].device
    b = len(prompts)
    resp = [o[0] for o in outputs]
    n_new = min(len(r) for r in resp)
    plens = np.array([len(p) for p in prompts])
    sp = 128 * -(-int(plens.max()) // 128)
    rows = np.zeros((b, sp), np.int64)
    for i, p in enumerate(prompts):
        rows[i, : len(p)] = p
    rows_d, plens_d = torch.from_numpy(rows).to(dev), torch.from_numpy(plens).to(dev)
    resp_d = torch.tensor([r[:n_new] for r in resp], device=dev)
    mp = -(-(sp + n_new) // 128)
    preds = []
    with torch.no_grad():
        for dtype in (torch.bfloat16, "int8"):
            if paged:
                kv = tfm.init_paged_kv_cache(cfg, b * mp, 128, dtype=dtype, device=dev)
                table = torch.arange(b * mp, device=dev).reshape(b, mp)
                logits, _ = tfm.prefill_into_pages(params, cfg, rows_d, plens_d, kv,
                                                   table[:, : sp // 128])
            else:
                kv = tfm.init_kv_cache(cfg, b, sp + n_new, dtype=dtype, device=dev)
                logits, _ = tfm.prefill_into_slots(params, cfg, rows_d, plens_d, kv,
                                                   torch.arange(b))
            out = [logits.argmax(-1)]
            for t in range(n_new - 1):
                tok, pos = resp_d[:, t], plens_d + t
                if paged:
                    logits, _ = tfm.decode_step_paged(params, cfg, tok, pos, kv, table, pos,
                                                      pos + 1)
                else:
                    logits, _ = tfm.decode_step_inflight(params, cfg, tok, pos, kv, slots=pos,
                                                         valid_to=pos + 1)
                out.append(logits.argmax(-1))
            preds.append(torch.stack(out, 1).cpu().numpy())
            del kv
    run = np.asarray([r[:n_new] for r in resp])
    return float((preds[0] == preds[1]).mean()), float((preds[0] == run).mean())


def _genmode_quickstart(seed):
    """(e) One `quickstart ppo-math` step at qwen2-1.5B with
    --no-paged-kv --spec-decode-k 4 --kv-cache-dtype int8: generate takes
    the dense window's spec path over an int8 cache.  8 prompts x 4
    responses, 128 new tokens, rewards replaced by seeded +-5 (a random
    model's are all -5).  Launches: K4 = 28 x the inflight decode steps,
    K1f = 28 x (prefill dispatches + 2 train forwards a micro-batch + the
    train engine's forward micro-batches), K1dq = K1dkv = 28 x train
    micro-batches, K2 = K3 = 0."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config

    cfg = qwen2_config("1.5b")
    rng = np.random.default_rng(seed + 50)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="genmodes-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    try:
        _check_disk("[genmodes]", work, _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, _, _ = _write_random_checkpoint("[genmodes]", work, cfg, seed + 51)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(rng, 16):
                f.write(json.dumps(row) + "\n")
        rec = {"steps": [], "loads": [], "saves": []}
        cur = {}
        _record_trial_steps(wrap, rec, cur)
        modes = []

        def on_generate(orig):
            @functools.wraps(orig)
            def generate(self, *a, **k):
                s0 = self.steps_total
                out = orig(self, *a, **k)
                cur["inflight_steps"] = cur.get("inflight_steps", 0) + self.steps_total - s0
                cur["prefill"] = cur.get("prefill", 0) + self.prefill_dispatches
                return out
            return generate

        def on_spec(orig):
            @functools.wraps(orig)
            def spec(self, *a, **k):
                modes.append((self.kv_paged, self.kv_cache_dtype))
                return orig(self, *a, **k)
            return spec

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                out.data["rewards"] = rng.choice(
                    [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
                return out
            return inference

        wrap(GeneratorEngine, "generate", on_generate)
        wrap(GeneratorEngine, "_generate_inflight_spec", on_spec)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--batch-size", "8",
            "--group-size", "4", "--max-new-tokens", "128", "--benchmark-steps", "1",
            "--fileroot", os.path.join(work, "trial"), "--seed", str(seed + 52),
            "--no-paged-kv", "--spec-decode-k", "4", "--kv-cache-dtype", "int8",
        ]
        log(f"[genmodes] (e) python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t = time.monotonic()
            stats = quickstart.main(argv)
            torch.cuda.synchronize()
            trial_s = time.monotonic() - t
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)
        check(len(stats) == 1 and len(rec["steps"]) == 1, f"[genmodes] (e): {len(stats)} steps")
        check(modes == [(False, "int8")], f"[genmodes] (e): spec path calls {modes}")
        st, s = rec["steps"][0], stats[0]
        check(all(math.isfinite(v) for v in s.values()), "[genmodes] (e): non-finite stats")
        L, mbs = cfg.n_layers, sum(c["mbs"] for c in st["train_calls"])
        want = dict(fwd=L * (st["prefill"] + 2 * mbs + st["train_fwd_mbs"]), dq=L * mbs,
                    dkv=L * mbs, k2=0, k3=0, k4=L * st["inflight_steps"])
        log(f"[genmodes] (e) 1 step: {s['time/step_s']:.2f} s (generate "
            f"{s.get('actor_gen/perf/time_s', float('nan')):.2f} s); {st['inflight_steps']} "
            f"dense spec decode steps, {st['prefill']} prefill dispatches, {mbs} train "
            f"micro-batches; launches {st['launches']}; peak {st['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB; trial {trial_s:.1f} s")
        check(st["launches"] == want and total == want and want["k4"] > 0,
              f"[genmodes] (e): launches {st['launches']} (trial {total}) != {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return dict(step_s=s["time/step_s"], generate_s=s.get("actor_gen/perf/time_s"),
                decode_steps=st["inflight_steps"], prefill_dispatches=st["prefill"],
                launches=total, peak_mem_bytes=st["peak_mem_bytes"], trial_s=trial_s)


def phase_genmodes(report, seed):
    """The serve phase's burst cut to its first 8 prompts (64-512 tokens,
    n=4: 32 requests, 128 new tokens, greedy) through GenerationServer at
    full qwen2-1.5B in bf16, in each inflight mode of GENMODES with 16
    slots (two waves, so admissions and retirements cycle): (a) the dense
    window in bf16 and with an int8 cache, (b) dense spec K=4, (c) the
    two-program paged path in bf16 and int8, (d) spec K=4 on the serving
    plane; then (e) one
    quickstart ppo-math step with --no-paged-kv --spec-decode-k 4
    --kv-cache-dtype int8.  Checked per mode: the replies, the launches
    (K4 = 28 x decode steps in (a) and (b), K2 = 28 x decode steps in (c)
    and 28 x inner steps in (d), K1f = 28 x prefill dispatches, every
    other kernel 0), no host sync inside a chunk; int8 against bf16 token
    agreement >= 0.85 teacher-forced along the bf16 run (`_teacher_forced`;
    the free-running count of tests/test_generator.py:316 is printed)."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = qwen2_config("1.5b")
    n_req, n, max_new = 8, 4, 128
    rng = np.random.default_rng(seed)
    prompts = [  # the serve phase's prompts, its first n_req of 16
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(16)
    ][:n_req]
    t_phase = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    modes = {}
    for name, ekw, gkw, kernel in GENMODES:
        modes[name] = _genmode_run(name, cfg, params, prompts, n, max_new, ekw, gkw,
                                   kernel, seed + 60)
    # int8 against bf16.  Free-running greedy outputs diverge for good at
    # their first near-tie flip (random weights give nearly flat logits),
    # so they are counted for the record; the check is the
    # teacher-forced agreement, token by token along the bf16 run.
    agreement = {}
    for bf, q8, paged in (("dense", "dense_int8", False), ("paged2", "paged2_int8", True),
                          ("dense", "paged2", None)):
        packed, resp, flips = _agreement(
            list(zip(prompts, modes[bf]["outputs"])), modes[q8]["outputs"])
        agreement[q8 if paged is not None else "paged2_vs_dense"] = rec = dict(
            packed=packed, responses=resp, first_flip_median=float(np.median(flips)))
        log(f"[genmodes] {q8} against {bf}, free-running greedy: token agreement "
            f"{packed:.4f} over prompt + response (tests/test_generator.py:316's count), "
            f"{resp:.4f} over the responses; first differing response position: median "
            f"{int(np.median(flips))}, min {min(flips)} of {max_new}")
        if paged is None:
            continue
        tf, tf_self = _teacher_forced(cfg, params, prompts, modes[bf]["outputs"], paged)
        rec.update(teacher_forced=tf, bf16_reproduced=tf_self)
        log(f"[genmodes] {q8} against {bf}, teacher-forced along the {bf} run's responses: "
            f"token agreement {tf:.4f}; the bf16 model's own tokens reproduced at {tf_self:.4f}")
        check(tf >= INT8_AGREEMENT, f"[genmodes] {q8}: teacher-forced agreement {tf} < "
              f"{INT8_AGREEMENT}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    quick = _genmode_quickstart(seed)
    launches = {k: sum(m["launches"][k] for m in modes.values()) + quick["launches"][k]
                for k in quick["launches"]}
    secs = time.monotonic() - t_phase
    log(f"[genmodes] launches over the phase {launches}; {secs:.1f} s")
    for m in modes.values():
        m.pop("outputs")
    report["genmodes"] = dict(modes=modes, agreement=agreement, quickstart=quick,
                              launches=launches, seconds=secs)


def _flat_params(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_params(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _worst(vals):
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def _kernels_line(report):
    qs_launches = report.get("quickstart", {}).get("launches", {})
    rc_launches = report.get("recover", {}).get("launches", {})
    gm_launches = report.get("genmodes", {}).get("launches", {})
    k = report.get("kernel", {})
    s = report.get("serve", {})
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "areal_tpu/ops/pallas/paged_attention.py:276",
        "launches": s.get("launches"),
        "launches_quickstart": qs_launches.get("k2"),
        "launches_recover": rc_launches.get("k2"),
        "launches_genmodes": gm_launches.get("k2"),
        "launches_push_int8": report.get("push_int8", {}).get("k2_launches"),
        "max_abs_err": k.get("max_abs_err", {}).get("bf16"),
        "max_abs_err_split": k.get("max_abs_err", {}).get("bf16_split"),
        "max_abs_err_fp32": k.get("max_abs_err", {}).get("fp32"),
        "max_abs_err_int8": k.get("max_abs_err", {}).get("int8"),
        "ms": k.get("kernel_ms"),
        "eager_ms": k.get("kernel_eager_ms"),
        "plain_ms": k.get("plain_ms"),
        "plain_eager_ms": k.get("plain_eager_ms"),
        "bound_ms": k.get("bound_ms"),
        "bound_by": k.get("bound_by"),
        "library_ms": k.get("library_ms"),
        "library_eager_ms": k.get("library_eager_ms"),
    }]
    k8 = k.get("bf16q_int8")
    if k8:  # bf16 q over an int8 pool: the tensor-core int8 path
        errs = k.get("max_abs_err", {})
        kernels[-1].update({
            "bf16q_int8_max_abs_err": errs.get("bf16q_int8"),
            "bf16q_int8_row_err": errs.get("bf16q_int8_row"),
            "bf16q_int8_model_err": errs.get("bf16q_int8_model"),
            "bf16q_int8_ms": k8["kernel_ms"], "bf16q_int8_eager_ms": k8["kernel_eager_ms"],
            "bf16q_int8_plain_ms": k8["plain_ms"], "bf16q_int8_library_ms": k8["library_ms"],
            "bf16q_int8_bound_ms": k8["bound_ms"], "bf16q_int8_bound_by": k8["bound_by"],
        })
    f = report.get("flash", {})
    train = report.get("train", {})
    launches = train.get("launches", {})
    ppo_launches = report.get("ppo", {}).get("launches", {})
    at_train = train.get("steps", [{}])[0].get("train_shape_errs", {})
    outputs = {"fwd": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}
    for name, line in (("fwd", 170), ("dq", 355), ("dkv", 380)):
        errs = f.get("max_abs_err", {})
        bound = f.get("bounds", {}).get(name, (None, None))
        t = f.get("times", {}).get(name, {})
        entry = {
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"areal_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": launches.get(name),
            "launches_ppo": ppo_launches.get(name),
            "launches_quickstart": qs_launches.get(name),
            "launches_recover": rc_launches.get(name),
            "launches_genmodes": gm_launches.get(name),
            "max_abs_err": _worst(errs.get(f"bf16_{o}") for o in outputs[name]),
            "row_err": _worst(errs.get(f"bf16_{o}_row") for o in outputs[name]),
            "max_abs_err_fp32": _worst(errs.get(f"fp32_{o}") for o in outputs[name]),
            "row_err_fp32": _worst(errs.get(f"fp32_{o}_row") for o in outputs[name]),
            "row_err_train_shape": _worst(
                at_train[o][0] if o in at_train else None for o in outputs[name]
            ),
            "row_err_edges": _worst(errs.get(f"edges_bf16_{o}") for o in outputs[name]),
            "row_err_edges_model": _worst(
                errs.get(f"edges_bf16_{o}_model") for o in outputs[name]),
            "row_err_model": _worst(errs.get(f"bf16_{o}_model_row") for o in outputs[name]),
            "ms": t.get("kernel_ms"),
            "eager_ms": t.get("kernel_eager_ms"),
            "plain_ms": t.get("plain_ms"),
            "plain_eager_ms": t.get("plain_eager_ms"),
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": t.get("library_ms"),
            "library_eager_ms": t.get("library_eager_ms"),
        }
        if name == "fwd":  # lse against the dense logsumexp and the model
            entry["lse_err_edges"] = _worst(errs.get(f"edges_{d}_lse") for d in ("bf16", "fp32"))
            entry["lse_err_model"] = errs.get("bf16_lse_model")
        kernels.append(entry)
    k3 = report.get("k3", {})
    errs = k3.get("max_abs_err", {})
    kernels.append({
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/paged_chunk_attention.cu",
        "replaces": "areal_tpu/ops/pallas/paged_attention.py:194",
        "launches": report.get("push", {}).get("launches"),
        "launches_push_int8": report.get("push_int8", {}).get("launches"),
        "launches_quickstart": qs_launches.get("k3"),
        "launches_recover": rc_launches.get("k3"),
        "launches_genmodes": gm_launches.get("k3"),
        "max_abs_err": errs.get("bf16"),
        "row_err": errs.get("bf16_row"),
        "max_abs_err_fp32": errs.get("fp32"),
        "row_err_fp32": errs.get("fp32_row"),
        "max_abs_err_int8": errs.get("int8"),
        "row_err_int8": errs.get("int8_row"),
        "row_err_tiled": errs.get("bf16_tiled_row"),
        "row_err_edges": _worst(errs.get(f"edges{n}_bf16_row") for n in (13, 1)),
        "ms": k3.get("kernel_ms"),
        "eager_ms": k3.get("kernel_eager_ms"),
        "plain_ms": k3.get("plain_ms"),
        "plain_eager_ms": k3.get("plain_eager_ms"),
        "bound_ms": k3.get("bound_ms"),
        "bound_by": k3.get("bound_by"),
        "library_ms": k3.get("library_ms"),
        "library_eager_ms": k3.get("library_eager_ms"),
    })
    c8 = k3.get("bf16q_int8")
    if c8:  # the chunk form, bf16 q over an int8 pool, at the replay shape
        kernels[-1].update({
            "bf16q_int8_row_err": c8["row_err"], "bf16q_int8_row_err_tiled": c8["row_err_tiled"],
            "bf16q_int8_row_err_edges": _worst(
                errs.get(f"edges{n}_bf16q_int8_row") for n in (13, 1)),
            "bf16q_int8_model_err": _worst([c8["model_err"]] + [
                errs.get(f"edges{n}_bf16q_int8_model") for n in (13, 1)]),
            "bf16q_int8_ms": c8["kernel_ms"], "bf16q_int8_eager_ms": c8["kernel_eager_ms"],
            "bf16q_int8_plain_ms": c8["plain_ms"], "bf16q_int8_library_ms": c8["library_ms"],
            "bf16q_int8_bound_ms": c8["bound_ms"], "bf16q_int8_bound_by": c8["bound_by"],
        })
    # The Q=1 entry point (decode_step_paged) runs K2's kernel: its
    # numbers stand on this row, its launches on K2's.
    for b, q1 in k3.get("q1", {}).items():
        e8 = q1.get("bf16q_int8", {})
        kernels[-1].update({
            f"q1_b{b}_route": "ragged_paged_attention",
            f"q1_b{b}_max_abs_err": q1["max_abs_err"].get("bf16_q1"),
            f"q1_b{b}_row_err": q1["max_abs_err"].get("bf16_q1_row"),
            f"q1_b{b}_row_err_int8": q1["max_abs_err"].get("int8_q1_row"),
            f"q1_b{b}_row_err_bf16q_int8": q1["max_abs_err"].get("bf16q_int8_q1_row"),
            f"q1_b{b}_model_err_bf16q_int8": q1["max_abs_err"].get("bf16q_int8_q1_model"),
            f"q1_b{b}_ms": q1["kernel_ms"], f"q1_b{b}_eager_ms": q1["kernel_eager_ms"],
            f"q1_b{b}_plain_ms": q1["plain_ms"], f"q1_b{b}_library_ms": q1["library_ms"],
            f"q1_b{b}_bound_ms": q1["bound_ms"], f"q1_b{b}_bound_by": q1["bound_by"],
            f"q1_b{b}_bf16q_int8_ms": e8.get("kernel_ms"),
            f"q1_b{b}_bf16q_int8_eager_ms": e8.get("kernel_eager_ms"),
            f"q1_b{b}_bf16q_int8_plain_ms": e8.get("plain_ms"),
            f"q1_b{b}_bf16q_int8_library_ms": e8.get("library_ms"),
            f"q1_b{b}_bf16q_int8_bound_ms": e8.get("bound_ms"),
        })
    k4 = report.get("k4", {})
    errs = k4.get("max_abs_err", {})
    kernels.append({
        "name": "decode_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/decode_attention.cu",
        "replaces": "areal_tpu/ops/pallas/decode_attention.py:145",
        "launches": report.get("static", {}).get("launches"),
        "launches_quickstart": qs_launches.get("k4"),
        "launches_recover": rc_launches.get("k4"),
        "launches_genmodes": gm_launches.get("k4"),
        "max_abs_err": errs.get("bf16_decode"),
        "row_err": errs.get("bf16_decode_row"),
        "max_abs_err_fp32": errs.get("fp32_decode"),
        "row_err_fp32": errs.get("fp32_decode_row"),
        "max_abs_err_int8": errs.get("int8_decode"),
        "row_err_int8": errs.get("int8_decode_row"),
        "row_err_split": errs.get("bf16_decode_split_row"),
        "row_err_bf16q_int8": _worst(v for key, v in errs.items()
                                     if key.startswith("bf16q_int8_") and key.endswith("_row")
                                     and not key.endswith("split_row")),
        "model_err_bf16q_int8": _worst(v for key, v in errs.items()
                                       if key.startswith("bf16q_int8_")
                                       and key.endswith("_split_row")),
        "ms": k4.get("kernel_ms"),
        "eager_ms": k4.get("kernel_eager_ms"),
        "plain_ms": k4.get("plain_ms"),
        "plain_eager_ms": k4.get("plain_eager_ms"),
        "bound_ms": k4.get("bound_ms"),
        "bound_by": k4.get("bound_by"),
        "library_ms": k4.get("library_ms"),
        "library_eager_ms": k4.get("library_eager_ms"),
        "b64_ms": k4.get("b64", {}).get("kernel_ms"),
        "b64_library_ms": k4.get("b64", {}).get("library_ms"),
        "b64_bound_ms": k4.get("b64", {}).get("bound_ms"),
    })
    for tag in ("int8_q1", "int8_q5", "q5"):  # the dense inflight window's forms
        f = k4.get(tag)
        if f:
            kernels[-1].update({
                f"{tag}_max_abs_err": f["max_abs_err"], f"{tag}_row_err": f["row_err"],
                f"{tag}_model_err": f["model_err"],
                f"{tag}_ms": f["kernel_ms"], f"{tag}_eager_ms": f["kernel_eager_ms"],
                f"{tag}_plain_ms": f["plain_ms"], f"{tag}_library_ms": f["library_ms"],
                f"{tag}_bound_ms": f["bound_ms"], f"{tag}_bound_by": f["bound_by"],
            })
    return kernels


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
    report = {}  # each phase's numbers for the kernels line
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        phase_kernel(report, args.seed)
    if "flash" in phases:
        phase_flash(report, args.seed)
    if "serve" in phases:
        phase_serve(report, args.seed)
    if "static" in phases:
        phase_static(report, args.seed)
    if "push" in phases:
        phase_push(report, args.seed)
    if "resume_parity" in phases:
        phase_resume_parity(report, args.seed)
    if "train" in phases:
        phase_train(report, args.seed)
    if "ppo" in phases:
        phase_ppo(report, args.seed)
    if "quickstart" in phases:
        phase_quickstart(report, args.seed)
    if "recover" in phases:
        phase_recover(report, args.seed)
    if "genmodes" in phases:
        phase_genmodes(report, args.seed)
    if "parity" in phases:
        phase_parity(args.seed)
    if "train_parity" in phases:
        phase_train_parity(args.seed)
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    log_card()  # again here: a long run's output may keep only its tail
    print(json.dumps({"kernels": _kernels_line(report)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
