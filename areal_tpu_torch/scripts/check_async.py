#!/usr/bin/env python
"""Asynchronous-RL and chaos checks of the PyTorch port, leg by leg (a
port of the JAX package's scripts/check_async.py, its flags and parts).

    python -m areal_tpu_torch.scripts.check_async [--model tiny|qwen2-1.5b]
        [--layers N] [--device cuda|cpu] [--prompts 24] [--versions 3]
        [--dir DIR] [--chaos | --trainer-chaos | --nan-chaos | --push-chaos
         | --verifier-chaos | --agents | --overlap]

The device defaults to the CUDA card; without one, and without
``--device cpu``, the script exits non-zero and names the missing device
(it never falls back to the CPU).  The port's kernels take head_dim 64
or 128 only (ROADMAP queue 1 item 9) and ``tiny`` has 16, so on the card
the model is qwen2-1.5B's width (``--layers`` cuts its depth) and
``--model tiny`` is refused.  On the CPU every comparison said to be
bit for bit runs on one thread (the multi-threaded CPU kernels reduce in
a varying order).

Part 1 (the default run, with part 2) drives the serving plane: a
RolloutController pumps prompts through a GenerationServer into a
staleness-bounded ReplayBuffer while a fake trainer consumes batches and
pushes fresh weights in memory between steps.  Checked: >= 3 weight
versions fed; a request interrupted by a push and resumed on its KV pages
(`resume_replays`), finishing under a newer version than it started; the
max_head_offpolicyness bound on every consumed trajectory.

Part 2: a tiny PPO trial through the master's replay-driven pipeline
with max_head_offpolicyness=1 (decoupled-PPO stats in the step stats),
then cap 0 against the synchronous trial: stats and final weights bit
for bit.

Part 3 (``--chaos``): three generation servers join by fleet discovery,
one is killed mid-decode by ``AREAL_FAULTS=kill@t=...``; zero lost
prompts, the staleness bound, the dead server's breaker opening and
closing again after a restart on the same port, at least one
redispatched prompt, the victim's flight dump (rendered by
``trace_report --flight``) and >= 95% of the consumed trajectories
joined dispatch -> trained in the merged trace.

Part 4 (``--overlap``): the tiny PPO trial four ways (barrier,
``pipeline_overlap`` window 1, window 3 with 2-seq chunks, a short
window-3 run), the reward carrying a per-sequence latency.  Window 1
equals the barrier bit for bit; the overlapped steady step beats the
barrier's; the per-stage idle (``trace_report.pipeline_rows``) shrinks;
overlap_frac is ~0 serial and positive overlapped.  For the JAX leg's
equal jit trace and compile counters of the 2-step and 6-step
overlapped runs, the port holds per step equal: the flash kernels'
launches (0 on the CPU, where every wrapper takes its plain version)
and ``areal_gen_decode_compiles_total`` (the generator's chunk builds).

Part 5 (``--trainer-chaos``): a 4-step tiny PPO trial with a recover
checkpoint every step.  (a) ``hang@point=mfc_train_step`` on the third
train MFC: the master's ``mfc_timeout_s`` declares the worker dead,
relaunches it, rolls back and resumes; one recovery, the dead / timeout /
recoveries counters each +1, the stats and final weights bit for bit
the fault-free run's.  (b) a subprocess victim (the hidden
``--trainer-chaos-victim``) killed at ``kill@point=recover_stage``
(exit 42) between staging and flipping its second save: step 1's
checkpoint stays manifest-valid, a clean restart resumes from it, ends
at the last step and leaves no stale stage.  (c) the current checkpoint
torn: the fallback to ``.prev``, and a third restart exits 0.

Part 6 (``--nan-chaos``): (a) ``nan@point=train_grads`` poisons a train
step's gradients: the step is quarantined with the masters, Adam's
moments and its count bit for bit unchanged, one host transfer a train
call, the same flash launches as the clean step after it (for the JAX
leg's single apply trace), and the next, clean step trains; (b) a
two-step NaN streak in the tiny PPO trial under
max_consecutive_quarantines=2: 2 quarantined steps, 1 rollback, the
replayed steps and final weights bit for bit the fault-free run's, the
flash launches equal to it (for the JAX leg's flat trace counters);
(c) ``corrupt_push@point=weight_push`` corrupts an in-memory push: the
server's checksum refuses it (``areal_gen_weight_push_rejected_total``
+1, the version unchanged, a ``push_rejected`` flight dump), the retry
lands, and greedy tokens equal a control server's that got the same
weights cleanly.

Part 7 (``--agents``): multi-turn tool-use episodes on persistent KV
slots (every even token a one-token stop): after turn 1 a turn prefills
only its observation, every turn stays on one slot, the serving chunk is
built once across the episodes (``decode_compiles``, for the JAX leg's
one decode compile), each assistant turn equals a single-shot replay of
its transcript; a code episode runs its tool in the sandbox and is
graded by the sandboxed code backend; a push mid-episode parks the slot
and the episode resumes on it.

Part 8 (``--push-chaos``): five discovered servers take a clean
broadcast-tree push (v1); the first relay is killed mid-broadcast
(``kill@point=param_push&skip=1``) during v2.  Zero torn versions
(every live server's params verify against the checksum of the version
it reports; laggards serve v1), the kill orphans exactly the victim's
subtree, the store keeps v1 through the orphans' pins, the victim's
flight dump renders; after a restart ``BroadcastFabric.repair()``
catches the laggards up and v3 converges all five.

Part 9 (``--verifier-chaos``): (a) three announced verifiers grade
continuous batches through a VerifierPool while one is killed mid-grade:
zero lost grades, a redispatch, the victim's breaker opening, its key
expiring, the supervisor's verifier lane refilling the pool, the
breaker closing again on the replacement, the victim's flight dump;
(b) a task mixture (math 2 : code 1) through the RolloutController,
graded through a 2-worker pool by the RewardFabric: namespaced qids,
per-task reward curves and fleet signals, per-task watermarks and
lineage; (c) one backend 10x slower: dispatch throughput holds.

Each leg is a function ``check_<leg>(cfg, device, ...)`` that returns its
failures (a list of strings); the parts of nan-chaos and trainer-chaos
are functions of their own, so a caller can run one in its own process.
``--bench-out`` (the CPU bench rows of the JAX script) is not ported.
Exit 0 iff every check passes.
"""

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import glob
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODELS = ("tiny", "qwen2-1.5b")
# The stats held bit for bit between two trials.
TRAIN_KEYS = (
    "actor_train/loss", "actor_train/actor_loss",
    "actor_train/approx_kl", "actor_train/importance_weight",
    "actor_train/grad_norm", "actor_train/task_reward",
)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def model_config(name: str, layers: Optional[int] = None):
    """`tiny_config()` or qwen2-1.5B's config, its depth cut to `layers`."""
    from areal_tpu_torch.models.config import qwen2_config, tiny_config

    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (one of {MODELS})")
    cfg = tiny_config() if name == "tiny" else qwen2_config("1.5b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    return cfg


def make_tokenizer(cfg):
    from areal_tpu_torch.data.tokenizer import CharTokenizer

    return CharTokenizer(vocab_size=cfg.vocab_size)


def build_math_rows(n: int = 16, seed: int = 0) -> List[Dict]:
    """`n` math prompts "Compute a + b." with their boxed answers."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        a, b = rng.randint(1, 50), rng.randint(1, 50)
        rows.append({
            "query_id": f"math-{i}",
            "prompt": f"Compute {a} + {b}. ",
            "task": "math",
            "solutions": [f"\\boxed{{{a + b}}}"],
        })
    return rows


def random_sample(rng: np.random.Generator, ids, keys=("packed_input_ids",), max_len=20):
    """A random SequenceSample with the given ids and keys."""
    from areal_tpu_torch.api.data_api import SequenceSample

    seqlens = {k: [[int(rng.integers(1, max_len))] for _ in ids] for k in keys}
    data = {
        k: rng.integers(0, 100, size=sum(s[0] for s in seqlens[k])).astype(np.int32)
        for k in keys
    }
    return SequenceSample(keys=set(keys), ids=list(ids), seqlens=seqlens, data=data)


def metric_value(name: str) -> float:
    """A series' value summed over its labels, from the default registry."""
    from areal_tpu_torch.base import metrics

    total = 0.0
    for line in metrics.default_registry().expose().splitlines():
        if line.startswith(f"{name} ") or line.startswith(f"{name}{{"):
            total += float(line.rsplit(" ", 1)[1])
    return total


def leaves(tree) -> List[torch.Tensor]:
    from areal_tpu_torch.base import integrity

    return integrity._leaves(tree)


def max_diff(a, b) -> float:
    """The largest absolute difference between two trees' leaves."""
    return max(
        float((x.detach().float() - y.detach().float().to(x.device)).abs().max())
        for x, y in zip(leaves(a), leaves(b))
    )


def snapshot(tree) -> List[torch.Tensor]:
    """Copies of a tree's leaves where they lie (a train step updates its
    masters in place)."""
    return [x.detach().clone() for x in leaves(tree)]


def same(a: List[torch.Tensor], tree) -> bool:
    """Whether `tree`'s leaves equal the snapshot `a` bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, leaves(tree)))


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far (0 on the CPU, where
    each wrapper takes its plain version)."""
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    return dict(fa.LAUNCHES, k4=da.LAUNCHES, k2=rpa.LAUNCHES, k3=pca.LAUNCHES)


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def unreachable_eos(cfg) -> int:
    """An EOS outside the vocab: every decode runs its whole window."""
    return cfg.vocab_size + 7


def _random_prompts(rng, cfg, n, size=6):
    return [[int(t) for t in rng.integers(8, cfg.vocab_size, size=size)] for _ in range(n)]


def ppo_config(cfg, fileroot: str, rows, *, mfc_timeout_s=None, actor_path=None, lr=5e-3,
               ckpt_freq_steps=1, max_consecutive_quarantines=3, max_new_tokens=8, **kw):
    """The deterministic tiny-PPO trial of the chaos legs: GRPO, batches of
    4 prompts x 2 responses, a recover checkpoint every step (by
    default).  The actor is random (seeded) or read from `actor_path`."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.experiments.common import PPOMathConfig
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    actor = (ModelAbstraction("hf", {"path": actor_path}) if actor_path
             else ModelAbstraction("random", {"config": cfg}))
    return PPOMathConfig(
        actor=actor,
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": {r["query_id"]: r for r in rows}},
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=max_new_tokens),
        ppo_kwargs={"n_minibatches": 1, "kl_ctl": 0.0},
        optimizer=OptimizerConfig(lr=lr, warmup_steps_proportion=0.0),
        batch_size=4,
        total_train_epochs=1,
        seed=1,
        mfc_timeout_s=mfc_timeout_s,
        worker_heartbeat_s=1.0,
        max_consecutive_quarantines=max_consecutive_quarantines,
        ctrl=ExperimentSaveEvalControl(ckpt_freq_steps=ckpt_freq_steps),
        fileroot=fileroot,
        **kw,
    )


def _actor(master):
    return master.pool.workers[0].models["actor@0"].engine


def _compare_stats(tag, want, got, failures) -> bool:
    ok = len(want) == len(got)
    if not ok:
        failures.append(f"{tag}: {len(got)} steps, the reference run {len(want)}")
    for t, (a, b) in enumerate(zip(want, got)):
        for k in TRAIN_KEYS:
            if a[k] != b[k]:
                ok = False
                failures.append(f"{tag} diverged at step {t}: {k} {b[k]} != {a[k]}")
    return ok


def _workers_under_faults(plan, tok, device, spec):
    """The plan's workers, built with `AREAL_FAULTS=spec` set around their
    construction only (the master's own injector stays empty)."""
    from areal_tpu_torch.system.transfer import InProcTransfer
    from areal_tpu_torch.system.worker import ModelWorker

    planes = InProcTransfer.make_group(len(plan.worker_configs))
    os.environ["AREAL_FAULTS"] = spec
    try:
        return [ModelWorker(wc, tokenizer=tok, device=device, transfer=planes[i])
                for i, wc in enumerate(plan.worker_configs)]
    finally:
        del os.environ["AREAL_FAULTS"]


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _print(tag, failures, ok_line):
    for f in failures:
        print(f"FAIL[{tag}]: {f}")
    if not failures:
        print(f"OK[{tag}]: {ok_line}")


# ---------------------------------------------------------------------------
# Part 1: the serving plane
# ---------------------------------------------------------------------------


def check_serving_plane(cfg, device, n_prompts: int = 24, n_versions: int = 3) -> List[str]:
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, LLMAPIClient
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController

    params = tfm.init_params(cfg, 0, device=device)
    # max_decode_batch=2 under 6-way concurrency forces the interruptible
    # inflight path; the unreachable EOS keeps every decode running its
    # window, so a push lands mid-flight.
    engine = GeneratorEngine(cfg, params, device, eos_token_id=unreachable_eos(cfg),
                             max_decode_batch=2)
    server = GenerationServer(engine, max_wait_ms=20.0)
    cap = 2
    replay = ReplayBuffer(capacity=8, max_head_offpolicyness=cap)
    client = LLMAPIClient(server.url, max_inflight=6)
    # 160 new tokens = 5 decode chunks a request: a push issued while
    # slots are live meets a chunk boundary before the run drains.
    ctl = RolloutController(
        [client], replay, GenerationHyperparameters(n=1, max_new_tokens=160),
        max_concurrency=6, backpressure_poll_s=0.01, autosize_inflight=False,
    )
    push_params = [tfm.init_params(cfg, 100 + i, device=device) for i in range(n_versions)]
    rng = np.random.default_rng(0)
    prompts = [(f"q{i}", p) for i, p in enumerate(_random_prompts(rng, cfg, n_prompts))]
    consumed, staleness_seen = [], []
    # The trainer gets its own executor: the controller's posts hold the
    # default executor's threads for whole decodes.
    trainer_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                         thread_name_prefix="trainer")

    async def drive():
        loop = asyncio.get_running_loop()
        pump = asyncio.create_task(ctl.run(prompts))
        pushes = 0
        try:
            while pushes < n_versions:
                trajs = await loop.run_in_executor(trainer_pool, replay.get_batch, 4, 60.0)
                for t in trajs:
                    staleness_seen.append(t.staleness(replay.version))
                consumed.extend(trajs)
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    if server.health_info()["live_slots"] > 0:
                        break
                    await asyncio.sleep(0.002)
                v = await loop.run_in_executor(
                    trainer_pool, server.update_weights_inmem, push_params[pushes])
                replay.set_version(v)
                pushes += 1
            # Then the trainer takes the rest of the stream: the port's
            # decode can fill the buffer with version-0 trajectories before
            # the first push, and what was dispatched after a push starts
            # under a newer head.
            while not pump.done() or len(replay) > 0:
                try:
                    trajs = await loop.run_in_executor(trainer_pool, replay.get_batch, 1, 0.2)
                except TimeoutError:
                    continue
                for t in trajs:
                    staleness_seen.append(t.staleness(replay.version))
                consumed.extend(trajs)
        finally:
            ctl.stop()
            await pump

    try:
        asyncio.run(drive())
    finally:
        server.close()
        trainer_pool.shutdown(wait=False)

    failures = []
    if server.version < n_versions:
        failures.append(f"expected >= {n_versions} weight versions, got {server.version}")
    if any(s > cap for s in staleness_seen):
        failures.append(f"trainer consumed staleness beyond the cap {cap}: "
                        f"{sorted(set(staleness_seen))}")
    if not consumed:
        failures.append("trainer consumed nothing")
    spanned = [t for t in consumed if t.version_end > t.version_start]
    if not spanned:
        failures.append("no trajectory finished under a newer version than it started")
    if engine.resume_replays < 1:
        failures.append(f"the engine never resumed an interrupted decode on its KV pages "
                        f"(resume_replays={engine.resume_replays})")
    head_versions = sorted({t.version_start for t in consumed})
    if len(head_versions) < 2:
        failures.append(f"consumed trajectories span too few head versions: {head_versions}")
    _print("serving", failures,
           f"{len(consumed)} trajectories consumed across head versions {head_versions} "
           f"(server at v{server.version}); {len(spanned)} interrupted and resumed "
           f"(resume_replays={engine.resume_replays}); staleness seen "
           f"{sorted(set(staleness_seen))} <= cap {cap}; controller stat {ctl.stat.as_dict()}")
    return failures


# ---------------------------------------------------------------------------
# Part 2: the trainer plane
# ---------------------------------------------------------------------------


def check_trainer_plane(cfg, device, fileroot: str) -> List[str]:
    from areal_tpu_torch.experiments.common import build_ppo_math, run_experiment

    tok = make_tokenizer(cfg)
    rows = build_math_rows(16, seed=7)

    def make(mho, sub):
        return ppo_config(cfg, os.path.join(fileroot, sub), rows, ckpt_freq_steps=None,
                          max_head_offpolicyness=mho)

    failures = []
    _, stats = run_experiment(build_ppo_math(make(1, "async"), tok), tokenizer=tok,
                              device=device)
    for s in stats:
        if not np.isfinite(s.get("actor_train/behav_imp_weight", np.nan)):
            failures.append("behav_imp_weight missing from the step stats")
            break
        if not 0.0 <= s.get("actor_train/behav_cap_clip", -1.0) <= 1.0:
            failures.append("behav_cap_clip missing or out of [0, 1]")
            break
        if s["replay/staleness"] > 1 or s["replay/rejected"] > 0:
            failures.append(f"staleness bound violated: {s['replay/staleness']} "
                            f"(rejected={s['replay/rejected']})")
            break
    if not any(s["replay/staleness"] == 1 for s in stats):
        failures.append("the pipeline never reached steady-state staleness 1")
    m_sync, s_sync = run_experiment(build_ppo_math(make(None, "sync"), tok), tokenizer=tok,
                                    device=device)
    m_cap0, s_cap0 = run_experiment(build_ppo_math(make(0, "cap0"), tok), tokenizer=tok,
                                    device=device)
    _compare_stats("cap=0 against sync", s_sync, s_cap0, failures)
    diff = max_diff(_actor(m_sync).get_params(), _actor(m_cap0).get_params())
    if diff != 0.0:
        failures.append(f"cap=0 final weights differ from sync by {diff}")
    _print("trainer", failures,
           f"async steps={len(stats)} with decoupled-PPO stats (behav_imp_weight last="
           f"{stats[-1].get('actor_train/behav_imp_weight', float('nan')):.6f}); cap=0 == sync "
           f"exactly over {len(s_sync)} steps (max param diff {diff})")
    return failures


# ---------------------------------------------------------------------------
# Part 3: the elastic fleet under a killed server
# ---------------------------------------------------------------------------


def check_chaos(cfg, device, n_prompts: int = 40, kill_after_s: float = 1.5,
                max_new_tokens: int = 256, params=None, engine_kw=None, on_engine=None,
                report: Optional[Dict] = None) -> List[str]:
    """Three announced servers, the first killed mid-decode by
    ``kill@t=kill_after_s`` from its environment; zero lost prompts.
    Traced: the victim leaves a flight dump with its last dispatch, and
    >= 95% of the consumed trajectories join dispatch -> trained.  The
    port's decode on the CPU is faster than the JAX package's, so its
    requests run 256 new tokens (the JAX leg's 64 finish before a kill
    at 2.5 s): the kill lands while the victim decodes."""
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.apps import trace_report
    from areal_tpu_torch.base import name_resolve, tracer
    from areal_tpu_torch.base.name_resolve import MemoryNameResolveRepository
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.fleet import CircuitBreaker, fleet_discovery
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController

    old_repo = name_resolve.default()
    name_resolve.set_default(MemoryNameResolveRepository())
    exp, trial = "chaos", "t0"
    failures = []
    trace_dir = tempfile.mkdtemp(prefix="areal_tpu_torch_chaos_trace_")
    os.environ["AREAL_TRACE_DIR"] = trace_dir
    tracer.configure(role="chaos", rank=0, dir=trace_dir, enabled=True, force=True)
    if params is None:
        params = tfm.init_params(cfg, 0, device=device)
    ekw = {"max_decode_batch": 2, **(engine_kw or {})}

    def make_engine():
        engine = GeneratorEngine(cfg, params, device, eos_token_id=unreachable_eos(cfg), **ekw)
        if on_engine is not None:
            on_engine(engine)  # a caller's hook: its settings, its counters
        return engine

    servers, victim = [], None
    for i in range(3):
        if i == 0:
            # The victim reads its fault from the environment, as a
            # server binary of a chaos run does.
            with _env(AREAL_FAULTS=f"kill@t={kill_after_s}s"):
                srv = GenerationServer(make_engine(), max_wait_ms=20.0)
            victim = srv
        else:
            srv = GenerationServer(make_engine(), max_wait_ms=20.0)
        # A long TTL: the crashed server's key outlives the dead window,
        # so the controller keeps its breaker (same identity).
        srv.announce(exp, trial, ttl=30.0)
        servers.append(srv)
    victim_sid, victim_port, victim_engine = f"s{victim.port}", victim.port, victim.engine

    cap = 2
    replay = ReplayBuffer(capacity=4, max_head_offpolicyness=cap)
    ctl = RolloutController(
        replay=replay,
        gconfig=GenerationHyperparameters(n=1, max_new_tokens=max_new_tokens),
        discovery=fleet_discovery(exp, trial),
        max_concurrency=6, health_refresh_s=0.3, backpressure_poll_s=0.01,
        autosize_inflight=False, dispatch_timeout_s=60.0, max_dispatch_retries=4,
        retry_backoff_s=0.05, health_poll_timeout_s=1.0, breaker_threshold=2,
        breaker_cooldown_s=1.0,
    )
    push_params = tfm.init_params(cfg, 100, device=device)
    rng = np.random.default_rng(0)
    prompts = [(f"q{i}", p) for i, p in enumerate(_random_prompts(rng, cfg, n_prompts))]
    consumed, staleness_seen = [], []
    chaos_done = asyncio.Event()
    restarted = {}

    async def wait_until(cond, timeout, what) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            await asyncio.sleep(0.1)
        failures.append(f"timeout waiting for {what}")
        return False

    async def consume(pump):
        loop = asyncio.get_running_loop()
        while not pump.done() or len(replay) > 0:
            # Throttled while the choreography plays out: prompts stay in
            # reserve for the breaker's close probe to ride on.
            if not chaos_done.is_set() and len(consumed) >= n_prompts // 3:
                k, pause = 1, 0.3
            else:
                k, pause = 2, 0.05
            if pump.done():
                k = 1  # get_batch(k) raises on a partial batch
            try:
                trajs = await loop.run_in_executor(None, replay.get_batch, k, 0.2)
            except TimeoutError:
                trajs = []
            for t in trajs:
                staleness_seen.append(t.staleness(replay.version))
            consumed.extend(trajs)
            await asyncio.sleep(pause)

    def restart_victim():
        # The engine is single-threaded: hand it on once the old
        # collector has exited.
        victim._collector_thread.join(timeout=60)
        srv = GenerationServer(victim_engine, port=victim_port, max_wait_ms=20.0,
                               version=replay.version)
        srv.announce(exp, trial, ttl=30.0)
        restarted["server"] = srv

    async def drive():
        pump = asyncio.create_task(ctl.run(prompts))
        consumer = asyncio.create_task(consume(pump))
        try:
            def breaker_open():
                st = ctl.server(victim_sid)
                return st is not None and st.breaker.opens >= 1

            if await wait_until(breaker_open, 120, "the breaker to open"):
                await asyncio.to_thread(restart_victim)

                def breaker_closed():
                    st = ctl.server(victim_sid)
                    return (st is not None and st.breaker.opens >= 1
                            and st.breaker.state == CircuitBreaker.CLOSED)

                if await wait_until(breaker_closed, 120, "the breaker to close again"):
                    alive = [s for s in servers if s is not victim] + [restarted["server"]]
                    v = 0
                    for s in alive:
                        v = await asyncio.to_thread(s.update_weights_inmem, push_params)
                    if v:
                        replay.set_version(v)
        finally:
            chaos_done.set()
            await pump
            await consumer

    try:
        asyncio.run(drive())
    finally:
        for s in servers[1:]:
            s.close()
        if "server" in restarted:
            restarted["server"].close()
        if not victim._crashed:
            victim.close()
        name_resolve.set_default(old_repo)

    stat = ctl.stat
    if stat.accepted + stat.rejected != n_prompts or stat.failed != 0:
        failures.append(f"prompt accounting broken: accepted {stat.accepted} + rejected "
                        f"{stat.rejected} != {n_prompts} dispatched (failed={stat.failed})")
    if stat.redispatched < 1:
        failures.append("the kill produced no redispatch")
    if any(s > cap for s in staleness_seen):
        failures.append(f"staleness bound violated: {sorted(set(staleness_seen))} vs cap {cap}")
    st = ctl.server(victim_sid)
    if st is None:
        failures.append(f"victim {victim_sid} lost from the fleet")
    else:
        if st.breaker.opens < 1:
            failures.append("the victim's breaker never opened")
        if st.breaker.state != CircuitBreaker.CLOSED:
            failures.append(f"the victim's breaker ended {st.breaker.state}, not closed")
    if len(ctl.servers) != 3:
        failures.append(f"expected 3 fleet members, the controller knows "
                        f"{[s.sid for s in ctl.servers]}")
    if ctl.membership_epoch < 1:
        failures.append("the membership epoch never advanced")
    if victim._faults is None or victim._faults.fired.get("kill", 0) < 1:
        failures.append("the AREAL_FAULTS kill never fired")

    flight_path = os.path.join(trace_dir, f"flightrec_gen_server_{victim_port}.json")
    if not os.path.exists(flight_path):
        failures.append(f"the killed victim left no flight dump at {flight_path}")
    else:
        with open(flight_path) as f:
            dump = json.load(f)
        events = dump.get("events", [])
        if dump.get("reason") != "fault_kill":
            failures.append(f"flight dump reason {dump.get('reason')!r} != 'fault_kill'")
        if not any(e.get("kind") == "kill" for e in events):
            failures.append("the flight dump's ring lacks the kill event")
        if not any(e.get("kind") == "dispatch" and e.get("sid") == victim_sid for e in events):
            failures.append("the flight dump lacks the victim's last dispatch")
    rendered = trace_report.format_flight(trace_dir, window_s=60.0)
    if rendered.startswith("no flightrec"):
        failures.append("trace_report --flight rendered no dumps")

    tracer.flush()
    trace = tracer.merge_shards(trace_dir, out_path=os.path.join(trace_dir, "trace.json"))
    os.environ.pop("AREAL_TRACE_DIR", None)
    errors = tracer.validate_trace(trace)
    if errors:
        failures.append(f"the merged chaos trace is invalid: {errors[:3]}")
    summary = trace_report.lineage_summary(trace)
    if summary["orphans"]:
        failures.append(f"orphan lineage traces: {summary['orphans'][:3]}")
    if summary["n"] != n_prompts:
        failures.append(f"expected {n_prompts} lineage roots, got {summary['n']}")
    if summary["complete"] < 0.95 * len(consumed):
        failures.append(f"lineage joined only {summary['complete']} of {len(consumed)} "
                        "consumed trajectories dispatch -> trained")
    accounted = (summary["complete"] + summary["in_flight"] + summary["rejected_stale"]
                 + summary["failed"])
    if accounted < summary["n"]:
        failures.append(f"{summary['n'] - accounted} of {summary['n']} lineage traces "
                        "neither complete, in flight, rejected nor failed")
    if report is not None:
        report.update(stat=stat.as_dict(), flight_path=flight_path, rendered=rendered,
                      lineage=summary, trace_dir=trace_dir,
                      opens=st.breaker.opens if st else 0,
                      closes=st.breaker.closes if st else 0)
    _print("chaos", failures,
           f"{n_prompts} prompts, zero lost (accepted={stat.accepted} rejected="
           f"{stat.rejected} failed={stat.failed} redispatched={stat.redispatched}); victim "
           f"{victim_sid} killed at t={kill_after_s}s, breaker opened and closed again; "
           f"staleness seen {sorted(set(staleness_seen))} <= cap {cap}; membership epoch "
           f"{ctl.membership_epoch}; lineage {summary['complete']}/{summary['n']} complete "
           f"with 0 orphans; victim flight dump at {flight_path}")
    if not failures:
        print("\n--- trace_report --flight (the last 60 s before the kill) ---")
        print(rendered)
    return failures


# ---------------------------------------------------------------------------
# Part 9: the verifier fleet under a killed grader; task mixtures
# ---------------------------------------------------------------------------


def check_verifier_chaos(cfg, device, kill_after_s: float = 1.2, n_mix: int = 16) -> List[str]:
    """(a) a killed verifier: zero lost grades, a redispatch, the breaker's
    cycle and the lane's refill; (b) a mixed-task rollout with per-task
    reward curves, signals and lineage; (c) the slow-verifier A/B."""
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.apps import metrics_report, trace_report
    from areal_tpu_torch.base import faults as faults_mod
    from areal_tpu_torch.base import metrics, name_resolve, tracer
    from areal_tpu_torch.base.name_resolve import MemoryNameResolveRepository
    from areal_tpu_torch.data.mixture import TaskMixtureStream, TaskSource
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.episode import RewardFabric
    from areal_tpu_torch.system.fleet import CircuitBreaker, SupervisorLane, fleet_discovery
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController
    from areal_tpu_torch.system.verifier_pool import (
        VerifierPool, VerifierWorker, list_verifiers, verifier_discovery,
    )

    old_repo = name_resolve.default()
    name_resolve.set_default(MemoryNameResolveRepository())
    failures = []
    trace_dir = tempfile.mkdtemp(prefix="areal_tpu_torch_vchaos_trace_")
    os.environ["AREAL_TRACE_DIR"] = trace_dir
    tracer.configure(role="vchaos", rank=0, dir=trace_dir, enabled=True, force=True)

    def wait_until(cond, timeout, what) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.05)
        failures.append(f"timeout waiting for {what}")
        return False

    # ---- (a) kill one of three graders mid-grade ----
    exp, trial = "vchaos", "t0"
    workers, victim = [], None
    for i in range(3):
        injector = None
        if i == 0:
            # The slow fault keeps grades in flight when the kill lands;
            # the short TTL lets the crashed key expire for the lane.
            injector = faults_mod.FaultInjector.parse(
                f"slow@ms=100&point=grade kill@t={kill_after_s}s")
        w = VerifierWorker(port=0, faults=injector)
        w.announce(exp, trial, ttl=(2.0 if i == 0 else 10.0))
        workers.append(w)
        if i == 0:
            victim = w
    victim_sid, victim_port = f"v{victim.port}", victim.port
    pool = VerifierPool(
        discovery=verifier_discovery(exp, trial), attempt_timeout_s=8.0, max_attempts=3,
        backoff_s=0.01, refresh_s=0.05, breaker_threshold=1, breaker_cooldown_s=0.4,
    )
    stop_pump = threading.Event()
    count_lock = threading.Lock()
    counts = {"items": 0, "ok": 0}
    pump_errors = []

    def math_items(k=3):
        return [{"task": "math", "text": r"The answer is \boxed{4}.",
                 "payload": {"solutions": [r"\boxed{4}"]}} for _ in range(k)]

    def pump():
        while not stop_pump.is_set():
            items = math_items()
            try:
                res = pool.verify_batch(items)
            except Exception as e:  # noqa: BLE001 — a loss is a finding
                pump_errors.append(repr(e))
                return
            if len(res) != len(items):
                pump_errors.append(f"shape: sent {len(items)}, got {len(res)}")
            with count_lock:
                counts["items"] += len(items)
                counts["ok"] += sum(map(bool, res))
            time.sleep(0.01)

    pumpers = [threading.Thread(target=pump, daemon=True) for _ in range(3)]
    for t in pumpers:
        t.start()
    respawned = []

    def respawn():
        # The same port: the replacement takes the victim's identity, and
        # the pool's breaker closes again through a half-open probe.
        w = VerifierWorker(port=victim_port)
        w.announce(exp, trial, ttl=10.0)
        respawned.append(w)

    lane = SupervisorLane(
        name="verifier", list_servers=lambda: list_verifiers(exp, trial), spawn=respawn,
        drain=lambda sid: None, min_servers=3, max_servers=4, action_cooldown_s=5.0,
        idle_rounds=10**6,  # this leg proves the refill, not a scale-down
    )
    wait_until(lambda: victim._crashed, 30, "the verifier kill fault")
    wait_until(lambda: len(list_verifiers(exp, trial)) == 2, 30,
               "the TTL eviction of the crashed verifier")
    wait_until(lambda: victim_sid in pool.breakers and pool.breakers[victim_sid].opens >= 1,
               30, "the victim's breaker to open")
    refill = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        decision = lane.step([])
        if decision.action == "spawn":
            refill = decision
            break
        time.sleep(0.1)
    if refill is None:
        failures.append("the supervisor lane never refilled the verifier pool")
    elif "refill" not in refill.reason:
        failures.append(f"unexpected refill reason {refill.reason!r}")
    wait_until(lambda: len(list_verifiers(exp, trial)) == 3, 30,
               "the replacement verifier to announce")
    wait_until(lambda: (pool.breakers[victim_sid].state == CircuitBreaker.CLOSED
                        and pool.breakers[victim_sid].closes >= 1),
               30, "the victim's breaker to close on the replacement")
    time.sleep(0.5)  # traffic after the heal rides the closed breaker
    stop_pump.set()
    for t in pumpers:
        t.join(timeout=30)
    for e in pump_errors:
        failures.append(f"grade pump error: {e}")
    if counts["ok"] != counts["items"] or counts["items"] == 0:
        failures.append(f"lost grades: {counts['ok']} of {counts['items']} items came back correct")
    if pool.redispatches < 1:
        failures.append("the kill produced no redispatch")
    if pool.graded_local > 0:
        failures.append(f"the pool graded {pool.graded_local} items locally despite live backends")
    if victim._faults is None or victim._faults.fired.get("kill", 0) < 1:
        failures.append("the AREAL_FAULTS kill never fired")
    br = pool.breakers.get(victim_sid)
    if br is None:
        failures.append(f"no breaker tracked for the victim {victim_sid}")
    else:
        if br.opens < 1:
            failures.append("the victim's breaker never opened")
        if br.closes < 1 or br.state != CircuitBreaker.CLOSED:
            failures.append(f"the victim's breaker ended {br.state} (opens={br.opens} "
                            f"closes={br.closes}), not closed again")
    flight_path = os.path.join(trace_dir, f"flightrec_verifier_{victim_port}.json")
    if not os.path.exists(flight_path):
        failures.append(f"the killed verifier left no flight dump at {flight_path}")
    else:
        with open(flight_path) as f:
            if json.load(f).get("reason") != "fault_kill":
                failures.append("the verifier's flight dump reason is not 'fault_kill'")
    for w in workers[1:] + respawned:
        w.close()
    if not failures:
        print(f"OK[verifier-chaos]: {counts['items']} grade items, zero lost; victim "
              f"{victim_sid} killed at t={kill_after_s}s, {pool.redispatches} batch(es) "
              f"redispatched, breaker opened x{br.opens} and closed x{br.closes}; the lane "
              f"refilled the pool to 3 ({refill.reason}); flight dump at {flight_path}")

    # ---- (b) + (c) mixed-task rollout, slow-verifier A/B ----
    params = tfm.init_params(cfg, 0, device=device)
    rng = np.random.default_rng(0)
    code_text = "```python\nprint(input())\n```"
    code_payload = {"input_output": json.dumps({"inputs": ["5\n"], "outputs": ["5\n"]})}

    def mix_run(tag, slow_ms):
        """One mixed-task rollout graded through a 2-worker pool: (dispatch
        seconds, mixture, consumed, replay, stat, verifier workers)."""
        exp2, trial2 = f"vmix_{tag}", "t0"
        vworkers = []
        for i in range(2):
            ms = slow_ms if i == 1 else 30  # both carry a base latency
            vw = VerifierWorker(port=0, faults=faults_mod.FaultInjector.parse(
                f"slow@ms={ms}&point=grade"))
            vw.announce(exp2, trial2, ttl=30.0)
            vworkers.append(vw)
        pool2 = VerifierPool(discovery=verifier_discovery(exp2, trial2), attempt_timeout_s=30.0,
                             refresh_s=0.1)
        mixture = TaskMixtureStream([
            TaskSource("math", _random_prompts(rng, cfg, 5), weight=2.0),
            TaskSource("code", _random_prompts(rng, cfg, 3), weight=1.0),
        ])
        fabric = RewardFabric(remote=pool2, max_workers=4, on_result=mixture.observe_reward)
        srv = GenerationServer(
            GeneratorEngine(cfg, params, device, eos_token_id=unreachable_eos(cfg),
                            max_decode_batch=2),
            max_wait_ms=20.0)
        srv.announce(exp2, trial2, ttl=30.0)
        replay = ReplayBuffer(capacity=4, max_head_offpolicyness=2)
        ctl = RolloutController(
            replay=replay, gconfig=GenerationHyperparameters(n=1, max_new_tokens=16),
            discovery=fleet_discovery(exp2, trial2), mixture=mixture, max_concurrency=4,
            health_refresh_s=0.3, backpressure_poll_s=0.01, autosize_inflight=False,
            dispatch_timeout_s=60.0,
        )
        consumed, futs = [], []

        async def consume(pump_task):
            loop = asyncio.get_running_loop()
            while not pump_task.done() or len(replay) > 0:
                try:
                    trajs = await loop.run_in_executor(None, replay.get_batch, 1, 0.2)
                except TimeoutError:
                    trajs = []
                for t in trajs:
                    consumed.append(t)
                    # Canned texts (the random model emits gibberish): math
                    # alternates pass and fail, code runs in the sandbox.
                    if t.task == "code":
                        text, payload = code_text, code_payload
                    else:
                        text = r"\boxed{4}" if len(consumed) % 3 != 0 else r"\boxed{5}"
                        payload = {"solutions": [r"\boxed{4}"]}
                    futs.append(fabric.submit(t.task, text, payload, trace_id=t.trace_id))
                await asyncio.sleep(0.01)

        async def drive():
            t0 = time.monotonic()
            pump_task = asyncio.create_task(ctl.run(max_prompts=n_mix))
            consumer = asyncio.create_task(consume(pump_task))
            await pump_task
            elapsed = time.monotonic() - t0
            await consumer
            return elapsed

        try:
            elapsed = asyncio.run(drive())
            for f in futs:
                f.result(timeout=120)
        finally:
            srv.close()
        return elapsed, mixture, consumed, replay, ctl.stat, vworkers

    elapsed_a, mix_a, consumed_a, replay_a, stat_a, vws_a = mix_run("a", slow_ms=30)
    for w in vws_a:
        w.close()
    elapsed_b, mix_b, consumed_b, replay_b, stat_b, vws_b = mix_run("b", slow_ms=300)
    for tag, stat, consumed in (("a", stat_a, consumed_a), ("b", stat_b, consumed_b)):
        if stat.accepted + stat.rejected != n_mix or stat.failed != 0:
            failures.append(f"[mix {tag}] prompt accounting broken: accepted {stat.accepted} + "
                            f"rejected {stat.rejected} != {n_mix} (failed={stat.failed})")
        qids = [t.qid for t in consumed]
        if len(set(qids)) != len(qids):
            failures.append(f"[mix {tag}] duplicate qids: {sorted(qids)}")
        bad = [q for q in qids if not (q.startswith("math:e") or q.startswith("code:e"))]
        if bad:
            failures.append(f"[mix {tag}] qids not task-namespaced: {bad[:4]}")
        if {t.task for t in consumed} != {"math", "code"}:
            failures.append(f"[mix {tag}] consumed tasks {({t.task for t in consumed})} != both")
    if mix_a.state_dict()["epochs"]["math"] < 1:
        failures.append("the math dataset never wrapped: the epoch-stamp check is vacuous")
    for mix in (mix_a, mix_b):
        if mix.reward_ema("math") is None or mix.reward_ema("code") is None:
            failures.append("a task's reward EMA never updated")
            break
    wm = replay_a.task_watermarks()
    if set(wm) != {"math", "code"}:
        failures.append(f"replay task watermarks {sorted(wm)} != both tasks")
    else:
        mix_a.sync_replay(wm)
        if sum(v["consumed"] for v in wm.values()) != len(consumed_a):
            failures.append("the per-task consumed counts do not add up")
    # (c) grading is asynchronous: a 10x slower backend must not slow the
    # dispatch.
    if elapsed_b > 2.0 * elapsed_a + 1.0:
        failures.append(f"dispatch throughput degraded under the slow verifier: "
                        f"{elapsed_b:.2f}s vs baseline {elapsed_a:.2f}s")
    slow_graded = vws_b[1].graded
    if slow_graded < 1:
        failures.append("the slow backend never graded anything")
    for w in vws_b:
        w.close()

    samples, _ = metrics_report.parse_prometheus_text(metrics.default_registry().expose())
    task_rewards = {labels.get("task"): v for n, labels, v in samples
                    if n == "areal_mixture_task_reward"}
    if not {"math", "code"} <= set(task_rewards):
        failures.append(f"per-task reward gauges missing: have {sorted(task_rewards)}")
    scrape = metrics_report.RoleScrape("local", time.monotonic(), samples)
    signals, _rows = metrics_report.fleet_signals([scrape], None)
    for sig in ("grade_latency_p99", "verifier_queue_depth", "task_reward_min"):
        if sig not in signals:
            failures.append(f"fleet signal {sig!r} missing: {signals}")
    slo_lines = []
    for text in ("crit: grade_latency_p99 <= 5", "crit: verifier_queue_depth <= 64",
                 "warn: task_reward_min >= 0.05"):
        rule = metrics_report.parse_slo_rule(text)
        msg = rule.evaluate([signals])
        slo_lines.append(f"  {text!r}: {'VIOLATED: ' + msg if msg else 'holds'}")
        if msg is not None and rule.signal != "task_reward_min":
            failures.append(f"SLO example unexpectedly violated: {msg}")

    tracer.flush()
    trace = tracer.merge_shards(trace_dir, out_path=os.path.join(trace_dir, "trace.json"))
    os.environ.pop("AREAL_TRACE_DIR", None)
    name_resolve.set_default(old_repo)
    summary = trace_report.lineage_summary(trace)
    by_task = {b["task"]: b for b in summary["by_task"]}
    if not {"math", "code"} <= set(by_task):
        failures.append(f"lineage by_task missing tasks: have {sorted(by_task)}")
    else:
        for task in ("math", "code"):
            if by_task[task]["complete"] < 1:
                failures.append(f"no complete {task} lineage timeline (n={by_task[task]['n']})")
    rendered = trace_report.format_lineage(trace)
    if "task=math" not in rendered or "task=code" not in rendered:
        failures.append("trace_report --lineage renders no per-task rows")
    _print("verifier-chaos", failures,
           f"2x{n_mix} mixed-task prompts (math:code = 2:1), namespaced qids across dataset "
           f"wraps, reward EMAs math={mix_b.reward_ema('math'):.2f} code="
           f"{mix_b.reward_ema('code'):.2f}; dispatch {elapsed_a:.2f}s baseline vs "
           f"{elapsed_b:.2f}s with one 10x-slow backend ({slow_graded} items on it)")
    if not failures:
        print("\n--- SLO examples over the scraped signals ---")
        for ln in slo_lines:
            print(ln)
        print("\n--- trace_report --lineage (per-task attribution) ---")
        for ln in rendered.splitlines():
            if ln.startswith("  task=") or "traces:" in ln:
                print(ln)
    return failures


# ---------------------------------------------------------------------------
# Part 8: the parameter fabric under a killed relay
# ---------------------------------------------------------------------------


def check_push_chaos(cfg, device, n_servers: int = 5, fanout: int = 2) -> List[str]:
    """Kill the first relay mid-broadcast: zero torn versions, the v-1
    bound, repair, convergence."""
    from areal_tpu_torch.apps import trace_report
    from areal_tpu_torch.base import faults, integrity, name_resolve, tracer
    from areal_tpu_torch.base.name_resolve import MemoryNameResolveRepository
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system import paramstore
    from areal_tpu_torch.system.fleet import fleet_discovery
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.paramstore import (
        BroadcastFabric, ParamStore, plan_tree, subtree_sids,
    )

    old_repo = name_resolve.default()
    name_resolve.set_default(MemoryNameResolveRepository())
    exp, trial = "pushchaos", "t0"
    failures = []
    trace_dir = tempfile.mkdtemp(prefix="areal_tpu_torch_push_chaos_trace_")
    os.environ["AREAL_TRACE_DIR"] = trace_dir
    tracer.configure(role="push_chaos", rank=0, dir=trace_dir, enabled=True, force=True)

    servers = []
    for i in range(n_servers):
        eng = GeneratorEngine(cfg, tfm.init_params(cfg, i, device=device), device,
                              eos_token_id=unreachable_eos(cfg))
        srv = GenerationServer(eng, max_wait_ms=2.0)
        srv.announce(exp, trial, ttl=30.0)  # outlives the dead window
        servers.append(srv)
    by_sid = {f"s{s.port}": s for s in servers}
    restarted = {}
    # With 5 sorted members at fanout 2 the chunks split [3, 2]: the
    # lowest sid heads the larger subtree and relays to two children.
    discovery = fleet_discovery(exp, trial)
    roots = plan_tree(sorted(discovery().items()), fanout)
    victim_node = roots[0]
    victim_sid = str(victim_node["sid"])
    victim_subtree = set(subtree_sids(victim_node))
    victim = by_sid[victim_sid]
    victim_port, victim_engine = victim.port, victim.engine
    if len(victim_node["children"]) != 2 or len(victim_subtree) != 3:
        failures.append(f"tree plan surprise: victim {victim_sid} heads subtree "
                        f"{sorted(victim_subtree)} (expected itself + 2 children)")
    # Armed after construction, so the victim comes from the planned tree:
    # the first param_push applies, the second (the v2 relay hop) crashes.
    victim._faults = faults.FaultInjector.parse("kill@point=param_push&skip=1")
    # retain=1: v1 surviving the v2 push proves the orphans' pins keep it.
    store = ParamStore(retain=1)
    fabric = BroadcastFabric(store, discovery=discovery, fanout=fanout, timeout_s=30.0,
                             experiment=exp, trial=trial)
    rejected0 = integrity.M_PUSH_REJECTED.get()
    orphans0 = paramstore.M_PUSH_ORPHANS.get()
    pushed = [tfm.init_params(cfg, 100 + i, device=device) for i in range(3)]
    checksums = [integrity.params_checksum(p) for p in pushed]

    def verify_fleet(live, want_version_of):
        """Every live server's params verify against the checksum of the
        version it reports: zero torn versions."""
        for sid, srv in live.items():
            v = srv.version
            want = want_version_of(sid)
            if v != want:
                failures.append(f"{sid} serves v{v}, expected v{want}")
                continue
            if v == 0:
                continue
            try:
                integrity.verify_checksum(srv.engine.params, checksums[v - 1])
            except integrity.WeightChecksumError as e:
                failures.append(f"TORN VERSION on {sid}: serving v{v} but params do not "
                                f"verify: {e}")

    r1 = None
    rendered = ""
    try:
        store.publish(pushed[0], checksums[0])
        r1 = fabric.push()
        if not r1.ok or sorted(r1.applied) != sorted(by_sid):
            failures.append(f"the clean v1 push did not reach the whole fleet: applied="
                            f"{sorted(r1.applied)} orphans={r1.orphans}")
        if r1.depth < 2:
            failures.append(f"v1 push depth {r1.depth} < 2: nothing relayed")
        verify_fleet(by_sid, lambda sid: 1)

        store.publish(pushed[1], checksums[1])
        r2 = fabric.push()
        orphaned = {str(o["sid"]) for o in r2.orphans}
        if orphaned != victim_subtree:
            failures.append(f"expected the kill to orphan exactly the victim's subtree "
                            f"{sorted(victim_subtree)}, got {sorted(orphaned)}")
        if sorted(r2.applied) != sorted(set(by_sid) - victim_subtree):
            failures.append(f"v2 push applied {sorted(r2.applied)}, expected "
                            f"{sorted(set(by_sid) - victim_subtree)}")
        moved = paramstore.M_PUSH_ORPHANS.get() - orphans0
        if moved != len(victim_subtree):
            failures.append(f"areal_param_push_orphans_total moved by {moved}, expected "
                            f"{len(victim_subtree)}")
        if victim._faults.fired.get("kill", 0) != 1:
            failures.append("the param_push kill never fired")
        live = {sid: srv for sid, srv in by_sid.items() if sid != victim_sid}
        # Every surviving laggard serves v1 = head-1, never v0.
        verify_fleet(live, lambda sid: 1 if sid in victim_subtree else 2)
        skew = max(s.version for s in live.values()) - min(s.version for s in live.values())
        if skew != 1:
            failures.append(f"post-kill weight version skew {skew}, expected 1")
        if 1 not in store.live_versions():
            failures.append("the store retired v1 while orphans still pin it")

        flight_path = os.path.join(trace_dir, f"flightrec_gen_server_{victim_port}.json")
        if not os.path.exists(flight_path):
            failures.append(f"the killed relay left no flight dump at {flight_path}")
        else:
            with open(flight_path) as f:
                if json.load(f).get("reason") != "fault_kill":
                    failures.append("the relay's flight dump reason is not 'fault_kill'")
        rendered = trace_report.format_flight(trace_dir, window_s=60.0)
        if rendered.startswith("no flightrec"):
            failures.append("trace_report --flight rendered no dumps")

        victim._collector_thread.join(timeout=60)
        srv = GenerationServer(victim_engine, port=victim_port, max_wait_ms=2.0, version=1)
        srv.announce(exp, trial, ttl=30.0)
        restarted["server"] = srv
        by_sid[victim_sid] = srv
        repaired = fabric.repair()
        if sorted(repaired) != sorted(victim_subtree):
            failures.append(f"repair caught up {sorted(repaired)}, expected the orphaned "
                            f"subtree {sorted(victim_subtree)}")
        verify_fleet(by_sid, lambda sid: 2)

        store.publish(pushed[2], checksums[2])
        r3 = fabric.push()
        if not r3.ok or sorted(r3.applied) != sorted(by_sid):
            failures.append(f"the v3 push after the repair did not converge: applied="
                            f"{sorted(r3.applied)} orphans={r3.orphans}")
        verify_fleet(by_sid, lambda sid: 3)
        if store.live_versions() != [3]:
            failures.append(f"the store retains {store.live_versions()} after convergence, "
                            "expected [3]")
        if integrity.M_PUSH_REJECTED.get() - rejected0 != 0:
            failures.append("areal_gen_weight_push_rejected_total moved during the run")
    finally:
        os.environ.pop("AREAL_TRACE_DIR", None)
        name_resolve.set_default(old_repo)
        for s in servers:
            if s is not victim:
                s.close()
        if "server" in restarted:
            restarted["server"].close()
        elif not victim._crashed:
            victim.close()
    _print("push-chaos", failures,
           f"v1 reached {len(by_sid)}/{len(by_sid)} servers (depth {r1.depth if r1 else 0}); "
           f"killing relay {victim_sid} mid-v2 orphaned exactly {sorted(victim_subtree)} (skew "
           f"1, laggards at v1, the store kept v1 through the pins); zero torn versions; "
           f"repair() caught up {len(victim_subtree)} laggards and v3 converged all "
           f"{len(by_sid)}")
    if not failures:
        print("\n--- trace_report --flight (the killed relay) ---")
        print(rendered)
    return failures


# ---------------------------------------------------------------------------
# Part 4: the pipeline-overlapped PPO step
# ---------------------------------------------------------------------------

OVERLAP_REWARD = "overlap-check-rw"
REWARD_LATENCY_S_PER_SEQ = 0.03


def _register_overlap_reward():
    from areal_tpu_torch.api.model_api import ALL_INTERFACES, register_interface
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface

    if OVERLAP_REWARD in ALL_INTERFACES:
        return

    @dataclasses.dataclass
    class OverlapCheckReward(MultiTaskRewardInterface):
        """Rewards that vary within a group (a random actor gets every
        answer wrong, and GRPO's group normalization would zero equal
        scores) and a per-sequence latency standing for a remote
        verifier: the serial idle the overlapped executor hides.  Per
        sequence, so the barrier (one call a batch) and the pipeline (one
        call a chunk) pay the same in total."""

        latency_s: float = 0.0

        def inference(self, model, sample, mb_spec):
            lens = [n for row in sample.seqlens["packed_input_ids"] for n in row]
            if self.latency_s:
                time.sleep(self.latency_s * len(lens))
            out = super().inference(model, sample, mb_spec)
            data = np.asarray(sample.data["packed_input_ids"])
            scores, off = [], 0
            for n in lens:
                scores.append(float(int(np.sum(data[off:off + n])) % 7) - 3.0)
                off += n
            out.data["rewards"] = np.asarray(scores, np.float32)
            return out

    register_interface(OVERLAP_REWARD, OverlapCheckReward)


def check_overlap(cfg, device, fileroot: str, n_long: int = 48, n_short: int = 16,
                  group_n: int = 2, max_new_tokens: int = 64) -> List[str]:
    """The barrier against the streamed executor, with trace-level stall
    attribution and per-step build flatness."""
    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.apps import trace_report
    from areal_tpu_torch.base import tracer
    from areal_tpu_torch.experiments.common import PPOMathConfig, build_ppo_math, run_experiment
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    _register_overlap_reward()
    tok = make_tokenizer(cfg)
    rows_long = build_math_rows(n_long, seed=7)
    rows_short = build_math_rows(n_short, seed=7)

    def make(sub, rows, **kw):
        return PPOMathConfig(
            actor=ModelAbstraction("random", {"config": cfg}),
            dataset=DatasetAbstraction(
                "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
            reward_interface=ModelInterfaceAbstraction(OVERLAP_REWARD, {
                "id2info": {r["query_id"]: r for r in rows},
                "latency_s": REWARD_LATENCY_S_PER_SEQ,
            }),
            gconfig=GenerationHyperparameters(n=group_n, max_new_tokens=max_new_tokens),
            ppo_kwargs={"n_minibatches": 1, "kl_ctl": 0.0},
            optimizer=OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0),
            batch_size=8, total_train_epochs=1, seed=1,
            ctrl=ExperimentSaveEvalControl(), fileroot=os.path.join(fileroot, sub), **kw,
        )

    def run(tag, rows, trace_dir=None, **kw):
        # Each traced leg's spans land in its own shard dir.
        tracer.configure(role="overlap_check", rank=0, dir=trace_dir,
                         enabled=trace_dir is not None, force=True)
        launches0 = kernel_launches()
        builds0 = metric_value("areal_gen_decode_compiles_total")
        m, stats = run_experiment(build_ppo_math(make(tag, rows, **kw), tok), tokenizer=tok,
                                  device=device)
        builds = dict(launch_delta(launches0),
                      decode_compiles=metric_value("areal_gen_decode_compiles_total") - builds0)
        trace = None
        if trace_dir is not None:
            tracer.flush()
            trace = tracer.merge_shards(trace_dir,
                                        out_path=os.path.join(trace_dir, "trace.json"))
        os.environ.pop("AREAL_TRACE_DIR", None)
        return m, stats, trace, builds

    failures = []
    m_bar, s_bar, _, _ = run("barrier", rows_long)
    m_ser, s_ser, tr_ser, _ = run("serial", rows_long,
                                  trace_dir=os.path.join(fileroot, "trace_serial"),
                                  pipeline_overlap=True, overlap_window=1)
    m_ovl, s_ovl, tr_ovl, b_long = run("overlap", rows_long,
                                       trace_dir=os.path.join(fileroot, "trace_overlap"),
                                       pipeline_overlap=True, overlap_window=3,
                                       pipeline_chunk_seqs=2)
    m_short, s_short, _, b_short = run("overlap_short", rows_short, pipeline_overlap=True,
                                       overlap_window=3, pipeline_chunk_seqs=2)

    _compare_stats("window=1 against the barrier", s_bar, s_ser, failures)
    if not any(s["actor_train/grad_norm"] > 0 for s in s_bar):
        failures.append("degenerate check: every barrier grad_norm is zero")
    diff = max_diff(_actor(m_bar).get_params(), _actor(m_ser).get_params())
    if diff != 0.0:
        failures.append(f"window=1 final weights differ from the barrier's by {diff}")

    # Medians: one straggler step must not flip the gate either way.
    wall_bar = float(np.median([s["time/step_s"] for s in s_bar[2:]]))
    wall_ovl = float(np.median([s["time/step_s"] for s in s_ovl[2:]]))
    if not wall_ovl < 0.95 * wall_bar:
        failures.append(f"the overlapped steady step ({wall_ovl:.3f}s) is not faster than the "
                        f"barrier's ({wall_bar:.3f}s)")
    for s in s_ovl:
        if not np.isfinite(s["actor_train/loss"]) or not np.isfinite(s["actor_train/grad_norm"]):
            failures.append("non-finite stats in the overlapped leg")
            break

    def steady(rows):
        rows = [r for r in rows if r["step"] is not None]
        return [r for r in rows if r["step"] >= 3] or rows

    def idle_s(row):
        return sum((row["window_us"] - st["busy_us"]) / 1e6 for st in row["stages"])

    rows_ser = steady(trace_report.pipeline_rows(tr_ser))
    rows_ovl = steady(trace_report.pipeline_rows(tr_ovl))
    idle_ser = idle_ovl = ofrac_ser = ofrac_ovl = fill_max = float("nan")
    if not rows_ser or not rows_ovl:
        failures.append(f"pipe:* spans missing from a traced leg (serial rows={len(rows_ser)}, "
                        f"overlap rows={len(rows_ovl)})")
    else:
        idle_ser = float(np.median([idle_s(r) for r in rows_ser]))
        idle_ovl = float(np.median([idle_s(r) for r in rows_ovl]))
        ofrac_ser = float(np.median([r["overlap_frac"] for r in rows_ser]))
        ofrac_ovl = float(np.median([r["overlap_frac"] for r in rows_ovl]))
        fill_max = max(st["fill"] for r in rows_ovl for st in r["stages"])
        if idle_ovl >= idle_ser:
            failures.append(f"per-stage idle did not shrink: serial {idle_ser:.3f}s -> "
                            f"overlapped {idle_ovl:.3f}s")
        if ofrac_ser > 0.02:
            failures.append(f"the serial leg reports overlap_frac {ofrac_ser:.3f} > 0")
        if ofrac_ovl < 0.05:
            failures.append(f"the overlapped leg shows no overlap (overlap_frac {ofrac_ovl:.3f})")

    # For the JAX leg's equal trace counters: the same launches and chunk
    # builds a step in the 2-step and the long overlapped runs.
    n_l, n_s = len(s_ovl), len(s_short)
    uneven = {k: (b_long[k], b_short[k]) for k in b_long if b_long[k] * n_s != b_short[k] * n_l}
    if uneven:
        failures.append(f"builds or launches a step differ between the {n_l}-step and the "
                        f"{n_s}-step overlapped runs: {uneven}")
    _print("overlap", failures,
           f"window=1 == barrier exactly over {len(s_bar)} steps (max param diff {diff}); "
           f"steady step {wall_bar:.3f}s -> {wall_ovl:.3f}s "
           f"({100 * (1 - wall_ovl / wall_bar):.0f}% faster); stage idle {idle_ser:.3f}s -> "
           f"{idle_ovl:.3f}s; overlap_frac {ofrac_ser:.3f} -> {ofrac_ovl:.3f} (max fill "
           f"{fill_max:.2f}); builds and launches a step equal: {b_short} over {n_s} steps")
    if not failures:
        print("\n--- trace_report --pipeline, window=1 (before) ---")
        print(trace_report.format_pipeline(tr_ser))
        print("--- trace_report --pipeline, window=3 (after) ---")
        print(trace_report.format_pipeline(tr_ovl))
    return failures


# ---------------------------------------------------------------------------
# Part 5: the crash-safe trainer plane
# ---------------------------------------------------------------------------


def _trainer_chaos_victim(cfg, device, fileroot: str, n_rows: int, actor_path=None,
                          lr: float = 5e-3) -> int:
    """The hidden --trainer-chaos-victim: run the tiny PPO trial to its end
    (resuming from any recover checkpoint).  The parent sets AREAL_FAULTS
    for the run it kills and reads the checkpoint dirs each run leaves."""
    from areal_tpu_torch.experiments.common import build_ppo_math, run_experiment

    tok = make_tokenizer(cfg)
    rows = build_math_rows(n_rows, seed=7)
    _, stats = run_experiment(
        build_ppo_math(ppo_config(cfg, fileroot, rows, actor_path=actor_path, lr=lr), tok),
        tokenizer=tok, device=device)
    print(f"VICTIM_OK steps={len(stats)}")
    return 0


def trainer_hang(cfg, device, fileroot: str, n_rows: int = 16, mfc_timeout_s: float = 30.0,
                 actor_path=None, lr: float = 5e-3) -> List[str]:
    """(a) A hang on the third train MFC, caught by the master's deadline:
    one recovery and a bit-exact resume against a fault-free run."""
    from areal_tpu_torch.apps.main import make_master
    from areal_tpu_torch.base import tracer
    from areal_tpu_torch.experiments.common import build_ppo_math, run_experiment
    from areal_tpu_torch.system.master import InProcessPool

    failures = []
    tok = make_tokenizer(cfg)
    rows = build_math_rows(n_rows, seed=7)
    steps = n_rows // 4
    m_base, s_base = run_experiment(
        build_ppo_math(ppo_config(cfg, os.path.join(fileroot, "baseline"), rows,
                                  actor_path=actor_path, lr=lr), tok),
        tokenizer=tok, device=device)
    # The in-process pool has no heartbeat lane: the deadline must clear
    # the slowest honest MFC (the first train step's warm-up).
    plan = build_ppo_math(ppo_config(cfg, os.path.join(fileroot, "chaos"), rows,
                                     mfc_timeout_s=mfc_timeout_s, actor_path=actor_path,
                                     lr=lr), tok)
    tracer.default_dir(plan.fileroot, plan.experiment_name, plan.trial_name)
    # The third train MFC hangs (a stuck host, not a crash): the master's
    # deadline, not a process exit, gives the death verdict.
    workers = _workers_under_faults(plan, tok, device,
                                    f"hang@point=mfc_train_step&skip={steps - 2}&times=1")
    injectors = [w._faults for w in workers if w._faults is not None]
    pool = InProcessPool(workers, mfc_timeout_s=plan.mfc_timeout_s)
    relaunches = []

    def relauncher(dead):
        # A scheduler's relaunch, in process: release the hung thread and
        # revive the pool's slot.
        for inj in injectors:
            inj.release()
        for wid in dead:
            pool.revive(wid)
        relaunches.append(sorted(dead))

    names = ("areal_master_worker_dead_total", "areal_master_mfc_timeout_total",
             "areal_master_recoveries_total", "areal_ckpt_flips_total")
    before = {n: metric_value(n) for n in names}
    master = make_master(plan, pool)
    master.worker_relauncher = relauncher
    master.load_recover_info()
    t0 = time.monotonic()
    stats = asyncio.run(master.run())
    detect_wall = time.monotonic() - t0
    hangs = sum(i.fired.get("hang", 0) for i in injectors)
    if hangs != 1:
        failures.append(f"expected exactly 1 injected hang, got {hangs}")
    if relaunches != [[0]]:
        failures.append(f"expected one relaunch of worker 0, got {relaunches}")
    if master._recoveries != 1:
        failures.append(f"expected 1 recovery, got {master._recoveries}")
    for name in names[:3]:
        delta = metric_value(name) - before[name]
        if delta != 1:
            failures.append(f"{name} moved by {delta}, expected 1")
    flips = metric_value("areal_ckpt_flips_total") - before["areal_ckpt_flips_total"]
    if flips < steps:
        failures.append(f"expected >= {steps} checkpoint flips (one a step), got {flips}")
    if master.step_info.global_step != len(s_base):
        failures.append(f"final global_step {master.step_info.global_step} != {len(s_base)}")
    # The rollback restores weights, optimizer, versions (the sampling
    # seeds) and data cursors: the replayed steps equal the baseline's.
    _compare_stats("the chaos run against the baseline", s_base, stats, failures)
    diff = max_diff(_actor(m_base).get_params(), _actor(master).get_params())
    if diff != 0.0:
        failures.append(f"post-recovery final weights differ from the baseline's by {diff}")
    _print("trainer-chaos", failures,
           f"hang detected and recovered in-run (1 recovery, wall {detect_wall:.1f}s, "
           f"{flips:.0f} checkpoint flips), resumed bit for bit against the baseline over "
           f"{len(stats)} steps (max param diff {diff})")
    return failures


def _victim_cmd(cfg_name, layers, device, root, n_rows, actor_path, lr):
    cmd = [sys.executable, "-m", "areal_tpu_torch.scripts.check_async",
           "--trainer-chaos-victim", root, "--model", cfg_name, "--device", str(device),
           "--rows", str(n_rows), "--lr", repr(lr)]
    if layers:
        cmd += ["--layers", str(layers)]
    if actor_path:
        cmd += ["--actor-path", actor_path]
    return cmd


def trainer_kill(cfg_name: str, layers: Optional[int], device, fileroot: str,
                 n_rows: int = 16, actor_path=None, lr: float = 5e-3,
                 report: Optional[Dict] = None, timeout_s: float = 600.0) -> List[str]:
    """(b) a victim process killed at recover_stage in its second save,
    then restarted; (c) its current checkpoint torn, then restarted."""
    from areal_tpu_torch.base import recover

    failures = []
    steps = n_rows // 4
    vic_root = os.path.join(fileroot, "victim")
    cmd = _victim_cmd(cfg_name, layers, device, vic_root, n_rows, actor_path, lr)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AREAL_FAULTS", None)
    times = {}

    def run(tag, faults=None):
        e = dict(env)
        if faults:
            e["AREAL_FAULTS"] = faults
        t0 = time.monotonic()
        r = subprocess.run(cmd, env=e, capture_output=True, text=True, timeout=timeout_s,
                           cwd=REPO_ROOT)
        times[tag] = time.monotonic() - t0
        return r

    # The first recover save commits; the second is killed after its
    # stage, before its flip.
    r1 = run("killed", "kill@point=recover_stage&skip=1&times=1")
    if r1.returncode != 42:
        failures.append(f"victim run 1: expected exit 42 (the kill at recover_stage), got "
                        f"{r1.returncode}; stderr tail: {r1.stderr[-800:]}")
    bases = sorted(glob.glob(os.path.join(vic_root, "checkpoints", "*", "*", "*",
                                          "recover_checkpoint")))
    if not bases:
        failures.append("victim run 1 left no committed recover_checkpoint")
    for base in bases:
        m = recover.validate_manifest(base)
        if m is None or m["step"] != 1:
            failures.append(f"{base}: expected an intact manifest at step 1 after the "
                            f"mid-save kill, got {m and m['step']}")
        if not os.path.isdir(recover.stage_dir(base, 2)):
            failures.append(f"the kill at recover_stage left no staged dir "
                            f"{recover.stage_dir(base, 2)}")
    r2 = run("restart")
    if r2.returncode != 0:
        failures.append(f"victim run 2 (the restart): expected exit 0, got {r2.returncode}; "
                        f"stderr tail: {r2.stderr[-800:]}")
    infos = [recover.load(r) for r in glob.glob(os.path.join(vic_root, "recover", "*", "*"))]
    if not infos or infos[0].last_step_info.global_step != steps:
        failures.append(f"victim run 2: expected recover info at step {steps}, got "
                        f"{[i.last_step_info.global_step for i in infos if i]}")
    for base in bases:
        m = recover.validate_manifest(base)
        if m is None or m["step"] != steps:
            failures.append(f"{base}: expected a manifest at step {steps} after the resumed "
                            f"run, got {m and m['step']}")
        stale = glob.glob(base + recover.STAGE_PREFIX + "*")
        if stale:
            failures.append(f"stale stages left behind: {stale}")
    # (c) The committed checkpoint torn: the fallback to .prev.
    for base in bases:
        m = recover.validate_manifest(base)
        if not m:
            continue
        with open(os.path.join(base, m["files"][0]["name"]), "wb") as f:
            f.write(b"torn")
        if recover.validate_manifest(base) is not None:
            failures.append(f"{base}: a torn file passed validation")
        if recover.latest_valid_checkpoint(base) != base + recover.PREV_SUFFIX:
            failures.append(f"{base}: the torn current did not fall back to .prev")
    r3 = run("torn")
    if r3.returncode != 0:
        failures.append(f"victim run 3 (torn current): expected exit 0 restoring from .prev, "
                        f"got {r3.returncode}; stderr tail: {r3.stderr[-800:]}")
    if report is not None:
        report.update(seconds=times, rcs=[r1.returncode, r2.returncode, r3.returncode])
    _print("trainer-chaos", failures,
           f"the mid-save kill (exit 42) left step 1's checkpoint intact and the restart "
           f"finished at step {steps}; the torn current fell back to .prev and restored "
           f"(runs {', '.join(f'{k} {v:.1f}s' for k, v in times.items())})")
    return failures


def check_trainer_chaos(cfg, device, fileroot: str, cfg_name: str = "tiny",
                        layers: Optional[int] = None, n_rows: int = 16) -> List[str]:
    # The deadline clears the slowest honest MFC: on the card the first
    # train step builds its kernels; on the CPU nothing is built.
    timeout = 10.0 if torch.device(device).type == "cpu" else 30.0
    return (trainer_hang(cfg, device, fileroot, n_rows=n_rows, mfc_timeout_s=timeout)
            + trainer_kill(cfg_name, layers, device, fileroot, n_rows=n_rows))


# ---------------------------------------------------------------------------
# Part 6: the numerical-integrity guard plane
# ---------------------------------------------------------------------------


def _sft_sample(rng, n=6, max_len=20):
    from areal_tpu_torch.api.data_api import SequenceSample

    sample = random_sample(rng, ids=[f"s{i}" for i in range(n)], keys=("packed_input_ids",),
                           max_len=max_len)
    masks = []
    for sl in sample.seqlens["packed_input_ids"]:
        m = np.zeros(sl[0], dtype=bool)
        m[:2] = True
        masks.append(m)
    sample.update_(SequenceSample(
        keys={"prompt_mask"}, ids=sample.ids,
        seqlens={"prompt_mask": [list(s) for s in sample.seqlens["packed_input_ids"]]},
        data={"prompt_mask": np.concatenate(masks)},
    ))
    return sample


def nan_quarantine(cfg, device, params=None, n_seqs: int = 6, max_len: int = 20,
                   around_step=contextlib.nullcontext, report: Optional[Dict] = None
                   ) -> List[str]:
    """(a) NaN gradients: the step is quarantined and changes nothing.
    `around_step` wraps the poisoned train call (a caller's sync probe)."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.ops import functional as F

    failures = []
    if params is None:
        params = tfm.init_params(cfg, 0, device=device)
    with _env(AREAL_FAULTS="nan@point=train_grads&times=1"):
        eng = TrainEngine(cfg, params=params, device=device,
                          optimizer_config=OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0),
                          ftspec=FinetuneSpec(1, 8, 8))
    sample = _sft_sample(np.random.default_rng(0), n_seqs, max_len)
    kw = dict(loss_fn=F.sft_loss, loss_weight_fn=F.sft_label_count,
              token_key="packed_input_ids", extra_keys=("prompt_mask",))
    before = {t: snapshot(getattr(eng, t)) for t in ("params", "_mu", "_nu")}
    count0 = eng.opt_count
    anom0 = metric_value("areal_train_anomaly_total")
    launches0 = kernel_launches()
    with around_step():
        out = eng.train_batch(sample, MicroBatchSpec(), **kw)
    nan_launches = launch_delta(launches0)
    unchanged = {t: same(before[t], getattr(eng, t)) for t in before}
    if not (out["quarantined"] == 1.0 and int(out["anomaly_verdict"]) & integrity.NONFINITE):
        failures.append(f"the NaN step was not quarantined as non-finite: {out}")
    if not all(unchanged.values()) or eng.opt_count != count0:
        failures.append(f"the quarantined step changed the state: unchanged {unchanged}, "
                        f"opt_count {count0} -> {eng.opt_count}")
    if metric_value("areal_train_anomaly_total") - anom0 != 1:
        failures.append("the anomaly counter did not move by 1 on the NaN step")
    if eng._faults is None or eng._faults.fired.get("nan", 0) != 1:
        failures.append("the nan fault did not fire exactly once")
    # The fault is spent (times=1): the next step trains, with the same
    # launches and one host transfer a call.
    launches1 = kernel_launches()
    out2 = eng.train_batch(sample, MicroBatchSpec(), **kw)
    clean_launches = launch_delta(launches1)
    if out2["quarantined"] != 0.0 or same(before["params"], eng.params):
        failures.append(f"the clean step after the NaN fault did not train: {out2}")
    if eng.opt_count != count0 + 1:
        failures.append(f"the clean step's count {eng.opt_count} != {count0 + 1}")
    if nan_launches != clean_launches:
        failures.append(f"the NaN step's launches {nan_launches} differ from the clean "
                        f"step's {clean_launches}")
    if eng.host_transfers != 2:
        failures.append(f"expected 1 host transfer a train call (2 in all), got "
                        f"{eng.host_transfers}")
    if report is not None:
        report.update(out=out, out2=out2, nan_launches=nan_launches,
                      clean_launches=clean_launches, host_transfers=eng.host_transfers)
    _print("nan-chaos", failures,
           f"NaN gradients quarantined with the masters, mu, nu and count unchanged "
           f"(1 host transfer a call; launches {nan_launches} == the clean step's); the next "
           f"step trained (grad_norm {out2['grad_norm']:.4g})")
    return failures


def nan_rollback(cfg, device, fileroot: str, n_rows: int = 16, actor_path=None,
                 lr: float = 5e-3, baseline_ckpt: bool = True,
                 report: Optional[Dict] = None) -> List[str]:
    """(b) A NaN streak over the last two steps under
    max_consecutive_quarantines=2: 2 quarantined steps, 1 rollback, and a
    replay bit for bit the fault-free run (`baseline_ckpt`: whether that
    run also saves recover checkpoints; they change no number)."""
    from areal_tpu_torch.apps.main import make_master
    from areal_tpu_torch.base import tracer
    from areal_tpu_torch.experiments.common import build_ppo_math, run_experiment
    from areal_tpu_torch.system.master import InProcessPool

    failures = []
    tok = make_tokenizer(cfg)
    rows = build_math_rows(n_rows, seed=7)
    steps = n_rows // 4
    launches0 = kernel_launches()
    t0 = time.monotonic()
    m_base, s_base = run_experiment(
        build_ppo_math(ppo_config(cfg, os.path.join(fileroot, "baseline"), rows,
                                  actor_path=actor_path, lr=lr,
                                  ckpt_freq_steps=1 if baseline_ckpt else None), tok),
        tokenizer=tok, device=device)
    base_s = time.monotonic() - t0
    base_launches = launch_delta(launches0)
    plan = build_ppo_math(ppo_config(cfg, os.path.join(fileroot, "chaos"), rows,
                                     actor_path=actor_path, lr=lr,
                                     max_consecutive_quarantines=2), tok)
    tracer.default_dir(plan.fileroot, plan.experiment_name, plan.trial_name)
    # The actor's train engine NaN-poisons the last two steps' gradients.
    workers = _workers_under_faults(plan, tok, device,
                                    f"nan@point=train_grads&skip={steps - 2}&times=2")
    names = ("areal_master_quarantined_steps_total", "areal_master_quarantine_rollbacks_total",
             "areal_master_recoveries_total")
    before = {n: metric_value(n) for n in names}
    launches1 = kernel_launches()
    t1 = time.monotonic()
    master = make_master(plan, InProcessPool(workers))
    master.load_recover_info()
    stats = asyncio.run(master.run())
    chaos_s = time.monotonic() - t1
    chaos_launches = launch_delta(launches1)

    def quarantined(s):
        return any(k.rsplit("/", 1)[-1] == "quarantined" and v > 0 for k, v in s.items())

    bad = [s for s in stats if quarantined(s)]
    clean = [s for s in stats if not quarantined(s)]
    if len(bad) != 2:
        failures.append(f"expected exactly 2 quarantined steps, got {len(bad)}")
    for name, want in zip(names, (2, 1, 1)):
        delta = metric_value(name) - before[name]
        if delta != want:
            failures.append(f"{name} moved by {delta}, expected {want}")
    if len(master._quarantine_ledger) < 2:
        failures.append(f"the quarantine ledger holds {len(master._quarantine_ledger)} "
                        "entries, expected >= 2")
    if master.step_info.global_step != len(s_base):
        failures.append(f"final global_step {master.step_info.global_step} != {len(s_base)}")
    # The rollback restores the checkpoint of step steps-2 (a quarantined
    # step never checkpoints): the replay equals the fault-free run.
    _compare_stats("the replay against the baseline", s_base, clean, failures)
    diff = max_diff(_actor(m_base).get_params(), _actor(master).get_params())
    if diff != 0.0:
        failures.append(f"post-rollback final weights differ from the baseline's by {diff}")
    # For the JAX leg's flat trace counters: the chaos run launched each
    # kernel what the baseline did, plus what its 2 quarantined steps ran
    # again (the same a step).
    per_step = {k: v // max(steps, 1) for k, v in base_launches.items()}
    want = {k: base_launches[k] + 2 * per_step[k] for k in base_launches}
    if any(base_launches[k] % max(steps, 1) for k in base_launches) or chaos_launches != want:
        failures.append(f"launches: chaos run {chaos_launches}, expected {want} (the baseline's "
                        f"{base_launches} and 2 replayed steps)")
    if report is not None:
        report.update(quarantined=len(bad), clean=len(clean), diff=diff,
                      base_launches=base_launches, chaos_launches=chaos_launches,
                      base_s=base_s, chaos_s=chaos_s, steps=steps)
    _print("nan-chaos", failures,
           f"a 2-step NaN streak rolled back and replayed bit for bit against the baseline "
           f"over {len(clean)} steps (max param diff {diff}; launches {chaos_launches} = the "
           f"baseline's + 2 steps')")
    return failures


def corrupt_push(cfg, device, params=None, push_params=None, n_prompts: int = 2,
                 max_new_tokens: int = 16, inflight: Optional[bool] = None,
                 engine_kw=None, report: Optional[Dict] = None) -> List[str]:
    """(c) A corrupted in-memory push: refused by the server's checksum,
    retried, and greedy decode equal to a control server's."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.base import integrity, tracer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.gen_server import GenerationServer

    failures = []
    if params is None:
        params = tfm.init_params(cfg, 0, device=device)
    if push_params is None:
        push_params = tfm.init_params(cfg, 42, device=device)
    ekw = dict(engine_kw or {})
    trace_dir = tempfile.mkdtemp(prefix="areal_tpu_torch_nan_chaos_trace_")
    with _env(AREAL_TRACE_DIR=trace_dir):
        with _env(AREAL_FAULTS="corrupt_push@point=weight_push&times=1"):
            victim = GenerationServer(GeneratorEngine(
                cfg, params, device, eos_token_id=unreachable_eos(cfg), **ekw))
        control = GenerationServer(GeneratorEngine(
            cfg, params, device, eos_token_id=unreachable_eos(cfg), **ekw))
        try:
            cs = integrity.params_checksum(push_params)
            rej0 = metric_value("areal_gen_weight_push_rejected_total")
            v0 = victim.version
            rejected = False
            try:
                victim.update_weights_inmem(push_params, checksum=cs)
            except integrity.WeightChecksumError:
                rejected = True
            if not rejected:
                failures.append("the corrupted push was not refused by the checksum")
            if metric_value("areal_gen_weight_push_rejected_total") - rej0 != 1:
                failures.append("areal_gen_weight_push_rejected_total did not move by 1")
            if victim.version != v0:
                failures.append("the refused push still bumped the serving version")
            dump = os.path.join(trace_dir, f"flightrec_gen_server_{victim.port}.json")
            if not os.path.exists(dump):
                failures.append(f"the refused push left no flight dump at {dump}")
            else:
                with open(dump) as f:
                    if json.load(f).get("reason") != "push_rejected":
                        failures.append("the flight dump's reason is not 'push_rejected'")
            # The pusher retries; the fault is spent and the push lands.
            v1 = victim.update_weights_inmem(push_params, checksum=cs)
            control.update_weights_inmem(push_params, checksum=cs)
            if v1 != v0 + 1:
                failures.append(f"the retried push served v{v1}, expected v{v0 + 1}")
            if victim._faults.fired.get("corrupt_push", 0) != 1:
                failures.append("the corrupt_push fault did not fire exactly once")
            rng = np.random.default_rng(0)
            lens = [int(x) for x in rng.integers(6, 10, size=n_prompts)]
            prompts = SequenceSample(
                keys={"packed_prompts"}, ids=[f"p{i}" for i in range(n_prompts)],
                seqlens={"packed_prompts": [[n] for n in lens]},
                data={"packed_prompts": rng.integers(8, cfg.vocab_size, size=sum(lens)
                                                     ).astype(np.int32)},
            )
            g = GenerationHyperparameters(n=1, max_new_tokens=max_new_tokens, greedy=True)
            gkw = {} if inflight is None else {"inflight": inflight}
            steps0 = victim.engine.steps_total
            launches0 = kernel_launches()
            out_v = victim.engine.generate(prompts, MicroBatchSpec(), g, **gkw)
            victim_launches = launch_delta(launches0)
            victim_steps = victim.engine.steps_total - steps0
            out_c = control.engine.generate(prompts, MicroBatchSpec(), g, **gkw)
            tv = np.asarray(out_v.data["packed_input_ids"])
            tc = np.asarray(out_c.data["packed_input_ids"])
            if not np.array_equal(tv, tc):
                failures.append("greedy decode after the retry differs from the control "
                                "server's")
            if report is not None:
                report.update(rejected=rejected, version=v1, flight_dump=dump,
                              launches=victim_launches, inner_steps=victim_steps,
                              tokens=int(tv.size))
        finally:
            victim.close()
            control.close()
            tracer.flush()
    _print("nan-chaos", failures,
           "the corrupted push was refused by the checksum (rejected counter +1, the version "
           "unchanged, a push_rejected flight dump), the retry landed, greedy decode equals "
           "the control server's")
    return failures


def check_nan_chaos(cfg, device, fileroot: str) -> List[str]:
    return (nan_quarantine(cfg, device) + nan_rollback(cfg, device, fileroot)
            + corrupt_push(cfg, device))


# ---------------------------------------------------------------------------
# Part 7: agent episodes
# ---------------------------------------------------------------------------


def check_agents(cfg, device, n_episodes: int = 3) -> List[str]:
    """Multi-turn tool-use episodes on persistent KV slots.  The random
    model has no chat template, so a tool-call stop is a token-space
    convention: every even token id is a one-token stop."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.interfaces.reward_service import grade_item
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.episode import (
        EngineEpisodeClient, EpisodeController, ToolCall, ToolExecutor,
    )

    failures = []
    params = tfm.init_params(cfg, 0, device=device)

    def mk_engine(p):
        return GeneratorEngine(cfg, p, device, eos_token_id=unreachable_eos(cfg), kv_paged=True,
                               kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)

    def sample_of(toks):
        arr = np.asarray(toks, np.int32)
        return SequenceSample(keys={"packed_prompts"}, ids=["p0"],
                              seqlens={"packed_prompts": [[len(arr)]]},
                              data={"packed_prompts": arr})

    rng = np.random.default_rng(17)
    prompt = [int(t) for t in rng.integers(8, cfg.vocab_size, size=12)]
    g = GenerationHyperparameters(n=1, max_new_tokens=24, greedy=True,
                                  stop=tuple((t,) for t in range(0, cfg.vocab_size, 2)))

    class RecordingClient(EngineEpisodeClient):
        """Keeps every raw turn dict (the prefill accounting)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.outs = []

        def _drive(self, fn, ep_id):
            turn = super()._drive(fn, ep_id)
            self.outs.append(dict(turn))
            return turn

    def parse_calc(toks):
        a, b = (list(toks) * 2)[-2:]  # a 1-token turn too
        return ToolCall("calculator", f"{a % 9} + {b % 9}")

    def encode_obs(call, text, ok):
        return [8 + (ord(c) % 16) for c in text][:6] or [8]

    tools = ToolExecutor(timeout_s=10.0)

    # ---- calculator episodes and their prefill accounting ----
    eng = mk_engine(params)
    turns0 = metric_value("areal_episode_turns_total")
    done0 = metric_value("areal_episode_completed_total")
    episodes, clients = [], []
    for i in range(n_episodes):
        client = RecordingClient(eng, g, token_budget=0, seed=0)
        ctl = EpisodeController(client, tools, parse_calc, encode_obs, max_turns=3)
        episodes.append(ctl.run_episode(f"calc-{i}", prompt))
        clients.append(client)
    for ep, client in zip(episodes, clients):
        if ep.stop_reason != "max_turns" or ep.assistant_turns != 3:
            failures.append(f"{ep.episode_id}: expected 3 assistant turns ending max_turns, got "
                            f"{ep.assistant_turns} ({ep.stop_reason})")
            continue
        outs = client.outs
        # Later episodes share the first one's prompt pages.
        covered = outs[0]["prefill_tokens"] + outs[0]["shared_prefix_tokens"]
        if covered != len(prompt):
            failures.append(f"{ep.episode_id}: turn 1 covered {covered} tokens, want "
                            f"{len(prompt)}")
        tool_turns = [t for t in ep.turns if t.role == "tool"]
        for k, (o, tt) in enumerate(zip(outs[1:], tool_turns)):
            # No full re-prefill after turn 1: a turn prefills its
            # observation only.
            if o["prefill_tokens"] != len(tt.tokens):
                failures.append(f"{ep.episode_id} turn {k + 2}: prefilled "
                                f"{o['prefill_tokens']} tokens, want {len(tt.tokens)}")
        if len({o["slot"] for o in outs}) != 1:
            failures.append(f"{ep.episode_id}: turns hopped slots {[o['slot'] for o in outs]}")
    # For the JAX leg's one decode compile: one serving-chunk build.
    if eng.decode_compiles != 1:
        failures.append(f"the serving chunk was built {eng.decode_compiles} times across "
                        f"{n_episodes} episodes, want exactly 1")
    if eng.episode_prefix_hits < n_episodes - 1:
        failures.append(f"same-prompt episodes missed the prefix cache "
                        f"(hits={eng.episode_prefix_hits})")
    if eng.prefill_dispatches != 0:
        failures.append(f"the turn loop dispatched {eng.prefill_dispatches} admit prefills, "
                        "want 0 (observations ride the ragged serving path)")
    if eng.dead_live_lanes != 0:
        failures.append(f"the packed stream computed {eng.dead_live_lanes} misassigned live "
                        "lanes, want 0")
    if not (eng.lanes_live > 0
            and eng.lanes_live + eng.lanes_slack == eng.lanes_dispatched):
        failures.append(f"lane counters do not partition the stream: live={eng.lanes_live} "
                        f"slack={eng.lanes_slack} dispatched={eng.lanes_dispatched}")

    # ---- each assistant turn equals a single-shot replay of its prefix ----
    ep0 = episodes[0] if episodes else None
    if ep0 is not None and not failures:
        prefix = list(ep0.prompt_ids)
        for t in ep0.turns:
            if t.role == "assistant":
                r = mk_engine(params).generate(sample_of(prefix), MicroBatchSpec(), g,
                                               inflight=True)
                replayed = np.asarray(r.data["packed_input_ids"]).tolist()[len(prefix):]
                if replayed != t.tokens:
                    failures.append(f"greedy identity broke at turn {t.index}: episode "
                                    f"{t.tokens} vs replay {replayed}")
                    break
            prefix.extend(t.tokens)

    # ---- a code episode, graded in the sandbox ----
    code_text = "```python\nprint(int(input()) ** 2)\n```"
    code_client = RecordingClient(eng, g)
    code_ep = EpisodeController(
        code_client, tools, lambda toks: ToolCall("python_exec", "print(3 ** 2)"), encode_obs,
        max_turns=2,
    ).run_episode("code-0", prompt)
    code_tool = [t for t in code_ep.turns if t.role == "tool"]
    if not code_tool or not code_tool[0].tool_ok:
        failures.append(f"the code episode's tool run failed: "
                        f"{[(t.tool_name, t.tool_ok) for t in code_tool]}")
    code_ep.reward = float(grade_item({
        "task": "code", "text": code_text,
        "payload": {"input_output": {"inputs": ["3\n"], "outputs": ["9"]}, "timeout_s": 8.0},
    }))
    if code_ep.reward != 1.0:
        failures.append("the sandboxed code grader refused a correct solution")
    traj = code_ep.to_trajectory(qid="code-0")
    if len(traj.output_ids[0]) != len(traj.output_logprobs[0]):
        failures.append("the episode trajectory's logprobs and tokens differ in length")

    # ---- a push mid-episode parks the slot; the episode resumes on it ----
    params2 = tfm.init_params(cfg, 101, device=device)
    push_state = {"parked": False}

    def pusher():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and eng.episode_stats()["active"] == 0:
            time.sleep(0.002)
        eng.interrupt()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if eng.episode_stats()["parked_mid_turn"] >= 1:
                push_state["parked"] = True
                break
            time.sleep(0.002)
        eng.set_params(params2)
        eng.clear_interrupt()

    push_client = RecordingClient(eng, g)
    push_ctl = EpisodeController(push_client, tools, parse_calc, encode_obs, max_turns=4)
    th = threading.Thread(target=pusher)
    th.start()
    push_ep = push_ctl.run_episode("push-0", prompt)
    th.join(timeout=120)
    if th.is_alive():
        failures.append("the weight pusher never finished")
    if not push_state["parked"]:
        failures.append("the weight push never parked the episode mid-turn")
    if push_ep.status != "done" or push_ep.slot_lost != 0:
        failures.append(f"the pushed-through episode did not finish cleanly: status="
                        f"{push_ep.status} slot_lost={push_ep.slot_lost}")
    if len({o["slot"] for o in push_client.outs}) != 1:
        failures.append("the weight push moved the episode off its slot")

    n_eps = n_episodes + 2  # calculator, code, push
    turns_delta = metric_value("areal_episode_turns_total") - turns0
    if turns_delta < n_episodes * 3 + 2:
        failures.append(f"areal_episode_turns_total moved by {turns_delta}, want >= "
                        f"{n_episodes * 3 + 2}")
    if metric_value("areal_episode_completed_total") - done0 != n_eps:
        failures.append("areal_episode_completed_total did not track the episodes")
    if metric_value("areal_episode_active") != 0:
        failures.append("areal_episode_active did not drain to zero")
    if metric_value("areal_episode_tool_seconds_count") <= 0:
        failures.append("the tool latency histogram never observed")
    _print("agents", failures,
           f"{n_episodes} calculator episodes (3 turns, observation-only prefills, "
           f"decode_compiles={eng.decode_compiles}), greedy identity against single-shot "
           f"replays, the sandboxed code reward {code_ep.reward}, a push mid-episode parked "
           f"and resumed on one slot; engine episode stats {eng.episode_stats()}")
    return failures


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


LEGS = ("chaos", "trainer_chaos", "nan_chaos", "push_chaos", "verifier_chaos", "agents",
        "overlap")


def _device(args) -> torch.device:
    """The run's device, or SystemExit naming what is missing."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("check_async: no CUDA device is available (torch.cuda.is_available() "
                         "is False); the checks run on the card, or on the CPU with "
                         "--device cpu")
    if device.type == "cuda" and args.model == "tiny":
        raise SystemExit("check_async: --model tiny has head_dim 16, and the port's kernels "
                         "take head_dim 64 or 128 only (ROADMAP queue 1 item 9): on the card "
                         "use --model qwen2-1.5b (--layers N cuts its depth)")
    return device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="check_async", description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=MODELS, default=None,
                   help="tiny (the CPU's default) or qwen2-1.5b (the card's)")
    p.add_argument("--layers", type=int, default=None, help="cut the model to N layers")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--prompts", type=int, default=24)
    p.add_argument("--versions", type=int, default=3,
                   help="in-memory weight pushes in the serving check")
    p.add_argument("--dir", default=None, help="fileroot of the trials (default: a tempdir)")
    p.add_argument("--chaos", action="store_true",
                   help="run ONLY the elastic-fleet chaos leg (3 servers, one killed "
                        "mid-decode via AREAL_FAULTS)")
    p.add_argument("--overlap", action="store_true",
                   help="run ONLY the pipeline-overlapped PPO leg (barrier vs streamed "
                        "executor A/B)")
    p.add_argument("--bench-out", default=None,
                   help="not ported: the port's benchmark is its own harness")
    p.add_argument("--trainer-chaos", action="store_true",
                   help="run ONLY the crash-safe trainer plane leg (worker hang mid-MFC -> "
                        "deadline recovery; master killed mid-recover-save -> manifest "
                        "fallback)")
    p.add_argument("--trainer-chaos-victim", metavar="DIR", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--rows", type=int, default=16, help=argparse.SUPPRESS)
    p.add_argument("--lr", type=float, default=5e-3, help=argparse.SUPPRESS)
    p.add_argument("--actor-path", default=None, help=argparse.SUPPRESS)
    p.add_argument("--nan-chaos", action="store_true",
                   help="run ONLY the numerical-integrity guard plane leg (NaN grads -> "
                        "quarantine; streak -> rollback + bit-exact replay; corrupt push -> "
                        "checksum rejection)")
    p.add_argument("--agents", action="store_true",
                   help="run ONLY the agent-serving runtime leg (multi-turn tool-use "
                        "episodes on persistent KV slots, sandboxed code reward, "
                        "mid-episode weight push)")
    p.add_argument("--push-chaos", action="store_true",
                   help="run ONLY the parameter-distribution-fabric chaos leg (5 servers, "
                        "broadcast-tree push, first relay killed mid-broadcast)")
    p.add_argument("--verifier-chaos", action="store_true",
                   help="run ONLY the verifier-service-fleet chaos leg (3 graders, one "
                        "killed mid-grade; task mixtures; slow-verifier A/B)")
    args = p.parse_args(argv)
    if args.bench_out:
        print("check_async: --bench-out is not ported: it wrote the JAX package's CPU bench "
              "rows, and the port's benchmark is a harness of its own", file=sys.stderr)
        return 2
    if args.model is None:
        args.model = "tiny" if torch.device(args.device).type == "cpu" else "qwen2-1.5b"
    device = _device(args)
    cfg = model_config(args.model, args.layers)
    os.environ.setdefault("AREAL_PAGING_CHECK", "1")  # the paranoid page allocator
    if device.type == "cpu":
        torch.set_num_threads(1)  # bit-for-bit comparisons need one CPU thread

    if args.trainer_chaos_victim:
        return _trainer_chaos_victim(cfg, device, args.trainer_chaos_victim, args.rows,
                                     actor_path=args.actor_path, lr=args.lr)

    def fileroot(prefix):
        return args.dir or tempfile.mkdtemp(prefix=prefix)

    chosen = [leg for leg in LEGS if getattr(args, leg)]
    if len(chosen) > 1:
        p.error(f"one leg at a time, got {chosen}")
    leg = chosen[0] if chosen else None
    runs = {
        "trainer_chaos": (lambda: check_trainer_chaos(
            cfg, device, fileroot("areal_tpu_torch_trainer_chaos_"), cfg_name=args.model,
            layers=args.layers, n_rows=args.rows),
            "crash-safe trainer plane survived the injected faults"),
        "nan_chaos": (lambda: check_nan_chaos(cfg, device, fileroot("areal_tpu_torch_nan_chaos_")),
                      "numerical-integrity guard plane survived the injected corruption"),
        "agents": (lambda: check_agents(cfg, device), "agent-serving runtime verified end to end"),
        "verifier_chaos": (lambda: check_verifier_chaos(cfg, device),
                           "verifier service fleet survived the injected kill"),
        "push_chaos": (lambda: check_push_chaos(cfg, device),
                       "parameter distribution fabric survived the killed relay"),
        "chaos": (lambda: check_chaos(cfg, device),
                  "elastic rollout fleet survived the injected kill"),
        "overlap": (lambda: check_overlap(cfg, device, fileroot("areal_tpu_torch_overlap_check_")),
                    "pipeline-overlapped PPO verified against the barrier"),
        None: (lambda: (check_serving_plane(cfg, device, args.prompts, args.versions)
                        + check_trainer_plane(cfg, device,
                                              fileroot("areal_tpu_torch_async_check_"))),
               "asynchronous RL loop verified end to end"),
    }
    fn, ok_line = runs[leg]
    failures = fn()
    if failures:
        print(f"FAIL: {len(failures)} {(leg or 'async').replace('_', '-')} check(s) failed")
        return 1
    print(f"OK: {ok_line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
