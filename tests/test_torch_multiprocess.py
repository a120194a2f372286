"""A generate/train split over two workers, in one process and in
several, against the JAX package (the done criterion of the JAX
package's runtime, tests/test_runtime_zmq.py:176, at tiny size on the
CPU).  The plan: ppo-math with a critic, a ref and KL control from a
checkpoint the JAX package wrote, greedy generation, the seeded null
reward, `placement={"actor_gen": 1, "reward": 1}` (the actor, the
critic and the ref on worker 0; the generator and the reward on worker
1), so prompts, rollouts, rewards and the actor's weights all cross
between workers.  (With greedy generation a group's responses are
equal, so GRPO's group-normalized advantages would cancel: the critic's
advantages give the update a signal above the engines' rounding.)

- The two-worker in-process trial against the JAX package's in-process
  trial of the same plan: greedy tokens identical, the train stats
  within tests/test_torch_experiments.py's parity tolerances, the same
  transfer/* keys and counts.
- The same plan with worker subprocesses (`apps/main.run_experiment`,
  `device="cpu"` passed down): every stat but the wall times equal to
  the in-process trial's, bit for bit on one thread a process.
- Kill and retry: worker 0 exits at step 2's first train step (the
  third of `kill@point=mfc_train_step`: the actor and the critic train
  once a step; worker 0's environment only); the launcher's
  watch fails the attempt, the retry resubmits both workers and resumes
  from step 1's recover checkpoint, and step 2 equals the uninterrupted
  trial's bit for bit.
- In-run recovery, in both packages: the third train request (step 2's
  first) hangs, the request's deadline declares the worker dead, a
  relauncher releases the hang and revives it, the master rolls back to
  step 1's checkpoint and finishes: one recovery, the three liveness
  counters each moved by 1, and every step's stats equal the
  uninterrupted trial's.
"""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGenerationHyperparameters
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.interfaces import null as jnull
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.apps import main as runner
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.interfaces import null as tnull
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from tests import fixtures

PLACEMENT = {"actor_gen": 1, "reward": 1}
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_TOKENS = {"jax": [], "port": []}


@pytest.fixture(autouse=True)
def _restore_runtime_env():
    """run_experiment points this process at the trial's name-resolve
    store and authkey (as the JAX launcher does); later tests get theirs
    back."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.stream import ENV_AUTHKEY

    keys = ("AREAL_NAME_RESOLVE", "AREAL_NAME_RESOLVE_ROOT", ENV_AUTHKEY)
    saved = {k: os.environ.get(k) for k in keys}
    default = name_resolve._default
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    name_resolve._default = default


def _timeless(stats):
    return {k: v for k, v in stats.items()
            if "/perf/" not in k and "time" not in k and not k.endswith("_s")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    ckpt = str(tmp / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    data = tmp / "math.jsonl"
    with open(data, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return tmp, ckpt, str(data)


def _port_cfg(inputs, sub, reward=None, **kw):
    tmp, ckpt, data = inputs
    return exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        ref=ModelAbstraction("hf", {"path": ckpt}),
        critic=ModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": data, "max_length": 64}),
        reward_interface=reward or ModelInterfaceAbstraction("null", {"seed": 5}),
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        batch_size=4, total_train_epochs=1,
        ctrl=kw.pop("ctrl", ExperimentSaveEvalControl(benchmark_steps=2)),
        placement=PLACEMENT, fileroot=str(tmp / sub), **kw,
    )


def _jax_cfg(inputs, sub, reward=None, **kw):
    tmp, ckpt, data = inputs
    return jexps.PPOMathConfig(
        actor=JModelAbstraction("hf", {"path": ckpt}),
        ref=JModelAbstraction("hf", {"path": ckpt}),
        critic=JModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        dataset=JDatasetAbstraction("math_code_prompt", {"dataset_path": data, "max_length": 64}),
        reward_interface=reward or JInterfaceAbstraction("null", {"seed": 5}),
        gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
        optimizer=JOptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        batch_size=4, total_train_epochs=1,
        ctrl=kw.pop("ctrl", JCtrl(benchmark_steps=2)),
        placement=PLACEMENT, fileroot=str(tmp / sub), **kw,
    )


def _port_plan(cfg):
    plan = exps.build_ppo_math(cfg)
    for wc in plan.worker_configs:
        wc.tokenizer_path = "char:512"
    return plan


def _recording(cls, pkg):
    orig = cls.inference

    def inference(self, model, sample, mb_spec):
        _TOKENS[pkg].append((list(sample.ids), np.asarray(sample.data["packed_input_ids"]).copy()))
        return orig(self, model, sample, mb_spec)

    return inference


@pytest.fixture(scope="module")
def inproc_runs(inputs):
    """The plan in one process, in both packages (the port on one
    thread); the tokens each reward call graded."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnull.NullInterface, "inference", _recording(jnull.NullInterface, "jax"))
    mp.setattr(tnull.NullInterface, "inference", _recording(tnull.NullInterface, "port"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jplan = jexps.build_ppo_math(_jax_cfg(inputs, "jax"), fixtures.make_tokenizer())
        jmaster, jstats = jexps.run_experiment(jplan, tokenizer=fixtures.make_tokenizer())
        master, stats = exps.run_experiment(_port_plan(_port_cfg(inputs, "port")),
                                            tokenizer=CharTokenizer(512), device="cpu")
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return dict(jax=jstats, port=stats, master=master, jmaster=jmaster)


def test_two_worker_plan_places_as_jax(inputs):
    plan = _port_plan(_port_cfg(inputs, "p"))
    jplan = jexps.build_ppo_math(_jax_cfg(inputs, "j"))
    assert plan.model_placement == jplan.model_placement == {
        "actor@0": 0, "actor_gen@0": 1, "reward@0": 1, "ref@0": 0, "critic@0": 0}
    assert [sorted(str(s.name) for s in wc.shards) for wc in plan.worker_configs] == [
        sorted(str(s.name) for s in wc.shards) for wc in jplan.worker_configs]
    assert [len(wc.datasets) for wc in plan.worker_configs] == [1, 0]
    assert plan.data_worker_ids == jplan.data_worker_ids == [0]


def test_two_worker_trial_matches_jax(inproc_runs):
    jstats, stats = inproc_runs["jax"], inproc_runs["port"]
    assert len(_TOKENS["port"]) == len(_TOKENS["jax"]) == 2
    for (tids, ttoks), (jids, jtoks) in zip(_TOKENS["port"], _TOKENS["jax"]):
        assert tids == jids
        np.testing.assert_array_equal(ttoks, jtoks)
    assert len(stats) == len(jstats) == 2
    for step, (got, want) in enumerate(zip(stats, jstats)):
        keys = [k for k in got if k.split("/")[0] in ("actor_train", "critic_train")
                and "/perf/" not in k and "/time/" not in k]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")
        assert got["actor_train/advantage_abs"] > 0.1
        xfer = sorted(k for k in got if k.startswith("transfer/"))
        assert xfer == sorted(k for k in want if k.startswith("transfer/"))
        assert {"transfer/data_count", "transfer/param_count", "transfer/param_bytes"} <= set(xfer)
        for k in ("transfer/data_count", "transfer/param_count"):
            assert got[k] == want[k], k


def test_multiprocess_trial_equals_inprocess(inputs, inproc_runs):
    """The plan with each worker in a subprocess on the CPU."""
    timeline = []
    stats = runner.run_experiment(_port_plan(_port_cfg(inputs, "mp")), device="cpu",
                                  worker_env=ONE_THREAD, timeline=timeline)
    assert [e["event"] for e in timeline] == ["submit", "connected", "done"]
    want = inproc_runs["port"]
    assert len(stats) == len(want) == 2
    for got, ref in zip(stats, want):
        assert _timeless(got) == _timeless(ref)
        assert got["transfer/param_bytes"] == ref["transfer/param_bytes"] > 0


def test_kill_and_retry_resumes_bit_for_bit(inputs, inproc_runs):
    ctrl = ExperimentSaveEvalControl(benchmark_steps=2, ckpt_freq_steps=1)
    plan = _port_plan(_port_cfg(inputs, "kill", ctrl=ctrl))
    timeline = []
    stats = runner.run_experiment(
        plan, device="cpu", recover_retries=1, worker_env=ONE_THREAD, timeline=timeline,
        worker_envs={0: {"AREAL_FAULTS": "kill@point=mfc_train_step&skip=2&times=1"}},
    )
    events = [(e["event"], e.get("attempt")) for e in timeline]
    assert events == [("submit", 0), ("connected", None), ("failed", 0),
                      ("submit", 1), ("connected", None), ("done", 1)], events
    assert "model_worker/0" in timeline[2]["error"]
    log0 = os.path.join(plan.fileroot, "logs", "ppo-math_trial-attempt0", "model_worker-0.log")
    with open(log0) as f:
        assert "FAULT kill at point 'mfc_train_step'" in f.read()
    # Attempt 1 ran step 2 only, from step 1's checkpoint.
    assert len(stats) == 1
    assert _timeless(stats[0]) == _timeless(inproc_runs["port"][1])


# ---------------- in-run recovery, in both packages ----------------

_PARITY_REWARD = "multiprocess-test-reward-by-query-id"


def _reward_class(sample_cls, base):
    """+5 / -5 by the parity of each prompt's query id (deterministic, so
    a replayed step grades as the first run did)."""

    @dataclasses.dataclass
    class ParityReward(base):
        def inference(self, model, sample, mb_spec):
            seqlens, rewards = [], []
            for sid, group in zip(sample.ids, sample.seqlens["packed_input_ids"]):
                seqlens.append([1] * len(group))
                rewards += [5.0 if int(str(sid).split("-")[1]) % 2 else -5.0] * len(group)
            return sample_cls(keys={"rewards"}, ids=list(sample.ids),
                              seqlens={"rewards": seqlens},
                              data={"rewards": np.asarray(rewards, np.float32)})

    return ParityReward


if _PARITY_REWARD not in model_api.ALL_INTERFACES:
    model_api.register_interface(_PARITY_REWARD, _reward_class(SequenceSample,
                                                               model_api.ModelInterface))
if _PARITY_REWARD not in jmodel_api.ALL_INTERFACES:
    jmodel_api.register_interface(_PARITY_REWARD, _reward_class(JSequenceSample,
                                                                jmodel_api.ModelInterface))


def _package(pkg):
    if pkg == "jax":
        from areal_tpu.base import metrics
        from areal_tpu.system.master import InProcessPool, MasterWorker
        from areal_tpu.system.transfer import InProcTransfer
        from areal_tpu.system.worker import ModelWorker

        return dict(metrics=metrics, pool=InProcessPool, master=MasterWorker,
                    planes=InProcTransfer, worker=ModelWorker,
                    reward=JInterfaceAbstraction(_PARITY_REWARD), cfg=_jax_cfg, ctrl=JCtrl,
                    tok=fixtures.make_tokenizer, dev={})
    from areal_tpu_torch.base import metrics
    from areal_tpu_torch.system.master import InProcessPool, MasterWorker
    from areal_tpu_torch.system.transfer import InProcTransfer
    from areal_tpu_torch.system.worker import ModelWorker

    return dict(metrics=metrics, pool=InProcessPool, master=MasterWorker, planes=InProcTransfer,
                worker=ModelWorker, reward=ModelInterfaceAbstraction(_PARITY_REWARD),
                cfg=_port_cfg, ctrl=ExperimentSaveEvalControl, tok=lambda: CharTokenizer(512),
                dev={"device": "cpu"})


def _trial(p, inputs, sub, fault=None, timeout=None):
    cfg = p["cfg"](inputs, sub, reward=p["reward"], mfc_timeout_s=timeout,
                   ctrl=p["ctrl"](benchmark_steps=3, ckpt_freq_steps=1))
    build = jexps.build_ppo_math if p["cfg"] is _jax_cfg else exps.build_ppo_math
    plan = build(cfg, p["tok"]())
    planes = p["planes"].make_group(len(plan.worker_configs))
    if fault:
        os.environ["AREAL_FAULTS"] = fault
    try:
        workers = [p["worker"](wc, tokenizer=p["tok"](), transfer=planes[i], **p["dev"])
                   for i, wc in enumerate(plan.worker_configs)]
    finally:
        os.environ.pop("AREAL_FAULTS", None)
    pool = p["pool"](workers, mfc_timeout_s=timeout)
    relaunches = []

    def relauncher(dead):
        # The in-process stand-in for a relaunch: release the hung thread
        # and clear the verdict.
        for w in workers:
            if w._faults is not None:
                w._faults.release()
        for wid in dead:
            pool.revive(wid)
        relaunches.append(sorted(dead))

    master = p["master"](
        dfg=plan.dfg, pool=pool, model_placement=plan.model_placement,
        data_worker_ids=plan.data_worker_ids, ctrl=plan.ctrl, fileroot=plan.fileroot,
        experiment_name=plan.experiment_name, trial_name=plan.trial_name,
        max_recoveries=plan.max_recoveries, worker_relauncher=relauncher,
    )
    master.load_recover_info()
    import asyncio

    t0 = time.monotonic()
    stats = asyncio.run(master.run())
    return master, stats, relaunches, workers, time.monotonic() - t0


COUNTERS = ("areal_master_worker_dead_total", "areal_master_mfc_timeout_total",
            "areal_master_recoveries_total")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_in_run_recovery(inputs, pkg):
    p = _package(pkg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, base, _, _, _ = _trial(p, inputs, f"{pkg}-base")
        # The deadline clears the slowest honest request of the fresh
        # trial with room to spare (first calls compile).
        slowest = max(v for s in base for k, v in s.items() if k.endswith("perf/time_s"))
        timeout = max(6.0, 3.0 * slowest)  # above the 5 s heartbeat period
        reg = p["metrics"].default_registry()
        before = {n: reg.get(n).get() if reg.get(n) else 0.0 for n in COUNTERS}
        master, stats, relaunches, workers, _ = _trial(
            p, inputs, f"{pkg}-chaos", fault="hang@point=mfc_train_step&skip=2&times=1",
            timeout=timeout)
    finally:
        torch.set_num_threads(threads)
    hangs = sum(w._faults.fired.get("hang", 0) for w in workers if w._faults is not None)
    assert hangs == 1 and relaunches == [[0]] and master._recoveries == 1
    for n in COUNTERS:
        assert reg.get(n).get() - before[n] == 1, n
    assert len(stats) == len(base) == 2 and master.step_info.global_step == 2
    for got, want in zip(stats, base):
        keys = [k for k in _timeless(want) if not k.startswith("transfer/")]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert base[-1]["actor_train/advantage_abs"] > 0.1
