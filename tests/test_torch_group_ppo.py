"""ppo-math on the SPMD worker group across real processes (ROADMAP queue
1, item 8.6a), on the CPU over gloo:

- `build_ppo_math(actor_parallel=d2, critic_parallel=d2)` through the
  multi-process runtime: the actor, the critic and the ref on a d2 mesh
  over two worker processes, the generator one engine a member over its
  own prompts (greedy; the seeded null reward and the critic, as
  tests/test_torch_multiprocess.py's trial, so the update carries a
  signal above the engines' rounding; one PPO minibatch, since each
  member splits its own rows into minibatches).  Every actor_train and
  critic_train stat of both steps equals the one-process trial's
  (`actor_parallel=d1`) and the JAX package's d2 trial on its CPU mesh
  within rtol 1e-4, atol 1e-6 (tests/test_torch_experiments.py's parity
  tolerance), and the generated tokens are the one-process trial's.
- `quickstart ppo-math --allocation d2` runs its trial on two worker
  processes: both members generate and train every step, the stats are
  finite, the ref sits on the group."""

import json
import os

import jax
import numpy as np
import pytest

from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base.topology import ParallelConfig as JParallelConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.apps import main as runner
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.base.topology import ParallelConfig
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from tests import fixtures
from tests.test_torch_group_sft import _restore_runtime_env  # noqa: F401

ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grp")
    ckpt = str(tmp / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    data = tmp / "math.jsonl"
    with open(data, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return tmp, ckpt, str(data)


def _cfg(package, inputs, sub, layout):
    tmp, ckpt, data = inputs
    if package == "port":
        ex, ma, ia, da, gen, opt, ctrl, par = (
            exps, ModelAbstraction, ModelInterfaceAbstraction, DatasetAbstraction,
            GenerationHyperparameters, OptimizerConfig, ExperimentSaveEvalControl,
            ParallelConfig)
    else:
        ex, ma, ia, da, gen, opt, ctrl, par = (
            jexps, JModelAbstraction, JInterfaceAbstraction, JDatasetAbstraction, JGen,
            JOptimizerConfig, JCtrl, JParallelConfig)
    return ex.PPOMathConfig(
        actor=ma("hf", {"path": ckpt}), ref=ma("hf", {"path": ckpt}),
        critic=ma("hf", {"path": ckpt, "is_critic": True}),
        dataset=da("math_code_prompt", {"dataset_path": data, "max_length": 64}),
        reward_interface=ia("null", {"seed": 5}),
        gconfig=gen(n=2, max_new_tokens=8, greedy=True),
        # One PPO minibatch: under the shard-exact dispatch each member
        # splits its own rows into minibatches (`SequenceSample.
        # split_balanced`), as the JAX package's multi-process group
        # does, so two minibatches would hold other rows than the one
        # process's global split.
        ppo_kwargs={"n_minibatches": 1, "kl_ctl": 0.1},
        optimizer=opt(lr=1e-4, warmup_steps_proportion=0.0),
        actor_parallel=par.from_str(layout), critic_parallel=par.from_str(layout),
        batch_size=4, total_train_epochs=1, ctrl=ctrl(benchmark_steps=2),
        experiment_name="ppo-group", trial_name=sub, fileroot=str(tmp / sub),
    )


def test_ppo_group_matches_one_process_and_jax(inputs):
    tmp, _, _ = inputs
    plan = exps.build_ppo_math(_cfg("port", inputs, "group", "d2"))
    for wc in plan.worker_configs:
        wc.tokenizer_path = "char:512"
    assert plan.model_groups == {"actor@0": [0, 1], "ref@0": [0, 1], "critic@0": [0, 1]}
    group = runner.run_experiment(plan, device="cpu", worker_env=ONE_THREAD)
    solo_plan = exps.build_ppo_math(_cfg("port", inputs, "solo", "d1"))
    _, solo = exps.run_experiment(solo_plan, tokenizer=fixtures.make_tokenizer(), device="cpu")
    _, jstats = jexps.run_experiment(jexps.build_ppo_math(_cfg("jax", inputs, "jax", "d2")),
                                     tokenizer=fixtures.make_tokenizer())
    assert len(group) == len(solo) == len(jstats) == 2
    for step in range(2):
        keys = [k for k in solo[step] if k.split("/")[0] in ("actor_train", "critic_train")
                and "/perf/" not in k and "/time/" not in k and "n_micro_batches" not in k]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(group[step][k], solo[step][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")
            np.testing.assert_allclose(group[step][k], jstats[step][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")
        assert abs(group[step]["actor_train/advantage_abs"]) > 0.1
        for k in ("n_response_tokens", "no_eos_ratio"):
            assert group[step][f"actor_train/{k}"] == solo[step][f"actor_train/{k}"]
    # Both members generated: each ran its own generate call a step.
    for w in (0, 1):
        with open(os.path.join(tmp, "group", "logs", "ppo-group_group-attempt0",
                               f"model_worker-{w}.log")) as f:
            log = f.read()
        assert "built model actor_gen@0" in log and "layout d2" in log


def test_quickstart_ppo_allocation_d2_runs_on_two_processes(inputs, tmp_path, monkeypatch):
    _, ckpt, data = inputs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    stats = quickstart.main(
        ["ppo-math", "--model.path", ckpt, "--dataset.path", data, "--tokenizer-path",
         "char:512", "--batch-size", "4", "--group-size", "2", "--max-new-tokens", "8",
         "--benchmark-steps", "2", "--ref-path", ckpt, "--kl-ctl", "0.1",
         "--allocation", "d2", "--fileroot", str(tmp_path)],
        device="cpu",
    )
    assert len(stats) == 2
    for s in stats:
        assert np.isfinite(s["actor_train/actor_loss"]) and s["actor_train/quarantined"] == 0
        assert s["actor_gen/perf/time_s"] > 0 and s["ref_inf/perf/time_s"] > 0
    logs = os.path.join(tmp_path, "logs", "ppo-math_trial0-attempt0")
    assert sorted(os.listdir(logs)) == ["model_worker-0.log", "model_worker-1.log"]
    with open(os.path.join(logs, "model_worker-1.log")) as f:
        log = f.read()
    assert "built model ref@0" in log and "process 1/2 joining the world" in log
