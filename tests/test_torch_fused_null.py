"""The fused reward+ref MFC and the null trials against the JAX package:

- `FusedThreadingInterface` (registered "fused") gives what its
  sub-interfaces give when each runs alone, bit for bit;
- a `fuse_rew_ref` ppo-math trial (greedy generation, the parity reward
  of tests/test_torch_experiments.py, a ref with KL control and a
  critic, two steps, as that file's parity case) has one `fused_rew_ref`
  MFC in place of `rew_inf` and `ref_inf`, and its actor and critic
  stats equal the port's unfused trial bit for bit (one CPU thread) and
  the JAX package's fused trial within the parity case's rtol 1e-4,
  atol 1e-6;
- the null trials (twins of tests/test_null_profile.py): the same stats
  in both packages, and the same random rewards reach the train MFC."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.model_api import GenerationHyperparameters as JGenerationHyperparameters
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.experiments import null as jnull
from areal_tpu.experiments.common import run_experiment as jrun_experiment
from areal_tpu.interfaces import null as jnull_if
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    GenerationHyperparameters,
    Model,
    OptimizerConfig,
    make_interface,
)
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.experiments import null as tnull
from areal_tpu_torch.interfaces import null as tnull_if
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from tests import fixtures
from tests.test_torch_experiments import _PARITY_REWARD

torch.set_num_threads(2)


def test_fused_interface_equals_its_parts():
    """The math reward and the ref's forward through one fused call (as
    dicts and as abstractions): the same rewards and logprobs as each
    sub-interface alone, bit for bit."""
    rows = fixtures.build_math_rows(4, seed=2)
    tok = CharTokenizer(512)
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(8, 30, 4)]
    sample = SequenceSample(
        keys={"packed_input_ids", "prompt_mask"}, ids=[r["query_id"] for r in rows],
        seqlens={"packed_input_ids": [[n] for n in lens], "prompt_mask": [[n] for n in lens]},
        data={"packed_input_ids": rng.integers(0, 256, sum(lens)).astype(np.int32),
              "prompt_mask": np.concatenate([np.arange(n) < 4 for n in lens])},
    )
    cfg = ttiny()
    model = Model("ref", InferenceEngine(cfg, ttfm.init_params(cfg, 0, device="cpu"), "cpu"),
                  tok, cfg)
    rew = {"type_": "rw-math-code", "args": {"id2info": {r["query_id"]: r for r in rows}}}
    mb = MicroBatchSpec()
    alone = {"rew": make_interface(rew["type_"], **rew["args"]).inference(model, sample, mb),
             "ref": make_interface("ppo_actor").inference(model, sample, mb)}
    for spec in (rew, ModelInterfaceAbstraction(rew["type_"], rew["args"])):
        fused = make_interface("fused", interfaces={"rew": spec, "ref": {"type_": "ppo_actor"}})
        out = fused.inference(model, sample, mb)
        assert out.keys == {"rewards", "logprobs"} and out.ids == sample.ids
        np.testing.assert_array_equal(out.data["rewards"], alone["rew"].data["rewards"])
        np.testing.assert_array_equal(out.data["logprobs"], alone["ref"].data["logprobs"])


def _trial_cfgs(tmp_path, ckpt, rows, fuse):
    common = dict(batch_size=4, total_train_epochs=1, ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
                  fuse_rew_ref=fuse)
    tag = "fused" if fuse else "unfused"
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("hf", {"path": ckpt}), ref=JModelAbstraction("hf", {"path": ckpt}),
        critic=JModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        dataset=JDatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=JInterfaceAbstraction(_PARITY_REWARD),
        gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=JOptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=JCtrl(benchmark_steps=2), fileroot=str(tmp_path / f"jax-{tag}"), **common,
    )
    tcfg = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}), ref=ModelAbstraction("hf", {"path": ckpt}),
        critic=ModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=ModelInterfaceAbstraction(_PARITY_REWARD),
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2), fileroot=str(tmp_path / f"port-{tag}"),
        **common,
    )
    return jcfg, tcfg


def _train_stats(stats):
    return [{k: v for k, v in s.items() if k.split("/")[0] in ("actor_train", "critic_train")
             and "/perf/" not in k and "/time/" not in k} for s in stats]


def test_fused_trial_matches_jax_and_unfused(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    rows = fixtures.build_math_rows(8, seed=4)
    jcfg, tcfg = _trial_cfgs(tmp_path, ckpt, rows, fuse=True)
    _, ucfg = _trial_cfgs(tmp_path, ckpt, rows, fuse=False)
    plan = exps.build_ppo_math(tcfg)
    names = {n.name for n in plan.dfg.nodes}
    assert "fused_rew_ref" in names and not names & {"rew_inf", "ref_inf"}
    assert {str(s.name) for s in plan.worker_configs[0].shards} == {
        "actor@0", "actor_gen@0", "ref@0", "critic@0"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # bit-for-bit CPU reductions
    try:
        _, fused = exps.run_experiment(plan, tokenizer=CharTokenizer(512), device="cpu")
        _, unfused = exps.run_experiment(exps.build_ppo_math(ucfg), tokenizer=CharTokenizer(512),
                                         device="cpu")
    finally:
        torch.set_num_threads(threads)
    _, jfused = jrun_experiment(jexps.build_ppo_math(jcfg), tokenizer=fixtures.make_tokenizer())
    assert len(fused) == len(unfused) == len(jfused) == 2
    assert all(s["fused_rew_ref/perf/time_s"] > 0 for s in fused)
    for step, (got, same, want) in enumerate(zip(_train_stats(fused), _train_stats(unfused),
                                                 _train_stats(jfused))):
        assert len(got) > 20 and got == same, step + 1
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")


def test_fuse_rew_ref_without_a_ref_raises(tmp_path):
    rows = fixtures.build_math_rows(8, seed=4)
    _, tcfg = _trial_cfgs(tmp_path, str(tmp_path), rows, fuse=True)
    with pytest.raises(ValueError, match="requires a ref model"):
        exps.build_ppo_math(dataclasses.replace(tcfg, ref=None, ppo_kwargs={}))


# ---------------- the null trials ----------------


def _null_run(pkg, tmp_path, builder, rows, dataset, monkeypatch):
    """Run one null trial in `pkg`, recording the rewards each train MFC
    receives."""
    seen = []
    iface, mod, abstraction, ctrl, run, tok = (
        (jnull_if, jnull, JDatasetAbstraction, JCtrl, jrun_experiment, fixtures.make_tokenizer())
        if pkg == "jax" else
        (tnull_if, tnull, DatasetAbstraction, ExperimentSaveEvalControl,
         lambda plan, tokenizer: exps.run_experiment(plan, tokenizer=tokenizer, device="cpu"),
         CharTokenizer(512)))
    train_step = iface.NullInterface.train_step

    def recording(self, model, sample, mb_spec):
        if "rewards" in sample.keys:
            seen.append(np.asarray(sample.data["rewards"]).copy())
        return train_step(self, model, sample, mb_spec)

    monkeypatch.setattr(iface.NullInterface, "train_step", recording)
    cfg = mod.NullSFTConfig(
        dataset=abstraction(dataset, {"dataset_builder": lambda: rows, "max_length": 64}),
        batch_size=4, total_train_epochs=1, ctrl=ctrl(benchmark_steps=2),
        fileroot=str(tmp_path / pkg),
    )
    plan = getattr(mod, builder)(cfg)
    _, stats = run(plan, tokenizer=tok)
    return plan, stats, seen


def test_null_sft_runs(tmp_path, monkeypatch):
    rows = fixtures.build_sft_rows(8, seed=3)
    for pkg in ("jax", "port"):
        _, stats, _ = _null_run(pkg, tmp_path, "build_null_sft", rows, "prompt_answer",
                                monkeypatch)
        assert len(stats) == 2, pkg
        assert stats[0]["null/n_seqs"] == 4.0, pkg


def test_null_ppo_two_mfc_graph(tmp_path, monkeypatch):
    """rew_inf -> actor_train over prompt data: the same random rewards
    (numpy's generator, seeded alike) reach the train MFC in both
    packages."""
    rows = fixtures.build_math_rows(8, seed=3)
    runs = {pkg: _null_run(pkg, tmp_path, "build_null_ppo", rows, "math_code_prompt",
                           monkeypatch)
            for pkg in ("jax", "port")}
    for pkg, (plan, stats, seen) in runs.items():
        assert {n.name for n in plan.dfg.nodes} == {"rew_inf", "actor_train"}, pkg
        assert len(stats) == 2 and stats[0]["actor_train/null/n_seqs"] == 4.0, pkg
        assert len(seen) == 2 and all(r.shape == (4,) for r in seen), pkg
    for got, want in zip(runs["port"][2], runs["jax"][2]):
        np.testing.assert_array_equal(got, want)
