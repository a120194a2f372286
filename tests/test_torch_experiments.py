"""The port's experiment runtime against the JAX package's: the ppo-math
DFG that `build_ppo_math` builds (twin of tests/test_experiments.py:49),
the in-process trial through `run_experiment` (twins of
`test_ppo_math_e2e[grpo|value]`, tests/test_experiments.py:144), and a
two-step parity case: one tiny checkpoint written by the JAX package,
greedy generation, a deterministic reward that gives the prompts
different scores, through both packages' `run_experiment` — equal
tokens, the per-step train stats and the saved checkpoints within the
tolerances of tests/test_torch_ppo.py's train step, a non-zero update."""

import dataclasses
import os

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
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api import model_api
from areal_tpu_torch.base.topology import ParallelConfig
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, SequenceSample
from areal_tpu_torch.api.dfg import ParamReallocHook
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.system.master import (
    ExperimentSaveEvalControl,
    InProcessPool,
    MasterWorker,
)
from tests import fixtures

torch.set_num_threads(2)


def _graph(plan):
    """Everything of a plan's DFG a runtime reads, package-neutral."""

    def hook(h):
        target = None if h.target is None else str(h.target)
        return (type(h).__name__, target, getattr(h, "eta", None))

    nodes = []
    for n in plan.dfg.nodes:
        nodes.append(dict(
            name=n.name, model=str(n.model_name), itype=n.interface_type.value,
            interface=n.interface_impl.type_, inputs=n.input_keys, outputs=n.output_keys,
            in_remap=n.input_key_remap, out_remap=n.output_key_remap, n_seqs=n.n_seqs,
            shard_keys=tuple(n.shard_keys),
            pre=[hook(h) for h in n.pre_hooks], post=[hook(h) for h in n.post_hooks],
            parents=[p.name for p in n.parents], children=[c.name for c in n.children],
        ))
    levels = [[n.name for n in lvl] for lvl in plan.dfg.topological_order()]
    shards = [(str(s.name), s.model.type_, s.backend.type_, s.interface.type_)
              for wc in plan.worker_configs for s in wc.shards]
    return nodes, levels, sorted(plan.dfg.dataset_keys), plan.model_placement, shards


GRAPH_CASES = {
    "grpo": dict(ref=False, critic=False, offload_ref=False),
    "grpo_ref_offload": dict(ref=True, critic=False, offload_ref=True),
    "grpo_ref_ema_offload": dict(ref=True, critic=False, offload_ref=True, ref_ema_eta=0.9),
    "value": dict(ref=True, critic=True, offload_ref=False),
    "grpo_ref_fused_offload": dict(ref=True, critic=False, offload_ref=True, fuse_rew_ref=True),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_ppo_graph_matches_jax(case):
    kw = GRAPH_CASES[case]
    rows = lambda: fixtures.build_math_rows(8)  # noqa: E731
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("random", {"config": jtiny()}),
        critic=JModelAbstraction("random", {"config": jtiny(is_critic=True)})
        if kw["critic"] else None,
        ref=JModelAbstraction("random", {"config": jtiny()}) if kw["ref"] else None,
        dataset=JDatasetAbstraction("prompt", {"dataset_builder": rows}),
        ppo_kwargs={"kl_ctl": 0.1} if kw["ref"] else {}, offload_ref=kw["offload_ref"],
        ref_ema_eta=kw.get("ref_ema_eta"), fuse_rew_ref=kw.get("fuse_rew_ref", False),
    )
    tcfg = exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": ttiny()}),
        critic=ModelAbstraction("random", {"config": ttiny(is_critic=True)})
        if kw["critic"] else None,
        ref=ModelAbstraction("random", {"config": ttiny()}) if kw["ref"] else None,
        dataset=DatasetAbstraction("prompt", {"dataset_builder": rows}),
        ppo_kwargs={"kl_ctl": 0.1} if kw["ref"] else {}, offload_ref=kw["offload_ref"],
        ref_ema_eta=kw.get("ref_ema_eta"), fuse_rew_ref=kw.get("fuse_rew_ref", False),
    )
    got, want = _graph(exps.build_ppo_math(tcfg)), _graph(jexps.build_ppo_math(jcfg))
    assert got == want
    nodes = {n["name"]: n for n in got[0]}
    post = [("ParamReallocHook", "actor_gen@0", 1.0)]
    if kw.get("ref_ema_eta"):
        # The EMA, then (with offload_ref) the ref back to host memory.
        post += [("ParamReallocHook", "ref@0", kw["ref_ema_eta"]), ("OffloadHook", "ref@0", None)]
    assert nodes["actor_train"]["post"] == post
    ref_node = "fused_rew_ref" if kw.get("fuse_rew_ref") else "ref_inf"
    assert (nodes.get(ref_node, {}).get("post") == [("OffloadHook", None, None)]) == (
        kw["offload_ref"])


def _e2e_cfg(tmp_path, mode, **kw):
    """tests/test_experiments.py:144's trial, in the port."""
    rows = fixtures.build_math_rows(8, seed=4)
    id2info = {r["query_id"]: r for r in rows}
    return exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": ttiny()}),
        critic=(ModelAbstraction("random", {"config": ttiny(is_critic=True)})
                if mode == "value" else None),
        ref=ModelAbstraction("random", {"config": ttiny()}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": id2info},
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        batch_size=4,
        total_train_epochs=1,
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2),
        fileroot=str(tmp_path),
        **kw,
    )


@pytest.mark.parametrize("mode", ["grpo", "value"])
def test_ppo_math_e2e(tmp_path, mode):
    """Twin of tests/test_experiments.py:144: the full PPO DFG over math
    rows with verified rewards, on the in-process runtime (CPU)."""
    tok = CharTokenizer(512)
    master, stats = exps.run_experiment(
        exps.build_ppo_math(_e2e_cfg(tmp_path, mode), tok), tokenizer=tok, device="cpu")
    assert len(stats) == 2
    s = stats[-1]
    assert [k for k in s if k.startswith("actor_train/")], s
    assert np.isfinite(s["actor_train/actor_loss"])
    assert "actor_train/task_reward" in s
    if mode == "value":
        assert np.isfinite(s["critic_train/value_loss"])
    assert abs(stats[0]["actor_train/importance_weight"] - 1.0) < 5e-2
    # The worker's timers and the analytic FLOPs reach the step stats.
    for name in ("actor_gen", "rew_inf", "ref_inf", "actor_train"):
        assert s[f"{name}/perf/time_s"] > 0, name
    assert s["actor_train/time/mfc_train_step_cnt"] == 1.0
    assert s["actor_train/perf/tflops"] > 0 and "actor_train/perf/mfu" not in s  # CPU
    assert master.step_info.global_step == 2 and s["buffer/size"] == 0.0


def test_offload_ref_e2e(tmp_path):
    tok = CharTokenizer(512)
    plan = exps.build_ppo_math(_e2e_cfg(tmp_path, "grpo", offload_ref=True), tok)
    master, stats = exps.run_experiment(plan, tokenizer=tok, device="cpu")
    assert len(stats) == 2 and np.isfinite(stats[-1]["actor_train/actor_loss"])
    assert master.pool.workers[0].models["ref@0"].engine._host_offload is not None


@pytest.mark.parametrize("option,value,item", [
    ("gen_server_url", "tcp://localhost:1", "item 7.8"),
    ("gen_server_url", "http://localhost:1,zmq://localhost:2", "item 7.8"),
    ("gen_parallel", ParallelConfig(data=2), "item 8.6b"),
])
def test_unported_options_raise(tmp_path, option, value, item):
    cfg = dataclasses.replace(_e2e_cfg(tmp_path, "grpo"), **{option: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        exps.build_ppo_math(cfg)


@pytest.mark.parametrize("kw,message", [
    (dict(param_push_tree=True), "param_push_tree requires gen_server_url"),
    (dict(param_push_fanout=0), "param_push_fanout must be >= 1"),
], ids=["tree_without_servers", "fanout_0"])
def test_push_option_checks_match_jax(tmp_path, kw, message):
    """The broadcast tree's option checks, as the JAX package words them."""
    from areal_tpu.experiments import check as jcheck

    cfg = dataclasses.replace(_e2e_cfg(tmp_path, "grpo"), **kw)
    with pytest.raises(Exception, match=message):
        exps.build_ppo_math(cfg)
    with pytest.raises(Exception, match=message):
        jcheck.check_ppo_math(cfg)


# The options the port refused before it had them, each now running a
# trial on the CPU: the difficulty filter, recover checkpoints, the EMA
# reference model, an int8 KV pool (which the static path ignores and
# the inflight paths honour, as in the JAX package), the dense KV window,
# the two-program admit path, speculative decoding, the agent-episode
# options (carried, read by no code of the in-process trial: see below),
# the pipeline-overlapped step, the tunable sentinels (set where they
# do not trip), the fused reward+ref MFC, bf16 masters, the remat
# policies "dots" and "dots_small", and asynchronous RL: the one-step
# rollout overlap, the replay pipeline (cap 0 and 1, a replay capacity),
# decoupled PPO's behaviour-weight cap and the imp-ratio sentinel,
# remote generation (a server started in the test: GEN_SERVER), and the
# multi-process runtime's options that act in-process: a placement over
# two workers (the data and param planes) and the requests' deadline
# with the heartbeat period.
GEN_SERVER = "<gen-server>"
FORMERLY_UNPORTED = [
    ("dataset_filter", {"min_accuracy": 0.1}),
    ("ctrl", ExperimentSaveEvalControl(benchmark_steps=2, ckpt_freq_steps=1)),
    ("ref_ema_eta", 0.5),
    ("gen_backend_args", {"kv_cache_dtype": "int8"}),
    ("kv_paged", False),
    ("prefill_chunk_tokens", 0),
    ("gconfig", GenerationHyperparameters(n=2, max_new_tokens=8, spec_decode_k=2)),
    ("episode_max_turns", 2),
    ("episode_token_budget", 64),
    ("tool_timeout_s", 1.0),
    ("pipeline_overlap", True),
    ("anomaly_kl_max", 10.0),
    ("anomaly_grad_norm_mult", 2.0),
    ("anomaly_update_norm_max", 100.0),
    ("fuse_rew_ref", True),
    ("train_backend_args", {"master_dtype": "bfloat16"}),
    ("train_backend_args", {"remat_policy": "dots"}),
    ("train_backend_args", {"remat_policy": "dots_small"}),
    ("rollout_ahead", 1),
    ("max_head_offpolicyness", 0),
    ("max_head_offpolicyness", 1),
    ("replay_capacity", 8),
    ("behav_imp_weight_cap", 2.0),
    ("ppo_kwargs", {"n_minibatches": 2, "kl_ctl": 0.1, "anomaly_imp_ratio_max": 100.0}),
    ("gen_server_url", GEN_SERVER),
    ("inmem_weight_sync", True),
    ("placement", {"actor_gen": 1, "reward": 1}),
    ("mfc_timeout_s", 120.0),
    ("worker_heartbeat_s", 2.0),
    ("param_push_tree", True),
    ("param_push_fanout", 1),
    ("weight_push_checksum", False),
]


def _option_id(option, value):
    if option == "train_backend_args":
        return f"{option}.{next(iter(value.values()))}"
    if option == "max_head_offpolicyness":
        return f"{option}.{value}"
    return "ppo_kwargs.anomaly_imp_ratio_max" if option == "ppo_kwargs" else option


def _with_option(cfg, option, value, server_url):
    """The e2e config with `option` set; the remote-generation options
    point it at `server_url` (the async ones at cap 1 for the cap and
    the capacity)."""
    if option == "gen_server_url":
        return dataclasses.replace(cfg, gen_server_url=server_url)
    if option == "inmem_weight_sync":
        return dataclasses.replace(cfg, gen_server_url=server_url, inmem_weight_sync=True)
    if option in ("param_push_tree", "param_push_fanout"):
        return dataclasses.replace(cfg, gen_server_url=server_url,
                                   **dict({"param_push_tree": True}, **{option: value}))
    if option == "weight_push_checksum":  # it acts on a push across workers
        return dataclasses.replace(cfg, placement={"actor_gen": 1, "reward": 1},
                                   weight_push_checksum=value)
    if option in ("replay_capacity", "behav_imp_weight_cap"):
        return dataclasses.replace(cfg, max_head_offpolicyness=1, **{option: value})
    if option == "ppo_kwargs":
        return dataclasses.replace(cfg, max_head_offpolicyness=1, ppo_kwargs=value)
    return dataclasses.replace(cfg, **{option: value})


@pytest.fixture()
def gen_server(tmp_path):
    """A port GenerationServer on a tiny engine, with the weights of the
    e2e trial's actor (the same seeded random init)."""
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as ttfm
    from areal_tpu_torch.system.gen_server import GenerationServer

    eng = GeneratorEngine(ttiny(), ttfm.init_params(ttiny(), 1, device="cpu"), "cpu",
                          eos_token_id=CharTokenizer(512).eos_token_id)
    srv = GenerationServer(eng, max_wait_ms=10.0, ckpt_root=str(tmp_path))
    yield srv
    srv.close()


@pytest.mark.parametrize("option,value", FORMERLY_UNPORTED,
                         ids=[_option_id(o, v) for o, v in FORMERLY_UNPORTED])
def test_formerly_unported_options_run(tmp_path, option, value, request, monkeypatch):
    import tempfile

    tok = CharTokenizer(512)
    url = None
    if value == GEN_SERVER or option in ("inmem_weight_sync", "param_push_tree",
                                         "param_push_fanout"):
        url = request.getfixturevalue("gen_server").url
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the push's sync dir
    base = _e2e_cfg(tmp_path, "grpo")
    if url is not None:
        base = dataclasses.replace(base, ref=None, ppo_kwargs={"n_minibatches": 2})
    cfg = _with_option(base, option, value, url)
    master, stats = exps.run_experiment(exps.build_ppo_math(cfg, tok), tokenizer=tok,
                                        device="cpu")
    assert len(stats) == 2 and np.isfinite(stats[-1]["actor_train/actor_loss"])
    worker = master.pool.workers[0]
    if option == "placement":
        assert master.placement == {"actor@0": 0, "actor_gen@0": 1, "reward@0": 1, "ref@0": 0}
        assert [sorted(w.models) for w in master.pool.workers] == [
            ["actor@0", "ref@0"], ["actor_gen@0", "reward@0"]]
        assert all(s["transfer/param_count"] == 1.0 and s["transfer/data_count"] > 0
                   for s in stats)
    if option == "mfc_timeout_s":
        assert master.pool.mfc_timeout_s == value and master.pool.dead_workers == set()
    if option == "ctrl":
        base = master._ckpt_dir(master._train_rpcs[0], "recover_checkpoint")
        assert os.path.isdir(base) and os.path.isdir(base + ".prev")
    engine = master.pool.workers[master.placement["actor_gen@0"]].models["actor_gen@0"].engine
    if option == "gen_backend_args":
        assert engine.kv_cache_dtype == "int8"
    if option == "kv_paged":
        assert engine.kv_paged is False
    if option == "prefill_chunk_tokens":
        assert engine.prefill_chunk_tokens == 0
    if option == "gconfig":
        assert engine.steps_total > 0  # spec decoding takes the inflight path
    if option == "pipeline_overlap":  # the default window 2, one prompt a chunk
        assert stats[-1]["pipeline/n_chunks"] == 4.0
        assert stats[-1]["actor_train/n_stream_chunks"] == 4.0
    if option == "anomaly_kl_max":
        assert worker.interfaces["actor@0"].anomaly_kl_max == value
    if option == "fuse_rew_ref":
        assert "fused_rew_ref/perf/time_s" in stats[-1] and "rew_inf/perf/time_s" not in stats[-1]
    if option == "train_backend_args":
        actor = worker.models["actor@0"].engine
        key, want = next(iter(value.items()))
        got = getattr(actor, key)
        assert (str(got).removeprefix("torch.") if key == "master_dtype" else got) == want
        if key == "master_dtype":
            assert all(p.dtype == torch.bfloat16 for p in actor.get_params()["blocks"].values())
    if option.startswith("anomaly_") and option != "anomaly_kl_max":
        for model in ("actor@0",):
            assert getattr(worker.models[model].engine, option) == value
    if option == "rollout_ahead":
        assert master.rollout_ahead == 1 and master._ahead_task is None
    if option in ("max_head_offpolicyness", "replay_capacity", "behav_imp_weight_cap",
                  "ppo_kwargs"):
        assert [s["replay/staleness"] <= master.max_head_offpolicyness for s in stats] == [
            True, True]
        assert master.replay.capacity == (8 if option == "replay_capacity" else 4)
        actor_if = worker.interfaces["actor@0"]
        want_cap = {0: None, 1: 5.0}[master.max_head_offpolicyness]
        if option == "behav_imp_weight_cap":
            want_cap = 2.0
        assert actor_if.behav_imp_weight_cap == want_cap
        if option == "ppo_kwargs":
            assert actor_if.anomaly_imp_ratio_max == 100.0
            assert all(s["actor_train/quarantined"] == 0.0 for s in stats)
    if url is not None:
        remote = worker.models["actor_gen@0"].engine
        assert remote.pushes == 2 and request.getfixturevalue("gen_server").version == 2
        assert remote.inmem_sync == (option == "inmem_weight_sync")
        fabric = option.startswith("param_push")
        assert remote.push_mode == ("fabric" if fabric else "disk")
        if fabric:
            assert remote._fabric.store.head == 2
            assert remote._fabric.fanout == (value if option == "param_push_fanout" else 2)
    if option == "weight_push_checksum":
        assert master.weight_push_checksum is False
        assert all(s["transfer/param_count"] == 1.0 for s in stats)


EPISODE_OPTIONS = dict(episode_max_turns=2, episode_token_budget=64, tool_timeout_s=1.0)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_episode_options_leave_the_trial_unchanged(tmp_path, package):
    """A behaviour of the reference, pinned in both packages: the three
    agent-episode options are carried by PPOMathConfig and read by no code
    of the in-process trial (only an episode runner on the rollout
    controller drives episodes), so the same trial with and without them
    gives equal stats."""
    _assert_options_change_nothing(tmp_path, package, EPISODE_OPTIONS)


MIXTURE_OPTIONS = dict(mixture_weights={"math": 3.0, "code": 1.0}, mixture_adaptive=True)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_mixture_options_leave_the_trial_unchanged(tmp_path, package):
    """A behaviour of the reference, pinned in both packages: the
    task-mixture options are carried by PPOMathConfig and checked, and
    no code of the in-process trial reads them (a `RolloutController`
    with `mixture=` consumes a mixture), so the same trial with and
    without them gives equal stats."""
    _assert_options_change_nothing(tmp_path, package, MIXTURE_OPTIONS)


def _assert_options_change_nothing(tmp_path, package, options):
    rows = fixtures.build_math_rows(8, seed=4)
    if package == "jax":
        from areal_tpu.api.config import ModelAbstraction as JMA

        def cfg(sub, **kw):
            return jexps.PPOMathConfig(
                actor=JMA("random", {"config": jtiny()}), ref=JMA("random", {"config": jtiny()}),
                dataset=JDatasetAbstraction(
                    "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
                reward_interface_args={"id2info": {r["query_id"]: r for r in rows}},
                gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8),
                ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
                optimizer=JOptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
                batch_size=4, total_train_epochs=1, ctrl=JCtrl(benchmark_steps=2),
                fileroot=str(tmp_path / sub), **kw,
            )

        def run(c):
            tok = fixtures.make_tokenizer()
            return jexps.run_experiment(jexps.build_ppo_math(c, tok), tokenizer=tok)[1]
    else:
        def cfg(sub, **kw):
            return _e2e_cfg(tmp_path / sub, "grpo", **kw)

        def run(c):
            tok = CharTokenizer(512)
            return exps.run_experiment(exps.build_ppo_math(c, tok), tokenizer=tok,
                                       device="cpu")[1]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU kernels then reduce in one order
    try:
        plain = run(cfg("plain"))
        with_opts = run(cfg("options", **options))
    finally:
        torch.set_num_threads(threads)
    assert len(plain) == len(with_opts) == 2
    for a, b in zip(plain, with_opts):
        keys = [k for k in a if "/perf/" not in k and "/time" not in k and "time/" not in k]
        assert set(keys) <= set(b) and len(keys) > 10
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}


def test_master_refuses_more_than_one_worker(tmp_path):
    """A placement naming a worker the pool does not have is refused; a
    pool of two workers, once refused, is taken, and so are recover
    checkpoints (`ckpt_freq_steps`)."""
    plan = exps.build_ppo_math(_e2e_cfg(tmp_path, "grpo"))
    with pytest.raises(ValueError, match="outside the pool"):
        MasterWorker(plan.dfg, InProcessPool([object()]),
                     {**plan.model_placement, "actor_gen@0": 1}, [0], plan.ctrl,
                     fileroot=str(tmp_path))
    with pytest.raises(ValueError, match="outside the pool"):
        MasterWorker(plan.dfg, InProcessPool([object()]), plan.model_placement, [3],
                     plan.ctrl, fileroot=str(tmp_path))
    two = MasterWorker(plan.dfg, InProcessPool([object(), object()]),
                       {**plan.model_placement, "actor_gen@0": 1}, [0], plan.ctrl,
                       fileroot=str(tmp_path))
    assert two.pool.n_workers == 2
    master = MasterWorker(plan.dfg, InProcessPool([object()]), plan.model_placement, [0],
                          ExperimentSaveEvalControl(ckpt_freq_steps=2), fileroot=str(tmp_path))
    assert master.ckpt_ctl.frequency_steps == 2


def test_param_sync_eta_below_one_raises(tmp_path):
    """An EMA sync (eta < 1), which the port once refused, now mixes: a
    post-hook with eta 0.5 onto the reference model leaves it exactly at
    `0.5 * actor + 0.5 * ref_before` after each step."""
    from areal_tpu_torch.system import worker as tworker

    tok = CharTokenizer(512)
    plan = exps.build_ppo_math(_e2e_cfg(tmp_path, "grpo"), tok)
    ref = next(n.model_name for n in plan.dfg.nodes if n.name == "ref_inf")
    plan.dfg.nodes[-1].post_hooks = [ParamReallocHook(target=ref, eta=0.5)]
    seen = []
    orig = tworker.ModelWorker._handle_param_sync

    def param_sync(self, req):
        before = {k: v.clone() for k, v in _flat(self.models[req["dst"]].engine.params)}
        out = orig(self, req)
        actor = {k: v.clone() for k, v in _flat(self.models[req["src"]].engine.get_params())}
        seen.append((req["eta"], {k: (v.clone(), actor[k], before[k])
                                  for k, v in _flat(self.models[req["dst"]].engine.params)}))
        return out

    tworker.ModelWorker._handle_param_sync = param_sync
    try:
        _, stats = exps.run_experiment(plan, tokenizer=tok, device="cpu")
    finally:
        tworker.ModelWorker._handle_param_sync = orig
    assert len(stats) == 2 and [eta for eta, _ in seen] == [0.5, 0.5]
    for _, leaves in seen:
        for k, (after, actor, before) in leaves.items():
            assert torch.equal(after, 0.5 * actor + 0.5 * before), k


# ---------------- two-step parity against the JAX package ----------------

_SEEN = {"jax": [], "port": []}


def _reward_class(sample_cls, base, pkg):
    """Scores each prompt's group by its query id's parity (+5 / -5), the
    same in both packages, and records the tokens it graded."""

    @dataclasses.dataclass
    class ParityReward(base):
        def inference(self, model, sample, mb_spec):
            _SEEN[pkg].append((list(sample.ids),
                               np.asarray(sample.data["packed_input_ids"]).copy()))
            seqlens, rewards = [], []
            for sid, group in zip(sample.ids, sample.seqlens["packed_input_ids"]):
                seqlens.append([1] * len(group))
                rewards += [5.0 if int(str(sid).split("-")[1]) % 2 else -5.0] * len(group)
            return sample_cls(
                keys={"rewards"}, ids=list(sample.ids), seqlens={"rewards": seqlens},
                data={"rewards": np.asarray(rewards, np.float32)},
            )

    return ParityReward


_PARITY_REWARD = "parity-test-reward-by-query-id"
if _PARITY_REWARD not in model_api.ALL_INTERFACES:
    model_api.register_interface(
        _PARITY_REWARD, _reward_class(SequenceSample, model_api.ModelInterface, "port"))
if _PARITY_REWARD not in jmodel_api.ALL_INTERFACES:
    jmodel_api.register_interface(
        _PARITY_REWARD, _reward_class(JSequenceSample, jmodel_api.ModelInterface, "jax"))


def _run_both(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    rows = fixtures.build_math_rows(8, seed=4)
    common = dict(
        batch_size=4, total_train_epochs=1,
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
    )
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("hf", {"path": ckpt}),
        critic=JModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        ref=JModelAbstraction("hf", {"path": ckpt}),
        dataset=JDatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=JInterfaceAbstraction(_PARITY_REWARD),
        gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=JOptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=JCtrl(benchmark_steps=2, save_freq_steps=2),
        fileroot=str(tmp_path / "jax"), **common,
    )
    tcfg = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        critic=ModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        ref=ModelAbstraction("hf", {"path": ckpt}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=ModelInterfaceAbstraction(_PARITY_REWARD),
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2, save_freq_steps=2),
        fileroot=str(tmp_path / "port"), **common,
    )
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    _, jstats = jexps.run_experiment(jexps.build_ppo_math(jcfg), tokenizer=fixtures.make_tokenizer())
    _, tstats = exps.run_experiment(exps.build_ppo_math(tcfg), tokenizer=CharTokenizer(512),
                                    device="cpu")
    return ckpt, jstats, tstats


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    return tmp, _run_both(tmp)


def test_parity_tokens_equal(parity_runs):
    _, _ = parity_runs
    assert len(_SEEN["port"]) == len(_SEEN["jax"]) == 2
    for (tids, ttoks), (jids, jtoks) in zip(_SEEN["port"], _SEEN["jax"]):
        assert tids == jids
        np.testing.assert_array_equal(ttoks, jtoks)


def test_parity_train_stats(parity_runs):
    """Per step, every stat of actor_train and critic_train (but the
    wall times) within tests/test_torch_ppo.py's rtol 1e-4, atol 1e-6."""
    _, (_, jstats, tstats) = parity_runs
    assert len(tstats) == len(jstats) == 2
    for step, (got, want) in enumerate(zip(tstats, jstats)):
        keys = [k for k in got if k.split("/")[0] in ("actor_train", "critic_train")
                and "/perf/" not in k and "/time/" not in k]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step + 1}: {k}")
        assert abs(got["actor_train/advantage_abs"]) > 0.1, got


def test_parity_checkpoints(parity_runs):
    """The step-2 checkpoints of actor and critic: the same tensors within
    rtol 1e-4, atol 1e-6, and the actor moved from the initial weights."""
    tmp, (ckpt, _, _) = parity_runs
    _, init = hf.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu")
    for model, critic in (("actor@0", False), ("critic@0", True)):
        path = [os.path.join(tmp, pkg, "checkpoints", "ppo-math", "trial", model, "step_2")
                for pkg in ("port", "jax")]
        _, got = hf.load_hf_checkpoint(path[0], is_critic=critic, dtype=torch.float32,
                                       device="cpu")
        _, want = hf.load_hf_checkpoint(path[1], is_critic=critic, dtype=torch.float32,
                                        device="cpu")
        flat_got, flat_want = dict(_flat(got)), dict(_flat(want))
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            np.testing.assert_allclose(flat_got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{model} {k}")
        if not critic:
            moved = max(float((flat_got[k] - v).abs().max()) for k, v in dict(_flat(init)).items())
            assert moved > 1e-5, moved


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_worker_serves_concurrent_mfcs(tmp_path):
    """The pool runs each request in a thread of its own: 16 reward and
    ref_inf calls at once on one worker's cache (a shortened switch
    interval) all finish, each reply carries only its own call's timer
    mark, and every entry ends with both outputs."""
    import sys
    import threading

    from areal_tpu_torch.system.worker import ModelWorker

    tok = CharTokenizer(512)
    plan = exps.build_ppo_math(_e2e_cfg(tmp_path, "grpo"), tok)
    worker = ModelWorker(plan.worker_configs[0], tokenizer=tok, device="cpu")
    nodes = {n.name: n for n in plan.dfg.nodes}

    def mfc(node, ids):
        return worker.handle_request({
            "type": "mfc", "model_name": str(node.model_name),
            "interface_type": node.interface_type.value, "ids": ids,
            "input_keys": list(node.input_keys),
            "output_key_remap": dict(node.output_key_remap), "mb_spec": node.mb_spec,
        })

    ids = list(worker.handle_request({"type": "fetch"})["meta"].ids)
    mfc(nodes["actor_gen"], ids)
    replies, errors = [], []

    def run(name):
        try:
            replies.append((name, mfc(nodes[name], ids)))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(name,))
                   for name in ("rew_inf", "ref_inf") * 8]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(replies) == 16
    for name, r in replies:
        assert r["stats"]["time/mfc_inference_cnt"] == 1.0, name
        assert set(r["meta"].keys) == set(nodes[name].output_keys)
    for sid in ids:
        assert {"rewards", "packed_ref_logprobs"} <= worker.data_cache[sid].keys


@pytest.mark.parametrize("kw,message", [
    (dict(mixture_weights={"math": 0.0}), "must be a positive number"),
    (dict(mixture_adaptive=True), "mixture_adaptive needs mixture_weights"),
    (dict(verifier_pool=True, trial_name=""), "verifier_pool needs experiment_name and trial_name"),
], ids=["zero_weight", "adaptive_without_weights", "pool_without_trial"])
def test_fleet_and_mixture_option_checks_match_jax(tmp_path, kw, message):
    """The verifier-pool and task-mixture options' checks, as the JAX
    package words them."""
    from areal_tpu.experiments import check as jcheck

    cfg = dataclasses.replace(_e2e_cfg(tmp_path, "grpo"), **kw)
    with pytest.raises(Exception, match=message):
        exps.build_ppo_math(cfg)
    with pytest.raises(Exception, match=message):
        jcheck.check_ppo_math(cfg)


def test_verifier_pool_option_wires_the_reward_interface(tmp_path):
    """`verifier_pool=True` hands the reward interface the trial's
    experiment and trial to discover its fleet, as the JAX builder does."""
    cfg = dataclasses.replace(_e2e_cfg(tmp_path, "grpo"), verifier_pool=True,
                              experiment_name="e-pool", trial_name="t-pool")
    plan = exps.build_ppo_math(cfg)
    rew = next(n for n in plan.dfg.nodes if n.name == "rew_inf")
    got = {k: v for k, v in rew.interface_impl.args.items()
           if k.startswith(("verifier_pool", "pool_"))}
    assert got == {"verifier_pool": True, "pool_experiment": "e-pool", "pool_trial": "t-pool"}
