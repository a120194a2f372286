"""The SPMD worker group's planning half, in one process, against the JAX
package (ROADMAP queue 1, item 8.6a):

- the master's shard-exact dispatch over a fake pool, the port's and the
  JAX master's side by side on the same batch: each member is shipped
  its own rows of the node's `shard_keys` and every row of the other
  keys, and the call carries the same `shard_of` tags; the fallbacks
  (members that disagree on the shard count, a shard with no member to
  place it) broadcast every key and tag nothing;
- a member's `_assemble_sample`: the keys it was not shipped are
  zero-filled from the shipped metadata, and a key in neither names its
  cause;
- the plans: `build_sft(n_hosts=2)`'s group and ranks, a placement
  list's replicas (both as the JAX package builds them), the ppo-math
  group of `actor_parallel=d2` (the trainer models on the group, the
  generator one replica a member);
- the DP dispatch over model replicas (twin of
  tests/test_experiments.py::test_ppo_dp_dispatch_replicas): the ref as
  two replicas in one process equals the solo trial and the JAX
  package's split trial;
- the refusals that name item 8.6b, and a world larger than the card
  count refused by name."""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import dfg as jdfg
from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.config import ModelInterfaceType as JType
from areal_tpu.api.config import ModelName as JModelName
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base.topology import ParallelConfig as JParallelConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system import master as jmaster
from areal_tpu_torch.api import dfg
from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)
from areal_tpu_torch.api.data_api import DatasetAbstraction, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.base.topology import ParallelConfig
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.system import master as tmaster
from areal_tpu_torch.system.worker import ModelWorker, WorkerConfig
from tests import fixtures
from tests.test_torch_experiments import _PARITY_REWARD

LENS = [5, 9, 3, 7, 12, 4]
KEYS = ("packed_input_ids", "prompt_mask")


class _FakePool(tmaster.WorkerPool):
    """Answers the dispatch's requests and records them; worker w's
    shard info is `infos[w]`."""

    def __init__(self, n, infos):
        self.n, self.infos, self.calls = n, infos, []

    async def request(self, worker_id, payload, timeout=None):
        self.calls.append((worker_id, payload))
        kind = payload["type"]
        if kind == "shard_info":
            rank, n = self.infos[worker_id]
            return {"rank": rank, "n": n}
        if kind == "data_send":
            return {"bytes": 0, "seconds": 0.0}
        if kind == "data_recv":
            return {"n": 0, "seconds": 0.0}
        return {"meta": None, "stats": {}}

    @property
    def n_workers(self):
        return self.n


def _meta(sample_cls):
    ids = [f"s{i}" for i in range(len(LENS))]
    return sample_cls(
        keys=set(KEYS), ids=ids, seqlens={k: [[n] for n in LENS] for k in KEYS},
        data={"packed_input_ids": np.zeros(sum(LENS), np.int32),
              "prompt_mask": np.zeros(sum(LENS), np.bool_)},
    ).meta()


def _dispatch(package, infos):
    """One train MFC of the model's group [0, 1] over rows that live on
    worker 2: the transfers (dst, keys, ids) and the mfc payloads."""
    if package == "port":
        mod, d, itype, name, cls = tmaster, dfg, ModelInterfaceType, ModelName, SequenceSample
        iface = ModelInterfaceAbstraction("sft")
    else:
        mod, d, itype, name, cls = jmaster, jdfg, JType, JModelName, JSample
        iface = JInterfaceAbstraction("sft")
    node = d.MFCDef(name="trainDefault", model_name=name("default", 0),
                    interface_type=itype.TRAIN_STEP, interface_impl=iface, input_keys=KEYS,
                    shard_keys=("packed_input_ids",), n_seqs=len(LENS))
    pool = _FakePool(3, infos)
    m = mod.MasterWorker(d.build_graph([node]), pool, {"default@0": 0}, [2],
                         mod.ExperimentSaveEvalControl(),
                         model_groups={"default@0": [0, 1]})
    meta = _meta(cls)
    m._record_owner(meta, 2)
    asyncio.run(m._dispatch_mfc(node, list(meta.ids), [0, 1], meta=meta))
    xfers = sorted((p["dst"], tuple(p["keys"]), tuple(p["ids"]))
                   for _, p in pool.calls if p["type"] == "data_send")
    mfcs = {w: p for w, p in pool.calls if p["type"] == "mfc"}
    return xfers, mfcs


CASES = {
    "sharded": [(0, 2), (1, 2), (0, 1)],
    "members_disagree": [(0, 2), (0, 1), (0, 1)],
    "rank_without_receiver": [(0, 3), (1, 3), (0, 1)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_exact_dispatch_matches_jax(case):
    got, got_mfcs = _dispatch("port", CASES[case])
    want, want_mfcs = _dispatch("jax", CASES[case])
    assert got == want
    assert sorted(got_mfcs) == [0, 1]
    ids = [f"s{i}" for i in range(len(LENS))]
    shipped = {(dst, key): set() for dst in (0, 1) for key in KEYS}
    for dst, keys, sids in got:
        for key in keys:
            shipped[(dst, key)] |= set(sids)
    # The broadcast key reaches every member whole.
    assert shipped[(0, "prompt_mask")] == shipped[(1, "prompt_mask")] == set(ids)
    if case == "sharded":
        tags = got_mfcs[0]["shard_of"]
        assert tags == want_mfcs[0]["shard_of"] == got_mfcs[1]["shard_of"]
        for w in (0, 1):
            # Each member its own rows of the shard key, and only those.
            assert shipped[(w, "packed_input_ids")] == {s for s in ids if tags[s][0] == w}
            assert tags[ids[0]][1] == 2
            meta = got_mfcs[w]["shard_meta"]
            assert meta.ids == ids and meta.keys == set(KEYS) and meta.data is None
        assert {tags[s][0] for s in ids} == {0, 1}
    else:
        for w in (0, 1):
            assert shipped[(w, "packed_input_ids")] == set(ids)
            assert "shard_of" not in got_mfcs[w] and "shard_of" not in want_mfcs[w]


def test_assemble_zero_fills_what_a_member_was_not_shipped():
    worker = ModelWorker(WorkerConfig(worker_index=1, shards=[]), device="cpu")
    ids = ["a", "b"]
    full = SequenceSample(
        keys=set(KEYS), ids=ids, seqlens={k: [[3], [2]] for k in KEYS},
        data={"packed_input_ids": np.arange(1, 6, dtype=np.int32),
              "prompt_mask": np.asarray([1, 0, 0, 1, 0], np.bool_)},
    )
    mine = full.select_idx([1])
    worker.data_cache["b"] = mine
    worker.data_cache["a"] = full.select_idx([0]).select_keys({"prompt_mask"})
    shard_of = {"a": [0, 2], "b": [1, 2]}
    got = worker._assemble_sample(ids, set(KEYS), {}, shard_of, full.meta())
    np.testing.assert_array_equal(got.data["packed_input_ids"], [0, 0, 0, 4, 5])
    assert got.data["packed_input_ids"].dtype == np.int32
    np.testing.assert_array_equal(got.data["prompt_mask"], full.data["prompt_mask"])
    assert got.metadata["shard_of"] == [[0, 2], [1, 2]] and got.shard_blocks() == [[0], [1]]
    with pytest.raises(KeyError, match=r"\['extra'\].*neither the data cache nor the shard"):
        worker._assemble_sample(ids, set(KEYS) | {"extra"}, {}, shard_of, full.meta())
    # Without shard tags a missing key is the old error.
    with pytest.raises(KeyError, match="no data for 'a'"):
        worker._assemble_sample(ids, set(KEYS), {})


def _sft_cfgs(n_hosts, layout):
    data = DatasetAbstraction("prompt_answer", {"dataset_path": "unused.jsonl"})
    jdata = JDatasetAbstraction("prompt_answer", {"dataset_path": "unused.jsonl"})
    return (exps.SFTConfig(model=ModelAbstraction("random", {"config": tiny_config()}),
                           dataset=data, n_hosts=n_hosts,
                           parallel=ParallelConfig.from_str(layout)),
            jexps.SFTConfig(model=JModelAbstraction("random", {"config": jtiny()}),
                            dataset=jdata, n_hosts=n_hosts,
                            parallel=JParallelConfig.from_str(layout)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX package's seeded tiny weights as an HF checkpoint: both
    packages' trials start from them."""
    path = str(tmp_path_factory.mktemp("ckpt"))
    jhf.save_hf_checkpoint(path, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    return path


def _ppo_cfg(package, tmp_path, ckpt_path=None, **kw):
    rows = fixtures.build_math_rows(8, seed=4)
    id2info = {r["query_id"]: r for r in rows}
    if package == "port":
        mods = (exps, ModelAbstraction, DatasetAbstraction, GenerationHyperparameters,
                OptimizerConfig, tiny_config, tmaster.ExperimentSaveEvalControl)
    else:
        mods = (jexps, JModelAbstraction, JDatasetAbstraction, JGen, JOptimizerConfig, jtiny,
                jmaster.ExperimentSaveEvalControl)
    ex, ma, da, gen, opt, tiny, ctrl = mods
    if ckpt_path:
        # A critic and the query-id parity reward: greedy groups cancel
        # GRPO's advantages, and the critic's give the update a signal
        # above the engines' rounding (tests/test_torch_experiments.py).
        kw.setdefault("critic", ma("hf", {"path": ckpt_path, "is_critic": True}))
        kw.setdefault("reward_interface", (ModelInterfaceAbstraction if package == "port"
                                           else JInterfaceAbstraction)(_PARITY_REWARD))
    model = ma("hf", {"path": ckpt_path}) if ckpt_path else ma("random", {"config": tiny()})
    return ex.PPOMathConfig(
        actor=model, ref=model,
        dataset=da("math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": id2info},
        gconfig=gen(n=2, max_new_tokens=8, greedy=True),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
        optimizer=opt(lr=1e-4, warmup_steps_proportion=0.0), batch_size=4,
        total_train_epochs=1, ctrl=ctrl(benchmark_steps=2), fileroot=str(tmp_path), **kw)


def test_plans_match_jax(tmp_path):
    port, jax_cfg = _sft_cfgs(2, "d2")
    plan, jplan = exps.build_sft(port), jexps.build_sft(jax_cfg)
    assert plan.model_groups == jplan.model_groups == {"default@0": [0, 1]}
    assert [(w.dist_process_id, w.dist_num_processes) for w in plan.worker_configs] == \
        [(0, 2), (1, 2)]
    assert [bool(w.datasets) for w in plan.worker_configs] == [True, False]
    assert plan.dfg.nodes[0].shard_keys == jplan.dfg.nodes[0].shard_keys
    assert all(w.shards[0].parallel == ParallelConfig(data=2) for w in plan.worker_configs)
    solo = exps.build_sft(_sft_cfgs(1, "d1")[0])
    assert solo.model_groups is None and solo.worker_configs[0].dist_num_processes == 0
    assert solo.worker_configs[0].shards[0].parallel is None

    split = exps.build_ppo_math(_ppo_cfg("port", tmp_path, placement={"ref": [0, 1]}))
    jsplit = jexps.build_ppo_math(_ppo_cfg("jax", tmp_path, placement={"ref": [0, 1]}))
    assert split.model_replicas == jsplit.model_replicas == {"ref@0": [0, 1]}
    assert len(split.worker_configs) == len(jsplit.worker_configs) == 2
    assert split.model_groups is None

    grp = exps.build_ppo_math(_ppo_cfg("port", tmp_path, actor_parallel=ParallelConfig(data=2)))
    assert grp.model_groups == {"actor@0": [0, 1], "ref@0": [0, 1]}
    assert grp.model_replicas == {"actor_gen@0": [0, 1]}
    assert grp.model_placement["reward@0"] == 0
    assert [[str(s.name) for s in w.shards] for w in grp.worker_configs] == [
        ["actor@0", "actor_gen@0", "reward@0", "ref@0"], ["actor@0", "actor_gen@0", "ref@0"]]
    assert [(w.dist_process_id, w.dist_num_processes) for w in grp.worker_configs] == \
        [(0, 2), (1, 2)]
    with pytest.raises(ValueError, match="multi-process runtime"):
        exps.run_experiment(grp, device="cpu")


def test_dp_dispatch_over_replicas_matches_solo_and_jax(tmp_path, ckpt):
    tok = CharTokenizer(512)
    plan = exps.build_ppo_math(
        _ppo_cfg("port", tmp_path / "split", ckpt, placement={"ref": [0, 1]}), tok)
    master, split = exps.run_experiment(plan, tokenizer=tok, device="cpu")
    # Each replica served a part of every ref_inf call.
    assert [w.models["ref@0"].name for w in master.pool.workers] == ["ref@0", "ref@0"]
    _, solo = exps.run_experiment(
        exps.build_ppo_math(_ppo_cfg("port", tmp_path / "solo", ckpt), tok),
        tokenizer=tok, device="cpu")
    _, jsplit = jexps.run_experiment(
        jexps.build_ppo_math(_ppo_cfg("jax", tmp_path / "jax", ckpt, placement={"ref": [0, 1]})),
        tokenizer=fixtures.make_tokenizer())
    for step in range(2):
        keys = [k for k in solo[step] if "perf/" not in k and "time" not in k
                and not k.startswith(("transfer/", "buffer/"))]
        assert len(keys) > 20 and "actor_train/ref_kl" in keys
        for k in keys:
            # Inference is deterministic: the split equals the solo trial
            # (tests/test_experiments.py's tolerance).
            assert np.isclose(split[step][k], solo[step][k], rtol=1e-3, atol=1e-5), k
        for k in keys:
            if k.split("/")[0] in ("actor_train", "critic_train"):
                # tests/test_torch_experiments.py's parity tolerance.
                np.testing.assert_allclose(split[step][k], jsplit[step][k], rtol=1e-4,
                                           atol=1e-6, err_msg=f"step {step + 1}: {k}")
    assert abs(split[-1]["actor_train/ref_kl"]) > 1e-4
    assert split[-1]["transfer/data_count"] > 0


@pytest.mark.parametrize("kw,item", [
    (dict(gen_parallel=ParallelConfig(data=2)), "item 8.6b"),
    (dict(actor_parallel=ParallelConfig(data=2, model=2)), "item 8.6b"),
    (dict(actor_parallel=ParallelConfig(data=2), gen_server_url="http://localhost:1"),
     "item 8.6b"),
], ids=["gen_parallel", "actor_model_axis", "group_with_gen_servers"])
def test_refusals_name_8_6b(tmp_path, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        exps.build_ppo_math(_ppo_cfg("port", tmp_path, **kw))


def test_generator_on_a_mesh_and_oversized_worlds_are_refused(monkeypatch):
    from areal_tpu_torch.api.config import ModelBackendAbstraction
    from areal_tpu_torch.base import distributed
    from areal_tpu_torch.system import worker as tworker

    shard = tworker.ModelShardSpec(
        name=ModelName("actor_gen", 0), model=ModelAbstraction("null"),
        backend=ModelBackendAbstraction("generator"),
        interface=ModelInterfaceAbstraction("null"), parallel=ParallelConfig(data=2))
    with pytest.raises(NotImplementedError, match="item 8.6b"):
        tworker._build_engine(shard, tiny_config(), None, torch.device("cpu"),
                              WorkerConfig(0, [shard]), None, mesh=object())
    monkeypatch.setattr(distributed, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards.*this machine has 1"):
        distributed.initialize("e", "t", 0, 2, device="cuda", init_method="tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="2 devices, but the worker group has 1 process"):
        exps.build_sft(_sft_cfgs(1, "d2")[0])
    with pytest.raises(ValueError, match="2 devices, but the worker group has 3"):
        exps.build_sft(dataclasses.replace(_sft_cfgs(1, "d2")[0], n_hosts=3))
