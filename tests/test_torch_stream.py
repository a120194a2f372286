"""The streamed train API and the pipeline-overlapped step in the port,
on the CPU in fp32: the engine's stream against the JAX engine's stream
and against its own `train_batch` (tests/test_master.py's
`TestEngineStreamParity` tolerance: the stream scales the gradient sum
once, the barrier each micro-batch), the stream's misuse, and the
master's streamed step through `build_ppo_math` -> `run_experiment`:
window 1 bit for bit the barrier step, and window 2 with chunks of two
prompts against the JAX package's streamed step (tokens, losses,
`pipeline/n_chunks`)."""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.model_api import GenerationHyperparameters as JGenerationHyperparameters
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.experiments import common as jexps
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.ops import functional as jF
from areal_tpu.system.master import ExperimentSaveEvalControl as JCtrl
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.models.weights import params_to_numpy
from areal_tpu_torch.ops import functional as tF
from areal_tpu_torch.system.master import ExperimentSaveEvalControl, MasterWorker
from tests import fixtures
from tests.test_torch_experiments import _PARITY_REWARD, _SEEN
from tests.test_torch_sentinels import SFT, _engines
from tests.test_torch_train import _flat, _samples

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(3)))


def _sft_sample():
    """tests/test_master.py's stream parity batch: four sequences, the
    first three tokens of each a prompt."""
    lens = [12, 20, 9, 15]
    rng = np.random.default_rng(0)
    pmask = np.concatenate([np.arange(l) < 3 for l in lens])
    arrays = dict(
        packed_input_ids=rng.integers(0, jtiny().vocab_size, sum(lens)).astype(np.int32),
        prompt_mask=pmask,
    )
    return _samples(arrays, lens), lens


def _stream(eng, sample, mb, loss, weight):
    state = eng.train_stream_begin()
    chunks = [eng.train_stream_chunk(state, c, mb, loss, weight, **SFT)
              for c in sample.split_balanced(2)]
    return chunks, eng.train_stream_end(state)


def test_stream_matches_jax_stream(weights):
    """Two chunks through each package's stream: every chunk stat and
    the step's stats (the norms 1e-4, the rest 1e-5), and the weights
    within 1e-5 of JAX's."""
    je, te = _engines(weights, lr=1e-3)
    (ts, js), _ = _sft_sample()
    jchunks, want = _stream(je, js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count)
    tchunks, got = _stream(te, ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count)
    for g, w in zip(tchunks + [got], jchunks + [want]):
        assert set(g) == set(w)
        for k in w:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=1e-7, err_msg=k)
    assert got["n_stream_chunks"] == 2.0 and te.opt_count == 1
    assert te.host_transfers == je.host_transfers == 3
    assert te.last_pack_stats == je.last_pack_stats
    pj, pt = _flat(je.get_params()), _flat(params_to_numpy(te.get_params()))
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-5, rtol=0, err_msg=k)


def test_stream_matches_train_batch(weights):
    """The port's stream against its own train_batch on the same data
    (tests/test_master.py:226's tolerances): the chunk weights sum to the
    batch's label count, loss rtol 1e-5, grad_norm rtol 1e-4, weights
    within 1e-5."""
    (ts, _), lens = _sft_sample()
    _, barrier = _engines(weights, lr=1e-3)
    want = barrier.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    _, streamed = _engines(weights, lr=1e-3)
    chunks, got = _stream(streamed, ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count)
    assert sum(c["chunk_weight"] for c in chunks) == sum(lens) - 4 * 3
    assert np.isclose(got["loss"], want["loss"], rtol=1e-5)
    assert np.isclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    pa = _flat(params_to_numpy(barrier.get_params()))
    pb = _flat(params_to_numpy(streamed.get_params()))
    assert max(float(np.abs(pa[k] - pb[k]).max()) for k in pa) < 1e-5


def test_stream_end_without_chunks_raises(weights):
    _, te = _engines(weights)
    state = te.train_stream_begin()
    with pytest.raises(ValueError, match="before any train_stream_chunk"):
        te.train_stream_end(state)


# ---------------- the master's streamed step ----------------


def _configs(tmp_path, ckpt, **kw):
    """tests/test_torch_experiments.py's two-step parity trial (actor,
    critic and ref from one checkpoint, greedy, the query-id reward),
    for both packages, with `kw` set on each config."""
    rows = fixtures.build_math_rows(8, seed=4)
    common = dict(batch_size=4, total_train_epochs=1,
                  ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1}, **kw)
    jcfg = jexps.PPOMathConfig(
        actor=JModelAbstraction("hf", {"path": ckpt}),
        critic=JModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
        ref=JModelAbstraction("hf", {"path": ckpt}),
        dataset=JDatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface=JInterfaceAbstraction(_PARITY_REWARD),
        gconfig=JGenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        optimizer=JOptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=JCtrl(benchmark_steps=2), fileroot=str(tmp_path / "jax"), **common,
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
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2), fileroot=str(tmp_path / "port"),
        **common,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "ckpt")
    jhf.save_hf_checkpoint(path, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(11)),
                           model_type="qwen2")
    return path


def _run_port(cfg):
    """The port's trial; returns each step's stats and the actor's and
    critic's weights after it."""
    weights = []
    orig = MasterWorker.execute_step

    async def execute_step(self):
        stats = await orig(self)
        models = self.pool.workers[0].models
        weights.append({m: _flat(params_to_numpy(models[m].engine.get_params()))
                        for m in ("actor@0", "critic@0")})
        return stats

    MasterWorker.execute_step = execute_step
    try:
        _, stats = exps.run_experiment(exps.build_ppo_math(cfg), tokenizer=CharTokenizer(512),
                                       device="cpu")
    finally:
        MasterWorker.execute_step = orig
    return stats, weights


def _train_keys(stats):
    return [k for k in stats if k.split("/")[0] in ("actor_train", "critic_train")
            and "/perf/" not in k and "/time/" not in k]


def test_window_one_is_the_barrier_bit_for_bit(tmp_path, ckpt):
    """pipeline_overlap with overlap_window 1 runs the barrier path node
    after node: every train stat of both steps and the actor's and
    critic's weights after each step equal the barrier trial's bit for
    bit, and each step reports one chunk."""
    _, barrier_cfg = _configs(tmp_path / "barrier", ckpt)
    _, overlap_cfg = _configs(tmp_path / "overlap", ckpt, pipeline_overlap=True,
                              overlap_window=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU kernels then reduce in one order
    try:
        want, want_w = _run_port(barrier_cfg)
        got, got_w = _run_port(overlap_cfg)
    finally:
        torch.set_num_threads(threads)
    assert len(got) == len(want) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        keys = _train_keys(w)
        assert len(keys) > 20 and "actor_train/grad_norm" in keys
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}, step
        assert g["pipeline/n_chunks"] == 1.0 and "pipeline/n_chunks" not in w
    for gw, ww in zip(got_w, want_w):
        for m in ww:
            for k in ww[m]:
                np.testing.assert_array_equal(gw[m][k], ww[m][k], err_msg=f"{m} {k}")


def test_waiting_chunks_share_one_generate_call(tmp_path, ckpt, monkeypatch):
    """Window 2 admits both chunks of a step at once, so the generate
    node serves them in one static burst (its rows both chunks'), while
    the stream still takes two chunks a step."""
    from areal_tpu_torch.engines.generator import GeneratorEngine

    rows = []
    orig = GeneratorEngine._static_program

    def counted(self, prompt_tok, *args, **kw):
        rows.append(prompt_tok.shape[0])
        return orig(self, prompt_tok, *args, **kw)

    monkeypatch.setattr(GeneratorEngine, "_static_program", counted)
    _, tcfg = _configs(tmp_path, ckpt, pipeline_overlap=True, overlap_window=2,
                       pipeline_chunk_seqs=2)
    stats, _ = _run_port(tcfg)
    assert len(stats) == 2 and rows == [8, 8]  # 2 chunks x 2 prompts x n=2, a step
    for s in stats:
        assert s["pipeline/n_chunks"] == 2.0 and s["actor_train/n_stream_chunks"] == 2.0


def test_window_two_matches_jax(tmp_path, ckpt):
    """Window 2, two prompts a chunk (two chunks a step) through both
    packages' streamed step: the graded tokens equal chunk by chunk, both
    steps' actor and critic train stats within rtol 1e-4 (atol 1e-6),
    pipeline/n_chunks equal, each stage with its fill and bubble.  The
    actor's loss is a cancelling sum near 0 (chunk-normalized advantages
    at a ratio ~1, whose last digits follow each package's generator
    logprobs), so it is held to 1e-4 absolute."""
    jcfg, tcfg = _configs(tmp_path, ckpt, pipeline_overlap=True, overlap_window=2,
                          pipeline_chunk_seqs=2)
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    _, jstats = jexps.run_experiment(jexps.build_ppo_math(jcfg), tokenizer=fixtures.make_tokenizer())
    tstats, _ = _run_port(tcfg)
    assert len(_SEEN["port"]) == len(_SEEN["jax"]) == 4
    seen = {tuple(ids): toks for ids, toks in _SEEN["jax"]}
    for ids, toks in _SEEN["port"]:
        np.testing.assert_array_equal(toks, seen[tuple(ids)])
    for step, (got, want) in enumerate(zip(tstats, jstats)):
        assert got["pipeline/n_chunks"] == want["pipeline/n_chunks"] == 2.0
        assert got["actor_train/n_stream_chunks"] == 2.0
        for stage in ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
                      "critic_train"):
            assert 0 < got[f"pipeline/fill_{stage}"] <= 1 and got[f"pipeline/bubble_s_{stage}"] >= 0
        keys = _train_keys(got)
        assert set(keys) <= set(want) and len(keys) > 20
        for k in keys:
            atol = 1e-4 if k in ("actor_train/loss", "actor_train/actor_loss") else 1e-6
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                       err_msg=f"step {step + 1}: {k}")
