"""The port's small host-side copies against the JAX package's: stat
merging, the anomaly verdict bits, the byte tokenizer, the interface
registry, the FLOP counters, timers and seeding; the MFU peak table; the
kernels' launch counters under threads; and the rule that the port's
entry points run on the CUDA card unless the caller asks for the CPU."""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from areal_tpu.base import integrity as jintegrity
from areal_tpu.base import monitor as jmonitor
from areal_tpu.base import seeding as jseeding
from areal_tpu.models.config import qwen2_config as jqwen2
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.base.stats import merge_stats as jmerge
from areal_tpu.data.tokenizer import CharTokenizer as JCharTokenizer
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.base import integrity, monitor, seeding
from areal_tpu_torch.base.stats import merge_stats
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.kernels import build
from areal_tpu_torch.kernels import flash_attention as fa
from areal_tpu_torch.kernels import ragged_paged_attention as rpa
from areal_tpu_torch.models.config import qwen2_config, tiny_config
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.system.worker import ModelShardSpec, ModelWorker, WorkerConfig


@pytest.mark.parametrize("parts", [
    [{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 6.0}],
    [{"loss": 1.0, "loss_denominator": 10.0}, {"loss": 3.0, "loss_denominator": 30.0}],
    [{"loss": 1.0, "loss_denominator": 10.0}, {"loss": 3.0}],  # partial: dropped
    [{"x": 2.0, "x_denominator": 0.0}, {"x": 4.0, "x_denominator": 0.0}],
])
def test_merge_stats_matches_jax(parts):
    assert merge_stats(parts) == jmerge(parts)


@pytest.mark.parametrize("verdict", [0, 1, 2, 5, 63])
def test_verdict_bits_match_jax(verdict):
    for name in ("NONFINITE", "GRAD_SPIKE", "UPDATE_NORM", "KL_BLOWUP",
                 "IMP_RATIO", "DEGENERATE_VAR"):
        assert getattr(integrity, name) == getattr(jintegrity, name)
    assert integrity.verdict_kinds(verdict) == jintegrity.verdict_kinds(verdict)
    before = sum(integrity.ANOMALY_COUNTS.values())
    integrity.record_anomaly(verdict)
    assert sum(integrity.ANOMALY_COUNTS.values()) == before + bin(verdict).count("1")


@pytest.mark.parametrize("text", ["Compute 3 + 4. ", "héllo \\boxed{7}", ""])
def test_char_tokenizer_matches_jax(text):
    t, j = CharTokenizer(512), JCharTokenizer(512)
    ids = t.encode(text, add_eos=True)
    assert ids == j.encode(text, add_eos=True)
    assert t.decode(ids + [t.pad_token_id]) == j.decode(ids + [j.pad_token_id]) == text
    assert t(text, truncation=True, max_length=4) == j(text, truncation=True, max_length=4)
    assert (t.eos_token_id, t.pad_token_id, t.vocab_size) == (257, 256, 512)


def test_interface_registry():
    ai = model_api.make_interface("ppo_actor", n_minibatches=2, disable_value=True)
    assert isinstance(ai, PPOActorInterface) and ai.n_minibatches == 2
    with pytest.raises(ValueError):
        model_api.register_interface("ppo_actor", PPOActorInterface)
    ci = model_api.make_interface("ppo_critic", value_norm=True)
    assert isinstance(ci, PPOCriticInterface) and ci.value_norm


_ENTRY_POINTS = {
    "init_params": lambda cfg, **kw: tfm.init_params(cfg, 0, **kw)["embed"],
    "params_from_numpy": lambda cfg, **kw: params_from_numpy(
        {"w": np.ones((2, 3), np.float32)}, **kw
    )["w"],
    "init_kv_cache": lambda cfg, **kw: tfm.init_kv_cache(cfg, 2, 16, **kw).k,
    "init_paged_kv_cache": lambda cfg, **kw: tfm.init_paged_kv_cache(cfg, 4, 8, **kw).k,
    "GeneratorEngine": lambda cfg, **kw: GeneratorEngine(
        cfg, tfm.init_params(cfg, 0, device="cpu"), eos_token_id=1, **kw
    ),
    "init_params_critic": lambda cfg, **kw: tfm.init_params(
        cfg.as_critic(), 0, **kw
    )["value_head"],
    "InferenceEngine": lambda cfg, **kw: InferenceEngine(
        cfg, tfm.init_params(cfg, 0, device="cpu"), **kw
    ),
    "TrainEngine_critic": lambda cfg, **kw: TrainEngine(
        cfg.as_critic(), tfm.init_params(cfg.as_critic(), 0, device="cpu"), **kw
    ),
    "ModelWorker": lambda cfg, **kw: ModelWorker(WorkerConfig(0, [ModelShardSpec(
        ModelName("ref"), ModelAbstraction("random", {"config": cfg}),
        ModelBackendAbstraction("inference"), ModelInterfaceAbstraction("ppo_actor"),
    )]), **kw),
    "root_generator": lambda cfg, **kw: seeding.root_generator(**kw),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_told(entry):
    """Called without `device`, each entry point resolves to the CUDA
    card: on a host without one it raises resolve_device's error rather
    than falling back to the CPU; `device="cpu"` runs on the host."""
    call = _ENTRY_POINTS[entry]
    cfg = tiny_config()
    if torch.cuda.is_available():
        assert call(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(cfg)
    assert call(cfg, device="cpu").device.type == "cpu"


def _math_dataset():
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from tests import fixtures

    return DatasetAbstraction("math_code_prompt", {"dataset_builder": fixtures.build_math_rows})


def test_run_experiment_runs_on_the_card_unless_told(tmp_path):
    """run_experiment builds its workers on the card by default: without
    one it raises resolve_device's error (the CPU e2e runs pass
    device="cpu", tests/test_torch_experiments.py)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    cfg = exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": tiny_config()}),
        dataset=_math_dataset(), fileroot=str(tmp_path),
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exps.run_experiment(exps.build_ppo_math(cfg), tokenizer=CharTokenizer(512))


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0),
    ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_tflops_by_card_name(name, peak):
    assert monitor.peak_tflops(name) == peak


def test_mfu_is_none_on_the_cpu():
    assert monitor.mfu(1e12, 1.0, torch.device("cpu")) is None


@pytest.mark.parametrize("model", ["tiny", "tiny_critic", "qwen2-1.5b"])
@pytest.mark.parametrize("lens", [[17], [64, 300, 5], [1] * 40])
def test_flops_match_jax(model, lens):
    t, j = {
        "tiny": (tiny_config(), jtiny()),
        "tiny_critic": (tiny_config(is_critic=True), jtiny(is_critic=True)),
        "qwen2-1.5b": (qwen2_config("1.5b"), jqwen2("1.5b")),
    }[model]
    n, sq = sum(lens), float(sum(x * x for x in lens))
    assert monitor.matmul_params(t) == jmonitor.matmul_params(j)
    assert monitor.flops_forward(t, n, sq) == jmonitor.flops_forward(j, n, sq)
    assert monitor.flops_train(t, n, sq) == jmonitor.flops_train(j, n, sq)
    gen = [3 * x % 11 for x in lens]
    assert monitor.flops_generate(t, lens, gen) == jmonitor.flops_generate(j, lens, gen)


def test_timers_drain_like_jax():
    t, j = monitor.Timers(), jmonitor.Timers()
    for timers in (t, j):
        for name in ("a", "a", "b"):
            with timers.record(name):
                pass
    got, want = t.drain(), j.drain()
    assert sorted(got) == sorted(want)
    assert got["time/a_cnt"] == want["time/a_cnt"] == 2.0
    assert t.drain() == {}


def test_seeding_matches_jax():
    seeding.set_random_seed(7, 2)
    ours = (random.random(), np.random.rand())
    jseeding.set_random_seed(7, 2)
    assert (random.random(), np.random.rand()) == ours
    assert seeding.get_seed() == jseeding.get_seed() == 9
    a = torch.rand(3, generator=seeding.root_generator("cpu"))
    b = torch.rand(3, generator=seeding.root_generator("cpu"))
    assert torch.equal(a, b)


def test_launch_counters_under_threads():
    """Two MFCs may launch kernels from two threads at once: the counters
    lose no increment (16 threads, a shortened switch interval)."""
    before_rpa, before_fa = rpa.LAUNCHES, dict(fa.LAUNCHES)
    n_threads, n_each = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                build.count_launch(vars(rpa), "LAUNCHES")
                build.count_launch(fa.LAUNCHES, "dq")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert rpa.LAUNCHES - before_rpa == n_threads * n_each
        assert fa.LAUNCHES["dq"] - before_fa["dq"] == n_threads * n_each
    finally:
        sys.setswitchinterval(interval)
        rpa.LAUNCHES = before_rpa
        fa.LAUNCHES.update(before_fa)
