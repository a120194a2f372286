"""The port's small host-side copies against the JAX package's: stat
merging, the anomaly verdict bits, the byte tokenizer and the interface
registry; and the rule that the port's entry points run on the CUDA
card unless the caller asks for the CPU."""

import numpy as np
import pytest
import torch

from areal_tpu.base import integrity as jintegrity
from areal_tpu.base.stats import merge_stats as jmerge
from areal_tpu.data.tokenizer import CharTokenizer as JCharTokenizer
from areal_tpu_torch.api import model_api
from areal_tpu_torch.base import integrity
from areal_tpu_torch.base.stats import merge_stats
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.engines.inference import InferenceEngine
from areal_tpu_torch.engines.train import TrainEngine
from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy


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
