"""The port's quickstart CLI end to end (twin of
tests/test_quickstart_cli.py:49): `quickstart.main(["ppo-math", ...],
device="cpu")` runs a tiny trial from a checkpoint the JAX package wrote,
with a ref model, KL control and the byte tokenizer, prints the last
step's stats and saves the actor; every flag whose feature is not yet
ported exits naming its ROADMAP item.  The flags ported since run a
trial; rerunning a command with recover checkpoints resumes it; and
`--config` YAML files parse to the JAX CLI's arguments."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.base import recover
from areal_tpu_torch.models.hf import registry as hf
from tests import fixtures

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    jhf.save_hf_checkpoint(str(path), jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(0)),
                           model_type="qwen2")
    return str(path)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "math.jsonl"
    with open(path, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return str(path)


def _argv(ckpt_dir, data_path, root, *extra):
    return [
        "ppo-math", "--model.path", ckpt_dir, "--dataset.path", data_path,
        "--tokenizer-path", "char:512", "--batch-size", "4", "--group-size", "2",
        "--max-new-tokens", "8", "--benchmark-steps", "2", "--fileroot", str(root), *extra,
    ]


def test_quickstart_ppo_cli(tmp_path, ckpt_dir, data_path, capsys):
    """ppo-math via argv with a ref model and KL control, saving at step 2."""
    stats = quickstart.main(
        _argv(ckpt_dir, data_path, tmp_path, "--ref-path", ckpt_dir, "--kl-ctl", "0.1",
              "--offload-ref", "--save-freq-steps", "2"),
        device="cpu",
    )
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(stats) == 2 and out.keys() == stats[-1].keys()
    assert [k for k in out if k.startswith("actor_train/")]
    assert np.isfinite(out["actor_train/actor_loss"])
    assert out["actor_train/kl_ctl_value"] == pytest.approx(0.1)
    assert "ref_inf/perf/time_s" in out
    saved = os.path.join(tmp_path, "checkpoints", "ppo-math", "trial0", "actor@0", "step_2")
    cfg, params = hf.load_hf_checkpoint(saved, dtype=torch.float32, device="cpu")
    assert cfg.n_layers == jtiny().n_layers and "lm_head" in params


def test_quickstart_defaults_to_the_card(tmp_path, ckpt_dir, data_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path))


UNPORTED = [
    (["--allocation", "d2"], "item 8"),
    (["--allocation", "search"], "item 10"),
    (["--chip", "v5p"], "item 10"),
    (["--search-devices", "8"], "item 10"),
    (["--launcher", "slurm"], "item 10"),
    (["--tpu-name", "x"], "item 10"),
    (["--multiprocess"], "item 7"),
    (["--recover-retries", "1"], "item 7"),
    (["--mfc-timeout-s", "60"], "item 7"),
    (["--worker-heartbeat-s", "2"], "item 7"),
    (["--anomaly-grad-norm-mult", "3"], "item 6"),
    (["--anomaly-update-norm-max", "1"], "item 6"),
    (["--no-weight-push-checksum"], "item 7"),
    (["--eval-data", "x.jsonl"], "item 10"),
    (["--eval-protocol", "avg@4"], "item 10"),
    (["--gen-allocation", "d1"], "item 8"),
    (["--gen-server-url", "http://localhost:1"], "item 7"),
    (["--master-dtype", "bfloat16"], "item 6"),
    (["--remat", "dots"], "item 6"),
    (["--fuse-rew-ref"], "item 6"),
    (["--rollout-ahead", "1"], "item 7"),
    (["--max-head-offpolicyness", "0"], "item 7"),
    (["--replay-capacity", "8"], "item 7"),
    (["--inmem-weight-sync"], "item 7"),
    (["--param-push-tree"], "item 7"),
    (["--param-push-fanout", "4"], "item 7"),
    (["--pipeline-overlap"], "item 6"),
    (["--overlap-window", "3"], "item 6"),
    (["--pipeline-chunk-seqs", "2"], "item 6"),
    (["--anomaly-kl-max", "1.0"], "item 6"),
    (["--episode-max-turns", "2"], "item 5.4"),
    (["--episode-token-budget", "64"], "item 5.4"),
    (["--tool-timeout-s", "1"], "item 5.4"),
    (["--verifier-pool"], "item 7"),
    (["--mixture-weight", "math=1"], "item 7"),
    (["--mixture-adaptive"], "item 7"),
]


@pytest.mark.parametrize("flags,item", UNPORTED, ids=[u[0][0] + "=" + "_".join(u[0][1:])
                                                       for u in UNPORTED])
def test_unported_flag_exits(tmp_path, ckpt_dir, data_path, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP queue 1, {item}"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, *flags), device="cpu")


def test_sft_exits(tmp_path, ckpt_dir, data_path):
    with pytest.raises(SystemExit, match="queue 1, item 6"):
        quickstart.main(["sft", "--model.path", ckpt_dir, "--dataset.path", data_path],
                        device="cpu")


@pytest.mark.parametrize("flags,message", [
    (["--kl-ctl", "0.1"], "--kl-ctl needs --ref-path"),
    (["--kl-adaptive"], "--kl-adaptive needs a nonzero --kl-ctl"),
])
def test_flag_combinations_exit(tmp_path, ckpt_dir, data_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, *flags), device="cpu")


# The flags the port refused before it had them, each now running a
# trial (see tests/test_torch_recover.py for their parity with the JAX
# package).
FORMERLY_UNPORTED = [
    ["--ckpt-freq-steps", "1"],
    ["--max-recoveries", "1"],
    ["--max-consecutive-quarantines", "1"],
    ["--ref-path", "{ckpt}", "--ref-ema-eta", "0.5", "--offload-ref"],
    ["--kv-cache-dtype", "int8"],
    ["--config", "{yaml}"],
    ["--no-paged-kv"],
    ["--prefill-chunk-tokens", "0"],
    ["--spec-decode-k", "2"],
]


@pytest.mark.parametrize("flags", FORMERLY_UNPORTED,
                         ids=[f[2] if f[0] == "--ref-path" else f[0] for f in FORMERLY_UNPORTED])
def test_formerly_unported_flag_runs(tmp_path, ckpt_dir, data_path, flags):
    cfg = tmp_path / "options.yaml"
    cfg.write_text("batch-size: 4\nlr: 1.0e-4\nckpt_freq_steps: 2\n")
    flags = [f.format(ckpt=ckpt_dir, yaml=cfg) for f in flags]
    stats = quickstart.main(_argv(ckpt_dir, data_path, tmp_path, *flags), device="cpu")
    assert len(stats) == 2 and np.isfinite(stats[-1]["actor_train/actor_loss"])
    recover_dir = os.path.join(tmp_path, "checkpoints", "ppo-math", "trial0", "actor@0",
                               "recover_checkpoint")
    assert os.path.isdir(recover_dir) == (flags[0] in ("--ckpt-freq-steps", "--config"))


def test_rerun_resumes_the_trial(tmp_path, ckpt_dir, data_path):
    """A trial with recover checkpoints, stopped after step 1, resumes
    when the same command is run again with more steps: only step 2 runs,
    from the step-1 checkpoint."""
    argv = _argv(ckpt_dir, data_path, tmp_path, "--ckpt-freq-steps", "1")
    first = argv[:argv.index("--benchmark-steps") + 1] + ["1"] + argv[
        argv.index("--benchmark-steps") + 2:]
    assert len(quickstart.main(first, device="cpu")) == 1
    info = recover.load(recover.recover_root(str(tmp_path), "ppo-math", "trial0"))
    assert info.last_step_info.global_step == 1
    stats = quickstart.main(argv, device="cpu")
    assert len(stats) == 1 and np.isfinite(stats[0]["actor_train/actor_loss"])
    info = recover.load(recover.recover_root(str(tmp_path), "ppo-math", "trial0"))
    assert info.last_step_info.global_step == 2


def _parsed(mod, argv, monkeypatch):
    """The argparse namespace each package's main() hands its ppo-math
    command."""
    got = {}
    monkeypatch.setattr(mod, "cmd_ppo_math", lambda args, **_: got.update(vars(args)))
    mod.main(argv)
    got.pop("fn")
    return got


def test_yaml_config_parses_as_jax(tmp_path, ckpt_dir, data_path, monkeypatch):
    """A YAML option file (flag spellings and python dests; required
    flags satisfied from the file; a flag on the command line wins) gives
    the port the JAX CLI's arguments."""
    from areal_tpu.apps import quickstart as jquickstart

    cfg = tmp_path / "options.yaml"
    cfg.write_text(
        f"model.path: {ckpt_dir}\ndataset.path: {data_path}\nbatch-size: 16\n"
        "group_size: 8\nlr: 3.0e-6\nckpt-freq-steps: 5\nref-ema-eta: 0.99\n"
        "max_consecutive_quarantines: 1\n"
    )
    # (--fileroot: each package's default names the package.)
    argv = ["ppo-math", "--config", str(cfg), "--batch-size", "4", "--fileroot", str(tmp_path)]
    got = _parsed(quickstart, argv, monkeypatch)
    want = _parsed(jquickstart, argv, monkeypatch)
    assert got == want
    assert (got["batch_size"], got["group_size"], got["lr"]) == (4, 8, 3e-6)
    assert (got["ckpt_freq_steps"], got["ref_ema_eta"], got["model_path"]) == (5, 0.99, ckpt_dir)


def test_yaml_config_unknown_key_exits(tmp_path, ckpt_dir, data_path):
    cfg = tmp_path / "options.yaml"
    cfg.write_text("batch-size: 4\nno-such-option: 1\n")
    with pytest.raises(SystemExit, match="unknown option 'no-such-option'"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, "--config", str(cfg)),
                        device="cpu")


def test_yaml_config_cannot_set_an_unported_flag(tmp_path, ckpt_dir, data_path):
    cfg = tmp_path / "options.yaml"
    cfg.write_text("rollout-ahead: 1\n")
    with pytest.raises(SystemExit, match="--rollout-ahead is not yet ported"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, "--config", str(cfg)),
                        device="cpu")


def test_yaml_config_without_pyyaml_exits_clearly(tmp_path, ckpt_dir, data_path, monkeypatch):
    """Where PyYAML is not installed (the card's machine), --config fails
    with a sentence naming the package, not an ImportError."""
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    cfg = tmp_path / "options.yaml"
    cfg.write_text("batch-size: 4\n")
    with pytest.raises(SystemExit, match="needs the PyYAML package"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, "--config", str(cfg)),
                        device="cpu")


def test_genmodes_step_matches_jax(tmp_path, ckpt_dir, data_path, monkeypatch, capsys):
    """One ppo-math step through both packages' CLI with the dense window,
    spec decoding and an int8 cache (`--no-paged-kv --spec-decode-k 2
    --kv-cache-dtype int8`), greedy generation and the query-id reward of
    tests/test_torch_experiments.py's parity case: the port takes the
    dense spec path, the graded tokens are equal, and every actor_train
    stat is within the parity case's rtol 1e-4, atol 1e-6."""
    import dataclasses

    from areal_tpu.api.config import ModelInterfaceAbstraction as JInterface
    from areal_tpu.apps import quickstart as jquickstart
    from areal_tpu_torch.api.config import ModelInterfaceAbstraction
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from tests.test_torch_experiments import _PARITY_REWARD, _SEEN

    for mod, interface in ((jquickstart.exps, JInterface),
                           (quickstart.exps, ModelInterfaceAbstraction)):
        def build(cfg, *a, _real=mod.build_ppo_math, _interface=interface, **k):
            cfg = dataclasses.replace(cfg, gconfig=cfg.gconfig.new(greedy=True),
                                      reward_interface=_interface(_PARITY_REWARD))
            return _real(cfg, *a, **k)

        monkeypatch.setattr(mod, "build_ppo_math", build)
    spec_calls = []
    real_spec = GeneratorEngine._generate_inflight_spec

    def spec(self, *a, **k):
        spec_calls.append(self.kv_cache_dtype)
        return real_spec(self, *a, **k)

    monkeypatch.setattr(GeneratorEngine, "_generate_inflight_spec", spec)
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    flags = ["--no-paged-kv", "--spec-decode-k", "2", "--kv-cache-dtype", "int8",
             "--benchmark-steps", "1"]  # the later flag wins
    capsys.readouterr()
    jquickstart.main(_argv(ckpt_dir, data_path, tmp_path / "jax", *flags))
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tstats = quickstart.main(_argv(ckpt_dir, data_path, tmp_path / "port", *flags),
                             device="cpu")
    assert len(tstats) == 1 and spec_calls == ["int8"]
    assert len(_SEEN["port"]) == len(_SEEN["jax"]) == 1
    (tids, ttoks), (jids, jtoks) = _SEEN["port"][0], _SEEN["jax"][0]
    assert tids == jids
    np.testing.assert_array_equal(ttoks, jtoks)
    keys = [k for k in tstats[0] if k.startswith("actor_train/")
            and "/perf/" not in k and "/time/" not in k]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_allclose(tstats[0][k], jstats[k], rtol=1e-4, atol=1e-6, err_msg=k)
