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
from areal_tpu_torch.base import integrity, recover
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
    (["--allocation", "d1m2"], "item 8.6b"),
    (["--allocation", "search"], "item 10"),
    (["--chip", "v5p"], "item 10"),
    (["--search-devices", "8"], "item 10"),
    (["--launcher", "slurm"], "item 10"),
    (["--tpu-name", "x"], "item 10"),
    (["--eval-data", "x.jsonl"], "item 10"),
    (["--eval-protocol", "avg@4"], "item 10"),
    (["--gen-allocation", "d1"], "item 8.6b"),
    (["--gen-server-url", "tcp://localhost:1"], "item 7.8"),
    (["--gen-server-url", "zmq://localhost:1"], "item 7.8"),
]


@pytest.mark.parametrize("flags,item", UNPORTED, ids=[
    u[0][0] + "=" + "_".join(u[0][1:]).split(":")[0] for u in UNPORTED])
def test_unported_flag_exits(tmp_path, ckpt_dir, data_path, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP queue 1, {item}"):
        quickstart.main(_argv(ckpt_dir, data_path, tmp_path, *flags), device="cpu")


def test_sft_exits(tmp_path, ckpt_dir):
    """`quickstart sft`, once refused, runs its trial to the end: two
    steps over prompt/answer rows with both engine sentinels set far from
    tripping, the last step's stats printed, the model saved at step 2
    (tests/test_torch_sft.py holds it against the JAX CLI)."""
    data = tmp_path / "sft.jsonl"
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps({"id": f"r{i}", "prompt": f"Q{i}: {i} + {i} = ",
                                "answer": f"{2 * i}"}) + "\n")
    stats = quickstart.main(
        ["sft", "--model.path", ckpt_dir, "--dataset.path", str(data), "--tokenizer-path",
         "char:512", "--batch-size", "4", "--fileroot", str(tmp_path), "--save-freq-steps", "2",
         "--anomaly-grad-norm-mult", "100", "--anomaly-update-norm-max", "100"],
        device="cpu",
    )
    assert len(stats) == 2 and all(s["quarantined"] == 0.0 for s in stats)
    assert np.isfinite(stats[-1]["loss"]) and stats[-1]["nll"] == pytest.approx(stats[-1]["loss"])
    saved = os.path.join(tmp_path, "checkpoints", "sft", "trial0", "default@0", "step_2")
    cfg, params = hf.load_hf_checkpoint(saved, dtype=torch.float32, device="cpu")
    assert cfg.n_layers == jtiny().n_layers


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
    ["--episode-max-turns", "2"],
    ["--episode-token-budget", "64"],
    ["--tool-timeout-s", "1"],
    ["--anomaly-grad-norm-mult", "3"],
    ["--anomaly-update-norm-max", "100"],
    ["--anomaly-kl-max", "10"],
    ["--pipeline-overlap"],
    ["--pipeline-overlap", "--overlap-window", "1"],
    ["--pipeline-overlap", "--overlap-window", "3", "--pipeline-chunk-seqs", "2"],
    ["--master-dtype", "bfloat16"],
    ["--remat", "dots"],
    ["--remat", "dots_small"],
    ["--ref-path", "{ckpt}", "--fuse-rew-ref"],
    ["--rollout-ahead", "1"],
    ["--max-head-offpolicyness", "0"],
    ["--max-head-offpolicyness", "1"],
    ["--max-head-offpolicyness", "1", "--replay-capacity", "8"],
    ["--gen-server-url", "{server}"],
    ["--gen-server-url", "{server}", "--inmem-weight-sync"],
    ["--gen-server-url", "{server}", "--param-push-tree"],
    ["--gen-server-url", "{server}", "--param-push-tree", "--param-push-fanout", "1"],
    ["--no-weight-push-checksum"],
    ["--multiprocess"],
    ["--multiprocess", "--recover-retries", "1", "--mfc-timeout-s", "120",
     "--worker-heartbeat-s", "2"],
    ["--recover-retries", "1"],
    ["--mfc-timeout-s", "60"],
    ["--worker-heartbeat-s", "2"],
    ["--verifier-pool"],
    ["--mixture-weight", "math=3", "--mixture-weight", "code=1"],
    ["--mixture-adaptive", "--mixture-weight", "math=1"],
]


def _flag_id(f):
    if f[0] == "--ref-path":
        return f[2]
    if f[0] in ("--remat", "--max-head-offpolicyness"):
        return "_".join(f)
    if f[0] in ("--gen-server-url", "--multiprocess"):
        return "_".join(x for x in f if x.startswith("--"))
    return "_".join(x for x in f if x.startswith("--")) if f[0] == "--pipeline-overlap" else f[0]


@pytest.mark.parametrize("flags", FORMERLY_UNPORTED, ids=[_flag_id(f) for f in FORMERLY_UNPORTED])
def test_formerly_unported_flag_runs(tmp_path, ckpt_dir, data_path, flags, monkeypatch):
    import tempfile

    cfg = tmp_path / "options.yaml"
    cfg.write_text("batch-size: 4\nlr: 1.0e-4\nckpt_freq_steps: 2\n")
    server = None
    if "{server}" in flags:
        # A generation server on the checkpoint's weights; the pushes'
        # checkpoints go under tmp_path.
        from areal_tpu_torch.engines.generator import GeneratorEngine
        from areal_tpu_torch.system.gen_server import GenerationServer

        mcfg, params = hf.load_hf_checkpoint(ckpt_dir, device="cpu")
        server = GenerationServer(GeneratorEngine(mcfg, params, "cpu", eos_token_id=1),
                                  max_wait_ms=10.0, ckpt_root=str(tmp_path))
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    flags = [f.format(ckpt=ckpt_dir, yaml=cfg, server=server.url if server else "")
             for f in flags]
    if "--multiprocess" in flags:
        _keep_runtime_env(monkeypatch)
    verifier = None
    if "--verifier-pool" in flags:
        # One announced verifier of the trial's fleet grades every batch.
        from areal_tpu_torch.system.verifier_pool import VerifierWorker

        verifier = VerifierWorker(port=0)
        verifier.announce("ppo-math", "trial0", "v0", ttl=30.0)
    try:
        stats = quickstart.main(_argv(ckpt_dir, data_path, tmp_path, *flags), device="cpu")
    finally:
        if server is not None:
            server.close()
        if verifier is not None:
            verifier.close()
    if verifier is not None:
        assert verifier.graded == 2 * 4 * 2  # steps x prompts x group size
    assert len(stats) == 2 and np.isfinite(stats[-1]["actor_train/actor_loss"])
    recover_dir = os.path.join(tmp_path, "checkpoints", "ppo-math", "trial0", "actor@0",
                               "recover_checkpoint")
    assert os.path.isdir(recover_dir) == (flags[0] in ("--ckpt-freq-steps", "--config"))
    assert all(s["actor_train/quarantined"] == 0.0 for s in stats)
    if "--fuse-rew-ref" in flags:
        assert "fused_rew_ref/perf/time_s" in stats[-1] and "ref_inf/perf/time_s" not in stats[-1]
    if flags[0] == "--pipeline-overlap":
        window = int(flags[flags.index("--overlap-window") + 1]) if len(flags) > 1 else 2
        chunk = int(flags[flags.index("--pipeline-chunk-seqs") + 1]) if len(flags) > 3 else 1
        assert stats[-1]["pipeline/window"] == window
        assert stats[-1]["pipeline/n_chunks"] == (1 if window == 1 else 4 // chunk)
    if flags[0] == "--max-head-offpolicyness":
        cap = int(flags[1])
        assert [s["replay/staleness"] <= cap for s in stats] == [True, True]
        assert stats[-1]["replay/accepted"] == 2.0 and stats[-1]["replay/rejected"] == 0.0
        assert ("actor_train/behav_imp_weight" in stats[-1]) == (cap > 0)
    if flags[0] == "--rollout-ahead":
        assert "replay/staleness" not in stats[-1]
    if server is not None:
        assert server.version == 2  # one push a step
    if "--multiprocess" in flags:  # each worker's log is on the fileroot
        logs = os.path.join(tmp_path, "logs", "ppo-math_trial0-attempt0")
        assert os.listdir(logs) == ["model_worker-0.log"]


def _keep_runtime_env(monkeypatch):
    """A --multiprocess trial points this process at its name-resolve
    store and authkey; give later tests theirs back, and keep the worker
    processes to two threads each."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.stream import ENV_AUTHKEY

    for key in ("AREAL_NAME_RESOLVE", "AREAL_NAME_RESOLVE_ROOT", ENV_AUTHKEY):
        monkeypatch.setenv(key, os.environ.get(key, ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(name_resolve, "_default", name_resolve._default)


def test_sft_multiprocess_runs(tmp_path, ckpt_dir, monkeypatch):
    """`quickstart sft --multiprocess`: the SFT trial with its worker in
    a process of its own on the CPU, two steps and a save at step 2."""
    _keep_runtime_env(monkeypatch)
    data = tmp_path / "sft.jsonl"
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps({"id": f"r{i}", "prompt": f"Q{i}: {i} + {i} = ",
                                "answer": f"{2 * i}"}) + "\n")
    stats = quickstart.main(
        ["sft", "--model.path", ckpt_dir, "--dataset.path", str(data), "--tokenizer-path",
         "char:512", "--batch-size", "4", "--fileroot", str(tmp_path), "--save-freq-steps", "2",
         "--multiprocess", "--mfc-timeout-s", "120"],
        device="cpu",
    )
    assert len(stats) == 2 and np.isfinite(stats[-1]["loss"])
    saved = os.path.join(tmp_path, "checkpoints", "sft", "trial0", "default@0", "step_2")
    assert os.path.isdir(saved)


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
    cfg.write_text("launcher: slurm\n")
    with pytest.raises(SystemExit, match="--launcher is not yet ported"):
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


def test_param_push_tree_trial_matches_jax(tmp_path, ckpt_dir, data_path, monkeypatch, capsys):
    """`ppo-math --gen-server-url A,B --param-push-tree --param-push-fanout 1`
    through both packages' CLI, each against two fresh port generation
    servers on the checkpoint (greedy, the query-id reward of
    tests/test_torch_experiments.py's parity case, 2 steps): the graded
    tokens of both steps are equal, every actor_train stat is within the
    parity case's rtol 1e-4, atol 1e-6, and after each trial its servers
    serve version 2 with the weights its trainer saved at step 2, bit for
    bit (the fabric carries the fp32 masters)."""
    import dataclasses

    from areal_tpu.api.config import ModelInterfaceAbstraction as JInterface
    from areal_tpu.apps import quickstart as jquickstart
    from areal_tpu_torch.api.config import ModelInterfaceAbstraction
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.gen_server import GenerationServer
    from tests.test_torch_experiments import _PARITY_REWARD, _SEEN

    for mod, interface in ((jquickstart.exps, JInterface),
                           (quickstart.exps, ModelInterfaceAbstraction)):
        def build(cfg, *a, _real=mod.build_ppo_math, _interface=interface, **k):
            cfg = dataclasses.replace(cfg, gconfig=cfg.gconfig.new(greedy=True),
                                      reward_interface=_interface(_PARITY_REWARD))
            return _real(cfg, *a, **k)

        monkeypatch.setattr(mod, "build_ppo_math", build)
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    out = {}
    for pkg in ("jax", "port"):
        mcfg, params = hf.load_hf_checkpoint(ckpt_dir, device="cpu")
        servers = [GenerationServer(GeneratorEngine(mcfg, params, "cpu", eos_token_id=1),
                                    max_wait_ms=10.0) for _ in range(2)]
        try:
            flags = ["--gen-server-url", ",".join(s.url for s in servers), "--param-push-tree",
                     "--param-push-fanout", "1", "--save-freq-steps", "2"]
            argv = _argv(ckpt_dir, data_path, tmp_path / pkg, *flags)
            capsys.readouterr()
            if pkg == "jax":
                jquickstart.main(argv)
                stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            else:
                stats = quickstart.main(argv, device="cpu")[-1]
            saved = os.path.join(tmp_path, pkg, "checkpoints", "ppo-math", "trial0", "actor@0",
                                 "step_2")
            _, want = hf.load_hf_checkpoint(saved, dtype=torch.float32, device="cpu")
            assert [s.version for s in servers] == [2, 2] and all(
                s.inmem_updates == 2 for s in servers)
            for s in servers:
                for a, b in zip(integrity._leaves(s.engine.params), integrity._leaves(want)):
                    assert torch.equal(a, b)
            out[pkg] = stats
        finally:
            for s in servers:
                s.close()
    assert len(_SEEN["port"]) == len(_SEEN["jax"]) == 2
    for (tids, ttoks), (jids, jtoks) in zip(_SEEN["port"], _SEEN["jax"]):
        assert tids == jids
        np.testing.assert_array_equal(ttoks, jtoks)
    keys = [k for k in out["port"] if k.startswith("actor_train/")
            and "/perf/" not in k and "/time/" not in k]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_allclose(out["port"][k], out["jax"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
