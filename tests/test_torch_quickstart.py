"""The port's quickstart CLI end to end (twin of
tests/test_quickstart_cli.py:49): `quickstart.main(["ppo-math", ...],
device="cpu")` runs a tiny trial from a checkpoint the JAX package wrote,
with a ref model, KL control and the byte tokenizer, prints the last
step's stats and saves the actor; every flag whose feature is not yet
ported exits naming its ROADMAP item."""

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
    (["--config", "x.yaml"], "item 4"),
    (["--allocation", "d2"], "item 8"),
    (["--allocation", "search"], "item 10"),
    (["--chip", "v5p"], "item 10"),
    (["--search-devices", "8"], "item 10"),
    (["--ckpt-freq-steps", "1"], "item 4"),
    (["--launcher", "slurm"], "item 10"),
    (["--tpu-name", "x"], "item 10"),
    (["--multiprocess"], "item 7"),
    (["--recover-retries", "1"], "item 4"),
    (["--mfc-timeout-s", "60"], "item 4"),
    (["--worker-heartbeat-s", "2"], "item 7"),
    (["--max-recoveries", "1"], "item 4"),
    (["--anomaly-grad-norm-mult", "3"], "item 6"),
    (["--anomaly-update-norm-max", "1"], "item 6"),
    (["--max-consecutive-quarantines", "1"], "item 4"),
    (["--no-weight-push-checksum"], "item 7"),
    (["--eval-data", "x.jsonl"], "item 10"),
    (["--eval-protocol", "avg@4"], "item 10"),
    (["--gen-allocation", "d1"], "item 8"),
    (["--gen-server-url", "http://localhost:1"], "item 7"),
    (["--ref-ema-eta", "0.5"], "item 4"),
    (["--kv-cache-dtype", "int8"], "item 5.1"),
    (["--no-paged-kv"], "item 5.1"),
    (["--prefill-chunk-tokens", "0"], "item 5.3"),
    (["--master-dtype", "bfloat16"], "item 6"),
    (["--remat", "dots"], "item 6"),
    (["--fuse-rew-ref"], "item 6"),
    (["--spec-decode-k", "2"], "item 5.2"),
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
