"""A killed member of an SPMD worker group (ROADMAP queue 1, item 8.6a):
a world cannot go on without a rank, so the member's death takes the
whole group down and the launcher restarts every member from the recover
checkpoint, with a fresh rendezvous key for the new attempt.

`build_sft(n_hosts=2, parallel=d2)` on the CPU over gloo, a recover
checkpoint every step (gathered, written by rank 0), worker 1 killed at
step 2's train step (`kill@point=mfc_train_step`, its environment only):
attempt 0 fails, attempt 1 resubmits both members, resumes from step 1
and runs step 2, whose loss, nll and norms equal the uninterrupted
one-process trial's within rtol 1e-4 (tests/test_torch_sft.py's
tolerance)."""

import json
import os

import numpy as np

from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
from areal_tpu_torch.api.model_api import OptimizerConfig
from areal_tpu_torch.apps import main as runner
from areal_tpu_torch.base.topology import ParallelConfig
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from tests import fixtures
from tests.test_torch_group_sft import _restore_runtime_env  # noqa: F401


def _cfg(tmp_path, n_hosts, layout, sub):
    data = tmp_path / "data.jsonl"
    if not data.exists():
        with open(data, "w") as f:
            for r in fixtures.build_sft_rows(16, seed=5):
                f.write(json.dumps(r) + "\n")
    return exps.SFTConfig(
        model=ModelAbstraction("random", {"config": tiny_config()}),
        dataset=DatasetAbstraction("prompt_answer", {"dataset_path": str(data),
                                                     "max_length": 128}),
        n_hosts=n_hosts, parallel=ParallelConfig.from_str(layout),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0), batch_size=8,
        mb_spec=MicroBatchSpec(n_mbs=2),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2, ckpt_freq_steps=1),
        experiment_name="grp-recover", trial_name=sub, fileroot=str(tmp_path / sub),
    )


def test_killed_member_restarts_the_whole_group(tmp_path):
    plan = exps.build_sft(_cfg(tmp_path, 2, "d2", "group"))
    for wc in plan.worker_configs:
        wc.tokenizer_path = "char:512"
    timeline = []
    stats = runner.run_experiment(
        plan, device="cpu", recover_retries=1, timeline=timeline,
        worker_env={"OMP_NUM_THREADS": "1"},
        worker_envs={1: {"AREAL_FAULTS": "kill@point=mfc_train_step&skip=1&times=1"}},
    )
    events = [(e["event"], e.get("attempt")) for e in timeline]
    assert events == [("submit", 0), ("connected", None), ("failed", 0),
                      ("submit", 1), ("connected", None), ("done", 1)], events
    logs = os.path.join(plan.fileroot, "logs")
    with open(os.path.join(logs, "grp-recover_group-attempt0", "model_worker-1.log")) as f:
        assert "FAULT kill at point 'mfc_train_step'" in f.read()
    # Both members joined a world again, at the new attempt's key.
    for w in (0, 1):
        with open(os.path.join(logs, "grp-recover_group-attempt1",
                               f"model_worker-{w}.log")) as f:
            log = f.read()
        assert f"process {w}/2 joining the world" in log
    # Attempt 1 ran step 2 only, from step 1's checkpoint.
    assert len(stats) == 1
    solo_plan = exps.build_sft(_cfg(tmp_path, 1, "d1", "solo"))
    for wc in solo_plan.worker_configs:
        wc.tokenizer_path = "char:512"
    _, solo = exps.run_experiment(solo_plan, device="cpu")
    for k in ("loss", "nll", "grad_norm", "update_norm"):
        np.testing.assert_allclose(stats[0][k], solo[1][k], rtol=1e-4, err_msg=k)
