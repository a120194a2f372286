"""The null trials (port of areal_tpu/experiments/null.py): the whole
in-process runtime with no device compute.

`build_null_sft` and `build_null_ppo` build trials whose MFCs run the
"null" interface (`interfaces/null.py`) on engine-less "null" models,
so the master's dispatch, the data plane, the buffer and the epoch
accounting run as in a real trial while each MFC does nothing.  Run one
with `experiments.common.run_experiment`.  The trial runs on one worker:
the JAX config's `n_workers` (empty extra workers) waits for the
cross-worker planes (ROADMAP queue 1, items 7 and 8).
"""

import dataclasses

from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
from areal_tpu_torch.api.dfg import MFCDef, build_graph
from areal_tpu_torch.api.model_api import FinetuneSpec
from areal_tpu_torch.experiments.common import ExperimentPlan
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from areal_tpu_torch.system.worker import ModelShardSpec, WorkerConfig


@dataclasses.dataclass
class NullSFTConfig:
    dataset: DatasetAbstraction
    batch_size: int = 8
    total_train_epochs: int = 1
    ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    seed: int = 1
    experiment_name: str = "null-sft"
    trial_name: str = "trial"
    fileroot: str = "/tmp/areal_tpu_torch/trial"


def _null_shard(name: ModelName) -> ModelShardSpec:
    return ModelShardSpec(
        name=name,
        model=ModelAbstraction("null"),
        backend=ModelBackendAbstraction("null"),
        interface=ModelInterfaceAbstraction("null"),
    )


def _plan(cfg: NullSFTConfig, nodes, shards) -> ExperimentPlan:
    """Every shard and the dataset on one worker."""
    ftspec = FinetuneSpec(
        total_train_epochs=cfg.total_train_epochs, train_batch_size=cfg.batch_size
    )
    worker = WorkerConfig(
        worker_index=0, shards=shards, datasets=[cfg.dataset], batch_size=cfg.batch_size,
        seed=cfg.seed, ftspec=ftspec,
    )
    cfg.ctrl.total_train_epochs = cfg.total_train_epochs
    return ExperimentPlan(
        dfg=build_graph(nodes),
        worker_configs=[worker],
        model_placement={str(s.name): 0 for s in shards},
        data_worker_ids=[0],
        ctrl=cfg.ctrl,
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        fileroot=cfg.fileroot,
    )


def build_null_sft(cfg: NullSFTConfig) -> ExperimentPlan:
    """One no-op train MFC over a real dataset."""
    model_name = ModelName("default", 0)
    node = MFCDef(
        name="trainDefault",
        model_name=model_name,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=ModelInterfaceAbstraction("null"),
        input_keys=("packed_input_ids", "prompt_mask"),
        n_seqs=cfg.batch_size,
        mb_spec=MicroBatchSpec(),
    )
    return _plan(cfg, [node], [_null_shard(model_name)])


def build_null_ppo(cfg: NullSFTConfig) -> ExperimentPlan:
    """Reward inference -> train over prompt data: the smallest
    two-MFC dataflow."""
    rew = ModelName("reward", 0)
    actor = ModelName("actor", 0)
    nodes = [
        MFCDef(
            name="rew_inf",
            model_name=rew,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=ModelInterfaceAbstraction("null"),
            input_keys=("packed_prompts",),
            output_keys=("rewards",),
            n_seqs=cfg.batch_size,
            mb_spec=MicroBatchSpec(),
        ),
        MFCDef(
            name="actor_train",
            model_name=actor,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=ModelInterfaceAbstraction("null"),
            input_keys=("packed_prompts", "rewards"),
            n_seqs=cfg.batch_size,
            mb_spec=MicroBatchSpec(),
        ),
    ]
    return _plan(cfg, nodes, [_null_shard(rew), _null_shard(actor)])
