"""Experiment builders: user config -> (DFG, workers, placement) (port of
`ExperimentPlan`, `PPOMathConfig`, `build_ppo_math` and `run_experiment`
in areal_tpu/experiments/common.py).

`build_ppo_math` builds the JAX package's ppo-math dataflow: generate ->
{reward, ref, critic inference} -> actor and critic train steps, the
generator taking the actor's weights after each train step (and, with
`ref_ema_eta`, the reference model moving toward them).  Every model
lives on one worker on one device.  The options the port does not have
yet stay in `PPOMathConfig` with their "off" defaults and fail
`check_ppo_math` when set (see `experiments/check.unported_options`).
"""

import asyncio
import dataclasses
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
from areal_tpu_torch.api.dfg import DFG, MFCDef, OffloadHook, ParamReallocHook, build_graph
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    GenerationHyperparameters,
    OptimizerConfig,
)
from areal_tpu_torch.system.master import ExperimentSaveEvalControl
from areal_tpu_torch.system.worker import ModelShardSpec, WorkerConfig


@dataclasses.dataclass
class ExperimentPlan:
    """Everything the runtime needs to execute a trial."""

    dfg: DFG
    worker_configs: List[WorkerConfig]
    model_placement: Dict[str, int]
    data_worker_ids: List[int]
    ctrl: ExperimentSaveEvalControl
    experiment_name: str = "exp"
    trial_name: str = "trial"
    fileroot: str = "/tmp/areal_tpu_torch/trial"
    # {"min_accuracy": .., "max_accuracy": ..} -> dynamic difficulty
    # filtering of prompts by per-step group accuracy.
    difficulty_filter: Optional[Dict[str, float]] = None
    # Rollbacks the master absorbs, and the quarantine streak that
    # triggers one (see system/master.py).
    max_recoveries: int = 3
    max_consecutive_quarantines: int = 3


@dataclasses.dataclass
class PPOMathConfig:
    actor: ModelAbstraction
    dataset: DatasetAbstraction
    # None -> GRPO (disable_value).
    critic: Optional[ModelAbstraction] = None
    ref: Optional[ModelAbstraction] = None
    reward_interface_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Overrides the reward interface (default: "rw-math-code" with
    # reward_interface_args).
    reward_interface: Optional[ModelInterfaceAbstraction] = None
    critic_interface_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(lr=2e-5)
    )
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    ppo_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # GeneratorEngine and TrainEngine kwargs; the kv_* knobs and
    # prefill_chunk_tokens go to the GeneratorEngine when not None.
    gen_backend_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kv_paged: Optional[bool] = None
    kv_page_size: int = 128
    kv_pool_pages: int = 0
    prefill_chunk_tokens: Optional[int] = None
    kv_share_prefix: Optional[bool] = None
    train_backend_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Host-offload the reference model's params after each ref_inf call.
    offload_ref: bool = False
    reward_backend: str = ""
    batch_size: int = 8  # prompts per step
    total_train_epochs: int = 1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    seed: int = 1
    experiment_name: str = "ppo-math"
    trial_name: str = "trial"
    fileroot: str = "/tmp/areal_tpu_torch/trial"
    # Dynamic difficulty filtering: {"min_accuracy", "max_accuracy"}.
    dataset_filter: Optional[Dict[str, float]] = None
    # EMA-update the reference model toward the actor after each train
    # step (ref <- eta * actor + (1 - eta) * ref).  None: a frozen ref.
    ref_ema_eta: Optional[float] = None
    # Rollbacks to the recover checkpoint the master absorbs, and the
    # quarantine streak that triggers one (0: never).
    max_recoveries: int = 3
    max_consecutive_quarantines: int = 3
    # ---- not yet ported: check_ppo_math refuses a value other than these ----
    rollout_ahead: int = 0
    max_head_offpolicyness: Optional[int] = None
    pipeline_overlap: bool = False
    fuse_rew_ref: bool = False
    gen_server_url: Optional[str] = None
    inmem_weight_sync: bool = False
    param_push_tree: bool = False
    verifier_pool: bool = False
    mixture_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    mixture_adaptive: bool = False
    placement: Dict[str, Any] = dataclasses.field(default_factory=dict)
    anomaly_grad_norm_mult: float = 0.0
    anomaly_update_norm_max: float = 0.0
    anomaly_kl_max: Optional[float] = None
    episode_max_turns: int = 0


def build_ppo_math(cfg: PPOMathConfig, tokenizer=None) -> ExperimentPlan:
    """The ppo-math DFG: generate -> {reward, ref, critic-inf} -> actor
    and critic train, with the weight sync to the generator after the
    actor's train step."""
    from areal_tpu_torch.experiments.check import check_ppo_math

    check_ppo_math(cfg)
    disable_value = cfg.critic is None
    actor = ModelName("actor", 0)
    actor_gen = ModelName("actor_gen", 0)
    reward = ModelName("reward", 0)
    ref = ModelName("ref", 0) if cfg.ref is not None else None
    critic = ModelName("critic", 0) if not disable_value else None

    ppo_kwargs = dict(cfg.ppo_kwargs)
    ppo_kwargs.setdefault("disable_value", disable_value)
    use_dense = bool(ppo_kwargs.get("use_dense_reward"))
    if use_dense and cfg.reward_interface is None:
        raise ValueError(
            "use_dense_reward needs a custom reward_interface that emits "
            "'dense_rewards' (the default rw-math-code grades scalars only)"
        )
    rew_args = dict(cfg.reward_interface_args)
    if cfg.reward_backend:
        rew_args.setdefault("reward_backend", cfg.reward_backend)
    rew_if = cfg.reward_interface or ModelInterfaceAbstraction("rw-math-code", rew_args)
    rew_outputs = ("rewards", "dense_rewards") if use_dense else ("rewards",)
    actor_if = ModelInterfaceAbstraction("ppo_actor", {"gconfig": cfg.gconfig, **ppo_kwargs})
    critic_if = ModelInterfaceAbstraction("ppo_critic", {
        **{k: v for k, v in ppo_kwargs.items() if k in ("n_minibatches", "kl_ctl")},
        **cfg.critic_interface_args,
    })
    nodes = [
        MFCDef(
            name="actor_gen",
            model_name=actor_gen,
            interface_type=ModelInterfaceType.GENERATE,
            interface_impl=actor_if,
            input_keys=("packed_prompts",),
            output_keys=("packed_input_ids", "packed_logprobs", "prompt_mask",
                         "seq_no_eos_mask"),
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ),
        MFCDef(
            name="rew_inf",
            model_name=reward,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=rew_if,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=rew_outputs,
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ),
    ]
    train_inputs = ["packed_input_ids", "prompt_mask", "packed_logprobs", "seq_no_eos_mask",
                    "rewards"]
    if use_dense:
        train_inputs.append("dense_rewards")
    if ref is not None:
        nodes.append(MFCDef(
            name="ref_inf",
            model_name=ref,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=ModelInterfaceAbstraction("ppo_actor"),
            input_keys=("packed_input_ids",),
            output_keys=("packed_ref_logprobs",),
            output_key_remap={"logprobs": "packed_ref_logprobs"},
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
            post_hooks=[OffloadHook()] if cfg.offload_ref else [],
        ))
        train_inputs.append("packed_ref_logprobs")
    if critic is not None:
        nodes.append(MFCDef(
            name="critic_inf",
            model_name=critic,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=critic_if,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=("values",),
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ))
        train_inputs.append("values")
    # After training, the generator takes the fresh weights.
    train_post_hooks = [ParamReallocHook(target=actor_gen)]
    if cfg.ref_ema_eta is not None:
        if ref is None:
            raise ValueError("ref_ema_eta requires a ref model")
        train_post_hooks.append(ParamReallocHook(target=ref, eta=cfg.ref_ema_eta))
        if cfg.offload_ref:
            # The EMA update reloads the ref onto the card; push it back
            # to host memory so offload_ref keeps its memory free.
            train_post_hooks.append(OffloadHook(target=ref))
    nodes.append(MFCDef(
        name="actor_train",
        model_name=actor,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=actor_if,
        input_keys=tuple(train_inputs),
        n_seqs=cfg.batch_size,
        mb_spec=cfg.mb_spec,
        post_hooks=train_post_hooks,
    ))
    if critic is not None:
        nodes.append(MFCDef(
            name="critic_train",
            model_name=critic,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=critic_if,
            input_keys=("packed_input_ids", "prompt_mask", "packed_logprobs",
                        "seq_no_eos_mask", "rewards", "values"),
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ))
    dfg = build_graph(nodes)

    gen_args = {
        k: v for k, v in (
            ("kv_paged", cfg.kv_paged),
            ("kv_page_size", cfg.kv_page_size),
            ("kv_pool_pages", cfg.kv_pool_pages),
            ("prefill_chunk_tokens", cfg.prefill_chunk_tokens),
            ("kv_share_prefix", cfg.kv_share_prefix),
        ) if v is not None
    }
    shards = [
        ModelShardSpec(
            name=actor, model=cfg.actor,
            backend=ModelBackendAbstraction("train", dict(cfg.train_backend_args)),
            interface=actor_if, optimizer=cfg.optimizer,
        ),
        ModelShardSpec(
            name=actor_gen, model=cfg.actor,
            backend=ModelBackendAbstraction("generator", {**gen_args, **cfg.gen_backend_args}),
            interface=actor_if,
        ),
        ModelShardSpec(
            name=reward, model=ModelAbstraction("null"),
            backend=ModelBackendAbstraction("null"), interface=rew_if,
        ),
    ]
    if ref is not None:
        shards.append(ModelShardSpec(
            name=ref, model=cfg.ref, backend=ModelBackendAbstraction("inference"),
            interface=ModelInterfaceAbstraction("ppo_actor"),
        ))
    if critic is not None:
        shards.append(ModelShardSpec(
            name=critic, model=cfg.critic,
            backend=ModelBackendAbstraction("train", dict(cfg.train_backend_args)),
            interface=critic_if, optimizer=cfg.optimizer,
        ))
    ftspec = FinetuneSpec(total_train_epochs=cfg.total_train_epochs,
                          train_batch_size=cfg.batch_size)
    worker = WorkerConfig(
        worker_index=0, shards=shards, datasets=[cfg.dataset], batch_size=cfg.batch_size,
        seed=cfg.seed, ftspec=ftspec,
    )
    cfg.ctrl.total_train_epochs = cfg.total_train_epochs
    return ExperimentPlan(
        dfg=dfg,
        worker_configs=[worker],
        model_placement={str(s.name): 0 for s in shards},
        data_worker_ids=[0],
        ctrl=cfg.ctrl,
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        fileroot=cfg.fileroot,
        difficulty_filter=cfg.dataset_filter,
        max_recoveries=cfg.max_recoveries,
        max_consecutive_quarantines=cfg.max_consecutive_quarantines,
    )


def run_experiment(plan: ExperimentPlan, tokenizer=None, device=None):
    """In-process runner: build the workers on `device` (the CUDA card
    unless told otherwise), drive the master loop to completion.  A
    trial with recover info on its fileroot resumes from it.  Returns
    (master, per-step stats)."""
    from areal_tpu_torch.system.master import InProcessPool, MasterWorker
    from areal_tpu_torch.system.worker import ModelWorker

    workers = [ModelWorker(wc, tokenizer=tokenizer, device=device) for wc in plan.worker_configs]
    master = MasterWorker(
        dfg=plan.dfg,
        pool=InProcessPool(workers),
        model_placement=plan.model_placement,
        data_worker_ids=plan.data_worker_ids,
        ctrl=plan.ctrl,
        fileroot=plan.fileroot,
        experiment_name=plan.experiment_name,
        trial_name=plan.trial_name,
        difficulty_filter=plan.difficulty_filter,
        max_recoveries=plan.max_recoveries,
        max_consecutive_quarantines=plan.max_consecutive_quarantines,
    )
    master.load_recover_info()
    stats = asyncio.run(master.run())
    return master, stats
