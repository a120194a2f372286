"""Experiment builders: user config -> (DFG, workers, placement) (port of
`ExperimentPlan`, `SFTConfig`, `build_sft`, `PPOMathConfig`,
`build_ppo_math` and `run_experiment` in areal_tpu/experiments/common.py).

`build_sft` builds the one-node SFT dataflow (a TRAIN_STEP of the "sft"
interface over `prompt_answer` rows).  The engine's sentinels
(`anomaly_grad_norm_mult`, `anomaly_update_norm_max`) reach the train
engines of both plans; PPO's `anomaly_kl_max` reaches the actor
interface.  `build_ppo_math` builds the JAX package's ppo-math dataflow: generate ->
{reward, ref, critic inference} -> actor and critic train steps, the
generator taking the actor's weights after each train step (and, with
`ref_ema_eta`, the reference model moving toward them).  With
`fuse_rew_ref` one MFC on the ref's worker (`interfaces/fused.py`)
grades the rewards while the ref's forward runs.  The train engines take
`train_backend_args` (`master_dtype`, `remat_policy`).  Asynchronous RL:
`rollout_ahead` and `max_head_offpolicyness` pick the master's async
step modes (a positive cap turns on decoupled PPO through
`behav_imp_weight_cap`), and `gen_server_url` makes the generator a
weightless client of generation servers (`_remote_gen_shard`, the
`remote_generator` backend), its weights pushed from disk after each
train step (paused around the push with `inmem_weight_sync`).
`placement` puts a model role on another worker (the datasets on
worker 0), or with a list of workers makes it independent replicas
(`model_replicas`: the master splits its forwards among them), and
`mfc_timeout_s` and `worker_heartbeat_s` reach the plan for the
multi-process runtime (`apps/main.py run_experiment`).  A layout above
one device (`SFTConfig.n_hosts` with `parallel`, `PPOMathConfig.
actor_parallel`) is an SPMD worker group, one process a card
(`model_groups`): the trainer models on a mesh over its ranks, each
`WorkerConfig` carrying its rank (`dist_process_id`) and the world's
size, and ppo-math's generator one engine a member.  The options the
port does not have yet stay in `PPOMathConfig` with their "off"
defaults and fail `check_ppo_math` when set (see
`experiments/check.unported_options`).
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
from areal_tpu_torch.base.topology import ParallelConfig
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
    # Cross-worker weight pushes carry a content checksum the receiver
    # verifies before it swaps (see system/master.py).
    weight_push_checksum: bool = True
    # The pipeline-overlapped step (see system/master.py).
    pipeline_overlap: bool = False
    overlap_window: int = 2
    pipeline_chunk_seqs: int = 1
    # The asynchronous step modes (see system/master.py).
    rollout_ahead: int = 0
    max_head_offpolicyness: Optional[int] = None
    replay_capacity: int = 4
    # The multi-process runtime's liveness (apps/main.py run_experiment,
    # system/stream.py): each request's deadline (None: none) and the
    # workers' heartbeat period.
    mfc_timeout_s: Optional[float] = None
    worker_heartbeat_s: float = 5.0
    # Model key -> every worker of its SPMD group (one world, one card a
    # member; group[0] the primary), and model key -> the workers holding
    # its independent replicas (see system/master.py).  A group needs
    # the multi-process runtime (apps/main.py run_experiment).
    model_groups: Optional[Dict[str, List[int]]] = None
    model_replicas: Optional[Dict[str, List[int]]] = None


@dataclasses.dataclass
class SFTConfig:
    model: ModelAbstraction
    dataset: DatasetAbstraction
    # > 1: the model over this many worker processes, one card each, the
    # ranks of one world (the SPMD worker group); `parallel` is its mesh
    # over them, so its world size must equal n_hosts.
    n_hosts: int = 1
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    batch_size: int = 8
    total_train_epochs: int = 1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    seed: int = 1
    experiment_name: str = "sft"
    trial_name: str = "trial"
    fileroot: str = "/tmp/areal_tpu_torch/trial"
    mfc_timeout_s: Optional[float] = None
    worker_heartbeat_s: float = 5.0
    max_recoveries: int = 3
    # The engine's sentinels (0: off): the grad-norm spike multiplier
    # over the clean steps' EWMA (> 1 when set) and the update-norm
    # ceiling; and the quarantine streak that rolls back.
    anomaly_grad_norm_mult: float = 0.0
    anomaly_update_norm_max: float = 0.0
    max_consecutive_quarantines: int = 3
    weight_push_checksum: bool = True


def build_sft(cfg: SFTConfig, tokenizer=None) -> ExperimentPlan:
    """One TRAIN_STEP node of the "sft" interface over the dataset's
    `packed_input_ids` and `prompt_mask`."""
    from areal_tpu_torch.experiments.check import check_sft

    check_sft(cfg)
    model_name = ModelName("default", 0)
    sft_if = ModelInterfaceAbstraction("sft")
    node = MFCDef(
        name="trainDefault",
        model_name=model_name,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=sft_if,
        input_keys=("packed_input_ids", "prompt_mask"),
        # The tokens feed the device only; prompt_mask stays broadcast
        # (its host-side counts set the global loss weight).
        shard_keys=("packed_input_ids",),
        n_seqs=cfg.batch_size,
        mb_spec=cfg.mb_spec,
    )
    group = cfg.n_hosts > 1
    shard = ModelShardSpec(
        name=model_name, model=cfg.model,
        backend=ModelBackendAbstraction("train", _anomaly_backend_args(cfg)),
        interface=sft_if, optimizer=cfg.optimizer,
        parallel=cfg.parallel if group else None,
    )
    ftspec = FinetuneSpec(total_train_epochs=cfg.total_train_epochs,
                          train_batch_size=cfg.batch_size)
    workers = [
        WorkerConfig(
            worker_index=w, shards=[shard], datasets=[cfg.dataset] if w == 0 else [],
            batch_size=cfg.batch_size, seed=cfg.seed, ftspec=ftspec,
            dist_process_id=w, dist_num_processes=cfg.n_hosts if group else 0,
            dist_timeout_s=cfg.mfc_timeout_s,
        )
        for w in range(cfg.n_hosts)
    ]
    cfg.ctrl.total_train_epochs = cfg.total_train_epochs
    return ExperimentPlan(
        dfg=build_graph([node]),
        worker_configs=workers,
        model_placement={str(model_name): 0},
        model_groups={str(model_name): list(range(cfg.n_hosts))} if group else None,
        data_worker_ids=[0],
        ctrl=cfg.ctrl,
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        fileroot=cfg.fileroot,
        max_recoveries=cfg.max_recoveries,
        max_consecutive_quarantines=cfg.max_consecutive_quarantines,
        weight_push_checksum=cfg.weight_push_checksum,
        mfc_timeout_s=cfg.mfc_timeout_s,
        worker_heartbeat_s=cfg.worker_heartbeat_s,
    )


def _anomaly_backend_args(cfg, base: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A train backend's args with the config's engine sentinels folded
    in (an explicit entry of `base` wins)."""
    args: Dict[str, Any] = dict(base or {})
    if cfg.anomaly_grad_norm_mult:
        args.setdefault("anomaly_grad_norm_mult", cfg.anomaly_grad_norm_mult)
    if cfg.anomaly_update_norm_max:
        args.setdefault("anomaly_update_norm_max", cfg.anomaly_update_norm_max)
    return args


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
    # The trainer models' layouts.  Above one device the actor's is a
    # worker group, one process a card: the actor and the ref (and the
    # critic, given the same world size) run on its mesh over the group,
    # and the generator runs as one engine a member over its own prompts
    # (replicas of the actor's gathered weights).  A model axis above 1,
    # and gen_parallel, need generation on a sharded layout (ROADMAP
    # queue 1, item 8.6b).
    actor_parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    gen_parallel: Optional[ParallelConfig] = None  # None = the actor's
    critic_parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    ref_parallel: Optional[ParallelConfig] = None  # None = the actor's
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
    # TrainEngine kwargs of the actor and the critic: "master_dtype"
    # ("float32" / "bfloat16"), "remat_policy" ("full", "dots",
    # "dots_small", "none").
    train_backend_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Host-offload the reference model's params after each ref_inf call.
    offload_ref: bool = False
    # Grade the rewards and run the ref's forward as ONE MFC on the ref's
    # worker (`fused_rew_ref`, the "fused" interface), the grading on the
    # host overlapping the forward on the card.  Needs a ref model.
    fuse_rew_ref: bool = False
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
    # The multi-process runtime's liveness: each request's deadline (None:
    # none) and the workers' heartbeat period.
    mfc_timeout_s: Optional[float] = None
    worker_heartbeat_s: float = 5.0
    # Rollbacks to the recover checkpoint the master absorbs, and the
    # quarantine streak that triggers one (0: never).
    max_recoveries: int = 3
    max_consecutive_quarantines: int = 3
    weight_push_checksum: bool = True
    # Model role -> worker index (e.g. {"actor_gen": 1, "reward": 1}: the
    # generator and the reward on a second worker, the data and param
    # planes moving what crosses), or a list of indices: independent
    # replicas, the first the primary (e.g. {"ref": [0, 1]}: the ref's
    # forwards split between two workers).  Roles not listed run on
    # worker 0.
    placement: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The pipeline-overlapped step: chunks of pipeline_chunk_seqs prompts
    # stream through generate -> reward/ref -> train grad accumulation,
    # overlap_window chunks in flight, one optimizer step after the last
    # chunk (window 1: the barrier path, bit for bit).
    pipeline_overlap: bool = False
    overlap_window: int = 2
    pipeline_chunk_seqs: int = 1
    # The tunable sentinels: the engine's grad-norm spike multiplier and
    # update-norm ceiling (0: off), the actor's KL ceiling (None: off).
    anomaly_grad_norm_mult: float = 0.0
    anomaly_update_norm_max: float = 0.0
    anomaly_kl_max: Optional[float] = None
    # Asynchronous rollout: 1 = generate step t+1's rollouts while step t
    # trains (one-step-stale behaviour policy).
    rollout_ahead: int = 0
    # Asynchronous RL: cap + 1 rollout batches in flight, admitted to a
    # staleness-bounded replay buffer (None: off; 0: the synchronous
    # ordering).  Exclusive with rollout_ahead.
    max_head_offpolicyness: Optional[int] = None
    # The replay buffer's capacity in batches.
    replay_capacity: int = 4
    # Decoupled PPO's behaviour-weight cap, set on the actor when
    # max_head_offpolicyness > 0 (ppo_kwargs["behav_imp_weight_cap"] wins).
    behav_imp_weight_cap: float = 5.0
    # Generation on remote servers: comma-separated http:// URLs of
    # GenerationServers (one per data-parallel rank); the weights reach
    # them from disk after each train step.
    gen_server_url: Optional[str] = None
    # Pause the servers at a chunk boundary around each push, so a sync
    # costs one chunk of replay instead of a drain.
    inmem_weight_sync: bool = False
    # The broadcast-tree push (system/paramstore.py): set_params on the
    # remote generator publishes ONE serialized payload into a versioned
    # ParamStore and pushes it down a fan-out tree over the servers (each
    # relays to `param_push_fanout` children before it applies), instead
    # of a checkpoint on disk.  Needs gen_server_url.
    param_push_tree: bool = False
    param_push_fanout: int = 2
    # Grade through the trial's announced verifier fleet
    # (system/verifier_pool.py): load-balanced, a breaker a server, a
    # retry on another server, the in-process registry when none is live.
    verifier_pool: bool = False
    # A task-mixture curriculum (data/mixture.py): task -> weight.  As in
    # the JAX package, no code of the in-process trial reads these two:
    # a `RolloutController(mixture=...)` consumes a mixture.
    mixture_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    mixture_adaptive: bool = False
    # Agent episodes (system/episode.py): carried as the JAX package
    # carries them.  No code of the in-process trial reads them there
    # either; only an episode runner on the rollout controller (ROADMAP
    # queue 1 item 7) drives episodes.
    episode_max_turns: int = 0
    episode_token_budget: int = 0
    tool_timeout_s: float = 10.0


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
    if cfg.anomaly_kl_max is not None:
        ppo_kwargs.setdefault("anomaly_kl_max", cfg.anomaly_kl_max)
    train_backend_args = _anomaly_backend_args(cfg, cfg.train_backend_args)
    if (cfg.max_head_offpolicyness or 0) > 0:
        # Off-policy samples are admissible: decoupled PPO corrects them.
        # At cap 0 the plain loss keeps the synchronous numerics.
        ppo_kwargs.setdefault("behav_imp_weight_cap", cfg.behav_imp_weight_cap)
    use_dense = bool(ppo_kwargs.get("use_dense_reward"))
    if use_dense and cfg.reward_interface is None:
        raise ValueError(
            "use_dense_reward needs a custom reward_interface that emits "
            "'dense_rewards' (the default rw-math-code grades scalars only)"
        )
    rew_args = dict(cfg.reward_interface_args)
    if cfg.reward_backend:
        rew_args.setdefault("reward_backend", cfg.reward_backend)
    if cfg.verifier_pool:
        rew_args.setdefault("verifier_pool", True)
        rew_args.setdefault("pool_experiment", cfg.experiment_name)
        rew_args.setdefault("pool_trial", cfg.trial_name)
    rew_if = cfg.reward_interface or ModelInterfaceAbstraction("rw-math-code", rew_args)
    rew_outputs = ("rewards", "dense_rewards") if use_dense else ("rewards",)
    if cfg.fuse_rew_ref and ref is None:
        raise ValueError(
            "fuse_rew_ref=True requires a ref model (the fused MFC runs on "
            "the ref worker); set PPOMathConfig.ref or disable fusion"
        )
    fuse = cfg.fuse_rew_ref
    fused_if = ModelInterfaceAbstraction("fused", {"interfaces": {
        "rew": {"type_": rew_if.type_, "args": rew_if.args},
        "ref": {"type_": "ppo_actor", "args": {}},
    }})
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
    ]
    if fuse:
        # One MFC on the ref's worker: the rewards and the ref logprobs.
        nodes.append(MFCDef(
            name="fused_rew_ref",
            model_name=ref,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=fused_if,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=rew_outputs + ("packed_ref_logprobs",),
            output_key_remap={"logprobs": "packed_ref_logprobs"},
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
            post_hooks=[OffloadHook()] if cfg.offload_ref else [],
        ))
    else:
        nodes.append(MFCDef(
            name="rew_inf",
            model_name=reward,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=rew_if,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=rew_outputs,
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ))
    train_inputs = ["packed_input_ids", "prompt_mask", "packed_logprobs", "seq_no_eos_mask",
                    "rewards"]
    if use_dense:
        train_inputs.append("dense_rewards")
    if ref is not None and not fuse:
        nodes.append(MFCDef(
            name="ref_inf",
            model_name=ref,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=ModelInterfaceAbstraction("ppo_actor"),
            input_keys=("packed_input_ids",),
            shard_keys=("packed_input_ids",),
            output_keys=("packed_ref_logprobs",),
            output_key_remap={"logprobs": "packed_ref_logprobs"},
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
            post_hooks=[OffloadHook()] if cfg.offload_ref else [],
        ))
    if ref is not None:
        train_inputs.append("packed_ref_logprobs")
    if critic is not None:
        nodes.append(MFCDef(
            name="critic_inf",
            model_name=critic,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=critic_if,
            input_keys=("packed_input_ids", "prompt_mask"),
            shard_keys=("packed_input_ids",),
            output_keys=("values",),
            n_seqs=cfg.batch_size,
            mb_spec=cfg.mb_spec,
        ))
        train_inputs.append("values")
    # The train steps ship their per-token keys shard-exactly: per-row
    # math reads only a member's own rows, and the batch-global moments
    # (advantages, the ref KL, the value norm) come from reductions over
    # the mesh.  prompt_mask and the per-sequence keys stay broadcast:
    # every member derives the sequence layout from them.
    heavy = ("packed_input_ids", "packed_logprobs", "packed_ref_logprobs", "values",
             "dense_rewards")
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
        shard_keys=tuple(k for k in train_inputs if k in heavy),
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
            shard_keys=("packed_input_ids", "packed_logprobs", "values"),
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
    # The worker group: the actor's layout over `world` processes.
    world = cfg.actor_parallel.world_size
    members = list(range(world))

    def mesh_of(parallel: Optional[ParallelConfig]) -> Optional[ParallelConfig]:
        parallel = parallel or cfg.actor_parallel
        return parallel if world > 1 and parallel.world_size > 1 else None

    shards = [
        ModelShardSpec(
            name=actor, model=cfg.actor,
            backend=ModelBackendAbstraction("train", dict(train_backend_args)),
            interface=actor_if, optimizer=cfg.optimizer, parallel=mesh_of(cfg.actor_parallel),
        ),
        _remote_gen_shard(cfg, actor_gen, actor_if) if cfg.gen_server_url else ModelShardSpec(
            name=actor_gen, model=cfg.actor,
            backend=ModelBackendAbstraction("generator", {**gen_args, **cfg.gen_backend_args}),
            interface=actor_if,
        ),
    ]
    if not fuse:
        shards.append(ModelShardSpec(
            name=reward, model=ModelAbstraction("null"),
            backend=ModelBackendAbstraction("null"), interface=rew_if,
        ))
    if ref is not None:
        shards.append(ModelShardSpec(
            name=ref, model=cfg.ref, backend=ModelBackendAbstraction("inference"),
            interface=fused_if if fuse else ModelInterfaceAbstraction("ppo_actor"),
            parallel=mesh_of(cfg.ref_parallel),
        ))
    if critic is not None:
        shards.append(ModelShardSpec(
            name=critic, model=cfg.critic,
            backend=ModelBackendAbstraction("train", dict(train_backend_args)),
            interface=critic_if, optimizer=cfg.optimizer,
            parallel=mesh_of(cfg.critic_parallel),
        ))
    ftspec = FinetuneSpec(total_train_epochs=cfg.total_train_epochs,
                          train_batch_size=cfg.batch_size)
    workers_of: Dict[str, List[int]] = {}
    groups: Dict[str, List[int]] = {}
    replicas: Dict[str, List[int]] = {}
    for sh in shards:
        key = str(sh.name)
        if sh.parallel is not None:
            workers_of[key] = groups[key] = list(members)
        elif world > 1 and sh.name == actor_gen:
            # One generator a member, over its own prompts, from the
            # actor's gathered weights: no weights cross processes.
            workers_of[key] = replicas[key] = list(members)
        else:
            where = cfg.placement.get(sh.name.role, 0)
            workers_of[key] = [where] if isinstance(where, int) else list(where)
            if len(workers_of[key]) > 1:
                replicas[key] = list(workers_of[key])
    placement = {k: ws[0] for k, ws in workers_of.items()}
    n_workers = max(w for ws in workers_of.values() for w in ws) + 1
    worker_configs = [
        WorkerConfig(
            worker_index=w,
            shards=[sh for sh in shards if w in workers_of[str(sh.name)]],
            # The datasets live on worker 0; what other workers need moves
            # over the master's data plane.
            datasets=[cfg.dataset] if w == 0 else [],
            batch_size=cfg.batch_size, seed=cfg.seed, ftspec=ftspec,
            dist_process_id=w if groups and w < world else 0,
            dist_num_processes=world if groups and w < world else 0,
            dist_timeout_s=cfg.mfc_timeout_s,
        )
        for w in range(n_workers)
    ]
    cfg.ctrl.total_train_epochs = cfg.total_train_epochs
    return ExperimentPlan(
        dfg=dfg,
        worker_configs=worker_configs,
        model_placement=placement,
        data_worker_ids=[0],
        ctrl=cfg.ctrl,
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        fileroot=cfg.fileroot,
        model_groups=groups or None,
        model_replicas=replicas or None,
        difficulty_filter=cfg.dataset_filter,
        max_recoveries=cfg.max_recoveries,
        max_consecutive_quarantines=cfg.max_consecutive_quarantines,
        weight_push_checksum=cfg.weight_push_checksum,
        pipeline_overlap=cfg.pipeline_overlap,
        overlap_window=cfg.overlap_window,
        pipeline_chunk_seqs=cfg.pipeline_chunk_seqs,
        rollout_ahead=cfg.rollout_ahead,
        max_head_offpolicyness=cfg.max_head_offpolicyness,
        replay_capacity=cfg.replay_capacity,
        mfc_timeout_s=cfg.mfc_timeout_s,
        worker_heartbeat_s=cfg.worker_heartbeat_s,
    )


def _remote_gen_shard(cfg: PPOMathConfig, actor_gen, actor_if) -> ModelShardSpec:
    """actor_gen as a weightless client of the GenerationServers at
    `cfg.gen_server_url`."""
    from areal_tpu_torch.models.hf import registry as hf

    model_type = "qwen2"
    if cfg.actor.type_ == "random":
        model_cfg = cfg.actor.args["config"]
        model_type = cfg.actor.args.get("model_type", model_type)
    elif cfg.actor.type_ == "hf":
        path = cfg.actor.args["path"]
        model_cfg = hf.load_model_config(path)
        # The pushed checkpoints go through the actor's own family.
        model_type = hf.load_hf_config(path)["model_type"]
    else:
        raise ValueError(f"gen_server_url with actor abstraction {cfg.actor.type_!r}")
    return ModelShardSpec(
        name=actor_gen,
        model=ModelAbstraction("config", {"config": model_cfg}),
        backend=ModelBackendAbstraction("remote_generator", {
            "url": [u.strip() for u in cfg.gen_server_url.split(",") if u.strip()],
            "model_type": model_type,
            "inmem_sync": cfg.inmem_weight_sync,
            "push_mode": "fabric" if cfg.param_push_tree else "disk",
            "push_fanout": cfg.param_push_fanout,
        }),
        interface=actor_if,
    )


def run_experiment(plan: ExperimentPlan, tokenizer=None, device=None):
    """In-process runner: build the workers on `device` (the CUDA card
    unless told otherwise), joined by `InProcTransfer`, and drive the
    master loop to completion.  A trial with recover info on its
    fileroot resumes from it.  Returns (master, per-step stats).  (The
    multi-process runtime is `apps/main.py run_experiment`.)"""
    from areal_tpu_torch.apps.main import make_master
    from areal_tpu_torch.base import tracer
    from areal_tpu_torch.system.master import InProcessPool
    from areal_tpu_torch.system.transfer import InProcTransfer
    from areal_tpu_torch.system.worker import ModelWorker

    if plan.model_groups:
        raise ValueError(
            "a worker group runs one process a member (one card each): run the plan "
            "with the multi-process runtime, apps/main.py run_experiment"
        )
    # One process hosts everything: every span lands in the master's
    # shard (threads are its lanes); the dir is set before any component
    # configures the tracer.
    tracer.default_dir(plan.fileroot, plan.experiment_name, plan.trial_name)
    planes = InProcTransfer.make_group(len(plan.worker_configs))
    workers = [
        ModelWorker(wc, tokenizer=tokenizer, device=device, transfer=planes[i])
        for i, wc in enumerate(plan.worker_configs)
    ]
    master = make_master(plan, InProcessPool(workers, mfc_timeout_s=plan.mfc_timeout_s))
    master.load_recover_info()
    stats = asyncio.run(master.run())
    return master, stats
