"""Quickstart CLI: `python -m areal_tpu_torch.apps.quickstart {sft,ppo-math} [options]`
(port of areal_tpu/apps/quickstart.py, the in-process `sft` and
`ppo-math` trials).

    python -m areal_tpu_torch.apps.quickstart sft \\
        --model.path /ckpts/qwen2-1.5b --dataset.path sft.jsonl \\
        --tokenizer-path char:151936 --batch-size 8 --save-freq-steps 100
    python -m areal_tpu_torch.apps.quickstart ppo-math \\
        --model.path /ckpts/qwen2-1.5b --dataset.path math.jsonl \\
        --tokenizer-path char:151936 --ref-path /ckpts/qwen2-1.5b --kl-ctl 0.1 \\
        --pipeline-overlap --overlap-window 2 --pipeline-chunk-seqs 2

`--allocation` lays the trainer models over the devices: above d1 each
device is a worker process of its own, one card a process, the ranks
of one `torch.distributed` world (the SPMD worker group), so the trial
runs on the multi-process runtime; `ppo-math`'s generator then runs one
engine a rank over its own prompts.  A model axis above 1 for
`ppo-math`, and `--gen-allocation`, come with item 8.6b.

The flags are the JAX package's, and `--config <yaml>` sets their
defaults from a file (keys spelled as the flags, e.g. `model.path`,
`batch-size`; flags on the command line win).  The trial runs on the
CUDA card: every model on one worker, `build_sft` or `build_ppo_math`
-> `run_experiment` -> the master's steps, in this process, or with
`--multiprocess` with the worker in a process of its own (the local
scheduler; `--recover-retries N` resubmits it after a failure and
resumes from the last recover checkpoint) (with
`--pipeline-overlap`, streamed in chunks; with `--rollout-ahead 1` or
`--max-head-offpolicyness K`, asynchronous; with `--gen-server-url`,
generating on remote servers); the last step's stats are printed as one
JSON line.  With `--ckpt-freq-steps N` the
master writes a recover checkpoint every N steps; rerunning the same
command (the same `--fileroot`, experiment and trial name) resumes the
trial from the last one.  Flags whose features the port does not have
yet exit with a message naming the ROADMAP item that brings them.
"""

import argparse
import json
import logging
import sys

from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.system.master import ExperimentSaveEvalControl

logger = logging.getLogger("areal_tpu_torch.quickstart")

# Flags of the JAX CLI whose features are not yet ported: any value but
# the flag's default exits, naming the item (ROADMAP queue 1).
_UNPORTED_FLAGS = {
    "chip": "item 10 (the allocation search)",
    "search_devices": "item 10 (the allocation search)",
    "launcher": "item 10 (scheduler/)",
    "tpu_name": "item 10 (scheduler/)",
    "tpu_zone": "item 10 (scheduler/)",
    "tpu_project": "item 10 (scheduler/)",
    "tpu_num_hosts": "item 10 (scheduler/)",
    "eval_data": "item 10 (scheduler/evaluator.py)",
    "eval_max_new_tokens": "item 10 (scheduler/evaluator.py)",
    "eval_protocol": "item 10 (scheduler/evaluator.py)",
    # ppo-math
    "gen_allocation": "item 8.6b (generation on a sharded layout)",
}


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", default=None,
                   help="YAML file of option defaults (keys = flag names, e.g. 'model.path:'); "
                        "flags on the command line override it")
    p.add_argument("--model.path", dest="model_path", required=True, help="HF checkpoint dir")
    p.add_argument("--dataset.path", dest="dataset_path", required=True,
                   help="jsonl dataset path")
    p.add_argument("--allocation", default="d1",
                   help="parallel layout of the trainer models, e.g. d4, f4, d2m2 (sft): "
                        "above d1, one worker process a card (the SPMD worker group, the "
                        "multi-process runtime)")
    p.add_argument("--chip", default="v5e", help="not yet ported")
    p.add_argument("--search-devices", type=int, default=None, help="not yet ported")
    p.add_argument("--tokenizer-path", default=None,
                   help="tokenizer dir (default: model path); 'char:<n>' loads the hermetic "
                        "byte-level tokenizer")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max-tokens-per-mb", type=int, default=16384)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--trial-name", default="trial0")
    p.add_argument("--fileroot", default="/tmp/areal_tpu_torch")
    p.add_argument("--save-freq-steps", type=int, default=None)
    p.add_argument("--ckpt-freq-steps", type=int, default=None,
                   help="write a recover checkpoint every N steps; rerunning the same "
                        "command resumes from the last one")
    p.add_argument("--benchmark-steps", type=int, default=None)
    p.add_argument("--launcher", default="local", choices=("local", "slurm", "tpu-pod"),
                   help="only 'local' is ported")
    p.add_argument("--tpu-name", default=None, help="not yet ported")
    p.add_argument("--tpu-zone", default=None, help="not yet ported")
    p.add_argument("--tpu-project", default=None, help="not yet ported")
    p.add_argument("--tpu-num-hosts", type=int, default=1, help="not yet ported")
    p.add_argument("--multiprocess", action="store_true",
                   help="run each worker in a process of its own (the local scheduler), the "
                        "master in this one")
    p.add_argument("--recover-retries", type=int, default=0,
                   help="with --multiprocess: attempts after a failed one, each resubmitting "
                        "every worker and resuming from the last recover checkpoint")
    p.add_argument("--mfc-timeout-s", type=float, default=None,
                   help="deadline of each request to a worker; past it a worker that stopped "
                        "heartbeating is declared dead and the master recovers")
    p.add_argument("--worker-heartbeat-s", type=float, default=5.0,
                   help="with --multiprocess: the workers' heartbeat period")
    p.add_argument("--max-recoveries", type=int, default=3,
                   help="rollbacks to the recover checkpoint the master absorbs before "
                        "exiting non-zero")
    p.add_argument("--anomaly-grad-norm-mult", type=float, default=0.0,
                   help="quarantine a train step whose grad norm exceeds this multiple of "
                        "the engine's running EWMA (must be > 1; 0 = off; non-finite "
                        "loss/grads always quarantine)")
    p.add_argument("--anomaly-update-norm-max", type=float, default=0.0,
                   help="quarantine a train step whose optimizer update norm exceeds this "
                        "ceiling (0 = off)")
    p.add_argument("--max-consecutive-quarantines", type=int, default=3,
                   help="consecutive quarantined steps before the master rolls back to the "
                        "last recover checkpoint (0 = never)")
    p.add_argument("--no-weight-push-checksum", action="store_true",
                   help="ship cross-worker weight pushes without their content checksum "
                        "(the receiver then swaps without verifying)")
    p.add_argument("--eval-data", default=None, help="not yet ported")
    p.add_argument("--eval-max-new-tokens", type=int, default=256, help="not yet ported")
    p.add_argument("--eval-protocol", default="greedy", help="not yet ported")


def _add_ppo_math(pp: argparse.ArgumentParser):
    pp.add_argument("--group-size", type=int, default=4)
    pp.add_argument("--max-new-tokens", type=int, default=1024)
    pp.add_argument("--temperature", type=float, default=1.0)
    pp.add_argument("--gen-allocation", default=None, help="not yet ported")
    pp.add_argument("--gen-server-url", default=None,
                    help="comma-separated http:// URLs of generation servers (decoupled "
                         "generation; the weights reach them from disk each step)")
    pp.add_argument("--ref-path", default=None,
                    help="reference policy checkpoint (enables KL control)")
    pp.add_argument("--kl-ctl", type=float, default=0.0)
    pp.add_argument("--kl-adaptive", action="store_true",
                    help="adapt the KL coefficient toward --adaptive-kl-target")
    pp.add_argument("--adaptive-kl-target", type=float, default=6.0)
    pp.add_argument("--adaptive-kl-horizon", type=float, default=10000.0)
    pp.add_argument("--generation-size", type=int, default=None,
                    help="best-of-k: sample this many responses per prompt, train on "
                         "the top --group-size by reward")
    pp.add_argument("--early-stop-imp-ratio", type=float, default=None)
    pp.add_argument("--early-stop-kl", type=float, default=None)
    pp.add_argument("--ref-ema-eta", type=float, default=None,
                    help="EMA-update the ref toward the actor each step")
    pp.add_argument("--kv-cache-dtype", default="auto", choices=("auto", "int8"),
                    help="int8: the inflight paths' KV cache in int8 (the static path "
                         "ignores it, as the JAX package's does)")
    pp.add_argument("--no-paged-kv", action="store_true",
                    help="the dense inflight KV window instead of the paged pool")
    pp.add_argument("--kv-page-size", type=int, default=128,
                    help="tokens per KV page in the serving plane's pool")
    pp.add_argument("--kv-pool-pages", type=int, default=0,
                    help="serving plane's KV pool in pages (0 = auto-size)")
    pp.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="serving plane: prompt tokens per row per inner step (0: the "
                         "two-program admit path, a prefill program then decode chunks)")
    pp.add_argument("--no-kv-share-prefix", action="store_true",
                    help="no copy-on-write prompt page sharing across a group")
    pp.add_argument("--master-dtype", default=None, choices=(None, "float32", "bfloat16"),
                    help="optimizer master/Adam dtype; bfloat16 halves the optimizer's "
                         "memory")
    pp.add_argument("--remat", default=None, choices=(None, "full", "dots_small", "dots", "none"),
                    help="activation rematerialization policy for training")
    pp.add_argument("--fuse-rew-ref", action="store_true",
                    help="one fused MFC for reward grading + ref inference (needs --ref-path)")
    pp.add_argument("--offload-ref", action="store_true",
                    help="host-offload the ref params between steps")
    pp.add_argument("--spec-decode-k", type=int, default=0,
                    help="speculative decoding: n-gram drafts per step (0 = off)")
    pp.add_argument("--rollout-ahead", type=int, default=0, choices=(0, 1),
                    help="1: generate the next step's rollouts while this step trains")
    pp.add_argument("--max-head-offpolicyness", type=int, default=None,
                    help="asynchronous RL: admit rollouts at most this many versions stale "
                         "through a replay buffer (0 = the synchronous ordering)")
    pp.add_argument("--replay-capacity", type=int, default=4,
                    help="the replay buffer's capacity in batches")
    pp.add_argument("--inmem-weight-sync", action="store_true",
                    help="pause the generation servers at a chunk boundary around each "
                         "weight push")
    pp.add_argument("--param-push-tree", action="store_true",
                    help="with --gen-server-url: publish each weight version once and push it "
                         "down a broadcast tree of the servers (each relays, then swaps in "
                         "place) instead of through a checkpoint on disk")
    pp.add_argument("--param-push-fanout", type=int, default=2,
                    help="children a node of the broadcast tree relays to")
    pp.add_argument("--pipeline-overlap", action="store_true",
                    help="stream each step through the graph in chunks of prompts")
    pp.add_argument("--overlap-window", type=int, default=2,
                    help="chunks in flight (1 = the barrier path, bit for bit)")
    pp.add_argument("--pipeline-chunk-seqs", type=int, default=1, help="prompts a chunk")
    pp.add_argument("--anomaly-kl-max", type=float, default=None,
                    help="quarantine a batch whose mean |logp - ref logp| over response "
                         "tokens exceeds this")
    pp.add_argument("--episode-max-turns", type=int, default=0,
                    help="agent episodes: max assistant turns (carried to the config; the "
                         "in-process trial runs single-shot rollouts, as the JAX CLI does)")
    pp.add_argument("--episode-token-budget", type=int, default=0,
                    help="agent episodes: transcript token cap per episode (0 = engine default)")
    pp.add_argument("--tool-timeout-s", type=float, default=10.0,
                    help="agent episodes: wall-clock bound on each tool call")
    pp.add_argument("--reward-backend", default="",
                    help="force one reward backend (only 'math' grading is ported)")
    pp.add_argument("--verifier-pool", action="store_true",
                    help="grade through the trial's announced verifier fleet "
                         "(python -m areal_tpu_torch.apps.verifier) instead of in-process")
    pp.add_argument("--mixture-weight", action="append", default=[], metavar="TASK=WEIGHT",
                    help="task-mixture curriculum weight, e.g. 'math=3' 'code=1'; repeatable")
    pp.add_argument("--mixture-adaptive", action="store_true",
                    help="upweight tasks whose reward EMA is below their watermark")


def _parse_mixture_weights(specs):
    """'task=weight' pairs -> {task: float} for PPOMathConfig."""
    weights = {}
    for spec in specs:
        task, sep, w = spec.partition("=")
        if not sep or not task:
            raise SystemExit(f"--mixture-weight wants TASK=WEIGHT, got {spec!r}")
        try:
            weights[task] = float(w)
        except ValueError:
            raise SystemExit(f"--mixture-weight {spec!r}: weight must be a number")
    return weights


def _refuse_unported(defaults, args) -> None:
    """Exit, naming the ROADMAP item, on a flag whose feature is not yet
    ported: any value but the flag's own default (`defaults`, taken
    before a YAML file replaces them) exits."""
    for dest, item in _UNPORTED_FLAGS.items():
        if hasattr(args, dest) and getattr(args, dest) != defaults.get(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported (ROADMAP queue 1, {item})")
    if args.allocation == "search":
        raise SystemExit("--allocation search is not yet ported "
                         "(ROADMAP queue 1, item 10: the allocation search)")
    for url in (args.__dict__.get("gen_server_url") or "").split(","):
        if url.strip() and not url.strip().startswith(("http://", "https://")):
            raise SystemExit(f"--gen-server-url {url.strip()}: only http:// is ported "
                             "(ROADMAP queue 1, item 7.8: the ZMQ transport)")
    if args.exp == "ppo-math" and _layout(args).model > 1:
        raise SystemExit(f"--allocation {args.allocation}: a model axis above 1 for ppo-math "
                         "is not yet ported (ROADMAP queue 1, item 8.6b: generation on a "
                         "sharded layout)")


def _layout(args):
    from areal_tpu_torch.base.topology import ParallelConfig

    try:
        return ParallelConfig.from_str(args.allocation)
    except ValueError as e:
        raise SystemExit(f"--allocation {args.allocation}: {e}")


def _apply_yaml_config(parser: argparse.ArgumentParser, argv):
    """Pre-read --config <yaml> and install its values as the parser's
    defaults (flags on the command line still win).  YAML keys use the
    flag spelling ('model.path', 'batch-size') or the python dest
    ('model_path')."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    known, _ = pre.parse_known_args(argv)
    if not known.config:
        return
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(
            f"--config {known.config}: reading a YAML option file needs the PyYAML "
            "package (`yaml`), which is not installed; pass the options as flags"
        ) from e
    with open(known.config) as f:
        raw = yaml.safe_load(f) or {}
    dests = {a.dest for a in parser._actions}
    mapped = {}
    for key, val in raw.items():
        dest = key.replace("-", "_")
        if dest not in dests:
            dest = key.replace(".", "_").replace("-", "_")
        if dest not in dests:
            raise SystemExit(f"--config: unknown option {key!r}")
        mapped[dest] = val
    parser.set_defaults(**mapped)
    # Values from the file satisfy required flags.
    for a in parser._actions:
        if a.dest in mapped and a.required:
            a.required = False


def _ctrl(args) -> ExperimentSaveEvalControl:
    return ExperimentSaveEvalControl(
        total_train_epochs=args.epochs,
        save_freq_steps=args.save_freq_steps,
        ckpt_freq_steps=args.ckpt_freq_steps,
        benchmark_steps=args.benchmark_steps,
    )


def _run(plan, args, device):
    from areal_tpu_torch.apps import main as runner

    for wc in plan.worker_configs:
        wc.tokenizer_path = args.tokenizer_path or args.model_path
    if args.multiprocess or plan.model_groups:
        stats = runner.run_experiment(plan, recover_retries=args.recover_retries, device=device)
    else:
        stats = runner.run_experiment_inproc(plan, device=device)
    print(json.dumps(stats[-1] if stats else {}), flush=True)
    return stats


def cmd_sft(args, device=None):
    cfg = exps.SFTConfig(
        model=ModelAbstraction("hf", {"path": args.model_path}),
        dataset=DatasetAbstraction(
            "prompt_answer", {"dataset_path": args.dataset_path, "max_length": args.max_seqlen}
        ),
        n_hosts=_layout(args).world_size,
        parallel=_layout(args),
        optimizer=OptimizerConfig(lr=args.lr),
        batch_size=args.batch_size,
        total_train_epochs=args.epochs,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=args.max_tokens_per_mb),
        ctrl=_ctrl(args),
        seed=args.seed,
        experiment_name=args.experiment_name or "sft",
        trial_name=args.trial_name,
        fileroot=args.fileroot,
        mfc_timeout_s=args.mfc_timeout_s,
        worker_heartbeat_s=args.worker_heartbeat_s,
        max_recoveries=args.max_recoveries,
        anomaly_grad_norm_mult=args.anomaly_grad_norm_mult,
        anomaly_update_norm_max=args.anomaly_update_norm_max,
        max_consecutive_quarantines=args.max_consecutive_quarantines,
        weight_push_checksum=not args.no_weight_push_checksum,
    )
    return _run(exps.build_sft(cfg), args, device)


def cmd_ppo_math(args, device=None):
    ppo_kwargs = {}
    if args.kl_ctl:
        if not args.ref_path:
            raise SystemExit("--kl-ctl needs --ref-path: the KL penalty is computed "
                             "against a reference policy's logprobs")
        ppo_kwargs["kl_ctl"] = args.kl_ctl
    if args.kl_adaptive:
        if not args.kl_ctl:
            raise SystemExit("--kl-adaptive needs a nonzero --kl-ctl as the initial "
                             "coefficient")
        ppo_kwargs["kl_adaptive"] = True
        ppo_kwargs["adaptive_kl_target"] = args.adaptive_kl_target
        ppo_kwargs["adaptive_kl_horizon"] = args.adaptive_kl_horizon
    if args.generation_size is not None:
        ppo_kwargs["generation_size"] = args.generation_size
    if args.early_stop_imp_ratio is not None:
        ppo_kwargs["early_stop_imp_ratio"] = args.early_stop_imp_ratio
    if args.early_stop_kl is not None:
        ppo_kwargs["early_stop_kl"] = args.early_stop_kl
    cfg = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": args.model_path}),
        ref=ModelAbstraction("hf", {"path": args.ref_path}) if args.ref_path else None,
        ppo_kwargs=ppo_kwargs,
        ref_ema_eta=args.ref_ema_eta,
        offload_ref=args.offload_ref,
        gen_backend_args=(
            {"kv_cache_dtype": args.kv_cache_dtype} if args.kv_cache_dtype != "auto" else {}
        ),
        kv_paged=False if args.no_paged_kv else None,
        kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        kv_share_prefix=False if args.no_kv_share_prefix else None,
        train_backend_args={
            k: v for k, v in (("master_dtype", args.master_dtype), ("remat_policy", args.remat))
            if v is not None
        },
        fuse_rew_ref=args.fuse_rew_ref,
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": args.dataset_path}),
        actor_parallel=_layout(args),
        optimizer=OptimizerConfig(lr=args.lr),
        gconfig=GenerationHyperparameters(
            n=args.group_size, max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, spec_decode_k=args.spec_decode_k,
        ),
        reward_backend=args.reward_backend,
        verifier_pool=args.verifier_pool,
        mixture_weights=_parse_mixture_weights(args.mixture_weight),
        mixture_adaptive=args.mixture_adaptive,
        batch_size=args.batch_size,
        total_train_epochs=args.epochs,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=args.max_tokens_per_mb),
        ctrl=_ctrl(args),
        seed=args.seed,
        experiment_name=args.experiment_name or "ppo-math",
        trial_name=args.trial_name,
        fileroot=args.fileroot,
        mfc_timeout_s=args.mfc_timeout_s,
        worker_heartbeat_s=args.worker_heartbeat_s,
        max_recoveries=args.max_recoveries,
        max_consecutive_quarantines=args.max_consecutive_quarantines,
        pipeline_overlap=args.pipeline_overlap,
        overlap_window=args.overlap_window,
        pipeline_chunk_seqs=args.pipeline_chunk_seqs,
        anomaly_grad_norm_mult=args.anomaly_grad_norm_mult,
        anomaly_update_norm_max=args.anomaly_update_norm_max,
        anomaly_kl_max=args.anomaly_kl_max,
        episode_max_turns=args.episode_max_turns,
        episode_token_budget=args.episode_token_budget,
        tool_timeout_s=args.tool_timeout_s,
        rollout_ahead=args.rollout_ahead,
        max_head_offpolicyness=args.max_head_offpolicyness,
        replay_capacity=args.replay_capacity,
        gen_server_url=args.gen_server_url,
        inmem_weight_sync=args.inmem_weight_sync,
        param_push_tree=args.param_push_tree,
        param_push_fanout=args.param_push_fanout,
        weight_push_checksum=not args.no_weight_push_checksum,
    )
    return _run(exps.build_ppo_math(cfg), args, device)


def main(argv=None, device=None):
    """Parse `argv` and run the experiment on `device` (the CUDA card
    unless told otherwise).  Returns the per-step stats."""
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.quickstart")
    sub = p.add_subparsers(dest="exp", required=True)
    ps = sub.add_parser("sft", help="supervised fine-tuning")
    _add_common(ps)
    ps.add_argument("--max-seqlen", type=int, default=4096)
    ps.set_defaults(fn=cmd_sft)
    pp = sub.add_parser("ppo-math", help="PPO/GRPO with verified math rewards")
    _add_common(pp)
    _add_ppo_math(pp)
    pp.set_defaults(fn=cmd_ppo_math)
    # YAML defaults on whichever subcommand was chosen.
    raw_argv = list(argv if argv is not None else sys.argv[1:])
    defaults = {}
    if raw_argv and raw_argv[0] in ("sft", "ppo-math"):
        sub_parser = {"sft": ps, "ppo-math": pp}[raw_argv[0]]
        defaults = {a.dest: a.default for a in sub_parser._actions}
        _apply_yaml_config(sub_parser, raw_argv[1:])
    args = p.parse_args(argv)
    _refuse_unported(defaults, args)
    return args.fn(args, device=device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
