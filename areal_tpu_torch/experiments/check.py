"""Experiment-config validation, run before any device work (port of
`check_ppo_math` and the checks it calls in areal_tpu/experiments/check.py).

A misconfigured trial fails at build time with a sentence naming the
knob.  Options of `PPOMathConfig` that the port does not have yet fail
the same way, naming the ROADMAP item that brings them, rather than
being ignored.
"""

import os

from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig


def _fail(msg: str):
    raise ValueError(f"invalid experiment config: {msg}")


def check_optimizer(opt: OptimizerConfig) -> None:
    if opt.lr <= 0:
        _fail(f"optimizer.lr must be > 0, got {opt.lr}")
    if not 0.0 <= opt.warmup_steps_proportion <= 1.0:
        _fail(
            "optimizer.warmup_steps_proportion must be in [0, 1], got "
            f"{opt.warmup_steps_proportion}"
        )
    if not 0.0 <= opt.min_lr_ratio <= 1.0:
        _fail(f"optimizer.min_lr_ratio must be in [0, 1], got {opt.min_lr_ratio}")


def check_model_path(role: str, spec) -> None:
    if spec is not None and spec.type_ == "hf":
        path = spec.args.get("path", "")
        if not os.path.exists(path):
            _fail(f"model path {path!r} for {role!r} does not exist locally "
                  "(download the checkpoint first)")


def check_gconfig(g: GenerationHyperparameters) -> None:
    if g.n < 1:
        _fail(f"gconfig.n must be >= 1, got {g.n}")
    if g.max_new_tokens < 1:
        _fail(f"gconfig.max_new_tokens must be >= 1, got {g.max_new_tokens}")
    if g.min_new_tokens > g.max_new_tokens:
        _fail(f"gconfig.min_new_tokens ({g.min_new_tokens}) > max_new_tokens "
              f"({g.max_new_tokens})")
    if not g.greedy and g.temperature <= 0:
        _fail(f"gconfig.temperature must be > 0 when sampling, got {g.temperature}")
    if not 0.0 < g.top_p <= 1.0:
        _fail(f"gconfig.top_p must be in (0, 1], got {g.top_p}")


def unported_options(cfg):
    """(option, ROADMAP item) for each option the config sets that the
    port does not have yet."""
    checks = (
        (cfg.rollout_ahead != 0, "rollout_ahead", "queue 1, item 7"),
        (cfg.max_head_offpolicyness is not None, "max_head_offpolicyness", "queue 1, item 7"),
        (cfg.pipeline_overlap, "pipeline_overlap", "queue 1, item 6"),
        (cfg.gen_server_url is not None, "gen_server_url", "queue 1, item 7"),
        (cfg.inmem_weight_sync, "inmem_weight_sync", "queue 1, item 7"),
        (cfg.param_push_tree, "param_push_tree", "queue 1, item 7"),
        (cfg.fuse_rew_ref, "fuse_rew_ref", "queue 1, item 6"),
        (cfg.verifier_pool, "verifier_pool", "queue 1, item 7"),
        (bool(cfg.mixture_weights) or cfg.mixture_adaptive, "mixture_weights",
         "queue 1, item 7"),
        (bool(cfg.placement), "placement (more than one worker)", "queue 1, items 7 and 8"),
        (cfg.anomaly_kl_max is not None, "anomaly_kl_max", "queue 1, item 6"),
        (bool(cfg.anomaly_grad_norm_mult), "anomaly_grad_norm_mult", "queue 1, item 6"),
        (bool(cfg.anomaly_update_norm_max), "anomaly_update_norm_max", "queue 1, item 6"),
        (cfg.episode_max_turns > 0, "episode_max_turns", "queue 1, item 5.4"),
        ("master_dtype" in cfg.train_backend_args,
         "train_backend_args.master_dtype (the port keeps fp32 masters)", "queue 1, item 6"),
        (cfg.train_backend_args.get("remat_policy") in ("dots", "dots_small"),
         "train_backend_args.remat_policy dots/dots_small", "queue 1, item 6"),
    )
    return [(name, item) for bad, name, item in checks if bad]


def check_ppo_math(cfg) -> None:
    """Cross-field checks for PPOMathConfig."""
    unported = unported_options(cfg)
    if unported:
        raise NotImplementedError("; ".join(
            f"{name} is not yet ported (ROADMAP {item})" for name, item in unported
        ))
    check_optimizer(cfg.optimizer)
    check_gconfig(cfg.gconfig)
    for role, spec in (("actor", cfg.actor), ("ref", cfg.ref), ("critic", cfg.critic)):
        check_model_path(role, spec)
    kw = cfg.ppo_kwargs
    if kw.get("kl_adaptive") and not kw.get("kl_ctl"):
        _fail("kl_adaptive with kl_ctl=0: the multiplicative controller can never "
              "leave 0 — set a nonzero initial kl_ctl")
    if (kw.get("kl_ctl") or kw.get("kl_adaptive")) and cfg.ref is None:
        _fail("KL control (kl_ctl/kl_adaptive) needs a ref model")
    if kw.get("use_dense_reward") and cfg.critic is None:
        _fail("use_dense_reward needs the critic (value) mode")
    for knob in ("early_stop_imp_ratio", "early_stop_kl"):
        v = kw.get(knob)
        if v is not None and v <= 0:
            _fail(f"{knob} must be > 0 (omit it to disable early stopping)")
    gen_size = kw.get("generation_size")
    if gen_size is not None and gen_size < cfg.gconfig.n:
        _fail(f"generation_size ({gen_size}) must be >= group size gconfig.n "
              f"({cfg.gconfig.n})")
    if cfg.kv_page_size < 1:
        _fail(f"kv_page_size must be >= 1, got {cfg.kv_page_size}")
    if cfg.kv_pool_pages < 0:
        _fail(f"kv_pool_pages must be >= 0 (0 = auto-size), got {cfg.kv_pool_pages}")
    if cfg.prefill_chunk_tokens is not None and cfg.prefill_chunk_tokens < 0:
        _fail(f"prefill_chunk_tokens must be >= 0, got {cfg.prefill_chunk_tokens}")
    if cfg.max_recoveries < 0:
        _fail(f"max_recoveries must be >= 0, got {cfg.max_recoveries}")
    if cfg.max_consecutive_quarantines < 0:
        _fail(f"max_consecutive_quarantines must be >= 0 (0 disables rollback "
              f"escalation), got {cfg.max_consecutive_quarantines}")
    if cfg.dataset_filter:
        lo = cfg.dataset_filter.get("min_accuracy", 0.0)
        hi = cfg.dataset_filter.get("max_accuracy", 1.0)
        if not 0.0 <= lo < hi <= 1.0:
            _fail(f"dataset_filter accuracy band [{lo}, {hi}] must satisfy 0 <= min < max <= 1")
