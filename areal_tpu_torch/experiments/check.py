"""Experiment-config validation, run before any device work (port of
`check_sft`, `check_ppo_math` and the checks they call in
areal_tpu/experiments/check.py).

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
    urls = [u.strip() for u in (cfg.gen_server_url or "").split(",") if u.strip()]
    group = cfg.actor_parallel.world_size > 1
    item_86b = "queue 1, item 8.6b (generation on a sharded layout)"
    checks = (
        (any(not u.startswith(("http://", "https://")) for u in urls),
         "gen_server_url other than http:// (the ZMQ transport)", "queue 1, item 7.8"),
        (cfg.gen_parallel is not None, "gen_parallel (a generator layout of its own)", item_86b),
        (cfg.actor_parallel.model > 1,
         f"actor_parallel {cfg.actor_parallel.to_str()} (a model axis above 1: the "
         "generator would run tensor-parallel)", item_86b),
        (group and bool(urls),
         "gen_server_url with a worker group (actor_parallel above one device)", item_86b),
    )
    return [(name, item) for bad, name, item in checks if bad]


def check_layout(name: str, parallel, n_processes: int) -> None:
    """A layout the worker group can run: one process a card, so a mesh
    spans exactly the group's processes; pipe and seq come with item
    8.5."""
    from areal_tpu_torch.base.topology import check_ported

    check_ported(parallel)
    if parallel.world_size not in (1, n_processes):
        _fail(f"{name} {parallel.to_str()} spans {parallel.world_size} devices, but the "
              f"worker group has {n_processes} processes (one card a process)")


def check_liveness(cfg) -> None:
    """The multi-process runtime's liveness knobs: a deadline inside the
    heartbeat's grace would declare live workers dead at their first slow
    MFC."""
    timeout = getattr(cfg, "mfc_timeout_s", None)
    beat = getattr(cfg, "worker_heartbeat_s", 5.0)
    if beat <= 0:
        _fail(f"worker_heartbeat_s must be > 0, got {beat}")
    if timeout is not None:
        if timeout <= 0:
            _fail(f"mfc_timeout_s must be > 0 (omit it for no deadline), got {timeout}")
        if timeout <= beat:
            _fail(f"mfc_timeout_s ({timeout}) must exceed worker_heartbeat_s ({beat}): at "
                  "least one beat must fit inside the deadline to tell slow from dead")
    if getattr(cfg, "max_recoveries", 3) < 0:
        _fail(f"max_recoveries must be >= 0, got {getattr(cfg, 'max_recoveries', 3)}")


def check_anomaly(cfg) -> None:
    """The sentinels' knobs (engines/train.py, interfaces/ppo.py) and the
    master's quarantine escalation."""
    mult = getattr(cfg, "anomaly_grad_norm_mult", 0.0)
    if mult < 0:
        _fail(f"anomaly_grad_norm_mult must be >= 0 (0 disables the grad-spike sentinel), "
              f"got {mult}")
    if 0.0 < mult <= 1.0:
        # A multiplier at or below the running mean would quarantine
        # routine steps.
        _fail(f"anomaly_grad_norm_mult must be > 1 when enabled (it multiplies the running "
              f"grad-norm EWMA), got {mult}")
    unorm = getattr(cfg, "anomaly_update_norm_max", 0.0)
    if unorm < 0:
        _fail(f"anomaly_update_norm_max must be >= 0 (0 disables the update-norm ceiling), "
              f"got {unorm}")
    kl_max = getattr(cfg, "anomaly_kl_max", None)
    if kl_max is not None and kl_max <= 0:
        _fail(f"anomaly_kl_max must be > 0 (omit it to disable the KL sentinel), got {kl_max}")
    mcq = getattr(cfg, "max_consecutive_quarantines", 3)
    if mcq < 0:
        _fail(f"max_consecutive_quarantines must be >= 0 (0 disables rollback escalation), "
              f"got {mcq}")


def check_sft(cfg) -> None:
    """Checks for SFTConfig."""
    check_optimizer(cfg.optimizer)
    check_liveness(cfg)
    check_anomaly(cfg)
    check_model_path("model", cfg.model)
    if cfg.n_hosts < 1:
        _fail(f"n_hosts must be >= 1, got {cfg.n_hosts}")
    check_layout("parallel", cfg.parallel, cfg.n_hosts)


def check_ppo_math(cfg) -> None:
    """Cross-field checks for PPOMathConfig."""
    unported = unported_options(cfg)
    if unported:
        raise NotImplementedError("; ".join(
            f"{name} is not yet ported (ROADMAP {item})" for name, item in unported
        ))
    check_optimizer(cfg.optimizer)
    check_gconfig(cfg.gconfig)
    check_liveness(cfg)
    check_anomaly(cfg)
    if cfg.rollout_ahead not in (0, 1):
        _fail(f"rollout_ahead must be 0 or 1, got {cfg.rollout_ahead}")
    mho = cfg.max_head_offpolicyness
    if mho is not None:
        if mho < 0:
            _fail(f"max_head_offpolicyness must be >= 0, got {mho}")
        if cfg.rollout_ahead > 0:
            # Both claim the prefetch pipeline; the replay path subsumes
            # rollout_ahead=1.
            _fail("max_head_offpolicyness and rollout_ahead are mutually exclusive "
                  "(async RL replaces the one-step-ahead path)")
    if cfg.replay_capacity < 1:
        _fail(f"replay_capacity must be >= 1, got {cfg.replay_capacity}")
    mw = cfg.mixture_weights or {}
    for task, w in mw.items():
        if not isinstance(w, (int, float)) or w <= 0:
            _fail(f"mixture_weights[{task!r}] must be a positive number (got {w!r}); "
                  "zero-weight tasks should be omitted")
    if cfg.mixture_adaptive and not mw:
        _fail("mixture_adaptive needs mixture_weights (the adaptive scheduler rebalances "
              "an explicit task mixture)")
    if cfg.verifier_pool and not (cfg.experiment_name and cfg.trial_name):
        _fail("verifier_pool needs experiment_name and trial_name to discover the announced "
              "verifier fleet")
    if cfg.pipeline_overlap:
        if cfg.rollout_ahead > 0 or mho is not None:
            _fail("pipeline_overlap is mutually exclusive with rollout_ahead / "
                  "max_head_offpolicyness: those overlap generation ACROSS steps, pipeline "
                  "overlap streams chunks WITHIN one on-policy step")
        if cfg.overlap_window < 1:
            _fail(f"overlap_window must be >= 1, got {cfg.overlap_window}")
        if cfg.pipeline_chunk_seqs < 1:
            _fail(f"pipeline_chunk_seqs must be >= 1, got {cfg.pipeline_chunk_seqs}")
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
    if cfg.param_push_fanout < 1:
        _fail(f"param_push_fanout must be >= 1, got {cfg.param_push_fanout}")
    if cfg.param_push_tree and not cfg.gen_server_url:
        # The fabric fans out over the remote servers; the in-process
        # engine swaps its weights directly.
        _fail("param_push_tree requires gen_server_url (the broadcast fabric distributes over "
              "the remote serving fleet; the in-process engine swaps weights directly)")
    if cfg.gen_server_url and (
        cfg.gen_backend_args or cfg.kv_paged is not None or cfg.kv_page_size != 128
        or cfg.kv_pool_pages or cfg.prefill_chunk_tokens is not None
        or cfg.kv_share_prefix is not None
    ):
        # These configure the in-process GeneratorEngine, which remote
        # generation never builds: a silently ignored knob is a trap.
        _fail("gen_backend_args/kv_paged/kv_page_size/kv_pool_pages/prefill_chunk_tokens/"
              "kv_share_prefix apply to the in-process GeneratorEngine and are ignored "
              "under gen_server_url (configure the generation server instead)")
    for role, where in cfg.placement.items():
        ws = where if isinstance(where, list) else [where]
        if not ws or any(not isinstance(w, int) or isinstance(w, bool) or w < 0 for w in ws):
            _fail(f"placement[{role!r}] must be a worker index or a list of them (replicas), "
                  f"got {where!r}")
        if len(set(ws)) != len(ws):
            _fail(f"placement[{role!r}] names a worker twice: {where!r}")
    world = cfg.actor_parallel.world_size
    for name, par in (("actor_parallel", cfg.actor_parallel),
                      ("ref_parallel", cfg.ref_parallel or cfg.actor_parallel),
                      ("critic_parallel", cfg.critic_parallel)):
        check_layout(name, par, world)
    if world > 1 and cfg.placement:
        _fail("placement with a worker group (actor_parallel above one device): the group's "
              "layout places the models")
    if cfg.dataset_filter:
        lo = cfg.dataset_filter.get("min_accuracy", 0.0)
        hi = cfg.dataset_filter.get("max_accuracy", 1.0)
        if not 0.0 <= lo < hi <= 1.0:
            _fail(f"dataset_filter accuracy band [{lo}, {hi}] must satisfy 0 <= min < max <= 1")
