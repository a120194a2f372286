"""PyTorch/CUDA port of areal_tpu.

A second package beside `areal_tpu` (the JAX reference, unchanged): same
module layout and function names, so each function here has its
counterpart at the same path in `areal_tpu`.  The port imports `torch`
and nothing of JAX or of `areal_tpu`; entry points run on the CUDA card
unless the caller passes ``device="cpu"``.

Slice 1, the serving path:

    system/gen_server.py  GenerationServer (POST /generate, GET /health)
    engines/generator.py  GeneratorEngine.generate -> the serving plane
    models/transformer.py decode_step_ragged_paged over a paged KV pool
    kernels/ragged_paged_attention.py (CUDA, sm_90a; CPU: plain version)

Slice 2, the GRPO train step:

    interfaces/ppo.py     PPOActorInterface.generate / inference / train_step
    interfaces/reward.py  MultiTaskRewardInterface (math, code, judge grading)
    engines/train.py      TrainEngine.train_batch / forward (AdamW, guard)
    models/transformer.py hidden_states / per_token_output over packed rows
    kernels/flash_attention.py flash_attention (CUDA, sm_90a; CPU: plain version)

Slice 3, the in-memory weight push mid-generation:

    system/gen_server.py  update_weights_inmem, pause/resume (POST /pause, /resume)
    engines/generator.py  interrupt -> park at a chunk boundary -> resume_generate
    models/transformer.py decode_step_spec_paged (the tail replay)
    kernels/paged_chunk_attention.py (CUDA, sm_90a; CPU: plain version)

Slice 4, the static generate path:

    engines/generator.py  generate -> prefill + decode_step over a dense cache
    kernels/decode_attention.py (CUDA, sm_90a; CPU: plain version)

Slices 5-7 redesigned every kernel for Hopper's tensor cores.

Slice 8, the critic and the reference model:

    interfaces/ppo.py     PPOCriticInterface, value-mode PPOActorInterface
    engines/inference.py  InferenceEngine; engines/offload.py host offload
    ops/gae.py            GAE as a log-depth scan; interfaces/value_norm.py

Slice 9, the system's own entry point:

    apps/quickstart.py    python -m areal_tpu_torch.apps.quickstart ppo-math
    experiments/common.py build_ppo_math -> run_experiment
    system/master.py      MasterWorker: the DFG's synchronous step
    system/worker.py      ModelWorker: models, data cache, dataset loader
    models/hf/            HF checkpoint IO (llama, qwen2, mistral, mixtral, gpt2; own safetensors IO)

Slice 10, recovery, the EMA reference model and the difficulty filter:

    base/recover.py       recover checkpoints: manifest, atomic flip, RecoverInfo
    system/master.py      recover saves, restart and restore, quarantine rollback
    system/worker.py      EMA param sync, data cursors, dataset filter
    engines/train.py      TrainEngine.save/load_optimizer_state

Slice 17, asynchronous RL:

    system/master.py      rollout_ahead=1 and the max_head_offpolicyness pipeline
    system/replay.py      ReplayBuffer: staleness-bounded admission
    system/rollout.py     RolloutController over generation servers
    system/gen_server.py  POST /update_weights, RemoteGeneratorEngine
    interfaces/reward_service.py  the verifier registry and its HTTP service

Slice 18, the multi-process runtime:

    apps/main.py          run_experiment: a worker process a WorkerConfig, recover retries
    apps/worker.py        the worker process: control server, transfer plane, stream
    system/stream.py      ConnWorkerPool, run_worker_stream (multiprocessing.connection)
    system/transfer.py    InProcTransfer, ConnTransfer (pickle-5 frames)
    system/worker_control.py  WorkerServer, WorkerControlPanel
    system/master.py      the data and param planes, worker-death recovery
    scheduler/, base/{names,name_resolve,network}.py

Slice 20, the tracer, the verifier fleet and task mixtures:

    base/tracer.py        spans, counters, lineage, the flight ring; shards per process
    apps/trace_report.py  merge, attribution, bubbles, pipeline, lineage, flight views
    system/verifier_pool.py  VerifierWorker, VerifierPool, verifier_discovery
    data/mixture.py       TaskMixtureStream: weighted task streams for the controller

Slice 21, the metrics plane and the SLO fleet supervisor:

    base/metrics.py       the registry, windows, MetricsServer (/metrics), the parser
    apps/metrics_report.py  fleet signals, SLO rules and the watchdog over /metrics
    system/fleet.py       FleetSupervisor and SupervisorLane: spawn and drain on SLO verdicts
    apps/fleet.py         python -m areal_tpu_torch.apps.fleet: the supervisor's CLI
    analysis/costmodel.py compose_step, the master's advisor residual

Slice 23, MoE and the mistral, mixtral and gpt2 families:

    models/transformer.py the router, the dense, topk and grouped dispatches, the aux
    engines/train.py      the aux in the trained loss (moe_aux_loss_coef)
    models/hf/registry.py mistral, mixtral (the experts) and gpt2 (c_attn, Conv1D)
"""
