#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`areal_tpu_torch`) once on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,flash,...]

Phases (all by default, in this order; any failed check exits non-zero
and prints no result):

build        — build every CUDA kernel from the sources in this checkout
               (nvcc, sm_90a, one process per source, all at once) and
               print the card's name and power limit.
kernel       — the ragged paged attention kernel (K2) against its plain
               PyTorch version and its split reference at qwen2-1.5B's
               attention shape over a 96-lane serving stream (fp32, bf16,
               int8 pools; dead lanes exactly 0; a poisoned last pool page
               changes nothing), over windows at its span's edges +-1 and
               over a one-span table; one call under
               torch.cuda.set_sync_debug_mode("error"); its time beside
               the plain version, one library call and the card's bound
               (device time from CUDA-graph replays, and the eager call's
               time with its host work).  Then the paged chunk attention
               kernel (K3) at the resume replay's shape (64 slots of 32 queries,
               windows 64-640, ragged q_lens with some 0) and on edge slots
               (Q=13 and Q=1; windows ending at tile and page edges and
               past the table; a ragged and an all-dead slot): fp32, bf16
               and int8 pools, each output row within a tolerance of its
               own magnitude of its plain version and of its tiled model,
               dead queries exactly 0, a poisoned last pool page changing
               nothing; one call under the sync debug mode; and its times
               (device and eager, as for K2).  Then the dense
               decode attention kernel (K4) at the static path's decode
               shape (32 rows of S=1024, prompts 64-512 right-aligned at
               512, window to 576), a Q=4 chunk, a 1280 window, rows
               with empty windows, windows at its span's edges +-1 and a
               one-span cache: fp32, bf16 and int8 caches, each output
               row within a tolerance of its own magnitude of its plain
               version and of its split reference, empty windows exactly
               0, poisoned positions outside every window changing
               nothing; one call under the sync debug mode; and its times
               at 32 rows and at the static phase's 64.  Then the forms
               the generator's other inflight modes run: K3's Q=1 entry
               point (the two-program path's decode step, which runs K2's
               kernel; 16 and 64 slots, windows 64-640, fp32/bf16/int8
               pools and bf16 q over int8, equal to K2's wrapper and held
               against the plain paged_decode_attention), K4 at Q=1 and
               Q=5 with bf16 q over an int8 cache and at Q=5 in bf16
               (dense spec, K=4), 16 rows of a 1024 window; each with one
               call under the sync debug mode and its times beside the
               plain version, SDPA and the bound.  bf16 q over an int8
               cache or pool (the tensor-core int8 path of K2 and K4) is
               held in every K2 and K4 case against the plain version
               and, within MODEL_TOL, its split reference.
flash        — the flash attention kernels (K1f forward, K1dq and K1dkv
               backward) against the plain version and its autograd on
               fp32 copies of the same inputs, at qwen2-1.5B's attention
               shape over rows of S=2048 packed with segments of 64-640
               tokens and one all-padding row, fp32 and bf16 (each output
               row within a tolerance of its own magnitude; padding
               outputs and grads exactly 0), and in bf16 against the
               kernels' models (o and lse: the online softmax with P in
               bf16; dq: dS as a bf16 hi + lo pair; dk, dv: P and dS in
               bf16); all three also at their edges (S=256 rows of
               segments of 1-129 tokens, rep 6 and 1, causal and not; an
               S=40 row; D=64), lse against the dense logsumexp; one call
               of each under the sync debug mode; and their times
               (device and eager) beside the plain version, SDPA with the
               packed mask and the card's bound.
serve        — the serving path at full qwen2-1.5B size (28 layers, bf16,
               random weights from --seed): GenerationServer over
               GeneratorEngine answers 16 concurrent /generate requests
               (n=4 groups, 128 new tokens); replies and engine counters
               are checked, and K2's launch count must equal 28 x the
               inner steps the engine ran.  The engine's
               static_path_max_new is 0, so by the JAX package's own rule
               every call takes the serving plane (as in push and
               resume_parity).
static       — the static generate path at full qwen2-1.5B: the same
               burst (64 requests) through GenerationServer over a
               default engine, which takes the static path (prefill with
               K1f, then one decode_step with K4 per token); replies are
               checked, K1f launches = 28 x static chunks, K4 launches =
               28 x decode steps, K2 launches 0; tokens/s, the prefill
               and decode step times, peak memory and a profiled call's
               K4 and idle shares are printed.
train        — two GRPO steps at full qwen2-1.5B (fp32 masters, bf16
               compute, remat "full"): PPOActorInterface.generate (the
               static path: K1f prefill, K4 decode) ->
               MultiTaskRewardInterface -> PPOActorInterface.train_step
               (K1f, K1dq, K1dkv), 8 prompts x n=4, 128 new tokens, the
               generator taking the trained weights after step 1; the
               importance ratio and approx-KL, grad_norm and the K1 launch
               counts are checked, and one train_step is profiled.  Before
               the first update, PPOActorInterface.inference recomputes the
               rollout's logprobs (each response token held against the
               generator's), and K1f/K1dq/K1dkv are held against the plain
               version on layer 0's q/k/v at the step's packed [B, S].
ppo          — two full PPO steps of ppo-math at qwen2-1.5B with all four
               models: the actor (TrainEngine + GeneratorEngine), a critic
               (TrainEngine on the value head, value norm "exp") and a
               reference model (InferenceEngine on the actor's initial
               weights, offloaded to host memory after each call);
               kl_ctl 0.1.  Each step: generate (static path) -> reward
               (seeded +-5) -> ref_inf (K1f) -> critic_inf (K1f) -> actor
               train_step -> critic train_step (K1f, K1dq, K1dkv) -> the
               generator takes the actor's weights.  Step 1: each
               response token's ref logprob within 0.125 of the
               generator's and their mean within 1e-2, importance ratio
               and approx-KL as in train, value_loss finite, the critic's
               grad_norm > 0.  Step 2: step 1's sample through the ref
               after its offload round trips gives step 1's logprobs bit
               for bit, and the ref is farther from the behaviour policy
               than at step 1.  K1 launches per model call = 28 x its
               micro-batches (x (2, 1, 1) for a train step); each call's
               seconds, peak memory and the value-norm moments printed.
sharded      — the trainer over a device mesh at qwen2-1.5B's width
               (CUT_LAYERS layers, bf16): a real NCCL world of one rank
               and a one-rank DeviceMesh (the card is one GPU; NCCL
               takes no two ranks on one).  (a) The actor and the critic
               as DTensors placed by the sharding rules take two PPO
               train steps through PPOActorInterface / PPOCriticInterface
               beside unsharded engines from the same weights on the same
               batch: loss and grad norm within SHARDED_STAT_RTOL, the
               params after both steps within SHARDED_PARAM_ATOL (and
               whether bit for bit), every leaf placed by its rule, and
               masked_moments through NCCL against numpy.  (b)
               flash_attention_sharded's per-rank body for a model axis
               of 2 (6q/1kv heads a rank): one launch of K1f, K1dq and
               K1dkv a head shard, the shards concatenated against K1
               over all heads and the plain version, and the two shards'
               forward times.  (c) K1's launches: n_layers x (2, 1, 1) a
               train call in (a), 2 of each form in (b).
quickstart   — the system's own entry point at qwen2-1.5B: a seeded random
               checkpoint written by the port's save_hf_checkpoint (fp32,
               two shards and an index; free disk checked first), 64 math
               rows written here, then `quickstart.main(["ppo-math", ...])`
               in this process with a ref model from the same checkpoint,
               kl_ctl 0.1, 8 prompts x 4 responses, 128 new tokens, two
               steps and a save at step 2 (rewards replaced by seeded +-5).
               The master runs the DFG: generate (static path) -> reward
               and ref_inf -> actor train_step -> the generator's weight
               sync.  Checked: three checkpoint loads; step 1's first
               minibatch importance ratio and approx-KL and the ref's
               logprobs against the behaviour policy's (the three loads
               hold one set of weights); finite stats; the launches of
               each step equal to 28 x the engines' calls of each MFC in
               the DFG (K2, K3 0); the saved checkpoint's keys, shapes and
               fp32; a non-zero update within AdamW's bound.  Step and
               per-MFC seconds, MFU, peak and resident memory, checkpoint
               write, load and save seconds are printed.
sft          — `quickstart.main(["sft", ...])` at qwen2-1.5B from the
               quickstart's seeded random checkpoint (written once, shared
               with quickstart and overlap): 64 prompt/answer rows written
               here, batch 8, two steps and a save at step 2; then
               SFTInterface.evaluate on the trained model over 16 more rows;
               the save reloaded (the trained masters bit for bit); a third
               step from the save with --anomaly-update-norm-max at half of
               step 2's update norm (UPDATE_NORM: the weights stay as
               loaded, bit for bit); and one step and evaluate at 2 layers
               in fp32, card against CPU (loss, grad norm, eval NLL within
               1e-4).  Launches exact: K1f 28 x 2, K1dq and K1dkv 28 x each
               train micro-batch, K1f 28 x each eval micro-batch.  Step time,
               tokens/s, MFU and peak memory are printed.
overlap      — the quickstart's ppo-math trial at 4 layers (CUT_LAYERS;
               8 prompts x 4, 128 new
               tokens, a ref, kl_ctl 0.1, two steps; rewards keyed to each
               sequence's id) three ways: the barrier step,
               --pipeline-overlap --overlap-window 1 (train stats and the
               actor's weights after each step equal the barrier's bit for
               bit) and --overlap-window 2 --pipeline-chunk-seqs 2 (four
               chunks of 8 requests, each its own static burst; the train
               stream's 4 chunks and one optimizer step; pipeline/n_chunks 4,
               fill and bubble of every stage; the loss within
               OVERLAP_LOSS_TOL of the barrier's).  Launches of each step =
               4 x the engines' calls summed over every chunk and thread.
               Each step's wall and the card's idle share over step 2
               (torch.profiler, CUDA activity) are printed.
trainmodes   — the trainer's options at qwen2-1.5B (28 layers, random
               weights): (a) TrainEngine in fp32 masters x remat none,
               full, dots, dots_small and bf16 masters x full, dots, one
               micro-batch of 8,192 tokens (segments 256-1,024), a warm
               and a timed step each: launches K1f = 28 x (1 for none, 2
               for the recompute), K1dq = K1dkv = 28; the weights after
               both steps bit for bit equal across the policies of one
               master dtype; forward+backward peaks none > dots >
               dots_small; bf16 masters' peak at least 8 B a parameter
               below fp32's; no peak within 5 GiB of the card's memory;
               step seconds and peaks beside their predictions printed.
               (b) one quickstart ppo-math step with --master-dtype
               bfloat16 --remat dots_small --fuse-rew-ref from the
               quickstart's checkpoint beside a tokenizer.json trained
               here (train_bpe_tokenizer; no char: path): the DFG's
               fused_rew_ref in place of rew_inf and ref_inf, its rewards
               and ref logprobs bit for bit those of the reward interface
               and the ref run alone, every prompt round-tripping through
               the port's BPE reader, exact launches, finite stats.  (c)
               build_null_sft and build_null_ppo, two steps each.
recover      — kill-and-resume at qwen2-1.5B's width and 4 layers
               (CUT_LAYERS) through quickstart.main: the
               quickstart trial with the EMA reference model
               (--ref-ema-eta 0.9 --offload-ref) and the difficulty filter,
               run uninterrupted for three steps (U), for one step with a
               recover checkpoint (R1), and rerun under R1's trial name
               (R2: restores step 1, runs steps 2-3); free disk checked
               first (~25 GiB).  Checked: every EMA bit for bit and the ref
               back on host, the filter's exact drop set and the loader's
               top-up, R1's manifest, R2's restore of R1's masters, Adam
               state, ref, versions, controls and filter state bit for bit,
               R2's steps fetching U's ids with U's tokens and stats (U's
               and R1's step-1 masters compared bit for bit first), and
               each step's launches = 4 x the engines' calls.  The save's
               and restore's seconds, each trial's steps and the peak are
               printed.
push         — the in-memory weight push mid-generation at qwen2-1.5B's
               full width (4 layers, bf16): GenerationServer serves 8 GRPO requests
               (n=4, prompts 64-512, 128 new tokens) while
               update_weights_inmem pushes new random weights with their
               checksum; the call parks at a chunk boundary, the weights
               are swapped, every live row's last chunk is replayed
               through K3 and the call finishes on its pages.  Spanned
               requests (version 0 -> 1), K3 launches = 4 x replays, the
               change against an uninterrupted old-weights run, and a
               refused bad-checksum push are checked.
resume_parity — park at the second serving chunk and resume under
               unchanged weights at qwen2-1.5B's width and 4 layers (rows decoding, a row
               mid-prefill, a follower mapping shared prompt pages): each
               replayed row's logits (K3) against the ones before the
               replay (K2), and in fp32 greedy tokens identical to an
               uninterrupted run.
genmodes     — the generator's other inflight modes at qwen2-1.5B's width
               and 4 layers (CUT_LAYERS) in
               bf16: the serve burst's first 8 prompts (x n=4, 64 new
               tokens, greedy) through GenerationServer over engines of
               16 slots,
               (a) the dense window (kv_paged=False) in bf16 and int8,
               (b) dense spec K=4, (c) the two-program paged path
               (prefill_chunk_tokens=0) in bf16 and int8, (d) spec K=4 on
               the serving plane, then (e) one quickstart ppo-math step
               with --no-paged-kv --spec-decode-k 4 --kv-cache-dtype int8.
               Replies, launches (K4 = 4 x decode steps in (a), (b); K2
               = 4 x decode steps in (c) and 4 x inner steps in (d);
               K1f = 4 x prefill dispatches; the rest 0), one decode
               chunk of each mode under the sync debug mode, and int8
               against bf16 token agreement >= 0.85 (teacher-forced along
               the bf16 run) are checked; tokens/s,
               the decode step's time, spec acceptance, cache copy bytes
               and peak memory are printed.
async        — asynchronous RL at qwen2-1.5B's width and 4 layers
               (CUT_LAYERS; 8 prompts x 4, 128 new
               tokens) from the quickstart's checkpoint: (a) `quickstart
               ppo-math --rollout-ahead 1`, three steps: each batch under
               one generator version, the batches of steps 2-3 generated
               during steps 1-2, exact launches; step walls against the
               quickstart phase's barrier, the card's idle share (NVML),
               the peak.  (b) a GenerationServer (serving plane, explicit
               pool) and a reward service on 127.0.0.1, a build_ppo_math
               trial with gen_server_url, inmem_weight_sync,
               max_head_offpolicyness 1, replay_capacity 4 and remote
               grading, 4 steps: staleness <= 1 (1 at the end), no
               rejection, 4 accepted, decoupled PPO's stats, the server's
               version 1 + the pushes, K2 = 4 x its inner steps, K3 = 4
               x its replays, rewards over HTTP equal to in-process
               grading, code items run in the sandbox graded alike.  (c)
               a RolloutController pumping 32 prompts through that server
               into a ReplayBuffer across 3 disk pushes: a request parked
               and resumed, every consumed group within the bound, greedy
               tokens under a pushed version equal an in-process engine's.
multiproc    — the multi-process runtime at qwen2-1.5B's width and 4 layers
               (CUT_LAYERS) from a seeded checkpoint of that depth:
               ppo-math with a ref, 8 prompts x 4,
               64 new tokens, the seeded null reward, placement
               {"actor_gen": 1, "reward": 1}.  (a) the plan in this
               process (two workers joined by InProcTransfer), 2 steps;
               (b) the same plan through apps.main.run_experiment, each
               worker a process of its own on the card: stats equal to
               (a)'s bit for bit, the workers' summed K1f/K1dq/K1dkv/K4
               launches (asked over their control servers) equal to
               (a)'s, both on the card; (c) recover checkpoints every
               step and worker 0 killed (exit 43) at step 2's train step:
               the retry resubmits both workers, resumes from step 1 and
               its step 2 equals (b)'s bit for bit; (d) in (b)'s and
               (c)'s runs, while the workers serve, `python -m
               areal_tpu_torch.apps.metrics_report --json` finds exactly
               master, model_worker/0 and model_worker/1 and exits 0; the
               master's step count, each worker MFC's calls and each
               MFC's MFU (in (0, 1], equal to the last step's perf/mfu)
               read from /metrics; advisor_pred_err, mfc_mfu_min/max and,
               with recover checkpoints, ckpt_age present.  Each step's
               transfer/* stats, the param push's split (gather,
               checksum, encode, wire, verify, load), each worker's peak,
               each MFC's MFU and the retry's detection, relaunch and
               restore seconds are printed.
fabric       — the param store and the broadcast-tree weight push at
               qwen2-1.5B's full width (4 layers, FABRIC_LAYERS, since
               the verifiers phase joined; bf16 servers) from a seeded
               checkpoint of that depth: three generation servers (two spawned by
               LocalProcessFleet as `python -m
               areal_tpu_torch.system.gen_server` processes, one in this
               process) found by fleet_discovery under a file
               name_resolve.  (d) first: quickstart ppo-math against the
               fleet with --param-push-tree and with the disk push, the
               two trials' tokens and stats bit for bit; (a) a fanout-2
               fabric pushes the checkpoint plus a seeded fp32 delta in
               the middle of a serving-plane burst on every server: depth
               2, every server at the version, the bytes of three hops
               from one serialization, K3 = 4 x replays and K2 = 4 x
               inner steps on the in-process server, identical greedy
               probes (also after a disk swap to the same weights), a
               wrong checksum refused everywhere; (b) a killed relay
               orphans its subtree, repair() restores it, its key
               expires, a spawned replacement joins; (c) tree against
               p2p push walls with each hop and apply.
verifiers    — the verifier fleet, task mixtures and the tracer at
               qwen2-1.5B (28 layers) from the quickstart's checkpoint:
               (a) quickstart ppo-math graded in-process and untraced,
               then traced (AREAL_TRACE=1) with --verifier-pool over two
               spawned `python -m areal_tpu_torch.apps.verifier`
               processes, one killed by AREAL_FAULTS mid-trial: tokens
               and stats bit for bit, every grade and 64 fixed answers
               before and after the kill equal to the registry, the dead
               key gone within its TTL, each step's K1f/K1dq/K1dkv/K4
               launches from the engines' calls; (b) a RolloutController
               with a 3:1 two-task TaskMixtureStream over an in-process
               GenerationServer (K2), a disk push mid-run, restored from
               state_dict() half way, graded by a spawned reward service:
               the draws, the remaining qids and every sample's lineage
               dispatch -> graded -> admitted -> trained; (c)
               `python -m areal_tpu_torch.apps.trace_report` on both
               directories (attribution, bubbles, --flight with the
               killed verifier's dump, --lineage), validate_trace clean;
               step walls traced and untraced, each process's spans,
               shard bytes and flush seconds.
supervisor   — the SLO fleet supervisor at qwen2-1.5B's width and 4 layers
               (CUT_LAYERS, bf16) from the seeded checkpoint of that depth:
               a GenerationServer in this process (s8401), a
               FleetSupervisor (min 1, max 2, `crit: queue_depth <= 16`)
               spawning `python -m areal_tpu_torch.system.gen_server`
               through LocalProcessFleet(sid_prefix="s"), and a verifier
               lane (min 1) over `python -m areal_tpu_torch.apps.verifier`;
               a RolloutController over fleet_discovery streams serving-
               plane requests (a stop sequence) until the queue's CRIT has
               spawned s8402 and it has served.  Checked: the lane's
               refill; the spawn, dispatches to s8402 and both servers'
               areal_gen_tokens_total rising by the tokens the controller
               received; goodput, kv_utilization, live_slots and
               version_skew in the rounds' signals; K2 = 4 x inner steps
               in this process, no K1f/K3/K4, no host sync in a chunk;
               three idle rounds drain s8402, whose process exits within
               the drain grace and whose weights and KV pool come back to
               the card; a SIGKILLed verifier evicted by its TTL and
               refilled; a second supervisor resuming both epochs from the
               recover root.  A round's seconds, CRIT to spawn, spawn to
               announce, announce to first tokens, drain to exit, the
               memory freed and kill to refill are printed.
chaos        — the chaos legs of `python -m areal_tpu_torch.scripts.check_async`,
               called in this process at qwen2-1.5B's width and 4 layers
               from the seeded checkpoint of that depth (phase_chaos):
               (a) NaN gradients quarantine a TrainEngine step with the
               masters, Adam's state and count bit for bit, one
               synchronizing call, K1 as the clean step's; (b) a NaN
               streak in the tiny-PPO trial rolls back and replays bit
               for bit; (c) a corrupted in-memory push refused by the
               card-side checksum, retried, greedy tokens equal a
               control server's (K2 = 4 x inner steps); (d) a victim
               process killed at recover_stage (exit 42), restarted, its
               torn checkpoint falling back to .prev ((b) and (d) at 2
               layers: their saves write fp32 masters and Adam's moments
               every step); (e) three in-process
               servers, one killed by kill@t mid-decode: no prompt lost,
               its breaker's cycle, its flight dump (K2 = 4 x inner steps).
families     — MoE and the mixtral and gpt2 families at published widths
               with seeded random weights (phase_families): (a) one MoE
               MLP at Mixtral-8x7B's width (D 4096, 8 experts of FFN
               14336, top-2): grouped and topk (capacity factor E)
               against the dense oracle in fp32 (1e-4 of the output's
               scale) and bf16 (2**-5 a row), routing and aux identical,
               topk at capacity factor 0.5 against a host recount of its
               drops, no host sync in each dispatch's forward and in
               grouped's backward, bf16 device times at T=64 and 8192
               beside the bound; (b) a 1-layer Mixtral-8x7B checkpoint
               written through the mixtral family (fp32, two shards;
               the reload bit for bit) and two `quickstart ppo-math`
               GRPO steps from it (--master-dtype bfloat16, an offloaded
               ref, char:32000): finite stats, K1f/K1dq/K1dkv/K4 = 1 x
               the engines' calls, each MFC's MFU; (c) a GenerationServer
               from that checkpoint serves the serve burst on the serving
               plane (K2 = 1 x inner steps), as one static chunk (K1f,
               K4) and on a dense-oracle engine, held against each other
               (free-running agreement printed; teacher-forced argmax
               agreement >= 0.85 and median logits row error <= 2**-5);
               no host sync in a serving chunk or a static decode step;
               (d) GPT-2 small at full depth: a gpt2 checkpoint, one
               quickstart step (char:50257) and a serving-plane burst,
               launches 12 x the engines' calls; (e) K1f/K1dq/K1dkv, K2
               and K4 against their plain versions at
               32/8 heads of 128 and 12/12 of 64.  mistral is held on the
               CPU only.
gemma        — the gemma family at google/gemma-2b's and gemma-7b's
               published widths with seeded random weights
               (phase_gemma): (a) every attention kernel form at head_dim
               256 (K1f, K1dq, K1dkv in fp32 and bf16; K2 in every type
               pairing; K3's chunk form in fp32, bf16 and int8, and its
               Q=1 entry point; K4 at Q=1, Q=5 and over int8) against its
               plain version at 8/1 and 16/16 heads, times at 8/1 beside
               the bound and SDPA; (b) a 4-layer Gemma-2B checkpoint
               written and reloaded bit for bit, two quickstart GRPO
               steps from it; (c) Gemma-2B at its 18 layers serving the
               burst on the serving plane and as one static chunk, held
               teacher-forced against each other (bf16, and in fp32
               within 1e-3), and a burst with a mid-way push (K3 = 18 x
               replays); (d) Gemma-7B at 2 layers (q width 4096 over
               hidden 3072): a checkpoint, a serving-plane burst, one
               quickstart step.
episodes     — agent episodes at qwen2-1.5B's full width, 4 layers, in bf16 through
               GenerationServer's POST /episode and the port's
               LLMAPIClient: (a) 8 calculator episodes (the serve burst's
               first 8 prompts; 3 turns, 32 new tokens a turn, a
               2048-token budget, observations of at most 6 tokens) on
               their own client threads, (b) python_exec once, (c) a
               SlotGone re-admission mapping the published prefix, (d)
               LRU eviction on a 7-page pool, (e) a weight push mid-turn
               (park, swap, episode_resume's K3 replay); (f) (a) with 4
               episodes and (e) over an int8 pool.  The stop set is probed so that turns 1
               and 2 of each episode end at their first token, and those
               turns must equal the probes' tokens and logprobs while
               every position past a rewound cursor is poisoned.
               Checked: turn accounting (observation prefills, transcript
               lengths, versions), K2 = 4 x inner steps, K3 = 4 x
               replays, K1f and K4 0, one chunk build, no host sync in a
               chunk; turn latency, tokens/s, the step time, observation
               prefill against transcript tokens and peak memory printed.
parity       — greedy tokens at qwen2-1.5B width and 2 layers in fp32: the
               engine on the card against the engine on the CPU (the
               plain path), on the serving plane (inflight=True, K2), on
               the static path (inflight=False, K1f and K4) and in each
               mode of genmodes (a)-(d); every full-precision mode's
               tokens equal the static path's.  Then one episode (two
               turns, SlotGone, a re-admission, a push mid-turn and
               episode_resume) on the card against the CPU: turns
               identical, logprobs within 1e-3, K2 = 2 x inner steps and
               K3 = 2 x replays.
train_parity — one train_batch at qwen2-1.5B width, 2 layers, fp32, of
               the actor (PPO loss) and of a critic (value loss): the card
               (K1) against the CPU (plain path): loss, grad_norm and the
               weights after the step.

The CPU halves of sft's, parity's and train_parity's comparisons run in a
child process (`--cpu-refs`, no card, CPU_REF_THREADS threads) started
before the push phase, beside the card's phases; each phase reads its half
from the child's file and checks that it ran on the same inputs.

`python3 chip_smoke.py --phases build,flash` is the quick call after
editing a flash kernel, `--phases build,kernel` after editing K2, K3 or
K4 (about 20 s of command on an H100), `--phases build,ppo` for the PPO
step with the critic and the reference model, `--phases build,quickstart`
for the quickstart entry point, `--phases build,sft` for SFT and the
sentinels, `--phases build,overlap` for the pipeline-overlapped step,
`--phases build,trainmodes` for the remat policies, bf16 masters, the
fused MFC, the BPE reader and the null trials,
`--phases build,recover` for kill-and-resume, `--phases build,kernel,parity,genmodes` for the
generator's other inflight modes, `--phases build,episodes,parity` for
agent episodes, `--phases build,quickstart,async` for asynchronous RL,
`--phases build,quickstart,multiproc` for the multi-process runtime,
`--phases build,verifiers` for the verifier fleet, mixtures and the tracer,
`--phases build,supervisor` for the SLO fleet supervisor, `--phases
build,chaos` for the chaos legs (each writes the 4-layer checkpoint
itself), `--phases build,families` for MoE and the mixtral and gpt2
families and `--phases build,gemma` for gemma and head_dim 256 (each
writes its own checkpoints).  Each phase's seconds are printed as `[time]` lines.  The line before the last is one JSON object
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.  Needs one
CUDA card; imports no JAX.
"""

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "flash", "serve", "static", "push", "resume_parity",
          "train", "ppo", "sharded", "quickstart", "sft", "overlap", "trainmodes", "recover", "genmodes",
          "async", "multiproc", "group", "fabric", "verifiers", "supervisor", "chaos", "families",
          "gemma", "episodes", "parity", "train_parity")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_cuda(fn, warmup: int = 5, iters: int = 25) -> float:
    """Median milliseconds of `fn()` over `iters` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_graph(fn, iters: int = 50) -> float:
    """Device milliseconds of one `fn()`: the call captured once in a CUDA
    graph, replayed `iters` times between two CUDA events.  Unlike
    time_cuda, no host work of the call (Python, checks, launches) is in
    the reading, so a call the host cannot keep the card busy with still
    reads its device time."""
    import torch

    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def timings(fn, plain, library, iters=25) -> dict:
    """A kernel's wrapper, its plain version and its library yardstick on
    the same inputs: device time (graph replays) and the time of an eager
    call (CUDA events around it, host work included) of each."""
    out = {}
    for key, f in (("kernel", fn), ("plain", plain), ("library", library)):
        out[f"{key}_ms"] = time_graph(f)
        out[f"{key}_eager_ms"] = time_cuda(f, iters=iters)
    return out


def no_host_sync(name: str, fn, tag: str = "[kernel]") -> None:
    """One call of a wrapper under torch.cuda.set_sync_debug_mode("error"):
    a host read of a device tensor inside it fails the run."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        check(False, f"{name}: the wrapper synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag} {name}: one call under set_sync_debug_mode('error'): no host sync")


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def _ptxas_lines(log_text):
    """One line per compiled kernel from nvcc's -Xptxas -v report: its
    name (demangled with c++filt where the toolkit host has it), registers,
    spill stores/loads and static shared memory."""
    import re
    import shutil

    rows, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append([name, f"{m.group(1)} registers, {spill or 'spills ?'}"
                         + (f", {smem.group(1)} B static smem" if smem else "")])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
            text=True, timeout=60,
        ).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [f"{n}: {rest}" for n, rest in rows]




def phase_build():
    from areal_tpu_torch.kernels import build

    t0 = time.monotonic()
    info = build.build_all()
    secs = time.monotonic() - t0
    for name, r in info.items():
        log(f"[build] {name} -> {os.path.relpath(r['path'], REPO)}")
        for line in _ptxas_lines(r["log"]):
            log(f"[build]   {line}")
    log(f"[build] seconds={secs:.2f}")
    log_card()


def log_card() -> None:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[card] {smi}")


# --------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# --------------------------------------------------------------------------


def _stream(seed, fixed=(1, 2, 127, 128, 129, 255, 256, 1000, 2047, 2048, 2100), mp=16,
            heads=(12, 2, 128)):
    """A 96-lane serving stream at qwen2-1.5B's attention shape (`heads`:
    n_q, n_kv, head_dim): 56 decode
    lanes and 4 prefill slices of 8 lanes with windows of 1..2048 that
    cross page boundaries (one decode window, 2100, runs past its 16-page
    table, which then bounds it), then 8 dead lanes; page tables carry
    sentinel entries past each row's mapped pages.  The last pool page is
    never mapped, so poisoning it must change nothing.  `fixed` gives the
    first decode lanes' windows, `mp` the table's pages."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (n_q, n_kv, d), ps = heads, 128
    rows = []  # (positions of the row's lanes)
    fixed = list(fixed)
    for i in range(56):
        vt = fixed[i] if i < len(fixed) else int(rng.integers(1, 2049))
        rows.append([vt - 1])
    for p0 in (0, 124, 1020, 2040):
        rows.append(list(range(p0, p0 + 8)))
    pages_per_row = [min(mp, -(-(max(r) + 1) // ps)) for r in rows]
    n_pool = sum(pages_per_row) + 8
    perm = rng.permutation(n_pool - 1)  # page n_pool-1 stays unmapped
    pt_rows, used = [], 0
    for k in pages_per_row:
        row = np.full((mp,), n_pool, np.int32)  # sentinel
        row[:k] = perm[used : used + k]
        used += k
        pt_rows.append(row)
    pt_tok, vt = [], []
    for r, pos in zip(pt_rows, rows):
        for p in pos:
            pt_tok.append(r)
            vt.append(p + 1)
    for _ in range(8):  # dead lanes: a row's table, window 0
        pt_tok.append(pt_rows[0])
        vt.append(0)
    pt_tok = np.stack(pt_tok).astype(np.int32)
    vt = np.asarray(vt, np.int32)
    T = len(vt)
    q = rng.standard_normal((T, n_q, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002)
    vs = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002)
    return dict(
        q=q, k=k, v=v, k8=k8, v8=v8, ks=ks.astype(np.float32),
        vs=vs.astype(np.float32), pt=pt_tok, vt=vt, n_live=T - 8,
    )


def _bound(s, elem_bytes, kv_bytes=None):
    """Least time for the call: unique K/V bytes the windows need (each
    position once, though many lanes of a row read it; `kv_bytes` a
    position and kv head of K, and of V, default d * elem_bytes), q in,
    out back, tables; against the flops of QK and PV at the bf16 tensor
    rate."""
    ps = s["k"].shape[1]
    n_kv, d = s["k"].shape[2], s["k"].shape[3]
    n_q = s["q"].shape[1]
    need = {}  # page -> positions needed
    flops = 0
    for row, vt in zip(s["pt"], s["vt"]):
        vt = min(int(vt), len(row) * ps)  # the table bounds the window
        flops += 4 * vt * n_q * d
        for j in range(-(-int(vt) // ps)):
            page = int(row[j])
            need[page] = max(need.get(page, 0), min(ps, vt - j * ps))
    kv_bytes = 2 * sum(need.values()) * n_kv * (kv_bytes or d * elem_bytes)
    io_bytes = 2 * s["q"].size * elem_bytes + s["pt"].size * 4 + s["vt"].size * 4
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


K2_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 1e-3}  # max abs error


def _hold_k2(tag, s, poison):
    """K2 on stream `s` against its plain version and its split reference
    (at the kernel's own span) on the same inputs, fp32, bf16 and int8
    pools (fp32 q), each within K2_TOL; bf16 q over the int8 pool (the
    tensor-core int8 path) within FLASH_ROW_TOL["bf16"] of the plain
    version on an fp32 copy of q and within MODEL_TOL of the split
    reference (`_model_err`); window-0 lanes exactly 0; with `poison`,
    the never-mapped last pool page set to 1e9 (127 and scale 1e9 for
    int8) changing nothing.  Returns {dtype: error} and the tensors."""
    import torch

    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()
         if key != "n_live"}
    ks, vs = t["ks"].to(bf), t["vs"].to(bf)
    cases = {
        "fp32": (t["q"], t["k"], t["v"], None, None),
        "bf16": (t["q"].to(bf), t["k"].to(bf), t["v"].to(bf), None, None),
        "int8": (t["q"], t["k8"], t["v8"], ks, vs),
        "bf16q_int8": (t["q"].to(bf), t["k8"], t["v8"], ks, vs),
    }
    ps, mp = s["k"].shape[1], s["pt"].shape[1]
    span_pages, n_splits = rpa.split_plan(mp, ps, s["q"].shape[0] * s["k"].shape[2])
    dead = t["vt"] == 0
    errs = {}
    for name, (q, k, v, ksc, vsc) in cases.items():
        args = (q, k, v, t["pt"], t["vt"], ksc, vsc)
        out = rpa.ragged_paged_attention_kernel(*args)
        split = rpa.ragged_paged_attention_split_reference(*args, span=span_pages * ps)
        quant_mma = name == "bf16q_int8"
        ref = rpa.ragged_paged_attention_reference(q.float() if quant_mma else q, *args[1:])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 {tag} {name}: non-finite kernel output")
        spans = f"{n_splits} span(s) of {span_pages} page(s)"
        if quant_mma:
            rel, err = _row_err(out, ref)
            rel_m = _model_err(out, split)
            errs[name], errs[f"{name}_row"], errs[f"{name}_model"] = err, rel, rel_m
            log(f"[kernel] K2 {tag} {name}: row_err={rel:.3e} against the plain version "
                f"(tolerance {FLASH_ROW_TOL['bf16']:.3e}), {rel_m:.3e} against the split "
                f"reference beyond the output's rounding (tolerance {MODEL_TOL:g}); "
                f"max_abs_err={err:.3e}; {spans}")
            check(rel <= FLASH_ROW_TOL["bf16"], f"K2 {tag} {name} disagrees with the plain "
                  f"version: {rel:.3e}")
            check(rel_m <= MODEL_TOL, f"K2 {tag} {name} disagrees with the split reference: "
                  f"{rel_m:.3e}")
        else:
            tol = K2_TOL[name]
            err = float((out.float() - ref.float()).abs().max())
            err_s = float((out.float() - split.float()).abs().max())
            errs[name], errs[f"{name}_split"] = err, err_s
            log(f"[kernel] K2 {tag} {name}: max_abs_err={err:.3e} against the plain version, "
                f"{err_s:.3e} against the split reference (tolerance {tol:g}; {spans})")
            check(err <= tol, f"K2 {tag} {name} disagrees with the plain version")
            check(err_s <= tol, f"K2 {tag} {name} disagrees with the split reference")
        check(float(out[dead].float().abs().max()) == 0.0,
              f"K2 {tag} {name}: dead lanes are not exactly 0")
        if not poison:
            continue
        # Poison the never-mapped last page: a sentinel-clamped read that
        # leaked mass would change the output.
        k_bad, v_bad = k.clone(), v.clone()
        if k.dtype == torch.int8:
            k_bad[-1], v_bad[-1] = 127, 127
            ks_bad, vs_bad = ksc.clone(), vsc.clone()
            ks_bad[-1], vs_bad[-1] = 1e9, 1e9
        else:
            k_bad[-1], v_bad[-1] = 1e9, 1e9
            ks_bad, vs_bad = ksc, vsc
        out_bad = rpa.ragged_paged_attention_kernel(
            q, k_bad, v_bad, t["pt"], t["vt"], ks_bad, vs_bad
        )
        check(
            torch.equal(out, out_bad),
            f"K2 {tag} {name}: poisoning the last pool page changed the output",
        )
    return errs, t, cases


def phase_kernel(report, seed):
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import paged_gather_layer
    from areal_tpu_torch.ops.quant import kv_dequant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16
    s = _stream(seed)
    errs, t, cases = _hold_k2("stream", s, poison=True)
    # Windows at the 256-position span's edges, +-1; and a 2-page table
    # (one span: the split pass writes the output, no merge) whose longer
    # windows run past it.
    edges = _stream(seed + 7, fixed=(255, 256, 257, 511, 512, 513, 767, 768, 769, 1, 2))
    for tag, es in (("span edges", edges), ("one span", _stream(seed + 8, mp=2))):
        e, _, _ = _hold_k2(tag, es, poison=False)
        errs.update({f"{tag}_{key}": val for key, val in e.items()})
    q, k, v = cases["bf16"][:3]
    no_host_sync("K2", lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"]))
    # Times at the main path's dtype (bf16 q and pool).  Library
    # yardstick: one SDPA call over the pre-gathered windows.
    T, n_q, d = q.shape
    n_kv = k.shape[2]
    kc = paged_gather_layer(k, t["pt"]).transpose(1, 2)  # [T, n_kv, S, d]
    vc = paged_gather_layer(v, t["pt"]).transpose(1, 2)
    kc = kc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
    vc = vc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
    mask = (
        torch.arange(kc.shape[2], device=dev)[None, :] < t["vt"][:, None]
    )[:, None, None, :]
    q4 = q[:, :, None, :]
    times = timings(
        lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"]),
        lambda: rpa.ragged_paged_attention_reference(q, k, v, t["pt"], t["vt"]),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
    )
    bound_ms, bound_by = _bound(s, 2)
    log(
        f"[kernel] K2 bf16 T={T}: kernel_ms={times['kernel_ms']:.4f} "
        f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
        f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
        f"bound_ms={bound_ms:.5f} ({bound_by})"
    )
    report["kernel"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by,
                            T=T, **times)
    # bf16 q over the int8 pool (the serving plane with an int8 cache):
    # SDPA over the same windows dequantized to bf16; the bound reads one
    # byte a K/V element and its bf16 scale.
    q8, k8, v8, ks8, vs8 = cases["bf16q_int8"]
    no_host_sync("K2 bf16q_int8", lambda: rpa.ragged_paged_attention_kernel(
        q8, k8, v8, t["pt"], t["vt"], ks8, vs8))
    kd = kv_dequant(paged_gather_layer(k8, t["pt"]), paged_gather_layer(ks8, t["pt"]), bf)
    vd = kv_dequant(paged_gather_layer(v8, t["pt"]), paged_gather_layer(vs8, t["pt"]), bf)
    kd = kd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
    vd = vd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
    times8 = timings(
        lambda: rpa.ragged_paged_attention_kernel(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
        lambda: rpa.ragged_paged_attention_reference(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask),
    )
    bound8, by8 = _bound(s, 2, kv_bytes=d + 2)
    log(
        f"[kernel] K2 bf16q_int8 T={T}: kernel_ms={times8['kernel_ms']:.4f} "
        f"plain_ms={times8['plain_ms']:.4f} library_ms={times8['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times8['kernel_eager_ms']:.4f} "
        f"plain={times8['plain_eager_ms']:.4f} library={times8['library_eager_ms']:.4f}; "
        f"bound_ms={bound8:.5f} ({by8})"
    )
    report["kernel"]["bf16q_int8"] = dict(bound_ms=bound8, bound_by=by8, **times8)
    _kernel_k3(report, seed)
    _kernel_k3_q1(report, seed)
    _kernel_k4(report, seed)
    _kernel_k4_inflight(report, seed)
    _split_sweep(report, seed)


def _split_sweep(report, seed):
    """K2 (the 96-lane stream) and K4 (the 32-row decode case), bf16, and
    K2 at K3's Q=1 shape (16 slots; bf16, and bf16 q over int8): device
    time (graph replays) at forced spans around the wrappers' own, and
    one profiled call of each at its own plan's span, split into the
    split pass and the merge kernel."""
    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    dev, bf = torch.device("cuda"), torch.bfloat16
    s = _stream(seed)
    q2, k2, v2 = (torch.from_numpy(s[key]).to(dev).to(bf) for key in ("q", "k", "v"))
    pt, vt2 = torch.from_numpy(s["pt"]).to(dev), torch.from_numpy(s["vt"]).to(dev)
    q_np, vf_np, vt_np, S = _k4_cases(seed)["decode"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q4 = torch.from_numpy(q_np).to(dev).to(bf)
    k4, v4 = (torch.randn((32, S, 2, 128), generator=gen, device=dev).to(bf)
              for _ in range(2))
    vf, vt4 = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
    # K2 at K3's Q=1 shape (16 slots, windows 64-640, a 6-page table of
    # 128: the two-program path's decode step), bf16 and bf16 q over int8.
    rng = np.random.default_rng(seed + 41)
    L = rng.integers(64, 641, 16)
    L[:2] = (64, 640)
    sl = _k3_slots(rng, 1, L, np.ones(16, np.int32), [-(-int(x) // 128) for x in L], 6)
    q1 = torch.from_numpy(sl["q"][:, 0]).to(dev).to(bf)
    k1, v1 = (torch.from_numpy(sl[key]).to(dev).to(bf) for key in ("k", "v"))
    k18, v18 = (torch.from_numpy(sl[key]).to(dev) for key in ("k8", "v8"))
    ks1, vs1 = (torch.from_numpy(sl[key]).to(dev).to(bf) for key in ("ks", "vs"))
    pt1, vt1 = torch.from_numpy(sl["pt"]).to(dev), torch.from_numpy(sl["hi0"]).to(dev)
    own2 = rpa.split_plan(pt.shape[1], 128, q2.shape[0] * 2)[0] * 128
    own1 = rpa.split_plan(pt1.shape[1], 128, 16 * 2)[0] * 128
    runs = (
        ("K2", rpa, lambda: rpa.ragged_paged_attention_kernel(q2, k2, v2, pt, vt2),
         (128, 256, 512), own2),
        ("K4", da, lambda: da.decode_attention_kernel(q4, k4, v4, vf, vt4),
         (64, 128, 256), da.SPLIT_POSITIONS),
        ("K2 Q=1 B=16", rpa, lambda: rpa.ragged_paged_attention_kernel(q1, k1, v1, pt1, vt1),
         (128, 256, 384), own1),
        ("K2 Q=1 B=16 bf16q_int8", rpa,
         lambda: rpa.ragged_paged_attention_kernel(q1, k18, v18, pt1, vt1, ks1, vs1),
         (128, 256, 384), own1),
    )
    out = {}
    for name, mod, fn, spans, own in runs:
        # Each span forced: K2's plan keeps it whatever the grid's size.
        saved = {key: getattr(mod, key) for key in ("SPLIT_POSITIONS", "SPLIT_MIN_BLOCKS")
                 if hasattr(mod, key)}
        try:
            for span in spans:
                mod.SPLIT_POSITIONS = span
                if "SPLIT_MIN_BLOCKS" in saved:
                    mod.SPLIT_MIN_BLOCKS = 0
                out[f"{name}_span{span}_ms"] = time_graph(fn)
        finally:
            for key, val in saved.items():
                setattr(mod, key, val)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        parts = {"split": 0.0, "merge": 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "attention" in e.key:
                us = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if us is None else us
                parts["merge" if "merge" in e.key else "split"] += us / 20
        out[f"{name}_split_us"], out[f"{name}_merge_us"] = parts["split"], parts["merge"]
        log(f"[kernel] {name} spans (positions: device ms) "
            + ", ".join(f"{sp}: {out[f'{name}_span{sp}_ms']:.4f}" for sp in spans)
            + f"; at its own span {own}, one call = split pass {parts['split']:.1f} us"
            f" + merge {parts['merge']:.1f} us (profiler)")
    report["split_sweep"] = out


def _k3_slots(rng, nq_tok, hi0, ql, n_pages, mp, n_q=12, n_kv=2, d=128, ps=128):
    """K3's inputs at qwen2-1.5B width: slot s maps n_pages[s] pages of a
    shuffled pool, then sentinels; query i of slot s attends [0, hi0[s] +
    i) while i < ql[s].  The last pool page is never mapped, so poisoning
    it must change nothing."""
    import numpy as np

    b = len(hi0)
    n_pool = sum(n_pages) + 8
    perm = rng.permutation(n_pool - 1)  # page n_pool-1 stays unmapped
    pt = np.full((b, mp), n_pool, np.int32)
    used = 0
    for s, k in enumerate(n_pages):
        pt[s, :k] = perm[used : used + k]
        used += k
    return dict(
        q=rng.standard_normal((b, nq_tok, n_q, d)).astype(np.float32),
        k=rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32),
        v=rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32),
        k8=rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8),
        v8=rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8),
        ks=(np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002).astype(np.float32),
        vs=(np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.01 + 0.002).astype(np.float32),
        pt=pt, hi0=np.asarray(hi0, np.int32), ql=np.asarray(ql, np.int32),
    )


def _replay_slots(seed, heads=(12, 2, 128)):
    """The resume replay's shape at qwen2-1.5B width (or `heads`: n_q,
    n_kv, head_dim): B=64 slots of
    Q=chunk_t=32 queries; slot b has L forwarded tokens (64..640) and
    replays its last r (0..32, some 0), so query i attends
    [0, L - r + 1 + i) and valid_to0 = L - r + 1.  Each slot maps
    ceil(L / 128) pages of a shuffled pool."""
    import numpy as np

    rng = np.random.default_rng(seed + 21)
    b, nq_tok, ps = 64, 32, 128
    L = rng.integers(64, 641, b)
    L[:4] = (64, 127, 128, 640)
    r = rng.integers(0, nq_tok + 1, b)
    r[:8] = (32, 1, 0, 32, 0, 17, 32, 5)
    r = np.minimum(r, L)
    mp = -(-(640 + nq_tok) // ps)
    n_q, n_kv, d = heads
    return _k3_slots(rng, nq_tok, L - r + 1, r, [-(-int(x) // ps) for x in L], mp,
                     n_q=n_q, n_kv=n_kv, d=d)


def _k3_edge_slots(seed, nq_tok, heads=(12, 2, 128)):
    """K3's edge cases at qwen2-1.5B width, page 128, a 6-page table (768
    positions), against the kernel's 64-row blocks and 32-position tiles:
    8 slots of Q=13 queries (78 rows: one full block and one partial,
    straddling queries) or of Q=1.  The last live query's window ends at
    32 (a tile edge), 128 (a page edge), 129, 256, past the table (800,
    bounded to 768), at 13 in a ragged slot (2 of Q live), at 1, and
    nowhere in an all-dead slot (q_lens 0)."""
    import numpy as np

    rng = np.random.default_rng(seed + 22 + nq_tok)
    last = np.array([32, 128, 129, 256, 800, 13, 1, 300])
    ql = np.minimum(np.array([13, 13, 13, 13, 13, 2, 1, 0]), nq_tok)
    pages = [-(-min(int(x), 768) // 128) if n else 0 for x, n in zip(last, ql)]
    n_q, n_kv, d = heads
    return _k3_slots(rng, nq_tok, last - np.maximum(ql - 1, 0), ql, pages, 6,
                     n_q=n_q, n_kv=n_kv, d=d)


def _k3_bound(s, elem_bytes, kv_bytes=None):
    """Least time for K3 on these slots: the flops of QK and PV over every
    live query's window at the bf16 tensor rate, against each slot's
    unique K/V positions (its widest live window, read once for all its
    queries and heads; `kv_bytes` a position and kv head of K, and of V,
    default d * elem_bytes), the live queries' q in (a dead query's
    output is 0 whatever its q holds), every output row back and the
    tables at the HBM rate."""
    b, nq_tok, n_q, d = s["q"].shape
    n_kv = s["k"].shape[2]
    cap = s["pt"].shape[1] * s["k"].shape[1]
    flops = kv_pos = 0
    for hi0, ql in zip(s["hi0"].tolist(), s["ql"].tolist()):
        for i in range(ql):
            flops += 4 * d * n_q * min(hi0 + i, cap)
        if ql > 0:
            kv_pos += min(hi0 + ql - 1, cap)
    nbytes = (2 * kv_pos * n_kv * (kv_bytes or d * elem_bytes)
              + int(s["ql"].sum()) * n_q * d * elem_bytes + s["q"].size * elem_bytes
              + s["pt"].size * 4 + 2 * b * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _k3_poison(s, k, v, ks, vs):
    """Copies of a pool (and its scales) with every page no slot maps and,
    in each slot's mapped pages, every position at or past its widest
    live window (0 for a slot with no live query) set to a huge value
    (int8: code 127 with a scale of 1e9): no kernel read may reach them."""
    import numpy as np
    import torch

    n_pool, ps = k.shape[:2]
    bad = np.ones((n_pool, ps), bool)
    cap = s["pt"].shape[1] * ps
    for pt_row, hi0, ql in zip(s["pt"], s["hi0"].tolist(), s["ql"].tolist()):
        end = max(0, min(hi0 + ql - 1, cap)) if ql > 0 else 0
        for j, page in enumerate(pt_row.tolist()):
            if page < n_pool:
                bad[page, : max(0, min(end - j * ps, ps))] = False
    bad = torch.from_numpy(bad).to(k.device)
    huge = 127 if k.dtype == torch.int8 else 1e9
    k_bad, v_bad = (torch.where(bad[..., None, None], torch.full_like(x, huge), x)
                    for x in (k, v))
    if ks is None:
        return k_bad, v_bad, ks, vs
    ks_bad, vs_bad = (torch.where(bad[..., None], torch.full_like(x, 1e9), x) for x in (ks, vs))
    return k_bad, v_bad, ks_bad, vs_bad


def _hold_k3(tag, s):
    """K3 on slots `s` (see _k3_slots) in fp32, bf16, fp32 q over an int8
    pool and bf16 q over an int8 pool (the replay's int8 form), each
    output row (one position's head vector) within FLASH_ROW_TOL of that
    row's largest |value| (see _row_err) of its plain version, taken on
    fp32 copies of the same rounded inputs, and of its tiled model
    (`paged_chunk_attention_tiled_reference`, the kernel's own tiles and
    bf16 P or P'); bf16 q over int8 also within MODEL_TOL of the tiled
    model beyond the output's rounding (`_model_err`, as K2 and K4 hold
    the same arithmetic); dead queries and q_lens-0 slots exactly 0;
    poisoning what no window reaches (_k3_poison) changes nothing,
    bitwise.  Returns (errors, the cases, the device tensors)."""
    import torch

    from areal_tpu_torch.kernels import paged_chunk_attention as pca

    dev = torch.device("cuda")
    t = {key: torch.from_numpy(val).to(dev) for key, val in s.items()}
    pt, hi0, ql = t["pt"], t["hi0"], t["ql"]
    nq_tok = s["q"].shape[1]
    dead = torch.arange(nq_tok, device=dev)[None, :] >= ql[:, None]  # [B, Q]
    ks, vs = t["ks"].to(torch.bfloat16), t["vs"].to(torch.bfloat16)
    bf = torch.bfloat16
    cases = {
        "fp32": (t["q"], t["k"], t["v"], None, None, FLASH_ROW_TOL["fp32"]),
        "bf16": (t["q"].to(bf), t["k"].to(bf), t["v"].to(bf), None, None,
                 FLASH_ROW_TOL["bf16"]),
        "int8": (t["q"], t["k8"], t["v8"], ks, vs, FLASH_ROW_TOL["fp32"]),
        "bf16q_int8": (t["q"].to(bf), t["k8"], t["v8"], ks, vs, FLASH_ROW_TOL["bf16"]),
    }
    errs = {}
    for name, (q, k, v, ksc, vsc, tol) in cases.items():
        out = pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql, ksc, vsc)
        f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
        ref = pca.paged_chunk_attention_reference(
            q.float(), f32(k), f32(v), pt, hi0, ql, ksc, vsc
        )
        tiled = pca.paged_chunk_attention_tiled_reference(q, k, v, pt, hi0, ql, ksc, vsc)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K3 {tag} {name}: non-finite output")
        rel, err = _row_err(out, ref)
        rel_t, _ = _row_err(out, tiled)
        errs[name], errs[f"{name}_row"], errs[f"{name}_tiled_row"] = err, rel, rel_t
        log(f"[kernel] K3 {tag} {name}: row_err={rel:.3e}, against the tiled model "
            f"{rel_t:.3e} (tolerance {tol:.3e}) max_abs_err={err:.3e}")
        check(rel <= tol, f"K3 {tag} {name} disagrees with the plain version")
        check(rel_t <= tol, f"K3 {tag} {name} disagrees with the tiled model")
        if name == "bf16q_int8":
            rel_m = _model_err(out, tiled)
            errs[f"{name}_model"] = rel_m
            log(f"[kernel] K3 {tag} {name}: {rel_m:.3e} against the tiled model beyond the "
                f"output's rounding (tolerance {MODEL_TOL:g})")
            check(rel_m <= MODEL_TOL, f"K3 {tag} {name} disagrees with the tiled model "
                  f"beyond the output's rounding: {rel_m:.3e}")
        if bool(dead.any()):
            check(float(out.float()[dead].abs().max()) == 0.0,
                  f"K3 {tag} {name}: dead queries are not exactly 0")
        k_bad, v_bad, ks_bad, vs_bad = _k3_poison(s, k, v, ksc, vsc)
        out_bad = pca.paged_decode_attention_chunk(q, k_bad, v_bad, pt, hi0, ql, ks_bad, vs_bad)
        check(torch.equal(out, out_bad),
              f"K3 {tag} {name}: poisoning what no window reaches changed the output")
    return errs, cases, t


def _kernel_k3(report, seed):
    """K3 held (see _hold_k3) at the replay's shape and on the edge slots
    at Q=13 and Q=1; one call under the sync debug mode; then, at the
    replay's shape in bf16 and in bf16 q over an int8 pool, the times of
    K3, its plain version and SDPA on the gathered windows with the
    boolean mask (device time from graph replays, and eager calls), and
    the bound."""
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.ops.attention import paged_gather_layer

    dev = torch.device("cuda")
    s = _replay_slots(seed)
    errs, cases, t = _hold_k3("replay", s)
    for nq_tok in (13, 1):
        e, _, _ = _hold_k3(f"edges Q={nq_tok}", _k3_edge_slots(seed, nq_tok))
        errs.update({f"edges{nq_tok}_{key}": val for key, val in e.items()})
    pt, hi0, ql = t["pt"], t["hi0"], t["ql"]
    b, nq_tok = s["q"].shape[:2]
    dead = torch.arange(nq_tok, device=dev)[None, :] >= ql[:, None]
    q, k, v = cases["bf16"][:3]
    no_host_sync("K3", lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql))
    # Library yardstick: one SDPA call over the gathered windows with the
    # boolean mask (query i of slot b sees [0, hi0[b] + i) while i < ql[b]).
    kc = paged_gather_layer(k, pt).transpose(1, 2).contiguous()  # [B, n_kv, S, d]
    vc = paged_gather_layer(v, pt).transpose(1, 2).contiguous()
    pos = torch.arange(kc.shape[2], device=dev)
    qi = torch.arange(nq_tok, device=dev)
    mask = (pos[None, None, :] < (hi0[:, None] + qi[None, :])[:, :, None]) & ~dead[:, :, None]
    q4 = q.transpose(1, 2).contiguous()  # [B, n_q, Q, d]
    times = timings(
        lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql),
        lambda: pca.paged_chunk_attention_reference(q, k, v, pt, hi0, ql),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask[:, None],
                                               enable_gqa=True),
        iters=10,
    )
    bound_ms, bound_by = _k3_bound(s, 2)
    log(f"[kernel] K3 bf16 B={b} Q={nq_tok}: kernel_ms={times['kernel_ms']:.4f} "
        f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
        f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
        f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
        f"bound_ms={bound_ms:.5f} ({bound_by}); {int((~dead).sum())} live queries")
    report["k3"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by, **times)
    # bf16 q over the int8 pool at the replay shape (the resume replay of
    # an int8 serving plane): held in _hold_k3; here one call under the
    # sync debug mode, then its times beside SDPA over the windows
    # dequantized to bf16; the bound reads one byte a K/V element and its
    # bf16 scale.
    from areal_tpu_torch.ops.quant import kv_dequant

    q8, k8, v8, ks8, vs8 = cases["bf16q_int8"][:5]
    no_host_sync("K3 bf16q_int8",
                 lambda: pca.paged_decode_attention_chunk(q8, k8, v8, pt, hi0, ql, ks8, vs8))
    kd = kv_dequant(paged_gather_layer(k8, pt), paged_gather_layer(ks8, pt), torch.bfloat16)
    vd = kv_dequant(paged_gather_layer(v8, pt), paged_gather_layer(vs8, pt), torch.bfloat16)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    times8 = timings(
        lambda: pca.paged_decode_attention_chunk(q8, k8, v8, pt, hi0, ql, ks8, vs8),
        lambda: pca.paged_chunk_attention_reference(q8, k8, v8, pt, hi0, ql, ks8, vs8),
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask[:, None],
                                               enable_gqa=True),
        iters=10,
    )
    bound8, by8 = _k3_bound(s, 2, kv_bytes=q.shape[-1] + 2)
    log(f"[kernel] K3 bf16q_int8 B={b} Q={nq_tok}: row_err="
        f"{errs['bf16q_int8_row']:.3e}, against the tiled model "
        f"{errs['bf16q_int8_tiled_row']:.3e} (tolerance {FLASH_ROW_TOL['bf16']:.3e}), "
        f"beyond the output's rounding {errs['bf16q_int8_model']:.3e} (tolerance "
        f"{MODEL_TOL:g}); "
        f"kernel_ms={times8['kernel_ms']:.4f} plain_ms={times8['plain_ms']:.4f} library_ms="
        f"{times8['library_ms']:.4f} (device, graph replays); eager calls kernel="
        f"{times8['kernel_eager_ms']:.4f} plain={times8['plain_eager_ms']:.4f} library="
        f"{times8['library_eager_ms']:.4f}; bound_ms={bound8:.5f} ({by8})")
    report["k3"]["bf16q_int8"] = dict(
        row_err=errs["bf16q_int8_row"], max_abs_err=errs["bf16q_int8"],
        row_err_tiled=errs["bf16q_int8_tiled_row"], model_err=errs["bf16q_int8_model"],
        bound_ms=bound8, bound_by=by8, **times8)


def _k4_cases(seed):
    """K4's inputs at qwen2-1.5B's attention shape (Hq=12, Hkv=2, D=128).
    decode: the static path's decode step — 32 rows of a S=1024 cache,
    prompts of 64..512 right-aligned at 512 (valid_from = 512 - prompt),
    64 tokens generated, so the window ends at valid_to = 576.  chunk:
    the same rows with Q=4 queries, the last seeing to 576.  w1280: a
    window of 1280 positions (no tile of 32 or block of 512 divides what
    the rows see), rows 2 and 3 empty.  empty: Q=2, rows 0-2 empty for
    both queries, row 3 for its first query only.  edges: windows of the
    256-position span +-1 (and 2 spans +-1, 1 and 0 positions) from
    random starts.  one_span: S=256, a single span (the split pass writes
    the output, no merge), Q=2, row 2's first query empty.  Returns
    {name: (q [B, Q, 12, 128], valid_from [B], valid_to0 [B], S)}."""
    import numpy as np

    rng = np.random.default_rng(seed + 31)
    n_q, d = 12, 128
    plen = rng.integers(64, 513, 32)
    plen[:2] = (64, 512)
    vf = (512 - plen).astype(np.int32)
    cases = {
        "decode": (1, vf, np.full(32, 576, np.int32), 1024),
        "chunk": (4, vf, np.full(32, 573, np.int32), 1024),
    }
    vf_w = rng.integers(0, 256, 4).astype(np.int32)
    vt_w = np.array([1280, 1031, 0, 5], np.int32)
    vf_w[3] = 9  # rows 2 and 3: valid_from >= valid_to
    cases["w1280"] = (1, vf_w, vt_w, 1280)
    vf_e = rng.integers(0, 300, 8).astype(np.int32)
    vt_e = rng.integers(300, 1000, 8).astype(np.int32)
    vf_e[:3] = (1000, 1023, 700)
    vt_e[:3] = (40, 1000, 699)  # every query of rows 0-2 empty
    vf_e[3], vt_e[3] = 500, 500  # query 0 empty, query 1 sees [500, 501)
    cases["empty"] = (2, vf_e, vt_e, 1024)
    vf_s = rng.integers(0, 200, 8).astype(np.int32)
    lens = np.array([255, 256, 257, 511, 512, 513, 1, 0], np.int32)
    cases["edges"] = (1, vf_s, vf_s + lens, 1024)
    cases["one_span"] = (2, np.array([0, 5, 100, 250], np.int32),
                         np.array([255, 200, 100, 255], np.int32), 256)
    return {
        name: (rng.standard_normal((len(f), nq, n_q, d)).astype(np.float32), f, t, S)
        for name, (nq, f, t, S) in cases.items()
    }


def _k4_windows(vf, vt0, nq, S):
    """[B, Q, S] bool: query i of row b sees [vf[b], vt0[b] + i) within S."""
    import torch

    pos = torch.arange(S, device=vf.device)
    hi = (vt0[:, None] + torch.arange(nq, device=vf.device)[None, :]).clamp(max=S)
    return (pos[None, None, :] >= vf[:, None, None]) & (pos[None, None, :] < hi[:, :, None])


def _k4_bound(vf, vt0, nq, S, n_q, n_kv, d, elem_bytes, kv_bytes=None):
    """Least time for K4 on these rows: the flops of QK and PV over each
    query's live window at the bf16 tensor rate, against each row's live
    K/V positions (the union of its queries' windows, read once for all
    its queries and heads; `kv_bytes` a position and kv head of K, and of
    V, default d * elem_bytes), q in, out back and the two window bounds,
    at the HBM rate."""
    flops = kv_pos = 0
    for f, t in zip(vf.tolist(), vt0.tolist()):
        lens = [max(0, min(t + i, S) - max(f, 0)) for i in range(nq)]
        flops += sum(4 * d * n_q * n for n in lens)
        kv_pos += max(lens)
    b = len(vf)
    nbytes = (2 * kv_pos * n_kv * (kv_bytes or d * elem_bytes)
              + 2 * b * nq * n_q * d * elem_bytes + 2 * b * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _kernel_k4(report, seed):
    """K4 against its plain version (`decode_attention_chunk` with every
    query live) and its split reference (at the kernel's span) on fp32
    copies of the same inputs, for each case of _k4_cases and fp32, bf16
    and int8 caches: each output row within FLASH_ROW_TOL of that row's
    largest |plain| value (int8: the fp32 bound), empty windows exactly
    0, K/V poisoned at every position outside every window of its row
    changing nothing; bf16 q over the int8 cache (the tensor-core int8
    path) also, within the bf16 row tolerance of the plain version and
    within MODEL_TOL of the split reference.  Then, at the decode case in bf16 (B=32, and the
    static phase's B=64), the times of K4, its plain version and SDPA on
    the same dense window with the boolean mask, and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.ops.attention import decode_attention_chunk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 32)
    bf = torch.bfloat16
    n_kv, d = 2, 128
    errs, n_zero = {}, 0
    for cname, (q_np, vf_np, vt_np, S) in _k4_cases(seed).items():
        b, nq = q_np.shape[:2]
        span, n_splits = da.split_plan(S)
        shape = (b, S, n_kv, d)
        base = {
            "q": torch.from_numpy(q_np).to(dev),
            "k": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            "v": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            "k8": torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev),
            "v8": torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev),
            "ks": torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
                  .to(dev).to(bf),
            "vs": torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
                  .to(dev).to(bf),
        }
        vf, vt = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
        win = _k4_windows(vf, vt, nq, S)  # [B, Q, S]
        empty = ~win.any(-1)  # [B, Q]
        outside = ~win.any(1)  # [B, S]: no query of the row sees it
        full = torch.full((b,), nq, dtype=torch.long, device=dev)
        cases = {
            "fp32": (base["q"], base["k"], base["v"], None, None, FLASH_ROW_TOL["fp32"]),
            "bf16": (base["q"].to(bf), base["k"].to(bf), base["v"].to(bf), None, None,
                     FLASH_ROW_TOL["bf16"]),
            "int8": (base["q"], base["k8"], base["v8"], base["ks"], base["vs"],
                     FLASH_ROW_TOL["fp32"]),
            "bf16q_int8": (base["q"].to(bf), base["k8"], base["v8"], base["ks"], base["vs"],
                           FLASH_ROW_TOL["bf16"]),
        }
        for tname, (q, k, v, ksc, vsc, tol) in cases.items():
            out = da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc)
            f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
            ref = decode_attention_chunk(
                q.float(), f32(k), f32(v), vf.long(), vt.long(), full, ksc, vsc
            )
            # The split reference takes the kernel's own q: its type picks
            # the arithmetic (bf16 q over int8 runs on the tensor cores).
            quant_mma = tname == "bf16q_int8"
            split = da.decode_attention_chunk_split_reference(
                q if quant_mma else q.float(), f32(k), f32(v), vf, vt, ksc, vsc, span=span
            )
            torch.cuda.synchronize()
            tag = f"{cname} {tname}"
            check(bool(torch.isfinite(out).all()), f"K4 {tag}: non-finite output")
            rel, err = _row_err(out, ref)
            rel_s = _model_err(out, split) if quant_mma else _row_err(out, split)[0]
            tol_s = MODEL_TOL if quant_mma else tol
            errs[f"{tname}_{cname}"], errs[f"{tname}_{cname}_row"] = err, rel
            errs[f"{tname}_{cname}_split_row"] = rel_s
            check(rel <= tol, f"K4 {tag} disagrees with the plain version: {rel:.3e}")
            check(rel_s <= tol_s,
                  f"K4 {tag} disagrees with the split reference: {rel_s:.3e}")
            if bool(empty.any()):
                check(float(out.float()[empty].abs().max()) == 0.0,
                      f"K4 {tag}: empty windows are not exactly 0")
                n_zero += int(empty.sum())
            k_bad, v_bad = k.clone(), v.clone()
            ks_bad, vs_bad = ksc, vsc
            if k.dtype == torch.int8:
                k_bad[outside], v_bad[outside] = 127, 127
                ks_bad, vs_bad = ksc.clone(), vsc.clone()
                ks_bad[outside], vs_bad[outside] = 1e9, 1e9
            else:
                k_bad[outside], v_bad[outside] = 1e9, 1e9
            out_bad = da.decode_attention_chunk_kernel(q, k_bad, v_bad, vf, vt, ks_bad, vs_bad)
            check(torch.equal(out, out_bad),
                  f"K4 {tag}: poisoning positions outside every window changed the output")
            log(f"[kernel] K4 {tag}: B={b} Q={nq} S={S} ({n_splits} span(s)) "
                f"row_err={rel:.3e} (tolerance {tol:.3e}), against the split reference "
                f"{rel_s:.3e} (tolerance {tol_s:.3e}"
                + (", beyond the output's rounding" if quant_mma else "")
                + f") max_abs_err={err:.3e}")
    log(f"[kernel] K4: {n_zero} empty-window query rows exactly 0; poisoned positions "
        f"outside every window changed nothing")
    # Times at the static path's decode shape, bf16 q and cache: the
    # decode case's 32 rows, then 64 rows (the static phase's batch) with
    # the same window rule.  Library yardstick: SDPA over the same dense
    # window, boolean mask, GQA native.
    q_np, vf_np, vt_np, S = _k4_cases(seed)["decode"]
    plen = rng.integers(64, 513, 64)
    per_b = {32: (q_np, vf_np, vt_np),
             64: (rng.standard_normal((64, 1, 12, d)).astype(np.float32),
                  (512 - plen).astype(np.int32), np.full(64, 576, np.int32))}
    for b, (q_np, vf_np, vt_np) in per_b.items():
        q = torch.from_numpy(q_np).to(dev).to(bf)
        k, v = (torch.from_numpy(rng.standard_normal((b, S, n_kv, d)).astype(np.float32))
                .to(dev).to(bf) for _ in range(2))
        vf, vt = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
        full = torch.full((b,), 1, dtype=torch.long, device=dev)
        if b == 32:
            no_host_sync("K4", lambda: da.decode_attention_kernel(q, k, v, vf, vt))
        mask = _k4_windows(vf, vt, 1, S)[:, None]  # [B, 1, 1, S]
        q4 = q.transpose(1, 2).contiguous()  # [B, 12, 1, D]
        kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        times = timings(
            lambda: da.decode_attention_kernel(q, k, v, vf, vt),
            lambda: decode_attention_chunk(q, k, v, vf.long(), vt.long(), full),
            lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                   enable_gqa=True),
            iters=10,
        )
        bound_ms, bound_by = _k4_bound(vf_np, vt_np, 1, S, 12, n_kv, d, 2)
        log(f"[kernel] K4 bf16 decode B={b} S={S}: kernel_ms={times['kernel_ms']:.4f} "
            f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
            f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
            f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
            f"bound_ms={bound_ms:.5f} ({bound_by}); {int((vt_np - vf_np).sum())} live "
            f"positions")
        if b == 32:
            report["k4"] = dict(max_abs_err=errs, bound_ms=bound_ms, bound_by=bound_by,
                                **times)
        else:
            report["k4"]["b64"] = dict(bound_ms=bound_ms, **times)


def _kernel_k3_q1(report, seed):
    """K3's Q=1 entry point (`paged_decode_attention_kernel`: the
    two-program path's decode attention, one query a slot), which runs
    K2's kernel, at the paged-decode shape: 16 and 64 slots, windows
    64-640 over shuffled pages of 128, a 6-page table.  The chunk kernel
    at Q=1 held as _hold_k3 holds it (fp32, bf16, int8 pools with fp32
    and with bf16 q; poison); then for the first four (bf16 q over the
    int8 pool: decode_step_paged's int8 form) the wrapper equal to K2's
    wrapper on the same inputs and within the row tolerance of the plain
    `paged_decode_attention` (on an fp32 copy of q), the bf16-q int8 form
    also within MODEL_TOL of K2's split reference; one call under the
    sync debug mode; then, for bf16 and bf16 q over int8, the times of
    the wrapper, the plain version and SDPA over the gathered windows
    (dequantized to bf16 for int8), beside the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import paged_decode_attention, paged_gather_layer
    from areal_tpu_torch.ops.quant import kv_dequant

    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(seed + 41)
    out = {}
    for b in (16, 64):
        L = rng.integers(64, 641, b)
        L[:2] = (64, 640)
        s = _k3_slots(rng, 1, L, np.ones(b, np.int32), [-(-int(x) // 128) for x in L], 6)
        errs, cases, t = _hold_k3(f"Q=1 B={b}", s)
        pt, vt = t["pt"], t["hi0"]
        cases = {name: cases[name][:6] for name in ("fp32", "bf16", "int8", "bf16q_int8")}
        span_pages, _ = rpa.split_plan(pt.shape[1], t["k8"].shape[1], b * t["k8"].shape[2])
        for name, (q, k, v, ksc, vsc, tol) in cases.items():
            got = pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc)
            k2 = rpa.ragged_paged_attention_kernel(q[:, 0], k, v, pt, vt, ksc, vsc)[:, None]
            f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
            plain = paged_decode_attention(q.float(), f32(k), f32(v), pt, vt, ksc, vsc)
            rel, err = _row_err(got, plain)
            errs[f"{name}_q1_row"], errs[f"{name}_q1"] = rel, err
            check(torch.equal(got, k2), f"K3 Q=1 B={b} {name}: the wrapper is not K2's "
                  "kernel on the same inputs")
            check(rel <= tol, f"K3 Q=1 B={b} {name} disagrees with paged_decode_attention: "
                  f"{rel:.3e}")
            if name == "bf16q_int8":
                model = rpa.ragged_paged_attention_split_reference(
                    q[:, 0], k, v, pt, vt, ksc, vsc, span=span_pages * k.shape[1])[:, None]
                rel_m = _model_err(got, model)
                errs[f"{name}_q1_model"] = rel_m
                check(rel_m <= MODEL_TOL, f"K3 Q=1 B={b} {name} disagrees with K2's split "
                      f"reference: {rel_m:.3e}")
            log(f"[kernel] K3 Q=1 B={b} {name}: the wrapper is K2's kernel (equal); row_err="
                f"{rel:.3e} against paged_decode_attention (tolerance {tol:.3e})"
                + (f", {rel_m:.3e} against K2's split reference beyond the output's rounding "
                   f"(tolerance {MODEL_TOL:g})" if name == "bf16q_int8" else ""))
        res = dict(max_abs_err=errs)
        for name in ("bf16", "bf16q_int8"):
            q, k, v, ksc, vsc = cases[name][:5]
            no_host_sync(f"K3 Q=1 B={b} {name}",
                         lambda: pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc))
            kc, vc = paged_gather_layer(k, pt), paged_gather_layer(v, pt)  # [B, S, n_kv, d]
            if ksc is not None:
                kc = kv_dequant(kc, paged_gather_layer(ksc, pt), bf)
                vc = kv_dequant(vc, paged_gather_layer(vsc, pt), bf)
            kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            mask = (torch.arange(kc.shape[2], device=dev)[None, :] < vt[:, None])[:, None, None, :]
            q4 = q.transpose(1, 2).contiguous()  # [B, n_q, 1, d]
            times = timings(
                lambda: pca.paged_decode_attention_kernel(q, k, v, pt, vt, ksc, vsc),
                lambda: paged_decode_attention(q, k, v, pt, vt, ksc, vsc),
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                       enable_gqa=True),
                iters=10,
            )
            bound_ms, bound_by = _k3_bound(s, 2, kv_bytes=k.shape[-1] + 2 if ksc is not None
                                           else None)
            log(f"[kernel] K3 Q=1 {name} B={b}: kernel_ms={times['kernel_ms']:.4f} "
                f"plain_ms={times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
                f"(device, graph replays); eager calls kernel={times['kernel_eager_ms']:.4f} "
                f"plain={times['plain_eager_ms']:.4f} library={times['library_eager_ms']:.4f}; "
                f"bound_ms={bound_ms:.5f} ({bound_by}); {int(L.sum())} live positions")
            entry = dict(bound_ms=bound_ms, bound_by=bound_by, **times)
            if name == "bf16":
                res.update(entry)
            else:
                res[name] = entry
        out[b] = res
    report["k3"]["q1"] = out


def _kernel_k4_inflight(report, seed):
    """K4 at the dense inflight window's shapes: 16 left-aligned rows of a
    S=1024 cache, windows [0, L) with L 64-640.  Q=1 and Q=5 with bf16 q
    over an int8 cache and bf16 scales (decode_step_inflight's and
    decode_step_spec's int8 forms), and Q=5 in bf16 (decode_step_spec at
    K=4: query j sees [0, L + j)).  Each held against
    `decode_attention_chunk` on the same inputs (q in fp32) within the
    bf16 row tolerance, the int8 forms also within MODEL_TOL of the split
    reference, positions past every window poisoned changing nothing;
    one call under the sync debug mode; then the times of K4, its plain
    version and SDPA (over the window dequantized to bf16 for the int8
    forms), beside the bound (int8: one byte a K/V element plus its row's
    bf16 scale)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.ops.attention import decode_attention_chunk
    from areal_tpu_torch.ops.quant import kv_dequant

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 42)
    b, S, n_q, n_kv, d = GENMODE_SLOTS, 1024, 12, 2, 128
    bf = torch.bfloat16
    L = rng.integers(64, 641, b).astype(np.int32)
    L[:2] = (64, 640)
    vf = torch.zeros(b, dtype=torch.int32, device=dev)
    vt = torch.from_numpy(L).to(dev)
    shape = (b, S, n_kv, d)
    k8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
    v8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
    ks, vs = (torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
              .to(dev).to(bf) for _ in range(2))
    k16, v16 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(bf)
                for _ in range(2))
    out = {}
    span = da.split_plan(S)[0]
    for tag, nq, k, v, ksc, vsc in (("int8_q1", 1, k8, v8, ks, vs),
                                    ("int8_q5", 5, k8, v8, ks, vs),
                                    ("q5", 5, k16, v16, None, None)):
        q = torch.from_numpy(rng.standard_normal((b, nq, n_q, d)).astype(np.float32)).to(dev)
        q = q.to(bf)
        full = torch.full((b,), nq, dtype=torch.long, device=dev)
        got = da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc)
        f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
        plain = decode_attention_chunk(q.float(), f32(k), f32(v), vf.long(), vt.long(), full,
                                       ksc, vsc)
        rel, err = _row_err(got, plain)
        check(bool(torch.isfinite(got).all()), f"K4 {tag}: non-finite output")
        check(rel <= FLASH_ROW_TOL["bf16"], f"K4 {tag} disagrees with the plain version: "
              f"{rel:.3e}")
        rel_m = None
        if ksc is not None:  # the tensor-core int8 path against its model
            rel_m = _model_err(got, da.decode_attention_chunk_split_reference(
                q, k, v, vf, vt, ksc, vsc, span=span))
            check(rel_m <= MODEL_TOL, f"K4 {tag} disagrees with the split reference: "
                  f"{rel_m:.3e}")
        outside = ~_k4_windows(vf, vt, nq, S).any(1)  # [B, S]
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[outside], v_bad[outside] = (127, 127) if k.dtype == torch.int8 else (1e4, 1e4)
        check(torch.equal(got, da.decode_attention_chunk_kernel(q, k_bad, v_bad, vf, vt,
                                                               ksc, vsc)),
              f"K4 {tag}: poisoning positions outside every window changed the output")
        no_host_sync(f"K4 {tag}", lambda: da.decode_attention_chunk_kernel(q, k, v, vf, vt,
                                                                          ksc, vsc))
        kd = kv_dequant(k, ksc, bf) if ksc is not None else k
        vd = kv_dequant(v, vsc, bf) if vsc is not None else v
        kc, vc = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        mask = _k4_windows(vf, vt, nq, S)[:, None]  # [B, 1, Q, S]
        q4 = q.transpose(1, 2).contiguous()
        times = timings(
            lambda: da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc),
            lambda: decode_attention_chunk(q, k, v, vf.long(), vt.long(), full, ksc, vsc),
            lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True),
            iters=10,
        )
        kv_bytes = d + 2 if k.dtype == torch.int8 else 2 * d
        bound_ms, bound_by = _k4_bound(np.zeros(b, np.int32), L, nq, S, n_q, n_kv, d, 2,
                                       kv_bytes=kv_bytes)
        log(f"[kernel] K4 {tag} B={b} Q={nq} S={S}: row_err={rel:.3e} (tolerance "
            f"{FLASH_ROW_TOL['bf16']:.3e})"
            + (f", against the split reference {rel_m:.3e} beyond the output's rounding "
               f"(tolerance {MODEL_TOL:g})" if rel_m is not None else "")
            + f" max_abs_err={err:.3e}; kernel_ms="
            f"{times['kernel_ms']:.4f} plain_ms={times['plain_ms']:.4f} library_ms="
            f"{times['library_ms']:.4f} (device, graph replays); eager calls kernel="
            f"{times['kernel_eager_ms']:.4f} plain={times['plain_eager_ms']:.4f} library="
            f"{times['library_eager_ms']:.4f}; bound_ms={bound_ms:.5f} ({bound_by})")
        out[tag] = dict(row_err=rel, max_abs_err=err, model_err=rel_m, bound_ms=bound_ms,
                        bound_by=bound_by, **times)
    report["k4"].update(out)


# --------------------------------------------------------------------------
# Phase: flash attention forward and backward against the plain version
# --------------------------------------------------------------------------


def _packed_rows(rng, b, s, lo=64, hi=640):
    """Segment ids [b, s]: rows 0..b-2 filled with segments of lo..hi
    tokens (a row's tail that cannot take a segment of lo stays padding),
    row b-1 all padding.  Returns (seg, per-segment lengths)."""
    import numpy as np

    seg = np.zeros((b, s), np.int32)
    lens = []
    for r in range(b - 1):
        off, sid = 0, 1
        while s - off >= lo:
            n = min(int(rng.integers(lo, hi + 1)), s - off)
            seg[r, off : off + n] = sid
            lens.append(n)
            off += n
            sid += 1
    return seg, lens


def _flash_bounds(lens, b, s, hq, hkv, d, elem):
    """Least times for K1f, K1dq, K1dkv at these segment lengths: the
    causal-within-segment flops (fwd 4d, dq 6d, dkv 8d per attended pair
    and q head) at the bf16 tensor rate, against every input read once
    and every output written once at the HBM rate."""
    pairs = sum(n * (n + 1) // 2 for n in lens)
    q_b = b * s * hq * d * elem
    kv_b = b * s * hkv * d * elem
    row_b = b * s * hq * 4  # lse or delta
    seg_b = b * s * 4
    work = {
        "fwd": (4 * d * hq * pairs, q_b + 2 * kv_b + seg_b + q_b + row_b),
        "dq": (6 * d * hq * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + seg_b + q_b),
        "dkv": (8 * d * hq * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + seg_b + 2 * kv_b),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes")
    return out


# Tolerances of the flash kernels against their plain versions, per
# output row (one position's head vector, D values) and relative to that
# row's largest |plain| value: fp32 differs by summation order only; a
# bf16 output is rounded once, to within half an ulp (2**-8 of each
# element's magnitude).  The bf16 bound is twice that rounding.
FLASH_ROW_TOL = {"fp32": 1e-4, "bf16": 2**-7}


def _row_err(got, want):
    """(largest error of a row relative to that row's largest |want|,
    largest absolute error).  A row smaller than the output's RMS (over
    its non-zero rows) takes the RMS instead: a row that is 0 in exact
    arithmetic, such as dq at a segment's first position (ds = P(dP - Δ)
    cancels there), carries only the rounding of its larger terms."""
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs().amax(-1)
    mag = w.abs().amax(-1)
    live = w[mag > 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 1.0
    return float((err / mag.clamp_min(rms)).max()), float(err.max())


# The split kernels' bf16-q int8 forms against their model
# (`split_window_attention`, fp32): the kernel's result before its one
# rounding to bf16 within MODEL_TOL of the row's magnitude.
MODEL_TOL = 1e-3


def _model_err(got, model):
    """Largest row error of a bf16 kernel output against its fp32 model
    beyond the output's rounding: each element's |got - model| less half
    a bf16 ulp of the larger of the two magnitudes, over the row's
    largest |model| (rows under the output's RMS take the RMS, as in
    _row_err)."""
    import torch

    g, w = got.detach().float(), model.detach().float()
    _, exp = torch.frexp(torch.maximum(g.abs(), w.abs()))
    half_ulp = torch.ldexp(torch.ones_like(w), exp - 9)  # bf16: 8 significant bits
    err = ((g - w).abs() - half_ulp).clamp_min(0).amax(-1)
    mag = w.abs().amax(-1)
    live = w[mag > 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 1.0
    return float((err / mag.clamp_min(rms)).max())


def _hold_flash(tag, q, k, v, seg, do, row_tol):
    """K1f, then K1dq and K1dkv through autograd, on (q, k, v, seg) with
    upstream gradient `do`.  Each kernel is held against its plain version
    on fp32 copies of the same (already rounded) inputs: o against
    `packed_attention_reference`, dq/dk/dv against `flash_bwd_reference`
    given the same Δ = rowsum(o∘dO) of the kernel's o.  Each output must
    lie within `row_tol` per row (see _row_err), be finite, and be exactly
    0 at padding.  In fp32 the gradients are also held against autograd
    through the plain forward; in bf16 that reading differs by design (Δ
    of the bf16 o, as the JAX kernel's `_bwd` has it) and is only printed.
    Returns {output: (row_err, max_abs_err)}."""
    import torch

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import packed_attention_reference

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention(q, k, v, seg)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    qr, kr, vr = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    o_ref = packed_attention_reference(qr, kr, vr, seg)
    plain_bwd = fa.flash_bwd_reference(qr, kr, vr, seg, do, fa.flash_delta(o, do))
    autograd = torch.autograd.grad(o_ref, (qr, kr, vr), do.float())
    torch.cuda.synchronize()
    pad = seg == 0
    out = {}
    for name, got, want, auto in (
        ("o", o, o_ref, None),
        ("dq", dq, plain_bwd[0], autograd[0]),
        ("dk", dk, plain_bwd[1], autograd[1]),
        ("dv", dv, plain_bwd[2], autograd[2]),
    ):
        check(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite")
        rel, err = _row_err(got, want)
        out[name] = (rel, err)
        line = (f"[flash] {tag} {name}: row_err={rel:.3e} (tolerance {row_tol:.3e}) "
                f"max_abs_err={err:.3e}")
        if auto is not None:
            auto_rel, auto_err = _row_err(got, auto)
            line += f"; against autograd: row_err={auto_rel:.3e} max_abs_err={auto_err:.3e}"
            if q.dtype == torch.float32:
                check(auto_rel <= row_tol, f"{tag} {name} disagrees with autograd")
        log(line)
        check(rel <= row_tol, f"{tag} {name} disagrees with the plain version")
        check(float(got.detach().float()[pad].abs().max()) == 0.0,
              f"{tag} {name}: padding positions are not exactly 0")
    return out


# lse is fp32 in every kernel and in its plain version (the dense
# logsumexp of the same rounded inputs): they differ by summation order.
# Tolerance on |got - want| / max(1, |want|), over rows that attend.
FLASH_LSE_TOL = 1e-4


def _dense_lse(q, k, seg, causal):
    """logsumexp of each row's masked fp32 logits, [B, S, Hq]."""
    import torch

    from areal_tpu_torch.ops.attention import make_packed_mask, repeat_kv

    logits = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), repeat_kv(k.float(), q.shape[2] // k.shape[2])
    ) * q.shape[-1] ** -0.5
    mask = make_packed_mask(seg, causal=causal)
    return torch.logsumexp(torch.where(mask, logits, -math.inf), -1).transpose(1, 2)


def _lse_err(got, want, seg):
    real = (seg > 0)[..., None].expand_as(want)
    diff = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1.0)
    return float(diff[real].max())


def _flash_edges(seed, cases=None, tag="[flash]"):
    """K1f, K1dq and K1dkv at their edges: three rows of S=256 packed with
    segments of 1, 63, 64 and 65 positions then padding; 127 and 129; 128
    then padding; rep 6 (Hq=12, Hkv=2) and rep 1 (Hq=Hkv=2), causal and
    not, at D=128; one row of S=40 (segments of 1, 23 and 9 then padding:
    a tail shorter than a tile), rep 2 (Hq=4, Hkv=2), causal and not; and
    the S=256 rows at D=64, rep 6, causal (or `cases`: (rows, hq, hkv, d,
    causal) with rows "seg256" or "seg40"); each in fp32 and bf16 (the
    bf16 forward runs 3, 2 or 1 q heads a block for rep 6, 2 and 1).  o,
    lse, then dq and dk, dv given that lse and Δ of that o: each row within
    FLASH_ROW_TOL of its plain version (packed_attention_reference,
    flash_bwd_reference) and, in bf16, of the kernels' models
    (flash_fwd_bf16_reference, flash_dq_bf16_reference,
    flash_dkv_bf16_reference); lse within FLASH_LSE_TOL of the dense
    logsumexp (and of the model's in bf16); padding rows exactly 0, and
    lse -1e30 there.  Returns the largest row errors."""
    import numpy as np
    import torch

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import packed_attention_reference

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)

    def rows(s, layouts):
        seg_np = np.zeros((len(layouts), s), np.int32)
        for r, lens in enumerate(layouts):
            off = 0
            for sid, n in enumerate(lens, 1):
                seg_np[r, off : off + n] = sid
                off += n
        return torch.from_numpy(seg_np).to(dev)

    segs = {"seg256": rows(256, ((1, 63, 64, 65), (127, 129), (128,))),
            "seg40": rows(40, ((1, 23, 9),))}
    if cases is None:
        cases = [("seg256", hq, hkv, 128, causal) for hq, hkv in ((12, 2), (2, 2))
                 for causal in (True, False)]
        cases += [("seg40", 4, 2, 128, causal) for causal in (True, False)]
        cases += [("seg256", 12, 2, 64, True)]
    worst = {}
    for seg_name, hq, hkv, d, causal in cases:
        seg = segs[seg_name]
        b, s = seg.shape
        pad = seg == 0
        base = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                .to(dev) for h in (hq, hkv, hkv, hq)]
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, do = (x.to(dtype) for x in base)
            o, lse = fa.flash_fwd(q, k, v, seg, causal)
            delta = fa.flash_delta(o, do)
            dq = fa.flash_dq(q, k, v, seg, do, lse, delta, causal)
            dk, dv = fa.flash_dkv(q, k, v, seg, do, lse, delta, causal)
            got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
            rq, rk, rv = fa.flash_bwd_reference(q, k, v, seg, do, delta, causal)
            held = [("plain", {
                "o": packed_attention_reference(q.float(), k.float(), v.float(), seg,
                                                causal=causal),
                "dq": rq, "dk": rk, "dv": rv}, _dense_lse(q, k, seg, causal))]
            if dtype == torch.bfloat16:
                mo, mlse = fa.flash_fwd_bf16_reference(q, k, v, seg, causal)
                mk, mv = fa.flash_dkv_bf16_reference(q, k, v, seg, do, lse, delta, causal)
                held.append(("bf16 model", {
                    "o": mo, "dq": fa.flash_dq_bf16_reference(q, k, v, seg, do, lse, delta,
                                                              causal),
                    "dk": mk, "dv": mv}, mlse))
            torch.cuda.synchronize()
            name = f"S={s} D={d} rep{hq // hkv} {'causal' if causal else 'full'} {tag}"
            parts = []
            for ref_name, want, want_lse in held:
                suffix = "_model" if ref_name != "plain" else ""
                for out, g in got.items():
                    rel, _ = _row_err(g, want[out])
                    key = f"{tag}_{out}{suffix}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    parts.append(f"{out} {rel:.3e}")
                    check(rel <= FLASH_ROW_TOL[tag],
                          f"K1 edges {name}: {out} disagrees with the {ref_name}: {rel:.3e}")
                lerr = _lse_err(lse, want_lse, seg)
                worst[f"{tag}_lse{suffix}"] = max(worst.get(f"{tag}_lse{suffix}", 0.0), lerr)
                parts.append(f"lse {lerr:.3e}")
                check(lerr <= FLASH_LSE_TOL,
                      f"K1 edges {name}: lse disagrees with the {ref_name}: {lerr:.3e}")
            for out, g in got.items():
                check(bool(torch.isfinite(g).all()), f"K1 edges {name}: {out} non-finite")
                check(float(g.float()[pad].abs().max()) == 0.0,
                      f"K1 edges {name}: {out} at padding is not exactly 0")
            check(bool((lse[pad] == fa.KERNEL_NEG).all()),
                  f"K1 edges {name}: lse at padding is not -1e30")
            log(f"{tag} K1 edges {name}: row_err against "
                + ", ".join(r[0] for r in held) + ": " + ", ".join(parts)
                + f" (tolerance {FLASH_ROW_TOL[tag]:.3e}, lse {FLASH_LSE_TOL:g}); "
                "padding exactly 0")
    return worst


def phase_flash(report, seed):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import make_packed_mask, packed_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    b, s, hq, hkv, d = 4, 2048, 12, 2, 128
    seg_np, lens = _packed_rows(rng, b, s)
    seg = torch.from_numpy(seg_np).to(dev)
    base = {
        name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        for name, shape in (
            ("q", (b, s, hq, d)), ("k", (b, s, hkv, d)), ("v", (b, s, hkv, d)),
            ("do", (b, s, hq, d)),
        )
    }
    errs = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (base[n].to(dtype) for n in ("q", "k", "v", "do"))
        fa.reset_launches()
        held = _hold_flash(tag, q, k, v, seg, do, FLASH_ROW_TOL[tag])
        check(fa.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1},
              f"{tag}: launches {fa.LAUNCHES}")
        for name, (rel, err) in held.items():
            errs[f"{tag}_{name}"] = err
            errs[f"{tag}_{name}_row"] = rel
    errs.update({f"edges_{key}": val for key, val in _flash_edges(seed).items()})

    # The main path's dtype (bf16): the tensor-core kernels against their
    # models, the sync checks, then the times.
    q, k, v, do = (base[n].to(torch.bfloat16) for n in ("q", "k", "v", "do"))
    seg32 = seg.to(torch.int32).contiguous()
    o, lse = fa.flash_fwd(q, k, v, seg32, True)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, seg32, do, lse, delta, True)
    dk, dv = fa.flash_dkv(q, k, v, seg32, do, lse, delta, True)
    mo, mlse = fa.flash_fwd_bf16_reference(q, k, v, seg)
    lerr = _lse_err(lse, mlse, seg)
    errs["bf16_lse_model"] = lerr
    log(f"[flash] bf16 lse against the kernel's model (flash_fwd_bf16_reference): "
        f"err={lerr:.3e} (tolerance {FLASH_LSE_TOL:g})")
    check(lerr <= FLASH_LSE_TOL, "bf16 lse disagrees with the kernel's model")
    models = {
        "flash_fwd_bf16_reference": lambda: {"o": mo},
        "flash_dq_bf16_reference": lambda: {
            "dq": fa.flash_dq_bf16_reference(q, k, v, seg, do, lse, delta)},
        "flash_dkv_bf16_reference": lambda: dict(zip(
            ("dk", "dv"), fa.flash_dkv_bf16_reference(q, k, v, seg, do, lse, delta))),
    }
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    for model, outputs in models.items():
        for name, want in outputs().items():
            rel, _ = _row_err(got[name], want)
            errs[f"bf16_{name}_model_row"] = rel
            log(f"[flash] bf16 {name} against the kernel's model ({model}): "
                f"row_err={rel:.3e} (tolerance {FLASH_ROW_TOL['bf16']:.3e})")
            check(rel <= FLASH_ROW_TOL["bf16"],
                  f"bf16 {name} disagrees with the kernel's model")
    del got, dq, dk, dv, mo, mlse
    kernels = {
        "fwd": lambda: fa.flash_fwd(q, k, v, seg32, True),
        "dq": lambda: fa.flash_dq(q, k, v, seg32, do, lse, delta, True),
        "dkv": lambda: fa.flash_dkv(q, k, v, seg32, do, lse, delta, True),
    }
    for name, fn in kernels.items():
        no_host_sync(f"K1{name}", fn)
    # Plain versions: packed_attention_reference (fwd) and
    # flash_bwd_reference (dq, dk and dv together, given Δ).  Library
    # yardstick: SDPA with the packed boolean mask (GQA native); its
    # backward (dq, dk and dv together) is the graph of forward+backward
    # less the forward's.
    mask = make_packed_mask(seg)
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    def plain_bwd():
        return fa.flash_bwd_reference(q, k, v, seg, do, delta)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)

    times = {
        "fwd": timings(kernels["fwd"], lambda: packed_attention_reference(q, k, v, seg),
                       sdpa, iters=10),
        "dq": timings(kernels["dq"], plain_bwd, sdpa_fwd_bwd, iters=10),
        "dkv": timings(kernels["dkv"], plain_bwd, sdpa_fwd_bwd, iters=10),
    }
    for name in ("dq", "dkv"):
        for key in ("library_ms", "library_eager_ms"):
            times[name][key] -= times["fwd"][key]
    bounds = _flash_bounds(lens, b, s, hq, hkv, d, 2)
    for name in ("fwd", "dq", "dkv"):
        t = times[name]
        log(f"[flash] bf16 {name}: kernel_ms={t['kernel_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} (device, graph replays); eager calls "
            f"kernel={t['kernel_eager_ms']:.4f} plain={t['plain_eager_ms']:.4f} "
            f"library={t['library_eager_ms']:.4f}; bound_ms={bounds[name][0]:.5f} "
            f"({bounds[name][1]})")
    log(f"[flash] (plain dq/dkv = flash_bwd_reference, dq+dk+dv; library fwd = SDPA, "
        f"library dq/dkv = SDPA's backward, dq+dk+dv); {len(lens)} segments, "
        f"{sum(lens)} real of {b * s} positions")
    report["flash"] = dict(
        max_abs_err=errs, times=times, bounds=bounds,
        segments=len(lens), real_tokens=sum(lens),
    )


# --------------------------------------------------------------------------
# Phase 3: the serving path at full size
# --------------------------------------------------------------------------


def _post(url, payload, timeout=900.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(report, seed):
    import numpy as np
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = qwen2_config("1.5b")
    n_req, n, max_new = 16, 4, 128
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] qwen2-1.5b random init ({cfg.n_layers} layers, bf16): "
        f"{time.monotonic() - t0:.1f} s")
    engine = GeneratorEngine(cfg, params, eos_token_id=151643)
    check(engine.device.type == "cuda", "the engine is not on the card")
    # By the JAX package's rule a burst whose max_new_tokens exceeds
    # static_path_max_new takes the serving plane: at 0 every call does.
    engine.static_path_max_new = 0
    per_call = []
    real_generate = engine.generate

    def generate_and_record(sample, *a, **k):  # observe each call's counters
        out = real_generate(sample, *a, **k)
        per_call.append(dict(
            requests=sample.bs,
            decode_compiles=engine.decode_compiles,
            prefill_dispatches=engine.prefill_dispatches,
            dead_live_lanes=engine.dead_live_lanes,
            lanes_live=engine.lanes_live, lanes_slack=engine.lanes_slack,
            lanes_dispatched=engine.lanes_dispatched,
            shared_mappings=engine.last_pool_stats.get("shared_mappings", 0),
            cow_copies=engine.last_pool_stats.get("cow_copies", 0),
        ))
        return out

    engine.generate = generate_and_record
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(n_req)
    ]
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    start = threading.Barrier(n_req)
    replies, lat, errors = [None] * n_req, [0.0] * n_req, []
    try:
        health = json.loads(urllib.request.urlopen(server.url + "/health").read())
        check(health["status"] == "ok", "/health is not ok")
        torch.cuda.reset_peak_memory_stats()
        rpa.LAUNCHES = 0
        steps0 = engine.steps_total

        def client(i):
            start.wait(timeout=60.0)  # post together: one batched call
            t_req = time.monotonic()
            try:
                replies[i] = _post(server.url + "/generate", dict(
                    qid=f"q{i}", prompt_ids=prompts[i], n=n,
                    max_new_tokens=max_new, temperature=1.0,
                ))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"q{i}: {e!r}")
            lat[i] = time.monotonic() - t_req

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = rpa.LAUNCHES
        steps = engine.steps_total - steps0
    finally:
        server.close()
    check(not errors, f"requests failed: {errors}")
    check(all(r is not None for r in replies), "a request got no reply")
    n_tok = 0
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"q{i}: {len(ids)} tokens")
            check(len(lps) == len(ids), f"q{i}: logprobs/ids length mismatch")
            check(all(math.isfinite(x) for x in lps), f"q{i}: non-finite logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"q{i}: id out of vocab")
            n_tok += len(ids)
    for c in per_call:
        check(c["dead_live_lanes"] == 0, f"dead_live_lanes {c}")
        check(c["lanes_live"] + c["lanes_slack"] == c["lanes_dispatched"],
              f"lane partition broken {c}")
        check(c["prefill_dispatches"] == 0, f"prefill dispatches {c}")
        check(c["decode_compiles"] == 1, f"chunk builds per call {c}")
    check(any(c["shared_mappings"] > 0 for c in per_call),
          "no prompt page was shared (CoW) in any call")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} x {steps} inner steps")
    lat.sort()
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        requests=n_req, n=n, max_new_tokens=max_new, generate_calls=len(per_call),
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        latency_p50_s=lat[len(lat) // 2],
        latency_p99_s=lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)],
        inner_steps=steps, launches=launches, peak_mem_bytes=peak,
        lane_budget=engine.serving_lane_budget, per_call=per_call,
        launches_per_chunk=cfg.n_layers * min(32, max_new),
    )
    log(
        f"[serve] {n_req} requests x n={n}: {n_tok} tokens in {wall:.2f} s = "
        f"{out['tokens_per_s']:.1f} tok/s; latency p50={out['latency_p50_s']:.2f} s "
        f"p99={out['latency_p99_s']:.2f} s; generate calls={len(per_call)}; "
        f"inner steps={steps}; K2 launches={launches}; lanes T={engine.serving_lane_budget}; "
        f"peak mem={peak / 2**30:.2f} GiB"
    )
    out["profile"] = _profile_generate(engine, cfg, rng, "ragged_paged_attention")
    report["serve"] = out
    # The recording wrapper closes a reference cycle through the engine:
    # drop it and collect now, or the weights stay allocated through the
    # later phases (and in their peak-memory readings).
    del engine.generate
    del engine, params, server
    gc.collect()
    torch.cuda.empty_cache()


# The profiled generate call's prompt and new tokens: at 128 and 32 its
# trace's collection took 35.5 s (serve) and 10.1 s (static) on an H100
# host, at 128 and 8 22.5 s and 1.9 s.
PROFILE_PROMPT_TOKENS = 64
PROFILE_NEW_TOKENS = 8


def _profile_generate(engine, cfg, rng, attention):
    """Device time by kernel over one smaller generate call (4 prompts of
    PROFILE_PROMPT_TOKENS tokens x n=4, PROFILE_NEW_TOKENS new tokens) under
    torch.profiler: the card's
    idle share of that call's wall time and the share of busy time of
    the kernels whose name holds `attention`.  CUDA activity only: the
    host ops' events added nothing read here and tripled the trace's
    collection time (about 100 s of the serve phase on an H100 host)."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters

    data = rng.integers(0, cfg.vocab_size, 4 * PROFILE_PROMPT_TOKENS).astype("int32")
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(4)],
        seqlens={"packed_prompts": [[PROFILE_PROMPT_TOKENS]] * 4},
        data={"packed_prompts": data},
    )
    g = GenerationHyperparameters(n=4, max_new_tokens=PROFILE_NEW_TOKENS, temperature=1.0)
    steps0, decode0 = engine.steps_total, engine.static_decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(sample, MicroBatchSpec(), g, seed=1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    averages = prof.key_averages()
    trace_s = time.monotonic() - t0 - wall  # the profiler's own collection and averaging
    kernels = []
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6
    attn_s = sum(k[0] for k in kernels if attention in k[2]) / 1e6
    top = [
        dict(name=name[:90], ms=us / 1e3, calls=n, share=us / 1e6 / max(busy_s, 1e-12))
        for us, n, name in kernels[:8]
    ]
    steps = engine.steps_total - steps0
    decode = engine.static_decode_steps - decode0
    share = attn_s / max(busy_s, 1e-12)
    log(f"[profile] 1 generate call, {steps} serving inner steps, {decode} static decode "
        f"steps: wall {wall:.3f} s, device busy {busy_s:.3f} s, idle share "
        f"{1 - busy_s / wall:.3f}, {attention} share of busy {share:.3f} (profiler on; its "
        f"trace took {trace_s:.1f} s to collect and average)")
    for k in top:
        log(f"[profile]   {k['share']:.3f} {k['ms']:10.2f} ms {k['calls']:7d}x {k['name']}")
    return dict(wall_s=wall, busy_s=busy_s, idle_share=1 - busy_s / wall,
                inner_steps=steps, static_decode_steps=decode,
                attention_share=share, top_kernels=top)


# --------------------------------------------------------------------------
# Phase: the static generate path at full size
# --------------------------------------------------------------------------


def _timed(module, name, times):
    """Wrap module.name so each call records a pair of CUDA events into
    times (no synchronisation); returns the original for restoring."""
    import torch

    real = getattr(module, name)

    def run(*a, **k):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(*a, **k)
        t1.record()
        times.append((t0, t1))
        return out

    setattr(module, name, run)
    return real


def phase_static(report, seed):
    """The serve phase's burst (16 requests x n=4, prompts 64-512, 128 new
    tokens, the same prompts) through GenerationServer over a DEFAULT
    engine at full qwen2-1.5B: 64 requests fit max_decode_batch and 128
    new tokens fit static_path_max_new, so the call takes the static
    path — one prefill (K1f) and one decode_step (K4) per token.  The
    launch counts are set to 0 just before the burst and read just
    after it."""
    import numpy as np
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = qwen2_config("1.5b")
    n_req, n, max_new = 16, 4, 128
    engine = GeneratorEngine(cfg, init_params(cfg, seed, device="cuda"), eos_token_id=151643)
    check(engine.device.type == "cuda", "the engine is not on the card")
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(n_req)
    ]
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    pre_t, dec_t = [], []
    real_pre = _timed(tfm, "prefill", pre_t)
    real_dec = _timed(tfm, "decode_step", dec_t)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        da.LAUNCHES = rpa.LAUNCHES = 0
        chunks0, steps0 = engine.static_chunks, engine.static_decode_steps
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed + 15)
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k1 = dict(fa.LAUNCHES)
        k4, k2 = da.LAUNCHES, rpa.LAUNCHES
        chunks = engine.static_chunks - chunks0
        steps = engine.static_decode_steps - steps0
        peak = torch.cuda.max_memory_allocated()
    finally:
        tfm.prefill, tfm.decode_step = real_pre, real_dec
        server.close()
    prefill_s = sum(a.elapsed_time(b) for a, b in pre_t) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in dec_t) / 1e3
    check(not errors and all(r is not None for r in replies), f"requests failed: {errors}")
    n_tok = 0
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        check(r["version"] == r["version_start"] == 0, f"q{i}: version {r['version']}")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"q{i}: {len(ids)} tokens")
            check(len(ids) == max_new or ids[-1] == 151643, f"q{i}: short without EOS")
            check(len(lps) == len(ids), f"q{i}: logprobs/ids length mismatch")
            check(all(math.isfinite(x) and x <= 0 for x in lps), f"q{i}: bad logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"q{i}: id out of vocab")
            n_tok += len(ids)
    log(f"[static] {n_req} requests x n={n}: {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tok/s; {chunks} static chunk(s), {steps} decode steps; "
        f"prefill {prefill_s:.3f} s, decode {decode_s:.3f} s = "
        f"{1e3 * decode_s / max(steps, 1):.3f} ms a step (CUDA events around each call); "
        f"launches K1f {k1['fwd']} (dq {k1['dq']}, dkv {k1['dkv']}), K4 {k4}, K2 {k2}; "
        f"peak mem {peak / 2**30:.2f} GiB")
    check(chunks >= 1 and steps >= 1, "the burst did not take the static path")
    check(k1 == {"fwd": cfg.n_layers * chunks, "dq": 0, "dkv": 0},
          f"K1 launches {k1} != {cfg.n_layers} x {chunks} static chunks")
    check(k4 == cfg.n_layers * steps, f"K4 launches {k4} != {cfg.n_layers} x {steps}")
    check(k2 == 0, f"the static path launched K2 {k2} times")
    out = dict(
        requests=n_req, n=n, max_new_tokens=max_new, tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, static_chunks=chunks, decode_steps=steps,
        prefill_s=prefill_s, decode_s=decode_s, decode_step_ms=1e3 * decode_s / max(steps, 1),
        launches=k4, k1f_launches=k1["fwd"], peak_mem_bytes=peak,
    )
    out["profile"] = _profile_generate(engine, cfg, rng, "decode_attention")
    report["static"] = out
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase: the in-memory weight push mid-generation, at full size
# --------------------------------------------------------------------------


def _burst(url, prompts, n, max_new, seed, timeout=900.0, **options):
    """POST every prompt at once (one batched engine call: same gconfig
    and seed), with request `options` (greedy, spec_decode_k, ...) beside
    the sampling defaults; returns (threads, replies, errors)."""
    start = threading.Barrier(len(prompts))
    replies, errors = [None] * len(prompts), []

    def client(i):
        start.wait(timeout=60.0)
        try:
            replies[i] = _post(url + "/generate", dict(
                dict(qid=f"q{i}", prompt_ids=prompts[i], n=n, max_new_tokens=max_new,
                     temperature=1.0, seed=seed), **options,
            ))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"q{i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    return threads, replies, errors


# Requests of the push burst: the serve burst's first 8 (16 before the
# async phase came: the burst's time is its waves of 16 slots, so 8
# halve it; the checks are the same).
PUSH_REQUESTS = 8
# Layers of the push, resume_parity, overlap, recover, genmodes, async,
# multiproc and episodes phases' model: qwen2-1.5B at full width, cut in
# depth (push and episodes to 14 since the async phase came; all seven to
# 7 since the multiproc phase came, and multiproc too since the fabric
# phase came; to 4 since the gemma phase came, when a slow card's whole
# smoke read 1,223 s: their decode steps are host-bound, a launch
# sequence a layer, and their weight pushes scale with the depth, so
# fewer layers take about proportionally less time; the checks count by
# the model's layers and are the same).
CUT_LAYERS = 4


def phase_push(report, seed):
    """GenerationServer at qwen2-1.5B's full width (CUT_LAYERS layers, bf16) serving
    PUSH_REQUESTS GRPO requests (n=4, prompts 64-512, 128 new tokens, one
    seed) while
    `update_weights_inmem` pushes init_params(seed + 1) with its checksum
    once live rows have run past their first chunk.  The running call
    parks, the weights are swapped, each live row's last chunk is replayed
    through K3, and the call finishes on its existing pages.  The same
    burst under the old weights, uninterrupted, is the reference.  Then a
    push with a wrong checksum is refused and version 1 keeps serving.
    Then the same over an int8 page pool (`kv_cache_dtype="int8"`: K2
    and K3 over int8 codes and bf16 scales) with the first half of
    them."""
    report["push"] = _push_run("push", seed, PUSH_REQUESTS)
    report["push_int8"] = _push_run("push_int8", seed, PUSH_REQUESTS // 2,
                                    kv_cache_dtype="int8")


def _push_run(tag, seed, n_req, **engine_kw):
    """One run of phase_push with the burst's first `n_req` requests and
    GeneratorEngine options `engine_kw`; returns its numbers."""
    import numpy as np
    import torch

    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    n, max_new = 4, 128
    engine = GeneratorEngine(cfg, init_params(cfg, seed, device="cuda"), eos_token_id=151643,
                             **engine_kw)
    check(engine.device.type == "cuda", "the engine is not on the card")
    engine.static_path_max_new = 0  # the serving plane, which can park
    chunk_t = min(32, max_new)
    rng = np.random.default_rng(seed + 13)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(16)
    ][:n_req]
    # Time the swap and each replay (host clock, synchronized).
    timing = {"swap_s": [], "replay_s": []}
    real_set, real_replay = engine.set_params, engine._get_paged_replay_fn

    def timed_set(params):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        real_set(params)
        torch.cuda.synchronize()
        timing["swap_s"].append(time.monotonic() - t0)

    def timed_replay():
        fn = real_replay()

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn(*a)
            torch.cuda.synchronize()
            timing["replay_s"].append(time.monotonic() - t0)

        return run

    # Neither runs before the push: the reference burst is not affected.
    engine.set_params, engine._get_paged_replay_fn = timed_set, timed_replay
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        t0 = time.monotonic()
        threads, ref, errors = _burst(server.url, prompts, n, max_new, seed + 14)
        for th in threads:
            th.join(timeout=900.0)
        ref_s = time.monotonic() - t0
        check(not errors and all(r is not None for r in ref), f"{tag}: reference burst: {errors}")
        check(all(r["version"] == r["version_start"] == 0 for r in ref),
              f"{tag}: the reference burst did not run on version 0")
        new = init_params(cfg, seed + 1, device="cuda")
        checksum = integrity.params_checksum(new)
        pca.LAUNCHES = rpa.LAUNCHES = 0
        replays0, steps0 = engine.resume_replays, engine.steps_total
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed + 14)
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            live = json.loads(urllib.request.urlopen(server.url + "/health").read())["live_slots"]
            if live > 0 and engine.steps_total - steps0 >= 2 * chunk_t:
                break
            time.sleep(0.01)
        steps_at_push = engine.steps_total - steps0
        check(steps_at_push >= 2 * chunk_t, f"{tag}: generation never ran two chunks")
        t_push = time.monotonic()
        version = server.update_weights_inmem(new, checksum=checksum)
        push_s = time.monotonic() - t_push
        del new
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k3, k2 = pca.LAUNCHES, rpa.LAUNCHES
        replays = engine.resume_replays - replays0
        steps = engine.steps_total - steps0
        check(not errors and all(r is not None for r in replies), f"{tag}: push burst: {errors}")
        health = json.loads(urllib.request.urlopen(server.url + "/health").read())
        # A push with a corrupted checksum is refused; version 1 serves on.
        bad = checksum.copy()
        bad[2] *= 1.01
        try:
            server.update_weights_inmem(init_params(cfg, seed + 2, device="cuda"), checksum=bad)
            refused = False
        except integrity.WeightChecksumError:
            refused = True
        after = _post(server.url + "/generate", dict(
            qid="after", prompt_ids=prompts[0][:64], n=1, max_new_tokens=8, greedy=True,
        ))
    finally:
        del engine.set_params, engine._get_paged_replay_fn  # the timing wrappers
        server.close()
    check(version == 1, f"{tag}: the push returned version {version}")
    n_tok = n_spanned = n_changed = 0
    for i, (r, r0) in enumerate(zip(replies, ref)):
        check(len(r["output_ids"]) == n, f"q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(len(ids) == max_new or (ids and ids[-1] == 151643),
                  f"q{i}: {len(ids)} tokens and no EOS")
            check(len(lps) == len(ids) and all(math.isfinite(x) for x in lps),
                  f"q{i}: logprobs malformed")
            n_tok += len(ids)
        if r["version_start"] == 0 and r["version"] == 1:
            n_spanned += 1
            n_changed += r["output_ids"] != r0["output_ids"]
    log(f"[{tag}] {engine_kw or ''} reference burst (old weights, uninterrupted) {ref_s:.2f} s; "
        f"push burst {wall:.2f} s, {n_tok} tokens; push after {steps_at_push} inner steps took "
        f"{push_s:.3f} s (swap {sum(timing['swap_s']):.3f} s, replays "
        f"{[round(x, 4) for x in timing['replay_s']]} s); resume_replays={replays}, "
        f"K3 launches={k3} ({cfg.n_layers} x {replays}), K2 launches={k2} "
        f"({cfg.n_layers} x {steps} inner steps); spanned requests {n_spanned}/{n_req}, "
        f"of which {n_changed} differ from the old-weights run; health after: "
        f"paused={health['paused']} version={health['version']}; bad-checksum push "
        f"refused={refused}, then version {after['version']}")
    check(n_spanned >= 1, f"{tag}: no request spanned the push (version_start 0, version 1)")
    check(n_changed >= 1, f"{tag}: no spanned request changed under the new weights")
    check(not health["paused"] and health["version"] == 1, f"{tag}: health after the push {health}")
    check(replays >= 1, f"{tag}: the push replayed nothing")
    check(k3 == cfg.n_layers * replays, f"{tag}: K3 launches {k3} != {cfg.n_layers} x {replays}")
    check(k2 == cfg.n_layers * steps, f"{tag}: K2 launches {k2} != {cfg.n_layers} x {steps}")
    check(refused, f"{tag}: a push with a wrong checksum was not refused")
    check(after["version"] == after["version_start"] == 1 and len(after["output_ids"][0]) == 8,
          f"{tag}: after the refused push: {after['version']}, {after['version_start']}")
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        launches=k3, k2_launches=k2, resume_replays=replays, push_s=push_s,
        swap_s=timing["swap_s"], replay_s=timing["replay_s"], wall_s=wall,
        reference_s=ref_s, tokens=n_tok, steps_at_push=steps_at_push,
        inner_steps=steps, spanned=n_spanned, changed=n_changed,
    )


# --------------------------------------------------------------------------
# Phase: resume under unchanged weights, at full size
# --------------------------------------------------------------------------

# The bf16 bound of resume_parity: each replayed row's logits before the
# replay (K2's forward in the serving chunk) against after it (K3's
# recompute of the same position), relative to the row's largest |logit|.
# Two bf16 paths through one model (other GEMM shapes, so other
# roundings of the same K/V): the first reading on the H100 was 1.56e-2;
# the bound is under 3x that.  fp32 read 1.9e-6 against its 1e-4.
RESUME_BF16_TOL = 4.5e-2
# The same bound over an int8 page pool (bf16 compute): before the
# replay K2 reads int8 codes, after it K3 does.  Everything of the bf16
# case holds, and the replay re-quantizes the tail it recomputes: a K/V
# element that the other GEMM shapes move by a bf16 ulp (~2^-9 of it)
# crosses a code boundary with probability ~|dx| / s (s = amax / 127,
# about 3 |x| / 127) and then moves by a whole step s, so the tail's
# K/V perturbation grows from E[dx^2] to about E|dx| * s: ~12x in
# variance, ~3.5x in RMS.  3.5 x the bf16 reading (1.56e-2) is 5.5e-2;
# the first bound, 1e-1, was under 2x that, written before the first
# int8 reading.  That reading on the H100 was 1.71e-2 (bf16 1.545e-2 in
# the same run): 1.1x bf16, not 3.5x, so the flips of codes move the
# logits far less than the estimate (most flipped elements meet small
# probabilities).  The bound is now the bf16 bound's margin, under 3x
# the reading.
RESUME_INT8_TOL = 5e-2


def _resume_parity_run(cfg, params, dtype, sample, g, **engine_kw):
    """One uninterrupted greedy generate and one parked at the second
    serving chunk, then resumed under unchanged weights, on a
    GeneratorEngine with options `engine_kw`.  Returns (the
    uninterrupted output, the resumed output, logits_buf before and
    after the replay, the replayed rows, what the park found)."""
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.engines.generator import GeneratorEngine

    eng = GeneratorEngine(cfg, params, compute_dtype=dtype, eos_token_id=151643, **engine_kw)
    eng.static_path_max_new = 0  # the serving plane, which can park
    ref = eng.generate(sample, MicroBatchSpec(), g, seed=0)
    real_get, real_replay = eng._get_serving_chunk_fn, eng._get_paged_replay_fn
    calls, cap = {"n": 0}, {}

    def hooked(*a, **kw):
        fn = real_get(*a, **kw)

        def wrapped(*fa, **fkw):
            calls["n"] += 1
            if calls["n"] == 2:
                eng.interrupt()
            return fn(*fa, **fkw)

        return wrapped

    def captured():
        fn = real_replay()

        def run(*a):
            cap["before"] = a[6].clone()
            fn(*a)
            cap["after"] = a[6].clone()
            cap["live"] = a[8].clone()

        return run

    eng._get_serving_chunk_fn, eng._get_paged_replay_fn = hooked, captured
    check(eng.generate(sample, MicroBatchSpec(), g, seed=0) is None,
          "the interrupted generate did not park")
    st = eng._session
    live = [s for s in range(st.n_slots) if st.active[s] is not None]
    park = dict(
        decoding=sum(int(st.prefill_rem[s] == 0) for s in live),
        prefilling=sum(int(st.prefill_rem[s] > 0) for s in live),
        followers=sum(int(st.shared_from[s] > 0 and st.alloc.is_shared(s, 0)) for s in live),
    )
    eng.clear_interrupt()
    out = eng.resume_generate()
    torch.cuda.synchronize()
    check(out is not None and eng.resume_replays == 1, "the resume did not finish")
    del eng
    return ref, out, cap["before"], cap["after"], cap["live"], park


def _log_first_flip(ref, res):
    """Print, for each sequence whose greedy tokens differ, the first
    differing position, both tokens and the logit gap there: the two
    chosen tokens' logprobs in their own runs, whose histories agree up
    to that position."""
    oa = ob = lpa = lpb = 0  # token and logprob offsets of each run
    for ln_a, ln_b in zip(ref.seqlens["packed_input_ids"], res.seqlens["packed_input_ids"]):
        for la, lb in zip(ln_a, ln_b):
            a = ref.data["packed_input_ids"][oa : oa + la]
            b = res.data["packed_input_ids"][ob : ob + lb]
            m = min(la, lb)
            diff = (a[:m] != b[:m]).nonzero()[0]
            if len(diff):
                j = int(diff[0])  # token j's logprob is entry j - 1
                ga = float(ref.data["packed_logprobs"][lpa + j - 1])
                gb = float(res.data["packed_logprobs"][lpb + j - 1])
                log(f"[resume_parity] token {j} of a sequence: {int(a[j])} (logprob "
                    f"{ga:.6f}) vs {int(b[j])} (logprob {gb:.6f}); gap {ga - gb:.3e}")
            oa, ob, lpa, lpb = oa + la, ob + lb, lpa + la - 1, lpb + lb - 1


def phase_resume_parity(report, seed):
    """Park at the second serving chunk and resume under UNCHANGED weights
    at qwen2-1.5B's full width (CUT_LAYERS layers), with rows decoding, a row mid-prefill
    and a same-prompt follower mapping its owner's prompt pages.  Each
    replayed row's logits after the replay (K3) are held against the
    ones before it (K2, the uninterrupted run's next-token logits):
    relative 1e-4 in fp32, RESUME_BF16_TOL in bf16 and RESUME_INT8_TOL in
    bf16 over an int8 page pool; in fp32 the greedy tokens equal the
    uninterrupted run's."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 17)
    cfg = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=CUT_LAYERS)
    # A 560-token prompt is still prefilling after two chunks (8 prompt
    # tokens a row per inner step); the 200-token prompt appears twice, so
    # its second copy maps the first's full prompt page once that one
    # has finished its prefill (the prefix cache of a GRPO group).
    lens = (560, 200, 200, 40)
    toks = [rng.integers(0, cfg.vocab_size, l) for l in lens[:2]]
    toks = [toks[0], toks[1], toks[1].copy(), rng.integers(0, cfg.vocab_size, lens[3])]
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": np.concatenate(toks).astype(np.int32)},
    )
    g = GenerationHyperparameters(n=1, max_new_tokens=48, greedy=True)
    params = init_params(cfg, seed + 3, device="cuda")
    out = {}
    runs = ((torch.float32, "fp32", {}), (torch.bfloat16, "bf16", {}),
            (torch.bfloat16, "bf16_int8", {"kv_cache_dtype": "int8"}))
    for dtype, tag, ekw in runs:
        ref, res, before, after, live, park = _resume_parity_run(
            cfg, params, dtype, sample, g, **ekw)
        gc.collect()  # the run's engine and its hooks
        torch.cuda.empty_cache()
        rows = live.nonzero()[:, 0]
        diff = (after[rows] - before[rows]).abs().amax(-1)
        rel = float((diff / before[rows].abs().amax(-1)).max())
        same = (ref.seqlens["packed_input_ids"] == res.seqlens["packed_input_ids"]
                and np.array_equal(ref.data["packed_input_ids"], res.data["packed_input_ids"]))
        log(f"[resume_parity] {tag}: park found {park}; {len(rows)} rows replayed; "
            f"logits after/before the replay: relative {rel:.3e}; greedy tokens "
            f"identical to the uninterrupted run: {same}")
        check(park["decoding"] > 0 and park["prefilling"] > 0 and park["followers"] > 0,
              f"{tag}: the park did not find decoding, prefilling and follower rows")
        out[tag] = dict(logits_rel=rel, tokens_identical=same, park=park, rows=len(rows))
        if tag == "fp32":
            check(rel <= 1e-4, f"fp32 replay logits differ by {rel:.3e} relative")
            if not same:
                _log_first_flip(ref, res)
            check(same, "fp32 greedy tokens after the resume differ from the uninterrupted run")
        else:
            tol = RESUME_INT8_TOL if ekw else RESUME_BF16_TOL
            check(rel <= tol, f"{tag} replay logits differ by {rel:.3e} > {tol}")
    report["resume_parity"] = out
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 4: greedy parity, card against CPU
# --------------------------------------------------------------------------


# (label, engine options, inflight, request options, the attention
# kernel a decode step launches once per layer) for phase_parity.
# New tokens a parity mode generates (at 16, the CPU side of the serving
# modes took 14-19 s of the phase's 78-112 s on the H100's host).
PARITY_NEW_TOKENS = 8
PARITY_MODES = (
    ("serving plane", {}, True, {}, "k2"),
    ("static path", {}, False, {}, "k4"),
    ("dense window", dict(kv_paged=False), True, {}, "k4"),
    ("dense window int8", dict(kv_paged=False, kv_cache_dtype="int8"), True, {}, "k4"),
    ("dense spec K=4", dict(kv_paged=False), True, dict(spec_decode_k=4), "k4"),
    ("two-program paged", dict(prefill_chunk_tokens=0), True, {}, "k2"),
    ("two-program paged int8", dict(prefill_chunk_tokens=0, kv_cache_dtype="int8"), True, {},
     "k2"),
    ("serving spec K=4", {}, True, dict(spec_decode_k=4), "k2"),
)


def _parity_inputs(seed):
    """phase_parity's model (qwen2-1.5B width, 2 layers, fp32), weights
    and prompts, the same in the phase and in the CPU references' child."""
    import numpy as np

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=2)
    params = init_params(cfg, seed, device="cpu")
    lens = (37, 150, 300, 129)
    rng = np.random.default_rng(seed + 1)
    data = np.concatenate(
        [rng.integers(0, cfg.vocab_size, size=l) for l in lens]
    ).astype(np.int32)
    kw = dict(eos_token_id=151643, kv_page_size=128, prefill_chunk_tokens=8)
    return cfg, params, lens, data, kw


def _parity_mode_run(cfg, params, lens, data, kw, mode, dev):
    """One PARITY_MODES mode on `dev`: its tokens and logprobs (and, on
    the card, its launches held to the engine's own steps)."""
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engines.generator import GeneratorEngine

    path, ekw, inflight, gkw, kernel = mode
    g = GenerationHyperparameters(n=2, max_new_tokens=PARITY_NEW_TOKENS, greedy=True, **gkw)
    sample = SequenceSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": data.copy()},
    )
    eng = GeneratorEngine(cfg, params, dev, compute_dtype=torch.float32, **dict(kw, **ekw))
    _reset_counts()
    t0 = time.monotonic()
    out = eng.generate(sample, MicroBatchSpec(), g, inflight=inflight)
    secs = time.monotonic() - t0
    if dev == "cuda":
        counts, L = _trial_counts(), cfg.n_layers
        if inflight:
            want = dict(fwd=L * eng.prefill_dispatches, dq=0, dkv=0, k2=0, k3=0, k4=0)
            want[kernel] = L * eng.steps_total
        else:
            want = dict(fwd=L * eng.static_chunks, dq=0, dkv=0, k2=0, k3=0,
                        k4=L * eng.static_decode_steps)
        check(counts == want and counts[kernel] > 0, f"{path}: launches {counts} != {want}")
    return dict(seqlens=out.seqlens["packed_input_ids"], ids=out.data["packed_input_ids"],
                logprobs=out.data["packed_logprobs"], secs=secs)


def _parity_cpu(seed):
    cfg, params, lens, data, kw = _parity_inputs(seed)
    return dict(
        inputs=(_inputs_print(params), data.tolist()),
        modes={m[0]: _parity_mode_run(cfg, params, lens, data, kw, m, "cpu")
               for m in PARITY_MODES},
        episode=_episode_parity_run(cfg, params, kw, seed, "cpu"),
    )


def phase_parity(seed):
    """Greedy tokens at qwen2-1.5B width and 2 layers in fp32 (TF32 off),
    each mode of PARITY_MODES on the card against the same mode on the
    CPU (the plain path, computed by the CPU references' child): tokens
    identical, logprobs within 1e-3, and the card's launches = 2 layers x
    the engine's own steps (the static path: K1f per chunk, K4 per decode
    step; every other mode: K1f per prefill dispatch and its decode kernel
    per step).  Every full-precision mode's tokens equal the static
    path's, on the card and on the CPU."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, lens, data, kw = _parity_inputs(seed)
    cuda = {m[0]: _parity_mode_run(cfg, params, lens, data, kw, m, "cuda")
            for m in PARITY_MODES}
    ref = _cpu_ref("parity")
    check(ref["inputs"] == (_inputs_print(params), data.tolist()),
          "[parity] the CPU reference ran on other inputs")
    tokens = {}
    for path, *_ in PARITY_MODES:
        a, b = cuda[path], ref["modes"][path]
        same = a["seqlens"] == b["seqlens"] and np.array_equal(a["ids"], b["ids"])
        lp_err = float(np.abs(a["logprobs"] - b["logprobs"]).max())
        log(f"[parity] {path}, 2 layers fp32 greedy: tokens identical={same}, max logprob "
            f"diff={lp_err:.2e} (cuda {a['secs']:.1f} s, cpu {b['secs']:.1f} s)")
        check(same, f"{path}: greedy tokens differ between the card and the CPU")
        check(lp_err <= 1e-3, f"{path}: logprobs differ by {lp_err} > 1e-3")
        tokens[path] = {"cuda": a["ids"], "cpu": b["ids"]}
    static = tokens["static path"]
    for path, toks in tokens.items():
        if "int8" in path:
            continue
        same = all(np.array_equal(toks[dev], static[dev]) for dev in ("cuda", "cpu"))
        log(f"[parity] {path} against the static path: tokens identical={same}")
        check(same, f"{path}: greedy tokens differ from the static path's")
    _episode_parity(_episode_parity_run(cfg, params, kw, seed, "cuda"), ref["episode"])


def _episode_parity_run(cfg, params, kw, seed, dev):
    """One episode's script on `dev` (2 slots): a turn, an observation's
    turn, release, the typed SlotGone, a re-admission of the full
    transcript (prefix hit), then an observation's turn parked after its
    first chunk, new weights, episode_resume (K3).  On the card, K2 = 2
    layers x inner steps, K3 = 2 x replays, the others 0."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.model_api import GenerationHyperparameters, SlotGoneError
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.transformer import init_params

    rng = np.random.default_rng(seed + 91)
    prompt = rng.integers(0, cfg.vocab_size, 150).tolist()
    new_params = init_params(cfg, seed + 1, device="cpu")
    g = GenerationHyperparameters(n=1, max_new_tokens=16, greedy=True)
    eng = GeneratorEngine(cfg, params, dev, compute_dtype=torch.float32,
                          max_decode_batch=2, **kw)
    real = eng._episode_chunk_fn
    armed = {"left": None}

    def chunk_fn(st, gc_):
        fn = real(st, gc_)

        def run(*a, **k):
            out = fn(*a, **k)
            if armed["left"] is not None:
                armed["left"] -= 1
                if armed["left"] == 0:
                    eng.interrupt()  # a push arriving after this chunk
            return out

        return run

    eng._episode_chunk_fn = chunk_fn
    _reset_counts()
    steps0 = eng.steps_total
    t0 = time.monotonic()
    out = [eng.episode_start("p", prompt, g, token_budget=512)]
    out.append(eng.episode_extend("p", [11, 12, 13]))
    eng.episode_release("p")
    try:
        eng.episode_extend("p", [14])
        gone = False
    except SlotGoneError:
        gone = True
    transcript = prompt + out[0]["tokens"] + [11, 12, 13] + out[1]["tokens"] + [14]
    out.append(eng.episode_start("p", transcript, g, token_budget=512))
    armed["left"] = 1
    out.append(eng.episode_extend("p", [15, 16]))
    eng.set_params(new_params)
    eng.clear_interrupt()
    out.append(eng.episode_resume("p"))
    secs = time.monotonic() - t0
    if dev == "cuda":
        torch.cuda.synchronize()
        counts, L = _trial_counts(), cfg.n_layers
        steps, replays = eng.steps_total - steps0, eng.resume_replays
        want = dict(fwd=0, dq=0, dkv=0, k2=L * steps, k3=L * replays, k4=0)
        check(counts == want and replays == 1,
              f"[parity] episode: launches {counts} != {want} (replays {replays})")
    return dict(out=out, gone=gone, secs=secs, stats=eng.episode_stats())


def _episode_parity(a, b):
    """The episode mode of phase_parity: the card's run `a` against the
    CPU's `b` (see _episode_parity_run).  Tokens identical, logprobs
    within 1e-3, every other field of every turn equal."""
    import numpy as np

    same = a["gone"] and b["gone"] and a["stats"] == b["stats"]
    lp_err = 0.0
    for ta, tb in zip(a["out"], b["out"]):
        if ta is None or tb is None:
            same = same and ta is None and tb is None
            continue
        same = same and ta["tokens"] == tb["tokens"] and all(
            ta[k] == tb[k] for k in ta if k not in ("tokens", "logprobs"))
        if ta["logprobs"] and len(ta["logprobs"]) == len(tb["logprobs"]):
            lp_err = max(lp_err, float(np.abs(np.subtract(ta["logprobs"], tb["logprobs"])).max()))
    turns = [t for t in a["out"] if t is not None]
    log(f"[parity] episode (start, extend, SlotGone, re-admission sharing "
        f"{turns[2]['shared_prefix_tokens']} tokens, a push mid-turn and episode_resume), "
        f"2 layers fp32 greedy: turns identical={same}, max logprob diff={lp_err:.2e}; reasons "
        f"{[t['stop_reason'] for t in turns]} (cuda {a['secs']:.1f} s, cpu {b['secs']:.1f} s)")
    check(same, "[parity] episode: the card's turns differ from the CPU's")
    check(lp_err <= 1e-3, f"[parity] episode: logprobs differ by {lp_err} > 1e-3")
    check(a["out"][3] is None and turns[2]["shared_prefix_tokens"] > 0,
          "[parity] episode: no mid-turn park or no prefix hit")


# --------------------------------------------------------------------------
# Phase: the GRPO train step at full size
# --------------------------------------------------------------------------

# Bounds of the train phase, between the generator's behaviour logprobs
# (bf16 weights, K2 over a bf16 pool) and the trainer's recompute (bf16
# casts of the same weights, K1f): two bf16 paths through one model.
# The first-minibatch importance ratio and approx-KL (means over the
# response tokens) read 2.6e-4 and 3.4e-4 at most on the H100, and each
# response token's |old_logp - new_logp| (held so that errors cannot
# cancel in a mean) 4.3e-2 at most; the bounds are about 3x that.
IMP_WEIGHT_TOL = 1e-3
APPROX_KL_TOL = 1e-3
TOKEN_LOGP_TOL = 0.125


def _train_prompts(rng, cfg, n_prompts):
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample

    lens = [int(rng.integers(64, 513)) for _ in range(n_prompts)]
    data = rng.integers(0, cfg.vocab_size, sum(lens)).astype(np.int32)
    ids = [f"q{i}" for i in range(n_prompts)]
    return SequenceSample(
        keys={"packed_prompts"}, ids=ids,
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": data},
    ), {i: {"task": "math", "solutions": [r"\boxed{7}"]} for i in ids}


def _profile_train_step(actor_if, actor, rollout, mb):
    """Device time by kernel over one train_step under torch.profiler:
    the card's idle share of its wall time, the K1 kernels' share of the
    busy time and each K1 kernel's device time a call."""
    import re

    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        actor_if.train_step(actor, rollout, mb)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6
    flash_s = sum(k[0] for k in kernels if "flash_" in k[2]) / 1e6
    top = [
        dict(name=name[:90], ms=us / 1e3, calls=n, share=us / 1e6 / max(busy_s, 1e-12))
        for us, n, name in kernels[:8]
    ]
    # Each K1 kernel's device time a call at the step's own packed shape.
    k1 = [
        dict(name=re.search(r"flash_\w+", name).group(0), ms=us / 1e3, calls=n,
             ms_per_call=us / 1e3 / max(n, 1))
        for us, n, name in kernels if "flash_" in name
    ]
    log(f"[profile] 1 train_step: wall {wall:.3f} s, device busy {busy_s:.3f} s, "
        f"idle share {1 - busy_s / wall:.3f}, K1 share of busy "
        f"{flash_s / max(busy_s, 1e-12):.3f} (profiler on)")
    for k in top:
        log(f"[profile]   {k['share']:.3f} {k['ms']:10.2f} ms {k['calls']:7d}x {k['name']}")
    for k in k1:
        log(f"[profile]   K1 {k['name']}: {k['ms']:.2f} ms in {k['calls']} launches = "
            f"{k['ms_per_call']:.4f} ms a call")
    return dict(wall_s=wall, busy_s=busy_s, idle_share=1 - busy_s / wall,
                k1_share=flash_s / max(busy_s, 1e-12), top_kernels=top, k1_per_call=k1)


def _train_recompute(actor_if, actor, rollout, mb):
    """Before the first update: PPOActorInterface.inference ->
    TrainEngine.forward (K1f only, no backward) recomputes the rollout's
    logprobs under the generator's weights; each response token's
    logprob is held against the generator's.  Layer 0's q/k/v and segment
    ids are taken from that forward, and K1f/K1dq/K1dkv are held against
    the plain version at the train step's own packed [B, S]."""
    import numpy as np
    import torch

    from areal_tpu_torch.interfaces.ppo import _extract_layout, _seq_align_minus1
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models import transformer as tfm

    captured = {}
    real_flash = tfm.flash_attention

    def capture(q, k, v, seg, causal=True):
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(), seg=seg.clone())
        return real_flash(q, k, v, seg, causal=causal)

    fa.reset_launches()
    tfm.flash_attention = capture
    try:
        t0 = time.monotonic()
        inf = actor_if.inference(actor, rollout, mb)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        tfm.flash_attention = real_flash
    launches = dict(fa.LAUNCHES)
    new_lp = inf.data["logprobs"]
    check(new_lp.shape == rollout.data["packed_input_ids"].shape
          and bool(np.isfinite(new_lp).all()), "inference logprobs malformed")
    check(launches["fwd"] > 0 and launches["dq"] == 0 and launches["dkv"] == 0,
          f"inference launches {launches}")
    old_lp = _seq_align_minus1(rollout, "packed_logprobs")
    resp = np.zeros(len(old_lp), bool)
    for s, length, pl in _extract_layout(rollout)[0]:
        resp[s + max(pl - 1, 0) : s + length - 1] = True
    diff = np.abs(old_lp - new_lp)[resp]
    tok_max, tok_p999 = float(diff.max()), float(np.quantile(diff, 0.999))
    log(f"[train] inference (TrainEngine.forward) before the update: {secs:.2f} s, "
        f"K1 launches {launches}; per-token |old_logp - new_logp| over {diff.size} "
        f"response tokens: max {tok_max:.4e} (bound {TOKEN_LOGP_TOL:g}), p99.9 "
        f"{tok_p999:.4e}, mean {float(diff.mean()):.4e}")
    check(tok_max < TOKEN_LOGP_TOL, f"a token's logprob differs by {tok_max}")
    q, k, v, seg = (captured[n] for n in ("q", "k", "v", "seg"))
    gen = torch.Generator(device=q.device).manual_seed(0)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    log(f"[flash] layer 0 of the train step: q {tuple(q.shape)} {q.dtype}, "
        f"{int((seg > 0).sum())} real of {seg.numel()} positions")
    held = _hold_flash("train", q, k, v, seg, do, FLASH_ROW_TOL["bf16"])
    return dict(
        inference_s=secs, inference_launches=launches, token_logp_max=tok_max,
        token_logp_p999=tok_p999, train_shape_errs=held,
    )


def phase_train(report, seed):
    """Two GRPO steps of the port at full qwen2-1.5B: generate (32
    requests, the static path as in the JAX package: K1f prefill, K4
    decode) -> reward -> train_step (K1f forward and remat recompute,
    K1dq/K1dkv backward), the generator taking the trained weights in
    between."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        FinetuneSpec, GenerationHyperparameters, Model, OptimizerConfig,
    )
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import PPOActorInterface
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = qwen2_config("1.5b")
    n_prompts, n, max_new = 8, 4, 128
    t0 = time.monotonic()
    params = init_params(cfg, seed + 2, device="cuda")
    train = TrainEngine(
        cfg, params,
        optimizer_config=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ftspec=FinetuneSpec(1, 64, n_prompts), remat_policy="full",
    )
    gen = GeneratorEngine(cfg, params, eos_token_id=151643)
    del params
    torch.cuda.synchronize()
    check(train.device.type == "cuda" and gen.device.type == "cuda",
          "the engines are not on the card")
    log(f"[train] qwen2-1.5b random init, TrainEngine (fp32 masters, bf16 compute, "
        f"remat full) + GeneratorEngine: {time.monotonic() - t0:.1f} s")
    tok = CharTokenizer(vocab_size=cfg.vocab_size)
    actor = Model("actor", train, tok, cfg)
    gen_model = Model("actor_gen", gen, tok, cfg)
    actor_if = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=n, max_new_tokens=max_new, temperature=1.0),
        n_minibatches=1, disable_value=True, adv_norm=True, kl_ctl=0.0,
    )
    mb = MicroBatchSpec()
    rng = np.random.default_rng(seed + 3)
    steps = []
    for step in range(2):
        prompts, id2info = _train_prompts(rng, cfg, n_prompts)
        rw_if = MultiTaskRewardInterface(id2info=id2info)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_gen = time.monotonic()
        fa.reset_launches()
        da.LAUNCHES = rpa.LAUNCHES = 0
        chunks0, dsteps0 = gen.static_chunks, gen.static_decode_steps
        rollout = actor_if.generate(gen_model, prompts, mb)
        torch.cuda.synchronize()
        t_rw = time.monotonic()
        gen_k1 = dict(fa.LAUNCHES)
        k4, k2 = da.LAUNCHES, rpa.LAUNCHES
        gen_chunks = gen.static_chunks - chunks0
        gen_steps = gen.static_decode_steps - dsteps0
        rollout.update_(rw_if.inference(actor, rollout, mb))
        graded = rollout.data["rewards"].copy()
        # A random model solves nothing: replace the graded scores with
        # seeded +-5 so the GRPO advantages are non-zero.
        rollout.data["rewards"] = rng.choice([-5.0, 5.0], size=graded.shape).astype(np.float32)
        t_rw_end = time.monotonic()
        peak = torch.cuda.max_memory_allocated()
        if step == 0:
            # Its dense plain attention is not the step's: keep it out of
            # the step's peak memory.
            inference = _train_recompute(actor_if, actor, rollout, mb)
            torch.cuda.reset_peak_memory_stats()
        t_train = time.monotonic()
        fa.reset_launches()
        stats = actor_if.train_step(actor, rollout, mb)
        torch.cuda.synchronize()
        t_end = time.monotonic()
        launches = dict(fa.LAUNCHES)
        chunks = train.last_pack_stats["n_micro_batches"]
        real = train.last_pack_stats["real_tokens"]
        grid = train.last_pack_stats["grid_tokens"]
        iw, akl, gn = stats["importance_weight"], stats["approx_kl"], stats["grad_norm"]
        rec = dict(
            step=step + 1, generate_s=t_rw - t_gen, reward_s=t_rw_end - t_rw,
            train_s=t_end - t_train, k4_launches=k4, gen_k1f_launches=gen_k1["fwd"],
            static_chunks=gen_chunks, decode_steps=gen_steps, launches=launches,
            micro_batches=chunks, real_tokens=real, grid_tokens=grid,
            train_tokens_per_s=real / (t_end - t_train),
            generated_tokens=int((~rollout.data["prompt_mask"].astype(bool)).sum()),
            graded_correct=int((graded > 0).sum()), importance_weight=iw,
            approx_kl=akl, grad_norm=gn, loss=stats["loss"],
            peak_mem_bytes=max(peak, torch.cuda.max_memory_allocated()),
        )
        if step == 0:
            rec.update(inference)
        steps.append(rec)
        log(f"[train] step {step + 1}: generate {rec['generate_s']:.2f} s "
            f"({rec['generated_tokens']} tokens; static path: {gen_chunks} chunk(s), "
            f"{gen_steps} decode steps, K1f launches {gen_k1['fwd']}, K4 {k4}, K2 {k2}), reward "
            f"{rec['reward_s']:.3f} s ({rec['graded_correct']}/{graded.size} graded "
            f"correct; rewards replaced by seeded +-5), train_step "
            f"{rec['train_s']:.2f} s = {rec['train_tokens_per_s']:.0f} tok/s "
            f"({real} real of {grid} grid tokens, {chunks} micro-batch); "
            f"importance_weight={iw:.6f} approx_kl={akl:.3e} grad_norm={gn:.4f} "
            f"loss={stats['loss']:.4e}; K1 launches {launches}; peak mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB")
        check(gen_chunks >= 1 and k2 == 0, "generate did not take the static path")
        check(gen_k1 == {"fwd": cfg.n_layers * gen_chunks, "dq": 0, "dkv": 0},
              f"generate's K1 launches {gen_k1} != {cfg.n_layers} x {gen_chunks} chunks")
        check(k4 == cfg.n_layers * gen_steps,
              f"generate's K4 launches {k4} != {cfg.n_layers} x {gen_steps} decode steps")
        check(math.isfinite(gn) and gn > 0, f"grad_norm {gn} is not finite and > 0")
        check(stats["quarantined"] == 0.0, "the step was quarantined")
        check(abs(iw - 1.0) < IMP_WEIGHT_TOL,
              f"|importance_weight - 1| = {abs(iw - 1.0)} >= {IMP_WEIGHT_TOL}")
        check(abs(akl) < APPROX_KL_TOL, f"|approx_kl| = {abs(akl)} >= {APPROX_KL_TOL}")
        want = {"fwd": cfg.n_layers * 2 * chunks, "dq": cfg.n_layers * chunks,
                "dkv": cfg.n_layers * chunks}
        check(launches == want, f"K1 launches {launches} != {want}")
        if step == 0:
            gen.set_params(train.get_params())
    total = {"fwd": 0, "dq": 0, "dkv": 0}
    for rec in steps:
        for k in total:
            total[k] += rec["launches"][k]
    prof = _profile_train_step(actor_if, actor, rollout, mb)
    report["train"] = dict(steps=steps, launches=total, profile=prof)
    del train, gen, actor, gen_model
    torch.cuda.empty_cache()


# Bound of the ppo phase's step-1 check between the ref's logprobs
# (InferenceEngine, bf16 casts of the actor's initial weights, K1f) and
# the generator's behaviour logprobs: the mean over response tokens of
# |ref_logp - old_logp|, two bf16 paths through one model.  The same
# comparison for the trainer's recompute (train phase) reads 9.8e-3 to
# 1.0e-2 on the H100, the ref's 1.01e-2; the bound is 3x that, as the
# train phase's are.  The ref is also held bit for bit against the
# trainer's own recompute, the same bf16 computation on the same weights.
REF_LOGP_MEAN_TOL = 3e-2


def _k1_check(tag, launches, n_layers, n_mbs, train):
    """K1 launches of one MFC: n_layers x micro-batches forwards, and for
    a train step (remat "full") a second forward, one dq and one dkv."""
    want = ({"fwd": 2 * n_layers * n_mbs, "dq": n_layers * n_mbs, "dkv": n_layers * n_mbs}
            if train else {"fwd": n_layers * n_mbs, "dq": 0, "dkv": 0})
    check(launches == want, f"{tag}: K1 launches {launches} != {want}")


def phase_ppo(report, seed):
    """Two full PPO steps of `ppo-math` at qwen2-1.5B with all four
    models: the actor (TrainEngine + GeneratorEngine), a critic
    (TrainEngine on the value head) and a reference model (an
    InferenceEngine on the actor's initial weights, offloaded to host
    memory after each call).  Each step: generate (static path) ->
    reward (seeded +-5) -> ref_inf -> critic_inf -> actor train_step ->
    critic train_step -> the generator takes the actor's weights."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        FinetuneSpec, GenerationHyperparameters, Model, OptimizerConfig,
    )
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import (
        PPOActorInterface, PPOCriticInterface, _extract_layout, _seq_align_minus1,
    )
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = qwen2_config("1.5b")
    ccfg = cfg.as_critic()
    n_prompts, n, max_new = 8, 4, 128
    # ppo-math's actor and critic lr (areal_tpu/experiments/common.py).
    oc = OptimizerConfig(lr=2e-5, warmup_steps_proportion=0.0)
    ft = FinetuneSpec(1, 64, n_prompts)
    t0 = time.monotonic()
    params = init_params(cfg, seed + 6, device="cuda")
    train = TrainEngine(cfg, params, optimizer_config=oc, ftspec=ft, remat_policy="full")
    gen = GeneratorEngine(cfg, params, eos_token_id=151643)
    del params
    # The ref from the trainer's live masters: set_params must copy, or
    # the ref would follow the actor's in-place updates.
    ref = InferenceEngine(cfg, train.get_params())
    cparams = init_params(ccfg, seed + 7, device="cuda")
    critic = TrainEngine(ccfg, cparams, optimizer_config=oc, ftspec=ft, remat_policy="full")
    del cparams
    torch.cuda.synchronize()
    check(all(e.device.type == "cuda" for e in (train, gen, ref, critic)),
          "the engines are not on the card")
    check(ref.compute_dtype == torch.bfloat16 and "value_head" in critic.params
          and "lm_head" not in critic.params, "ref dtype or critic head wrong")
    resident = torch.cuda.memory_allocated()
    log(f"[ppo] qwen2-1.5b actor (TrainEngine + GeneratorEngine), critic (TrainEngine, "
        f"value head [{ccfg.hidden_dim}, 1]), ref (InferenceEngine, bf16): "
        f"{time.monotonic() - t0:.1f} s, {resident / 2**30:.2f} GiB resident")
    tok = CharTokenizer(vocab_size=cfg.vocab_size)
    actor = Model("actor", train, tok, cfg)
    gen_model = Model("actor_gen", gen, tok, cfg)
    ref_model = Model("ref", ref, tok, cfg)
    critic_model = Model("critic", critic, tok, ccfg)
    actor_if = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=n, max_new_tokens=max_new, temperature=1.0),
        n_minibatches=1, disable_value=False, adv_norm=True, kl_ctl=0.1,
    )
    critic_if = PPOCriticInterface(n_minibatches=1, value_norm=True, value_norm_type="exp",
                                   kl_ctl=0.1)
    mb = MicroBatchSpec()
    rng = np.random.default_rng(seed + 8)
    steps, step1 = [], {}
    for step in range(2):
        rec = dict(step=step + 1)
        prompts, id2info = _train_prompts(rng, cfg, n_prompts)
        torch.cuda.reset_peak_memory_stats()

        def mfc(name, fn):
            torch.cuda.synchronize()
            fa.reset_launches()
            da.LAUNCHES = rpa.LAUNCHES = 0
            t = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            rec[f"{name}_s"] = time.monotonic() - t
            rec[f"{name}_launches"] = dict(fa.LAUNCHES)
            return out

        chunks0, dsteps0 = gen.static_chunks, gen.static_decode_steps
        rollout = mfc("generate", lambda: actor_if.generate(gen_model, prompts, mb))
        k4 = da.LAUNCHES
        gen_chunks = gen.static_chunks - chunks0
        gen_steps = gen.static_decode_steps - dsteps0
        check(gen_chunks >= 1 and rpa.LAUNCHES == 0, "generate did not take the static path")
        check(rec["generate_launches"] == {"fwd": cfg.n_layers * gen_chunks, "dq": 0, "dkv": 0}
              and k4 == cfg.n_layers * gen_steps,
              f"generate: K1 {rec['generate_launches']}, K4 {k4}")
        rollout.update_(MultiTaskRewardInterface(id2info=id2info).inference(actor, rollout, mb))
        rollout.data["rewards"] = rng.choice(
            [-5.0, 5.0], size=rollout.data["rewards"].shape).astype(np.float32)
        n_mbs = len(rollout.split(mb))

        # ref_inf (the JAX package's ppo-math: the actor interface's
        # inference on the ref, logprobs renamed), then its offload hook.
        ref_out = mfc("ref_inf", lambda: actor_if.inference(ref_model, rollout, mb))
        _k1_check("ref_inf", rec["ref_inf_launches"], cfg.n_layers, n_mbs, train=False)
        ref_out.remap_keys_({"logprobs": "packed_ref_logprobs"})
        rollout.update_(ref_out)
        if step == 0:
            # Before the actor's update its TrainEngine.forward (bf16
            # casts of the same masters) is the ref's computation.
            mine = actor_if.inference(actor, rollout, mb).data["logprobs"]
            rec["ref_equals_trainer_recompute"] = bool(
                np.array_equal(mine, rollout.data["packed_ref_logprobs"]))
        before = torch.cuda.memory_allocated()
        mfc("ref_offload", ref.offload)
        rec["ref_offload_freed_bytes"] = before - torch.cuda.memory_allocated()
        check(ref.params is None and rec["ref_offload_freed_bytes"] > 2.5e9,
              f"ref offload freed {rec['ref_offload_freed_bytes']} bytes")

        values = mfc("critic_inf", lambda: critic_if.inference(critic_model, rollout, mb))
        _k1_check("critic_inf", rec["critic_inf_launches"], cfg.n_layers, n_mbs, train=False)
        v = values.data["values"]
        check(v.shape == rollout.data["packed_input_ids"].shape and bool(np.isfinite(v).all()),
              "critic values malformed")
        rollout.update_(values)

        stats = mfc("actor_train", lambda: actor_if.train_step(actor, rollout, mb))
        _k1_check("actor_train", rec["actor_train_launches"], cfg.n_layers,
                  train.last_pack_stats["n_micro_batches"], train=True)
        cstats = mfc("critic_train", lambda: critic_if.train_step(critic_model, rollout, mb))
        _k1_check("critic_train", rec["critic_train_launches"], cfg.n_layers,
                  critic.last_pack_stats["n_micro_batches"], train=True)
        mfc("set_params", lambda: gen.set_params(train.get_params()))
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

        old_lp = _seq_align_minus1(rollout, "packed_logprobs")
        ref_lp = rollout.data["packed_ref_logprobs"]
        resp = np.zeros(len(old_lp), bool)
        for s0, length, pl in _extract_layout(rollout)[0]:
            resp[s0 + max(pl - 1, 0) : s0 + length - 1] = True
        diff = np.abs(ref_lp - old_lp)[resp]
        mean_v, std_v = critic_if.rms.mean_std()
        iw, akl = stats["importance_weight"], stats["approx_kl"]
        rec.update(
            ref_logp_max=float(diff.max()), ref_logp_mean=float(diff.mean()),
            importance_weight=iw, approx_kl=akl, ref_kl=stats["ref_kl"],
            actor_loss=stats["actor_loss"], actor_grad_norm=stats["grad_norm"],
            value_loss=cstats["value_loss"], value_clip_ratio=cstats["value_clip_ratio"],
            critic_grad_norm=cstats["grad_norm"], value_norm_mean=mean_v,
            value_norm_std=std_v, values_mean=float(v[resp].mean()),
            values_std=float(v[resp].std()), micro_batches=n_mbs,
            train_micro_batches=train.last_pack_stats["n_micro_batches"],
            real_tokens=train.last_pack_stats["real_tokens"],
            grid_tokens=train.last_pack_stats["grid_tokens"],
            static_chunks=gen_chunks, decode_steps=gen_steps, k4_launches=k4,
        )
        log(f"[ppo] step {step + 1}: generate {rec['generate_s']:.2f} s ({gen_chunks} static "
            f"chunk(s), {gen_steps} decode steps), ref_inf {rec['ref_inf_s']:.3f} s + offload "
            f"{rec['ref_offload_s']:.3f} s ({rec['ref_offload_freed_bytes'] / 2**30:.2f} GiB "
            f"freed), critic_inf {rec['critic_inf_s']:.3f} s, actor train "
            f"{rec['actor_train_s']:.2f} s, critic train {rec['critic_train_s']:.2f} s, "
            f"set_params {rec['set_params_s']:.2f} s; peak mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB")
        log(f"[ppo] step {step + 1}: K1 launches ref_inf {rec['ref_inf_launches']}, critic_inf "
            f"{rec['critic_inf_launches']}, actor train {rec['actor_train_launches']}, critic "
            f"train {rec['critic_train_launches']} ({n_mbs} forward micro-batch(es), "
            f"{rec['train_micro_batches']} train micro-batch(es) of {rec['real_tokens']} real / "
            f"{rec['grid_tokens']} grid tokens)")
        log(f"[ppo] step {step + 1}: |ref_logp - old_logp| over {diff.size} response tokens: "
            f"max {rec['ref_logp_max']:.4e}, mean {rec['ref_logp_mean']:.4e}; "
            f"importance_weight={iw:.6f} approx_kl={akl:.3e} ref_kl={stats['ref_kl']:.4e} "
            f"actor grad_norm={stats['grad_norm']:.4f}; value_loss={cstats['value_loss']:.4e} "
            f"value_clip_ratio={cstats['value_clip_ratio']:.3f} critic grad_norm="
            f"{cstats['grad_norm']:.4f}; value norm mean={mean_v:.6f} std={std_v:.6f}; "
            f"values (real scale) mean={rec['values_mean']:.4f} std={rec['values_std']:.4f}")
        check(stats["quarantined"] == 0.0 and cstats["quarantined"] == 0.0,
              "a step was quarantined")
        check(math.isfinite(cstats["value_loss"]), f"value_loss {cstats['value_loss']}")
        check(math.isfinite(cstats["grad_norm"]) and cstats["grad_norm"] > 0,
              f"critic grad_norm {cstats['grad_norm']} is not finite and > 0")
        check(math.isfinite(stats["grad_norm"]) and stats["grad_norm"] > 0,
              f"actor grad_norm {stats['grad_norm']} is not finite and > 0")
        if step == 0:
            log(f"[ppo] step 1: ref logprobs equal the trainer's recompute bit for bit: "
                f"{rec['ref_equals_trainer_recompute']}")
            check(rec["ref_equals_trainer_recompute"],
                  "the ref's logprobs differ from the trainer's recompute")
            check(abs(stats["ref_kl"]) < APPROX_KL_TOL,
                  f"|ref_kl| = {abs(stats['ref_kl'])} >= {APPROX_KL_TOL}")
            check(rec["ref_logp_max"] < TOKEN_LOGP_TOL,
                  f"a token's ref logprob differs by {rec['ref_logp_max']}")
            check(rec["ref_logp_mean"] < REF_LOGP_MEAN_TOL,
                  f"mean |ref - behavior logp| {rec['ref_logp_mean']} >= {REF_LOGP_MEAN_TOL}")
            check(abs(iw - 1.0) < IMP_WEIGHT_TOL,
                  f"|importance_weight - 1| = {abs(iw - 1.0)} >= {IMP_WEIGHT_TOL}")
            check(abs(akl) < APPROX_KL_TOL, f"|approx_kl| = {abs(akl)} >= {APPROX_KL_TOL}")
            step1 = dict(rollout=rollout, ref_lp=ref_lp.copy())
        else:
            # The ref went to host memory after step 1's call and came
            # back for this step's: step 1's sample through it again gives
            # step 1's logprobs bit for bit.
            again = actor_if.inference(ref_model, step1["rollout"], mb).data["logprobs"]
            same = bool(np.array_equal(again, step1["ref_lp"]))
            rec["ref_round_trip_bitwise"] = same
            log(f"[ppo] ref after the offload round trip: step 1's sample again, "
                f"bit-identical={same}; the actor moved: mean |ref - behavior logp| "
                f"{rec['ref_logp_mean']:.4e} against step 1's {steps[0]['ref_logp_mean']:.4e}")
            check(same, "the ref's logprobs changed across the offload round trip")
            check(rec["ref_logp_mean"] > steps[0]["ref_logp_mean"] and stats["ref_kl"] != 0.0,
                  "the KL term did not grow: the actor has not moved from the ref")
        steps.append(rec)
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    for rec in steps:
        for name in ("ref_inf", "critic_inf", "actor_train", "critic_train"):
            for k in launches:
                launches[k] += rec[f"{name}_launches"][k]
    report["ppo"] = dict(steps=steps, launches=launches, resident_bytes=resident)
    del train, gen, ref, critic, actor, gen_model, ref_model, critic_model, step1
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase: the trainer over a device mesh (ROADMAP queue 1, items 8.1-8.4)
# --------------------------------------------------------------------------

# The sharded engines against the unsharded ones on the same card: the
# train step's stats within IMP_WEIGHT_TOL's scale, and the params after
# two steps within one AdamW update of lr 2e-5.
SHARDED_STAT_RTOL = 1e-3
SHARDED_PARAM_ATOL = 2e-5


def _sharded_rollout(rng, cfg, n_prompts, n):
    """A post-rollout PPO batch (random tokens, logprobs near -1, values,
    rewards +-5): what the actor's and the critic's train_step consume."""
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample

    seqlens = [[int(rng.integers(64, 257)) + int(rng.integers(32, 129)) for _ in range(n)]
               for _ in range(n_prompts)]
    plens = [[int(rng.integers(16, 64)) for _ in range(n)] for _ in range(n_prompts)]
    flat = [l for r in seqlens for l in r]
    total, n_seqs = sum(flat), n_prompts * n
    pmask = np.concatenate([np.arange(l) < p for r, pr in zip(seqlens, plens)
                            for l, p in zip(r, pr)])
    data = {
        "packed_input_ids": rng.integers(0, cfg.vocab_size, total).astype(np.int32),
        "prompt_mask": pmask,
        "packed_logprobs": rng.normal(-1.0, 0.3, total - n_seqs).astype(np.float32),
        "packed_ref_logprobs": rng.normal(-1.1, 0.3, total - n_seqs).astype(np.float32),
        "values": rng.normal(0.0, 1.0, total).astype(np.float32),
        "rewards": rng.choice([-5.0, 5.0], n_seqs).astype(np.float32),
        "seq_no_eos_mask": np.zeros(n_seqs, np.float32),
    }
    return SequenceSample(
        keys=set(data), ids=[f"q{i}" for i in range(n_prompts)],
        seqlens={
            "packed_input_ids": [list(r) for r in seqlens],
            "prompt_mask": [list(r) for r in seqlens],
            "values": [list(r) for r in seqlens],
            "packed_logprobs": [[l - 1 for l in r] for r in seqlens],
            "packed_ref_logprobs": [[l - 1 for l in r] for r in seqlens],
            "rewards": [[1] * n] * n_prompts,
            "seq_no_eos_mask": [[1] * n] * n_prompts,
        },
        data=data,
    )


def _sharded_train(cfg, mesh, seed):
    """(a): the actor and the critic as DTensors placed by the rules take
    two PPO train steps through PPOActorInterface / PPOCriticInterface,
    beside unsharded engines from the same weights on the same batch."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import (
        FinetuneSpec, GenerationHyperparameters, Model, OptimizerConfig,
    )
    from areal_tpu_torch.engines.train import TrainEngine, _leaves
    from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.parallel import sharding

    oc = OptimizerConfig(lr=2e-5, warmup_steps_proportion=0.0)
    ft = FinetuneSpec(1, 64, 8)
    mb = MicroBatchSpec()
    rng = np.random.default_rng(seed + 41)
    rollout = _sharded_rollout(rng, cfg, 8, 4)
    n_mbs = len(rollout.split(mb))
    logp_noise = {"packed_logprobs": 0.02, "packed_ref_logprobs": 0.05}
    rec = {"launches": {"fwd": 0, "dq": 0, "dkv": 0}, "bitwise": True}
    roles = (
        ("actor", cfg, "actor_loss", lambda: PPOActorInterface(
            gconfig=GenerationHyperparameters(n=4, max_new_tokens=128), n_minibatches=1,
            disable_value=False, adv_norm=True, kl_ctl=0.1)),
        ("critic", cfg.as_critic(), "value_loss", lambda: PPOCriticInterface(
            n_minibatches=1, value_norm=True, value_norm_type="exp", kl_ctl=0.1)),
    )
    for i, (role, rcfg, loss_key, make_if) in enumerate(roles):
        params = init_params(rcfg, seed + 42 + i, device="cuda")
        plain = TrainEngine(rcfg, params, optimizer_config=oc, ftspec=ft, remat_policy="full")
        shard = TrainEngine(rcfg, params, optimizer_config=oc, ftspec=ft, remat_policy="full",
                            mesh=mesh)
        del params
        if role == "actor":
            # Behaviour and ref logprobs near the policy's own, so the
            # importance ratios are near 1 and the clipped loss has a
            # gradient (random ones far from it clip every token).
            for key, sd in logp_noise.items():
                out = make_if().inference(Model(role, plain, None, rcfg), rollout, mb)
                lp = out.data["logprobs"]
                out.data["logprobs"] = (lp + rng.normal(0.0, sd, lp.shape)).astype(np.float32)
                out.remap_keys_({"logprobs": key})
                rollout.update_(out)
        want = sharding.param_placements(plain.params, mesh)
        for name, p in _leaves(shard.params):
            check(isinstance(p, DTensor) and p.is_cuda and tuple(p.placements)
                  == tuple(dict(_leaves(want))[name]), f"{role} {name}: not placed by its rule")
        ifs = {"plain": make_if(), "sharded": make_if()}
        models = {"plain": Model(role, plain, None, rcfg), "sharded": Model(role, shard, None, rcfg)}
        for step in range(2):
            outs = {}
            for tag in ("plain", "sharded"):
                torch.cuda.synchronize()
                fa.reset_launches()
                t0 = time.monotonic()
                outs[tag] = ifs[tag].train_step(models[tag], rollout, mb)
                torch.cuda.synchronize()
                rec[f"{role}_{tag}_step{step + 1}_s"] = time.monotonic() - t0
                _k1_check(f"[sharded] {role} {tag} step {step + 1}", dict(fa.LAUNCHES),
                          rcfg.n_layers, n_mbs, train=True)
                if tag == "sharded":
                    for k in rec["launches"]:
                        rec["launches"][k] += fa.LAUNCHES[k]
            p, s = outs["plain"], outs["sharded"]
            for key in (loss_key, "grad_norm"):
                # The actor loss is a cancelling sum near 0: relative to
                # max(|loss|, 1).
                scale = max(abs(p[key]), 1.0 if key == loss_key else 1e-30)
                rel = abs(s[key] - p[key]) / scale
                rec[f"{role}_step{step + 1}_{key}_rel"] = rel
                rec["bitwise"] &= s[key] == p[key]
                log(f"[sharded] {role} step {step + 1}: {key} sharded={s[key]!r} "
                    f"unsharded={p[key]!r} rel={rel:.3e} (tolerance {SHARDED_STAT_RTOL:g})")
                check(np.isfinite(s[key]) and rel <= SHARDED_STAT_RTOL,
                      f"{role} step {step + 1}: sharded {key} disagrees")
        with torch.no_grad():
            diff = max(float((a.full_tensor().float() - b.float()).abs().max())
                       for (_, a), (_, b) in zip(_leaves(shard.params), _leaves(plain.params)))
        rec[f"{role}_param_max_abs_diff"] = diff
        rec["bitwise"] &= diff == 0.0
        log(f"[sharded] {role} params after two steps: max |sharded - unsharded| = {diff:.3e} "
            f"(tolerance {SHARDED_PARAM_ATOL:g})")
        check(diff <= SHARDED_PARAM_ATOL, f"{role}: sharded params disagree after two steps")
        if role == "actor":
            # masked_moments through NCCL's all-reduce, against the
            # unsharded engine and numpy.
            vals = np.asarray(rollout.data["values"], np.float64)
            mask = np.asarray(rollout.data["prompt_mask"], np.float32) < 0.5
            probe = SequenceSample(
                keys={"packed_input_ids", "values", "loss_mask"}, ids=list(rollout.ids),
                seqlens={k: rollout.seqlens["packed_input_ids"]
                         for k in ("packed_input_ids", "values", "loss_mask")},
                data={"packed_input_ids": rollout.data["packed_input_ids"],
                      "values": rollout.data["values"], "loss_mask": mask.astype(np.float32)},
            )
            got = shard.masked_moments(probe, mb, ("values",))
            ref = plain.masked_moments(probe, mb, ("values",))
            v = vals[mask]
            oracle = np.array([v.sum(), (v * v).sum(), np.abs(v).sum()])
            err = float(np.max(np.abs(got["values"] - oracle) / np.abs(oracle)))
            rec["moments_rel_err"] = err
            log(f"[sharded] masked_moments over NCCL: count {got['count']:.0f} (numpy "
                f"{mask.sum()}), [sum, sum sq, abs sum] {got['values'].tolist()} against "
                f"numpy rel {err:.2e}, the unsharded engine's equal: "
                f"{bool(np.array_equal(got['values'], ref['values']))}")
            check(got["count"] == mask.sum() and err <= 1e-5,
                  "masked_moments over the mesh disagrees with numpy")
        del plain, shard, models
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _sharded_heads(seed):
    """(b): flash_attention_sharded's per-rank body for a model axis of
    2 (each head shard one launch of K1f, K1dq and K1dkv) concatenated
    against K1 over all heads and against the plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import make_packed_mask, packed_attention_reference

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 43)
    b, s, hq, hkv, d, m = 4, 2048, 12, 2, 128, 2
    seg_np, lens = _packed_rows(rng, b, s)
    seg = torch.from_numpy(seg_np).to(dev)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
        for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    )

    def run(qq, kk, vv, dd):
        qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (qq, kk, vv))
        o = fa.flash_attention(qq, kk, vv, seg)
        o.backward(dd)
        return o.detach(), qq.grad, kk.grad, vv.grad

    def heads(x, j):  # rank j's contiguous slice of x's heads (Shard(2) over m)
        h = x.shape[2] // m
        return x[:, :, j * h: (j + 1) * h]

    full = run(q, k, v, do)
    torch.cuda.synchronize()
    fa.reset_launches()
    parts = [run(*(heads(x, j) for x in (q, k, v, do))) for j in range(m)]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    check(launches == {"fwd": m, "dq": m, "dkv": m},
          f"head shards: K1 launches {launches}, want {m} of each form")
    got = [torch.cat([p[i] for p in parts], dim=2) for i in range(4)]
    names = ("o", "dq", "dk", "dv")
    bitwise = {n: bool(torch.equal(g, f)) for n, g, f in zip(names, got, full)}
    vs_full = {n: _row_err(g, f)[0] for n, g, f in zip(names, got, full)}
    plain = packed_attention_reference(q.float(), k.float(), v.float(), seg)
    rel, err = _row_err(got[0], plain)
    log(f"[sharded] head shards (m={m}: {hq // m}q/{hkv // m}kv a rank) concatenated "
        f"against K1 over all heads: bit for bit {bitwise}, row_err {vs_full} (tolerance "
        f"{FLASH_ROW_TOL['bf16']:.3e}); o against the plain version: row_err={rel:.3e}")
    check(max(vs_full.values()) <= FLASH_ROW_TOL["bf16"] and rel <= FLASH_ROW_TOL["bf16"],
          "the head shards disagree with K1 over all heads")
    seg32 = seg.to(torch.int32).contiguous()
    shards = [tuple(heads(x, j).contiguous() for x in (q, k, v)) for j in range(m)]

    def sharded_fwd():
        return [fa.flash_fwd(*sh, seg32, True) for sh in shards]

    mask = make_packed_mask(seg)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = timings(
        sharded_fwd, lambda: packed_attention_reference(q, k, v, seg),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
        iters=10)
    bound = _flash_bounds(lens, b, s, hq, hkv, d, 2)["fwd"]
    log(f"[sharded] K1f over 2 head shards (both ranks' bodies, one card): "
        f"kernel_ms={times['kernel_ms']:.4f} plain_ms={times['plain_ms']:.4f} "
        f"library_ms={times['library_ms']:.4f} (device, graph replays); eager "
        f"kernel={times['kernel_eager_ms']:.4f}; bound_ms={bound[0]:.5f} ({bound[1]})")
    return dict(launches=launches, bitwise=bitwise, row_err_vs_full=vs_full, row_err=rel,
                max_abs_err=err, times=times, bound=bound)


def phase_sharded(report, seed):
    """The trainer over a device mesh at qwen2-1.5B's width (CUT_LAYERS
    layers, bf16 compute): a real NCCL world of one rank and a one-rank
    DeviceMesh; (a) the sharded actor and critic against unsharded
    engines over two PPO train steps, masked_moments through NCCL;
    (b) flash_attention_sharded's per-rank body for a model axis of 2;
    (c) K1's launches counted exactly."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from areal_tpu_torch.base import distributed, network
    from areal_tpu_torch.base.topology import ParallelConfig, make_mesh
    from areal_tpu_torch.models.config import qwen2_config

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    distributed.initialize("chip_smoke", "sharded", 0, 1, device="cuda",
                           init_method=f"tcp://127.0.0.1:{network.find_free_port()}")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"world: {dist.get_backend()} x {dist.get_world_size()}")
        mesh = make_mesh(ParallelConfig(), device="cuda")
        log(f"[sharded] NCCL world of 1 rank, mesh {mesh}; qwen2-1.5b at {cfg.n_layers} "
            f"layers ({cfg.n_q_heads}q/{cfg.n_kv_heads}kv heads, head_dim {cfg.head_dim})")
        t0 = time.monotonic()
        a = _sharded_train(cfg, mesh, seed)
        a["s"] = time.monotonic() - t0
        log(f"[sharded] (a) {a['s']:.1f} s; K1 launches of the sharded engines {a['launches']} "
            f"(= {cfg.n_layers} layers x (2, 1, 1) x 4 train calls); bit for bit against "
            f"the unsharded engines: {a['bitwise']}")
        t0 = time.monotonic()
        b = _sharded_heads(seed)
        b["s"] = time.monotonic() - t0
    finally:
        distributed.shutdown()
    report["sharded"] = {"train": a, "heads": b}
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# quickstart: the system's own entry point
# --------------------------------------------------------------------------

QUICKSTART_DIR = os.path.join(REPO, ".quickstart_tmp")


def _math_rows(rng, n):
    """n math rows written here (nothing is downloaded), prompts of 64-512
    bytes: a sum to compute, padded with words."""
    words = "the quick brown fox jumps over lazy dog math proof integer prime sum".split()
    rows = []
    for i in range(n):
        a, b = (int(x) for x in rng.integers(1, 1000, 2))
        text = f"Compute {a} + {b}. "
        target = int(rng.integers(64, 513))
        while len(text) < target:
            text += words[int(rng.integers(len(words)))] + " "
        rows.append({"query_id": f"q{i}", "prompt": text[:target], "task": "math",
                     "solutions": [f"\\boxed{{{a + b}}}"]})
    return rows


def _adamw_bound(lrs, beta1, beta2, weight_decay, w_max):
    """The most AdamW can move one element in updates at learning rates
    `lrs`: update t moves it by at most lr_t (c_t + wd |w|), where
    c_t = sqrt(sum_i a_i^2 / b_i) bounds |m_hat / sqrt(v_hat)| (Cauchy-
    Schwarz over the bias-corrected weights a_i of the gradients in the
    first moment and b_i of their squares in the second; eps only
    shrinks it)."""
    total, w = 0.0, w_max
    for t, lr in enumerate(lrs, start=1):
        c2 = sum(
            ((1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)) ** 2
            / ((1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t))
            for i in range(1, t + 1)
        )
        step = lr * (math.sqrt(c2) + weight_decay * w)
        total, w = total + step, w + step
    return total


def _shard_headers(path):
    from areal_tpu_torch.models.hf import safetensors_io

    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors"):
            header, _ = safetensors_io.read_header(os.path.join(path, f))
            header.pop("__metadata__", None)
            out.update(header)
    return out


def _trial_counts():
    """Every kernel's launch count so far."""
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    return dict(fa.LAUNCHES, k4=da.LAUNCHES, k2=rpa.LAUNCHES, k3=pca.LAUNCHES)


def _reset_counts():
    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa

    fa.reset_launches()
    da.LAUNCHES = rpa.LAUNCHES = pca.LAUNCHES = 0


def _fp32_model_bytes(cfg):
    """Bytes of a dense model's fp32 weights (tied embeddings)."""
    return 4 * (cfg.vocab_size * cfg.hidden_dim + cfg.n_layers * (
        2 * cfg.hidden_dim * cfg.q_dim + 2 * cfg.hidden_dim * cfg.kv_dim
        + 3 * cfg.hidden_dim * cfg.intermediate_dim))


def _check_disk(tag, path, need):
    import shutil

    free = shutil.disk_usage(path).free
    log(f"{tag} disk: {free / 2**30:.1f} GiB free under {path}, {need / 2**30:.1f} GiB needed")
    check(free >= need, f"{tag} only {free / 2**30:.1f} GiB free for the phase's "
          f"checkpoints; {need / 2**30:.1f} GiB needed")


def _write_random_checkpoint(tag, work, cfg, seed):
    """A seeded random checkpoint written by the port's
    save_hf_checkpoint into work/ckpt (fp32, two shards and an index);
    returns (path, seconds, bytes)."""
    import torch

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.transformer import init_params

    ckpt = os.path.join(work, "ckpt")
    t = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    hf.save_hf_checkpoint(ckpt, cfg, params, model_type="qwen2")
    del params
    torch.cuda.empty_cache()
    write_s = time.monotonic() - t
    files = sorted(os.listdir(ckpt))
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
    shards = [f for f in files if f.endswith(".safetensors")]
    log(f"{tag} wrote a seeded random qwen2-1.5b checkpoint ({cfg.n_layers} layers) with "
        "save_hf_checkpoint: "
        f"{ckpt_bytes / 1e9:.3f} GB fp32 in {write_s:.2f} s "
        f"({ckpt_bytes / 1e9 / write_s:.2f} GB/s): {files}")
    if cfg.n_layers == qwen2_config("1.5b").n_layers:  # 6.2 GB over the 5 GiB shard cap
        check(len(shards) == 2 and "model.safetensors.index.json" in files,
              f"the checkpoint is not two shards and an index: {files}")
    else:  # a cut depth fits one shard
        check(shards == ["model.safetensors"], f"the checkpoint is not one shard: {files}")
    return ckpt, write_s, ckpt_bytes


def _record_checkpoint_io(wrap, rec):
    """Time every checkpoint load (rec["loads"]: seconds) and every
    interface save (rec["saves"]: (dir, seconds))."""
    import functools

    import torch

    from areal_tpu_torch.interfaces import sft
    from areal_tpu_torch.models.hf import registry as hf

    def on_load(orig):
        @functools.wraps(orig)
        def load(*a, **k):
            t0 = time.monotonic()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            rec["loads"].append(time.monotonic() - t0)
            return out
        return load

    def on_save(orig):
        @functools.wraps(orig)
        def save(self, model, save_dir):
            t0 = time.monotonic()
            orig(self, model, save_dir)
            rec["saves"].append((save_dir, time.monotonic() - t0))
        return save

    wrap(hf, "load_hf_checkpoint", on_load)
    wrap(sft.SFTInterface, "save", on_save)


def _record_trial_steps(wrap, rec, cur):
    """Wrap (through `wrap`, which records what to restore) the master's
    step and the engines' calls, so each step of a `quickstart.main`
    trial appends a record to rec["steps"]: its number, the kernels'
    launches in the step, the static chunks and decode steps generate
    ran, the forward micro-batches of the ref and of the train engine,
    each train_batch call's stats, micro-batches and lr, and the step's
    peak memory.  `cur` is the step in progress."""
    import functools

    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.system.master import MasterWorker

    def on_step(orig):
        async def execute_step(self):
            torch.cuda.synchronize()
            if "resident_bytes" not in rec:
                rec["resident_bytes"] = torch.cuda.memory_allocated()
                rec["plan_nodes"] = [(nd.name, nd.interface_type) for nd in self.dfg.nodes]
            torch.cuda.reset_peak_memory_stats()
            cur.clear()
            cur.update(step=self.step_info.global_step + 1, gen_chunks=0, decode_steps=0,
                       ref_fwd_mbs=0, train_fwd_mbs=0, train_calls=[],
                       counts0=_trial_counts())
            stats = await orig(self)
            torch.cuda.synchronize()
            c1 = _trial_counts()
            cur["launches"] = {k: c1[k] - cur["counts0"][k] for k in c1}
            cur["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            cur["stats"] = stats
            rec["steps"].append(dict(cur))
            return stats
        return execute_step

    def on_generate(orig):
        @functools.wraps(orig)
        def generate(self, *a, **k):
            c0, s0 = self.static_chunks, self.static_decode_steps
            out = orig(self, *a, **k)
            cur["gen_chunks"] += self.static_chunks - c0
            cur["decode_steps"] += self.static_decode_steps - s0
            return out
        return generate

    def on_forward(key):
        def make(orig):
            @functools.wraps(orig)
            def forward(self, sample, mb_spec, *a, **k):
                cur[key] += len(sample.split(mb_spec))
                return orig(self, sample, mb_spec, *a, **k)
            return forward
        return make

    def on_train_batch(orig):
        @functools.wraps(orig)
        def train_batch(self, *a, **k):
            lr = self.lr_schedule(self.opt_count)
            out = orig(self, *a, **k)
            cur["train_calls"].append(dict(
                stats=out, mbs=self.last_pack_stats["n_micro_batches"], lr=lr,
                oc=self.optimizer_config))
            return out
        return train_batch

    wrap(MasterWorker, "execute_step", on_step)
    wrap(GeneratorEngine, "generate", on_generate)
    wrap(InferenceEngine, "forward", on_forward("ref_fwd_mbs"))
    wrap(TrainEngine, "forward", on_forward("train_fwd_mbs"))
    wrap(TrainEngine, "train_batch", on_train_batch)


def _check_step_launches(tag, step, st, nodes, n_layers, max_new, gen_chunks=(1, 1)):
    """A step's launches (st: one record of _record_trial_steps) against
    the launches each MFC of the DFG `nodes` must make, from the engines'
    own calls: generate one prefill (K1f) a static chunk and one K4 a
    decode step; ref_inf one K1f a forward micro-batch; each train_batch
    (or streamed chunk) of actor_train two forwards (remat "full"), one
    dq and one dkv a micro-batch.  K2 and K3 (the serving plane) run no
    time.  Generation takes between gen_chunks[0] and gen_chunks[1]
    static chunks (the streamed step's generate node serves the pipeline
    chunks waiting on it in one burst), the K1f launches of every thread
    summed."""
    from areal_tpu_torch.api.config import ModelInterfaceType

    L = n_layers
    train_mbs = sum(c["mbs"] for c in st["train_calls"])
    per_node = {}
    for name, itype in nodes:
        if itype == ModelInterfaceType.GENERATE:
            per_node[name] = dict(fwd=L * st["gen_chunks"], k4=L * st["decode_steps"])
        elif itype == ModelInterfaceType.TRAIN_STEP:
            per_node[name] = dict(fwd=L * (2 * train_mbs + st["train_fwd_mbs"]),
                                  dq=L * train_mbs, dkv=L * train_mbs)
        elif name == "ref_inf":
            per_node[name] = dict(fwd=L * st["ref_fwd_mbs"])
    want = {k: sum(d.get(k, 0) for d in per_node.values()) for k in ("fwd", "dq", "dkv", "k4")}
    want.update(k2=0, k3=0)
    log(f"{tag} step {step}: launches {st['launches']}; from the DFG {per_node} "
        f"({st['gen_chunks']} static chunk(s), {st['decode_steps']} decode steps, "
        f"{st['ref_fwd_mbs']} ref micro-batch(es), {len(st['train_calls'])} minibatch "
        f"train_batch call(s) of {train_mbs} micro-batch(es))")
    check(st["launches"] == want, f"{tag} step {step}: launches {st['launches']} != {want}")
    lo, hi = gen_chunks
    check(lo <= st["gen_chunks"] <= hi
          and st["gen_chunks"] <= st["decode_steps"] <= st["gen_chunks"] * (max_new - 1),
          f"{tag} step {step}: generate took {st['gen_chunks']} static chunks, "
          f"{st['decode_steps']} decode steps")


def phase_quickstart(report, seed):
    """`python -m areal_tpu_torch.apps.quickstart ppo-math` at qwen2-1.5B,
    in this process: a seeded random checkpoint written by the port's
    save_hf_checkpoint (fp32, two shards and an index), 64 math rows
    written here, then quickstart.main over them with a ref model from the
    same checkpoint, KL control, 8 prompts x 4 responses, 128 new tokens,
    two steps and a save at step 2.  The graded rewards (all -5 for a
    random model, so no update) are replaced by seeded +-5."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.interfaces.ppo import (
        PPOActorInterface, _extract_layout, _seq_align_minus1,
    )
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import safetensors_io

    cfg = qwen2_config("1.5b")
    n_prompts, n, max_new, n_steps = 8, 4, 128, 2
    rng = np.random.default_rng(seed + 20)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    try:
        # Two fp32 copies of the model (the checkpoint, the step-2 save)
        # and the margin the trial's logs need.
        _check_disk("[quickstart]", work, 2 * _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, write_s, ckpt_bytes = _shared_checkpoint("[quickstart]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(rng, 64):
                f.write(json.dumps(row) + "\n")

        # Instrumentation: per-step records from the engines' own calls.
        rec = {"steps": [], "loads": [], "saves": []}
        cur = {}
        _record_trial_steps(wrap, rec, cur)

        def on_actor_train(orig):
            @functools.wraps(orig)
            def train_step(self, model, sample, mb_spec):
                old_lp = _seq_align_minus1(sample, "packed_logprobs")
                ref_lp = _seq_align_minus1(sample, "packed_ref_logprobs")
                resp = np.zeros(len(old_lp), bool)
                for s0, length, pl in _extract_layout(sample)[0]:
                    resp[s0 + max(pl - 1, 0): s0 + length - 1] = True
                diff = np.abs(ref_lp - old_lp)[resp]
                cur["ref_logp_max"], cur["ref_logp_mean"] = float(diff.max()), float(diff.mean())
                cur["response_tokens"] = int(resp.sum())
                return orig(self, model, sample, mb_spec)
            return train_step

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                cur["graded_rewards"] = out.data["rewards"].tolist()
                out.data["rewards"] = rng.choice(
                    [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
                return out
            return inference

        wrap(PPOActorInterface, "train_step", on_actor_train)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        _record_checkpoint_io(wrap, rec)

        argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt,
            "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
            "--max-new-tokens", str(max_new), "--benchmark-steps", str(n_steps),
            "--save-freq-steps", str(n_steps), "--fileroot", os.path.join(work, "trial"),
            "--seed", str(seed + 22),
        ]
        log(f"[quickstart] python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
        log("[quickstart] the graded rewards are replaced by seeded +-5 (a random model's "
            "are all -5, which gives GRPO no advantage)")
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t = time.monotonic()
            stats = quickstart.main(argv)
            torch.cuda.synchronize()
            trial_s = time.monotonic() - t
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)
        check(len(stats) == n_steps and len(rec["steps"]) == n_steps,
              f"{len(stats)} steps of stats, {len(rec['steps'])} recorded")
        check(len(rec["loads"]) == 3, f"{len(rec['loads'])} checkpoint loads, want 3 "
              "(actor, actor_gen, ref)")
        nodes = rec["plan_nodes"]
        log(f"[quickstart] DFG: {[f'{nm} ({it.value})' for nm, it in nodes]}; "
            f"checkpoint loads {['%.2f s' % s for s in rec['loads']]}; trial {trial_s:.1f} s; "
            f"resident after setup {rec['resident_bytes'] / 2**30:.2f} GiB")
        L = cfg.n_layers
        steps_out = []
        for i, st in enumerate(rec["steps"]):
            s = st["stats"]
            check(all(math.isfinite(v) for v in s.values()),
                  f"step {i + 1}: non-finite stats {[k for k, v in s.items() if not math.isfinite(v)]}")
            check(s["actor_train/quarantined"] == 0.0, f"step {i + 1} was quarantined")
            _check_step_launches("[quickstart]", i + 1, st, nodes, L, max_new)
            first = st["train_calls"][0]["stats"]
            mfc = {k.split("/")[0]: v for k, v in s.items() if k.endswith("/perf/time_s")}
            rec_out = dict(
                step_s=s["time/step_s"], mfc_s=mfc,
                train_mfu=s.get("actor_train/perf/mfu"),
                generate_mfu=s.get("actor_gen/perf/mfu"), ref_mfu=s.get("ref_inf/perf/mfu"),
                train_tflops=s["actor_train/perf/tflops"],
                peak_mem_bytes=st["peak_mem_bytes"], launches=st["launches"],
                first_importance_weight=first["importance_weight"],
                first_approx_kl=first["approx_kl"],
                importance_weight=s["actor_train/importance_weight"],
                approx_kl=s["actor_train/approx_kl"], ref_kl=s["actor_train/ref_kl"],
                ref_logp_max=st["ref_logp_max"], ref_logp_mean=st["ref_logp_mean"],
                actor_loss=s["actor_train/actor_loss"], grad_norm=s["actor_train/grad_norm"],
                decode_steps=st["decode_steps"],
                train_micro_batches=sum(c["mbs"] for c in st["train_calls"]),
            )
            steps_out.append(rec_out)
            log(f"[quickstart] step {i + 1}: {s['time/step_s']:.2f} s; by MFC (s) "
                f"{ {k: round(v, 3) for k, v in mfc.items()} }; MFU actor_train "
                f"{rec_out['train_mfu']}, actor_gen {rec_out['generate_mfu']}, ref_inf "
                f"{rec_out['ref_mfu']}; peak {st['peak_mem_bytes'] / 2**30:.2f} GiB")
            log(f"[quickstart] step {i + 1}: first minibatch importance_weight="
                f"{first['importance_weight']:.6f} approx_kl={first['approx_kl']:.3e}; step "
                f"importance_weight={s['actor_train/importance_weight']:.6f} approx_kl="
                f"{s['actor_train/approx_kl']:.3e} ref_kl={s['actor_train/ref_kl']:.3e}; "
                f"|ref - behaviour logp| over {st['response_tokens']} response tokens: max "
                f"{st['ref_logp_max']:.4e} mean {st['ref_logp_mean']:.4e}; actor_loss="
                f"{s['actor_train/actor_loss']:.4e} grad_norm={s['actor_train/grad_norm']:.4f}")
            if i == 0:
                # Before any update actor, generator and ref hold the
                # checkpoint's weights: the first minibatch's ratio is 1.
                check(abs(first["importance_weight"] - 1.0) < IMP_WEIGHT_TOL,
                      f"|importance_weight - 1| = {abs(first['importance_weight'] - 1.0)}")
                check(abs(first["approx_kl"]) < APPROX_KL_TOL,
                      f"|approx_kl| = {abs(first['approx_kl'])}")
                check(abs(s["actor_train/ref_kl"]) < APPROX_KL_TOL,
                      f"|ref_kl| = {abs(s['actor_train/ref_kl'])}")
                check(st["ref_logp_max"] < TOKEN_LOGP_TOL and st["ref_logp_mean"] < REF_LOGP_MEAN_TOL,
                      f"|ref - behaviour logp| max {st['ref_logp_max']}, mean {st['ref_logp_mean']}")

        check(total == {k: sum(st["launches"][k] for st in rec["steps"]) for k in total}
              and all(total[k] > 0 for k in ("fwd", "dq", "dkv", "k4")),
              f"launches over the trial {total}: outside the steps, or a kernel never ran")

        # The step-2 save: the checkpoint's keys and shapes, fp32, and the
        # update: non-zero, within what AdamW can move an element.
        check(len(rec["saves"]) == 1, f"saves: {rec['saves']}")
        saved, save_s = rec["saves"][0]
        want_h, got_h = _shard_headers(ckpt), _shard_headers(saved)
        check({k: v["shape"] for k, v in got_h.items()} == {k: v["shape"] for k, v in want_h.items()},
              "the saved checkpoint's tensors differ from the loaded one's")
        check({v["dtype"] for v in got_h.values()} == {"F32"}, "the saved checkpoint is not fp32")
        updates = [c for st in rec["steps"] for c in st["train_calls"]
                   if c["stats"]["quarantined"] == 0.0]
        oc = updates[0]["oc"]
        lrs = [c["lr"] for c in updates]
        before, after = {}, {}
        for path, into in ((ckpt, before), (saved, after)):
            for f in sorted(os.listdir(path)):
                if f.endswith(".safetensors"):
                    into.update(safetensors_io.load_file(os.path.join(path, f)))
        largest, worst = 0.0, 0.0
        for name, w0 in before.items():
            w0 = w0.cuda()
            delta = float((after[name].cuda() - w0).abs().max())
            bound = _adamw_bound(lrs, oc.beta1, oc.beta2, oc.weight_decay, float(w0.abs().max()))
            largest, worst = max(largest, delta), max(worst, delta / bound)
            check(delta <= bound, f"{name}: moved {delta}, more than AdamW's bound {bound}")
        del before, after
        log(f"[quickstart] step-2 save: {saved} in {save_s:.2f} s; {len(updates)} AdamW updates "
            f"at lr {lrs[0]:g}: largest change {largest:.3e}, at most {worst:.3f} of its "
            f"tensor's bound")
        check(largest > 0.0, "the saved weights equal the loaded ones: no update")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    report["quickstart"] = dict(
        steps=steps_out, launches=total, resident_bytes=rec["resident_bytes"],
        ckpt_write_s=write_s, ckpt_bytes=ckpt_bytes, ckpt_load_s=rec["loads"],
        save_s=save_s, trial_s=trial_s, largest_update=largest,
    )


# --------------------------------------------------------------------------
# sft and overlap: SFT, the streamed step and the sentinels at full size
# --------------------------------------------------------------------------

# Seeded random checkpoints written once and shared by the phases that
# read them ((seed, layers) -> (dir, path, write seconds, bytes)); removed
# after the last phase that uses them.
SHARED_CKPTS = {}
CKPT_PHASES = ("quickstart", "sft", "overlap", "trainmodes", "recover", "genmodes", "async",
               "multiproc", "group", "fabric", "verifiers", "supervisor", "chaos")


def _shared_checkpoint(tag, cfg, seed):
    """The seeded random qwen2-1.5b checkpoint of `_write_random_checkpoint`
    at `cfg`'s depth, written on the first call for (`seed`, depth) and
    reused after it."""
    key = (seed, cfg.n_layers)
    if key not in SHARED_CKPTS:
        os.makedirs(QUICKSTART_DIR, exist_ok=True)
        work = tempfile.mkdtemp(prefix="ckpt-", dir=QUICKSTART_DIR)
        _check_disk(tag, work, _fp32_model_bytes(cfg) + 2**30)
        SHARED_CKPTS[key] = (work,) + _write_random_checkpoint(tag, work, cfg, seed)
    else:
        log(f"{tag} reading the seeded random checkpoint written earlier: {SHARED_CKPTS[key][1]}")
    return SHARED_CKPTS[key][1:]


def _release_shared_checkpoints():
    import shutil

    for work, *_ in SHARED_CKPTS.values():
        shutil.rmtree(work, ignore_errors=True)
    SHARED_CKPTS.clear()


def _sft_rows(rng, n):
    """n prompt/answer rows written here: _math_rows' prompts (64-512
    bytes) and answers of 32-128 bytes."""
    rows = []
    for i, r in enumerate(_math_rows(rng, n)):
        total = r["solutions"][0][len("\\boxed{"):-1]
        answer = f"The sum is {total}. "
        target = int(rng.integers(32, 129))
        while len(answer) < target:
            answer += f"Check: {total} is the sum. "
        rows.append({"id": f"s{i}", "prompt": r["prompt"], "answer": answer[:target]})
    return rows


def _capture_trials(wrap, masters):
    """Wrap (through `wrap`) the port's run_experiment so that each trial
    quickstart.main runs leaves its master in `masters`."""
    from areal_tpu_torch.experiments import common

    def on_run(orig):
        def run_experiment(*a, **k):
            master, stats = orig(*a, **k)
            masters.append(master)
            return master, stats
        return run_experiment

    wrap(common, "run_experiment", on_run)


SFT_PARITY_SEED = 63  # phase_sft's parity weights: init_params(seed + this)


def _sft_parity_run(seed, rows, dev):
    """SFTInterface.train_step and evaluate on one batch of `rows` at
    qwen2-1.5B width, 2 layers, fp32, on `dev`: loss, grad_norm,
    eval_nll, and the inputs' fingerprint."""
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import FinetuneSpec, Model, OptimizerConfig
    from areal_tpu_torch.data.datasets import PromptAnswerDataset
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.sft import SFTInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    base = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=2)
    tok = CharTokenizer(base.vocab_size)
    ds = PromptAnswerDataset(seed, 0, 1, tok, max_length=256, dataset_builder=lambda: rows[:4])
    sample = SequenceSample.gather([ds[i] for i in range(len(ds))])
    params = init_params(base, seed, device="cpu")
    eng = TrainEngine(base, params, dev, compute_dtype=torch.float32,
                      optimizer_config=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
                      ftspec=FinetuneSpec(1, 8, 8))
    model = Model("default", eng, tok, base)
    t0 = time.monotonic()
    st = SFTInterface().train_step(model, sample, MicroBatchSpec())
    ev = SFTInterface().evaluate(model, [sample])
    return dict(out=dict(loss=st["loss"], grad_norm=st["grad_norm"], eval_nll=ev["eval_nll"]),
                secs=time.monotonic() - t0, bs=sample.bs,
                tokens=sample.total_len("packed_input_ids"),
                inputs=(_inputs_print(params), sample.data["packed_input_ids"].tolist()))


def _sft_parity_cpu(seed):
    import numpy as np

    rows = _sft_rows(np.random.default_rng(seed + 60), 80)[:64]  # phase_sft's train rows
    return _sft_parity_run(seed + SFT_PARITY_SEED, rows, "cpu")


def _sft_parity(seed, rows):
    """SFTInterface.train_step and evaluate on one batch of the phase's
    rows at qwen2-1.5B width, 2 layers, fp32: the card (K1 kernels)
    against the CPU (plain path, computed by the CPU references' child),
    same weights and batch: loss, grad_norm and eval_nll within 1e-4 of
    each other (relative), as train_parity holds the GRPO step."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {"cuda": _sft_parity_run(seed, rows, "cuda")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    runs["cpu"] = _cpu_ref("sft")
    check(runs["cpu"]["inputs"] == runs["cuda"]["inputs"],
          "[sft] parity: the CPU reference ran on other inputs")
    out = {dev: r["out"] for dev, r in runs.items()}
    for dev, r in runs.items():
        log(f"[sft] parity {dev}: {r['out']} ({r['secs']:.1f} s)")
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
           for k in out["cpu"]}
    log(f"[sft] parity, 2 layers fp32, {runs['cuda']['bs']} rows of {runs['cuda']['tokens']} "
        f"tokens: card against CPU, relative differences {rel} (bound 1e-4)")
    check(all(v <= 1e-4 for v in rel.values()), f"sft card vs CPU: {rel}")
    return rel


def phase_sft(report, seed):
    """`python -m areal_tpu_torch.apps.quickstart sft` at qwen2-1.5B in
    this process: the seeded random checkpoint (shared with quickstart
    and overlap), 64 prompt/answer rows written here, batch 8, two steps
    and a save at step 2; then SFTInterface.evaluate on the trained model
    over 16 more rows; the step-2 save reloaded; a third step, from the
    save, with --anomaly-update-norm-max at half of step 2's update norm
    (quarantined: the weights stay as loaded, bit for bit); and the loss,
    grad norm and eval NLL of one step at 2 layers, fp32, card against
    CPU."""
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import Model
    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.data.datasets import PackedDataLoader, PromptAnswerDataset
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.sft import SFTInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.system.master import MasterWorker

    cfg = qwen2_config("1.5b")
    L, batch, n_steps = cfg.n_layers, 8, 2
    rng = np.random.default_rng(seed + 60)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="sft-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def unwrap():
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
        restore.clear()

    steps, masters, cur, before = [], [], {}, {}

    def on_step(orig):
        async def execute_step(self):
            if "fingerprints" in before:  # the weights the step starts from
                before["fingerprints"] = _leaf_fingerprints(
                    self.pool.workers[0].models["default@0"].engine.params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cur.clear()
            cur.update(mbs=0, real_tokens=0, counts0=_trial_counts(), t0=time.monotonic())
            stats = await orig(self)
            torch.cuda.synchronize()
            c1 = _trial_counts()
            steps.append(dict(
                stats=stats, wall_s=time.monotonic() - cur["t0"], mbs=cur["mbs"],
                real_tokens=cur["real_tokens"], peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches={k: c1[k] - cur["counts0"][k] for k in c1}))
            return stats
        return execute_step

    def on_train_batch(orig):
        def train_batch(self, *a, **k):
            out = orig(self, *a, **k)
            cur["mbs"] += self.last_pack_stats["n_micro_batches"]
            cur["real_tokens"] += self.last_pack_stats["real_tokens"]
            return out
        return train_batch

    def want_train(mbs):
        return dict(fwd=2 * L * mbs, dq=L * mbs, dkv=L * mbs, k2=0, k3=0, k4=0)

    try:
        # The step-2 save and the margin the logs need (the checkpoint
        # itself is shared).
        _check_disk("[sft]", work, _fp32_model_bytes(cfg) + 2**30)
        ckpt, _, _ = _shared_checkpoint("[sft]", cfg, seed + 21)
        rows = _sft_rows(rng, 80)
        train_rows, eval_rows = rows[:64], rows[64:]
        data = os.path.join(work, "sft.jsonl")
        with open(data, "w") as f:
            for row in train_rows:
                f.write(json.dumps(row) + "\n")
        wrap(MasterWorker, "execute_step", on_step)
        wrap(TrainEngine, "train_batch", on_train_batch)
        _capture_trials(wrap, masters)
        common = ["--dataset.path", data, "--tokenizer-path", f"char:{cfg.vocab_size}",
                  "--batch-size", str(batch), "--seed", str(seed + 62)]
        argv = ["sft", "--model.path", ckpt, *common, "--benchmark-steps", str(n_steps),
                "--save-freq-steps", str(n_steps), "--fileroot", os.path.join(work, "trial")]
        log(f"[sft] python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
        torch.cuda.synchronize()
        t = time.monotonic()
        stats = quickstart.main(argv)
        trial_s = time.monotonic() - t
        check(len(stats) == n_steps == len(steps), f"{len(stats)} steps of stats, {len(steps)} recorded")
        steps_out = []
        for i, st in enumerate(steps):
            s = st["stats"]
            check(all(math.isfinite(v) for v in s.values()),
                  f"step {i + 1}: non-finite stats {[k for k, v in s.items() if not math.isfinite(v)]}")
            check(s["quarantined"] == 0.0, f"step {i + 1} was quarantined")
            check(st["launches"] == want_train(st["mbs"]),
                  f"step {i + 1}: launches {st['launches']} != {want_train(st['mbs'])}")
            out = dict(step_s=st["wall_s"], train_s=s["perf/time_s"], mfu=s.get("perf/mfu"),
                       tokens=st["real_tokens"], tokens_per_s=st["real_tokens"] / st["wall_s"],
                       peak_mem_bytes=st["peak_mem_bytes"], loss=s["loss"],
                       grad_norm=s["grad_norm"], update_norm=s["update_norm"],
                       micro_batches=st["mbs"], launches=st["launches"])
            steps_out.append(out)
            log(f"[sft] step {i + 1}: {st['wall_s']:.3f} s ({s['perf/time_s']:.3f} s in the "
                f"train MFC), {st['real_tokens']} tokens = {out['tokens_per_s']:.1f} tok/s, MFU "
                f"{out['mfu']}, peak {st['peak_mem_bytes'] / 2**30:.2f} GiB; loss={s['loss']:.6f} "
                f"grad_norm={s['grad_norm']:.4f} update_norm={s['update_norm']:.6f}; "
                f"{st['mbs']} micro-batch(es), launches {st['launches']}")

        # Evaluation with the trained model, over 16 more rows.
        model = masters[-1].pool.workers[0].models["default@0"]
        eval_ds = PromptAnswerDataset(seed, 0, 1, model.tokenizer, max_length=4096,
                                      dataset_builder=lambda: eval_rows)
        batches = list(PackedDataLoader(eval_ds, batch_size=batch, seed=seed))
        eval_mbs = sum(len(b.split(MicroBatchSpec())) for b in batches)
        torch.cuda.synchronize()
        c0, t = _trial_counts(), time.monotonic()
        ev = SFTInterface().evaluate(model, batches)
        torch.cuda.synchronize()
        eval_s = time.monotonic() - t
        c1 = _trial_counts()
        eval_launches = {k: c1[k] - c0[k] for k in c1}
        want = dict(fwd=L * eval_mbs, dq=0, dkv=0, k2=0, k3=0, k4=0)
        log(f"[sft] evaluate over {len(eval_rows)} rows ({len(batches)} batches, {eval_mbs} "
            f"micro-batches): eval_nll={ev['eval_nll']:.6f} in {eval_s:.3f} s; launches "
            f"{eval_launches}")
        check(math.isfinite(ev["eval_nll"]) and ev["eval_nll"] > 0, f"eval_nll {ev['eval_nll']}")
        check(eval_launches == want, f"evaluate launches {eval_launches} != {want}")

        # The step-2 save reloads to the trained masters bit for bit.
        saved = os.path.join(work, "trial", "checkpoints", "sft", "trial0", "default@0",
                             f"step_{n_steps}")
        t = time.monotonic()
        _, loaded = hf.load_hf_checkpoint(saved, dtype=torch.float32, device="cuda")
        load_s = time.monotonic() - t
        saved_fp = _leaf_fingerprints(loaded)
        check(saved_fp == _leaf_fingerprints(model.engine.params),
              "the step-2 save does not reload to the trained weights")
        del loaded, model
        masters.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[sft] the step-2 save reloads to the trained masters bit for bit "
            f"({len(saved_fp)} tensors, loaded in {load_s:.2f} s)")

        # A third step from the save with the ceiling under step 2's
        # update norm: quarantined, the weights stay as the trial loaded
        # them (the save in the model's bf16, widened to fp32 masters).
        ceiling = steps[-1]["stats"]["update_norm"] / 2
        steps.clear()
        before["fingerprints"] = None
        argv3 = ["sft", "--model.path", saved, *common, "--benchmark-steps", "1",
                 "--anomaly-update-norm-max", repr(ceiling),
                 "--fileroot", os.path.join(work, "trial3")]
        log(f"[sft] python -m areal_tpu_torch.apps.quickstart {' '.join(argv3)}")
        stats3 = quickstart.main(argv3)[0]
        st3 = steps[0]
        engine = masters[-1].pool.workers[0].models["default@0"].engine
        log(f"[sft] step 3 (ceiling {ceiling:.6e}): quarantined={stats3['quarantined']} "
            f"verdict={stats3['anomaly_verdict']} update_norm={stats3['update_norm']:.6e} "
            f"grad_norm={stats3['grad_norm']:.4f}; launches {st3['launches']}")
        check(stats3["quarantined"] == 1.0
              and int(stats3["anomaly_verdict"]) == integrity.UPDATE_NORM,
              f"step 3 not quarantined by the update-norm ceiling: {stats3}")
        check(st3["launches"] == want_train(st3["mbs"]),
              f"step 3 launches {st3['launches']} != {want_train(st3['mbs'])}")
        check(_leaf_fingerprints(engine.params) == before["fingerprints"]
              and engine.opt_count == 0, "the quarantined step changed the weights")
        log("[sft] the quarantined step left the weights bit for bit")
        del engine
        masters.clear()
        unwrap()
        gc.collect()
        torch.cuda.empty_cache()
        parity = _sft_parity(seed + SFT_PARITY_SEED, train_rows)
    finally:
        unwrap()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    total = {k: sum(s["launches"][k] for s in steps_out) for k in steps_out[0]["launches"]}
    report["sft"] = dict(
        steps=steps_out, trial_s=trial_s, launches=total, eval_nll=ev["eval_nll"],
        eval_launches=eval_launches, eval_s=eval_s, quarantined_step=dict(
            ceiling=ceiling, update_norm=stats3["update_norm"], launches=st3["launches"]),
        parity=parity,
    )


class _BusySampler:
    """The card's busy share over a window from NVML's utilization.gpu
    (the percent of each sample period in which a kernel ran), sampled
    every 50 ms by one `nvidia-smi` process that runs only inside the
    window: no profiler, so no trace to collect (torch.profiler's took
    35-148 s a step here).  `share` is None when no sample came back."""

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                 "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        self.samples, self.share = 0, None
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        vals = [float(x) for x in out.split() if x.strip().replace(".", "", 1).isdigit()]
        self.samples = len(vals)
        self.share = sum(vals) / len(vals) / 100 if vals else None
        return False


OVERLAP_MODES = (
    ("barrier", []),
    ("window1", ["--pipeline-overlap", "--overlap-window", "1"]),
    ("window2", ["--pipeline-overlap", "--overlap-window", "2", "--pipeline-chunk-seqs", "2"]),
)
# A streamed step takes its one optimizer step at the behaviour policy
# (ratio 1) with each chunk's advantages normalized over the chunk, so its
# loss is 0 up to the ratio's bf16 recompute noise; the barrier's loss
# averages four minibatches, three of them after an update, and is not
# that quantity (on an H100 at 700 W: 0.104 against the stream's -2.4e-4).
OVERLAP_LOSS_TOL = 1e-2
OVERLAP_STEPS = 1


def phase_overlap(report, seed):
    """The quickstart's ppo-math trial (8 prompts x 4, 128 new tokens, a
    ref from the same checkpoint, kl_ctl 0.1, OVERLAP_STEPS steps: one,
    to keep the whole smoke inside its limit; rewards keyed to each
    sequence's id and place in its group, so every mode scores alike)
    three ways through quickstart.main: the barrier step,
    --pipeline-overlap --overlap-window 1 (its train stats and the actor's
    weights after each step equal the barrier's bit for bit), and
    --overlap-window 2 --pipeline-chunk-seqs 2 (4 chunks of 8 requests,
    generated in 2 to 4 static bursts, the chunks waiting on the generate
    node sharing one; stream begin, 4 chunks of
    gradient accumulation and one optimizer step: importance weight 1,
    approx-KL 0 and a loss within OVERLAP_LOSS_TOL of 0).  Each step's
    launches equal L x the engines' calls summed over the MFCs of all
    chunks and both threads (K1f from the prefills, the ref and the train
    micro-batches; K4 from the decode steps); step walls, the card's idle
    share over each step (`_BusySampler`), fill and bubble of each
    stage."""
    import functools
    import zlib

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.system.master import MasterWorker

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    n_prompts, n, max_new, n_steps = 8, 4, 128, OVERLAP_STEPS
    L = cfg.n_layers
    rng = np.random.default_rng(seed + 70)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="overlap-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)
            scores = []
            for sid, group in zip(sample.ids, sample.seqlens["packed_input_ids"]):
                scores += [5.0 if zlib.crc32(f"{sid}/{j}/{seed}".encode()) & 1 else -5.0
                           for j in range(len(group))]
            out.data["rewards"] = np.asarray(scores, np.float32)
            return out
        return inference

    def on_stream_chunk(cur):
        def make(orig):
            @functools.wraps(orig)
            def train_stream_chunk(self, *a, **k):
                out = orig(self, *a, **k)
                cur["train_calls"].append(dict(stats=out, mbs=int(out["chunk_micro_batches"])))
                return out
            return train_stream_chunk
        return make

    results = {}
    try:
        ckpt, _, _ = _shared_checkpoint("[overlap]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(rng, 64):
                f.write(json.dumps(row) + "\n")
        for mode, flags in OVERLAP_MODES:
            rec, cur, fps, walls, busy = {"steps": []}, {}, [], [], []

            def on_step(orig, fps=fps, walls=walls, busy=busy):
                async def execute_step(self):
                    t0 = time.monotonic()
                    with _BusySampler() as sampler:
                        stats = await orig(self)
                        torch.cuda.synchronize()
                    walls.append(time.monotonic() - t0)
                    busy.append(sampler.share)
                    fps.append(_leaf_fingerprints(
                        self.pool.workers[0].models["actor@0"].engine.params))
                    return stats
                return execute_step

            _record_trial_steps(wrap, rec, cur)
            wrap(TrainEngine, "train_stream_chunk", on_stream_chunk(cur))
            wrap(MultiTaskRewardInterface, "inference", on_reward)
            wrap(MasterWorker, "execute_step", on_step)
            argv = [
                "ppo-math", "--model.path", ckpt, "--dataset.path", data,
                "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt,
                "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
                "--max-new-tokens", str(max_new), "--benchmark-steps", str(n_steps),
                "--fileroot", os.path.join(work, mode), "--seed", str(seed + 72), *flags,
            ]
            log(f"[overlap] {mode}: python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
            try:
                torch.cuda.synchronize()
                t = time.monotonic()
                stats = quickstart.main(argv)
                torch.cuda.synchronize()
                trial_s = time.monotonic() - t
            finally:
                for owner, name, orig in reversed(restore):
                    setattr(owner, name, orig)
                restore.clear()
            check(len(stats) == n_steps == len(rec["steps"]) == len(walls),
                  f"{mode}: {len(stats)} steps of stats, {len(rec['steps'])} recorded")
            chunks = 4 if mode == "window2" else 1
            out = dict(trial_s=trial_s, steps=[], fingerprints=fps)
            for i, st in enumerate(rec["steps"]):
                s = st["stats"]
                check(all(math.isfinite(v) for v in s.values()),
                      f"{mode} step {i + 1}: non-finite stats "
                      f"{[k for k, v in s.items() if not math.isfinite(v)]}")
                check(s["actor_train/quarantined"] == 0.0, f"{mode} step {i + 1} quarantined")
                # Window 2 admits two chunks at a time, so the generate
                # node serves the four in two to four bursts.
                _check_step_launches(f"[overlap] {mode}", i + 1, st, rec["plan_nodes"], L, max_new,
                                     gen_chunks=(2, 4) if mode == "window2" else (1, 1))
                pipe = {k[len("pipeline/"):]: v for k, v in s.items() if k.startswith("pipeline/")}
                if mode != "barrier":
                    check(pipe.get("n_chunks") == chunks,
                          f"{mode}: pipeline/n_chunks {pipe.get('n_chunks')} != {chunks}")
                    check(all(f"fill_{nm}" in pipe and f"bubble_s_{nm}" in pipe
                              for nm, _ in rec["plan_nodes"]),
                          f"{mode}: a stage without fill or bubble: {sorted(pipe)}")
                if mode == "window2":
                    check(s["actor_train/n_stream_chunks"] == chunks,
                          f"{mode}: {s['actor_train/n_stream_chunks']} stream chunks")
                train = {k: v for k, v in s.items() if k.startswith("actor_train/")
                         and "/perf/" not in k and "/time/" not in k}
                out["steps"].append(dict(
                    step_s=walls[i], busy_share=busy[i], launches=st["launches"], pipeline=pipe,
                    train=train, peak_mem_bytes=st["peak_mem_bytes"],
                    decode_steps=st["decode_steps"], gen_chunks=st["gen_chunks"],
                    mfc_s={k.split("/")[0]: v for k, v in s.items() if k.endswith("/perf/time_s")}))
                idle = "not measured" if busy[i] is None else f"{1 - busy[i]:.4f}"
                log(f"[overlap] {mode} step {i + 1}: {walls[i]:.3f} s, the card's idle share "
                    f"{idle} (NVML utilization.gpu every 50 ms); actor_loss="
                    f"{train['actor_train/actor_loss']:.6e} grad_norm="
                    f"{train['actor_train/grad_norm']:.4f}; {st['gen_chunks']} static chunk(s), "
                    f"{st['decode_steps']} decode steps; peak {st['peak_mem_bytes'] / 2**30:.2f} GiB")
                if pipe:
                    log(f"[overlap] {mode} step {i + 1} pipeline: "
                        f"{ {k: round(v, 4) for k, v in pipe.items()} }")
            results[mode] = out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    barrier, w1, w2 = results["barrier"], results["window1"], results["window2"]
    for i, (a, b) in enumerate(zip(barrier["steps"], w1["steps"])):
        check(a["train"] == b["train"], f"window 1 step {i + 1}: train stats differ from the "
              f"barrier's: { {k: (a['train'][k], b['train'].get(k)) for k in a['train'] if a['train'][k] != b['train'].get(k)} }")
        check(barrier["fingerprints"][i] == w1["fingerprints"][i],
              f"window 1 step {i + 1}: the actor's weights differ from the barrier's")
    log(f"[overlap] window 1: every actor_train stat and the actor's weights after each step "
        f"({n_steps}) equal the barrier's bit for bit")
    for i, (a, b) in enumerate(zip(barrier["steps"], w2["steps"])):
        t = b["train"]
        loss, iw, kl = (t[f"actor_train/{k}"] for k in ("actor_loss", "importance_weight",
                                                         "approx_kl"))
        log(f"[overlap] window 2 step {i + 1}: actor_loss {loss:.6e} (bound {OVERLAP_LOSS_TOL}; "
            f"the barrier's, over four minibatches, {a['train']['actor_train/actor_loss']:.6e}), "
            f"importance_weight {iw:.6f}, approx_kl {kl:.3e} (bounds {IMP_WEIGHT_TOL}, "
            f"{APPROX_KL_TOL})")
        check(abs(loss) <= OVERLAP_LOSS_TOL and abs(iw - 1.0) < IMP_WEIGHT_TOL
              and abs(kl) < APPROX_KL_TOL,
              f"window 2 step {i + 1}: the streamed step is not at the behaviour policy: "
              f"loss {loss}, importance_weight {iw}, approx_kl {kl}")
    for r in results.values():
        r.pop("fingerprints")
    total = {k: sum(s["launches"][k] for s in w2["steps"]) for k in w2["steps"][0]["launches"]}
    report["overlap"] = dict(modes=results, launches=total)


# --------------------------------------------------------------------------
# trainmodes: the remat policies, bf16 masters, the fused reward+ref MFC,
# a checkpoint's own tokenizer.json and the null trials
# --------------------------------------------------------------------------

# (master dtype, remat policy) of the engine modes, one micro-batch of
# TRAINMODE_TOKENS tokens each.
TRAINMODES = (("float32", "none"), ("float32", "full"), ("float32", "dots"),
              ("float32", "dots_small"), ("bfloat16", "full"), ("bfloat16", "dots"))
TRAINMODE_TOKENS = 8192
TRAINMODE_SEGMENTS = (256, 1024)
# A mode's peak may come no nearer the card's memory than this.
TRAINMODE_HEADROOM = 5 * 2**30
BPE_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")


def train_bpe_tokenizer(texts, out_dir, n_merges=1024):
    """Write a qwen2-layout byte-level BPE (`tokenizer.json`,
    `tokenizer_config.json`) trained here on `texts`, deterministically:
    the texts split by qwen2's pre-tokenizer pattern, each word as its
    UTF-8 bytes in the ByteLevel alphabet, then up to `n_merges` merges,
    each of the most frequent adjacent pair (the smallest pair first
    among equals) while some pair occurs twice.  Ids: the 256 bytes in
    byte order, the merges' tokens, then BPE_SPECIALS.  The card's
    machine has no `tokenizers` to train one with."""
    from collections import Counter

    from areal_tpu_torch.data.bpe import BYTE_TO_CHAR, QWEN2_PATTERN, split_words

    counts = Counter()
    for text in texts:
        for w in split_words(text):
            counts[tuple(BYTE_TO_CHAR[b] for b in w.encode("utf-8"))] += 1
    words = [[list(w), n] for w, n in sorted(counts.items())]
    vocab = {BYTE_TO_CHAR[b]: b for b in range(256)}
    merges = []
    while len(merges) < n_merges:
        pairs = Counter()
        for syms, n in words:
            for a, b in zip(syms, syms[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        if pairs[best] < 2:
            break
        merged = best[0] + best[1]
        merges.append(list(best))
        vocab.setdefault(merged, len(vocab))
        for w in words:
            syms, out, i = w[0], [], 0
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            w[0] = out
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": len(vocab) + i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, t in enumerate(BPE_SPECIALS)],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False},
            byte_level]},
        "post_processor": byte_level,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
                  "merges": merges},
    }
    config = {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": BPE_SPECIALS[0],
              "pad_token": BPE_SPECIALS[0], "bos_token": None,
              "clean_up_tokenization_spaces": False, "model_max_length": 32768}
    os.makedirs(out_dir, exist_ok=True)
    for name, obj in (("tokenizer.json", spec), ("tokenizer_config.json", config)):
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return len(vocab), len(merges)


def _trainmode_sample(rng, cfg):
    """One micro-batch of TRAINMODE_TOKENS tokens: random tokens in
    segments of TRAINMODE_SEGMENTS lengths (the last one completing the
    count) from `rng`."""
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample

    lo, hi = TRAINMODE_SEGMENTS
    lens, left = [], TRAINMODE_TOKENS
    while left > hi:  # each draw leaves at least `lo` for the last segment
        lens.append(int(rng.integers(lo, min(hi, left - lo) + 1)))
        left -= lens[-1]
    lens.append(left)
    data = rng.integers(0, cfg.vocab_size, TRAINMODE_TOKENS).astype(np.int32)
    return SequenceSample(keys={"packed_input_ids"}, ids=[f"t{i}" for i in range(len(lens))],
                          seqlens={"packed_input_ids": [[n] for n in lens]},
                          data={"packed_input_ids": data}), lens


def _trainmode_loss(lp, batch):
    return -lp.sum(), {}


def _trainmode_weight(arrays):
    return float((arrays["segment_ids"] > 0).sum())


def _trainmode_run(cfg, params, samples, master, policy):
    """One engine of the mode over `samples` (a warm step, then a timed
    step): the timed step's seconds (CUDA events), its peak before the
    optimizer step (forward and backward) and over the whole step, its
    launches, the products the "dots" checkpoint kept in its forward,
    and the weights' fingerprints after both steps."""
    import torch
    from torch.utils.checkpoint import CheckpointPolicy

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import OptimizerConfig
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.models import transformer as tfm

    mb = MicroBatchSpec(max_tokens_per_mb=TRAINMODE_TOKENS)
    eng = TrainEngine(cfg, params, "cuda", master_dtype=master, remat_policy=policy,
                      optimizer_config=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0))
    fwd_bwd = {}
    step = eng._guarded_step

    def guarded(*a, **k):  # the peak of the forward and backward, before the step
        fwd_bwd["peak"] = torch.cuda.max_memory_allocated()
        return step(*a, **k)

    eng._guarded_step = guarded
    out = eng.train_batch(samples[0], mb, _trainmode_loss, _trainmode_weight)
    check(out["quarantined"] == 0.0, f"{master}/{policy}: the warm step was quarantined")
    kept, policy_fn = [0], tfm._dots_policy

    def counting(ctx, op, *a, **k):
        verdict = policy_fn(ctx, op, *a, **k)
        if verdict == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept[0] += 1
        return verdict

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tfm._dots_policy = counting
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        a.record()
        out = eng.train_batch(samples[1], mb, _trainmode_loss, _trainmode_weight)
        b.record()
        b.synchronize()
    finally:
        tfm._dots_policy = policy_fn
    res = dict(
        step_s=a.elapsed_time(b) / 1e3, peak_bytes=torch.cuda.max_memory_allocated(),
        fwd_bwd_peak_bytes=fwd_bwd["peak"], launches=_trial_counts(), kept_products=kept[0],
        micro_batches=eng.last_pack_stats["n_micro_batches"],
        grid=eng.last_pack_stats["grid_tokens"], loss=out["loss"],
        grad_norm=out["grad_norm"], quarantined=out["quarantined"],
        master_bytes=sum(p.numel() * p.element_size() for _, p in _flat_params(eng.params)),
        fingerprints=_leaf_fingerprints(eng.get_params()),
    )
    del eng, step, guarded
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _trainmode_predictions(cfg, n_params, tokens):
    """Each mode's peak reckoned from the shapes (bytes; PERF.md §5
    writes the same sums): resident masters, moments, gradients and the
    fp32 mode's bf16 compute copy, plus what the policy keeps of a
    layer's activations a token (bf16), plus the optimizer's temporaries
    over its largest leaf (seven leaf-sized tensors in the master dtype:
    the clipped gradient, the new moments, the update's chain), whichever
    is larger."""
    D, F, L = cfg.hidden_dim, cfg.intermediate_dim, cfg.n_layers
    q, kv = cfg.q_dim, cfg.kv_dim
    kept = {  # bf16 bytes a token and layer
        # autograd's residuals: the norms' fp32 inputs and outputs (4 x
        # D x 4 B), RoPE's fp32 q/k and their rotations (2 x (q + kv) x
        # 4 B), h, h2, q/k/v, o, gate, silu, up, and the product (bf16).
        "none": 2 * (4 * 2 * D + 2 * 2 * (q + kv) + 2 * D + q + 2 * kv + q + 4 * F),
        "full": 2 * D,
        "dots": 2 * (D + q + 2 * kv + D + 2 * F + D),
        "dots_small": 2 * 2 * D,
    }
    largest = max(L * D * F, cfg.vocab_size * D)
    out = {}
    for master, policy in TRAINMODES:
        m = 4 if master == "float32" else 2
        resident = n_params * (3 * m + (2 if m == 4 else 0))  # params, mu, nu (+ bf16 copy)
        # + the bf16 gradients in flight, one layer's recompute (or the
        # backward's transients) and three [512, V] fp32 blocks of the
        # chunked logprobs.
        fwd_bwd = (resident + tokens * L * kept[policy] + n_params * 2
                   + tokens * kept["none"] + 3 * 512 * cfg.vocab_size * 4)
        step = resident + n_params * m + 7 * largest * m
        out[(master, policy)] = (fwd_bwd, max(fwd_bwd, step))
    return out


def _trainmode_engines(seed, cfg):
    """Part (a): every mode of TRAINMODES on one micro-batch."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.transformer import init_params

    rng = np.random.default_rng(seed + 60)
    samples, lens = zip(*(_trainmode_sample(rng, cfg) for _ in range(2)))
    params = init_params(cfg, seed + 61, device="cuda")
    n_params = sum(p.numel() for _, p in _flat_params(params))
    predicted = _trainmode_predictions(cfg, n_params, TRAINMODE_TOKENS)
    card = torch.cuda.get_device_properties(0).total_memory
    L = cfg.n_layers
    log(f"[trainmodes] {n_params} parameters; one micro-batch of {TRAINMODE_TOKENS} tokens a "
        f"step in {len(lens[1])} segments of {min(lens[1])}-{max(lens[1])}")
    modes = {}
    for master, policy in TRAINMODES:
        r = _trainmode_run(cfg, params, samples, master, policy)
        fwd = L * (1 if policy == "none" else 2)
        want = dict(fwd=fwd, dq=L, dkv=L, k4=0, k2=0, k3=0)
        p_fb, p_step = predicted[(master, policy)]
        log(f"[trainmodes] {master} masters, remat {policy}: step {r['step_s']:.3f} s "
            f"({TRAINMODE_TOKENS / r['step_s']:.0f} tok/s), peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB (predicted {p_step / 2**30:.2f}), forward+backward peak "
            f"{r['fwd_bwd_peak_bytes'] / 2**30:.2f} GiB (predicted {p_fb / 2**30:.2f}); "
            f"masters {r['master_bytes'] / 2**30:.2f} GiB; launches {r['launches']}; "
            f"products kept by the checkpoint {r['kept_products']}; "
            f"loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}")
        check(r["micro_batches"] == 1 and r["grid"] == TRAINMODE_TOKENS,
              f"{master}/{policy}: {r['micro_batches']} micro-batches of {r['grid']} tokens")
        check(r["launches"] == want, f"{master}/{policy}: launches {r['launches']} != {want}")
        # "dots" keeps the seven projections of each layer (aten.mm).
        kept = 7 * L if policy == "dots" else 0
        check(r["kept_products"] == kept,
              f"{master}/{policy}: the checkpoint kept {r['kept_products']} products, not {kept}")
        check(r["quarantined"] == 0.0 and math.isfinite(r["loss"])
              and math.isfinite(r["grad_norm"]), f"{master}/{policy}: {r}")
        check(r["peak_bytes"] <= card - TRAINMODE_HEADROOM,
              f"{master}/{policy}: peak {r['peak_bytes']} within 5 GiB of the card's {card}")
        r["predicted_bytes"], r["predicted_fwd_bwd_bytes"] = p_step, p_fb
        modes[f"{master}/{policy}"] = r
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for master in ("float32", "bfloat16"):
        same = [m for m in modes if m.startswith(master + "/")]
        ref = modes[same[0]]["fingerprints"]
        for m in same[1:]:
            differ = [n for n, f in modes[m]["fingerprints"].items() if f != ref[n]]
            check(not differ, f"{m}: the weights after two steps differ from {same[0]}'s in "
                  f"{len(differ)} leaves: {differ[:8]}")
        log(f"[trainmodes] {master} masters: the weights after two steps are bit for bit "
            f"equal under {[m.split('/')[1] for m in same]}")
    fb = {m: modes[m]["fwd_bwd_peak_bytes"] for m in modes}
    check(fb["float32/none"] > fb["float32/dots"] > fb["float32/dots_small"],
          f"forward+backward peaks none/dots/dots_small not in order: {fb}")
    saving = 8 * n_params
    for policy in ("full", "dots"):
        a, b = modes[f"float32/{policy}"]["peak_bytes"], modes[f"bfloat16/{policy}"]["peak_bytes"]
        log(f"[trainmodes] remat {policy}: bf16 masters peak {b / 2**30:.2f} GiB, fp32 "
            f"{a / 2**30:.2f} GiB: {(a - b) / 2**30:.2f} GiB less (at least 8 B x "
            f"{n_params} = {saving / 2**30:.2f} GiB)")
        check(a - b >= saving, f"remat {policy}: bf16 masters save {a - b} B < {saving} B")
    for r in modes.values():
        r.pop("fingerprints")
    return dict(modes=modes, n_params=n_params, card_bytes=card)


def _check_fused_step(rec, L):
    """Part (b)'s one step: K1f = 28 x (1 prefill + the fused MFC's ref
    forwards + 2 x train micro-batches: dots_small's attention branch
    recomputed), K1dq = K1dkv = 28 x train micro-batches, K4 = 28 x
    decode steps."""
    st = rec["steps"][0]
    mbs = sum(c["mbs"] for c in st["train_calls"])
    want = dict(fwd=L * (st["gen_chunks"] + st["ref_fwd_mbs"] + 2 * mbs + st["train_fwd_mbs"]),
                dq=L * mbs, dkv=L * mbs, k4=L * st["decode_steps"], k2=0, k3=0)
    check(st["launches"] == want, f"launches {st['launches']} != {want}")
    return st, want


def _trainmode_quickstart(seed, cfg, work):
    """Part (b): one `quickstart ppo-math` step with bf16 masters, remat
    dots_small and the fused reward+ref MFC, from a checkpoint directory
    holding a tokenizer.json trained here (no char: path)."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.data.bpe import BPETokenizer
    from areal_tpu_torch.data.tokenizer import load_hf_tokenizer
    from areal_tpu_torch.interfaces.fused import FusedThreadingInterface

    rng = np.random.default_rng(seed + 62)
    rows = _math_rows(rng, 64)
    ckpt, _, _ = _shared_checkpoint("[trainmodes]", cfg, seed + 21)
    model_dir = os.path.join(work, "model")
    os.makedirs(model_dir)
    for f in os.listdir(ckpt):
        os.symlink(os.path.join(ckpt, f), os.path.join(model_dir, f))
    n_vocab, n_merges = train_bpe_tokenizer(
        [r["prompt"] for r in rows] + [s for r in rows for s in r["solutions"]], model_dir)
    tok = load_hf_tokenizer(model_dir)
    check(isinstance(tok, BPETokenizer), f"the checkpoint's tokenizer loaded as {type(tok)}")
    bad = [r["prompt"] for r in rows if tok.decode(tok.encode(r["prompt"])) != r["prompt"]]
    check(not bad, f"{len(bad)} prompts do not round-trip through the tokenizer: {bad[:2]}")
    n_ids = sum(len(tok.encode(r["prompt"])) for r in rows)
    log(f"[trainmodes] (b) tokenizer.json trained here: {n_vocab} tokens ({n_merges} merges) "
        f"+ {len(BPE_SPECIALS)} specials, eos {tok.eos_token_id}; {len(rows)} prompts, "
        f"{sum(len(r['prompt']) for r in rows)} bytes -> {n_ids} ids, every one round-trips")
    data = os.path.join(work, "math.jsonl")
    with open(data, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")

    restore, rec, cur, fused = [], {"steps": []}, {}, []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_fused(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)
            fused.append((self, model, sample, mb_spec,
                          {k: np.asarray(out.data[k]).copy() for k in ("rewards", "logprobs")}))
            return out
        return inference

    _record_trial_steps(wrap, rec, cur)
    wrap(FusedThreadingInterface, "inference", on_fused)
    n_prompts, n, max_new = 8, 4, 64
    argv = [
        "ppo-math", "--model.path", model_dir, "--dataset.path", data, "--ref-path", model_dir,
        "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
        "--max-new-tokens", str(max_new), "--benchmark-steps", "1",
        "--fileroot", os.path.join(work, "trial"), "--seed", str(seed + 63),
        "--master-dtype", "bfloat16", "--remat", "dots_small", "--fuse-rew-ref",
    ]
    log(f"[trainmodes] (b) python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t = time.monotonic()
        stats = quickstart.main(argv)
        torch.cuda.synchronize()
        trial_s = time.monotonic() - t
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
    check(len(stats) == 1 and len(rec["steps"]) == 1 and len(fused) == 1,
          f"{len(stats)} steps, {len(rec['steps'])} recorded, {len(fused)} fused calls")
    names = [nm for nm, _ in rec["plan_nodes"]]
    check("fused_rew_ref" in names and "rew_inf" not in names and "ref_inf" not in names,
          f"the DFG's nodes {names}")
    s = stats[0]
    check(all(math.isfinite(v) for v in s.values()),
          f"non-finite stats {[k for k, v in s.items() if not math.isfinite(v)]}")
    check(s["actor_train/quarantined"] == 0.0, "the step was quarantined")
    st, want = _check_fused_step(rec, cfg.n_layers)

    # The fused MFC against its sub-interfaces run alone on its batch
    # (after the trial, outside the step's launch count).
    iface, model, sample, mb_spec, got = fused[0]
    check(isinstance(model.tokenizer, BPETokenizer), f"the trial's tokenizer {type(model.tokenizer)}")
    alone = {"rewards": iface.sub_interfaces["rew"].inference(model, sample, mb_spec),
             "logprobs": iface.sub_interfaces["ref"].inference(model, sample, mb_spec)}
    for key, res in alone.items():
        check(np.array_equal(np.asarray(res.data[key]), got[key]),
              f"the fused MFC's {key} differ from its sub-interface's run alone")
    del fused, model, iface, alone
    gc.collect()
    torch.cuda.empty_cache()
    mfc = {k.split("/")[0]: v for k, v in s.items() if k.endswith("/perf/time_s")}
    log(f"[trainmodes] (b) DFG {names}; 1 step {s['time/step_s']:.2f} s; by MFC (s) "
        f"{ {k: round(v, 3) for k, v in mfc.items()} }; peak {st['peak_mem_bytes'] / 2**30:.2f} "
        f"GiB; launches {st['launches']} (= {want}); the fused MFC's rewards and ref logprobs "
        f"equal the reward interface's and the ref's run alone, bit for bit; trial {trial_s:.1f} s")
    return dict(step_s=s["time/step_s"], mfc_s=mfc, peak_mem_bytes=st["peak_mem_bytes"],
                launches=st["launches"], trial_s=trial_s, vocab=n_vocab, merges=n_merges,
                decode_steps=st["decode_steps"])


def _trainmode_null(seed, work):
    """Part (c): build_null_sft and build_null_ppo in this process."""
    import numpy as np

    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.experiments.common import run_experiment
    from areal_tpu_torch.experiments.null import NullSFTConfig, build_null_ppo, build_null_sft
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    rng = np.random.default_rng(seed + 64)
    out = {}
    for name, build, dataset, rows, key in (
            ("sft", build_null_sft, "prompt_answer", _sft_rows(rng, 16), "null/n_seqs"),
            ("ppo", build_null_ppo, "math_code_prompt", _math_rows(rng, 16),
             "actor_train/null/n_seqs")):
        cfg = NullSFTConfig(
            dataset=DatasetAbstraction(dataset, {"dataset_builder": lambda rows=rows: rows,
                                                 "max_length": 1024}),
            batch_size=4, ctrl=ExperimentSaveEvalControl(benchmark_steps=2),
            fileroot=os.path.join(work, f"null-{name}"))
        t = time.monotonic()
        _, stats = run_experiment(build(cfg), tokenizer=CharTokenizer(512))
        out[name] = time.monotonic() - t
        check(len(stats) == 2 and all(s[key] == 4.0 for s in stats),
              f"null {name}: {len(stats)} steps, {[s.get(key) for s in stats]}")
    log(f"[trainmodes] (c) build_null_sft and build_null_ppo: two steps each, null/n_seqs 4.0 "
        f"and actor_train/null/n_seqs 4.0 ({out['sft']:.2f} s, {out['ppo']:.2f} s)")
    return out


def phase_trainmodes(report, seed):
    """The trainer's options at qwen2-1.5B (28 layers, full width,
    random weights): (a) TRAINMODES on one micro-batch of 8,192 tokens,
    a warm and a timed step each: step seconds, peaks (forward and
    backward, and the whole step) beside the predictions, launches K1f
    = 28 x (1 or 2: the recompute), K1dq = K1dkv = 28; the weights bit
    for bit equal across the policies of one master dtype; forward and
    backward peaks none > dots > dots_small; bf16 masters' peak at least
    8 B a parameter below fp32's; (b) one quickstart step with
    `--master-dtype bfloat16 --remat dots_small --fuse-rew-ref` from a
    checkpoint holding a tokenizer.json trained here; (c) the null
    trials."""
    import shutil

    import torch

    from areal_tpu_torch.models.config import qwen2_config

    cfg = qwen2_config("1.5b")
    out = _trainmode_engines(seed, cfg)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="trainmodes-", dir=QUICKSTART_DIR)
    try:
        out["quickstart"] = _trainmode_quickstart(seed, cfg, work)
        out["null_s"] = _trainmode_null(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(out["quickstart"]["launches"])
    for m in out["modes"].values():
        for k, v in m["launches"].items():
            launches[k] += v
    out["launches"] = launches
    report["trainmodes"] = out


# --------------------------------------------------------------------------
# recover: kill-and-resume, the EMA reference model and the difficulty filter
# --------------------------------------------------------------------------

RECOVER_DIR = os.path.join(REPO, ".recover_tmp")
RECOVER_ETA = 0.9
# New tokens a response (128 before the async phase came; generation is
# most of each of the phase's six steps, and every check holds at 64).
RECOVER_NEW_TOKENS = 64
RECOVER_FILTER = {"min_accuracy": 0.25, "max_accuracy": 0.75}
# Step 2's reward groups: the first 3 prompts of the batch score 4/4, the
# next 2 score 0/4 (the expected drop set); every other group 2/4.
RECOVER_ALL_GOOD, RECOVER_ALL_BAD = 3, 2
# Resumed against uninterrupted, when the step-1 masters agree bit for
# bit: every step-2/3 stat within this relative difference.
RESUME_STATS_RTOL = 1e-6


def _leaf_fingerprints(tree):
    """Per-leaf fingerprints of a tensor tree on the card, to compare two
    states bit for bit without a copy: each leaf's dtype, shape, and two
    int64 sums over its raw words (the words, and each word times its
    index mod 65521, plus 1), taken in chunks."""
    import torch

    out = {}
    for name, x in _flat_params(tree):
        w = x.detach().contiguous().view(-1)
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        s0 = torch.zeros((), dtype=torch.int64, device=w.device)
        s1 = torch.zeros((), dtype=torch.int64, device=w.device)
        for i in range(0, w.numel(), 1 << 24):
            c = w[i:i + (1 << 24)].to(torch.int64)
            idx = torch.arange(i, i + c.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
            s0 += c.sum()
            s1 += (c * idx).sum()
        out[name] = (str(x.dtype), tuple(x.shape), int(s0), int(s1))
    return out


def _trial_state(master):
    """What a recover checkpoint must carry over, read from a master and
    its one worker: counters, controls (their elapsed seconds aside),
    the filter's ids, the versions, the dataset's ids, and fingerprints
    of the actor's fp32 masters and Adam moments and of the ref."""
    w = master.pool.workers[0]
    actor = w.models["actor@0"].engine
    ref = w.models["ref@0"].engine
    ref_params = ref.get_params()
    out = dict(
        step_info=dataclasses.asdict(master.step_info),
        ctl={name: {k: v for k, v in ctl.state_dict().items() if k != "elapsed"}
             for name, ctl in (("save", master.save_ctl), ("ckpt", master.ckpt_ctl))},
        filtered_ids=list(master._filtered_ids),
        versions={k: m.version for k, m in w.models.items()},
        dataset_ids=list(w.datasets[0].ids),
        opt_count=actor.opt_count,
        masters=_leaf_fingerprints(actor.params),
        mu=_leaf_fingerprints(actor._mu),
        nu=_leaf_fingerprints(actor._nu),
        ref=_leaf_fingerprints(ref_params),
    )
    ref.offload()  # as the trial left it
    return out


def phase_recover(report, seed):
    """Kill-and-resume at qwen2-1.5B's full width (CUT_LAYERS layers), through
    `quickstart.main(["ppo-math", ...])` in this process: the quickstart
    phase's trial (a seeded random fp32 checkpoint, one shard at a cut depth, 64 math
    rows, `char:151936`, a ref, `--kl-ctl 0.1`, 8 prompts x 4) at
    RECOVER_NEW_TOKENS new tokens, with `--ref-ema-eta 0.9 --offload-ref` and the difficulty
    filter (`dataset_filter` {min 0.25, max 0.75}, which the CLI has no
    flag for: set by wrapping build_ppo_math).  Rewards are seeded +-5,
    2 of 4 positive in every group but at step 2, where the batch's first
    3 prompts score 4/4 and the next 2 score 0/4: the filter must drop
    exactly those 5.  Three trials:

    U   uninterrupted, three steps, no recover save;
    R1  one step with `--ckpt-freq-steps 1` (a recover checkpoint at 1);
    R2  the same trial name rerun to step 3: it restores step 1 and runs
        steps 2 and 3, with no recover save (so no `.prev`).

    (The drop comes at step 2, after the restart: a drop before a
    checkpoint makes the restored data cursor replay a permutation of the
    shrunken dataset, as the JAX package's does, and the resumed batches
    then differ from U's; the CPU tests pin that behaviour.)

    Checked: after every EMA (each step, and the restore's replay) each
    ref leaf equals 0.9 * actor + 0.1 * ref_before bit for bit (the
    coefficients in each leaf's dtype, as JAX's weak typing does) and the
    ref is back on host at the step's end; the filter drops exactly the 5
    expected ids at step 2, no dropped id comes back, every fetch holds
    >= 8 unique ids; R1's recover dir validates its manifest; R2 restores
    R1's fp32 masters, Adam moments, update count, ref, versions, step
    account, controls and filter state bit for bit; R2's steps 2 and 3
    fetch U's ids; U's and R1's step-1 masters are compared bit for bit
    and, where they agree, R2's tokens equal U's and its stats agree
    within RESUME_STATS_RTOL (the port's kernels use no atomics); each
    step's launches equal L x the engines' calls of each MFC."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.system.master import MasterWorker
    from areal_tpu_torch.system.worker import ModelWorker, _Cycler

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    n_prompts, n, max_new = 8, 4, RECOVER_NEW_TOKENS
    L = cfg.n_layers
    os.makedirs(RECOVER_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=RECOVER_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    rec, cur = {}, {}
    phase = {"ema": [], "times": {}, "states": {}, "host_step1": None, "in_restore": False}
    trials = {}
    try:
        model = _fp32_model_bytes(cfg)
        # The recover checkpoint (weights and both Adam moments), the
        # input checkpoint where no earlier phase wrote it, and a margin.
        _check_disk("[recover]", work, 4 * model + 2 * 2**30)
        ckpt, write_s, ckpt_bytes = _shared_checkpoint("[recover]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(np.random.default_rng(seed + 41), 64):
                f.write(json.dumps(row) + "\n")

        _record_trial_steps(wrap, rec, cur)
        _record_checkpoint_io(wrap, rec)

        def on_build(orig):
            @functools.wraps(orig)
            def build_ppo_math(c, *a, **k):
                c.dataset_filter = dict(RECOVER_FILTER)
                return orig(c, *a, **k)
            return build_ppo_math

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                groups = [len(g) for g in sample.seqlens["packed_input_ids"]]
                step = cur["step"]
                r = np.random.default_rng([seed + 42, step])
                rewards = []
                for gi, k in enumerate(groups):
                    if step == 2 and gi < RECOVER_ALL_GOOD:
                        rewards += [5.0] * k
                    elif step == 2 and gi < RECOVER_ALL_GOOD + RECOVER_ALL_BAD:
                        rewards += [-5.0] * k
                    else:
                        rewards += list(r.permutation([5.0] * (k // 2) + [-5.0] * (k - k // 2)))
                out.data["rewards"] = np.asarray(rewards, np.float32)
                cur["reward_ids"] = list(sample.ids)
                cur["tokens"] = np.asarray(sample.data["packed_input_ids"]).copy()
                return out
            return inference

        def on_fetch(orig):
            @functools.wraps(orig)
            def fetch(self, req):
                cur["loader_batches"] = 0
                out = orig(self, req)
                cur["fetch_ids"] = list(out["meta"].ids)
                return out
            return fetch

        def on_cycler_next(orig):
            @functools.wraps(orig)
            def nxt(self):
                if "loader_batches" in cur:
                    cur["loader_batches"] += 1
                return orig(self)
            return nxt

        def on_param_sync(orig):
            @functools.wraps(orig)
            def param_sync(self, req):
                if req["dst"] != "ref@0":
                    return orig(self, req)
                ref = self.models["ref@0"].engine
                before = {k: v.clone() for k, v in _flat_params(ref.get_params())}
                out = orig(self, req)
                actor = dict(_flat_params(self.models[req["src"]].engine.get_params()))
                bad, worst = [], 0.0
                for k, after in _flat_params(ref.get_params()):
                    b, a = before.pop(k), actor[k]
                    # JAX's weak typing: each coefficient in its leaf's dtype.
                    want = (torch.tensor(req["eta"], dtype=a.dtype) * a
                            + torch.tensor(1 - req["eta"], dtype=b.dtype) * b).to(b.dtype)
                    if not torch.equal(after, want):
                        bad.append(k)
                        worst = max(worst, float((after.float() - want.float()).abs().max()))
                phase["ema"].append(dict(
                    trial=phase["trial"], step="restore" if phase["in_restore"] else cur["step"],
                    eta=req["eta"], bad=bad, worst=worst))
                return out
            return param_sync

        def on_step_end(orig):
            async def execute_step(self):
                stats = await orig(self)
                ref = self.pool.workers[0].models["ref@0"].engine
                rec["steps"][-1].update(ref_offloaded=ref._host_offload is not None,
                                        filtered=list(self._filtered_ids))
                if phase["trial"] in ("U", "R1") and rec["steps"][-1]["step"] == 1:
                    actor = self.pool.workers[0].models["actor@0"].engine
                    phase["states"][phase["trial"] + "_step1"] = _leaf_fingerprints(actor.params)
                    if phase["trial"] == "U":
                        phase["host_step1"] = {k: v.detach().to("cpu", copy=True)
                                               for k, v in _flat_params(actor.params)}
                    else:
                        phase["step1_gap"] = max(
                            float((v.detach() - phase["host_step1"][k].cuda()).abs().max())
                            for k, v in _flat_params(actor.params))
                        phase["host_step1"] = None
                return stats
            return execute_step

        def on_run(orig):
            async def run(self):
                out = await orig(self)
                phase["states"][phase["trial"] + "_exit"] = _trial_state(self)
                return out
            return run

        def on_restore(orig):
            async def restore_worker_state(self):
                t0 = time.monotonic()
                phase["in_restore"] = True
                await orig(self)
                phase["in_restore"] = False
                torch.cuda.synchronize()
                phase["times"]["restore_s"] = time.monotonic() - t0
                phase["states"]["R2_restored"] = _trial_state(self)
            return restore_worker_state

        def on_save_recover(orig):
            async def save_recover(self, step):
                t0 = time.monotonic()
                await orig(self, step)
                phase["times"]["recover_save_s"] = time.monotonic() - t0
            return save_recover

        wrap(exps, "build_ppo_math", on_build)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        wrap(ModelWorker, "_handle_fetch", on_fetch)
        wrap(_Cycler, "__next__", on_cycler_next)
        wrap(ModelWorker, "_handle_param_sync", on_param_sync)
        wrap(MasterWorker, "execute_step", on_step_end)
        wrap(MasterWorker, "run", on_run)
        wrap(MasterWorker, "_restore_worker_state", on_restore)
        wrap(MasterWorker, "_save_recover", on_save_recover)

        fileroot = os.path.join(work, "trial")
        base_argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt,
            "--kl-ctl", "0.1", "--batch-size", str(n_prompts), "--group-size", str(n),
            "--max-new-tokens", str(max_new), "--ref-ema-eta", str(RECOVER_ETA),
            "--offload-ref", "--fileroot", fileroot, "--seed", str(seed + 43),
        ]
        plan = (("U", ["--benchmark-steps", "3", "--trial-name", "uninterrupted"]),
                ("R1", ["--benchmark-steps", "1", "--trial-name", "killed",
                        "--ckpt-freq-steps", "1"]),
                ("R2", ["--benchmark-steps", "3", "--trial-name", "killed"]))
        log(f"[recover] python -m areal_tpu_torch.apps.quickstart {' '.join(base_argv)} "
            f"with dataset_filter={RECOVER_FILTER}; trials {dict(plan)}")
        torch.cuda.synchronize()
        _reset_counts()
        try:
            for name, extra in plan:
                phase["trial"] = name
                rec.clear()
                rec.update(steps=[], loads=[], saves=[])
                c0 = _trial_counts()
                t = time.monotonic()
                stats = quickstart.main(base_argv + extra)
                torch.cuda.synchronize()
                c1 = _trial_counts()
                trials[name] = dict(
                    stats=stats, steps=list(rec["steps"]), loads=list(rec["loads"]),
                    saves=list(rec["saves"]), seconds=time.monotonic() - t,
                    launches={k: c1[k] - c0[k] for k in c1},
                    resident_bytes=rec.get("resident_bytes"), nodes=rec.get("plan_nodes"),
                )
                gc.collect()
                torch.cuda.empty_cache()
                log(f"[recover] trial {name}: {len(stats)} step(s) in "
                    f"{trials[name]['seconds']:.1f} s; checkpoint loads "
                    f"{['%.2f s' % s for s in rec['loads']]}; card memory after "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)

        # ---- every step: stats, launches, EMA, offload, fetches ----
        for name, tr in trials.items():
            check(len(tr["stats"]) == {"U": 3, "R1": 1, "R2": 2}[name],
                  f"[recover] trial {name}: {len(tr['stats'])} steps")
            check(tr["launches"] == {k: sum(st["launches"][k] for st in tr["steps"])
                                     for k in tr["launches"]},
                  f"[recover] trial {name}: launches outside its steps {tr['launches']}")
            for st in tr["steps"]:
                s, i = st["stats"], st["step"]
                check(all(math.isfinite(v) for v in s.values()),
                      f"[recover] {name} step {i}: non-finite stats")
                check(s["actor_train/quarantined"] == 0.0, f"[recover] {name} step {i} quarantined")
                _check_step_launches(f"[recover] {name}", i, st, tr["nodes"], L, max_new)
                check(st["ref_offloaded"], f"[recover] {name} step {i}: the ref is not on host")
                ids = st["fetch_ids"]
                check(len(ids) == len(set(ids)) >= n_prompts and len(st["reward_ids"]) == n_prompts,
                      f"[recover] {name} step {i}: fetched {ids}, graded {st['reward_ids']}")
                mfc = {k.split("/")[0]: round(v, 3) for k, v in s.items()
                       if k.endswith("/perf/time_s")}
                log(f"[recover] {name} step {i}: {s['time/step_s']:.2f} s; by MFC (s) {mfc}; "
                    f"peak {st['peak_mem_bytes'] / 2**30:.2f} GiB; fetched {len(ids)} ids in "
                    f"{st['loader_batches']} loader batch(es); filtered so far "
                    f"{len(st['filtered'])}")
        ema_bad = [e for e in phase["ema"] if e["bad"]]
        log(f"[recover] EMA checks: {[(e['trial'], e['step']) for e in phase['ema']]}; "
            f"leaves off the exact mix: {ema_bad}")
        check(len(phase["ema"]) == 3 + 1 + 3 and not ema_bad,
              f"[recover] EMA not bit for bit (or not 7 calls): {ema_bad or phase['ema']}")

        # ---- the filter ----
        u2, u3 = trials["U"]["steps"][1], trials["U"]["steps"][2]
        expected = u2["reward_ids"][:RECOVER_ALL_GOOD + RECOVER_ALL_BAD]
        log(f"[recover] filter: expected drop {expected}; U dropped {u2['filtered']}; "
            f"step-3 fetch {u3['fetch_ids']}")
        check(trials["U"]["steps"][0]["filtered"] == [] and u2["filtered"] == expected,
              f"[recover] U's filter dropped {u2['filtered']}, want {expected}")
        check(not set(expected) & set(u3["fetch_ids"]) and not set(expected) & set(
            trials["R2"]["steps"][1]["fetch_ids"]), "[recover] a dropped id was fetched again")
        st_u = phase["states"]["U_exit"]
        check(len(st_u["dataset_ids"]) == 64 - len(expected)
              and not set(expected) & set(st_u["dataset_ids"]),
              f"[recover] U's dataset holds {len(st_u['dataset_ids'])} rows")

        # ---- the recover checkpoint and the round trip ----
        base = os.path.join(fileroot, "checkpoints", "ppo-math", "killed", "actor@0",
                            "recover_checkpoint")
        manifest = recover.validate_manifest(base)
        check(manifest is not None and manifest["step"] == 1,
              f"[recover] R1's recover checkpoint {base} does not validate: {manifest}")
        check(not os.path.exists(base + recover.PREV_SUFFIX)
              and sorted(os.listdir(os.path.dirname(base))) == ["recover_checkpoint"],
              f"[recover] {os.listdir(os.path.dirname(base))} beside the checkpoint")
        rc_bytes = sum(f["size"] for f in manifest["files"])
        log(f"[recover] R1's recover checkpoint: {rc_bytes / 1e9:.3f} GB in "
            f"{len(manifest['files'])} files, saved in {phase['times']['recover_save_s']:.2f} s "
            f"({rc_bytes / 1e9 / phase['times']['recover_save_s']:.2f} GB/s); R2's restore "
            f"{phase['times']['restore_s']:.2f} s ({rc_bytes / 1e9 / phase['times']['restore_s']:.2f} "
            f"GB/s); manifest versions {manifest['model_versions']}")
        r1, r2 = phase["states"]["R1_exit"], phase["states"]["R2_restored"]
        for key in ("masters", "mu", "nu", "opt_count", "ref", "versions", "step_info", "ctl",
                    "filtered_ids", "dataset_ids"):
            check(r1[key] == r2[key], f"[recover] R2's restored {key} differs from R1's at exit")
        log(f"[recover] R2 restored R1's state bit for bit: masters, mu, nu "
            f"({len(r1['masters'])} leaves each), opt_count {r1['opt_count']}, the ref, "
            f"versions {r1['versions']}, step {r1['step_info']}, controls {r1['ctl']}")

        # ---- resumed against uninterrupted ----
        same = phase["states"]["U_step1"] == phase["states"]["R1_step1"]
        log(f"[recover] U's and R1's step-1 masters bitwise equal: {same} (largest "
            f"difference {phase['step1_gap']:.3e})")
        for (su, sr) in zip(trials["U"]["steps"][1:], trials["R2"]["steps"]):
            check(su["fetch_ids"] == sr["fetch_ids"],
                  f"[recover] step {sr['step']}: R2 fetched {sr['fetch_ids']}, U {su['fetch_ids']}")
        worst = {}
        for (su, sr) in zip(trials["U"]["steps"][1:], trials["R2"]["steps"]):
            for k, v in su["stats"].items():
                if "/perf/" in k or "/time/" in k or k.startswith("time/"):
                    continue
                d = abs(sr["stats"][k] - v) / max(abs(v), 1e-30)
                worst[k] = max(worst.get(k, 0.0), d)
        tokens_equal = [np.array_equal(su["tokens"], sr["tokens"])
                        for su, sr in zip(trials["U"]["steps"][1:], trials["R2"]["steps"])]
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
        log(f"[recover] R2 against U at steps 2-3: tokens equal {tokens_equal}; largest "
            f"relative stat differences {top}")
        check(same, f"[recover] U's and R1's step-1 masters differ (by up to "
              f"{phase['step1_gap']:.3e}): the train step is not deterministic on the card")
        check(all(tokens_equal) and max(worst.values()) <= RESUME_STATS_RTOL,
              f"[recover] the resumed trial left the uninterrupted one: tokens {tokens_equal}, "
              f"stats {top}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    steps_s = {name: [st["stats"]["time/step_s"] for st in tr["steps"]]
               for name, tr in trials.items()}
    report["recover"] = dict(
        launches=total, ckpt_write_s=write_s, ckpt_bytes=ckpt_bytes,
        recover_bytes=rc_bytes, times=phase["times"], steps_s=steps_s,
        peak_mem_bytes=max(st["peak_mem_bytes"] for tr in trials.values() for st in tr["steps"]),
        trial_s={name: tr["seconds"] for name, tr in trials.items()},
    )
    log(f"[recover] step seconds {steps_s}; peak {report['recover']['peak_mem_bytes'] / 2**30:.2f} "
        f"GiB; launches over the phase {total}")
    log_card()


TRAIN_PARITY_LR = 1e-5


def _train_parity_inputs(seed):
    """phase_train_parity's batch and its two runs (kind, model config,
    weight seed, loss, the loss's keys), the same in the phase and in the
    CPU references' child."""
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample
    from areal_tpu_torch.interfaces.ppo import _ppo_actor_loss_factory, _ppo_critic_loss_factory
    from areal_tpu_torch.models.config import qwen2_config

    base = dataclasses.replace(qwen2_config("1.5b", param_dtype="float32"), n_layers=2)
    rng = np.random.default_rng(seed + 5)
    lens = [100, 300, 150, 200]
    total = sum(lens)
    pmask = np.concatenate([np.arange(l) < l // 3 for l in lens])
    lmask = np.concatenate([(np.arange(l) >= l // 3 - 1) & (np.arange(l) < l - 1) for l in lens])
    arrays = dict(
        packed_input_ids=rng.integers(0, base.vocab_size, total).astype(np.int32),
        prompt_mask=pmask,
        old_logp=(-12.0 + 0.5 * rng.standard_normal(total)).astype(np.float32),
        advantages=rng.standard_normal(total).astype(np.float32),
        loss_mask=lmask.astype(np.float32),
        old_values=(0.5 * rng.standard_normal(total)).astype(np.float32),
        returns=rng.standard_normal(total).astype(np.float32),
    )
    sample = SequenceSample(
        keys=set(arrays), ids=[f"s{i}" for i in range(len(lens))],
        seqlens={k: [[l] for l in lens] for k in arrays}, data=arrays,
    )
    runs = (
        ("actor", base, seed + 4, _ppo_actor_loss_factory(0.2),
         ("old_logp", "advantages", "loss_mask")),
        ("critic", base.as_critic(), seed + 9, _ppo_critic_loss_factory(0.2),
         ("old_values", "returns", "loss_mask")),
    )
    return sample, runs


def _train_parity_run(sample, run, dev):
    """One train_batch of `run` on `dev`: its stats, the weights after it
    (on the host) and the inputs' fingerprint; on the card, K1's launches
    held to 2 layers."""
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import _mask_count
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models.transformer import init_params

    kind, cfg, pseed, loss_fn, extra_keys = run
    params = init_params(cfg, pseed, device="cpu")
    inputs = _inputs_print(params)
    eng = TrainEngine(
        cfg, params, dev, compute_dtype=torch.float32,
        optimizer_config=OptimizerConfig(lr=TRAIN_PARITY_LR, warmup_steps_proportion=0.0),
        ftspec=FinetuneSpec(1, 8, 8), remat_policy="full",
    )
    fa.reset_launches()
    t0 = time.monotonic()
    out = eng.train_batch(sample, MicroBatchSpec(), loss_fn, _mask_count, extra_keys=extra_keys)
    secs = time.monotonic() - t0
    if dev == "cuda":
        check(fa.LAUNCHES == {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers,
                              "dkv": cfg.n_layers},
              f"{kind}: card launches {fa.LAUNCHES}")
    after = {k: v.detach().cpu() for k, v in _flat_params(eng.get_params())}
    return dict(out=out, after=after, secs=secs, inputs=inputs)


def _train_parity_cpu(seed):
    sample, runs = _train_parity_inputs(seed)
    return {run[0]: _train_parity_run(sample, run, "cpu") for run in runs}


def phase_train_parity(seed):
    """One train_batch at qwen2-1.5B width, 2 layers, fp32: the card (K1
    kernels, cuBLAS) against the CPU (plain versions, computed by the CPU
    references' child), same weights and batch, same loss: the actor's
    PPO loss, then a critic's clipped value loss on the value head."""
    import torch

    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sample, runs = _train_parity_inputs(seed)
    lr = TRAIN_PARITY_LR
    ref = None
    for run in runs:
        kind, cfg, pseed = run[:3]
        res = {"cuda": _train_parity_run(sample, run, "cuda")}
        ref = ref or _cpu_ref("train_parity")
        res["cpu"] = ref.pop(kind)
        check(res["cpu"]["inputs"] == res["cuda"]["inputs"],
              f"[train_parity] {kind}: the CPU reference ran on other weights")
        out = {dev: r["out"] for dev, r in res.items()}
        for dev, r in res.items():
            log(f"[train_parity] {kind} {dev}: loss={r['out']['loss']:.8e} "
                f"grad_norm={r['out']['grad_norm']:.8e} ({r['secs']:.1f} s)")
        before = dict(_flat_params(init_params(cfg, pseed, device="cpu")))
        rel = {
            k: abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
            for k in ("loss", "grad_norm")
        }
        # Adam's first step moves each weight by about lr * sign(g) (plus
        # decay): compare the two devices' moves.  A gradient element near
        # 0 (|g| ~ eps) may move by a different fraction of lr on each
        # side, so the bound is on the share of weights whose moves differ
        # by more than lr / 10, and on the largest difference (2 lr:
        # opposite signs).
        n_all = n_off = 0
        worst = 0.0
        for k, p0 in before.items():
            d = (res["cuda"]["after"][k] - p0) - (res["cpu"]["after"][k] - p0)
            worst = max(worst, float(d.abs().max()))
            n_off += int((d.abs() > lr / 10).sum())
            n_all += d.numel()
        frac = n_off / n_all
        log(f"[train_parity] {kind}, 2 layers fp32: loss rel diff {rel['loss']:.2e}, "
            f"grad_norm rel diff {rel['grad_norm']:.2e} (bound 1e-4); weight moves differing "
            f"by > lr/10: {n_off} of {n_all} ({frac:.2e}, bound 1e-3); largest "
            f"{worst:.3e} (bound {2 * lr:g})")
        check(rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-4,
              f"{kind}: loss/grad_norm differ card vs CPU: {rel}")
        check(frac <= 1e-3 and worst <= 2 * lr * (1 + 1e-3),
              f"{kind}: params after the step differ card vs CPU")
        del res


# --------------------------------------------------------------------------
# genmodes: the generator's other inflight modes at full size
# --------------------------------------------------------------------------

# (name, engine options, request options, the attention kernel a decode
# step of the mode launches once per layer)
GENMODES = (
    ("dense", dict(kv_paged=False), {}, "k4"),
    ("dense_int8", dict(kv_paged=False, kv_cache_dtype="int8"), {}, "k4"),
    ("dense_spec", dict(kv_paged=False), dict(spec_decode_k=4), "k4"),
    ("paged2", dict(prefill_chunk_tokens=0), {}, "k2"),
    ("paged2_int8", dict(prefill_chunk_tokens=0, kv_cache_dtype="int8"), {}, "k2"),
    ("serving_spec", {}, dict(spec_decode_k=4), "k2"),
)
# The decode-chunk getter of each mode's loop.
GENMODE_CHUNK_GETTER = {
    "dense": "_get_inflight_decode_fn", "dense_int8": "_get_inflight_decode_fn",
    "dense_spec": "_get_spec_decode_fn", "paged2": "_get_paged_decode_fn",
    "paged2_int8": "_get_paged_decode_fn", "serving_spec": "_get_serving_chunk_fn",
}
GENMODE_SLOTS = 16
# New tokens a response in the modes (128 before the async phase came:
# host-bound decode steps are most of the phase; two waves of 16 slots
# still run two chunks and more a mode, so every check holds).
GENMODE_NEW_TOKENS = 64
INT8_AGREEMENT = 0.85  # tests/test_generator.py:316's bound


def _genmode_run(name, cfg, params, prompts, n, max_new, ekw, gkw, kernel, seed):
    """One mode: the burst (every prompt at once, n greedy responses of
    max_new tokens, the mode's request options) through GenerationServer
    over an engine with GENMODE_SLOTS slots.  The launch counts are set
    to 0 just before the burst and read just after it.  The mode's second
    decode chunk runs under torch.cuda.set_sync_debug_mode("error"); CUDA
    events bracket every chunk; a speculative step's emitted tokens are
    summed on the card."""
    import torch

    from areal_tpu_torch.engines import generator as gen_mod
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.gen_server import GenerationServer

    engine = GeneratorEngine(cfg, params, eos_token_id=151643,
                             max_decode_batch=GENMODE_SLOTS, **ekw)
    check(engine.device.type == "cuda", f"[genmodes] {name}: the engine is not on the card")
    engine.static_path_max_new = 0  # every mode is an inflight one
    calls, chunk_ev, held = [], [], {}
    real_generate = engine.generate

    def generate(sample, *a, **k):
        out = real_generate(sample, *a, **k)
        calls.append(dict(prefill_dispatches=engine.prefill_dispatches,
                          cache_copy_bytes=engine.cache_copy_bytes,
                          decode_compiles=engine.decode_compiles,
                          dead_live_lanes=engine.dead_live_lanes))
        return out

    getter_name = GENMODE_CHUNK_GETTER[name]
    real_getter = getattr(engine, getter_name)

    def getter(*a, **k):
        fn = real_getter(*a, **k)

        def run(*fa, **fk):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            hold = len(chunk_ev) == 1  # the second chunk: kernels loaded, warm
            if hold:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            ev[0].record()
            try:
                out = fn(*fa, **fk)
            except RuntimeError as e:
                if hold:
                    held["error"] = repr(e)
                raise
            finally:
                if hold:
                    torch.cuda.set_sync_debug_mode(0)
            ev[1].record()
            if hold:
                held["ok"] = True
            chunk_ev.append(ev)
            return out

        return run

    spec_acc = torch.zeros(2, dtype=torch.long, device=engine.device)  # (emitted, row-steps)
    real_emit = gen_mod._spec_emit

    def spec_emit(*a, **k):
        out = real_emit(*a, **k)
        gen0, gen1 = a[9], out[2]  # gen_count before and after the step
        emitted = gen1 - gen0
        spec_acc.add_(torch.stack([emitted.sum(), (emitted > 0).sum()]))
        return out

    engine.generate = generate
    setattr(engine, getter_name, getter)
    gen_mod._spec_emit = spec_emit
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = engine.steps_total
        _reset_counts()
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed,
                                          greedy=True, **gkw)
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _trial_counts()
        steps = engine.steps_total - steps0
        peak = torch.cuda.max_memory_allocated()
    finally:
        gen_mod._spec_emit = real_emit
        server.close()
    check(held.get("ok") and "error" not in held,
          f"[genmodes] {name}: a decode chunk synchronised with the host: {held}")
    check(not errors and all(r is not None for r in replies),
          f"[genmodes] {name}: requests failed: {errors[:3]}")
    n_tok, outputs = 0, []
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"[genmodes] {name} q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new, f"[genmodes] {name} q{i}: {len(ids)} tokens")
            check(len(ids) == max_new or ids[-1] == 151643,
                  f"[genmodes] {name} q{i}: short without EOS")
            check(len(lps) == len(ids), f"[genmodes] {name} q{i}: logprobs/ids lengths")
            check(all(math.isfinite(x) and x <= 1e-6 for x in lps),
                  f"[genmodes] {name} q{i}: bad logprob")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"[genmodes] {name} q{i}: bad id")
            n_tok += len(ids)
        outputs.append(r["output_ids"])
    prefill = sum(c["prefill_dispatches"] for c in calls)
    L = cfg.n_layers
    want = dict(fwd=L * prefill, dq=0, dkv=0, k2=0, k3=0, k4=0)
    want[kernel] = L * steps
    chunk_ms = sum(a.elapsed_time(b) for a, b in chunk_ev)
    emitted, row_steps = (int(x) for x in spec_acc.tolist())
    K = gkw.get("spec_decode_k", 0)
    out = dict(
        requests=len(prompts), n=n, max_new_tokens=max_new, generate_calls=len(calls),
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall, steps=steps,
        chunks=len(chunk_ev), chunk_s=chunk_ms / 1e3, decode_step_ms=chunk_ms / max(steps, 1),
        prefill_dispatches=prefill,
        cache_copy_bytes=sum(c["cache_copy_bytes"] for c in calls),
        decode_compiles=sum(c["decode_compiles"] for c in calls),
        launches=counts, peak_mem_bytes=peak, outputs=outputs,
    )
    if K:
        out.update(tokens_per_spec_step=emitted / max(row_steps, 1),
                   acceptance=(emitted - row_steps) / max(K * row_steps, 1))
    log(f"[genmodes] {name}: {len(prompts)} requests x n={n} greedy{f' K={K}' if K else ''}: "
        f"{n_tok} tokens in {wall:.2f} s = {out['tokens_per_s']:.1f} tok/s; {steps} decode "
        f"steps in {len(chunk_ev)} chunks, {out['decode_step_ms']:.3f} ms a step (CUDA events "
        f"around each chunk); prefill dispatches {prefill}; cache copy bytes "
        f"{out['cache_copy_bytes']}; chunk builds {out['decode_compiles']}; generate calls "
        f"{len(calls)}; launches {counts}; peak mem {peak / 2**30:.2f} GiB"
        + (f"; {out['tokens_per_spec_step']:.3f} tokens a verify step, acceptance "
           f"{out['acceptance']:.3f}" if K else ""))
    check(counts == want, f"[genmodes] {name}: launches {counts} != {want}")
    check(steps > 0 and counts[kernel] > 0, f"[genmodes] {name}: the mode ran no decode step")
    check(all(c["dead_live_lanes"] == 0 for c in calls), f"[genmodes] {name}: dead live lanes")
    log(f"[genmodes] {name}: chunk 2 of {len(chunk_ev)} ran under "
        f"set_sync_debug_mode('error'): no host sync")
    del engine.generate, server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _agreement(a, b):
    """Token agreement of two runs' outputs as tests/test_generator.py:316
    counts it (prompt + response of every sequence, positionally, where
    the lengths match), and over the responses alone."""
    import numpy as np

    same = total = r_same = r_total = 0
    first_flip = []
    for (prompt, outs_a), outs_b in zip(a, b):
        for x, y in zip(outs_a, outs_b):
            m = min(len(x), len(y))
            eq = np.asarray(x[:m]) == np.asarray(y[:m])
            r_same, r_total = r_same + int(eq.sum()), r_total + max(len(x), len(y))
            same, total = same + len(prompt) + int(eq.sum()), total + len(prompt) + max(len(x), len(y))
            first_flip.append(int(np.argmin(eq)) if not eq.all() else m)
    return same / total, r_same / r_total, first_flip


def _teacher_forced_logits(cfg, params, prompts, resp, paged, dtype):
    """fp32 logits [b, n_new, V] of the model along the responses `resp`
    (one a prompt, cut to the shortest), teacher-forced through the
    engine's own forwards over a cache in `dtype`: one batched prefill
    (K1f), then one decode step a position (dense: `decode_step_inflight`,
    K4; paged: `decode_step_paged`, K2's kernel) fed the response's
    token."""
    import numpy as np
    import torch

    from areal_tpu_torch.models import transformer as tfm

    dev = params["embed"].device
    b = len(prompts)
    n_new = min(len(r) for r in resp)
    plens = np.array([len(p) for p in prompts])
    sp = 128 * -(-int(plens.max()) // 128)
    rows = np.zeros((b, sp), np.int64)
    for i, p in enumerate(prompts):
        rows[i, : len(p)] = p
    rows_d, plens_d = torch.from_numpy(rows).to(dev), torch.from_numpy(plens).to(dev)
    resp_d = torch.tensor([r[:n_new] for r in resp], device=dev)
    mp = -(-(sp + n_new) // 128)
    with torch.no_grad():
        if paged:
            kv = tfm.init_paged_kv_cache(cfg, b * mp, 128, dtype=dtype, device=dev)
            table = torch.arange(b * mp, device=dev).reshape(b, mp)
            logits, _ = tfm.prefill_into_pages(params, cfg, rows_d, plens_d, kv,
                                               table[:, : sp // 128])
        else:
            kv = tfm.init_kv_cache(cfg, b, sp + n_new, dtype=dtype, device=dev)
            logits, _ = tfm.prefill_into_slots(params, cfg, rows_d, plens_d, kv,
                                               torch.arange(b))
        out = [logits]
        for t in range(n_new - 1):
            tok, pos = resp_d[:, t], plens_d + t
            if paged:
                logits, _ = tfm.decode_step_paged(params, cfg, tok, pos, kv, table, pos,
                                                  pos + 1)
            else:
                logits, _ = tfm.decode_step_inflight(params, cfg, tok, pos, kv, slots=pos,
                                                     valid_to=pos + 1)
            out.append(logits)
        del kv
    return torch.stack(out, 1)


def _teacher_forced(cfg, params, prompts, outputs, paged):
    """Greedy tokens of the bf16 and of the int8 model along the bf16
    run's responses (each prompt's first), teacher-forced
    (`_teacher_forced_logits`).  Returns (the fraction of response
    positions where the int8 model's token equals the bf16 model's, the
    fraction where the bf16 model's equals the bf16 run's own)."""
    import numpy as np
    import torch

    resp = [o[0] for o in outputs]
    n_new = min(len(r) for r in resp)
    preds = [_teacher_forced_logits(cfg, params, prompts, resp, paged, dtype)
             .argmax(-1).cpu().numpy() for dtype in (torch.bfloat16, "int8")]
    run = np.asarray([r[:n_new] for r in resp])
    return float((preds[0] == preds[1]).mean()), float((preds[0] == run).mean())


def _genmode_quickstart(seed):
    """(e) One `quickstart ppo-math` step at qwen2-1.5B with
    --no-paged-kv --spec-decode-k 4 --kv-cache-dtype int8: generate takes
    the dense window's spec path over an int8 cache.  8 prompts x 4
    responses, 128 new tokens, rewards replaced by seeded +-5 (a random
    model's are all -5).  Launches: K4 = L x the inflight decode steps,
    K1f = L x (prefill dispatches + 2 train forwards a micro-batch + the
    train engine's forward micro-batches), K1dq = K1dkv = L x train
    micro-batches, K2 = K3 = 0."""
    import functools
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.models.config import qwen2_config

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    rng = np.random.default_rng(seed + 50)
    os.makedirs(QUICKSTART_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="genmodes-", dir=QUICKSTART_DIR)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    try:
        _check_disk("[genmodes]", work, _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, _, _ = _shared_checkpoint("[genmodes]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(rng, 16):
                f.write(json.dumps(row) + "\n")
        rec = {"steps": [], "loads": [], "saves": []}
        cur = {}
        _record_trial_steps(wrap, rec, cur)
        modes = []

        def on_generate(orig):
            @functools.wraps(orig)
            def generate(self, *a, **k):
                s0 = self.steps_total
                out = orig(self, *a, **k)
                cur["inflight_steps"] = cur.get("inflight_steps", 0) + self.steps_total - s0
                cur["prefill"] = cur.get("prefill", 0) + self.prefill_dispatches
                return out
            return generate

        def on_spec(orig):
            @functools.wraps(orig)
            def spec(self, *a, **k):
                modes.append((self.kv_paged, self.kv_cache_dtype))
                return orig(self, *a, **k)
            return spec

        def on_reward(orig):
            @functools.wraps(orig)
            def inference(self, model, sample, mb_spec):
                out = orig(self, model, sample, mb_spec)
                out.data["rewards"] = rng.choice(
                    [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
                return out
            return inference

        wrap(GeneratorEngine, "generate", on_generate)
        wrap(GeneratorEngine, "_generate_inflight_spec", on_spec)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        argv = [
            "ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--batch-size", "8",
            "--group-size", "4", "--max-new-tokens", "128", "--benchmark-steps", "1",
            "--fileroot", os.path.join(work, "trial"), "--seed", str(seed + 52),
            "--no-paged-kv", "--spec-decode-k", "4", "--kv-cache-dtype", "int8",
        ]
        log(f"[genmodes] (e) python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t = time.monotonic()
            stats = quickstart.main(argv)
            torch.cuda.synchronize()
            trial_s = time.monotonic() - t
            total = _trial_counts()
        finally:
            for owner, name, orig in reversed(restore):
                setattr(owner, name, orig)
        check(len(stats) == 1 and len(rec["steps"]) == 1, f"[genmodes] (e): {len(stats)} steps")
        check(modes == [(False, "int8")], f"[genmodes] (e): spec path calls {modes}")
        st, s = rec["steps"][0], stats[0]
        check(all(math.isfinite(v) for v in s.values()), "[genmodes] (e): non-finite stats")
        L, mbs = cfg.n_layers, sum(c["mbs"] for c in st["train_calls"])
        want = dict(fwd=L * (st["prefill"] + 2 * mbs + st["train_fwd_mbs"]), dq=L * mbs,
                    dkv=L * mbs, k2=0, k3=0, k4=L * st["inflight_steps"])
        log(f"[genmodes] (e) 1 step: {s['time/step_s']:.2f} s (generate "
            f"{s.get('actor_gen/perf/time_s', float('nan')):.2f} s); {st['inflight_steps']} "
            f"dense spec decode steps, {st['prefill']} prefill dispatches, {mbs} train "
            f"micro-batches; launches {st['launches']}; peak {st['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB; trial {trial_s:.1f} s")
        check(st["launches"] == want and total == want and want["k4"] > 0,
              f"[genmodes] (e): launches {st['launches']} (trial {total}) != {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return dict(step_s=s["time/step_s"], generate_s=s.get("actor_gen/perf/time_s"),
                decode_steps=st["inflight_steps"], prefill_dispatches=st["prefill"],
                launches=total, peak_mem_bytes=st["peak_mem_bytes"], trial_s=trial_s)


def phase_genmodes(report, seed):
    """The serve phase's burst cut to its first 8 prompts (64-512 tokens,
    n=4: 32 requests, GENMODE_NEW_TOKENS new tokens, greedy) through GenerationServer at
    full qwen2-1.5B in bf16, in each inflight mode of GENMODES with 16
    slots (two waves, so admissions and retirements cycle): (a) the dense
    window in bf16 and with an int8 cache, (b) dense spec K=4, (c) the
    two-program paged path in bf16 and int8, (d) spec K=4 on the serving
    plane; then (e) one
    quickstart ppo-math step with --no-paged-kv --spec-decode-k 4
    --kv-cache-dtype int8.  Checked per mode: the replies, the launches
    (K4 = L x decode steps in (a) and (b), K2 = L x decode steps in (c)
    and L x inner steps in (d), K1f = L x prefill dispatches, every
    other kernel 0), no host sync inside a chunk; int8 against bf16 token
    agreement >= 0.85 teacher-forced along the bf16 run (`_teacher_forced`;
    the free-running count of tests/test_generator.py:316 is printed)."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    n_req, n, max_new = 8, 4, GENMODE_NEW_TOKENS
    rng = np.random.default_rng(seed)
    prompts = [  # the serve phase's prompts, its first n_req of 16
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(16)
    ][:n_req]
    t_phase = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    modes = {}
    for name, ekw, gkw, kernel in GENMODES:
        modes[name] = _genmode_run(name, cfg, params, prompts, n, max_new, ekw, gkw,
                                   kernel, seed + 60)
    # int8 against bf16.  Free-running greedy outputs diverge for good at
    # their first near-tie flip (random weights give nearly flat logits),
    # so they are counted for the record; the check is the
    # teacher-forced agreement, token by token along the bf16 run.
    agreement = {}
    for bf, q8, paged in (("dense", "dense_int8", False), ("paged2", "paged2_int8", True),
                          ("dense", "paged2", None)):
        packed, resp, flips = _agreement(
            list(zip(prompts, modes[bf]["outputs"])), modes[q8]["outputs"])
        agreement[q8 if paged is not None else "paged2_vs_dense"] = rec = dict(
            packed=packed, responses=resp, first_flip_median=float(np.median(flips)))
        log(f"[genmodes] {q8} against {bf}, free-running greedy: token agreement "
            f"{packed:.4f} over prompt + response (tests/test_generator.py:316's count), "
            f"{resp:.4f} over the responses; first differing response position: median "
            f"{int(np.median(flips))}, min {min(flips)} of {max_new}")
        if paged is None:
            continue
        tf, tf_self = _teacher_forced(cfg, params, prompts, modes[bf]["outputs"], paged)
        rec.update(teacher_forced=tf, bf16_reproduced=tf_self)
        log(f"[genmodes] {q8} against {bf}, teacher-forced along the {bf} run's responses: "
            f"token agreement {tf:.4f}; the bf16 model's own tokens reproduced at {tf_self:.4f}")
        check(tf >= INT8_AGREEMENT, f"[genmodes] {q8}: teacher-forced agreement {tf} < "
              f"{INT8_AGREEMENT}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    quick = _genmode_quickstart(seed)
    launches = {k: sum(m["launches"][k] for m in modes.values()) + quick["launches"][k]
                for k in quick["launches"]}
    secs = time.monotonic() - t_phase
    log(f"[genmodes] launches over the phase {launches}; {secs:.1f} s")
    for m in modes.values():
        m.pop("outputs")
    report["genmodes"] = dict(modes=modes, agreement=agreement, quickstart=quick,
                              launches=launches, seconds=secs)


# --------------------------------------------------------------------------
# Phase: asynchronous RL at full size
# --------------------------------------------------------------------------

ASYNC_DIR = os.path.join(REPO, ".async_tmp")
# The generation server's serving plane for (b) and (c): 32 slots (8
# prompts x 4 in one wave) over an explicitly sized pool, so the pool
# does not take the trainer's memory (an auto-sized pool fills the free
# memory it finds).  256 pages of 128 tokens: 32 rows of <= 512 + 128.
ASYNC_SLOTS = 32
ASYNC_POOL_PAGES = 256
# The server's prefill slice a row and inner step (the engine's default is
# 8, which with its auto admit headroom of 4 x 8 lanes admits 32 prompt
# tokens an inner step: ~520 inner steps a 32-row batch of 64-512-token
# prompts, against ~160 at 64).
ASYNC_PREFILL_TOKENS = 64
# Code items graded by the service and in this process: a program that
# passes, one with the wrong output, one that fails to run, no program.
ASYNC_CODE_IO = json.dumps({"inputs": ["3 4", "10 -2"], "outputs": ["7", "8"]})
ASYNC_CODE_ITEMS = [
    ("```python\na, b = map(int, input().split())\nprint(a + b)\n```", True),
    ("```python\na, b = map(int, input().split())\nprint(a - b)\n```", False),
    ("```python\nraise SystemExit(3)\n```", False),
    ("the sum is 7", False),
]


def _async_rows(rng, n_math, n_code):
    """_math_rows' rows and `n_code` code rows (sum two integers), shuffled
    together by the dataset loader."""
    rows = _math_rows(rng, n_math)
    for i in range(n_code):
        text = "Write a program that reads two integers and prints their sum. "
        target = int(rng.integers(64, 257))
        while len(text) < target:
            text += "Use python. "
        rows.append({"query_id": f"c{i}", "prompt": text[:target], "task": "code",
                     "input_output": ASYNC_CODE_IO})
    return rows


def _async_server_engine(cfg, params):
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine

    eos = CharTokenizer(cfg.vocab_size).eos_token_id  # the trials' tokenizer
    engine = GeneratorEngine(cfg, params, eos_token_id=eos,
                             max_decode_batch=ASYNC_SLOTS, kv_pool_pages=ASYNC_POOL_PAGES,
                             prefill_chunk_tokens=ASYNC_PREFILL_TOKENS)
    engine.static_path_max_new = 0  # the serving plane, which a push parks
    return engine


def phase_async(report, seed):
    """Asynchronous RL at qwen2-1.5B's full width (CUT_LAYERS layers, random
    weights; 8 prompts x 4, 128 new tokens) from a seeded checkpoint of
    that depth:

    (a) `quickstart.main(["ppo-math", ..., "--rollout-ahead", "1"])`, three
        steps in this process (rewards seeded +-5): each batch generated
        under one generator version (no weight sync lands inside a
        generate call), the generate calls of steps 2 and 3 run inside
        steps 1 and 2, generation t+1 on the weights after step t-1, and
        each step's launches = L x the engines' calls (K1f, K1dq, K1dkv,
        K4; K2 and K3 0).  Step walls against the quickstart phase's
        barrier step, the card's idle share (NVML) and the peak printed.
    (b) a port GenerationServer (serving plane, 32 slots, a 256-page pool)
        and a port reward service on 127.0.0.1 in this process; the server
        loads the checkpoint through POST /update_weights (version 1); then
        a trial through build_ppo_math and run_experiment with
        gen_server_url, inmem_weight_sync, max_head_offpolicyness 1,
        replay_capacity 4 and the reward interface's remote_url, 4 steps:
        replay/staleness <= 1 every step and 1 at the last, rejected 0,
        accepted 4; behav_imp_weight finite, behav_cap_clip in [0, 1]; the
        server's version 1 + the pushes; K2 = L x the server's inner
        steps, K3 = L x its resume_replays, K1 = L x the train engine's
        calls, K4 0; every reward graded over HTTP equal to in-process
        grading of the same rows, and code items run in the sandbox graded
        alike by the service and in this process.
    (c) a RolloutController pumps 32 prompts through (b)'s server into a
        ReplayBuffer (cap 1) while RemoteGeneratorEngine.set_params makes 3
        disk pushes (inmem sync): at least one request parked and resumed
        (version_start < version_end), every consumed group within the
        bound, no prompt failed; then greedy tokens under the last pushed
        version equal an in-process engine's on the same weights."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.config import qwen2_config

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    t_phase = time.monotonic()
    os.makedirs(ASYNC_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=ASYNC_DIR)
    try:
        # The shared checkpoint (where no earlier phase wrote it), two push
        # checkpoints (one a remote engine) and a margin.
        _check_disk("[async]", work, 3 * _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, _, _ = _shared_checkpoint("[async]", cfg, seed + 21)
        rng = np.random.default_rng(seed + 90)
        data = os.path.join(work, "rows.jsonl")
        with open(data, "w") as f:
            for row in _async_rows(rng, 56, 8):
                f.write(json.dumps(row) + "\n")
        out = {"a": _async_ahead(report, seed, cfg, ckpt, data, work)}
        gc.collect()
        torch.cuda.empty_cache()
        out.update(_async_remote(seed, cfg, ckpt, data, work))
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: out["a"]["launches"][k] + out["b"]["launches"][k] + out["c"]["launches"][k]
                for k in out["a"]["launches"]}
    secs = time.monotonic() - t_phase
    log(f"[async] launches over the phase {launches}; {secs:.1f} s")
    report["async"] = dict(out, launches=launches, seconds=secs)


def _async_ahead(report, seed, cfg, ckpt, data, work):
    """(a): the one-step rollout overlap through the CLI."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.system.master import MasterWorker

    n_prompts, n, max_new, n_steps = 8, 4, 128, 3
    rng = np.random.default_rng(seed + 91)
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    rec, cur = {"steps": []}, {}
    _record_trial_steps(wrap, rec, cur)
    # The generate calls, the weight syncs into the generator (after the
    # first step began: the engine's constructor sets its weights too)
    # and the steps, on one clock.
    marks = {"gens": [], "syncs": [], "steps": [], "synced": 0, "started": False}
    lock = threading.Lock()

    def on_generate(orig):
        @functools.wraps(orig)
        def generate(self, *a, **k):
            with lock:
                t0, v0 = time.monotonic(), marks["synced"]
            out = orig(self, *a, **k)
            with lock:
                marks["gens"].append((t0, time.monotonic(), v0, marks["synced"]))
            return out
        return generate

    def on_set_params(orig):
        @functools.wraps(orig)
        def set_params(self, params):
            t0 = time.monotonic()
            orig(self, params)
            with lock:
                if marks["started"]:
                    marks["synced"] += 1
                    marks["syncs"].append((t0, time.monotonic()))
        return set_params

    def on_step(orig):
        async def execute_step(self):
            t0 = time.monotonic()
            marks["started"] = True
            stats = await orig(self)
            marks["steps"].append((t0, time.monotonic()))
            return stats
        return execute_step

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)
            out.data["rewards"] = rng.choice(
                [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
            return out
        return inference

    wrap(GeneratorEngine, "generate", on_generate)
    wrap(GeneratorEngine, "set_params", on_set_params)
    wrap(MasterWorker, "execute_step", on_step)
    wrap(MultiTaskRewardInterface, "inference", on_reward)
    argv = [
        "ppo-math", "--model.path", ckpt, "--dataset.path", data,
        "--tokenizer-path", f"char:{cfg.vocab_size}", "--batch-size", str(n_prompts),
        "--group-size", str(n), "--max-new-tokens", str(max_new), "--benchmark-steps",
        str(n_steps), "--fileroot", os.path.join(work, "ahead"), "--seed", str(seed + 92),
        "--rollout-ahead", "1",
    ]
    log(f"[async] (a) python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
    try:
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        with _BusySampler() as busy:
            stats = quickstart.main(argv)
            torch.cuda.synchronize()
        trial_s = time.monotonic() - t
        total = _trial_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
    check(len(stats) == n_steps == len(rec["steps"]) == len(marks["steps"]),
          f"(a) {len(stats)} steps of stats, {len(rec['steps'])} recorded")
    gens, syncs, steps = marks["gens"], marks["syncs"], marks["steps"]
    log(f"[async] (a) generate calls (start, end, syncs before, syncs after, s from trial "
        f"start): {[(round(a - t, 2), round(b - t, 2), v0, v1) for a, b, v0, v1 in gens]}; "
        f"syncs {[(round(a - t, 2), round(b - t, 2)) for a, b in syncs]}; steps "
        f"{[(round(a - t, 2), round(b - t, 2)) for a, b in steps]}")
    check(len(gens) == n_steps and len(syncs) == n_steps,
          f"(a) {len(gens)} generate calls and {len(syncs)} weight syncs, want {n_steps} each")
    for i, (a, b, v0, v1) in enumerate(gens):
        check(v0 == v1 and not any(s0 < b and a < s1 for s0, s1 in syncs),
              f"(a) a weight sync landed inside generate call {i + 1}")
    # Generate call 1 runs inline in step 1; call k+1 (k >= 1), the
    # prefetch of step k+1, inside step k, on the weights of step k-1.
    check(steps[0][0] <= gens[0][0] and gens[0][1] <= steps[0][1], "(a) step 1's generate")
    for k in range(1, n_steps):
        s0, s1 = steps[k - 1]
        check(s0 <= gens[k][0] and gens[k][1] <= s1,
              f"(a) the batch of step {k + 1} was not generated during step {k}")
    check([g[2] for g in gens] == [0, 0, 1], f"(a) syncs before each generate "
          f"{[g[2] for g in gens]}, want [0, 0, 1]")
    nodes = rec["plan_nodes"]
    walls = []
    for i, st in enumerate(rec["steps"]):
        s = st["stats"]
        check(all(math.isfinite(v) for v in s.values()), f"(a) step {i + 1}: non-finite stats")
        check(s["actor_train/quarantined"] == 0.0, f"(a) step {i + 1} was quarantined")
        _check_step_launches("[async] (a)", i + 1, st, nodes, cfg.n_layers, max_new,
                             gen_chunks=((2, 2), (1, 1), (0, 0))[i])
        walls.append(s["time/step_s"])
    check(total == {k: sum(st["launches"][k] for st in rec["steps"]) for k in total},
          f"(a) launches outside the steps: {total}")
    barrier = [x["step_s"] for x in report.get("quickstart", {}).get("steps", [])]
    share = busy.share
    log(f"[async] (a) rollout-ahead step walls {[round(w, 3) for w in walls]} s against the "
        f"quickstart phase's barrier steps {[round(w, 3) for w in barrier] or 'not run'} s "
        f"(its steps carry a ref); trial {trial_s:.1f} s; card busy "
        f"{'not measured' if share is None else f'{share:.3f}'} over the trial "
        f"({busy.samples} NVML samples); peak {peak / 2**30:.2f} GiB; importance_weight "
        f"{[round(x['actor_train/importance_weight'], 5) for x in stats]}")
    return dict(step_s=walls, barrier_step_s=barrier, trial_s=trial_s, busy_share=share,
                peak_bytes=peak, launches=total,
                generate_s=[b - a for a, b, _, _ in gens], sync_s=[b - a for a, b in syncs])


def _async_remote(seed, cfg, ckpt, data, work):
    """(b) and (c) against one generation server and one reward service."""
    import numpy as np
    import torch

    from areal_tpu_torch.interfaces import reward_service
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    # The server starts on other weights and loads the checkpoint over
    # /update_weights; its paths are confined to the repo's scratch dirs.
    engine = _async_server_engine(cfg, init_params(cfg, seed + 93, device="cuda"))
    check(engine.device.type == "cuda", "(b) the server's engine is not on the card")
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=200.0,
                              ckpt_root=REPO)
    verifier = reward_service.serve("127.0.0.1", 0, background=True)
    vurl = f"http://127.0.0.1:{verifier.server_port}"
    try:
        t = time.monotonic()
        v = _post(server.url + "/update_weights", {"path": ckpt})["version"]
        load_s = time.monotonic() - t
        check(v == 1, f"(b) the server's version after loading the checkpoint: {v}")
        try:
            _post(server.url + "/update_weights", {"path": "/"})
            outside = False
        except Exception:  # noqa: BLE001 — refused: HTTP 500 with the reason
            outside = True
        check(outside and server.version == 1, "(b) a path outside ckpt_root was not refused")
        log(f"[async] (b) server at {server.url} (serving plane, {ASYNC_SLOTS} slots, "
            f"{ASYNC_POOL_PAGES} pages), checkpoint loaded over /update_weights in "
            f"{load_s:.2f} s -> version 1; a path outside ckpt_root refused; reward service "
            f"at {vurl}")
        b = _async_decoupled(seed, cfg, ckpt, data, work, server, vurl)
        gc.collect()
        torch.cuda.empty_cache()
        c = _async_controller(seed, cfg, data, work, server)
    finally:
        server.close()
        verifier.shutdown()
        verifier.server_close()
    del engine, server
    return {"b": dict(b, load_s=load_s), "c": c}


def _async_decoupled(seed, cfg, ckpt, data, work, server, vurl):
    """(b): the trial generating on the server, grading on the service."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.interfaces import reward_service
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.system.gen_server import RemoteGeneratorEngine
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    n_prompts, n, max_new, n_steps = 8, 4, 128, 4
    rng = np.random.default_rng(seed + 94)
    engine = server.engine
    restore = []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    calls = {"train_mbs": 0, "fwd_mbs": 0, "graded": 0, "mismatch": [], "push_s": []}

    def on_train_batch(orig):
        @functools.wraps(orig)
        def train_batch(self, *a, **k):
            out = orig(self, *a, **k)
            calls["train_mbs"] += self.last_pack_stats["n_micro_batches"]
            return out
        return train_batch

    def on_forward(orig):
        @functools.wraps(orig)
        def forward(self, sample, mb_spec, *a, **k):
            calls["fwd_mbs"] += len(sample.split(mb_spec))
            return orig(self, sample, mb_spec, *a, **k)
        return forward

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)  # graded over HTTP
            in_process = MultiTaskRewardInterface(
                id2info=self.id2info, code_timeout_s=self.code_timeout_s)
            local = orig(in_process, model, sample, mb_spec)
            got, want = out.data["rewards"], local.data["rewards"]
            calls["graded"] += len(got)
            if not np.array_equal(got, want):
                calls["mismatch"].append((got.tolist(), want.tolist()))
            # A random model's answers all score -5: seeded +-5 instead,
            # so GRPO has advantages and the weights move.
            out.data["rewards"] = rng.choice([-5.0, 5.0], size=got.shape).astype(np.float32)
            return out
        return inference

    def on_set_params(orig):
        @functools.wraps(orig)
        def set_params(self, params):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            orig(self, params)
            calls["push_s"].append(time.monotonic() - t0)
        return set_params

    wrap(TrainEngine, "train_batch", on_train_batch)
    wrap(TrainEngine, "forward", on_forward)
    wrap(MultiTaskRewardInterface, "inference", on_reward)
    wrap(RemoteGeneratorEngine, "set_params", on_set_params)
    # The pushes' checkpoints go to this phase's work dir.
    wrap(tempfile, "tempdir", lambda _: work)
    tok = CharTokenizer(cfg.vocab_size)
    pcfg = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": data}),
        reward_interface_args={"dataset_path": data, "remote_url": vurl,
                               "code_timeout_s": 20.0},
        gconfig=GenerationHyperparameters(n=n, max_new_tokens=max_new),
        optimizer=OptimizerConfig(lr=2e-5),
        batch_size=n_prompts,
        ctrl=ExperimentSaveEvalControl(benchmark_steps=n_steps),
        seed=seed + 95,
        experiment_name="async",
        fileroot=os.path.join(work, "decoupled"),
        gen_server_url=server.url,
        inmem_weight_sync=True,
        max_head_offpolicyness=1,
        replay_capacity=4,
    )
    v0, steps0, replays0 = server.version, engine.steps_total, engine.resume_replays
    try:
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        master, stats = exps.run_experiment(exps.build_ppo_math(pcfg, tok), tokenizer=tok)
        torch.cuda.synchronize()
        trial_s = time.monotonic() - t
        launches = _trial_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
    remote = master.pool.workers[0].models["actor_gen@0"].engine
    inner = engine.steps_total - steps0
    replays = engine.resume_replays - replays0
    L = cfg.n_layers
    check(isinstance(remote, RemoteGeneratorEngine) and remote.inmem_sync,
          "(b) the trial's generator is not a RemoteGeneratorEngine with inmem sync")
    check(os.path.dirname(remote.sync_dir) == work, f"(b) pushes went to {remote.sync_dir}")
    check(len(stats) == n_steps, f"(b) {len(stats)} steps")
    for i, s in enumerate(stats):
        check(s["replay/staleness"] <= 1, f"(b) step {i + 1}: staleness {s['replay/staleness']}")
        check(s["replay/rejected"] == 0, f"(b) step {i + 1}: {s['replay/rejected']} rejected")
        check(math.isfinite(s["actor_train/behav_imp_weight"]),
              f"(b) step {i + 1}: behav_imp_weight {s['actor_train/behav_imp_weight']}")
        check(0.0 <= s["actor_train/behav_cap_clip"] <= 1.0,
              f"(b) step {i + 1}: behav_cap_clip {s['actor_train/behav_cap_clip']}")
        check(all(math.isfinite(x) for x in s.values()), f"(b) step {i + 1}: non-finite stats")
    check(stats[-1]["replay/staleness"] == 1 and stats[-1]["replay/accepted"] == n_steps,
          f"(b) last step: staleness {stats[-1]['replay/staleness']}, accepted "
          f"{stats[-1]['replay/accepted']}")
    check(remote.pushes == n_steps and server.version == v0 + remote.pushes == 1 + n_steps,
          f"(b) server version {server.version} after {remote.pushes} pushes from {v0}")
    want = dict(fwd=L * (2 * calls["train_mbs"] + calls["fwd_mbs"]), dq=L * calls["train_mbs"],
                dkv=L * calls["train_mbs"], k4=0, k2=L * inner, k3=L * replays)
    log(f"[async] (b) launches {launches}; from the engines {want} ({calls['train_mbs']} train "
        f"and {calls['fwd_mbs']} forward micro-batches; the server's {inner} inner steps and "
        f"{replays} resume replays)")
    check(launches == want, f"(b) launches {launches} != {want}")
    check(inner > 0 and launches["k2"] > 0, "(b) the server ran no inner step")
    check(not calls["mismatch"] and calls["graded"] == n_steps * n_prompts * n,
          f"(b) {calls['graded']} rewards graded; over HTTP against in-process: "
          f"{calls['mismatch'][:1]}")
    items = [{"task": "code", "text": text, "payload": {"input_output": ASYNC_CODE_IO,
                                                          "timeout_s": 20.0}}
             for text, _ in ASYNC_CODE_ITEMS]
    t = time.monotonic()
    remote_grades = reward_service.post_verify(vurl, items, timeout_s=120.0)
    code_s = time.monotonic() - t
    local_grades = [reward_service.grade_item(it) for it in items]
    check(remote_grades == local_grades == [ok for _, ok in ASYNC_CODE_ITEMS],
          f"(b) code grades over HTTP {remote_grades}, in-process {local_grades}")
    log(f"[async] (b) 4 steps in {trial_s:.1f} s: walls "
        f"{[round(s['time/step_s'], 3) for s in stats]} s; staleness "
        f"{[s['replay/staleness'] for s in stats]}; behav_imp_weight "
        f"{[round(s['actor_train/behav_imp_weight'], 5) for s in stats]}; behav_cap_clip "
        f"{[s['actor_train/behav_cap_clip'] for s in stats]}; disk pushes "
        f"{[round(x, 2) for x in calls['push_s']]} s; server version {server.version}; "
        f"{calls['graded']} rewards over HTTP equal in-process; code items {remote_grades} "
        f"in {code_s:.2f} s; peak {peak / 2**30:.2f} GiB")
    _rmtree(remote.sync_dir)
    del master, remote
    return dict(step_s=[s["time/step_s"] for s in stats], trial_s=trial_s,
                staleness=[s["replay/staleness"] for s in stats], push_s=calls["push_s"],
                launches=launches, inner_steps=inner, resume_replays=replays, peak_bytes=peak)


def _rmtree(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def _async_controller(seed, cfg, data, work, server):
    """(c): the rollout controller over the server, three disk pushes."""
    import asyncio

    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput, GenerationHyperparameters, LLMAPIClient,
    )
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import RemoteGeneratorEngine
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController

    n_prompts, n, max_new, n_pushes = 32, 4, 128, 3
    engine = server.engine
    tok = CharTokenizer(cfg.vocab_size)
    with open(data) as f:
        rows = [json.loads(line) for line in f]
    prompts = [(f"c-{r['query_id']}", tok.encode(r["prompt"])) for r in rows[:n_prompts]]
    replay = ReplayBuffer(capacity=8, max_head_offpolicyness=1)
    replay.set_version(server.version)
    remote = RemoteGeneratorEngine(cfg, server.url, sync_dir=os.path.join(work, "sync_c"),
                                   inmem_sync=True)
    client = remote.clients[0]
    probe = LLMAPIClient(server.url)
    waits = []
    real_pause = client.pause

    def pause():
        # Pause while rows decode, so the push parks a request mid-flight
        # (no wait once every prompt has been answered).
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 60 and probe.health()["live_slots"] == 0
               and (ctl.cursor < n_prompts or ctl.stat.in_flight > 0)):
            time.sleep(0.01)
        waits.append(time.monotonic() - t0)
        return real_pause()

    client.pause = pause
    ctl = RolloutController([LLMAPIClient(server.url)], replay,
                            GenerationHyperparameters(n=n, max_new_tokens=max_new),
                            seed=seed + 96, dispatch_timeout_s=600.0)
    pushed = {}
    steps0, replays0 = engine.steps_total, engine.resume_replays
    consumed = []

    def push_all():
        for i in range(n_pushes):
            # Push i after 6 x i groups are consumed: pushes a wave of
            # groups apart, so a request rarely spans two of them.
            t0 = time.monotonic()
            while len(consumed) < 6 * i and time.monotonic() - t0 < 300:
                time.sleep(0.05)
            params = init_params(cfg, seed + 97 + i, device="cuda")
            t0 = time.monotonic()
            remote.set_params(params)
            pushed.setdefault("s", []).append(time.monotonic() - t0)
            replay.set_version(server.version)
            if i == n_pushes - 1:
                pushed["params"] = params  # the weights greedy parity runs on
            del params

    async def drive():
        pump = asyncio.create_task(ctl.run(prompts))
        pusher = asyncio.create_task(asyncio.to_thread(push_all))
        while not (pump.done() and pusher.done() and len(replay) == 0):
            try:
                got = await asyncio.to_thread(replay.get_batch, 1, 0.2)
            except TimeoutError:
                continue
            consumed.extend((t.qid, t.version_start, t.version_end, t.retired_version)
                            for t in got)
        await pump
        await pusher

    torch.cuda.synchronize()
    _reset_counts()
    t = time.monotonic()
    asyncio.run(drive())
    torch.cuda.synchronize()
    pump_s = time.monotonic() - t
    launches = _trial_counts()
    inner = engine.steps_total - steps0
    replays = engine.resume_replays - replays0
    stat = ctl.stat.as_dict()
    parked = [c for c in consumed if c[1] < c[2]]
    log(f"[async] (c) {n_prompts} prompts through the controller in {pump_s:.1f} s with "
        f"{n_pushes} disk pushes ({[round(x, 2) for x in pushed['s']]} s; pause waited "
        f"{[round(x, 2) for x in waits]} s for live rows): stat {stat}; consumed {len(consumed)}, "
        f"staleness at consumption {sorted({r - v0 for _, v0, _, r in consumed})}, "
        f"{len(parked)} parked and resumed across a push; replay {replay.watermarks()}; server "
        f"{inner} inner steps, {replays} resume replays; launches {launches}")
    check(stat["failed"] == 0 and stat["accepted"] + stat["rejected"] == n_prompts,
          f"(c) controller stat {stat}")
    check(len(consumed) == stat["accepted"] - replay.dropped_stale - replay.evicted,
          f"(c) consumed {len(consumed)} of {stat['accepted']} accepted")
    check(all(r - v0 <= 1 for _, v0, _, r in consumed), "(c) a consumed group past the bound")
    check(parked, "(c) no request was parked and resumed across a push")
    check(server.version == 1 + 4 + n_pushes, f"(c) server version {server.version}")
    check(launches["k2"] == cfg.n_layers * inner and launches["k3"] == cfg.n_layers * replays
          and replays >= 1, f"(c) launches {launches}: K2 != {cfg.n_layers} x {inner} or K3 != "
          f"{cfg.n_layers} x {replays}")
    # Greedy tokens under the last pushed version: the server against an
    # in-process engine of the same options on the same weights, one
    # request at a time (the same shapes on both).
    local = _async_server_engine(cfg, pushed.pop("params"))
    g = GenerationHyperparameters(n=1, max_new_tokens=32, greedy=True)
    fresh = np.random.default_rng(seed + 98)
    equal = []
    for i in range(2):
        ids = fresh.integers(0, cfg.vocab_size, int(fresh.integers(64, 257))).tolist()
        out = probe.generate(APIGenerateInput(qid=f"greedy{i}", prompt_ids=ids, gconfig=g))
        check(out.version_start == out.version == server.version,
              f"(c) greedy request on version {out.version_start}->{out.version}")
        sample = SequenceSample(keys={"packed_prompts"}, ids=["g"],
                                seqlens={"packed_prompts": [[len(ids)]]},
                                data={"packed_prompts": np.asarray(ids, np.int32)})
        mine = local.generate(sample, MicroBatchSpec(), g, seed=0)
        want = np.asarray(mine.data["packed_input_ids"])[len(ids):].tolist()
        equal.append(out.output_ids[0] == want)
        check(equal[-1], f"(c) greedy tokens under version {out.version}: server "
              f"{out.output_ids[0][:12]}... != in-process {want[:12]}...")
    log(f"[async] (c) greedy tokens under version {server.version}: the server equals an "
        f"in-process engine on the pushed weights ({len(equal)} requests of 32 tokens)")
    del local
    _rmtree(remote.sync_dir)
    return dict(pump_s=pump_s, push_s=pushed["s"], stat=stat, consumed=len(consumed),
                parked=len(parked), launches=launches, inner_steps=inner,
                resume_replays=replays)


# --------------------------------------------------------------------------
# Phase: agent episodes at full size
# --------------------------------------------------------------------------

EP_SLOTS = 16  # the engine's max_decode_batch: the episode session's slots
EP_MAX_NEW = 32  # new tokens an assistant turn, so a chunk is 32 inner steps
EP_BUDGET = 2048  # transcript tokens an episode
EP_TURNS = 3  # assistant turns an episode (the controller's max_turns)
EP_EOS = 151643
# Episodes of the int8 pool's run (8 before the async phase came: each
# episode's turns wait on one engine lock, so 4 take about half the time).
EP_INT8_EPISODES = 4
# Turns 1-2 of each calculator episode against the one-token probes of
# the same steps on an engine of the same geometry: the same kernels on
# the same inputs, so equal to fp32 rounding; a read of a poisoned
# position (1e9) would move a logprob by orders of magnitude more.
PROBE_LOGP_TOL = 1e-5


def _ep_parse(toks):
    """The agents leg's token-level tool-call convention
    (scripts/check_async.py:2688): a stop turn calls the calculator on
    operands read off its last tokens."""
    from areal_tpu_torch.system.episode import ToolCall

    a, b = (list(toks) * 2)[-2:]
    return ToolCall("calculator", f"{a % 9} + {b % 9}")


def _ep_encode(call, text, ok):
    """Observation tokens: the result's characters, at most 6."""
    return [8 + (ord(c) % 16) for c in text][:6] or [8]


class _TurnLog:
    """An episode client that records each raw turn dict and its HTTP
    latency (the controller's Turn records carry neither)."""

    def __init__(self, inner):
        self.inner, self.outs, self.lat = inner, [], []

    def version(self):
        return self.inner.version()

    def _rec(self, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        self.lat.append(time.monotonic() - t0)
        self.outs.append(dict(out))
        return out

    def start(self, ep_id, ids):
        return self._rec(self.inner.start, ep_id, ids)

    def extend(self, ep_id, ids):
        return self._rec(self.inner.extend, ep_id, ids)

    def release(self, ep_id):
        self.inner.release(ep_id)


def _ep_stops(tag, cfg, params, prompts, ekw):
    """A small stop set under which each calculator episode's first two
    assistant turns end at their first token: the greedy token after each
    prompt (A) and after prompt + A + A's observation (B).  Read by
    episodes of one-token turns on an engine of the episodes' geometry (16
    slots, W=8, the same pool, lane budget and token budget) without
    prefix sharing: a turn's inner steps do not depend on where its chunks
    end, so A and B are the tokens the episodes sample."""
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.episode import ToolExecutor

    t0 = time.monotonic()
    eng = GeneratorEngine(cfg, params, eos_token_id=EP_EOS, max_decode_batch=EP_SLOTS,
                          kv_share_prefix=False, **ekw)
    g = GenerationHyperparameters(n=1, max_new_tokens=1, greedy=True)
    tools = ToolExecutor(register_builtins=True)
    probes = []  # per prompt: (A, its logprob, B, its logprob)
    for i, p in enumerate(prompts):
        a = eng.episode_start(f"cal{i}", p, g, token_budget=EP_BUDGET)
        call = _ep_parse(a["tokens"])
        b = eng.episode_extend(f"cal{i}", _ep_encode(call, tools.run(call), True))
        eng.episode_release(f"cal{i}")
        probes.append((a["tokens"][0], a["logprobs"][0], b["tokens"][0], b["logprobs"][0]))
    del eng
    gc.collect()
    toks = sorted({t for a, _, b, _ in probes for t in (a, b)})
    log(f"[episodes] {tag}: stop set of {len(toks)} single tokens from one-token probe "
        f"turns ({time.monotonic() - t0:.1f} s)")
    return tuple((t,) for t in toks), probes


def _ep_poison_hook(engine, rec):
    """After every turn's rewind, poison the slot's positions at and past
    its cursor on its mapped pages (bf16: 1e9; int8: code 127 at scale
    1e9, as the kernel phase poisons): the next admission teacher-forces
    over them and no read may reach the rest."""
    import torch

    real = engine._finish_episode_turn

    def finish(st, ep, reason):
        out = real(st, ep, reason)
        s, alloc, pool = ep.slot, st.alloc, st.pool
        ps, lo = alloc.page_size, int(st.cache_len[s])
        huge = 127 if pool.k.dtype == torch.int8 else 1e9
        for j in range(lo // ps, int(alloc.used[s])):
            page, off = int(alloc.table[s, j]), max(lo - j * ps, 0)
            if int(alloc.refcount[page]) != 1:  # shared pages are read-only
                continue
            pool.k[:, page, off:] = huge
            pool.v[:, page, off:] = huge
            if pool.k_scale is not None:
                pool.k_scale[:, page, off:] = 1e9
                pool.v_scale[:, page, off:] = 1e9
            rec["poisoned"] += ps - off
        return out

    engine._finish_episode_turn = finish


def _ep_chunk_hook(engine, rec):
    """Wrap the engine's serving chunk: CUDA events around every chunk,
    the session's second chunk under set_sync_debug_mode("error"), and,
    once `rec["hold"]` is set, the next chunk held after it runs until a
    push has asked the engine to park (so the push lands mid-turn)."""
    import torch

    real = engine._episode_chunk_fn

    def chunk_fn(st, g):
        fn = real(st, g)

        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            sync_hold = len(rec["events"]) == 1
            if sync_hold:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            ev[0].record()
            try:
                out = fn(*a, **k)
            except RuntimeError as e:
                if sync_hold:
                    rec["sync_error"] = repr(e)
                raise
            finally:
                if sync_hold:
                    torch.cuda.set_sync_debug_mode(0)
            ev[1].record()
            if sync_hold:
                rec["sync_ok"] = True
            rec["events"].append(ev)
            if rec.get("hold") and not rec["in_turn"].is_set():
                rec["in_turn"].set()
                deadline = time.monotonic() + 120
                while not engine.interrupt_requested and time.monotonic() < deadline:
                    time.sleep(0.005)
            return out

        return run

    engine._episode_chunk_fn = chunk_fn


def _ep_calc(tag, url, prompts, stops, probes):
    """(a): one calculator episode a prompt, each on its own client thread
    through the port's LLMAPIClient (ServerEpisodeClient), max_turns 3.
    Checked: every episode ends with at least 2 assistant turns ending in
    a stop, and those two turns are the probe's tokens with its logprobs
    (within PROBE_LOGP_TOL: the same steps over a pool whose positions
    past each rewound cursor are poisoned), turn 2 on prefills exactly its
    observation, every transcript_len adds up, every turn ran on
    version 0."""
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, LLMAPIClient
    from areal_tpu_torch.system.episode import (
        EpisodeController, ServerEpisodeClient, ToolExecutor,
    )

    g = GenerationHyperparameters(n=1, max_new_tokens=EP_MAX_NEW, greedy=True, stop=stops)
    tools = ToolExecutor(timeout_s=10.0)
    logs = [_TurnLog(ServerEpisodeClient(LLMAPIClient(url), g, token_budget=EP_BUDGET))
            for _ in prompts]
    eps, errors = [None] * len(prompts), []
    start = threading.Barrier(len(prompts))

    def run(i):
        start.wait(timeout=60.0)
        try:
            ctl = EpisodeController(logs[i], tools, _ep_parse, _ep_encode, max_turns=EP_TURNS)
            eps[i] = ctl.run_episode(f"{tag}-{i}", prompts[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{tag}-{i}: {e!r}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600.0)
    wall = time.monotonic() - t0
    check(not errors and all(ep is not None for ep in eps), f"[episodes] {tag}: {errors}")
    n_tok = obs_prefill = transcript_tokens = 0
    stop_turns, probe_err = [], 0.0
    for i, (ep, lg) in enumerate(zip(eps, logs)):
        a_turns = [t for t in ep.turns if t.role == "assistant"]
        stop_turns.append(sum(t.stop_reason == "stop" for t in a_turns))
        for k, (tok, lp) in enumerate((probes[i][:2], probes[i][2:])):
            turn = a_turns[k]
            check(turn.tokens == [tok] and turn.stop_reason == "stop",
                  f"[episodes] {tag}-{i} turn {k}: {turn.tokens[:4]} ({turn.stop_reason}), "
                  f"the probe read [{tok}]")
            probe_err = max(probe_err, abs(turn.logprobs[0] - lp))
        check(ep.status == "done" and len(lg.outs) == len(a_turns) and ep.slot_lost == 0,
              f"[episodes] {tag}-{i}: {ep.status}, {len(lg.outs)} turns logged")
        check(stop_turns[-1] >= 2, f"[episodes] {tag}-{i}: {stop_turns[-1]} stop turns "
              f"({[t.stop_reason for t in a_turns]})")
        length = len(prompts[i])
        for k, out in enumerate(lg.outs):
            turn = a_turns[k]
            if k > 0:
                obs = ep.turns[2 * k - 1].tokens
                check(out["prefill_tokens"] == len(obs), f"[episodes] {tag}-{i} turn {k}: "
                      f"prefilled {out['prefill_tokens']} for a {len(obs)}-token observation")
                length += len(obs)
                obs_prefill += out["prefill_tokens"]
            length += len(turn.tokens)
            check(out["transcript_len"] == length, f"[episodes] {tag}-{i} turn {k}: "
                  f"transcript_len {out['transcript_len']} != {length}")
            check(out["version"] == out["version_start"] == 0, f"[episodes] {tag}-{i}: version")
            check(len(turn.logprobs) == len(turn.tokens)
                  and all(math.isfinite(x) and x <= 1e-6 for x in turn.logprobs),
                  f"[episodes] {tag}-{i} turn {k}: bad logprobs")
            check(all(0 <= t < 151936 for t in turn.tokens), f"[episodes] {tag}-{i}: bad id")
            n_tok += len(turn.tokens)
        check(ep.transcript() == prompts[i] + ep.response_text_tokens(), f"[episodes] {tag}-{i}")
        transcript_tokens += len(ep.transcript())
    check(probe_err <= PROBE_LOGP_TOL, f"[episodes] {tag}: turns 1-2 logprobs {probe_err:.3e} "
          f"from the probe's")
    lat = sorted(x for lg in logs for x in lg.lat)
    out = dict(
        episodes=len(eps), turns=len(lat), stop_turns=stop_turns, probe_logp_err=probe_err,
        stop_reasons=[ep.stop_reason for ep in eps], tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, turn_p50_s=lat[len(lat) // 2],
        turn_p90_s=lat[min(len(lat) - 1, math.ceil(0.9 * len(lat)) - 1)],
        obs_prefill_tokens=obs_prefill, transcript_tokens=transcript_tokens,
        transcripts={ep.episode_id: ep.transcript() for ep in eps},
    )
    log(f"[episodes] {tag}: {len(eps)} calculator episodes on {len(eps)} client threads: "
        f"{len(lat)} assistant turns ({sum(stop_turns)} ending in a stop; per episode "
        f"{stop_turns}), {n_tok} tokens in {wall:.2f} s = {out['tokens_per_s']:.1f} tok/s; turn "
        f"latency p50 {out['turn_p50_s']:.3f} s, p90 {out['turn_p90_s']:.3f} s; observation "
        f"prefill {obs_prefill} tokens against {transcript_tokens} transcript tokens; turns 1-2 "
        f"equal the probe's tokens, logprobs within {probe_err:.3e}")
    return out


def _ep_push(tag, engine, server, rec, cfg, seed):
    """(e): a mid-turn in-memory push.  An episode whose first turn needs
    several chunks (a 400-token prompt, no stop) is held after its first
    chunk; update_weights_inmem(init_params(seed + 1)) then parks the
    turn, swaps the weights and resumes it: episode_resume replays the
    slot's last chunk tail (K3) and the turn ends under version 1."""
    import numpy as np

    from areal_tpu_torch.api.model_api import GenerationHyperparameters, LLMAPIClient
    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.models.transformer import init_params

    rng = np.random.default_rng(seed + 71)
    prompt = rng.integers(0, cfg.vocab_size, 400).tolist()
    g = GenerationHyperparameters(n=1, max_new_tokens=EP_MAX_NEW, greedy=True)
    new = init_params(cfg, seed + 1, device="cuda")
    checksum = integrity.params_checksum(new)
    replays0 = engine.resume_replays
    box = {}
    rec["hold"] = True

    def run():
        try:
            box["turn"] = LLMAPIClient(server.url).episode_start(
                f"{tag}-push", prompt, g, token_budget=EP_BUDGET)
        except Exception as e:  # noqa: BLE001 — reported below
            box["error"] = repr(e)

    th = threading.Thread(target=run)
    th.start()
    check(rec["in_turn"].wait(timeout=300), f"[episodes] {tag}: the push episode never ran")
    t0 = time.monotonic()
    version = server.update_weights_inmem(new, checksum=checksum)
    push_s = time.monotonic() - t0
    th.join(timeout=300.0)
    rec["hold"] = False
    del new
    check(not th.is_alive() and "error" not in box, f"[episodes] {tag}: push episode {box}")
    turn = box["turn"]
    replays = engine.resume_replays - replays0
    log(f"[episodes] {tag}: push mid-turn took {push_s:.3f} s -> version {version}; the turn "
        f"resumed with {replays} replay(s) and ended '{turn['stop_reason']}' with "
        f"{len(turn['tokens'])} tokens, versions {turn['version_start']} -> {turn['version']}")
    check(version == 1 and (turn["version_start"], turn["version"]) == (0, 1),
          f"[episodes] {tag}: the turn did not span the push: {turn['version_start']}, "
          f"{turn['version']}")
    check(replays == 1, f"[episodes] {tag}: {replays} replays")
    check(engine.episode_stats()["parked_mid_turn"] == 0 and not engine.interrupt_requested,
          f"[episodes] {tag}: left parked")
    check(len(turn["tokens"]) == EP_MAX_NEW and turn["transcript_len"] == 400 + EP_MAX_NEW,
          f"[episodes] {tag}: push turn {len(turn['tokens'])} tokens")
    return dict(push_s=push_s, replays=replays)


def _ep_engine_run(tag, cfg, params, prompts, seed, stops, probes, ekw, extra=None):
    """One engine of the episodes phase: (a) the calculator episodes, the
    caller's `extra` steps, then (e) the push; the launch counts are set
    to 0 just before and read just after, and held to the engine's own
    inner steps (K2) and replays (K3)."""
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.gen_server import GenerationServer

    engine = GeneratorEngine(cfg, params, eos_token_id=EP_EOS, max_decode_batch=EP_SLOTS, **ekw)
    check(engine.device.type == "cuda", "[episodes] the engine is not on the card")
    rec = {"events": [], "in_turn": threading.Event(), "poisoned": 0}
    _ep_chunk_hook(engine, rec)
    _ep_poison_hook(engine, rec)
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=2.0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0, replays0 = engine.steps_total, engine.resume_replays
        _reset_counts()
        out = _ep_calc(tag, server.url, prompts, stops, probes)
        if extra is not None:
            out.update(extra(engine, server, out))
        out.update(_ep_push(tag, engine, server, rec, cfg, seed))
        torch.cuda.synchronize()
        counts = _trial_counts()
        steps = engine.steps_total - steps0
        replays = engine.resume_replays - replays0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.close()
    L = cfg.n_layers
    want = dict(fwd=0, dq=0, dkv=0, k2=L * steps, k3=L * replays, k4=0)
    chunk_ms = sum(a.elapsed_time(b) for a, b in rec["events"])
    st = engine._ep_session
    out.update(inner_steps=steps, resume_replays=replays, launches=counts, peak_mem_bytes=peak,
               chunks=len(rec["events"]), decode_step_ms=chunk_ms / max(steps, 1),
               chunk_builds=engine.decode_compiles, stats=engine.episode_stats(),
               poisoned_positions=rec["poisoned"])
    log(f"[episodes] {tag}: {steps} inner steps in {len(rec['events'])} chunks, "
        f"{out['decode_step_ms']:.3f} ms a step (CUDA events around each chunk); "
        f"{rec['poisoned']} positions past rewound cursors poisoned; chunk builds "
        f"{engine.decode_compiles}; resume_replays {replays}; launches {counts}; stats "
        f"{out['stats']}; peak mem {peak / 2**30:.2f} GiB")
    check(counts == want, f"[episodes] {tag}: launches {counts} != {want}")
    check(replays >= 1 and counts["k3"] > 0, f"[episodes] {tag}: no K3 replay")
    check(engine.decode_compiles == 1 and len(st.chunk_fns) == 1,
          f"[episodes] {tag}: the serving chunk was built {engine.decode_compiles} times")
    check(rec.get("sync_ok") and "sync_error" not in rec,
          f"[episodes] {tag}: a chunk synchronised with the host: {rec.get('sync_error')}")
    check(engine.dead_live_lanes == 0, f"[episodes] {tag}: dead live lanes")
    log(f"[episodes] {tag}: chunk 2 of {len(rec['events'])} ran under "
        f"set_sync_debug_mode('error'): no host sync")
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ep_tools_and_readmit(engine, server, calc, py_prompt, stops):
    """(b) python_exec once, in a two-turn episode whose first turn ends
    on the stop set (its prompt was probed with the others); (c) a
    re-admission after SlotGone: an (a) episode, already released, is
    extended (typed 409, the slot-lost counter up by one), then started
    again with its full transcript: it maps its published pages and
    prefills the tail."""
    from areal_tpu_torch.api.model_api import (
        GenerationHyperparameters, LLMAPIClient, SlotGoneError,
    )
    from areal_tpu_torch.base import metrics
    from areal_tpu_torch.system.episode import (
        EpisodeController, ServerEpisodeClient, ToolCall, ToolExecutor,
    )

    api = LLMAPIClient(server.url)
    g = GenerationHyperparameters(n=1, max_new_tokens=EP_MAX_NEW, greedy=True)
    seen = {}

    def parse_py(toks):
        a, b = (list(toks) * 2)[-2:]
        seen["want"] = str(a % 9 + b % 9)
        return ToolCall("python_exec", f"print({a % 9} + {b % 9})")

    def encode(call, text, ok):
        seen.update(text=text, ok=ok)
        return _ep_encode(call, text.strip(), ok)

    tools = ToolExecutor(timeout_s=10.0)
    ep = EpisodeController(ServerEpisodeClient(api, g.new(stop=stops), token_budget=EP_BUDGET),
                           tools, parse_py, encode, max_turns=2)
    t0 = time.monotonic()
    episode = ep.run_episode("py-0", py_prompt)
    py_s = time.monotonic() - t0
    tool_turns = [t for t in episode.turns if t.role == "tool"]
    check(len(tool_turns) == 1 and tool_turns[0].tool_name == "python_exec",
          f"[episodes] (b) py-0 ran no python_exec turn: {[t.role for t in episode.turns]}")
    t = tool_turns[0]
    log(f"[episodes] (b) python_exec in episode py-0: ok={t.tool_ok} in "
        f"{t.tool_latency_s:.3f} s, output {seen['text'][:80]!r} (want {seen['want']}); "
        f"episode ended '{episode.stop_reason}'")
    check(t.tool_latency_s < 12.0, "[episodes] (b) python_exec did not finish within its timeout")
    check((t.tool_ok and seen["text"].strip() == seen["want"])
          or (not t.tool_ok and seen["text"].startswith("tool error (")),
          f"[episodes] (b) python_exec: {seen}")
    counter = metrics.default_registry().get("areal_gen_episode_slot_lost_total")
    lost0 = counter.get()
    transcript = calc["transcripts"]["calc-0"]
    try:
        api.episode_extend("calc-0", [9])
        gone = False
    except SlotGoneError:
        gone = True
    check(gone and counter.get() == lost0 + 1,
          f"[episodes] (c) extend after release: typed={gone}, counter {lost0} -> {counter.get()}")
    turn = api.episode_start("calc-0", transcript, g, token_budget=EP_BUDGET)
    shared = turn["shared_prefix_tokens"]
    api.episode_release("calc-0")
    log(f"[episodes] (c) SlotGone (HTTP 409) on calc-0, then its {len(transcript)}-token "
        f"transcript re-admitted: {shared} tokens mapped from the prefix cache, "
        f"{turn['prefill_tokens']} prefilled")
    check(shared > 0 and turn["prefill_tokens"] == len(transcript) - shared,
          f"[episodes] (c) re-admission: shared {shared}, prefilled {turn['prefill_tokens']}")
    return dict(python_exec_s=py_s, readmit_shared=shared,
                readmit_prefill=turn["prefill_tokens"], readmit_transcript=len(transcript))


def _ep_eviction(cfg, params, seed):
    """(d): LRU eviction under a tight pool (kv_pool_pages=7 of 128
    tokens; three 300-token episodes need 3 pages each).  The third start
    evicts the least recently admitted parked episode, whose extend then
    gets the typed SlotGone; its re-admission evicts the next."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.model_api import (
        GenerationHyperparameters, LLMAPIClient, SlotGoneError,
    )
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.gen_server import GenerationServer

    rng = np.random.default_rng(seed + 83)
    prompts = [rng.integers(0, cfg.vocab_size, 300).tolist() for _ in range(3)]
    engine = GeneratorEngine(cfg, params, eos_token_id=EP_EOS, max_decode_batch=EP_SLOTS,
                             kv_pool_pages=7)
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=2.0)
    g = GenerationHyperparameters(n=1, max_new_tokens=EP_MAX_NEW, greedy=True)
    try:
        api = LLMAPIClient(server.url)
        t0 = time.monotonic()
        steps0 = engine.steps_total
        _reset_counts()
        turns = [api.episode_start(f"ev-{i}", p, g, token_budget=EP_BUDGET)
                 for i, p in enumerate(prompts)]
        after_three = engine.episode_stats()
        try:
            api.episode_extend("ev-0", [9])
            gone = False
        except SlotGoneError:
            gone = True
        again = api.episode_start("ev-0", prompts[0] + turns[0]["tokens"] + [9], g,
                                  token_budget=EP_BUDGET)
        torch.cuda.synchronize()
        counts, steps = _trial_counts(), engine.steps_total - steps0
        secs = time.monotonic() - t0
        final = engine.episode_stats()
    finally:
        server.close()
    log(f"[episodes] (d) pool of 7 pages: after three starts {after_three}; ev-0 extend typed "
        f"SlotGone={gone}; its re-admission prefilled {again['prefill_tokens']} tokens; final "
        f"{final}; {steps} inner steps, launches {counts}; {secs:.1f} s")
    L = cfg.n_layers
    check(after_three["evicted"] == 1 and gone, f"[episodes] (d) eviction: {after_three}, {gone}")
    check(final["evicted"] == 2 and final["active"] == 2, f"[episodes] (d) final {final}")
    check(counts == dict(fwd=0, dq=0, dkv=0, k2=L * steps, k3=0, k4=0),
          f"[episodes] (d) launches {counts}")
    check(engine.decode_compiles == 1, "[episodes] (d) chunk builds")
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stats=final, inner_steps=steps, launches=counts, seconds=secs)


def phase_episodes(report, seed):
    """Agent episodes at qwen2-1.5B's full width (CUT_LAYERS layers, bf16, random weights
    from --seed) through GenerationServer's POST /episode and the port's
    LLMAPIClient: (a) 8 calculator episodes (the serve burst's first 8
    prompts, 64-512 tokens; max_turns 3, 32 new tokens a turn, a 2048-token
    budget, observations of at most 6 tokens), each on its own client
    thread; (b) python_exec once; (c) a SlotGone re-admission that maps
    the published prefix; (d) LRU eviction under a tight pool; (e) a
    mid-turn in-memory push (park, swap, episode_resume's K3 replay); (f)
    (a) with its first EP_INT8_EPISODES episodes and (e) again over an
    int8 pool.  Checked: replies and turn
    accounting, at least 2 stop turns an episode, launches K2 = layers x
    inner steps and K3 = layers x replays (>= 1 in (e) and (f)), K1f and K4
    0, one chunk build, no host sync in a chunk."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    rng = np.random.default_rng(seed)
    prompts = [  # the serve phase's prompts, its first 8 of 16
        rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        for _ in range(16)
    ][:8]
    t_phase = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    runs = {}
    py_prompt = np.random.default_rng(seed + 79).integers(0, cfg.vocab_size, 120).tolist()
    for tag, ekw in (("calc", {}), ("calc_int8", dict(kv_cache_dtype="int8"))):
        if tag == "calc":
            stops, probes = _ep_stops(tag, cfg, params, prompts + [py_prompt], ekw)

            def extra(engine, server, calc, stops=stops):
                return _ep_tools_and_readmit(engine, server, calc, py_prompt, stops)
        else:
            # The int8 pool's run takes the first EP_INT8_EPISODES episodes.
            sub = prompts[:EP_INT8_EPISODES]
            (stops, probes), extra = _ep_stops(tag, cfg, params, sub, ekw), None
        runs[tag] = _ep_engine_run(tag, cfg, params, prompts if tag == "calc" else sub, seed,
                                   stops, probes, ekw, extra=extra)
        runs[tag].pop("transcripts")
        if tag == "calc":
            runs["evict"] = _ep_eviction(cfg, params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["calc"]["launches"]}
    secs = time.monotonic() - t_phase
    log(f"[episodes] launches over the phase {launches}; {secs:.1f} s")
    report["episodes"] = dict(runs=runs, launches=launches, seconds=secs)


def _flat_params(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_params(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _worst(vals):
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


# --------------------------------------------------------------------------
# multiproc: the multi-process runtime, a generate/train split on one card
# --------------------------------------------------------------------------

MULTIPROC_DIR = os.path.join(REPO, ".multiproc_tmp")
MULTIPROC_NEW_TOKENS = 64
MULTIPROC_PLACEMENT = {"actor_gen": 1, "reward": 1}


def _multiproc_plan(cfg, ckpt, data, work, seed, trial, ckpt_freq=None):
    """The quickstart's ppo-math trial (a ref, kl_ctl 0.1, 8 prompts x 4,
    the seeded null reward) over two workers: the actor and the ref on
    worker 0, the generator and the reward on worker 1."""
    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    pc = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        ref=ModelAbstraction("hf", {"path": ckpt}),
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": data}),
        reward_interface=ModelInterfaceAbstraction("null", {"seed": seed + 52}),
        ppo_kwargs={"kl_ctl": 0.1},
        optimizer=OptimizerConfig(lr=2e-5),
        gconfig=GenerationHyperparameters(n=4, max_new_tokens=MULTIPROC_NEW_TOKENS),
        batch_size=8, total_train_epochs=1,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=16384),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2, ckpt_freq_steps=ckpt_freq),
        seed=seed + 53, experiment_name="multiproc", trial_name=trial,
        fileroot=os.path.join(work, trial), placement=dict(MULTIPROC_PLACEMENT),
    )
    plan = exps.build_ppo_math(pc)
    for wc in plan.worker_configs:
        wc.tokenizer_path = f"char:{cfg.vocab_size}"
    return plan


def _timeless(stats):
    """A step's stats without its wall times and per-process memory."""
    return {k: v for k, v in stats.items()
            if "/perf/" not in k and "time" not in k and not k.endswith("_s")}


def _param_push_lines(paths):
    """The PARAM_PUSH records the workers logged, in order."""
    out = []
    for path in paths:
        with open(path) as f:
            for line in f:
                if "PARAM_PUSH " in line:
                    out.append(json.loads(line.split("PARAM_PUSH ", 1)[1]))
    return out


def _log_pushes(tag, pushes):
    for p in pushes:
        if p["side"] == "send":
            log(f"[multiproc] {tag} param push send: {p['bytes'] / 1e9:.3f} GB, gather "
                f"{p['gather_s']:.3f} s, checksum {p['checksum_s']:.3f} s, encode "
                f"{p['encode_s']:.3f} s, wire {p['wire_s']:.3f} s"
                + (" (cached encoding)" if p["cached"] else ""))
        else:
            log(f"[multiproc] {tag} param push recv: wait {p['wait_s']:.3f} s, verify "
                f"{p['verify_s']:.3f} s, load {p['load_s']:.3f} s")


def _worker_stats(plan, seen):
    """on_finish of a multi-process trial: each worker's runtime_stats
    (pid, device, launches, peak memory) and the card's compute
    processes, asked while the workers still serve."""
    from areal_tpu_torch.system.worker_control import WorkerControlPanel

    def on_finish(master):
        panel = WorkerControlPanel(plan.experiment_name, plan.trial_name)
        names = [f"model_worker/{i}" for i in range(len(plan.worker_configs))]
        try:
            panel.connect(names, timeout=30)
            seen["workers"] = panel.group_request("runtime_stats", timeout=60)
        finally:
            panel.close()
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        seen["smi"] = r.stdout.strip()
        seen["restore_s"] = master.restore_seconds
    return on_finish


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _counter(name):
    """A series of this process's default registry (0 when unregistered)."""
    from areal_tpu_torch.base import metrics

    m = metrics.default_registry().get(name)
    return m.get() if m is not None else 0.0


def _metrics_plane(plan, seen):
    """(d), in on_finish while the workers still serve: `python -m
    areal_tpu_torch.apps.metrics_report --json` over the trial's announced
    roles (two scrapes, a CRIT rule that holds), and one in-process scrape
    of the same endpoints for the labelled series the JSON does not
    carry; checked after the trial by `_check_metrics_plane`."""
    from areal_tpu_torch.apps import metrics_report as mr

    E, T = plan.experiment_name, plan.trial_name

    def on_finish(master):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, "-m", "areal_tpu_torch.apps.metrics_report",
                            "--experiment", E, "--trial", T, "--count", "2", "--interval", "0.5",
                            "--json", "--slo", "crit: version_skew <= 0"],
                           capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
        seen["report_s"] = time.monotonic() - t0
        seen["rc"], seen["stderr"] = r.returncode, r.stderr[-3000:]
        seen["lines"] = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
        seen["scrape"] = {x.role: x for x in mr.scrape_fleet(mr.discover(E, T))}
        seen["stats"] = list(master.stats_history)
    return on_finish


def _check_metrics_plane(tag, seen, steps_before, want_ckpt):
    """The metrics report saw exactly the trial's three roles, exited 0,
    and its numbers are the trial's: the master's step count, each
    worker's MFC calls, each MFC's MFU equal to the last step's
    ``<mfc>/perf/mfu`` stat, in (0, 1]."""
    check(seen["rc"] == 0, f"{tag} metrics_report exited {seen['rc']}: {seen['stderr']}")
    lines = seen["lines"]
    check(len(lines) == 2, f"{tag} metrics_report printed {len(lines)} JSON lines")
    last = lines[-1]
    roles = [row["role"] for row in last["roles"]]
    check(roles == ["master", "model_worker/0", "model_worker/1"]
          and all(row["ok"] for row in last["roles"]), f"{tag} metrics roles {last['roles']}")
    check(not last["violations"], f"{tag} violations {last['violations']}")
    sig = last["signals"]
    stats = seen["stats"]
    if steps_before is not None:
        check(sig.get("areal_master_steps_total") == steps_before + len(stats),
              f"{tag} areal_master_steps_total {sig.get('areal_master_steps_total')} != "
              f"{steps_before} + {len(stats)} steps")
    for w in ("model_worker/0", "model_worker/1"):
        calls = {lb["mfc"]: v for n, lb, v in seen["scrape"][w].samples
                 if n == "areal_worker_mfc_seconds_count"}
        check(calls and all(v == len(stats) for v in calls.values()),
              f"{tag} {w}'s MFC calls {calls}, want {len(stats)} each")
        log(f"[multiproc] {tag} {w}: MFC calls {calls}")
    want = {k[:-len("/perf/mfu")]: v for k, v in stats[-1].items() if k.endswith("/perf/mfu")}
    mfus = {lb["mfc"]: v for n, lb, v in seen["scrape"]["master"].samples
            if n == "areal_mfc_mfu_ratio" and lb.get("mfc") in want}
    check(want and mfus == want and all(0 < v <= 1 for v in mfus.values()),
          f"{tag} areal_mfc_mfu_ratio {mfus} != the last step's perf/mfu {want}")
    for key in ("advisor_pred_err", "mfc_mfu_min", "mfc_mfu_max") + (
            ("ckpt_age",) if want_ckpt else ()):
        check(key in sig, f"{tag} signal {key} missing from {sorted(sig)}")
    log(f"[multiproc] {tag} metrics_report: roles {roles}, exit 0 in {seen['report_s']:.1f} s; "
        f"areal_master_steps_total {sig.get('areal_master_steps_total')}, advisor_pred_err "
        f"{sig['advisor_pred_err']:.4f}, mfc_mfu_min {sig['mfc_mfu_min']:.4f}, mfc_mfu_max "
        f"{sig['mfc_mfu_max']:.4f}" + (f", ckpt_age {sig['ckpt_age']:.1f} s" if want_ckpt else ""))
    log(f"[multiproc] {tag} MFU per MFC (last step, {_card()}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(mfus.items())))
    return mfus


def _both(*fns):
    def on_finish(master):
        for fn in fns:
            fn(master)
    return on_finish


def phase_multiproc(report, seed):
    """The multi-process runtime at qwen2-1.5B's full width and CUT_LAYERS
    layers, from a seeded checkpoint of that depth (char tokenizer, 64 math
    rows, a ref, kl_ctl 0.1, 8 prompts x 4, MULTIPROC_NEW_TOKENS new
    tokens, the seeded null reward), placement {"actor_gen": 1, "reward":
    1}: prompts, rollouts, rewards and the actor's fp32 weights (with
    their checksum) cross between the workers each step.
    (a) B: the plan in this process (two ModelWorkers joined by
        InProcTransfer), 2 steps, launches read here.
    (b) U: the plan through apps.main.run_experiment, each worker a
        process of its own on the card: every stat but the wall times
        equal to B's bit for bit; the workers' summed K1f, K1dq, K1dkv
        and K4 launches (each worker's runtime_stats, asked over its
        control server) equal to B's; both on cuda:0, with their peaks,
        and both pids among nvidia-smi's compute processes when it lists
        any; each step's transfer/* stats and the param push's split.
    (d) in (b)'s on_finish, while the workers serve: `python -m
        areal_tpu_torch.apps.metrics_report --json` over the trial finds
        exactly master, model_worker/0 and model_worker/1 and exits 0
        (a CRIT rule that holds); areal_master_steps_total rose by the
        steps run, each worker MFC's areal_worker_mfc_seconds_count equals
        its calls, each areal_mfc_mfu_ratio{mfc} lies in (0, 1] and equals
        the last step's <mfc>/perf/mfu; advisor_pred_err, mfc_mfu_min and
        mfc_mfu_max are present, and ckpt_age too in (c), whose trial
        commits recover checkpoints.
    (c) C: U's plan with recover checkpoints every step, recover_retries
        1 and kill@point=mfc_train_step&skip=1&times=1 in worker 0's
        environment: worker 0 exits 43 at step 2's train step, the watch
        fails attempt 0, attempt 1 resubmits both workers and resumes from
        step 1's checkpoint: its step 2 equal to U's bit for bit; the
        retry's detection, relaunch and restore seconds."""
    import gc
    import logging as pylogging

    import numpy as np
    import torch

    from areal_tpu_torch.apps import main as runner
    from areal_tpu_torch.models.config import qwen2_config

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    os.makedirs(MULTIPROC_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=MULTIPROC_DIR)
    out = {}
    pushes_b = []

    class _Pushes(pylogging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("PARAM_PUSH "):
                pushes_b.append(json.loads(msg[len("PARAM_PUSH "):]))

    handler = _Pushes()
    wlog = pylogging.getLogger("areal_tpu_torch.model_worker")
    old_level = wlog.level
    try:
        # C's recover checkpoint (weights and both Adam moments, current
        # and .prev), the shared input checkpoint, and a margin.
        _check_disk("[multiproc]", work, 7 * _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, _, _ = _shared_checkpoint("[multiproc]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(np.random.default_rng(seed + 51), 64):
                f.write(json.dumps(row) + "\n")

        # (a) B: in this process.
        wlog.addHandler(handler)
        wlog.setLevel(pylogging.INFO)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        stats_b = runner.run_experiment_inproc(_multiproc_plan(cfg, ckpt, data, work, seed, "B"))
        torch.cuda.synchronize()
        b_s = time.monotonic() - t0
        counts_b = _trial_counts()
        peak_b = torch.cuda.max_memory_allocated()
        wlog.removeHandler(handler)
        wlog.setLevel(old_level)
        gc.collect()
        torch.cuda.empty_cache()
        check(len(stats_b) == 2, f"[multiproc] (a) {len(stats_b)} steps")
        for i, s in enumerate(stats_b):
            check(all(np.isfinite(v) for v in s.values()), f"[multiproc] (a) step {i + 1} stats")
            log(f"[multiproc] (a) B step {i + 1}: {s['time/step_s']:.2f} s; "
                + ", ".join(f"{k} {v:.6g}" for k, v in s.items() if k.startswith("transfer/")))
        check(stats_b[-1]["actor_train/advantage_abs"] > 0.1, "[multiproc] (a) no advantage")
        check(counts_b["fwd"] > 0 and counts_b["dq"] > 0 and counts_b["dkv"] > 0
              and counts_b["k4"] > 0 and counts_b["k2"] == counts_b["k3"] == 0,
              f"[multiproc] (a) launches {counts_b}")
        _log_pushes("(a) B", pushes_b)
        log(f"[multiproc] (a) B: 2 steps in one process in {b_s:.1f} s, launches {counts_b}, "
            f"peak {peak_b / 2**30:.2f} GiB (both workers)")

        # (b) U: each worker a process of its own.
        plan_u = _multiproc_plan(cfg, ckpt, data, work, seed, "U")
        seen_u, tl_u, plane_u = {}, [], {}
        steps_before = _counter("areal_master_steps_total")
        t0 = time.monotonic()
        stats_u = runner.run_experiment(
            plan_u, on_finish=_both(_worker_stats(plan_u, seen_u), _metrics_plane(plan_u, plane_u)),
            timeline=tl_u)
        u_s = time.monotonic() - t0
        check(len(stats_u) == 2, f"[multiproc] (b) {len(stats_u)} steps")
        for i, (u, b) in enumerate(zip(stats_u, stats_b)):
            tu, tb = _timeless(u), _timeless(b)
            diff = {k: (tu.get(k), tb.get(k)) for k in set(tu) | set(tb) if tu.get(k) != tb.get(k)}
            check(not diff, f"[multiproc] (b) step {i + 1} differs from B: {diff}")
            log(f"[multiproc] (b) U step {i + 1}: {u['time/step_s']:.2f} s, {len(tu)} stats "
                "equal to B's bit for bit; "
                + ", ".join(f"{k} {v:.6g}" for k, v in u.items() if k.startswith("transfer/")))
        workers = seen_u["workers"]
        summed = {k: sum(w["launches"][k] for w in workers.values()) for k in counts_b}
        for name, w in sorted(workers.items()):
            log(f"[multiproc] (b) {name}: pid {w['pid']} on {w['device']} ({w['device_name']}), "
                f"launches {w['launches']}, peak {w['max_memory_allocated'] / 2**30:.2f} GiB")
            check(w["device"].startswith("cuda") and w["max_memory_allocated"] > 0,
                  f"[multiproc] (b) {name} is not on the card: {w}")
        check(all(summed[k] == counts_b[k] for k in ("fwd", "dq", "dkv", "k4")),
              f"[multiproc] (b) the workers' launches {summed} != B's {counts_b}")
        listed = [line.split(",")[0].strip() for line in seen_u["smi"].splitlines()
                  if line.strip()]
        mine = {str(w["pid"]) for w in workers.values()}
        log(f"[multiproc] (b) nvidia-smi compute processes: {len(listed)}, pids {listed}; the "
            f"workers' own pids {sorted(mine)}")
        if mine <= set(listed):
            log("[multiproc] (b) both workers' pids are among the card's compute processes")
        else:
            # nvidia-smi reports pids of another pid namespace here (each
            # process shows as 1): count the card's processes instead, this
            # one and the two workers.
            check(len(listed) >= 1 + len(workers),
                  f"[multiproc] (b) {len(listed)} compute processes on the card, want this "
                  f"one and {len(workers)} workers")
            log(f"[multiproc] (b) nvidia-smi's pids are not this namespace's: {len(listed)} "
                f"compute processes on the card, this one and the {len(workers)} workers")
        logs_u = [os.path.join(plan_u.fileroot, "logs", "multiproc_U-attempt0",
                               f"model_worker-{i}.log") for i in range(2)]
        pushes_u = _param_push_lines(logs_u)
        check(sum(p["side"] == "send" for p in pushes_u) == 2, f"[multiproc] (b) pushes {pushes_u}")
        _log_pushes("(b) U", pushes_u)
        connect_s = tl_u[1]["t"] - tl_u[0]["t"]
        log(f"[multiproc] (b) U: {u_s:.1f} s (workers up and connected in {connect_s:.1f} s), "
            f"launches summed over the workers {summed}")
        mfu_u = _check_metrics_plane("(d)", plane_u, steps_before, want_ckpt=False)

        # (c) C: kill worker 0 at step 2's train step; the retry resumes.
        plan_c = _multiproc_plan(cfg, ckpt, data, work, seed, "C", ckpt_freq=1)
        seen_c, tl_c, plane_c = {}, [], {}
        clock = time.time() - time.monotonic()
        t0 = time.monotonic()
        stats_c = runner.run_experiment(
            plan_c, recover_retries=1, timeline=tl_c,
            on_finish=_both(_worker_stats(plan_c, seen_c), _metrics_plane(plan_c, plane_c)),
            worker_envs={0: {"AREAL_FAULTS": "kill@point=mfc_train_step&skip=1&times=1"}})
        c_s = time.monotonic() - t0
        events = [(e["event"], e.get("attempt")) for e in tl_c]
        check(events == [("submit", 0), ("connected", None), ("failed", 0), ("submit", 1),
                         ("connected", None), ("done", 1)], f"[multiproc] (c) events {events}")
        log0 = os.path.join(plan_c.fileroot, "logs", "multiproc_C-attempt0", "model_worker-0.log")
        with open(log0) as f:
            kill = [line for line in f if "FAULT kill at point 'mfc_train_step'" in line]
        check(len(kill) == 1, "[multiproc] (c) worker 0 logged no kill")
        import datetime

        stamp = " ".join(kill[0].split()[:2])
        kill_t = datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp() - clock
        check(len(stats_c) == 1, f"[multiproc] (c) attempt 1 ran {len(stats_c)} steps")
        tc, tu = _timeless(stats_c[0]), _timeless(stats_u[1])
        diff = {k: (tc.get(k), tu.get(k)) for k in set(tc) | set(tu) if tc.get(k) != tu.get(k)}
        check(not diff, f"[multiproc] (c) resumed step 2 differs from U's: {diff}")
        detect_s = tl_c[2]["t"] - kill_t
        relaunch_s = tl_c[4]["t"] - tl_c[2]["t"]
        log("[multiproc] (c) timeline (s from submit): " + ", ".join(
            f"{e['event']} {e['t'] - tl_c[0]['t']:.1f}" for e in tl_c)
            + f"; the kill at {kill_t - tl_c[0]['t']:.1f}")
        log(f"[multiproc] (c) C: {c_s:.1f} s; worker 0 killed at step 2's train step, the watch "
            f"failed the attempt {detect_s:.2f} s later; the relaunch (stop, resubmit, both "
            f"workers connected) {relaunch_s:.1f} s; the restore {seen_c['restore_s']:.2f} s; "
            f"resumed step 2 {stats_c[0]['time/step_s']:.2f} s, its {len(tc)} stats equal to "
            "U's step 2 bit for bit")
        _check_metrics_plane("(d) C", plane_c, None, want_ckpt=True)
        out = dict(launches=summed, b_s=b_s, u_s=u_s, c_s=c_s, peak_b=peak_b,
                   peaks={k: w["max_memory_allocated"] for k, w in workers.items()},
                   detect_s=detect_s, relaunch_s=relaunch_s, restore_s=seen_c["restore_s"],
                   mfu=mfu_u, report_s=plane_u["report_s"])
    finally:
        wlog.removeHandler(handler)
        wlog.setLevel(old_level)
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    report["multiproc"] = out


FABRIC_DIR = os.path.join(REPO, ".fabric_tmp")
# The spawned servers' ports count up from FABRIC_BASE_PORT (the one armed
# to die, then the plain ones); the server in this process takes
# FABRIC_INPROC_PORT, so its sid "s8201" sorts after theirs and the tree's
# first root (the relay with a child) is a spawned server.
FABRIC_BASE_PORT = 8101
FABRIC_INPROC_PORT = 8201
FABRIC_TTL = 5.0  # the fleet keys' keepalive TTL (s)
# Every server's serving plane: 32 slots (8 prompts x 4 in one wave) over
# an explicitly sized pool (an auto-sized one takes the card's free
# memory, which three servers and a trainer share), a 64-token prefill
# slice, as in the async phase.
FABRIC_SLOTS = 32
FABRIC_POOL_PAGES = 256
FABRIC_PREFILL_TOKENS = 64
FABRIC_PROMPTS = 8
FABRIC_NEW_TOKENS = 128
# The burst's stop sequence: a request with one takes the serving plane by
# the JAX engine's own rule (a push then parks it and K3 replays), where a
# burst of <= 64 requests of <= 2048 new tokens without one takes the
# static path.  A random model emits this pair about never.
FABRIC_STOP = [[151935, 151934]]
FABRIC_DELTA_STD = 1e-3  # the seeded fp32 delta pushed on top of the checkpoint
FABRIC_TRIAL_NEW_TOKENS = 64
# Fabric's depth since the verifiers phase joined the smoke (CUT_LAYERS:
# the seeded checkpoint the earlier cut phases wrote): its pushes move
# 2.2 GB instead of 6.2 GB, which keeps the whole smoke inside its limit.
FABRIC_LAYERS = CUT_LAYERS
# (b): the server armed to die skips the param pushes it takes before
# (d)'s two fabric pushes and (a)'s two, and dies at the fifth.
FABRIC_KILL = "kill@point=param_push&skip=4&times=1"


def _reap(proc, timeout):
    """Wait for a spawned process to exit: (its exit code, its peak
    resident host memory in bytes, from wait4's rusage), or (None, None)
    at the timeout.  wait4's rusage holds where /proc/<pid>/status has no
    VmHWM, as on the card's machine."""
    deadline = time.monotonic() + timeout
    while True:
        pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
        if pid:
            return os.waitstatus_to_exitcode(status), usage.ru_maxrss * 1024
        if time.monotonic() > deadline:
            return None, None
        time.sleep(0.05)


def _metric_value(url, name):
    """One unlabelled series of a server's /metrics (0 when absent)."""
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return 0.0


class _PushLog:
    """Each hop this process sends (paramstore.push_payload, wrapped) and
    each apply a server logs ("param_push vN at sid: relay ... s, apply ...
    s"), read from this process's logger and the spawned servers' logs."""

    def __init__(self, paramstore, logs_dir):
        import logging as pylogging

        self.hops, self.lines, self.logs_dir = [], [], logs_dir
        self._paramstore, self._real = paramstore, paramstore.push_payload
        log_self = self

        def push_payload(url, meta, payload, **kw):
            t0 = time.monotonic()
            try:
                return log_self._real(url, meta, payload, **kw)
            finally:
                log_self.hops.append(dict(version=meta.get("version"), url=url,
                                          sid=(meta.get("subtree") or {}).get("sid"),
                                          s=time.monotonic() - t0))

        class _Handler(pylogging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("param_push v"):
                    log_self.lines.append(msg)

        paramstore.push_payload = push_payload
        self.handler = _Handler()
        self.logger = pylogging.getLogger("areal_tpu_torch.gen_server")
        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(pylogging.INFO)

    def close(self):
        self._paramstore.push_payload = self._real
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def applies(self, version):
        """{sid: (relay_s, apply_s)} the servers logged for `version`."""
        lines = list(self.lines)
        for name in os.listdir(self.logs_dir):
            with open(os.path.join(self.logs_dir, name), errors="replace") as f:
                lines += [ln.split(": ", 1)[1] for ln in f if "areal_tpu_torch.gen_server: "
                          "param_push v" in ln]
        out = {}
        for ln in lines:
            head, rest = ln.split(": relay to ", 1)
            v, sid = head[len("param_push v"):].split(" at ")
            if int(v) == version:
                relay = float(rest.split(" children ")[1].split(" s,")[0])
                apply = float(rest.split("apply ")[1].split(" s")[0])
                out[sid] = (relay, apply)
        return out

    def describe(self, version, report):
        hops = [h for h in self.hops if h["version"] == version]
        applies = self.applies(version)
        return (f"wall {report.seconds:.3f} s (depth {report.depth}); this process's hops "
                + ", ".join(f"-> {h['sid']} {h['s']:.3f} s" for h in hops)
                + "; at each server (relay to its children, then apply) "
                + ", ".join(f"{sid}: {r:.3f} + {a:.3f} s" for sid, (r, a) in sorted(applies.items())))


def _fabric_fleet(ckpt, eos, experiment, trial, base_port, logs_dir, faults=""):
    """A LocalProcessFleet of port generation servers on `ckpt`: each
    process runs `python -m areal_tpu_torch.system.gen_server` by exec
    (never a fork of this process), its log in `logs_dir`."""
    import shlex

    from areal_tpu_torch.system.fleet import LocalProcessFleet

    env = f"env AREAL_FAULTS={shlex.quote(faults)} " if faults else ""
    cmd = (f"exec {env}{shlex.quote(sys.executable)} -m areal_tpu_torch.system.gen_server "
           f"--path {shlex.quote(ckpt)} --port {{port}} --experiment {{experiment}} "
           f"--trial {{trial}} --keepalive-ttl {FABRIC_TTL} --eos-token-id {eos} "
           f"--max-decode-batch {FABRIC_SLOTS} --kv-pool-pages {FABRIC_POOL_PAGES} "
           f"--prefill-chunk-tokens {FABRIC_PREFILL_TOKENS} "
           f"> {shlex.quote(logs_dir)}/server-{{port}}.log 2>&1")
    return LocalProcessFleet(["sh", "-c", cmd], experiment, trial, base_port=base_port,
                             drain_grace_s=1.0, sid_prefix="s")


def _wait_for(cond, timeout, what, procs=(), tag="[fabric]"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        for p in procs:
            check(p.poll() is None, f"{tag} a spawned server exited ({p.returncode}) while "
                  f"waiting for {what}")
        time.sleep(0.1)
    check(False, f"{tag} timed out after {timeout} s waiting for {what}")


def _fabric_probe(urls, prompts):
    """Greedy tokens of each server on `prompts` (16 new tokens each)."""
    out = {}
    for sid, url in sorted(urls.items()):
        out[sid] = [_post(url + "/generate", dict(qid=f"probe{i}", prompt_ids=p, n=1,
                                                  max_new_tokens=16, greedy=True))
                    for i, p in enumerate(prompts)]
    return out


GROUP_DIR = os.path.join(REPO, ".group_tmp")
GROUP_PROMPT_BYTES = 192  # every prompt the same length: the micro-batches are predictable
GROUP_REF_TOL = 0.05  # max |ref logprob| difference a token, replicas against one (bf16 forward)


def _equal_math_rows(rng, n, nbytes):
    """n math rows whose prompts are all `nbytes` bytes (char tokens)."""
    rows = _math_rows(rng, n)
    for r in rows:
        r["prompt"] = (r["prompt"] + " pad" * nbytes)[:nbytes]
    return rows


def _group_ppo_plan(cfg, ckpt, data, work, seed, trial, placement, mb_tokens):
    """The multiproc phase's ppo-math trial (a ref, 8 prompts x 4,
    MULTIPROC_NEW_TOKENS new tokens, the seeded null reward), greedy,
    with `placement` (e.g. the ref as replicas) and a token cap a
    micro-batch.  kl_ctl 0: the ref's logprobs are held directly, and the
    actor's update (so step 2's tokens) does not move with them."""
    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    pc = exps.PPOMathConfig(
        actor=ModelAbstraction("hf", {"path": ckpt}),
        ref=ModelAbstraction("hf", {"path": ckpt}),
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": data}),
        reward_interface=ModelInterfaceAbstraction("null", {"seed": seed + 52}),
        ppo_kwargs={"kl_ctl": 0.0},
        optimizer=OptimizerConfig(lr=2e-5),
        gconfig=GenerationHyperparameters(n=4, max_new_tokens=MULTIPROC_NEW_TOKENS, greedy=True),
        batch_size=8, total_train_epochs=1,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=mb_tokens),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2),
        seed=seed + 53, experiment_name="group", trial_name=trial,
        fileroot=os.path.join(work, trial), placement=dict(placement),
    )
    plan = exps.build_ppo_math(pc)
    for wc in plan.worker_configs:
        wc.tokenizer_path = f"char:{cfg.vocab_size}"
    return plan


def _read_dumps(root, prefix, key):
    """The MFC outputs `AREAL_MFC_DUMP_DIR` collected under `root` in
    files starting `prefix`: (id, flat data, per-sequence lengths) of
    `key`, across every worker's files, in call order."""
    import numpy as np

    out = []
    for name in sorted(os.listdir(root), key=lambda n: int(n.rsplit("_", 1)[1][:-4])):
        if not name.startswith(prefix):
            continue
        z = np.load(os.path.join(root, name))
        data, lens, seqlens = z[f"data.{key}"], z[f"lens.{key}"], z[f"seqlens.{key}"]
        pos, seq = 0, 0
        for sid, n in zip(z["ids"], lens):
            sl = seqlens[seq:seq + n]
            out.append((str(sid), data[pos:pos + sl.sum()], sl))
            pos, seq = pos + sl.sum(), seq + n
    return out


def phase_group(report, seed):
    """The SPMD worker group's runtime on the one card (ROADMAP item
    8.6a; the four-card layouts run in scripts/group_check.py):
    (a) model replicas: the multiproc phase's ppo-math trial at qwen2-1.5B's
        width and CUT_LAYERS layers, greedy, with the ref as two replicas
        in two worker processes sharing the card (R, through
        apps.main.run_experiment), against the one-replica trial in this
        process (S).  Every prompt is GROUP_PROMPT_BYTES long and the
        token cap a micro-batch is 16 sequences' worth, so S's ref call
        takes two micro-batches of four prompts and each replica's half
        one.  Held: the greedy tokens of every sequence equal; each
        token's ref logprob within GROUP_REF_TOL of S's (the replicas
        pack other rows into their bf16 forwards); the generation and
        reward stats equal; K1f, K1dq, K1dkv and K4 launches summed over
        R's two processes equal to S's.
    (b) `quickstart sft --allocation d1` through the group path: its plan
        made a worker group of one (a world of one rank over NCCL, the
        model on a DeviceMesh), two steps in a worker process; the master
        asked the member's shard layout ((0, 1): the call broadcast) and
        dispatched each step to the group; loss, grad and update norms
        against the plain one-process trial in this process (no world)."""
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.apps import main as runner
    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.base.topology import ParallelConfig
    from areal_tpu_torch.data.tokenizer import load_hf_tokenizer
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.models.config import qwen2_config

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    os.makedirs(GROUP_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=GROUP_DIR)
    card = _card()
    out = {"seconds": {}}
    try:
        _check_disk("[group]", work, 2**30)
        ckpt, _, _ = _shared_checkpoint("[group]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        rows = _equal_math_rows(np.random.default_rng(seed + 91), 64, GROUP_PROMPT_BYTES)
        with open(data, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        tok = load_hf_tokenizer(f"char:{cfg.vocab_size}")
        plen = len(tok.encode(rows[0]["prompt"]))
        seq_len = plen + MULTIPROC_NEW_TOKENS
        mb_tokens = 16 * seq_len

        # (a) S: one ref, in this process; its outputs dumped here.
        dump_s, dump_r = os.path.join(work, "dump_S"), os.path.join(work, "dump_R")
        os.environ["AREAL_MFC_DUMP_DIR"] = dump_s
        _reset_counts()
        t0 = time.monotonic()
        try:
            stats_s = runner.run_experiment_inproc(
                _group_ppo_plan(cfg, ckpt, data, work, seed, "S", {}, mb_tokens))
        finally:
            del os.environ["AREAL_MFC_DUMP_DIR"]
        torch.cuda.synchronize()
        out["seconds"]["a_one_replica"] = time.monotonic() - t0
        counts_s = _trial_counts()
        # (a) R: the ref as replicas on workers 0 and 1, two processes.
        plan_r = _group_ppo_plan(cfg, ckpt, data, work, seed, "R", {"ref": [0, 1]}, mb_tokens)
        check(plan_r.model_replicas == {"ref@0": [0, 1]}, f"[group] (a) {plan_r.model_replicas}")
        seen = {}
        t0 = time.monotonic()
        stats_r = runner.run_experiment(plan_r, on_finish=_worker_stats(plan_r, seen),
                                        worker_env={"AREAL_MFC_DUMP_DIR": dump_r})
        out["seconds"]["a_replicas"] = time.monotonic() - t0
        check(len(stats_s) == len(stats_r) == 2, f"[group] (a) steps {len(stats_s)}, {len(stats_r)}")
        gen_s = _read_dumps(dump_s, "actor_gen", "packed_input_ids")
        gen_r = _read_dumps(dump_r, "actor_gen", "packed_input_ids")
        check(len(gen_s) == len(gen_r) == 16, f"[group] (a) generated {len(gen_s)} / {len(gen_r)} ids")
        for (ids, ts, ls), (idr, tr, lr) in zip(gen_s, gen_r):
            check(ids == idr and np.array_equal(ls, lr) and np.array_equal(ts, tr),
                  f"[group] (a) greedy tokens of {ids} differ between the trials")
        ref_s = {sid: (v, sl) for sid, v, sl in _read_dumps(dump_s, "ref", "packed_ref_logprobs")}
        ref_r = _read_dumps(dump_r, "ref", "packed_ref_logprobs")
        check(sorted(sid for sid, _, _ in ref_r) == sorted(ref_s),
              f"[group] (a) the replicas' ref outputs cover {len(ref_r)} ids, not {len(ref_s)}")
        by_worker = {f.split("_w")[1].split("_")[0] for f in os.listdir(dump_r) if f.startswith("ref")}
        check(by_worker == {"0", "1"}, f"[group] (a) ref outputs from workers {by_worker}")
        err = 0.0
        for sid, v, sl in ref_r:
            vs, sls = ref_s[sid]
            check(np.array_equal(sl, sls), f"[group] (a) ref lengths of {sid}")
            err = max(err, float(np.abs(v.astype(np.float64) - vs).max()))
        check(err <= GROUP_REF_TOL, f"[group] (a) ref logprobs {err:.4g} from S's (tol {GROUP_REF_TOL})")
        for i, (a, b) in enumerate(zip(stats_s, stats_r)):
            for k in ("actor_train/n_response_tokens", "actor_train/no_eos_ratio",
                      "actor_train/task_reward"):
                check(a[k] == b[k], f"[group] (a) step {i + 1} {k}: {a[k]} vs {b[k]}")
            log(f"[group] (a) step {i + 1}: S {a['time/step_s']:.2f} s, R {b['time/step_s']:.2f} s; "
                f"ref_inf {a['ref_inf/perf/time_s']:.3f} / {b['ref_inf/perf/time_s']:.3f} s; ref_kl "
                f"{a['actor_train/ref_kl']:.6g} / {b['actor_train/ref_kl']:.6g}")
        workers = seen["workers"]
        summed = {k: sum(w["launches"][k] for w in workers.values()) for k in counts_s}
        for name, w in sorted(workers.items()):
            check(w["device"].startswith("cuda") and w["max_memory_allocated"] > 0,
                  f"[group] (a) {name} is not on the card: {w}")
            log(f"[group] (a) R {name}: pid {w['pid']} on {w['device']}, launches {w['launches']}, "
                f"peak {w['max_memory_allocated'] / 2**30:.2f} GiB")
        check(all(summed[k] == counts_s[k] for k in ("fwd", "dq", "dkv", "k4")),
              f"[group] (a) R's summed launches {summed} != S's {counts_s}")
        log(f"[group] (a) replicas: greedy tokens of {len(gen_r)} prompt groups identical, ref "
            f"logprobs within {err:.4g} of one replica's (tol {GROUP_REF_TOL}) over {len(ref_r)} "
            f"ids from workers {sorted(by_worker)}; launches S {counts_s}, R summed {summed}; "
            f"S {out['seconds']['a_one_replica']:.1f} s, R {out['seconds']['a_replicas']:.1f} s "
            f"({card})")
        out["launches"] = counts_s
        out["ref_err"] = err

        # (b) quickstart sft --allocation d1 through the group path.
        sft_data = os.path.join(work, "sft.jsonl")
        with open(sft_data, "w") as f:
            for row in _sft_rows(np.random.default_rng(seed + 92), 32):
                f.write(json.dumps(row) + "\n")
        argv = ["sft", "--model.path", ckpt, "--dataset.path", sft_data, "--tokenizer-path",
                f"char:{cfg.vocab_size}", "--batch-size", "8", "--seed", str(seed + 93),
                "--benchmark-steps", "2", "--allocation", "d1"]
        masters, seen_b = [], {}
        real_build, real_run = exps.build_sft, runner.run_experiment

        def group_of_one(sft_cfg):
            plan = real_build(sft_cfg)
            wc = plan.worker_configs[0]
            wc.dist_process_id, wc.dist_num_processes = 0, 1
            wc.shards[0].parallel = ParallelConfig()
            plan.model_groups = {"default@0": [0]}
            return plan

        def run_group(plan, **kw):
            def on_finish(master):
                masters.append(master)
                _worker_stats(plan, seen_b)(master)
            return real_run(plan, on_finish=on_finish, **kw)

        exps.build_sft, runner.run_experiment = group_of_one, run_group
        t0 = time.monotonic()
        try:
            stats_g = quickstart.main(argv + ["--multiprocess", "--fileroot",
                                              os.path.join(work, "sft_group")])
        finally:
            exps.build_sft, runner.run_experiment = real_build, real_run
        out["seconds"]["b_group"] = time.monotonic() - t0
        t0 = time.monotonic()
        stats_p = quickstart.main(argv + ["--fileroot", os.path.join(work, "sft_plain")])
        out["seconds"]["b_plain"] = time.monotonic() - t0
        (master,) = masters
        check(master.groups == {"default@0": [0]}
              and master._shard_info_cache == {"default@0": [(0, 1)]},
              f"[group] (b) groups {master.groups}, shard infos {master._shard_info_cache}")
        (w,) = seen_b["workers"].values()
        check(w["device"] == "cuda:0" and w["launches"]["fwd"] > 0,
              f"[group] (b) the member's runtime {w}")
        diffs = {}
        for i, (g, p) in enumerate(zip(stats_g, stats_p)):
            for k in ("loss", "grad_norm", "update_norm"):
                d = abs(g[k] - p[k]) / max(abs(p[k]), 1e-30)
                diffs[f"step{i + 1}/{k}"] = d
                check(d <= 1e-5, f"[group] (b) step {i + 1} {k}: {g[k]} vs {p[k]}")
        log(f"[group] (b) quickstart sft --allocation d1 as a group of one (NCCL world of 1, "
            f"shard info (0, 1)): 2 steps in {out['seconds']['b_group']:.1f} s, the plain trial "
            f"{out['seconds']['b_plain']:.1f} s; largest relative difference "
            f"{max(diffs.values()):.3g} ({'bit for bit' if not any(diffs.values()) else 'within 1e-5'}); "
            f"the member's launches {w['launches']} ({card})")
        report["group"] = out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_fabric(report, seed):
    """The param store and the broadcast-tree weight push over a fleet of
    three generation servers at qwen2-1.5B's full width (FABRIC_LAYERS
    layers, bf16 servers), from a seeded checkpoint of that depth, under a
    file name_resolve:
    `LocalProcessFleet` spawns two servers (`python -m
    areal_tpu_torch.system.gen_server`, each its own process on the card;
    the first armed with AREAL_FAULTS `kill@point=param_push` for its fifth
    push), and a third, built in this process so its K2 and K3 launches are
    held exactly, announces itself; `fleet_discovery` lists exactly three.

    (d) runs first: a trial's fresh ParamStore starts at head 0, and a
        server at version k takes versions 1..k as no-ops (the reference's
        behaviour, ROADMAP queue 3), so the fabric trial needs the servers
        at version 0.  `quickstart ppo-math --gen-server-url <the three>
        --param-push-tree --param-push-fanout 2 --inmem-weight-sync`, 2
        steps of 8 prompts x 4, 64 new tokens, greedy (set by wrapping
        build_ppo_math: the CLI has no flag), each client sending its
        requests one at a time (a server's packed prefill depends on the
        order they arrive in), rewards seeded +-5; then the
        servers reload the checkpoint over /update_weights and the same
        trial runs with the disk push: the generated tokens of both steps
        and every step stat but the times are equal bit for bit.
    (a) a BroadcastFabric(fanout=2) over the fleet, its store continuing
        the servers' version time (`load_state_dict`), publishes the
        checkpoint plus a seeded fp32 delta once (serialize and checksum
        timed) and pushes it while each server serves a burst of 8 prompts
        x 4 (64-512 tokens, 128 new, a stop sequence: the serving plane):
        the tree's depth is 2, all three serve the version,
        areal_param_push_bytes_total (this process's and the servers') grew
        by three hops of payload plus meta from one serialization, the
        in-process server's K3 launches = L x its replays (>= 1) and K2 =
        L x its inner steps; greedy probes give identical tokens on the
        three servers and on the in-process one after it loads the same
        weights from an HF checkpoint over /update_weights; a push with a
        wrong checksum is refused by all three, their versions unchanged.
    (b) a push kills the first root (the relay with a child): exactly its
        subtree (two sids) is orphaned and the third server applies;
        repair() brings the surviving orphan to the head; the dead
        server's process exits and its key leaves fleet_discovery within
        its TTL; a replacement from `LocalProcessFleet.spawn()` joins.
    (c) the same weights pushed as two more versions, one in tree mode (the
        replacement's first push) and one in p2p mode: each push's wall,
        this process's hops and each server's relay and apply seconds.
    The phase's seconds and each process's peak host RSS print (ru_maxrss
    from getrusage for this process, from wait4 for each spawned one:
    the card's machine shows no VmHWM in /proc/<pid>/status)."""
    import shutil

    import numpy as np
    import torch

    from areal_tpu_torch.base import integrity, name_resolve
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.system import paramstore
    from areal_tpu_torch.system.fleet import fleet_discovery
    from areal_tpu_torch.system.gen_server import GenerationServer

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=FABRIC_LAYERS)
    L = cfg.n_layers
    t_phase = time.monotonic()
    os.makedirs(FABRIC_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=FABRIC_DIR)
    logs_dir = os.path.join(work, "logs")
    os.makedirs(logs_dir)
    env = {"AREAL_NAME_RESOLVE": "file",
           "AREAL_NAME_RESOLVE_ROOT": os.path.join(work, "name_resolve"),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    old_repo = name_resolve.default()
    name_resolve.set_default(name_resolve.FileNameResolveRepository())
    old_tempdir = tempfile.tempdir
    fleets, server, pushlog, spawned = [], None, None, {}
    out = {"walls": {}, "hwm": {}}
    try:
        # The disk trial's push checkpoint, (a)'s disk swap and a margin.
        _check_disk("[fabric]", work, 2 * _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, _, _ = _shared_checkpoint("[fabric]", cfg, seed + 21)
        eos = CharTokenizer(cfg.vocab_size).eos_token_id
        E, T = "fabric", f"t{seed}"
        doomed = _fabric_fleet(ckpt, eos, E, T, FABRIC_BASE_PORT, logs_dir, FABRIC_KILL)
        plain = _fabric_fleet(ckpt, eos, E, T, FABRIC_BASE_PORT + 1, logs_dir)
        fleets = [doomed, plain]
        t0 = time.monotonic()
        sid_dead, sid_b = doomed.spawn(), plain.spawn()
        procs = [doomed.procs[sid_dead], plain.procs[sid_b]]
        spawned = {sid_dead: procs[0], sid_b: procs[1]}
        _, params = hf.load_hf_checkpoint(ckpt, device="cuda")
        engine = GeneratorEngine(cfg, params, eos_token_id=eos, max_decode_batch=FABRIC_SLOTS,
                                 kv_pool_pages=FABRIC_POOL_PAGES,
                                 prefill_chunk_tokens=FABRIC_PREFILL_TOKENS)
        del params
        check(engine.device.type == "cuda", "[fabric] the in-process engine is not on the card")
        server = GenerationServer(engine, port=FABRIC_INPROC_PORT, max_wait_ms=200.0)
        sid_in = server.announce(E, T, ttl=FABRIC_TTL)
        view = fleet_discovery(E, T)
        _wait_for(lambda: len(view()) == 3, 300, "three announced servers", procs)
        up_s = time.monotonic() - t0
        members = view()
        check(set(members) == {sid_dead, sid_b, sid_in}, f"[fabric] fleet {members}")
        for sid in (sid_dead, sid_b):
            with open(os.path.join(logs_dir, f"server-{sid[1:]}.log")) as f:
                check(" on cuda" in f.read(), f"[fabric] server {sid} is not on the card")
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        check(len(smi) >= 3, f"[fabric] {len(smi)} compute processes on the card, want this one "
              "and the two spawned servers")
        log(f"[fabric] fleet up in {up_s:.1f} s: {sorted(members)} (spawned {sid_dead} armed "
            f"with {FABRIC_KILL!r}, {sid_b}; {sid_in} in this process); the card lists "
            f"{len(smi)} compute processes")
        pushlog = _PushLog(paramstore, logs_dir)
        gc.collect()
        torch.cuda.empty_cache()
        _reset_counts()

        # (d) first: the fabric trial against servers at version 0, then the disk trial.
        tempfile.tempdir = work  # the disk push's sync dir
        out["d"] = _fabric_trials(seed, cfg, ckpt, work, members, engine)
        tempfile.tempdir = old_tempdir
        gc.collect()
        torch.cuda.empty_cache()

        # (a) the tree push mid-burst.
        store = paramstore.ParamStore()
        fabric = paramstore.BroadcastFabric(store, discovery=view, fanout=2, experiment=E,
                                            trial=T)
        versions = fabric.poll_versions()
        store.load_state_dict({"head": max(versions.values())})
        _, w = hf.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cuda")
        dev = integrity._leaves(w)[0].device
        gen = torch.Generator(device=dev).manual_seed(seed + 95)
        with torch.no_grad():
            for leaf in integrity._leaves(w):
                leaf.add_(torch.randn(leaf.shape, generator=gen, device=dev),
                          alpha=FABRIC_DELTA_STD)
        torch.cuda.synchronize()
        n_serialize = [0]
        real_serialize = paramstore.serialize_params

        def counted_serialize(tree):
            n_serialize[0] += 1
            return real_serialize(tree)

        paramstore.serialize_params = counted_serialize
        try:
            t = time.monotonic()
            manifest, payload = paramstore.serialize_params(w)
            serialize_s = time.monotonic() - t
            t = time.monotonic()
            checksum = integrity.params_checksum(w)
            checksum_s = time.monotonic() - t
            v1 = store.publish(manifest=manifest, payload=payload, checksum=checksum)
            pv = store.get(v1)
            rng = np.random.default_rng(seed + 96)
            prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
                       for _ in range(FABRIC_PROMPTS)]
            spawned_urls = {sid: members[sid] for sid in (sid_dead, sid_b)}
            bytes0 = {sid: _metric_value(u, "areal_param_push_bytes_total")
                      for sid, u in spawned_urls.items()}
            bytes0["self"] = paramstore.M_PUSH_BYTES.get()
            pca.LAUNCHES = rpa.LAUNCHES = 0
            replays0, steps0 = engine.resume_replays, engine.steps_total
            bursts = {sid: _burst(url, prompts, 4, FABRIC_NEW_TOKENS, seed + 97, stop=FABRIC_STOP)
                      for sid, url in members.items()}
            _wait_for(lambda: server.health_info()["live_slots"] > 0
                      and engine.steps_total - steps0 >= 64, 300, "two chunks of the burst")
            steps_at_push = engine.steps_total - steps0
            rep_a = fabric.push()
            for threads, _, _ in bursts.values():
                for th in threads:
                    th.join(timeout=900.0)
            torch.cuda.synchronize()
            k3, k2 = pca.LAUNCHES, rpa.LAUNCHES
            replays, steps = engine.resume_replays - replays0, engine.steps_total - steps0
        finally:
            paramstore.serialize_params = real_serialize
        for sid, (_, replies, errors) in bursts.items():
            check(not errors and all(r is not None for r in replies),
                  f"[fabric] (a) {sid}'s burst: {errors}")
        spanned = sum(r["version_start"] < r["version"] == v1 for r in bursts[sid_in][1])
        check(rep_a.ok and rep_a.depth == 2 and sorted(rep_a.applied) == sorted(members),
              f"[fabric] (a) push {rep_a}")
        check(all(v == v1 for v in fabric.poll_versions().values()),
              f"[fabric] (a) versions {fabric.poll_versions()} != {v1}")
        roots = paramstore.plan_tree(sorted(members.items()), 2)
        hops = [n for r in roots for n in [r] + r["children"]]
        want_bytes = sum(pv.nbytes + len(json.dumps(dict(fabric._base_meta(pv), subtree=n)))
                         for n in hops)
        moved = paramstore.M_PUSH_BYTES.get() - bytes0["self"] + sum(
            _metric_value(u, "areal_param_push_bytes_total") - bytes0[sid]
            for sid, u in spawned_urls.items())
        check(len(hops) == 3 and moved == want_bytes,
              f"[fabric] (a) {moved} bytes pushed, want {want_bytes} (3 hops)")
        check(n_serialize[0] == 1, f"[fabric] (a) {n_serialize[0]} serializations")
        check(replays >= 1 and spanned >= 1,
              f"[fabric] (a) the push landed outside the burst: {replays} replays, "
              f"{spanned} spanned requests")
        check(k3 == L * replays, f"[fabric] (a) K3 launches {k3} != {L} x {replays} replays")
        check(k2 == L * steps, f"[fabric] (a) K2 launches {k2} != {L} x {steps} inner steps")
        log(f"[fabric] (a) v{v1}: {pv.nbytes / 1e9:.3f} GB fp32 serialized once in "
            f"{serialize_s:.3f} s (card -> host), checksum {checksum_s:.3f} s; pushed after "
            f"{steps_at_push} inner steps of the in-process burst: {pushlog.describe(v1, rep_a)}")
        log(f"[fabric] (a) bytes pushed {moved:.0f} = 3 hops x (payload + meta); the in-process "
            f"server: {replays} replays, K3 {k3} = {L} x {replays}, K2 {k2} = {L} x {steps} inner "
            f"steps, {spanned} of {FABRIC_PROMPTS} requests spanned the push")
        out["walls"]["a_tree"] = rep_a.seconds
        probes = rng.integers(0, cfg.vocab_size, (4, 48)).tolist()
        got = _fabric_probe(members, probes)
        toks = {sid: [r["output_ids"] for r in rs] for sid, rs in got.items()}
        check(len({json.dumps(t) for t in toks.values()}) == 1,
              f"[fabric] (a) the servers' greedy probes differ: {toks}")
        disk = os.path.join(work, "disk_v")
        t = time.monotonic()
        hf.save_hf_checkpoint(disk, cfg, w, model_type="qwen2")
        save_s = time.monotonic() - t
        del w
        torch.cuda.empty_cache()
        v_disk = _post(members[sid_in] + "/update_weights", {"path": disk})["version"]
        after = _fabric_probe({sid_in: members[sid_in]}, probes)[sid_in]
        check([r["output_ids"] for r in after] == toks[sid_in] and all(
            r["version"] == v_disk for r in after),
              "[fabric] (a) the disk swap's greedy probes differ from the fabric's")
        shutil.rmtree(disk, ignore_errors=True)
        log(f"[fabric] (a) greedy probes (4 x 16 tokens) identical on the three servers, and on "
            f"{sid_in} after /update_weights from the same weights saved to disk ({save_s:.2f} s "
            f"save; version {v_disk})")
        bad = checksum.copy()
        bad[2:] *= 1.01
        before = fabric.poll_versions()
        # The disk swap moved a server past the store's head: continue
        # version time past it, or the push would be that server's no-op.
        store.load_state_dict({"head": max(before.values())})
        v_bad = store.publish(manifest=manifest, payload=payload, checksum=bad)
        rep_bad = fabric.push()
        check(not rep_bad.applied and sorted(o["sid"] for o in rep_bad.orphans) == sorted(members)
              and all("checksum" in o["error"] for o in rep_bad.orphans),
              f"[fabric] (a) the wrong checksum was not refused everywhere: {rep_bad}")
        check(fabric.poll_versions() == before, "[fabric] (a) a refused push moved a version")
        log(f"[fabric] (a) v{v_bad} with a wrong checksum refused by all three "
            f"({pushlog.describe(v_bad, rep_bad)}); versions stay {before}")

        # (b) the first root dies at its param push.
        v_b = store.publish(manifest=manifest, payload=payload, checksum=checksum)
        rep_b = fabric.push()
        t_dead = time.monotonic()
        orphans = sorted(o["sid"] for o in rep_b.orphans)
        check(orphans == sorted([sid_dead, sid_b]) and rep_b.applied == [sid_in],
              f"[fabric] (b) orphans {orphans}, applied {rep_b.applied}")
        code, out["hwm"][sid_dead] = _reap(procs[0], 60)
        check(code == 0, f"[fabric] (b) the killed server's process did not exit ({code})")
        _wait_for(lambda: sid_dead not in view(), FABRIC_TTL + 5, "the dead server's key to expire")
        expire_s = time.monotonic() - t_dead
        check(expire_s <= FABRIC_TTL + 1.0, f"[fabric] (b) the dead key stayed {expire_s:.1f} s")
        repaired = fabric.repair()
        check(repaired == [sid_b], f"[fabric] (b) repair() brought {repaired}")
        sid_c = plain.spawn()  # the replacement: its first push is (c)'s tree push
        procs.append(plain.procs[sid_c])
        spawned[sid_c] = procs[2]
        versions = fabric.poll_versions()
        check(versions[sid_b] == versions[sid_in] == v_b, f"[fabric] (b) versions {versions}")
        log(f"[fabric] (b) v{v_b}: {sid_dead} killed at its param push, orphans {orphans}, "
            f"{sid_in} applied ({pushlog.describe(v_b, rep_b)}); repair() -> {repaired}; the "
            f"dead key left the fleet {expire_s:.2f} s after the push (TTL {FABRIC_TTL} s)")
        _wait_for(lambda: sid_c in view(), 300, "the replacement to announce", procs[1:])
        members = view()
        check(set(members) == {sid_b, sid_c, sid_in}, f"[fabric] (b) fleet after {members}")

        # (c) tree against p2p, the same weights as two versions.
        reports = {}
        for mode in ("tree", "p2p"):
            fab = paramstore.BroadcastFabric(store, discovery=view, fanout=2, mode=mode)
            v = store.publish(manifest=manifest, payload=payload, checksum=checksum)
            reports[mode] = (v, fab.push())
            r = reports[mode][1]
            check(r.ok and r.depth == (2 if mode == "tree" else 1)
                  and all(x == v for x in fab.poll_versions().values()),
                  f"[fabric] (c) {mode} push {r}")
            out["walls"][f"c_{mode}"] = r.seconds
            log(f"[fabric] (c) {mode} v{v}: {pushlog.describe(v, r)}")
        log(f"[fabric] (c) the replacement {sid_c} took the tree push (v{reports['tree'][0]}); "
            f"tree {reports['tree'][1].seconds:.3f} s vs p2p {reports['p2p'][1].seconds:.3f} s")
        out.update(serialize_s=serialize_s, checksum_s=checksum_s, nbytes=pv.nbytes,
                   replays=replays, k2=k2, k3=k3, inner_steps=steps, spanned=spanned,
                   expire_s=expire_s, up_s=up_s)
        del payload, pv, store, fabric
    finally:
        tempfile.tempdir = old_tempdir
        if pushlog is not None:
            pushlog.close()
        if server is not None:
            server.close()
        for f in fleets:
            f.shutdown()
        for sid, p in spawned.items():
            if sid not in out["hwm"]:
                _, out["hwm"][sid] = _reap(p, 60)
        name_resolve.set_default(old_repo)
        for name in sorted(os.listdir(logs_dir)):  # the servers' warnings, for a reader
            with open(os.path.join(logs_dir, name), errors="replace") as f:
                for line in f:
                    if " WARNING " in line or " ERROR " in line or "Traceback" in line:
                        log(f"[fabric] {name}: {line.rstrip()[:400]}")
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    import resource

    out["hwm"]["self"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out["launches"] = _trial_counts()
    out["seconds"] = time.monotonic() - t_phase
    log("[fabric] peak host RSS (VmHWM): " + ", ".join(
        f"{k} {v / 2**30:.2f} GiB" if v else f"{k} not read" for k, v in out["hwm"].items())
        + f"; launches over the phase {out['launches']}; {out['seconds']:.1f} s")
    report["fabric"] = out


def _bf16_bits(tree):
    """Each leaf's bf16 bits (the leaf cast as a server casts it) summed as
    integers, in sorted-key order: equal lists mean equal weights."""
    import torch

    from areal_tpu_torch.base import integrity

    return [int(x.detach().to(torch.bfloat16).view(torch.int16).sum(dtype=torch.int64))
            for x in integrity._leaves(tree)]


def _fabric_trials(seed, cfg, ckpt, work, members, engine):
    """(d): the quickstart trial against the fleet, with the fabric push
    and with the disk push; after each push the in-process server's
    weights (`engine`) are held against the pushed ones cast to bf16."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.api.model_api import LLMAPIClient
    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.system.gen_server import RemoteGeneratorEngine

    data = os.path.join(work, "math.jsonl")
    with open(data, "w") as f:
        for row in _math_rows(np.random.default_rng(seed + 98), 64):
            f.write(json.dumps(row) + "\n")
    urls = [members[sid] for sid in sorted(members)]
    rec = {"gen": [], "push": [], "landed": [], "versions": []}
    state = {}
    restore = []

    def wrap(owner, name, make):
        restore.append((owner, name, getattr(owner, name)))
        setattr(owner, name, make(getattr(owner, name)))

    def on_generate(orig):
        @functools.wraps(orig)
        def generate(self, sample, *a, **k):
            out = orig(self, sample, *a, **k)
            rec["gen"].append((list(out.ids), np.asarray(out.data["packed_input_ids"]).copy(),
                               [sum(x) for x in out.seqlens["packed_input_ids"]]))
            return out
        return generate

    def on_set_params(orig):
        @functools.wraps(orig)
        def set_params(self, params):
            want = _bf16_bits(params)
            torch.cuda.synchronize()
            t = time.monotonic()
            orig(self, params)
            rec["push"].append(time.monotonic() - t)
            rec["landed"].append(_bf16_bits(engine.params) == want)
            rec["versions"].append([cl.health()["version"] for cl in self.clients])
        return set_params

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)
            out.data["rewards"] = state["rng"].choice(
                [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
            return out
        return inference

    def on_build(orig):
        @functools.wraps(orig)
        def build(cfg_, *a, **k):
            return orig(dataclasses.replace(cfg_, gconfig=cfg_.gconfig.new(greedy=True)), *a, **k)
        return build

    def on_batch(orig):
        # One request at a time a client: a server packs the requests
        # that reach it together in their order of arrival, and the packed
        # prefill's numerics depend on a prompt's place in the pack (K1f's
        # tile bounds), so concurrent requests flip greedy near-ties from
        # run to run (on the H100: one prompt of 8 at step 1).
        @functools.wraps(orig)
        def generate_batch(self, inps, max_concurrency=64):
            return orig(self, inps, max_concurrency=1)
        return generate_batch

    wrap(LLMAPIClient, "generate_batch", on_batch)
    wrap(RemoteGeneratorEngine, "generate", on_generate)
    wrap(RemoteGeneratorEngine, "set_params", on_set_params)
    wrap(MultiTaskRewardInterface, "inference", on_reward)
    wrap(exps, "build_ppo_math", on_build)
    runs = {}
    try:
        for mode in ("fabric", "disk"):
            if mode == "disk":  # every server back on the checkpoint
                t = time.monotonic()
                threads = [threading.Thread(target=_post, args=(u + "/update_weights",
                                                                {"path": ckpt})) for u in urls]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=600)
                log(f"[fabric] (d) the servers reloaded the checkpoint over /update_weights in "
                    f"{time.monotonic() - t:.2f} s")
            state["rng"] = np.random.default_rng(seed + 99)
            rec["gen"], rec["push"], rec["landed"], rec["versions"] = [], [], [], []
            argv = ["ppo-math", "--model.path", ckpt, "--dataset.path", data,
                    "--tokenizer-path", f"char:{cfg.vocab_size}", "--batch-size", "8",
                    "--group-size", "4", "--max-new-tokens", str(FABRIC_TRIAL_NEW_TOKENS),
                    "--benchmark-steps", "2", "--fileroot", os.path.join(work, mode),
                    "--seed", str(seed + 100), "--gen-server-url", ",".join(urls),
                    "--inmem-weight-sync"]
            if mode == "fabric":
                argv += ["--param-push-tree", "--param-push-fanout", "2"]
            t = time.monotonic()
            stats = quickstart.main(argv)
            runs[mode] = dict(stats=stats, gen=list(rec["gen"]), push=list(rec["push"]),
                              landed=list(rec["landed"]), versions=list(rec["versions"]),
                              seconds=time.monotonic() - t)
            log(f"[fabric] (d) {mode} trial: {runs[mode]['seconds']:.1f} s, steps "
                f"{[round(s['time/step_s'], 2) for s in stats]} s, pushes "
                f"{[round(x, 2) for x in rec['push']]} s, the servers' versions after each "
                f"{rec['versions']}; the in-process server holds each push's weights bit for "
                f"bit: {rec['landed']}")
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
    f, d = runs["fabric"], runs["disk"]
    check(len(f["stats"]) == len(d["stats"]) == 2 and len(f["gen"]) == len(d["gen"]) == 2
          and len(f["push"]) == len(d["push"]) == 2, "[fabric] (d) the trials' steps or pushes")
    check(all(f["landed"]) and all(d["landed"]), "[fabric] (d) a push did not land on the "
          f"in-process server bit for bit: fabric {f['landed']}, disk {d['landed']}")
    check(f["versions"] == [[1] * len(urls), [2] * len(urls)]
          and all(len(set(v)) == 1 for v in d["versions"]),
          f"[fabric] (d) versions after the pushes: fabric {f['versions']}, disk {d['versions']}")
    for i, ((fi, ft, fl), (di, dt, dl)) in enumerate(zip(f["gen"], d["gen"])):
        if fi == di and fl == dl and not np.array_equal(ft, dt):
            cut = np.cumsum([0] + fl)
            bad = [k for k in range(len(fl)) if not np.array_equal(ft[cut[k]:cut[k + 1]],
                                                                    dt[cut[k]:cut[k + 1]])]
            log(f"[fabric] (d) step {i + 1}: prompts {bad} of {len(fl)} differ (prompt k went "
                f"to server k % {len(urls)} of {urls})")
        check(fi == di and fl == dl and np.array_equal(ft, dt),
              f"[fabric] (d) step {i + 1}'s tokens differ between the fabric and disk trials")
    tf, td = _timeless(f["stats"][-1]), _timeless(d["stats"][-1])
    diff = {k: (tf.get(k), td.get(k)) for k in set(tf) | set(td) if tf.get(k) != td.get(k)}
    check(not diff, f"[fabric] (d) step 2's stats differ: {diff}")
    check(f["stats"][-1]["actor_train/advantage_abs"] > 0.1, "[fabric] (d) no advantage")
    log(f"[fabric] (d) fabric and disk trials: both steps' {f['gen'][1][1].size} tokens "
        f"and step 2's {len(tf)} stats equal bit for bit; pushes fabric "
        f"{[round(x, 2) for x in f['push']]} s vs disk {[round(x, 2) for x in d['push']]} s")
    return dict(fabric_s=f["seconds"], disk_s=d["seconds"], fabric_push_s=f["push"],
                disk_push_s=d["push"], step_s={m: [s["time/step_s"] for s in r["stats"]]
                                              for m, r in runs.items()})


# --------------------------------------------------------------------------
# Phase: the verifier fleet, task mixtures and the tracer
# --------------------------------------------------------------------------

VERIFIERS_DIR = os.path.join(REPO, ".verifiers_tmp")
VERIFIERS_EXPERIMENT = "verifiers"
# The two spawned verifiers: the doomed one's sid sorts first, so the
# pool's least-loaded choice (ties by sid) sends it the trial's batches.
VERIFIER_SIDS = ("v0", "v1")
VERIFIER_PORTS = (8301, 8302)
VERIFIER_TTL = 3.0
# Trial two starts this long after the doomed verifier announces itself
# (the fleet's check of the fixed answers runs in between); the verifier
# dies at the middle of trial two's second step, as trial one's warm
# second step predicts it, counted from then.
VERIFIERS_LEAD_S = 4.0
VERIFIERS_NEW_TOKENS = 64
VERIFIERS_SERVER_PORT = 8311  # (b)'s in-process generation server
VERIFIERS_REWARD_PORT = 8321  # (b)'s spawned reward service
MIX_WEIGHTS = {"math": 3.0, "code": 1.0}
MIX_PROMPTS = 16  # two halves of 8: the controller is restored in between
# One response a prompt: a group's followers wait on their owner's prompt
# pages, which multiplies the serving plane's inner steps (PERF.md §7).
MIX_GROUP = 1
MIX_NEW_TOKENS = 64


def _verifier_answers():
    """64 fixed answers, half of them right: math (a boxed sum, or a
    response with no answer in it: graded without the sympy pool) and
    judge items (a reference in the tail or not)."""
    items = []
    for i in range(48):
        a = (37 * i + 11) % 1000
        text = f"so the sum is \\boxed{{{a}}}" if i % 2 == 0 else "I cannot tell."
        items.append({"task": "math", "text": text,
                      "payload": {"solutions": [f"\\boxed{{{a}}}"]}})
    for i in range(16):
        ref = ("Paris", "Rome", "Lima", "Oslo")[i % 4]
        said = ref if i % 2 == 0 else "Bern"
        items.append({"task": "judge", "text": f"... so the answer is {said}",
                      "payload": {"reference": ref}})
    return items


def _spawn_verifier(args, log_path, env):
    """`python -m areal_tpu_torch.apps.verifier ...` as a process of its
    own (exec, never a fork of this process), its log at `log_path`."""
    with open(log_path, "wb") as logf:
        return subprocess.Popen([sys.executable, "-m", "areal_tpu_torch.apps.verifier", *args],
                                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _flush_line(log_path):
    """The tracer's own cost a spawned process logged at its end."""
    import ast

    with open(log_path, errors="replace") as f:
        lines = [ln for ln in f if "tracer: {" in ln]
    return ast.literal_eval(lines[-1].split("tracer: ", 1)[1].strip()) if lines else None


def _verifier_trial(seed, cfg, ckpt, data, work, name, pool):
    """One quickstart ppo-math trial (a ref, 8 prompts x 4, 64 new
    tokens, greedy, two steps) grading in-process or through the verifier
    fleet: its stats, each step's generated tokens and launches, every
    grade (the items and their results) and each reward call's offset
    from the trial's start; the graded rewards are then replaced by
    seeded +-5, the same in both trials (a random model's are all -5)."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.interfaces import reward_service
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
    from areal_tpu_torch.system.verifier_pool import VerifierPool

    rec = {"steps": [], "gen": [], "grades": [], "reward_t": [], "step_t": [], "attempts": []}
    cur = {}
    restore = []
    rng = np.random.default_rng(seed + 120)

    def wrap(owner, attr, make):
        restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, make(getattr(owner, attr)))

    _record_trial_steps(wrap, rec, cur)

    def on_generate(orig):
        @functools.wraps(orig)
        def generate(self, *a, **k):
            out = orig(self, *a, **k)
            rec["gen"].append(np.asarray(out.data["packed_input_ids"]).copy())
            return out
        return generate

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            rec["reward_t"].append(time.monotonic() - rec["t0"])
            out = orig(self, model, sample, mb_spec)
            out.data["rewards"] = rng.choice(
                [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
            return out
        return inference

    def on_verify(orig):  # the in-process grade of one item
        @functools.wraps(orig)
        def verify(self, task, text, info):
            ok = orig(self, task, text, info)
            rec["grades"].append(((task, text), ok))
            return ok
        return verify

    def on_verify_batch(orig):  # a batch through the fleet
        @functools.wraps(orig)
        def verify_batch(self, items):
            oks = orig(self, items)
            rec["grades"] += [((it["task"], it["text"]), ok) for it, ok in zip(items, oks)]
            rec.setdefault("items", []).extend(items)
            return oks
        return verify_batch

    def on_post(orig):  # each attempt of the pool: which server, and its outcome
        @functools.wraps(orig)
        def post_verify(url, items, *a, **k):
            try:
                out = orig(url, items, *a, **k)
            except Exception as e:
                rec["attempts"].append((url, time.monotonic() - rec["t0"], repr(e)[:60]))
                raise
            rec["attempts"].append((url, time.monotonic() - rec["t0"], "ok"))
            return out
        return post_verify

    def on_build(orig):
        @functools.wraps(orig)
        def build(cfg_, *a, **k):
            return orig(dataclasses.replace(cfg_, gconfig=cfg_.gconfig.new(greedy=True)), *a, **k)
        return build

    def on_step(orig):
        @functools.wraps(orig)
        async def execute_step(self):
            rec["step_t"].append(time.monotonic() - rec["t0"])
            return await orig(self)
        return execute_step

    wrap(exps, "build_ppo_math", on_build)
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.system.master import MasterWorker

    wrap(MasterWorker, "execute_step", on_step)

    wrap(GeneratorEngine, "generate", on_generate)
    wrap(MultiTaskRewardInterface, "inference", on_reward)
    wrap(MultiTaskRewardInterface, "verify", on_verify)
    wrap(VerifierPool, "verify_batch", on_verify_batch)
    wrap(reward_service, "post_verify", on_post)
    argv = ["ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt, "--kl-ctl", "0.1",
            "--batch-size", "8", "--group-size", "4",
            "--max-new-tokens", str(VERIFIERS_NEW_TOKENS), "--benchmark-steps", "2",
            "--fileroot", os.path.join(work, name), "--seed", str(seed + 122),
            "--experiment-name", VERIFIERS_EXPERIMENT, "--trial-name", f"t{seed}"]
    if pool:
        argv.append("--verifier-pool")
    try:
        torch.cuda.synchronize()
        _reset_counts()
        rec["t0"] = time.monotonic()
        stats = quickstart.main(argv)
        torch.cuda.synchronize()
        rec["seconds"] = time.monotonic() - rec["t0"]
        rec["launches"] = _trial_counts()
    finally:
        for owner, attr, orig in reversed(restore):
            setattr(owner, attr, orig)
    rec["stats"] = stats
    check(len(stats) == 2 and len(rec["steps"]) == 2 and len(rec["gen"]) == 2
          and len(rec["reward_t"]) == 2, f"[verifiers] (a) trial {name}: {len(stats)} steps, "
          f"{len(rec['gen'])} generate calls, {len(rec['reward_t'])} reward calls")
    for i, st in enumerate(rec["steps"]):
        check(all(math.isfinite(v) for v in st["stats"].values()),
              f"[verifiers] (a) trial {name} step {i + 1}: non-finite stats")
        _check_step_launches(f"[verifiers] (a) trial {name}", i + 1, st, rec["plan_nodes"],
                             cfg.n_layers, VERIFIERS_NEW_TOKENS)
    check(rec["launches"] == {k: sum(st["launches"][k] for st in rec["steps"])
                              for k in rec["launches"]},
          f"[verifiers] (a) trial {name}: launches {rec['launches']} outside the steps")
    return rec


def _shard_stats(trace_dir):
    """Each shard's process label, span count, bytes and events."""
    out = {}
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("trace_") and f.endswith(".jsonl"):
            path = os.path.join(trace_dir, f)
            with open(path) as fh:
                rows = [json.loads(line) for line in fh if line.strip()]
            out[f[len("trace_"):-len(".jsonl")]] = dict(
                spans=sum(1 for r in rows if r.get("ph") == "X"), events=len(rows) - 1,
                bytes=os.path.getsize(path))
    return out


def phase_verifiers(report, seed):
    """The verifier fleet, task mixtures and the tracer at qwen2-1.5B (28
    layers, random weights from the quickstart's seeded checkpoint),
    under a file name_resolve.

    (a) Two quickstart ppo-math trials (a ref, 8 prompts x 4, 64 new
        tokens, greedy, two steps, graded math rewards replaced by seeded
        +-5 in both): trial one grades in-process, untraced; trial two runs
        with AREAL_TRACE=1 and --verifier-pool over two spawned `python -m
        areal_tpu_torch.apps.verifier --experiment ... --trial ... --ttl 3`
        processes, the first armed with AREAL_FAULTS `kill@t=...` to die
        half way between the trial's two grades.  Held: both trials'
        tokens and step stats bit for bit, every step's launches from the
        engines' calls (K1f, K1dq, K1dkv, K4; K2 and K3 none), every grade
        equal to the in-process registry's on the same answers, 64 fixed
        right and wrong answers graded through the pool before the kill
        (both verifiers live) and after it equal to the registry, the dead
        verifier's key gone within its TTL, its flight dump written within
        trial two.
    (b) A RolloutController over one in-process GenerationServer (32
        slots, 256 pages, the serving plane, K2) with a two-task
        TaskMixtureStream (math:code = 3:1), 16 prompts x 1, 64 new tokens,
        greedy, traced, one disk push (/update_weights) mid-run; the
        controller is rebuilt from state_dict() after 8 prompts; each
        trajectory graded by a spawned reward service with its trace_id.
        Held: the draws follow the weights exactly (12 math, 4 code, in
        the mixture's own order), the restored controller draws the
        remaining qids, every sample's lineage joins dispatch, first_token,
        generated, admitted, graded and trained with no orphan, K2 = 28 x
        inner steps and K3 = 28 x replays, the rest none.
    (c) `python -m areal_tpu_torch.apps.trace_report` on (a)'s and (b)'s
        directories: the shards of every process (master, both verifiers;
        the server's and the reward service's) merge, validate_trace finds
        nothing, the attribution table and bubbles print, --flight shows
        the killed verifier's fault_kill dump, --lineage (b)'s timelines.
    Printed: trial two's step walls beside trial one's; each process's
    span count, shard bytes and flush seconds."""
    import asyncio
    import collections
    import shutil
    import signal

    import numpy as np
    import torch

    from areal_tpu_torch.api.model_api import GenerationHyperparameters, LLMAPIClient
    from areal_tpu_torch.apps import trace_report
    from areal_tpu_torch.base import name_resolve, tracer
    from areal_tpu_torch.data import mixture as mixture_mod
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.interfaces import reward_service
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.system import rollout as rollout_mod
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController
    from areal_tpu_torch.system.verifier_pool import (
        VerifierPool, list_verifiers, verifier_discovery,
    )

    cfg = qwen2_config("1.5b")
    L = cfg.n_layers
    t_phase = time.monotonic()
    os.makedirs(VERIFIERS_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=VERIFIERS_DIR)
    trace_a, trace_b, logs = (os.path.join(work, d) for d in ("trace_a", "trace_b", "logs"))
    os.makedirs(logs)
    env = {"AREAL_NAME_RESOLVE": "file",
           "AREAL_NAME_RESOLVE_ROOT": os.path.join(work, "name_resolve"),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    saved_env = {k: os.environ.get(k) for k in (*env, "AREAL_TRACE", "AREAL_TRACE_DIR")}
    os.environ.update(env)
    old_repo = name_resolve.default()
    name_resolve.set_default(name_resolve.FileNameResolveRepository())
    E, T = VERIFIERS_EXPERIMENT, f"t{seed}"
    procs, server, out = {}, None, {}
    answers = _verifier_answers()
    registry = [reward_service.grade_item(it) for it in answers]
    check(sum(registry) == 32, f"[verifiers] the fixed answers grade {sum(registry)} right, want 32")
    flush = {}
    try:
        ckpt, _, _ = _shared_checkpoint("[verifiers]", cfg, seed + 21)
        data = os.path.join(work, "math.jsonl")
        with open(data, "w") as f:
            for row in _math_rows(np.random.default_rng(seed + 121), 64):
                f.write(json.dumps(row) + "\n")

        # (a) trial one: in-process grading, untraced.
        tracer.configure(role="smoke", enabled=False, force=True)
        one = _verifier_trial(seed, cfg, ckpt, data, work, "one", pool=False)
        g1, g2 = one["reward_t"]
        # Trial two's grades, predicted from trial one's warm second step:
        # step 1 starts after the set-up (s1) and grades as far into it as
        # step 2 did (g2 - s2); step 2's grade comes a step later.  The
        # verifier dies half way between the two.
        s1, s2 = one["step_t"]
        step2_s = one["stats"][1]["time/step_s"]
        kill_at = s1 + (g2 - s2) + 0.5 * step2_s
        kill_after = VERIFIERS_LEAD_S + kill_at
        log(f"[verifiers] (a) trial one (in-process grading, untraced): {one['seconds']:.1f} s, "
            f"steps {[round(s['time/step_s'], 2) for s in one['stats']]} s from {s1:.1f} and "
            f"{s2:.1f} s, rewards graded at {g1:.1f} and {g2:.1f} s; {len(one['grades'])} grades, "
            f"{sum(ok for _, ok in one['grades'])} right; launches {one['launches']}; the doomed "
            f"verifier is to die {kill_at:.1f} s into trial two")

        # The fleet: two verifiers, traced into (a)'s directory.
        vf_env = dict(os.environ, AREAL_TRACE="1", AREAL_TRACE_DIR=trace_a)
        t_spawn = time.monotonic()
        for i, (sid, port) in enumerate(zip(VERIFIER_SIDS, VERIFIER_PORTS)):
            e = dict(vf_env, AREAL_FAULTS=f"kill@t={kill_after:.3f}s") if i == 0 else vf_env
            procs[sid] = _spawn_verifier(
                ["--experiment", E, "--trial", T, "--server-id", sid, "--port", str(port),
                 "--ttl", str(VERIFIER_TTL)], os.path.join(logs, f"verifier-{sid}.log"), e)
        deadline = time.monotonic() + 60
        t_doomed = None
        while list_verifiers(E, T) != list(VERIFIER_SIDS):
            if t_doomed is None and VERIFIER_SIDS[0] in list_verifiers(E, T):
                t_doomed = time.monotonic()  # its fault clock started just before
            for sid, p in procs.items():
                check(p.poll() is None, f"[verifiers] verifier {sid} exited ({p.returncode})")
            check(time.monotonic() < deadline, "[verifiers] the fleet did not announce in 60 s")
            time.sleep(0.02)
        t_doomed = t_doomed or time.monotonic()
        up_s = time.monotonic() - t_spawn
        pool = VerifierPool(discovery=verifier_discovery(E, T), refresh_s=0.0)
        halves = [answers[:32], answers[32:]]
        got = [None, None]
        ths = [threading.Thread(target=lambda j=j: got.__setitem__(j, pool.verify_batch(halves[j])))
               for j in range(2)]
        t = time.monotonic()
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
        before_s = time.monotonic() - t
        check(got[0] + got[1] == registry and pool.graded_pooled == 64 and pool.graded_local == 0,
              f"[verifiers] (a) before the kill the pool graded {got} (pooled "
              f"{pool.graded_pooled}, local {pool.graded_local}), the registry {registry}")
        wait = VERIFIERS_LEAD_S - (time.monotonic() - t_doomed)
        check(wait > 0, f"[verifiers] the fleet took {time.monotonic() - t_doomed:.1f} s to come "
              f"up and grade, past the {VERIFIERS_LEAD_S} s trial two starts at")
        log(f"[verifiers] (a) fleet {list_verifiers(E, T)} up {up_s:.2f} s after the spawn "
            f"({VERIFIER_SIDS[0]} armed kill@t={kill_after:.3f}s); 64 fixed answers through the "
            f"pool in two concurrent batches in {before_s:.3f} s equal the registry; trial two "
            f"starts in {wait:.1f} s")
        time.sleep(wait)

        # (a) trial two: traced, grading through the fleet; a watcher
        # notes when the doomed verifier's key leaves the listing.
        gone = {}

        def watch():
            while not gone.get("stop"):
                if VERIFIER_SIDS[0] not in list_verifiers(E, T):
                    gone["t"] = time.time()
                    return
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        os.environ.update(AREAL_TRACE="1", AREAL_TRACE_DIR=trace_a)
        tracer.configure(role="master", rank=0, dir=trace_a, enabled=True, force=True)
        t_two = time.time()
        two = _verifier_trial(seed, cfg, ckpt, data, work, "two", pool=True)
        t_two_end = time.time()
        tracer.flush()
        flush["master_0"] = tracer.flush_stats()
        tracer.configure(role="smoke", enabled=False, force=True)
        for k in ("AREAL_TRACE", "AREAL_TRACE_DIR"):
            os.environ.pop(k, None)
        log(f"[verifiers] (a) trial two (traced, --verifier-pool): {two['seconds']:.1f} s, steps "
            f"{[round(s['time/step_s'], 2) for s in two['stats']]} s against trial one's "
            f"{[round(s['time/step_s'], 2) for s in one['stats']]} s; rewards graded at "
            f"{[round(x, 1) for x in two['reward_t']]} s; the pool's attempts (server, s, "
            f"outcome) {[(u.rsplit(':', 1)[1], round(s, 1), o) for u, s, o in two['attempts']]}")
        for i, (a, b) in enumerate(zip(one["gen"], two["gen"])):
            check(np.array_equal(a, b), f"[verifiers] (a) step {i + 1}'s tokens differ between "
                  "the trials")
        ta, tb = _timeless(one["stats"][-1]), _timeless(two["stats"][-1])
        diff = {k: (ta.get(k), tb.get(k)) for k in set(ta) | set(tb) if ta.get(k) != tb.get(k)}
        check(not diff and all(_timeless(x) == _timeless(y)
                               for x, y in zip(one["stats"], two["stats"])),
              f"[verifiers] (a) the trials' stats differ: {diff}")
        check([k for k, _ in one["grades"]] == [k for k, _ in two["grades"]]
              and len(two["grades"]) == 2 * 32, "[verifiers] (a) the trials graded other answers")
        mine = [reward_service.grade_item(it) for it in two["items"]]
        check([ok for _, ok in two["grades"]] == mine == [ok for _, ok in one["grades"]],
              "[verifiers] (a) a grade through the fleet differs from the in-process registry's")
        rc, _ = _reap(procs[VERIFIER_SIDS[0]], 30)
        check(rc is not None, "[verifiers] (a) the doomed verifier is still running")
        dumps = tracer.read_flight_dumps(trace_a)
        check([d["reason"] for d in dumps] == ["fault_kill"]
              and dumps[0]["role"] == "verifier" and dumps[0]["rank"] == VERIFIER_PORTS[0],
              f"[verifiers] (a) flight dumps {[(d['role'], d['rank'], d['reason']) for d in dumps]}")
        t_kill = dumps[0]["t_dump_us"] / 1e6
        check(t_two < t_kill < t_two_end, f"[verifiers] (a) the verifier died {t_kill - t_two:.1f} "
              f"s into trial two, outside its {t_two_end - t_two:.1f} s (steps from "
              f"{[round(x, 1) for x in two['step_t']]} s)")
        watcher.join(timeout=4 * VERIFIER_TTL)
        gone["stop"] = True
        gone_s = gone.get("t", float("inf")) - t_kill
        check(list_verifiers(E, T) == [VERIFIER_SIDS[1]] and 0 <= gone_s <= VERIFIER_TTL + 1.0,
              f"[verifiers] (a) the dead verifier's key: {list_verifiers(E, T)} {gone_s:.2f} s "
              f"after its death (TTL {VERIFIER_TTL} s)")
        t = time.monotonic()
        after = pool.verify_batch(answers)
        check(after == registry and pool.graded_pooled == 128 and pool.graded_local == 0,
              f"[verifiers] (a) after the kill the pool graded {after} (pooled "
              f"{pool.graded_pooled}, local {pool.graded_local})")
        log(f"[verifiers] (a) both trials' {sum(x.size for x in two['gen'])} tokens and "
            f"{len(tb)} step-2 stats equal bit for bit; {len(two['grades'])} fleet grades equal "
            f"the registry's; the verifier died {t_kill - t_two:.1f} s into trial two "
            f"({t_two_end - t_two:.1f} s), its key gone {gone_s:.2f} s after (TTL "
            f"{VERIFIER_TTL} s); 64 answers after the kill in {time.monotonic() - t:.3f} s equal "
            f"the registry")
        procs[VERIFIER_SIDS[1]].send_signal(signal.SIGINT)
        check(_reap(procs[VERIFIER_SIDS[1]], 30)[0] is not None,
              "[verifiers] the surviving verifier did not stop")
        for sid, port in zip(VERIFIER_SIDS, VERIFIER_PORTS):
            flush[f"verifier_{port}"] = _flush_line(os.path.join(logs, f"verifier-{sid}.log"))
        out["a"] = dict(one_s=one["seconds"], two_s=two["seconds"],
                        one_step_s=[s["time/step_s"] for s in one["stats"]],
                        two_step_s=[s["time/step_s"] for s in two["stats"]],
                        kill_into_trial_s=t_kill - t_two, key_gone_s=gone_s,
                        launches=[one["launches"], two["launches"]])

        # (b) the mixture through a controller over an in-process server.
        rw_env = dict(os.environ, AREAL_TRACE="1", AREAL_TRACE_DIR=trace_b)
        procs["reward"] = _spawn_verifier(["--port", str(VERIFIERS_REWARD_PORT)],
                                          os.path.join(logs, "reward.log"), rw_env)
        reward_url = f"http://127.0.0.1:{VERIFIERS_REWARD_PORT}"
        tracer.configure(role="gen_server", rank=VERIFIERS_SERVER_PORT, dir=trace_b,
                         enabled=True, force=True)
        tok = CharTokenizer(cfg.vocab_size)
        _, params = hf.load_hf_checkpoint(ckpt, device="cuda")
        engine = GeneratorEngine(cfg, params, eos_token_id=tok.eos_token_id,
                                 max_decode_batch=FABRIC_SLOTS, kv_pool_pages=FABRIC_POOL_PAGES,
                                 prefill_chunk_tokens=FABRIC_PREFILL_TOKENS)
        engine.static_path_max_new = 0  # the serving plane
        del params
        server = GenerationServer(engine, port=VERIFIERS_SERVER_PORT, max_wait_ms=100.0)
        rng = np.random.default_rng(seed + 123)
        rows = {"math": _math_rows(rng, 8), "code": _async_rows(rng, 0, 4)}
        prompts = {task: [tok.encode(r["prompt"]) for r in rs] for task, rs in rows.items()}

        def mixture():
            return mixture_mod.build_mixture(MIX_WEIGHTS, prompts)

        want, ref = [], mixture()
        for i in range(MIX_PROMPTS):
            it = next(ref)
            want.append((rollout_mod._normalize_prompt(it, i)[0], it["task"], it["index"]))
        check(collections.Counter(t for _, t, _ in want) == {"math": 12, "code": 4},
              f"[verifiers] (b) the mixture's draws {want}")
        deadline = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(reward_url + "/health", timeout=5).read()
                break
            except OSError:
                check(procs["reward"].poll() is None and time.monotonic() < deadline,
                      "[verifiers] (b) the reward service did not come up")
                time.sleep(0.05)
        g = GenerationHyperparameters(n=MIX_GROUP, max_new_tokens=MIX_NEW_TOKENS, greedy=True,
                                      stop=FABRIC_STOP)
        replay = ReplayBuffer(capacity=64, max_head_offpolicyness=1)
        remote = reward_service.RemoteVerifier(reward_url, timeout_s=300.0)
        pushed = {}

        def push():
            t0 = time.monotonic()
            while replay.accepted < 2 and time.monotonic() - t0 < 300:
                time.sleep(0.02)
            t0 = time.monotonic()
            pushed["version"] = _post(server.url + "/update_weights", {"path": ckpt})["version"]
            pushed["s"] = time.monotonic() - t0

        def half(ctl, with_push):
            th = threading.Thread(target=push) if with_push else None
            if th:
                th.start()
            asyncio.run(ctl.run(max_prompts=MIX_PROMPTS // 2))
            if th:
                th.join(timeout=600)
            trajs = list(replay._entries)
            items = []
            for tr in trajs:
                task, idx = tr.qid.split(":")[0], int(tr.qid.rsplit(":p", 1)[1])
                row = rows[task][idx]
                for o in tr.output_ids:
                    items.append({"task": task, "text": tok.decode(o), "trace_id": tr.trace_id,
                                  "payload": {"solutions": row.get("solutions") or [],
                                              "input_output": row.get("input_output"),
                                              "timeout_s": 8.0}})
            oks = remote.verify_batch(items)
            check(oks == [reward_service.grade_item({k: v for k, v in it.items()
                                                     if k != "trace_id"}) for it in items],
                  "[verifiers] (b) a grade of the reward service differs from the registry's")
            got_trajs = replay.get_batch(len(trajs), timeout=0)
            return [(t.qid, t.task) for t in got_trajs], sum(oks), len(oks)

        torch.cuda.synchronize()
        _reset_counts()
        steps0, replays0 = engine.steps_total, engine.resume_replays
        t = time.monotonic()
        ctl = RolloutController([LLMAPIClient(server.url)], replay, g, seed=seed + 124,
                                mixture=mixture())
        first, ok1, n1 = half(ctl, True)
        sd = ctl.state_dict()
        ctl2 = RolloutController([LLMAPIClient(server.url)], replay, g, seed=seed + 124,
                                 mixture=mixture())
        ctl2.load_state_dict(sd)
        second, ok2, n2 = half(ctl2, False)
        torch.cuda.synchronize()
        pump_s = time.monotonic() - t
        launches_b = _trial_counts()
        inner = engine.steps_total - steps0
        replays = engine.resume_replays - replays0
        tracer.flush()
        flush[f"gen_server_{VERIFIERS_SERVER_PORT}"] = tracer.flush_stats()
        check(sorted(q for q, _ in first) == sorted(q for q, _, _ in want[:8])
              and sorted(q for q, _ in second) == sorted(q for q, _, _ in want[8:]),
              f"[verifiers] (b) dispatched {first} then {second}, the mixture draws {want}")
        check(all(t_ == q.split(":")[0] for q, t_ in first + second),
              "[verifiers] (b) a trajectory's task stamp")
        check(pushed.get("version") == 1 and server.version == 1,
              f"[verifiers] (b) the disk push: {pushed}, server version {server.version}")
        st1, st2 = ctl.stat.as_dict(), ctl2.stat.as_dict()
        # The restored controller continues the counters it was given.
        check(st1["accepted"] == 8 and st2["accepted"] == 16 and st2["failed"] == 0,
              f"[verifiers] (b) controller stats {st1} {st2}")
        want_b = dict(fwd=0, dq=0, dkv=0, k4=0, k2=L * inner, k3=L * replays)
        check(launches_b == want_b and inner > 0,
              f"[verifiers] (b) launches {launches_b} != {want_b} ({inner} inner steps, "
              f"{replays} replays)")
        log(f"[verifiers] (b) {MIX_PROMPTS} prompts x {MIX_GROUP} through the mixture "
            f"{MIX_WEIGHTS} in {pump_s:.1f} s: draws {[q for q, _, _ in want]}; the restored "
            f"controller drew the remaining 8; disk push {pushed['s']:.2f} s mid-run; graded "
            f"{ok1 + ok2}/{n1 + n2} right by the reward service; {inner} inner steps, "
            f"{replays} replays; launches {launches_b}")
        server.close()
        server = None
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        tracer.configure(role="smoke", enabled=False, force=True)
        procs["reward"].send_signal(signal.SIGINT)
        check(_reap(procs["reward"], 30)[0] is not None, "[verifiers] the reward service did not stop")
        flush[f"reward_{VERIFIERS_REWARD_PORT}"] = _flush_line(os.path.join(logs, "reward.log"))

        # (c) trace_report on both directories.
        for d, views in ((trace_a, ([], ["--flight"])), (trace_b, (["--lineage"],))):
            for v in views:
                r = subprocess.run([sys.executable, "-m", "areal_tpu_torch.apps.trace_report", d,
                                    "--top", "5", *v], capture_output=True, text=True,
                                   timeout=300, cwd=REPO)
                check(r.returncode == 0, f"[verifiers] (c) trace_report {v} on {d}: {r.stderr}")
                text = r.stdout.strip().splitlines()
                log(f"[verifiers] (c) trace_report {os.path.basename(d)} {' '.join(v)}:\n"
                    + "\n".join(text[:40] + (["..."] if len(text) > 40 else [])))
                if v == ["--flight"]:
                    check("fault_kill" in r.stdout and f"verifier_{VERIFIER_PORTS[0]}" in r.stdout,
                          "[verifiers] (c) --flight does not show the killed verifier's dump")
        ta_trace = tracer.merge_shards(trace_a)
        tb_trace = tracer.merge_shards(trace_b)
        procs_a = {e["args"]["name"] for e in ta_trace["traceEvents"] if e["ph"] == "M"}
        procs_b = {e["args"]["name"] for e in tb_trace["traceEvents"] if e["ph"] == "M"}
        check(tracer.validate_trace(ta_trace) == [] and tracer.validate_trace(tb_trace) == [],
              f"[verifiers] (c) validate_trace: {tracer.validate_trace(ta_trace)[:5]} "
              f"{tracer.validate_trace(tb_trace)[:5]}")
        check(procs_a == {"master_0", *(f"verifier_{p}" for p in VERIFIER_PORTS)}
              and procs_b == {f"gen_server_{VERIFIERS_SERVER_PORT}",
                              f"reward_{VERIFIERS_REWARD_PORT}"},
              f"[verifiers] (c) processes {procs_a} {procs_b}")
        spans_a = collections.Counter(
            (e["pid"], e["name"]) for e in ta_trace["traceEvents"] if e["ph"] == "X")
        names = {e["pid"]: e["args"]["name"] for e in ta_trace["traceEvents"] if e["ph"] == "M"}
        for port in VERIFIER_PORTS:
            pid = next(p for p, n in names.items() if n == f"verifier_{port}")
            check(spans_a[(pid, "verify")] >= 1, f"[verifiers] (c) verifier {port} graded nothing")
        summary = trace_report.lineage_summary(tb_trace)
        rows_b = trace_report.lineage_rows(tb_trace)
        full = {"dispatch", "first_token", "generated", "admitted", "graded", "trained"}
        check(summary["n"] == MIX_PROMPTS and summary["complete"] == MIX_PROMPTS
              and not summary["orphans"] and all(full <= set(r["stages"]) for r in rows_b),
              f"[verifiers] (c) lineage {summary}")
        check({r["task"] for r in rows_b} == set(MIX_WEIGHTS), "[verifiers] (c) task stamps")
        shards = {**_shard_stats(trace_a), **_shard_stats(trace_b)}
        for proc, s in sorted(shards.items()):
            fl = flush.get(proc)
            log(f"[verifiers] (c) {proc}: {s['spans']} spans of {s['events']} events, "
                f"{s['bytes']} shard bytes, flushes {fl}")
        out["c"] = dict(shards=shards, flush=flush, lineage=summary)
        out["b"] = dict(pump_s=pump_s, push_s=pushed["s"], inner_steps=inner,
                        resume_replays=replays, launches=launches_b)
    finally:
        if server is not None:
            server.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tracer.configure(role="smoke", enabled=False, force=True)
        name_resolve.set_default(old_repo)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    total = {k: sum(x[k] for x in (*out["a"]["launches"], out["b"]["launches"]))
             for k in out["b"]["launches"]}
    out["launches"] = total
    out["seconds"] = time.monotonic() - t_phase
    log(f"[verifiers] the phase's launches {total}; {out['seconds']:.1f} s")
    report["verifiers"] = out


# --------------------------------------------------------------------------
# Phase: the SLO fleet supervisor over the metrics plane
# --------------------------------------------------------------------------

SUPERVISOR_DIR = os.path.join(REPO, ".supervisor_tmp")
SUPERVISOR_EXPERIMENT = "supervisor"
# The in-process server and the spawned ones: four digits each, since the
# drain's victim is the last id in sorted order (s8402 after s8401).
SUPERVISOR_INPROC_PORT = 8401
SUPERVISOR_BASE_PORT = 8402
SUPERVISOR_VERIFIER_PORT = 8411
SUPERVISOR_QUEUE = 16  # the CRIT rule: crit: queue_depth <= 16
# The in-process server picks at most 8 requests (x 4 responses: its 32
# slots) a batch, and the controller keeps 48 in flight: the rest wait in
# its queue, which each /health refresh publishes (the gauge is not the
# live queue: ROADMAP queue 3).
SUPERVISOR_BATCH = 8
SUPERVISOR_CONCURRENCY = 48
SUPERVISOR_GROUP = 4
SUPERVISOR_NEW_TOKENS = 64
SUPERVISOR_INTERVAL = 0.5  # seconds between supervisor rounds
SUPERVISOR_COOLDOWN = 10.0
# The verifier lane's cooldown outlasts the phase: its refills happen
# inside it, which only a refill may.
SUPERVISOR_LANE_COOLDOWN = 600.0
SUPERVISOR_IDLE_ROUNDS = 3
SUPERVISOR_VERIFIER_TTL = 3.0
SUPERVISOR_TAIL_S = 4.0  # the burst runs on this long after the new server's first tokens


class _StopSupervisor(Exception):
    pass


def _pool_bytes(cfg, pages, page_size=128):
    """A bf16 paged KV pool's bytes: K and V of every layer."""
    return pages * page_size * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2


def phase_supervisor(report, seed):
    """The SLO fleet supervisor at qwen2-1.5B's full width and CUT_LAYERS
    layers in bf16, from the seeded checkpoint of that depth, under a
    file name_resolve: one GenerationServer in this process (s8401,
    SUPERVISOR_BATCH requests a batch), a FleetSupervisor (min 1, max 2,
    SUPERVISOR_COOLDOWN, SUPERVISOR_IDLE_ROUNDS idle rounds, the rule
    `crit: queue_depth <= SUPERVISOR_QUEUE`, a recover root) whose
    LocalProcessFleet(sid_prefix="s") spawns `python -m
    areal_tpu_torch.system.gen_server` processes from port 8402, and a
    verifier SupervisorLane (min 1) over list_verifiers and `python -m
    areal_tpu_torch.apps.verifier`.  The supervisor's own run() loop runs
    in a thread over the metrics report's discover, scrape and signals
    (wrapped here only to record each round).  Its idle_goodput is
    infinite: after traffic stops the reference's goodput signal holds
    the last call's gauge (ROADMAP queue 3), so idleness is read from
    idle_frac and in_flight.  The supervisor and the lane count, besides
    the announced members, the ones this phase started that have not
    announced yet: the reference counts only announced members, and a
    server's start outlasts the cooldown.
    A RolloutController(discovery=fleet_discovery(E, T)) streams
    requests of 4 x 64 new tokens with a stop sequence (the serving plane,
    by the engine's own choice) in waves of SUPERVISOR_CONCURRENCY, all in
    flight at once, until the new server has served SUPERVISOR_TAIL_S.
    Checked, in order: (1) the lane refills to one verifier; the CRIT
    spawns the second server; the controller dispatches to it and both
    servers' areal_gen_tokens_total rise; (2) summed over the servers the
    rise equals the tokens the controller received; (3) goodput > 0 during
    the burst, kv_utilization in [0, 1] and in (0, 1] on scrapes with live
    slots past a call's first chunk (the pool is sampled before each
    chunk), live_slots <= capacity_slots, version_skew 0; (4) K2 = L x inner steps on the
    in-process server, no K1f, K3 or K4, no host sync in a serving chunk
    (its second under set_sync_debug_mode("error")); (5) after the stream
    the idle rounds drain s8402: its process exits within the drain grace
    and the card's free memory comes back by at least its weight and
    KV-pool bytes; (6) a verifier killed with SIGKILL leaves the listing
    within its TTL and is refilled; (7) a second FleetSupervisor over the
    same recover root resumes the membership epoch and the lane's epoch.
    Printed with the card's name and power limit: a round's seconds
    (scrape and evaluate) for the roles it saw, CRIT to spawn decision,
    spawn to announce, announce to the new server's first tokens, drain
    to process exit, the memory freed, kill to refill."""
    import asyncio
    import shlex
    import shutil
    import signal as signals_mod

    import numpy as np
    import torch

    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.apps import metrics_report as mr
    from areal_tpu_torch.base import integrity, name_resolve, names
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.system.fleet import (
        FleetSupervisor, LocalProcessFleet, SupervisorLane, fleet_discovery,
    )
    from areal_tpu_torch.system.gen_server import GenerationServer
    from areal_tpu_torch.system.replay import ReplayBuffer
    from areal_tpu_torch.system.rollout import RolloutController
    from areal_tpu_torch.system.verifier_pool import list_verifiers

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    L = cfg.n_layers
    t_phase = time.monotonic()
    os.makedirs(SUPERVISOR_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=SUPERVISOR_DIR)
    logs_dir = os.path.join(work, "logs")
    os.makedirs(logs_dir)
    env = {"AREAL_NAME_RESOLVE": "file",
           "AREAL_NAME_RESOLVE_ROOT": os.path.join(work, "name_resolve"),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    old_repo = name_resolve.default()
    name_resolve.set_default(name_resolve.FileNameResolveRepository())
    real_mr = {k: getattr(mr, k) for k in ("discover", "fleet_signals")}
    stop = threading.Event()
    server, fleets, sup_thread, spawned, events, rounds = None, [], None, {}, [], []
    out = {}
    try:
        ckpt, _, _ = _shared_checkpoint("[supervisor]", cfg, seed + 21)
        eos = CharTokenizer(cfg.vocab_size).eos_token_id
        E, T = SUPERVISOR_EXPERIMENT, f"t{seed}"
        _, params = hf.load_hf_checkpoint(ckpt, device="cuda")
        weight_bytes = sum(x.numel() * x.element_size() for x in integrity._leaves(params))
        engine = GeneratorEngine(cfg, params, eos_token_id=eos, max_decode_batch=FABRIC_SLOTS,
                                 kv_pool_pages=FABRIC_POOL_PAGES,
                                 prefill_chunk_tokens=FABRIC_PREFILL_TOKENS)
        del params
        check(engine.device.type == "cuda", "[supervisor] the in-process engine is not on the card")
        server = GenerationServer(engine, port=SUPERVISOR_INPROC_PORT, max_wait_ms=50.0,
                                  max_batch=SUPERVISOR_BATCH)
        sid1 = server.announce(E, T, ttl=FABRIC_TTL)
        name_resolve.add(names.metrics_endpoint(E, T, f"gen_server/{server.port}"), server.url,
                         replace=True)
        gen_fleet = _fabric_fleet(ckpt, eos, E, T, SUPERVISOR_BASE_PORT, logs_dir)
        ver_cmd = (f"exec {shlex.quote(sys.executable)} -m areal_tpu_torch.apps.verifier "
                   f"--experiment {{experiment}} --trial {{trial}} --port {{port}} "
                   f"--ttl {SUPERVISOR_VERIFIER_TTL} > {shlex.quote(logs_dir)}/verifier-{{port}}.log "
                   "2>&1")
        ver_fleet = LocalProcessFleet(["sh", "-c", ver_cmd], E, T,
                                      base_port=SUPERVISOR_VERIFIER_PORT, drain_grace_s=1.0,
                                      name_key=names.verifier_server, sid_prefix="v")
        fleets = [gen_fleet, ver_fleet]

        def recorded(kind, fleet_):
            def spawn():
                t = time.monotonic()
                sid = fleet_.spawn()
                spawned[sid] = (fleet_.procs[sid], t)
                events.append((t, kind, "spawned", sid))
                return sid

            def drain(sid):
                events.append((time.monotonic(), kind, "drain", sid))
                fleet_.drain(sid)
                events.append((time.monotonic(), kind, "drained", sid))
            return spawn, drain

        gspawn, gdrain = recorded("fleet", gen_fleet)
        vspawn, vdrain = recorded("lane", ver_fleet)
        seen_sids = set()

        def members(listed, prefix):
            """The announced members and those this phase started that have
            not announced yet (their processes alive): a spawn counts from
            the moment it is made, so a server that takes longer than the
            cooldown to start is not spawned twice."""
            seen_sids.update(listed)
            starting = {sid for sid, (proc, _) in spawned.items() if sid.startswith(prefix)
                        and proc.poll() is None and sid not in seen_sids}
            return sorted(set(listed) | starting)

        lane = SupervisorLane("verifier", list_servers=lambda: members(list_verifiers(E, T), "v"),
                              spawn=vspawn,
                              drain=vdrain, min_servers=1, max_servers=2,
                              action_cooldown_s=SUPERVISOR_LANE_COOLDOWN,
                              idle_rounds=SUPERVISOR_IDLE_ROUNDS)
        recover_root = os.path.join(work, "recover")
        sup = FleetSupervisor(
            E, T, rules=[mr.parse_slo_rule(f"crit: queue_depth <= {SUPERVISOR_QUEUE}")],
            spawn=gspawn, drain=gdrain, min_servers=1, max_servers=2,
            action_cooldown_s=SUPERVISOR_COOLDOWN, idle_rounds=SUPERVISOR_IDLE_ROUNDS,
            idle_goodput=float("inf"), recover_root=recover_root, lanes=[lane])
        announced = sup.list_servers
        sup.list_servers = lambda: members(announced(), "s")
        real_lane_evaluate, real_sup_evaluate = lane.evaluate, sup.evaluate

        def discover(e, t):
            if stop.is_set():
                raise _StopSupervisor
            rounds.append({"t0": time.monotonic()})
            return real_mr["discover"](e, t)

        def fleet_signals(roles, prev):
            sig, rows = real_mr["fleet_signals"](roles, prev)
            rounds[-1].update(roles=roles, signals=sig, rows=rows)
            return sig, rows

        def sup_evaluate(signals):
            d = real_sup_evaluate(signals)
            rounds[-1]["t1"] = time.monotonic()
            rounds[-1]["decision"] = d
            return d

        def lane_evaluate(history):
            d = real_lane_evaluate(history)
            if d.action != "hold":
                events.append((time.monotonic(), "lane", "decision", d.reason))
            return d

        mr.discover, mr.fleet_signals = discover, fleet_signals
        sup.evaluate, lane.evaluate = sup_evaluate, lane_evaluate
        err = {}

        def run_supervisor():
            try:
                sup.run(count=None, interval=SUPERVISOR_INTERVAL)
            except _StopSupervisor:
                pass
            except BaseException as e:  # noqa: BLE001 — reported by the main thread
                err["e"] = repr(e)

        sup_thread = threading.Thread(target=run_supervisor, daemon=True)
        t_start = time.monotonic()
        sup_thread.start()

        def alive():
            check("e" not in err, f"[supervisor] the supervisor loop failed: {err.get('e')}")
            return True

        # (1) the lane refills to one verifier.
        _wait_for(lambda: alive() and len(list_verifiers(E, T)) == 1, 120, "the lane's refill", tag="[supervisor]")
        first_v = list_verifiers(E, T)[0]
        refills = [e for e in events if e[1] == "lane" and e[2] == "decision"]
        check(refills and "refill" in refills[0][3], f"[supervisor] lane decisions {refills}")
        log(f"[supervisor] (1) the lane refilled to one verifier ({first_v}) "
            f"{events[0][0] - t_start:.2f} s after the loop started: {refills[0][3]}")

        # The burst.
        free0 = torch.cuda.mem_get_info()[0]
        tokens0 = _metric_value(server.url, "areal_gen_tokens_total")
        hold = {}
        real_getter = engine._get_serving_chunk_fn

        def getter(*a, **k):
            fn = real_getter(*a, **k)

            def run(*fa, **fk):
                hold["n"] = hold.get("n", 0) + 1
                if hold["n"] != 2:
                    return fn(*fa, **fk)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*fa, **fk)
                except RuntimeError as e:
                    hold["error"] = repr(e)
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    hold.setdefault("ok", "error" not in hold)
            return run

        engine._get_serving_chunk_fn = getter
        gc.collect()
        _reset_counts()
        steps0 = engine.steps_total
        replay = ReplayBuffer(capacity=1 << 20, max_head_offpolicyness=1)
        ctl = RolloutController(
            discovery=fleet_discovery(E, T), replay=replay,
            gconfig=GenerationHyperparameters(n=SUPERVISOR_GROUP,
                                              max_new_tokens=SUPERVISOR_NEW_TOKENS,
                                              stop=FABRIC_STOP),
            seed=seed + 131, max_concurrency=SUPERVISOR_CONCURRENCY, autosize_inflight=False,
            dispatch_timeout_s=600.0)
        rng = np.random.default_rng(seed + 132)
        burst, burst_done = {}, threading.Event()

        async def waves():
            # Waves of SUPERVISOR_CONCURRENCY prompts, each run to its end,
            # until the main thread ends the burst: a run() over an endless
            # source would create its dispatch tasks without bound.  The
            # loop's thread pool carries every dispatch at once (the default
            # pool has min(32, cores + 4) threads).
            import concurrent.futures

            asyncio.get_running_loop().set_default_executor(
                concurrent.futures.ThreadPoolExecutor(max_workers=SUPERVISOR_CONCURRENCY + 16))
            i = 0
            while not burst_done.is_set():
                wave = [(f"sup{i + j}",
                         rng.integers(0, cfg.vocab_size, int(rng.integers(64, 129))).tolist())
                        for j in range(SUPERVISOR_CONCURRENCY)]
                i += len(wave)
                await ctl.run(wave)
            return ctl.stat

        def pump():
            try:
                burst["stat"] = asyncio.run(waves())
            except BaseException as e:  # noqa: BLE001 — reported by the main thread
                burst["error"] = repr(e)

        pump_thread = threading.Thread(target=pump, daemon=True)
        t_burst = time.monotonic()
        pump_thread.start()
        spawn_ev = lambda: [e for e in events if e[1] == "fleet" and e[2] == "spawned"]
        _wait_for(lambda: alive() and "error" not in burst and spawn_ev(), 120,
                  "the CRIT's spawn", tag="[supervisor]")
        t_spawn, sid2 = spawn_ev()[0][0], spawn_ev()[0][3]
        check(sid2 == f"s{SUPERVISOR_BASE_PORT}", f"[supervisor] spawned {sid2}")
        proc2 = spawned[sid2][0]
        crit = next(r for r in rounds if r.get("decision") is not None
                    and r["decision"].action == "spawn")
        _wait_for(lambda: alive() and sid2 in fleet_discovery(E, T)(), 300,
                  "the spawned server's announcement", [proc2], tag="[supervisor]")
        t_announce = time.monotonic()
        with open(os.path.join(logs_dir, f"server-{sid2[1:]}.log")) as f:
            check(" on cuda" in f.read(), f"[supervisor] server {sid2} is not on the card")
        url2 = fleet_discovery(E, T)()[sid2]
        _wait_for(lambda: "error" not in burst and _metric_value(url2, "areal_gen_tokens_total") > 0,
                  300, "the new server's first tokens", [proc2], tag="[supervisor]")
        t_first = time.monotonic()
        free_up = torch.cuda.mem_get_info()[0]
        time.sleep(SUPERVISOR_TAIL_S)
        burst_done.set()
        pump_thread.join(timeout=600)
        check(not pump_thread.is_alive() and "error" not in burst,
              f"[supervisor] the burst: {burst.get('error', 'did not end')}")
        t_end = time.monotonic()
        stat = burst["stat"].as_dict()
        got = replay.get_batch(len(replay), 1.0) if len(replay) else []
        received = sum(len(o) for tr in got for o in tr.output_ids)
        inner = engine.steps_total - steps0
        launches = _trial_counts()
        check(stat["failed"] == 0 and stat["rejected"] == 0 and stat["accepted"] == len(got) > 0,
              f"[supervisor] controller stat {stat}, {len(got)} groups")
        tokens1 = _metric_value(server.url, "areal_gen_tokens_total") - tokens0

        # (5) the idle rounds drain the spawned server.
        drain_ev = lambda: [e for e in events if e[1] == "fleet" and e[2] == "drain"]
        _wait_for(lambda: alive() and drain_ev(), 120, "the idle drain", tag="[supervisor]")
        t_drain, victim = drain_ev()[0][0], drain_ev()[0][3]
        check(victim == sid2, f"[supervisor] drained {victim}, want {sid2}")
        while proc2.poll() is None and time.monotonic() - t_drain < 60:
            time.sleep(0.01)
        t_exit = time.monotonic()
        check(proc2.poll() is not None, f"[supervisor] {sid2}'s process outlived its drain")
        check(t_exit - t_drain <= gen_fleet.drain_grace_s + 5.0,
              f"[supervisor] {sid2} exited {t_exit - t_drain:.1f} s after the drain")
        check(sid2 not in fleet_discovery(E, T)(), f"[supervisor] {sid2} still listed")
        freed, free_after = 0, 0
        need = weight_bytes + _pool_bytes(cfg, FABRIC_POOL_PAGES)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            free_after = torch.cuda.mem_get_info()[0]
            freed = free_after - free_up
            if freed >= need:
                break
            time.sleep(0.2)
        check(freed >= need, f"[supervisor] {freed / 2**30:.2f} GiB came back after the drain, "
              f"want its weights and KV pool {need / 2**30:.2f} GiB")
        # The spawned server's tokens: its last scrape before the drain.
        tokens2 = max(v for r in rounds if r.get("roles")
                      for x in r["roles"] if x.role == f"gen_server/{sid2[1:]}" and x.ok
                      for v in [x.value("areal_gen_tokens_total") or 0.0])
        log(f"[supervisor] (1) burst: {stat}; the CRIT (round signals queue_depth "
            f"{crit['signals']['queue_depth']:.0f} > {SUPERVISOR_QUEUE}) spawned {sid2}; tokens "
            f"{sid1} +{tokens1:.0f}, {sid2} +{tokens2:.0f}")
        check(tokens1 > 0 and tokens2 > 0, f"[supervisor] a server served nothing: {tokens1}, "
              f"{tokens2}")
        check(tokens1 + tokens2 == received, f"[supervisor] (2) servers counted {tokens1} + "
              f"{tokens2} tokens, the controller received {received}")
        log(f"[supervisor] (2) the servers' areal_gen_tokens_total rose by {tokens1 + tokens2:.0f}"
            f" in all = the {received} tokens the controller received in {len(got)} groups")

        # (3) the signals during the burst.
        during = [r for r in rounds if r.get("signals") is not None
                  and t_burst <= r["t0"] <= t_end]
        check(any(r["signals"]["goodput"] > 0 for r in during),
              "[supervisor] (3) no round saw goodput during the burst")
        live_rows, util_rows = 0, 0
        for r in during:
            check(r["signals"]["version_skew"] == 0, f"[supervisor] (3) skew {r['signals']}")
            for x in r["roles"]:
                if not x.ok or not x.role.startswith("gen_server/"):
                    continue
                live, cap = x.value("areal_gen_live_slots"), x.value("areal_gen_capacity_slots")
                kvu = x.value("areal_gen_kv_utilization_ratio")
                check(live is not None and cap and live <= cap,
                      f"[supervisor] (3) {x.role} live_slots {live} > capacity {cap}")
                check(kvu is not None and 0 <= kvu <= 1,
                      f"[supervisor] (3) {x.role} kv_utilization {kvu}")
                if live > 0:
                    # The pool is sampled before each chunk: a call's first
                    # chunk samples it before any prompt token is in.
                    live_rows += 1
                    util_rows += kvu > 0
        check(util_rows > 0, f"[supervisor] (3) no scrape of {live_rows} with live slots saw "
              "kv_utilization in (0, 1]")
        peak = max(during, key=lambda r: r["signals"]["goodput"])
        log(f"[supervisor] (3) {len(during)} rounds in the burst: goodput up to "
            f"{peak['signals']['goodput']:.1f} tok/s, kv_utilization in (0, 1] on {util_rows} of "
            f"{live_rows} scrapes with live slots (0 on the rest: a call's first chunk samples "
            "the pool before its prompts are in), live_slots <= capacity_slots, version_skew 0")

        # (4) the kernels on the in-process server.
        check(launches["k2"] == L * inner and inner > 0, f"[supervisor] (4) K2 {launches['k2']} "
              f"!= {L} x {inner} inner steps")
        check(launches["fwd"] == launches["k3"] == launches["k4"] == 0,
              f"[supervisor] (4) launches {launches}: K1f, K3 and K4 must not run")
        check(hold.get("ok") is True, f"[supervisor] (4) a serving chunk synchronised with the "
              f"card: {hold.get('error')}")
        log(f"[supervisor] (4) the in-process server: K2 {launches['k2']} = {L} x {inner} inner "
            f"steps, K1f/K3/K4 0; its second serving chunk ran under set_sync_debug_mode('error')")

        # (6) a verifier killed with SIGKILL leaves and is refilled.
        vproc = spawned[first_v][0]
        t_kill = time.monotonic()
        os.kill(vproc.pid, signals_mod.SIGKILL)
        vproc.wait(timeout=30)
        _wait_for(lambda: alive() and first_v not in list_verifiers(E, T),
                  SUPERVISOR_VERIFIER_TTL + 10, "the killed verifier's eviction", tag="[supervisor]")
        t_gone = time.monotonic()
        _wait_for(lambda: alive() and len(list_verifiers(E, T)) == 1, 120, "the lane's refill", tag="[supervisor]")
        t_refill = time.monotonic()
        refills = [e for e in events if e[1] == "lane" and e[2] == "decision"]
        check(len(refills) == 2 and "refill" in refills[1][3]
              and refills[1][0] - refills[0][0] < SUPERVISOR_LANE_COOLDOWN,
              f"[supervisor] (6) lane decisions {refills}")
        check(t_gone - t_kill <= SUPERVISOR_VERIFIER_TTL + 2.0,
              f"[supervisor] (6) the dead verifier stayed listed {t_gone - t_kill:.1f} s")
        log(f"[supervisor] (6) {first_v} killed: gone from the listing after "
            f"{t_gone - t_kill:.2f} s (TTL {SUPERVISOR_VERIFIER_TTL} s), the lane's refill "
            f"decision {refills[1][0] - t_kill:.2f} s after the kill (inside its "
            f"{SUPERVISOR_LANE_COOLDOWN:.0f} s cooldown), {list_verifiers(E, T)} announced "
            f"{t_refill - t_kill:.2f} s after the kill")

        # (7) the epochs persist.
        stop.set()
        sup_thread.join(timeout=60)
        check(not sup_thread.is_alive() and "e" not in err, f"[supervisor] the loop: {err}")
        lane2 = SupervisorLane("verifier", list_servers=lambda: list_verifiers(E, T))
        sup2 = FleetSupervisor(E, T, recover_root=recover_root, lanes=[lane2])
        check((sup.membership_epoch, lane.epoch) == (2, 2)
              and (sup2.membership_epoch, lane2.epoch) == (2, 2),
              f"[supervisor] (7) epochs {sup.membership_epoch}, {lane.epoch} -> resumed "
              f"{sup2.membership_epoch}, {lane2.epoch}")
        log("[supervisor] (7) a second FleetSupervisor over the recover root resumed membership "
            f"epoch {sup2.membership_epoch} and the verifier lane's epoch {lane2.epoch}")

        secs = [r["t1"] - r["t0"] for r in rounds if "t1" in r]
        worst = max((r for r in rounds if "t1" in r), key=lambda r: r["t1"] - r["t0"])
        card = _card()
        failed = [(x.role, x.error) for x in worst["roles"] if not x.ok]
        log(f"[supervisor] {card}: {len(secs)} rounds; a round (scrape and evaluate) median "
            f"{sorted(secs)[len(secs) // 2] * 1e3:.1f} ms, max {max(secs) * 1e3:.1f} ms over the "
            f"roles {sorted(x.role for x in worst['roles'])}"
            + (f", failed scrapes {failed}" if failed else ""))
        log(f"[supervisor] {card}: CRIT to spawn decision {(t_spawn - crit['t0']) * 1e3:.1f} ms "
            f"within its round ({t_spawn - t_burst:.2f} s after the burst began); spawn to "
            f"announce {t_announce - t_spawn:.2f} s; announce to the new server's first tokens "
            f"{t_first - t_announce:.2f} s; drain to process exit {t_exit - t_drain:.2f} s "
            f"(grace {gen_fleet.drain_grace_s} s); free memory {free0 / 2**30:.2f} GiB before the "
            f"spawn, {free_up / 2**30:.2f} with {sid2} up, {free_after / 2**30:.2f} after: "
            f"{freed / 2**30:.2f} GiB freed (weights {weight_bytes / 2**30:.2f} + KV pool "
            f"{_pool_bytes(cfg, FABRIC_POOL_PAGES) / 2**30:.2f} GiB); kill to refill "
            f"{t_refill - t_kill:.2f} s")
        out = dict(launches=launches, inner_steps=inner, stat=stat, tokens=received,
                   round_ms=sorted(secs)[len(secs) // 2] * 1e3,
                   spawn_s=t_spawn - t_burst, announce_s=t_announce - t_spawn,
                   first_tokens_s=t_first - t_announce, drain_exit_s=t_exit - t_drain,
                   freed=freed, kill_refill_s=t_refill - t_kill)
    finally:
        stop.set()
        if sup_thread is not None:
            sup_thread.join(timeout=60)
        mr.discover, mr.fleet_signals = real_mr["discover"], real_mr["fleet_signals"]
        if server is not None:
            server.close()
        for f in fleets:
            f.shutdown()
        for proc, _ in spawned.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        name_resolve.set_default(old_repo)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    log(f"[supervisor] the phase: {out['seconds']:.1f} s")
    report["supervisor"] = out


# --------------------------------------------------------------------------
# The chaos legs: poison and kill seams
# --------------------------------------------------------------------------

CHAOS_DIR = os.path.join(REPO, ".chaos_tmp")
# Depth of (b)'s and (d)'s trials: they write fp32 masters and Adam's
# moments at every step (about 6.7 GB a save at 7 layers, 3.9 GB at 2,
# most of it the 151,936 x 1,536 embedding).  At 7 layers the phase took
# 169.2 s, (d)'s three processes 79.9 s of it.
CHAOS_TRIAL_LAYERS = 2
CHAOS_LR = 1e-5  # the trials' lr: random weights at qwen2's width stay finite
CHAOS_PUSH_PROMPTS = 8
CHAOS_NEW_TOKENS = 64
CHAOS_PROMPTS = 24  # (e)'s stream
# (e): 32 new tokens are one serving chunk a request (2.8 s with three
# engines on the card, the first from 0.12 s after the victim's start in
# run 3), and the victim's kill@t lands inside it at speeds 0.5-2x.
CHAOS_STREAM_NEW_TOKENS = 32
CHAOS_KILL_S = 2.0


def _sync_probe(rec):
    """A context manager factory for nan_quarantine's poisoned step: the
    step runs under torch.cuda.set_sync_debug_mode("warn") and each
    synchronizing call's warning is recorded in rec["syncs"]."""
    import contextlib
    import warnings

    import torch

    @contextlib.contextmanager
    def probe():
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # (The mode's own "prototype feature" notice is not a sync.)
        rec["syncs"] = [str(w.message).splitlines()[0] for w in caught
                        if "called a synchronizing CUDA operation" in str(w.message)]
    return probe


def phase_chaos(report, seed):
    """The chaos legs of `python -m areal_tpu_torch.scripts.check_async`,
    called in this process at qwen2-1.5B's full width and CUT_LAYERS
    layers, from the seeded checkpoint of that depth (bf16), each part
    holding exact launch counts:
    (a) nan-chaos proof 1: `nan@point=train_grads&times=1`, one
        TrainEngine step: quarantined, the fp32 masters, Adam's mu, nu and
        its count bit for bit, exactly one synchronizing call (warnings
        under set_sync_debug_mode("warn")), K1 launches equal the clean
        step's after it (K1f 2 x L, K1dq and K1dkv L a micro-batch, the
        remat recompute), and the clean step changes the weights;
    (b) nan-chaos proof 2: the tiny-PPO trial (4 prompts x 2, 8 new
        tokens, a recover checkpoint every step) at CHAOS_TRIAL_LAYERS
        (2) from the seeded checkpoint of that depth,
        a NaN streak over its last two steps under
        max_consecutive_quarantines 2: 2 quarantined steps, 1 rollback,
        the replay's stats and final masters bit for bit the fault-free
        run's, the launches the baseline's plus 2 steps';
    (c) nan-chaos proof 3: `corrupt_push@point=weight_push&times=1` on an
        in-process GenerationServer: the push refused by the checksum
        reduced on the card, areal_gen_weight_push_rejected_total +1, the
        version unchanged, a push_rejected flight dump, the retry lands,
        and 8 prompts' greedy tokens on the serving plane equal a control
        server's that got the same weights cleanly; K2 = L x inner steps;
    (d) trainer-chaos (b) and (c): a victim process under
        `kill@point=recover_stage&skip=1&times=1` exits 42 with step 1's
        checkpoint manifest-valid and the stage left; a clean restart ends
        at the last step with no stale stage; a torn current falls back to
        `.prev` and a third restart exits 0 (2 steps, CHAOS_TRIAL_LAYERS;
        its processes run beside the other parts);
    (e) --chaos: three in-process servers announce themselves (a memory
        name_resolve), a RolloutController fed by fleet_discovery streams
        CHAOS_PROMPTS prompts on the serving plane, the first server under
        `kill@t=CHAOS_KILL_S`: no prompt lost, a redispatch, the victim's
        breaker open and closed again after a restart on its port, its
        flight dump with the kill rendered by trace_report --flight, the
        lineage joined; K2 = L x the inner steps of the three engines.
    The other legs run on the card in other phases: --push-chaos in
    `fabric` (b), --verifier-chaos (a) in `verifiers` and `supervisor`,
    --agents in `episodes`, --overlap in `overlap`, a worker's death in
    `multiproc` (c).  --trainer-chaos (a), a hang caught by
    mfc_timeout_s, runs on the CPU only: its path is the master's
    host-side deadline, and on the card a deadline above the first
    step's warm-up costs tens of seconds of waiting."""
    import shutil

    import torch

    from areal_tpu_torch.models.config import qwen2_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.scripts import check_async as ca

    cfg = dataclasses.replace(qwen2_config("1.5b"), n_layers=CUT_LAYERS)
    L = cfg.n_layers
    tcfg = dataclasses.replace(cfg, n_layers=CHAOS_TRIAL_LAYERS)
    t_phase = time.monotonic()
    os.makedirs(CHAOS_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=CHAOS_DIR)
    card = _card()
    out = {"launches": {}, "seconds": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    def done(part, t0):
        out["seconds"][part] = time.monotonic() - t0
        log(f"[chaos] ({part}) {out['seconds'][part]:.1f} s")

    d_thread = None
    try:
        ckpt, _, _ = _shared_checkpoint("[chaos]", cfg, seed + 21)
        tckpt = ckpt if tcfg.n_layers == L else _shared_checkpoint("[chaos]", tcfg, seed + 21)[0]
        _, params = hf.load_hf_checkpoint(ckpt, device="cuda")

        # (d) A save killed between stage and flip; a torn checkpoint.  Its
        # three processes wait mostly on their saves (88.5 s of the whole
        # smoke's 1,012.1 s in PR 23's run 4), so they run beside (a)-(c)
        # and (e), which run in this process.
        rd, d_out = {}, {}

        def run_d():
            t = time.monotonic()
            try:
                d_out["fails"] = ca.trainer_kill(
                    "qwen2-1.5b", tcfg.n_layers, "cuda", os.path.join(work, "d"), n_rows=8,
                    actor_path=tckpt, lr=CHAOS_LR, report=rd)
            except Exception as e:  # noqa: BLE001 — reported by the check below
                d_out["fails"] = [repr(e)]
            d_out["seconds"] = time.monotonic() - t

        d_thread = threading.Thread(target=run_d, name="chaos-d")
        d_thread.start()

        # (a) NaN gradients, one engine step.
        t0 = time.monotonic()
        rec, ra = {}, {}
        fails = ca.nan_quarantine(cfg, "cuda", params=params, around_step=_sync_probe(rec),
                                  report=ra)
        check(not fails, f"[chaos] (a) {fails}")
        n_mb = int(ra["out"]["n_micro_batches"])
        want = {"fwd": 2 * L * n_mb, "dq": L * n_mb, "dkv": L * n_mb, "k2": 0, "k3": 0, "k4": 0}
        check(ra["nan_launches"] == ra["clean_launches"] == want,
              f"[chaos] (a) launches: NaN step {ra['nan_launches']}, clean step "
              f"{ra['clean_launches']}, want {want}")
        check(len(rec["syncs"]) == 1, f"[chaos] (a) the poisoned step synchronised "
              f"{len(rec['syncs'])} times, want 1 (its host read): {rec['syncs'][:6]}")
        add(ra["nan_launches"])
        add(ra["clean_launches"])
        log(f"[chaos] (a) NaN step quarantined (verdict {ra['out']['anomaly_verdict']:.0f}), "
            f"masters, mu, nu and count unchanged; 1 synchronizing call ({rec['syncs'][:1]}); "
            f"launches {ra['nan_launches']} == the clean step's; clean grad_norm "
            f"{ra['out2']['grad_norm']:.6g}")
        done("a", t0)
        gc.collect()
        torch.cuda.empty_cache()

        # (b) A NaN streak, a rollback, a bit-for-bit replay.
        t0 = time.monotonic()
        rb = {}
        fails = ca.nan_rollback(tcfg, "cuda", os.path.join(work, "b"), n_rows=12,
                                actor_path=tckpt, lr=CHAOS_LR, baseline_ckpt=False, report=rb)
        check(not fails, f"[chaos] (b) {fails}")
        check(rb["base_launches"]["fwd"] > 0 and rb["base_launches"]["k4"] > 0,
              f"[chaos] (b) the trial ran no kernel: {rb['base_launches']}")
        add(rb["base_launches"])
        add(rb["chaos_launches"])
        log(f"[chaos] (b) {rb['quarantined']} quarantined steps, 1 rollback, {rb['clean']} clean "
            f"steps bit for bit the baseline's (max param diff {rb['diff']}); launches baseline "
            f"{rb['base_launches']}, chaos {rb['chaos_launches']}; baseline {rb['base_s']:.1f} s, "
            f"chaos run {rb['chaos_s']:.1f} s ({tcfg.n_layers} layers)")
        done("b", t0)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) A corrupted push, refused on the card, retried.
        t0 = time.monotonic()
        rc = {}
        push = init_params(cfg, seed + 23, device="cuda")
        fails = ca.corrupt_push(
            cfg, "cuda", params=params, push_params=push, n_prompts=CHAOS_PUSH_PROMPTS,
            max_new_tokens=CHAOS_NEW_TOKENS, inflight=True,
            engine_kw=dict(max_decode_batch=FABRIC_SLOTS, kv_pool_pages=FABRIC_POOL_PAGES,
                           prefill_chunk_tokens=FABRIC_PREFILL_TOKENS),
            report=rc)
        del push
        check(not fails, f"[chaos] (c) {fails}")
        lc = rc["launches"]
        check(lc["k2"] == L * rc["inner_steps"] > 0 and lc["fwd"] == lc["k3"] == lc["k4"] == 0,
              f"[chaos] (c) launches {lc} != {L} x {rc['inner_steps']} inner steps on K2 alone")
        add(lc)
        log(f"[chaos] (c) the corrupted push refused (the checksum reduced on the card), the "
            f"version stayed, flight dump {os.path.basename(rc['flight_dump'])}; the retry served "
            f"v{rc['version']}; {CHAOS_PUSH_PROMPTS} prompts' greedy tokens equal the control's; "
            f"K2 {lc['k2']} = {L} x {rc['inner_steps']} inner steps")
        done("c", t0)
        gc.collect()
        torch.cuda.empty_cache()

        # (e) A server killed mid-decode in a discovered fleet.
        t0 = time.monotonic()
        re_ = {}
        made = []

        def serving_plane(engine):
            engine.static_path_max_new = 0  # every call on the serving plane, as in push
            made.append(engine)

        launches0 = _trial_counts()
        fails = ca.check_chaos(
            cfg, "cuda", n_prompts=CHAOS_PROMPTS, kill_after_s=CHAOS_KILL_S,
            max_new_tokens=CHAOS_STREAM_NEW_TOKENS, params=params,
            engine_kw=dict(kv_pool_pages=FABRIC_POOL_PAGES,
                           prefill_chunk_tokens=FABRIC_PREFILL_TOKENS),
            on_engine=serving_plane, report=re_)
        le = {k: v - launches0[k] for k, v in _trial_counts().items()}
        check(not fails, f"[chaos] (e) {fails}")
        inner = sum(e.steps_total for e in made)
        check(len(made) == 3 and le["k2"] == L * inner > 0 and le["fwd"] == le["k4"] == 0,
              f"[chaos] (e) launches {le} over {len(made)} engines: K2 != {L} x {inner} inner "
              "steps, or K1f/K4 ran")
        add(le)
        log(f"[chaos] (e) {re_['stat']}; breaker opened x{re_['opens']} and closed x"
            f"{re_['closes']}; lineage {re_['lineage']['complete']}/{re_['lineage']['n']} "
            f"complete; K2 {le['k2']} = {L} x {inner} inner steps over 3 engines, K3 "
            f"{le['k3']} (replays of the healed fleet's push)")
        log("[chaos] (e) trace_report --flight:\n" + re_["rendered"])
        shutil.rmtree(re_["trace_dir"], ignore_errors=True)
        done("e", t0)

        d_thread.join(timeout=1200)
        check(not d_thread.is_alive(), "[chaos] (d) did not finish")
        check(not d_out["fails"], f"[chaos] (d) {d_out['fails']}")
        out["seconds"]["d"] = d_out["seconds"]
        log(f"[chaos] (d) exit codes {rd['rcs']}; runs "
            + ", ".join(f"{k} {v:.1f} s" for k, v in rd["seconds"].items())
            + f"; {d_out['seconds']:.1f} s beside (a)-(c) and (e)")
    finally:
        if d_thread is not None:  # its processes end by their own time limits
            d_thread.join(timeout=1800)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"]["phase"] = time.monotonic() - t_phase
    log(f"[chaos] {card}: parts " + ", ".join(f"({k}) {v:.1f} s" for k, v in
                                              out["seconds"].items()))
    log(f"[chaos] the phase's launches: {out['launches']}")
    report["chaos"] = out


# --------------------------------------------------------------------------
# Phase: MoE and the mixtral and gpt2 families
# --------------------------------------------------------------------------

FAMILIES_DIR = os.path.join(REPO, ".families_tmp")
# mistralai/Mixtral-8x7B-v0.1's config.json (its model-shape keys).
MIXTRAL_8X7B = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"], "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "vocab_size": 32000, "max_position_embeddings": 32768, "rope_theta": 1e6,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "hidden_act": "silu", "bos_token_id": 1, "eos_token_id": 2,
    "torch_dtype": "bfloat16",
}
# openai-community/gpt2's config.json (GPT-2 small; n_inner null = 4 x 768).
GPT2_SMALL = {
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], "n_layer": 12, "n_embd": 768,
    "n_head": 12, "n_inner": None, "n_positions": 1024, "n_ctx": 1024, "vocab_size": 50257,
    "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new", "bos_token_id": 50256,
    "eos_token_id": 50256,
}
# Mixtral's depth in (b) and (c): 1 of its 32 layers (1,713.4 M parameters:
# a 6.85 GB fp32 checkpoint, two shards and an index).  At 2 layers (a
# 12.66 GB checkpoint) the phase read 104.9 s on an H100, (b) 33.2 s of it.
FAMILIES_MIXTRAL_LAYERS = 1
FAMILIES_PROMPTS = 16  # (c)'s and (d)'s burst: the serve phase's 16 requests
FAMILIES_NEW_TOKENS = 128
# (a): fp32 dispatches differ from the dense oracle by summation order
# only: within 1e-4 of the output's scale (its largest |value|).  bf16:
# grouped rounds each expert's output, its weighted value and the sum
# over k to bf16, the oracle its expert outputs and the combine (half a
# bf16 ulp, 2**-8 of a value, each): each output row within 2**-5 (four
# ulps at the row's largest |oracle| value).
MOE_FP32_TOL = 1e-4
MOE_BF16_ROW_TOL = 2**-5
MOE_TOKENS = (64, 8192)  # (a)'s timed token counts
# (c): teacher-forced logits of two bf16 runs that differ by rounding
# only (static against serving forwards; grouped against the dense
# oracle): the median row's error within 2**-5 of the row's largest
# |logit|; a router choice that flips at a near-tie changes its token's
# row by far more, so the largest rows are printed, not held.  Argmax
# agreement along the run >= 0.85 (INT8_AGREEMENT's bound).
FAMILY_LOGIT_TOL = 2**-5


def _family_cfg(hf_config, n_layers=None):
    """The port's config read from a published config.json by the
    family's own reader, its depth cut to `n_layers`."""
    from areal_tpu_torch.models.hf import registry as hf

    cfg = hf.get_family(hf_config["model_type"]).config_from_hf(hf_config)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)


def _moe_bound(T, cfg, dispatch, used_experts):
    """The least time of one MoE MLP call on T tokens in bf16: the
    products it computes (2 flops a multiply-add: the three expert
    products on T*k rows for grouped, on T rows of every expert for the
    oracle, on E*C capacity slots plus the one-hot dispatch and combine
    products for topk) at the bf16 tensor rate, against the expert
    weights it reads (the experts this run's routing used, for grouped;
    all of them otherwise), the router, x in and out back at the HBM
    rate."""
    D, F_, E, k = cfg.hidden_dim, cfg.moe_intermediate_dim, cfg.n_experts, cfg.n_experts_per_tok
    router = 2 * T * D * E
    if dispatch == "grouped":
        flops, experts = 6 * T * k * D * F_ + router, used_experts
    elif dispatch == "dense":
        flops, experts = 6 * T * E * D * F_ + router, E
    else:
        cap = max(int(math.ceil(T * k / E * cfg.moe_capacity_factor)), 1)
        flops, experts = 6 * E * cap * D * F_ + 4 * T * E * cap * D + router, E
    nbytes = 2 * (3 * experts * D * F_ + D * E + 2 * T * D)
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops


def _moe_kept_reference(x, blk, top_w, top_idx, kept):
    """The MoE output of the routing choices `kept` [T, k] (bool) alone,
    in fp32: each expert on the rows that chose it and were kept, scaled
    by the routing weight and added into its token."""
    import torch
    import torch.nn.functional as F

    x = x.float()
    out = torch.zeros_like(x)
    for e in range(blk["wg"].shape[0]):
        tok, j = torch.nonzero((top_idx == e) & kept, as_tuple=True)
        if tok.numel():
            xe = x[tok]
            y = (F.silu(xe @ blk["wg"][e].float()) * (xe @ blk["wu"][e].float())) @ blk["wd"][e].float()
            out.index_add_(0, tok, y * top_w[tok, j, None].float())
    return out


def _families_moe(seed):
    """(a) One MoE MLP at Mixtral-8x7B's width (D 4096, 8 experts of FFN
    14336, top-2) on seeded inputs."""
    import numpy as np
    import torch

    from areal_tpu_torch.models import transformer as tfm

    cfg = _family_cfg(MIXTRAL_8X7B, 1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 240)

    def dense(shape, fan_in):
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * fan_in**-0.5).to(torch.bfloat16)

    D, E, F_ = cfg.hidden_dim, cfg.n_experts, cfg.moe_intermediate_dim
    blk = {"router": dense((D, E), D), "wg": dense((E, D, F_), D), "wu": dense((E, D, F_), D),
           "wd": dense((E, F_, D), F_)}
    blk32 = {k: v.float() for k, v in blk.items()}
    cfgs = {
        "dense": dataclasses.replace(cfg, moe_dispatch="dense"),
        "topk_cfE": dataclasses.replace(cfg, moe_dispatch="topk", moe_capacity_factor=float(E)),
        "grouped": dataclasses.replace(cfg, moe_dispatch="grouped"),
    }
    out = {"errs": {}, "times": {}}
    T0 = MOE_TOKENS[0]
    x32 = torch.randn((1, T0, D), generator=gen, device=dev)
    for dname, x, weights in (("fp32", x32, blk32), ("bf16", x32.to(torch.bfloat16), blk)):
        res = {name: tfm._mlp(x, weights, c) for name, c in cfgs.items()}
        route = [tfm._moe_route(x.reshape(-1, D), weights, c) for c in cfgs.values()]
        torch.cuda.synchronize()
        oracle, aux = res["dense"]
        check(all(torch.equal(r[1], route[0][1]) and torch.equal(r[0], route[0][0])
                  for r in route), f"[families] (a) {dname}: the routing differs by dispatch")
        check(len({float(a) for _, a in res.values()}) == 1,
              f"[families] (a) {dname}: the aux differs by dispatch "
              f"{ {n: float(a) for n, (_, a) in res.items()} }")
        scale = float(oracle.float().abs().max())
        for name in ("topk_cfE", "grouped"):
            got = res[name][0]
            check(bool(torch.isfinite(got).all()), f"[families] (a) {dname} {name}: non-finite")
            if dname == "fp32":
                err = float((got - oracle).abs().max())
                out["errs"][f"fp32_{name}"] = err / scale
                log(f"[families] (a) fp32 {name} against the dense oracle at T={T0}: "
                    f"max_abs_err={err:.3e}, {err / scale:.3e} of the output's scale "
                    f"{scale:.3e} (tolerance {MOE_FP32_TOL:g})")
                check(err <= MOE_FP32_TOL * scale, f"[families] (a) fp32 {name} disagrees")
            else:
                rel, err = _row_err(got.reshape(T0, D), oracle.reshape(T0, D))
                out["errs"][f"bf16_{name}_row"] = rel
                log(f"[families] (a) bf16 {name} against the dense oracle at T={T0}: "
                    f"row_err={rel:.3e} (tolerance {MOE_BF16_ROW_TOL:.3e}), max_abs_err={err:.3e}")
                check(rel <= MOE_BF16_ROW_TOL, f"[families] (a) bf16 {name} disagrees")
        log(f"[families] (a) {dname}: routing and aux ({float(aux):.6f}) identical across "
            f"the three dispatches")
    # topk at capacity factor 0.5 drops exactly the choices a host recount
    # of the rule drops (choice-slot-major queues, cap slots an expert).
    c05 = dataclasses.replace(cfg, moe_dispatch="topk", moe_capacity_factor=0.5)
    top_w, top_idx, _, _ = tfm._moe_route(x32.reshape(-1, D), blk32, c05)
    cap = int(math.ceil(T0 * cfg.n_experts_per_tok / E * 0.5))
    idx = top_idx.cpu().numpy()
    kept, fill = np.zeros(idx.shape, bool), [0] * E
    for j in range(idx.shape[1]):
        for t in range(idx.shape[0]):
            kept[t, j] = fill[idx[t, j]] < cap
            fill[idx[t, j]] += 1
    got = tfm._mlp(x32, blk32, c05)[0].reshape(T0, D)
    want = _moe_kept_reference(x32.reshape(T0, D), blk32, top_w, top_idx,
                               torch.from_numpy(kept).to(dev))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    n_drop = int((~kept).sum())
    out["errs"]["fp32_topk_cf0.5_dropped"] = err / scale
    log(f"[families] (a) fp32 topk at capacity factor 0.5 (cap {cap}): {n_drop} of "
        f"{kept.size} choices dropped by the host recount; the output against the kept "
        f"choices' reference: max_abs_err={err:.3e}, {err / scale:.3e} of its scale")
    check(n_drop > 0 and err <= MOE_FP32_TOL * scale,
          "[families] (a) topk at capacity factor 0.5 drops other choices than the rule")
    del blk32, got, want
    # No host sync in any dispatch's forward, nor in grouped's backward.
    xb = x32.to(torch.bfloat16)
    for name, c in cfgs.items():
        no_host_sync(f"(a) {name} forward (bf16, T={T0})", lambda c=c: tfm._mlp(xb, blk, c),
                     tag="[families]")
    xg = xb.clone().requires_grad_(True)
    wg = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
    y, aux = tfm._mlp(xg, wg, cfgs["grouped"])
    dy = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
    no_host_sync(f"(a) grouped backward (bf16, T={T0})", lambda: torch.autograd.backward(
        [y, aux], [dy, torch.ones_like(aux)]), tag="[families]")
    check(all(bool(torch.isfinite(w.grad).all()) for w in wg.values()),
          "[families] (a) grouped backward: non-finite grads")
    del xg, wg, y, dy
    # bf16 device times of each dispatch (CUDA-graph replays) beside the bound.
    timed = dict(cfgs, topk=dataclasses.replace(cfg, moe_dispatch="topk"))
    timed.pop("topk_cfE")
    for T in MOE_TOKENS:
        x = torch.randn((1, T, D), generator=gen, device=dev).to(torch.bfloat16)
        used = int(torch.unique(tfm._moe_route(x.reshape(-1, D), blk, cfg)[1]).numel())
        for name, c in timed.items():
            ms = time_graph(lambda c=c: tfm._mlp(x, blk, c), iters=10)
            bound, by, flops = _moe_bound(T, c, name, used)
            out["times"][f"{name}_T{T}"] = dict(ms=ms, bound_ms=bound, bound_by=by,
                                                 tflops_per_s=flops / ms / 1e9)
            log(f"[families] (a) {name} bf16 T={T}: {ms:.3f} ms (CUDA-graph replays), bound "
                f"{bound:.3f} ms ({by}; {flops / 1e12:.3f} TFLOP, {used} experts used), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        del x
    del blk
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _families_holds(seed):
    """(e) K1f/K1dq/K1dkv, K2 and K4 against their plain versions at the
    two new head layouts, bf16: Mixtral's 32 q heads over 8 kv heads of
    128 and GPT-2's 12 over 12 of 64."""
    import numpy as np
    import torch

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.ops.attention import decode_attention_chunk

    dev, bf = torch.device("cuda"), torch.bfloat16
    errs = {}
    for lname, (hq, hkv, d) in (("mixtral", (32, 8, 128)), ("gpt2", (12, 12, 64))):
        t0 = time.monotonic()
        rng = np.random.default_rng(seed + 250)
        b, s = 2, 2048
        seg_np, _ = _packed_rows(rng, b, s)
        seg = torch.from_numpy(seg_np).to(dev)
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                       .to(dev).to(bf) for h in (hq, hkv, hkv, hq))
        flash = _hold_flash(f"families {lname} {hq}/{hkv} D={d}", q, k, v, seg, do,
                            FLASH_ROW_TOL["bf16"])
        for o, (rel, _) in flash.items():
            errs[f"{lname}_flash_{o}_row"] = rel
        k2, _, _ = _hold_k2(f"families {lname} {hq}/{hkv} D={d}",
                            _stream(seed + 251, heads=(hq, hkv, d)), poison=False)
        errs[f"{lname}_k2_bf16"] = k2["bf16"]
        t2 = time.monotonic()
        # K4 at the static decode step: 32 rows of a 1024 cache, windows
        # of 64-512 prompt tokens right-aligned at 512, 64 tokens out.
        plen = rng.integers(64, 513, 32)
        vf = torch.from_numpy((512 - plen).astype(np.int32)).to(dev)
        vt = torch.full((32,), 576, dtype=torch.int32, device=dev)
        qd = torch.from_numpy(rng.standard_normal((32, 1, hq, d)).astype(np.float32)).to(dev)
        kc, vc = (torch.from_numpy(rng.standard_normal((32, 1024, hkv, d)).astype(np.float32))
                  .to(dev) for _ in range(2))
        full = torch.ones((32,), dtype=torch.long, device=dev)
        for tname, cast, tol in (("fp32", lambda x: x, FLASH_ROW_TOL["fp32"]),
                                 ("bf16", lambda x: x.to(bf), FLASH_ROW_TOL["bf16"])):
            got = da.decode_attention_chunk_kernel(cast(qd), cast(kc), cast(vc), vf, vt)
            want = decode_attention_chunk(cast(qd).float(), cast(kc).float(), cast(vc).float(),
                                          vf.long(), vt.long(), full)
            rel, err = _row_err(got, want)
            errs[f"{lname}_k4_{tname}_row"] = rel
            log(f"[families] K4 {lname} {hq}/{hkv} D={d} {tname} (32 rows, windows to 576 "
                f"of 1024): row_err={rel:.3e} (tolerance {tol:.3e}) max_abs_err={err:.3e}")
            check(rel <= tol, f"[families] K4 {lname} {tname} disagrees with the plain version")
        log(f"[families] (e) {lname}: flash and K2 {t2 - t0:.1f} s, K4 {time.monotonic() - t2:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _family_burst(tag, cfg, params, prompts, n, max_new, eos, serving, seed):
    """The burst (every prompt at once, n greedy responses of max_new
    tokens) through GenerationServer over a default engine: on the
    serving plane (`serving`: static_path_max_new 0; its second decode
    chunk under set_sync_debug_mode("error"); K2 = L x inner steps) or
    on the static path (one static chunk: K1f = L x chunks, K4 = L x
    decode steps; its second decode_step under the sync debug mode).
    Counts are set to 0 just before the burst and read just after."""
    import torch

    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.gen_server import GenerationServer

    engine = GeneratorEngine(cfg, params, eos_token_id=eos)
    check(engine.device.type == "cuda", f"{tag}: the engine is not on the card")
    held, calls = {}, [0]
    if serving:
        engine.static_path_max_new = 0
        real = engine._get_serving_chunk_fn
    else:
        real = tfm.decode_step

    def under_sync_check(fn):
        def run(*a, **k):
            calls[0] += 1
            if calls[0] != 2:  # the second call: kernels loaded, warm
                return fn(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **k)
                held["ok"] = True
                return out
            except RuntimeError as e:
                held["error"] = repr(e)
                raise
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    if serving:
        engine._get_serving_chunk_fn = lambda *a, **k: under_sync_check(real(*a, **k))
    else:
        tfm.decode_step = under_sync_check(real)
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        torch.cuda.synchronize()
        steps0, chunks0, dsteps0 = (engine.steps_total, engine.static_chunks,
                                    engine.static_decode_steps)
        _reset_counts()
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts, n, max_new, seed, greedy=True)
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _trial_counts()
    finally:
        if not serving:
            tfm.decode_step = real
        server.close()
    check(not errors and all(r is not None for r in replies), f"{tag}: requests failed: "
          f"{errors[:3]}")
    check(held.get("ok") and "error" not in held, f"{tag}: a decode chunk or step "
          f"synchronised with the host: {held}")
    outputs, n_tok = [], 0
    for i, r in enumerate(replies):
        check(len(r["output_ids"]) == n, f"{tag} q{i}: {len(r['output_ids'])} outputs")
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(0 < len(ids) <= max_new and (len(ids) == max_new or ids[-1] == eos),
                  f"{tag} q{i}: {len(ids)} tokens")
            check(len(lps) == len(ids) and all(math.isfinite(x) for x in lps),
                  f"{tag} q{i}: bad logprobs")
            check(all(0 <= x < cfg.vocab_size for x in ids), f"{tag} q{i}: id out of vocab")
            n_tok += len(ids)
        outputs.append(r["output_ids"])
    L = cfg.n_layers
    if serving:
        steps = engine.steps_total - steps0
        want = dict(fwd=L * engine.prefill_dispatches, dq=0, dkv=0, k2=L * steps, k3=0, k4=0)
        what = f"{steps} inner steps"
    else:
        chunks = engine.static_chunks - chunks0
        steps = engine.static_decode_steps - dsteps0
        want = dict(fwd=L * chunks, dq=0, dkv=0, k2=0, k3=0, k4=L * steps)
        what = f"{chunks} static chunk(s), {steps} decode steps"
        check(chunks == 1, f"{tag}: {chunks} static chunks, want 1")
    log(f"{tag}: {len(prompts)} requests x n={n} greedy: {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tok/s; {what}; launches {counts}; call 2 under "
        f"set_sync_debug_mode('error'): no host sync")
    check(counts == want, f"{tag}: launches {counts} != {want}")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(outputs=outputs, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                steps=steps, launches=counts)


def _family_trial(tag, work, ckpt, cfg, seed, n_steps, extra=()):
    """`quickstart.main(["ppo-math", ...])` from checkpoint `ckpt`: 8
    prompts x 4, 128 new tokens, a ref with --offload-ref, kl_ctl 0.1,
    `n_steps` steps, rewards replaced by seeded +-5 (a random model's are
    all -5).  Launches of each step = L x the engines' calls
    (_check_step_launches); every stat finite."""
    import functools

    import numpy as np
    import torch

    from areal_tpu_torch.apps import quickstart
    from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface

    rng = np.random.default_rng(seed)
    data = os.path.join(work, "math.jsonl")
    with open(data, "w") as f:
        for row in _math_rows(rng, 64):
            f.write(json.dumps(row) + "\n")
    rec, cur, restore = {"steps": [], "loads": [], "saves": []}, {}, []

    def wrap(owner, name, make):
        orig = getattr(owner, name)
        restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_reward(orig):
        @functools.wraps(orig)
        def inference(self, model, sample, mb_spec):
            out = orig(self, model, sample, mb_spec)
            out.data["rewards"] = rng.choice(
                [-5.0, 5.0], size=out.data["rewards"].shape).astype(np.float32)
            return out
        return inference

    argv = ["ppo-math", "--model.path", ckpt, "--dataset.path", data,
            "--tokenizer-path", f"char:{cfg.vocab_size}", "--ref-path", ckpt, "--offload-ref",
            "--kl-ctl", "0.1", "--batch-size", "8", "--group-size", "4",
            "--max-new-tokens", str(FAMILIES_NEW_TOKENS), "--benchmark-steps", str(n_steps),
            "--fileroot", os.path.join(work, "trial"), "--seed", str(seed), *extra]
    log(f"{tag} python -m areal_tpu_torch.apps.quickstart {' '.join(argv)}")
    try:
        _record_trial_steps(wrap, rec, cur)
        _record_checkpoint_io(wrap, rec)
        wrap(MultiTaskRewardInterface, "inference", on_reward)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.monotonic()
        stats = quickstart.main(argv)
        torch.cuda.synchronize()
        trial_s = time.monotonic() - t0
        total = _trial_counts()
    finally:
        for owner, name, orig in reversed(restore):
            setattr(owner, name, orig)
    check(len(stats) == n_steps == len(rec["steps"]), f"{tag} {len(stats)} steps of stats")
    check(len(rec["loads"]) == 3, f"{tag} {len(rec['loads'])} checkpoint loads, want 3")
    steps = []
    for i, st in enumerate(rec["steps"]):
        s = st["stats"]
        check(all(math.isfinite(v) for v in s.values()), f"{tag} step {i + 1}: non-finite "
              f"stats {[k for k, v in s.items() if not math.isfinite(v)]}")
        _check_step_launches(tag, i + 1, st, rec["plan_nodes"], cfg.n_layers,
                             FAMILIES_NEW_TOKENS)
        mfu = {k.split("/")[0]: s.get(k) for k in s if k.endswith("/perf/mfu")}
        first = st["train_calls"][0]["stats"]
        steps.append(dict(step_s=s["time/step_s"], mfu=mfu, peak_mem_bytes=st["peak_mem_bytes"],
                          first_importance_weight=first["importance_weight"],
                          first_approx_kl=first["approx_kl"],
                          actor_loss=s["actor_train/actor_loss"],
                          grad_norm=s["actor_train/grad_norm"], launches=st["launches"]))
        log(f"{tag} step {i + 1}: {s['time/step_s']:.2f} s; MFU {mfu}; first minibatch "
            f"importance_weight {first['importance_weight']:.6f} approx_kl "
            f"{first['approx_kl']:.3e}; actor_loss {s['actor_train/actor_loss']:.4e} grad_norm "
            f"{s['actor_train/grad_norm']:.4f}; peak {st['peak_mem_bytes'] / 2**30:.2f} GiB")
    check(total == {k: sum(st["launches"][k] for st in rec["steps"]) for k in total}
          and all(total[k] > 0 for k in ("fwd", "dq", "dkv", "k4")),
          f"{tag} launches over the trial {total}: outside the steps, or a kernel never ran")
    log(f"{tag} trial {trial_s:.1f} s; checkpoint loads "
        f"{['%.2f s' % x for x in rec['loads']]}; launches {total}")
    return dict(steps=steps, launches=total, trial_s=trial_s, loads_s=rec["loads"])


def _family_checkpoint(tag, work, cfg, seed, model_type):
    """Seeded random weights (init_params on the card) written through the
    family's save_hf_checkpoint; the reload (fp32) equals them bit for
    bit.  Returns (path, params, write seconds, bytes)."""
    import torch

    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.transformer import init_params

    ckpt = os.path.join(work, "ckpt")
    params = init_params(cfg, seed, device="cuda")
    t0 = time.monotonic()
    hf.save_hf_checkpoint(ckpt, cfg, params, model_type=model_type)
    write_s = time.monotonic() - t0
    files = sorted(os.listdir(ckpt))
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
    t0 = time.monotonic()
    cfg_back, back = hf.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    check(cfg_back == cfg, f"{tag} the reloaded config differs: {cfg_back}")
    back = dict(_flat_params(back))
    bad = [name for name, x in _flat_params(params) if not torch.equal(back[name], x.float())]
    check(not bad, f"{tag} the reload differs from the written leaves: {bad[:4]}")
    log(f"{tag} wrote a seeded random {model_type} checkpoint ({cfg.n_layers} layers) with "
        f"save_hf_checkpoint: {nbytes / 1e9:.3f} GB fp32 in {write_s:.2f} s "
        f"({nbytes / 1e9 / write_s:.2f} GB/s): {files}; reloaded in fp32 in {load_s:.2f} s, "
        f"every leaf bit for bit")
    del back
    return ckpt, params, write_s, nbytes, files


def _family_agreement(tag, cfg, params, prompts, serving, others, envelope=False):
    """(c)'s holds: free-running greedy agreement of each of `others`
    ({name: (run, config, paged)}: the static path, the dense-oracle
    engine) with the serving plane (printed), and the teacher-forced
    logits along the serving run's responses: the dense window (the
    static path's forwards, K1f + K4) and the dense-oracle dispatch
    against the paged forwards (K2's kernel), each's median row error
    within FAMILY_LOGIT_TOL and argmax agreement >= INT8_AGREEMENT.
    With `envelope` (a deep dense model, whose bf16 rounding grows with
    depth), the bf16 bound is instead the larger of FAMILY_LOGIT_TOL and
    the median row error of the bf16 paged forwards against the model's
    in fp32 (the two bf16 paths share every GEMM's rounding, so they
    differ by less than either differs from fp32), and the same two
    paths in fp32 are held within FP32_PAIR_TOL (`_fp32_holds`)."""
    import numpy as np
    import torch

    out = {}
    for name, (other, _, _) in others.items():
        packed, resp, flips = _agreement(list(zip(prompts, serving["outputs"])),
                                         other["outputs"])
        out[f"{name}_free_running"] = resp
        log(f"{tag} {name} against the serving plane, free-running greedy: token agreement "
            f"{packed:.4f} over prompt + response, {resp:.4f} over the responses; first "
            f"differing position: median {int(np.median(flips))}, min {min(flips)}")
    resp_ids = [o[0] for o in serving["outputs"]]
    base = _teacher_forced_logits(cfg, params, prompts, resp_ids, True, torch.bfloat16)
    run = torch.tensor([r[: base.shape[1]] for r in resp_ids], device=base.device)
    out["serving_reproduced"] = float((base.argmax(-1) == run).float().mean())
    tol = FAMILY_LOGIT_TOL
    if envelope:
        out.update(_fp32_holds(tag, cfg, params, prompts, resp_ids, base))
        tol = max(FAMILY_LOGIT_TOL, out["bf16_envelope"])
    out["logit_row_tol"] = tol
    for name, (_, c, paged) in others.items():
        other = _teacher_forced_logits(c, params, prompts, resp_ids, paged, torch.bfloat16)
        err = (other - base).abs().amax(-1) / base.abs().amax(-1)
        q = torch.quantile(err.flatten(), torch.tensor([0.5, 0.9, 1.0], device=err.device))
        agree = float((other.argmax(-1) == base.argmax(-1)).float().mean())
        out[f"{name}_teacher_forced"] = agree
        out[f"{name}_logit_row_err"] = [float(x) for x in q]
        log(f"{tag} {name} against the paged forwards, teacher-forced along the serving "
            f"run's responses: argmax agreement {agree:.4f} (bound {INT8_AGREEMENT}); logits "
            f"row error median {float(q[0]):.3e} (tolerance {tol:.3e}), p90 "
            f"{float(q[1]):.3e}, max {float(q[2]):.3e}")
        check(agree >= INT8_AGREEMENT and float(q[0]) <= tol,
              f"{tag} {name}: teacher-forced logits disagree with the paged forwards")
        del other
    log(f"{tag} the serving run's own tokens reproduced teacher-forced at "
        f"{out['serving_reproduced']:.4f}")
    return out


# The static path's forwards (K1f, K4) against the paged ones (K2) of one
# fp32 model, teacher-forced: each kernel's fp32 output is within 1e-4
# of its row (FLASH_ROW_TOL), and the bf16 pair's reading on an H100
# shows 18 layers amplifying a kernel's error ~10x (3.5e-2 against ~4e-3
# a kernel): 1e-3 on the median row.
FP32_PAIR_TOL = 1e-3


def _fp32_holds(tag, cfg, params, prompts, resp_ids, base):
    """The model with its weights in fp32 (fp32 caches; K1f, K2 and K4 in
    fp32), teacher-forced along the same responses on the paged and the
    dense path: their median row error within FP32_PAIR_TOL; and the
    bf16 paged forwards `base` against the fp32 paged ones (the bf16
    rounding the model carries at its depth: `bf16_envelope`)."""
    import torch

    p32 = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    c32 = dataclasses.replace(cfg, param_dtype="float32")
    ref = _teacher_forced_logits(c32, p32, prompts, resp_ids, True, torch.float32)
    out = {}

    def row_err(got, want):
        err = (got - want).abs().amax(-1) / want.abs().amax(-1)
        q = torch.quantile(err.flatten(), torch.tensor([0.5, 0.9, 1.0], device=err.device))
        return [float(x) for x in q], float((got.argmax(-1) == want.argmax(-1)).float().mean())

    (med, p90, mx), agree = row_err(base, ref)
    out["bf16_envelope"], out["bf16_fp32_agreement"] = med, agree
    log(f"{tag} the bf16 paged forwards against the fp32 model's, teacher-forced: argmax "
        f"agreement {agree:.4f}; logits row error median {med:.3e}, p90 {p90:.3e}, max {mx:.3e}")
    dense = _teacher_forced_logits(c32, p32, prompts, resp_ids, False, torch.float32)
    del p32
    (med, p90, mx), agree = row_err(dense, ref)
    out["fp32_pair_row_err"], out["fp32_pair_agreement"] = [med, p90, mx], agree
    log(f"{tag} fp32: the static path's forwards against the paged ones, teacher-forced: argmax "
        f"agreement {agree:.4f}; logits row error median {med:.3e} (tolerance "
        f"{FP32_PAIR_TOL:g}), p90 {p90:.3e}, max {mx:.3e}")
    check(med <= FP32_PAIR_TOL, f"{tag} fp32: the static path's forwards disagree with the "
          "paged ones")
    del ref, dense
    return out


def _family_prompts(cfg, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
            for _ in range(FAMILIES_PROMPTS)]


def phase_families(report, seed):
    """MoE and the mixtral and gpt2 families on the card, at published
    widths with seeded random weights (mistral is llama's model under its
    own config reader, with (b)'s attention layout: it is held on the
    CPU only, tests/test_torch_hf_families.py):
    (a) one MoE MLP at Mixtral-8x7B's width: grouped and topk (capacity
        factor E) against the dense oracle in fp32 and bf16, routing and
        aux identical; topk at capacity factor 0.5 against a host recount
        of its drops; no host sync in each dispatch's forward and in
        grouped's backward; bf16 device times at T=64 and 8192 beside
        the bound;
    (b) a 1-layer Mixtral-8x7B checkpoint written through the mixtral
        family (the reload bit for bit), then `quickstart ppo-math` from
        it, 2 GRPO steps with --master-dtype bfloat16 and an offloaded
        ref: finite stats, exact K1f/K1dq/K1dkv/K4 launches, each MFC's
        MFU;
    (c) a GenerationServer from that checkpoint serves the serve cell's
        burst on the serving plane (K2) and as one static chunk (K1f,
        K4), and a dense-oracle engine the burst again; the three held
        against each other (`_family_agreement`);
    (d) GPT-2 small at full depth: a gpt2 checkpoint, one quickstart
        step (char:50257) and a serving-plane burst;
    (e) K1f/K1dq/K1dkv, K2 and K4 against their plain versions at
        Mixtral's 32/8 heads of 128 and GPT-2's 12/12 of 64."""
    import shutil

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    log(f"[families] torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_phase = time.monotonic()
    secs = {}
    out = {}
    launches = dict(fwd=0, dq=0, dkv=0, k2=0, k3=0, k4=0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def done(part, t0):
        secs[part] = time.monotonic() - t0
        log(f"[families] ({part}) {secs[part]:.1f} s")

    t0 = time.monotonic()
    out["moe"] = _families_moe(seed)
    done("a", t0)
    t0 = time.monotonic()
    out["holds"] = _families_holds(seed)
    done("e", t0)

    os.makedirs(FAMILIES_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run-", dir=FAMILIES_DIR)
    try:
        cfg = _family_cfg(MIXTRAL_8X7B, FAMILIES_MIXTRAL_LAYERS)
        t0 = time.monotonic()
        # The fp32 checkpoint (6.85 GB at 1 layer) and the trial's logs.
        _check_disk("[families]", work, 4 * (cfg.vocab_size * cfg.hidden_dim * 2 + cfg.n_layers * (
            cfg.hidden_dim * (2 * cfg.q_dim + 2 * cfg.kv_dim + cfg.n_experts)
            + 3 * cfg.n_experts * cfg.hidden_dim * cfg.moe_intermediate_dim)) + 2 * 2**30)
        ckpt, params, write_s, nbytes, files = _family_checkpoint(
            "[families] (b)", work, cfg, seed + 260, "mixtral")
        check(len([f for f in files if f.endswith(".safetensors")]) > 1
              and "model.safetensors.index.json" in files,
              f"[families] (b) the checkpoint is not shards and an index: {files}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        trial = _family_trial("[families] (b)", work, ckpt, cfg, seed + 261, 2,
                              ("--master-dtype", "bfloat16"))
        add(trial["launches"])
        out["mixtral_trial"] = dict(trial, ckpt_write_s=write_s, ckpt_bytes=nbytes)
        done("b", t0)

        t0 = time.monotonic()
        from areal_tpu_torch.models.hf import registry as hf

        _, params = hf.load_hf_checkpoint(ckpt)
        prompts = _family_prompts(cfg, seed + 262)
        runs = {}
        for name, c, serving in (("serving", cfg, True), ("static", cfg, False),
                                 ("dense_oracle", dataclasses.replace(cfg, moe_dispatch="dense"),
                                  True)):
            runs[name] = _family_burst(f"[families] (c) mixtral {name}", c, params, prompts,
                                       4, FAMILIES_NEW_TOKENS, MIXTRAL_8X7B["eos_token_id"],
                                       serving, seed + 263)
            add(runs[name]["launches"])
        out["mixtral_serve"] = dict(
            agreement=_family_agreement(
                "[families] (c) mixtral", cfg, params, prompts, runs["serving"],
                {"static": (runs["static"], cfg, False),
                 "dense_oracle": (runs["dense_oracle"],
                                  dataclasses.replace(cfg, moe_dispatch="dense"), True)}),
            **{name: {k: v for k, v in r.items() if k != "outputs"} for name, r in runs.items()})
        del params, runs
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        done("c", t0)

        t0 = time.monotonic()
        work = tempfile.mkdtemp(prefix="run-", dir=FAMILIES_DIR)
        g2 = _family_cfg(GPT2_SMALL)
        ckpt, params, write_s, nbytes, _ = _family_checkpoint(
            "[families] (d)", work, g2, seed + 270, "gpt2")
        trial = _family_trial("[families] (d) gpt2", work, ckpt, g2, seed + 271, 1)
        add(trial["launches"])
        serve = _family_burst("[families] (d) gpt2 serving", g2, params,
                              _family_prompts(g2, seed + 272), 4, FAMILIES_NEW_TOKENS,
                              GPT2_SMALL["eos_token_id"], True, seed + 273)
        add(serve["launches"])
        serve.pop("outputs")
        out["gpt2"] = dict(trial=trial, serve=serve, ckpt_write_s=write_s, ckpt_bytes=nbytes)
        del params
        done("d", t0)
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    secs["phase"] = time.monotonic() - t_phase
    out.update(launches=launches, seconds=secs)
    log(f"[families] {card}: parts " + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()))
    log(f"[families] the phase's launches (the main paths of (b)-(d)): {launches}")
    report["families"] = out


GEMMA_DIR = os.path.join(REPO, ".gemma_tmp")
# google/gemma-2b's and google/gemma-7b's config.json (their model-shape keys).
GEMMA_2B = {
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "vocab_size": 256000,
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "hidden_act": "gelu", "hidden_activation": None, "tie_word_embeddings": True,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "bfloat16",
}
GEMMA_7B = dict(GEMMA_2B, hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
                num_attention_heads=16, num_key_value_heads=16)
GEMMA_LAYOUTS = {"gemma2b": (8, 1, 256), "gemma7b": (16, 16, 256)}  # n_q, n_kv, head_dim


def _gemma_times(tag, fns, bound, key=None):
    """Device and eager times of a kernel's wrapper, its plain version and
    its SDPA yardstick (`fns` as `timings` takes them), printed beside the
    bound."""
    t = timings(*fns, iters=10)
    log(f"[gemma] (a) {tag}: kernel_ms={t['kernel_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
        f"library_ms={t['library_ms']:.4f} (device, graph replays); eager calls "
        f"kernel={t['kernel_eager_ms']:.4f} plain={t['plain_eager_ms']:.4f} "
        f"library={t['library_eager_ms']:.4f}; bound_ms={bound[0]:.5f} ({bound[1]})")
    return dict(bound_ms=bound[0], bound_by=bound[1], **t)


def _gemma_flash(seed, lname, heads, timed):
    """K1f, K1dq, K1dkv at D=256: fp32 and bf16 against their plain
    versions at B=2 x S=2048 (segments of 64-640), the edge rows of
    _flash_edges at this layout (causal and not; bf16 also against the
    kernels' models); with `timed`, the table's B=4 x S=2048 in bf16 (and
    the fp32 kernels' device times) beside the bound and SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.ops.attention import make_packed_mask, packed_attention_reference

    dev = torch.device("cuda")
    hq, hkv, d = heads
    rng = np.random.default_rng(seed + 280)
    errs, times = {}, {}
    b, s = 2, 2048
    seg = torch.from_numpy(_packed_rows(rng, b, s)[0]).to(dev)
    base = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dev)
            for h in (hq, hkv, hkv, hq)]
    for dtype, tname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (x.to(dtype) for x in base)
        held = _hold_flash(f"gemma {lname} {hq}/{hkv} D={d} {tname}", q, k, v, seg, do,
                           FLASH_ROW_TOL[tname])
        for o, (rel, _) in held.items():
            errs[f"{tname}_{o}_row"] = rel
    del base, q, k, v, do
    edges = _flash_edges(seed + 281, [("seg256", hq, hkv, d, True), ("seg256", hq, hkv, d, False),
                                      ("seg40", hq, hkv, d, True)], tag="[gemma] (a)")
    errs.update({f"edges_{key}": val for key, val in edges.items()})
    if not timed:
        return errs, times
    b = 4
    seg_np, lens = _packed_rows(rng, b, s)
    seg = torch.from_numpy(seg_np).to(dev)
    seg32 = seg.to(torch.int32).contiguous()
    base = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dev)
            for h in (hq, hkv, hkv, hq)]
    bounds = _flash_bounds(lens, b, s, hq, hkv, d, 2)
    for dtype, tname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (x.to(dtype) for x in base)
        o, lse = fa.flash_fwd(q, k, v, seg32, True)
        delta = fa.flash_delta(o, do)
        kernels = {
            "fwd": lambda: fa.flash_fwd(q, k, v, seg32, True),
            "dq": lambda: fa.flash_dq(q, k, v, seg32, do, lse, delta, True),
            "dkv": lambda: fa.flash_dkv(q, k, v, seg32, do, lse, delta, True),
        }
        if tname == "fp32":  # the card-vs-CPU kernels: device time only
            for name, fn in kernels.items():
                times[f"fp32_{name}_ms"] = time_graph(fn, iters=10)
            log(f"[gemma] (a) K1 fp32 {lname} B={b} S={s}: device ms "
                + ", ".join(f"{n} {times[f'fp32_{n}_ms']:.4f}" for n in kernels))
            continue
        for name, fn in kernels.items():
            no_host_sync(f"K1{name} {lname} D={d}", fn, tag="[gemma] (a)")
        mask = make_packed_mask(seg)
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        dos = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

        def plain_bwd():
            return fa.flash_bwd_reference(q, k, v, seg, do, delta)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)

        plains = {"fwd": lambda: packed_attention_reference(q, k, v, seg), "dq": plain_bwd,
                  "dkv": plain_bwd}
        libs = {"fwd": sdpa, "dq": sdpa_fwd_bwd, "dkv": sdpa_fwd_bwd}
        for name in ("fwd", "dq", "dkv"):
            times[name] = _gemma_times(f"K1{name} bf16 {lname} B={b} S={s}",
                                       (kernels[name], plains[name], libs[name]), bounds[name])
        for name in ("dq", "dkv"):  # SDPA's backward: forward + backward less the forward
            for key in ("library_ms", "library_eager_ms"):
                times[name][key] -= times["fwd"][key]
        log(f"[gemma] (a) K1 {lname}: library dq/dkv = SDPA's backward (dq+dk+dv) "
            f"{times['dq']['library_ms']:.4f} ms; {len(lens)} segments, {sum(lens)} real tokens")
        del qs, ks, vs, dos
    return errs, times


def _gemma_split_kernels(seed, lname, heads, timed):
    """K2 (the 96-lane stream: fp32, bf16, fp32 q over int8, bf16 q over
    int8 via _hold_k2, then fp32 q over a bf16 pool and bf16 q over an
    fp32 pool against the plain version on fp32 copies), K3's chunk form
    (the replay's slots, or the Q=13 edge slots where the pool would be
    large; _hold_k3: fp32, bf16, fp32 q over int8, bf16 q over int8) and
    its Q=1 entry point (16 slots, equal to K2's wrapper), and K4 (the
    static decode step's 32 rows of S=1024 at Q=1, fp32, bf16, int8 and
    bf16 q over int8; Q=5 in bf16 and bf16 q over int8) at D=256; with
    `timed`, the bf16 and bf16q-int8 forms' times beside bound and SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.kernels import decode_attention as da
    from areal_tpu_torch.kernels import paged_chunk_attention as pca
    from areal_tpu_torch.kernels import ragged_paged_attention as rpa
    from areal_tpu_torch.ops.attention import (
        decode_attention_chunk,
        paged_decode_attention,
        paged_gather_layer,
    )
    from areal_tpu_torch.ops.quant import kv_dequant

    dev = torch.device("cuda")
    bf = torch.bfloat16
    n_q, n_kv, d = heads
    errs, times = {}, {}
    tag = f"gemma {lname} {n_q}/{n_kv} D={d}"
    # ---- K2
    st = _stream(seed + 282, mp=16 if timed else 2, heads=heads)  # 7B: a 2-page table
    e, t, cases = _hold_k2(tag, st, poison=True)
    errs.update({f"k2_{key}": val for key, val in e.items()})
    for name, (q, k, v) in (("fp32q_bf16", (t["q"], t["k"].to(bf), t["v"].to(bf))),
                            ("bf16q_fp32", (t["q"].to(bf), t["k"], t["v"]))):
        out = rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"])
        ref = rpa.ragged_paged_attention_reference(q.float(), k.float(), v.float(), t["pt"],
                                                   t["vt"])
        tol = FLASH_ROW_TOL["fp32" if q.dtype == torch.float32 else "bf16"]
        rel, err = _row_err(out, ref)
        errs[f"k2_{name}_row"] = rel
        log(f"[kernel] K2 {tag} {name}: row_err={rel:.3e} (tolerance {tol:.3e}) "
            f"max_abs_err={err:.3e}")
        check(bool(torch.isfinite(out).all()) and rel <= tol,
              f"K2 {tag} {name} disagrees with the plain version")
    if timed:
        q, k, v = cases["bf16"][:3]
        T = q.shape[0]
        kc = paged_gather_layer(k, t["pt"]).transpose(1, 2)
        vc = paged_gather_layer(v, t["pt"]).transpose(1, 2)
        kc = kc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
        vc = vc.repeat_interleave(n_q // n_kv, dim=1).contiguous()
        mask = (torch.arange(kc.shape[2], device=dev)[None, :] < t["vt"][:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        times["k2"] = _gemma_times(f"K2 bf16 {lname} T={T}", (
            lambda: rpa.ragged_paged_attention_kernel(q, k, v, t["pt"], t["vt"]),
            lambda: rpa.ragged_paged_attention_reference(q, k, v, t["pt"], t["vt"]),
            lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)), _bound(st, 2))
        q8, k8, v8, ks8, vs8 = cases["bf16q_int8"]
        kd = kv_dequant(paged_gather_layer(k8, t["pt"]), paged_gather_layer(ks8, t["pt"]), bf)
        vd = kv_dequant(paged_gather_layer(v8, t["pt"]), paged_gather_layer(vs8, t["pt"]), bf)
        kd = kd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
        vd = vd.transpose(1, 2).repeat_interleave(n_q // n_kv, dim=1).contiguous()
        times["k2_bf16q_int8"] = _gemma_times(f"K2 bf16q_int8 {lname} T={T}", (
            lambda: rpa.ragged_paged_attention_kernel(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
            lambda: rpa.ragged_paged_attention_reference(q8, k8, v8, t["pt"], t["vt"], ks8, vs8),
            lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)),
            _bound(st, 2, kv_bytes=d + 2))
        del kc, vc, kd, vd
    del t, cases
    # ---- K3, chunk form
    s3 = _replay_slots(seed + 283, heads) if timed else _k3_edge_slots(seed + 283, 13, heads)
    e, cases, t = _hold_k3(f"{tag} {'replay' if timed else 'edges Q=13'}", s3)
    errs.update({f"k3_{key}": val for key, val in e.items()})
    if timed:
        e, _, _ = _hold_k3(f"{tag} edges Q=13", _k3_edge_slots(seed + 284, 13, heads))
        errs.update({f"k3_edges13_{key}": val for key, val in e.items()})
        pt, hi0, ql = t["pt"], t["hi0"], t["ql"]
        b, nq_tok = s3["q"].shape[:2]
        dead = torch.arange(nq_tok, device=dev)[None, :] >= ql[:, None]
        pos = torch.arange(pt.shape[1] * s3["k"].shape[1], device=dev)
        qi = torch.arange(nq_tok, device=dev)
        mask = (pos[None, None, :] < (hi0[:, None] + qi[None, :])[:, :, None]) & ~dead[:, :, None]
        for name, kvb in (("bf16", None), ("bf16q_int8", d + 2)):
            q, k, v, ksc, vsc = cases[name][:5]
            kc, vc = paged_gather_layer(k, pt), paged_gather_layer(v, pt)
            if ksc is not None:
                kc = kv_dequant(kc, paged_gather_layer(ksc, pt), bf)
                vc = kv_dequant(vc, paged_gather_layer(vsc, pt), bf)
            kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            q4 = q.transpose(1, 2).contiguous()
            times[f"k3_{name}"] = _gemma_times(f"K3 {name} {lname} B={b} Q={nq_tok}", (
                lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql, ksc, vsc),
                lambda: pca.paged_chunk_attention_reference(q, k, v, pt, hi0, ql, ksc, vsc),
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask[:, None],
                                                       enable_gqa=True)),
                _k3_bound(s3, 2, kv_bytes=kvb))
            del kc, vc
        q, k, v = cases["fp32"][:3]
        times["k3_fp32_ms"] = time_graph(
            lambda: pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql), iters=10)
        log(f"[gemma] (a) K3 fp32 {lname}: device {times['k3_fp32_ms']:.4f} ms")
    del t, cases
    # ---- K3's Q=1 entry point (K2's kernel)
    rng = np.random.default_rng(seed + 285)
    b = 16
    L = rng.integers(64, 641, b)
    L[:2] = (64, 640)
    s1 = _k3_slots(rng, 1, L, np.ones(b, np.int32), [-(-int(x) // 128) for x in L], 6,
                   n_q=n_q, n_kv=n_kv, d=d)
    t1 = {key: torch.from_numpy(val).to(dev) for key, val in s1.items()}
    ks1, vs1 = t1["ks"].to(bf), t1["vs"].to(bf)
    for name, (q, k, v, ksc, vsc) in {
            "fp32": (t1["q"], t1["k"], t1["v"], None, None),
            "bf16": (t1["q"].to(bf), t1["k"].to(bf), t1["v"].to(bf), None, None),
            "bf16q_int8": (t1["q"].to(bf), t1["k8"], t1["v8"], ks1, vs1)}.items():
        got = pca.paged_decode_attention_kernel(q, k, v, t1["pt"], t1["hi0"], ksc, vsc)
        k2 = rpa.ragged_paged_attention_kernel(q[:, 0], k, v, t1["pt"], t1["hi0"], ksc,
                                               vsc)[:, None]
        f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
        plain = paged_decode_attention(q.float(), f32(k), f32(v), t1["pt"], t1["hi0"], ksc, vsc)
        rel, _ = _row_err(got, plain)
        tol = FLASH_ROW_TOL["fp32" if q.dtype == torch.float32 else "bf16"]
        errs[f"k3q1_{name}_row"] = rel
        log(f"[kernel] K3 Q=1 {tag} B={b} {name}: the wrapper is K2's kernel (equal); "
            f"row_err={rel:.3e} against paged_decode_attention (tolerance {tol:.3e})")
        check(torch.equal(got, k2), f"K3 Q=1 {tag} {name}: not K2's kernel on the same inputs")
        check(rel <= tol, f"K3 Q=1 {tag} {name} disagrees with paged_decode_attention")
        if timed and name == "bf16":
            kc = paged_gather_layer(k, t1["pt"]).transpose(1, 2).contiguous()
            vc = paged_gather_layer(v, t1["pt"]).transpose(1, 2).contiguous()
            mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                    < t1["hi0"][:, None])[:, None, None, :]
            q4 = q.transpose(1, 2).contiguous()
            times["k3_q1"] = _gemma_times(f"K3 Q=1 bf16 {lname} B={b}", (
                lambda: pca.paged_decode_attention_kernel(q, k, v, t1["pt"], t1["hi0"]),
                lambda: paged_decode_attention(q, k, v, t1["pt"], t1["hi0"]),
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                       enable_gqa=True)),
                _k3_bound(s1, 2))
    del t1
    # ---- K4
    rng = np.random.default_rng(seed + 286)
    for fname, b, nq, S in (("decode", 32 if timed else 8, 1, 1024),
                            ("q5", 16 if timed else 4, 5, 1024)):
        if fname == "decode":  # the static decode step: prompts right-aligned at 512
            plen = rng.integers(64, 513, b)
            vf_np, vt_np = (512 - plen).astype(np.int32), np.full(b, 576, np.int32)
        else:  # decode_step_spec's verify chunk: windows [0, L + j)
            vf_np, vt_np = np.zeros(b, np.int32), rng.integers(64, 641, b).astype(np.int32)
        shape = (b, S, n_kv, d)
        q32 = torch.from_numpy(rng.standard_normal((b, nq, n_q, d)).astype(np.float32)).to(dev)
        k32, v32 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                    for _ in range(2))
        k8, v8 = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
                  for _ in range(2))
        ks, vs = (torch.from_numpy(np.abs(rng.standard_normal(shape[:3])) * 0.01 + 0.002)
                  .to(dev).to(bf) for _ in range(2))
        vf, vt = torch.from_numpy(vf_np).to(dev), torch.from_numpy(vt_np).to(dev)
        full = torch.full((b,), nq, dtype=torch.long, device=dev)
        span = da.split_plan(S)[0]
        forms = {"bf16": (q32.to(bf), k32.to(bf), v32.to(bf), None, None),
                 "bf16q_int8": (q32.to(bf), k8, v8, ks, vs)}
        if fname == "decode":
            forms.update(fp32=(q32, k32, v32, None, None), int8=(q32, k8, v8, ks, vs))
        for tname, (q, k, v, ksc, vsc) in forms.items():
            got = da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc)
            f32 = (lambda x: x) if k.dtype == torch.int8 else (lambda x: x.float())
            plain = decode_attention_chunk(q.float(), f32(k), f32(v), vf.long(), vt.long(), full,
                                           ksc, vsc)
            rel, err = _row_err(got, plain)
            tol = FLASH_ROW_TOL["fp32" if q.dtype == torch.float32 else "bf16"]
            errs[f"k4_{fname}_{tname}_row"] = rel
            line = f"row_err={rel:.3e} (tolerance {tol:.3e}) max_abs_err={err:.3e}"
            if tname == "bf16q_int8":
                rel_m = _model_err(got, da.decode_attention_chunk_split_reference(
                    q, k, v, vf, vt, ksc, vsc, span=span))
                errs[f"k4_{fname}_{tname}_model"] = rel_m
                line += f"; against the split reference {rel_m:.3e} (tolerance {MODEL_TOL:g})"
                check(rel_m <= MODEL_TOL, f"K4 {tag} {fname} {tname} disagrees with the split "
                      "reference")
            log(f"[kernel] K4 {tag} {fname} {tname} B={b} Q={nq} S={S}: {line}")
            check(bool(torch.isfinite(got).all()) and rel <= tol,
                  f"K4 {tag} {fname} {tname} disagrees with the plain version")
            if timed and tname in ("bf16", "bf16q_int8"):
                kd = kv_dequant(k, ksc, bf) if ksc is not None else k
                vd = kv_dequant(v, vsc, bf) if vsc is not None else v
                kc, vc = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
                mask = _k4_windows(vf, vt, nq, S)[:, None]
                q4 = q.transpose(1, 2).contiguous()
                times[f"k4_{fname}_{tname}"] = _gemma_times(
                    f"K4 {fname} {tname} {lname} B={b} Q={nq}", (
                        lambda: da.decode_attention_chunk_kernel(q, k, v, vf, vt, ksc, vsc),
                        lambda: decode_attention_chunk(q, k, v, vf.long(), vt.long(), full,
                                                       ksc, vsc),
                        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                               enable_gqa=True)),
                    _k4_bound(vf_np, vt_np, nq, S, n_q, n_kv, d, 2,
                              kv_bytes=d + 2 if ksc is not None else None))
                del kc, vc
    return errs, times


def _gemma_holds(seed):
    """(a) Every kernel form at D=256 against its plain version on the
    card, at Gemma-2B's 8 q heads over 1 kv head and Gemma-7B's 16 over
    16; times at Gemma-2B's."""
    import torch

    out = {}
    for lname, heads in GEMMA_LAYOUTS.items():
        t0 = time.monotonic()
        timed = lname == "gemma2b"
        ferrs, ftimes = _gemma_flash(seed, lname, heads, timed)
        t1 = time.monotonic()
        serrs, stimes = _gemma_split_kernels(seed, lname, heads, timed)
        out[lname] = dict(errs={**ferrs, **serrs}, times={**ftimes, **stimes})
        log(f"[gemma] (a) {lname}: flash {t1 - t0:.1f} s, K2/K3/K4 {time.monotonic() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# (b)'s depth: 4 of Gemma-2B's 18 layers (963.6 M parameters: a 3.85 GB fp32
# checkpoint, against 10.0 GB at full depth).
GEMMA_TRIAL_LAYERS = 4
GEMMA_7B_LAYERS = 2  # (d): 1,337.2 M parameters, q width 4096 over hidden 3072
GEMMA_PUSH_REQUESTS = 4  # (c)'s push burst: the burst's first 4 requests, as push_int8's


def _gemma_push(tag, cfg, params, prompts, seed):
    """(c)'s push: the burst's first GEMMA_PUSH_REQUESTS requests (n=4, 128
    new tokens) on the serving plane, with an in-memory push of seeded new
    weights once generation has run two chunks: parked requests replay
    their tails through K3's chunk form.  Counts are set to 0 just before
    the burst and read just after: K3 = L x replays, K2 = L x inner steps,
    K1f = L x prefill dispatches."""
    import torch

    from areal_tpu_torch.base import integrity
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.gen_server import GenerationServer

    eos = GEMMA_2B["eos_token_id"]
    engine = GeneratorEngine(cfg, params, eos_token_id=eos)
    engine.static_path_max_new = 0  # the serving plane, which can park
    chunk_t = 32
    new = init_params(cfg, seed + 1, device="cuda")
    checksum = integrity.params_checksum(new)
    server = GenerationServer(engine, host="127.0.0.1", port=0, max_wait_ms=500.0)
    try:
        torch.cuda.synchronize()
        replays0, steps0, pre0 = (engine.resume_replays, engine.steps_total,
                                  engine.prefill_dispatches)
        _reset_counts()
        t0 = time.monotonic()
        threads, replies, errors = _burst(server.url, prompts[:GEMMA_PUSH_REQUESTS], 4,
                                          FAMILIES_NEW_TOKENS, seed + 2, greedy=True)
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            live = json.loads(urllib.request.urlopen(server.url + "/health").read())["live_slots"]
            if live > 0 and engine.steps_total - steps0 >= 2 * chunk_t:
                break
            time.sleep(0.01)
        steps_at_push = engine.steps_total - steps0
        t_push = time.monotonic()
        version = server.update_weights_inmem(new, checksum=checksum)
        push_s = time.monotonic() - t_push
        for th in threads:
            th.join(timeout=900.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _trial_counts()
    finally:
        server.close()
    replays = engine.resume_replays - replays0
    steps = engine.steps_total - steps0
    L = cfg.n_layers
    want = dict(fwd=L * (engine.prefill_dispatches - pre0), dq=0, dkv=0, k2=L * steps,
                k3=L * replays, k4=0)
    spanned = sum(r is not None and r["version_start"] == 0 and r["version"] == 1
                  for r in replies)
    log(f"{tag}: {GEMMA_PUSH_REQUESTS} requests x n=4, push after {steps_at_push} inner steps "
        f"took {push_s:.3f} s; burst {wall:.2f} s, {steps} inner steps, resume_replays "
        f"{replays}, {spanned} requests spanned the push; launches {counts}")
    check(not errors and all(r is not None for r in replies), f"{tag}: requests failed: "
          f"{errors[:3]}")
    check(steps_at_push >= 2 * chunk_t, f"{tag}: generation never ran two chunks")
    check(version == 1 and spanned >= 1 and replays >= 1,
          f"{tag}: version {version}, {spanned} spanned, {replays} replays")
    for r in replies:
        for ids, lps in zip(r["output_ids"], r["output_logprobs"]):
            check(len(lps) == len(ids) and all(math.isfinite(x) for x in lps),
                  f"{tag}: bad logprobs")
    check(counts == want, f"{tag}: launches {counts} != {want}")
    del server, engine, new
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=counts, push_s=push_s, wall_s=wall, inner_steps=steps,
                resume_replays=replays, spanned=spanned, steps_at_push=steps_at_push)


def phase_gemma(report, seed):
    """The gemma family on the card, at published widths with seeded
    random weights: google/gemma-2b (hidden 2048, 8 q heads over 1 kv head
    of 256, FFN 16384, vocab 256000) and google/gemma-7b (hidden 3072, 16
    heads of 256: a q width of 4096, not the hidden width):
    (a) every attention kernel form at head_dim 256 against its plain
        version, at 8/1 and 16/16 (`_gemma_holds`), with times at 8/1;
    (b) a Gemma-2B checkpoint of GEMMA_TRIAL_LAYERS layers written through
        the gemma family (the reload bit for bit), then `quickstart
        ppo-math` from it: 2 GRPO steps with --master-dtype bfloat16 and
        an offloaded ref, finite stats, exact K1f/K1dq/K1dkv/K4 launches,
        each MFC's MFU;
    (c) Gemma-2B at its full 18 layers (bf16) serving the serve cell's
        16-request burst on the serving plane (K2) and as one static
        chunk (K1f, K4), held against each other teacher-forced
        (`_family_agreement`); then a burst with an in-memory weight push
        mid-way (`_gemma_push`: K3's chunk form replays at D=256);
    (d) Gemma-7B at GEMMA_7B_LAYERS layers: a checkpoint, one quickstart
        step and a serving-plane burst."""
    import shutil

    import torch

    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    t_phase = time.monotonic()
    secs, out = {}, {}
    launches = dict(fwd=0, dq=0, dkv=0, k2=0, k3=0, k4=0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def done(part, t0):
        secs[part] = time.monotonic() - t0
        log(f"[gemma] ({part}) {secs[part]:.1f} s")

    t0 = time.monotonic()
    out["holds"] = _gemma_holds(seed)
    done("a", t0)
    os.makedirs(GEMMA_DIR, exist_ok=True)
    try:
        t0 = time.monotonic()
        work = tempfile.mkdtemp(prefix="run-", dir=GEMMA_DIR)
        cfg = _family_cfg(GEMMA_2B, GEMMA_TRIAL_LAYERS)
        _check_disk("[gemma]", work, _fp32_model_bytes(cfg) + 2 * 2**30)
        ckpt, params, write_s, nbytes, _ = _family_checkpoint(
            "[gemma] (b)", work, cfg, seed + 290, "gemma")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        trial = _family_trial("[gemma] (b) gemma-2b", work, ckpt, cfg, seed + 291, 2,
                              ("--master-dtype", "bfloat16"))
        add(trial["launches"])
        out["gemma2b_trial"] = dict(trial, ckpt_write_s=write_s, ckpt_bytes=nbytes)
        shutil.rmtree(work, ignore_errors=True)
        done("b", t0)

        t0 = time.monotonic()
        cfg = _family_cfg(GEMMA_2B)
        params = init_params(cfg, seed + 292, device="cuda")
        prompts = _family_prompts(cfg, seed + 293)
        runs = {}
        for name, serving in (("serving", True), ("static", False)):
            runs[name] = _family_burst(f"[gemma] (c) gemma-2b {name}", cfg, params, prompts, 4,
                                       FAMILIES_NEW_TOKENS, GEMMA_2B["eos_token_id"], serving,
                                       seed + 294)
            add(runs[name]["launches"])
        agreement = _family_agreement("[gemma] (c) gemma-2b", cfg, params, prompts,
                                      runs["serving"], {"static": (runs["static"], cfg, False)},
                                      envelope=True)
        push = _gemma_push("[gemma] (c) gemma-2b push", cfg, params, prompts, seed + 295)
        add(push["launches"])
        out["gemma2b_serve"] = dict(
            agreement=agreement, push=push,
            **{name: {k: v for k, v in r.items() if k != "outputs"} for name, r in runs.items()})
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
        done("c", t0)

        t0 = time.monotonic()
        work = tempfile.mkdtemp(prefix="run-", dir=GEMMA_DIR)
        g7 = _family_cfg(GEMMA_7B, GEMMA_7B_LAYERS)
        check(g7.q_dim == 4096 and g7.hidden_dim == 3072, f"[gemma] (d) {g7}")
        _check_disk("[gemma]", work, _fp32_model_bytes(g7) + 2 * 2**30)
        ckpt, params, write_s, nbytes, _ = _family_checkpoint(
            "[gemma] (d)", work, g7, seed + 296, "gemma")
        serve = _family_burst("[gemma] (d) gemma-7b serving", g7, params,
                              _family_prompts(g7, seed + 297), 4, FAMILIES_NEW_TOKENS,
                              GEMMA_7B["eos_token_id"], True, seed + 298)
        add(serve["launches"])
        serve.pop("outputs")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        trial = _family_trial("[gemma] (d) gemma-7b", work, ckpt, g7, seed + 299, 1)
        add(trial["launches"])
        out["gemma7b"] = dict(trial=trial, serve=serve, ckpt_write_s=write_s, ckpt_bytes=nbytes)
        done("d", t0)
    finally:
        shutil.rmtree(GEMMA_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    secs["phase"] = time.monotonic() - t_phase
    out.update(launches=launches, seconds=secs)
    log(f"[gemma] {card}: parts " + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()))
    log(f"[gemma] the phase's launches (the main paths of (b)-(d)): {launches}")
    report["gemma"] = out


def _gemma_entries(report, kernel):
    """The D=256 numbers of one row of the kernels line: the gemma
    phase's launches, the worst row error of each form at Gemma-2B's and
    Gemma-7B's heads, and each timed form's device ms, plain, library and
    bound at Gemma-2B's (`d256_<form>_*`)."""
    g = report.get("gemma", {})
    holds = g.get("holds", {})
    errs = [h["errs"] for h in holds.values()]
    times = holds.get("gemma2b", {}).get("times", {})
    prefix = {"fwd": ("fwd", "o"), "dq": ("dq", "dq"), "dkv": ("dkv", "dk", "dv"),
              "k2": ("k2",), "k3": ("k3",), "k4": ("k4",)}[kernel]
    out = {"launches_gemma": g.get("launches", {}).get(kernel)}
    if kernel in ("fwd", "dq", "dkv"):
        keys = [f"{t}_{o}_row" for t in ("fp32", "bf16") for o in prefix[1:]]
        keys += [f"edges_{t}_{o}{m}" for t in ("fp32", "bf16") for o in prefix[1:]
                 for m in ("", "_model")]
        out["d256_row_err"] = _worst(e.get(k) for e in errs for k in keys)
        out["d256_fp32_ms"] = times.get(f"fp32_{kernel}_ms")
        forms = {"": times.get(kernel)}
    else:
        out["d256_row_err"] = _worst(v for e in errs for k, v in e.items()
                                     if k.startswith(prefix[0] + "_") and k.endswith("_row"))
        forms = {f"{k[len(kernel) + 1:]}_" if k != kernel else "": v for k, v in times.items()
                 if (k == kernel or k.startswith(kernel + "_")) and isinstance(v, dict)}
        if kernel == "k3":
            out["d256_fp32_ms"] = times.get("k3_fp32_ms")
    for name, t in forms.items():
        if t:
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
                out[f"d256_{name}{key.replace('kernel_ms', 'ms')}"] = t[key]
    return out


def _kernels_line(report):
    qs_launches = report.get("quickstart", {}).get("launches", {})
    rc_launches = report.get("recover", {}).get("launches", {})
    gm_launches = report.get("genmodes", {}).get("launches", {})
    ep_launches = report.get("episodes", {}).get("launches", {})
    sft = report.get("sft", {})
    sft_launches = sft.get("launches", {})
    ov_launches = report.get("overlap", {}).get("launches", {})
    tm_launches = report.get("trainmodes", {}).get("launches", {})
    as_launches = report.get("async", {}).get("launches", {})
    mp_launches = report.get("multiproc", {}).get("launches", {})
    gp_launches = report.get("group", {}).get("launches", {})
    fb_launches = report.get("fabric", {}).get("launches", {})
    vf_launches = report.get("verifiers", {}).get("launches", {})
    sv_launches = report.get("supervisor", {}).get("launches", {})
    ch_launches = report.get("chaos", {}).get("launches", {})
    fm_launches = report.get("families", {}).get("launches", {})
    fm_holds = report.get("families", {}).get("holds", {})
    k = report.get("kernel", {})
    s = report.get("serve", {})
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "areal_tpu/ops/pallas/paged_attention.py:276",
        "launches": s.get("launches"),
        "launches_quickstart": qs_launches.get("k2"),
        "launches_recover": rc_launches.get("k2"),
        "launches_genmodes": gm_launches.get("k2"),
        "launches_push_int8": report.get("push_int8", {}).get("k2_launches"),
        "launches_episodes": ep_launches.get("k2"),
        "launches_sft": sft_launches.get("k2"),
        "launches_overlap": ov_launches.get("k2"),
        "launches_trainmodes": tm_launches.get("k2"),
        "launches_async": as_launches.get("k2"),
        "launches_multiproc": mp_launches.get("k2"),
        "launches_group": gp_launches.get("k2"),
        "launches_fabric": fb_launches.get("k2"),
        "launches_verifiers": vf_launches.get("k2"),
        "launches_supervisor": sv_launches.get("k2"),
        "launches_chaos": ch_launches.get("k2"),
        "launches_families": fm_launches.get("k2"),
        "max_abs_err_families": _worst(fm_holds.get(f"{m}_k2_bf16") for m in ("mixtral", "gpt2")),
        "max_abs_err": k.get("max_abs_err", {}).get("bf16"),
        "max_abs_err_split": k.get("max_abs_err", {}).get("bf16_split"),
        "max_abs_err_fp32": k.get("max_abs_err", {}).get("fp32"),
        "max_abs_err_int8": k.get("max_abs_err", {}).get("int8"),
        "ms": k.get("kernel_ms"),
        "eager_ms": k.get("kernel_eager_ms"),
        "plain_ms": k.get("plain_ms"),
        "plain_eager_ms": k.get("plain_eager_ms"),
        "bound_ms": k.get("bound_ms"),
        "bound_by": k.get("bound_by"),
        "library_ms": k.get("library_ms"),
        "library_eager_ms": k.get("library_eager_ms"),
        **_gemma_entries(report, "k2"),
    }]
    k8 = k.get("bf16q_int8")
    if k8:  # bf16 q over an int8 pool: the tensor-core int8 path
        errs = k.get("max_abs_err", {})
        kernels[-1].update({
            "bf16q_int8_max_abs_err": errs.get("bf16q_int8"),
            "bf16q_int8_row_err": errs.get("bf16q_int8_row"),
            "bf16q_int8_model_err": errs.get("bf16q_int8_model"),
            "bf16q_int8_ms": k8["kernel_ms"], "bf16q_int8_eager_ms": k8["kernel_eager_ms"],
            "bf16q_int8_plain_ms": k8["plain_ms"], "bf16q_int8_library_ms": k8["library_ms"],
            "bf16q_int8_bound_ms": k8["bound_ms"], "bf16q_int8_bound_by": k8["bound_by"],
        })
    f = report.get("flash", {})
    sh_train = report.get("sharded", {}).get("train", {})
    sh_heads = report.get("sharded", {}).get("heads", {})
    train = report.get("train", {})
    launches = train.get("launches", {})
    ppo_launches = report.get("ppo", {}).get("launches", {})
    at_train = train.get("steps", [{}])[0].get("train_shape_errs", {})
    outputs = {"fwd": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}
    for name, line in (("fwd", 170), ("dq", 355), ("dkv", 380)):
        errs = f.get("max_abs_err", {})
        bound = f.get("bounds", {}).get(name, (None, None))
        t = f.get("times", {}).get(name, {})
        entry = {
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"areal_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": launches.get(name),
            "launches_ppo": ppo_launches.get(name),
            "launches_quickstart": qs_launches.get(name),
            "launches_recover": rc_launches.get(name),
            "launches_genmodes": gm_launches.get(name),
            "launches_episodes": ep_launches.get(name),
            "launches_sft": sft_launches.get(name),
            "launches_sft_eval": sft.get("eval_launches", {}).get(name),
            "launches_overlap": ov_launches.get(name),
            "launches_trainmodes": tm_launches.get(name),
            "launches_async": as_launches.get(name),
            "launches_multiproc": mp_launches.get(name),
            "launches_group": gp_launches.get(name),
            "launches_fabric": fb_launches.get(name),
            "launches_verifiers": vf_launches.get(name),
            "launches_supervisor": sv_launches.get(name),
            "launches_chaos": ch_launches.get(name),
            "launches_families": fm_launches.get(name),
            "launches_sharded": sh_train.get("launches", {}).get(name),
            "launches_sharded_heads": sh_heads.get("launches", {}).get(name),
            "row_err_families": _worst(fm_holds.get(f"{m}_flash_{o}_row")
                                       for m in ("mixtral", "gpt2") for o in outputs[name]),
            "max_abs_err": _worst(errs.get(f"bf16_{o}") for o in outputs[name]),
            "row_err": _worst(errs.get(f"bf16_{o}_row") for o in outputs[name]),
            "max_abs_err_fp32": _worst(errs.get(f"fp32_{o}") for o in outputs[name]),
            "row_err_fp32": _worst(errs.get(f"fp32_{o}_row") for o in outputs[name]),
            "row_err_train_shape": _worst(
                at_train[o][0] if o in at_train else None for o in outputs[name]
            ),
            "row_err_edges": _worst(errs.get(f"edges_bf16_{o}") for o in outputs[name]),
            "row_err_edges_model": _worst(
                errs.get(f"edges_bf16_{o}_model") for o in outputs[name]),
            "row_err_model": _worst(errs.get(f"bf16_{o}_model_row") for o in outputs[name]),
            "ms": t.get("kernel_ms"),
            "eager_ms": t.get("kernel_eager_ms"),
            "plain_ms": t.get("plain_ms"),
            "plain_eager_ms": t.get("plain_eager_ms"),
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": t.get("library_ms"),
            "library_eager_ms": t.get("library_eager_ms"),
            **_gemma_entries(report, name),
        }
        if name == "fwd":  # lse against the dense logsumexp and the model
            entry["lse_err_edges"] = _worst(errs.get(f"edges_{d}_lse") for d in ("bf16", "fp32"))
            entry["lse_err_model"] = errs.get("bf16_lse_model")
        kernels.append(entry)
    t = sh_heads.get("times", {})
    bound = sh_heads.get("bound", (None, None))
    kernels.append({
        "name": "flash_attention_sharded",
        "route": "cuda",
        "source": "areal_tpu_torch/kernels/flash_attention.py",
        "replaces": "areal_tpu/ops/pallas/flash_attention.py:483",
        "launches": sh_heads.get("launches", {}).get("fwd"),
        "launches_by_form": sh_heads.get("launches"),
        "launches_train": sh_train.get("launches"),
        "max_abs_err": sh_heads.get("max_abs_err"),
        "row_err": sh_heads.get("row_err"),
        "row_err_vs_full_heads": sh_heads.get("row_err_vs_full"),
        "bit_for_bit_vs_full_heads": sh_heads.get("bitwise"),
        "ms": t.get("kernel_ms"),
        "eager_ms": t.get("kernel_eager_ms"),
        "plain_ms": t.get("plain_ms"),
        "plain_eager_ms": t.get("plain_eager_ms"),
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": t.get("library_ms"),
        "library_eager_ms": t.get("library_eager_ms"),
    })
    k3 = report.get("k3", {})
    errs = k3.get("max_abs_err", {})
    kernels.append({
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/paged_chunk_attention.cu",
        "replaces": "areal_tpu/ops/pallas/paged_attention.py:194",
        "launches": report.get("push", {}).get("launches"),
        "launches_push_int8": report.get("push_int8", {}).get("launches"),
        "launches_quickstart": qs_launches.get("k3"),
        "launches_recover": rc_launches.get("k3"),
        "launches_genmodes": gm_launches.get("k3"),
        "launches_episodes": ep_launches.get("k3"),
        "launches_sft": sft_launches.get("k3"),
        "launches_overlap": ov_launches.get("k3"),
        "launches_trainmodes": tm_launches.get("k3"),
        "launches_async": as_launches.get("k3"),
        "launches_multiproc": mp_launches.get("k3"),
        "launches_group": gp_launches.get("k3"),
        "launches_fabric": fb_launches.get("k3"),
        "launches_verifiers": vf_launches.get("k3"),
        "launches_supervisor": sv_launches.get("k3"),
        "launches_chaos": ch_launches.get("k3"),
        "launches_families": fm_launches.get("k3"),
        "max_abs_err": errs.get("bf16"),
        "row_err": errs.get("bf16_row"),
        "max_abs_err_fp32": errs.get("fp32"),
        "row_err_fp32": errs.get("fp32_row"),
        "max_abs_err_int8": errs.get("int8"),
        "row_err_int8": errs.get("int8_row"),
        "row_err_tiled": errs.get("bf16_tiled_row"),
        "row_err_edges": _worst(errs.get(f"edges{n}_bf16_row") for n in (13, 1)),
        "ms": k3.get("kernel_ms"),
        "eager_ms": k3.get("kernel_eager_ms"),
        "plain_ms": k3.get("plain_ms"),
        "plain_eager_ms": k3.get("plain_eager_ms"),
        "bound_ms": k3.get("bound_ms"),
        "bound_by": k3.get("bound_by"),
        "library_ms": k3.get("library_ms"),
        "library_eager_ms": k3.get("library_eager_ms"),
        **_gemma_entries(report, "k3"),
    })
    c8 = k3.get("bf16q_int8")
    if c8:  # the chunk form, bf16 q over an int8 pool, at the replay shape
        kernels[-1].update({
            "bf16q_int8_row_err": c8["row_err"], "bf16q_int8_row_err_tiled": c8["row_err_tiled"],
            "bf16q_int8_row_err_edges": _worst(
                errs.get(f"edges{n}_bf16q_int8_row") for n in (13, 1)),
            "bf16q_int8_model_err": _worst([c8["model_err"]] + [
                errs.get(f"edges{n}_bf16q_int8_model") for n in (13, 1)]),
            "bf16q_int8_ms": c8["kernel_ms"], "bf16q_int8_eager_ms": c8["kernel_eager_ms"],
            "bf16q_int8_plain_ms": c8["plain_ms"], "bf16q_int8_library_ms": c8["library_ms"],
            "bf16q_int8_bound_ms": c8["bound_ms"], "bf16q_int8_bound_by": c8["bound_by"],
        })
    # The Q=1 entry point (decode_step_paged) runs K2's kernel: its
    # numbers stand on this row, its launches on K2's.
    for b, q1 in k3.get("q1", {}).items():
        e8 = q1.get("bf16q_int8", {})
        kernels[-1].update({
            f"q1_b{b}_route": "ragged_paged_attention",
            f"q1_b{b}_max_abs_err": q1["max_abs_err"].get("bf16_q1"),
            f"q1_b{b}_row_err": q1["max_abs_err"].get("bf16_q1_row"),
            f"q1_b{b}_row_err_int8": q1["max_abs_err"].get("int8_q1_row"),
            f"q1_b{b}_row_err_bf16q_int8": q1["max_abs_err"].get("bf16q_int8_q1_row"),
            f"q1_b{b}_model_err_bf16q_int8": q1["max_abs_err"].get("bf16q_int8_q1_model"),
            f"q1_b{b}_ms": q1["kernel_ms"], f"q1_b{b}_eager_ms": q1["kernel_eager_ms"],
            f"q1_b{b}_plain_ms": q1["plain_ms"], f"q1_b{b}_library_ms": q1["library_ms"],
            f"q1_b{b}_bound_ms": q1["bound_ms"], f"q1_b{b}_bound_by": q1["bound_by"],
            f"q1_b{b}_bf16q_int8_ms": e8.get("kernel_ms"),
            f"q1_b{b}_bf16q_int8_eager_ms": e8.get("kernel_eager_ms"),
            f"q1_b{b}_bf16q_int8_plain_ms": e8.get("plain_ms"),
            f"q1_b{b}_bf16q_int8_library_ms": e8.get("library_ms"),
            f"q1_b{b}_bf16q_int8_bound_ms": e8.get("bound_ms"),
        })
    k4 = report.get("k4", {})
    errs = k4.get("max_abs_err", {})
    kernels.append({
        "name": "decode_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/decode_attention.cu",
        "replaces": "areal_tpu/ops/pallas/decode_attention.py:145",
        "launches": report.get("static", {}).get("launches"),
        "launches_quickstart": qs_launches.get("k4"),
        "launches_recover": rc_launches.get("k4"),
        "launches_genmodes": gm_launches.get("k4"),
        "launches_episodes": ep_launches.get("k4"),
        "launches_sft": sft_launches.get("k4"),
        "launches_overlap": ov_launches.get("k4"),
        "launches_trainmodes": tm_launches.get("k4"),
        "launches_async": as_launches.get("k4"),
        "launches_multiproc": mp_launches.get("k4"),
        "launches_group": gp_launches.get("k4"),
        "launches_fabric": fb_launches.get("k4"),
        "launches_verifiers": vf_launches.get("k4"),
        "launches_supervisor": sv_launches.get("k4"),
        "launches_chaos": ch_launches.get("k4"),
        "launches_families": fm_launches.get("k4"),
        "row_err_families": _worst(fm_holds.get(f"{m}_k4_bf16_row") for m in ("mixtral", "gpt2")),
        "max_abs_err": errs.get("bf16_decode"),
        "row_err": errs.get("bf16_decode_row"),
        "max_abs_err_fp32": errs.get("fp32_decode"),
        "row_err_fp32": errs.get("fp32_decode_row"),
        "max_abs_err_int8": errs.get("int8_decode"),
        "row_err_int8": errs.get("int8_decode_row"),
        "row_err_split": errs.get("bf16_decode_split_row"),
        "row_err_bf16q_int8": _worst(v for key, v in errs.items()
                                     if key.startswith("bf16q_int8_") and key.endswith("_row")
                                     and not key.endswith("split_row")),
        "model_err_bf16q_int8": _worst(v for key, v in errs.items()
                                       if key.startswith("bf16q_int8_")
                                       and key.endswith("_split_row")),
        "ms": k4.get("kernel_ms"),
        "eager_ms": k4.get("kernel_eager_ms"),
        "plain_ms": k4.get("plain_ms"),
        "plain_eager_ms": k4.get("plain_eager_ms"),
        "bound_ms": k4.get("bound_ms"),
        "bound_by": k4.get("bound_by"),
        "library_ms": k4.get("library_ms"),
        "library_eager_ms": k4.get("library_eager_ms"),
        **_gemma_entries(report, "k4"),
        "b64_ms": k4.get("b64", {}).get("kernel_ms"),
        "b64_library_ms": k4.get("b64", {}).get("library_ms"),
        "b64_bound_ms": k4.get("b64", {}).get("bound_ms"),
    })
    for tag in ("int8_q1", "int8_q5", "q5"):  # the dense inflight window's forms
        f = k4.get(tag)
        if f:
            kernels[-1].update({
                f"{tag}_max_abs_err": f["max_abs_err"], f"{tag}_row_err": f["row_err"],
                f"{tag}_model_err": f["model_err"],
                f"{tag}_ms": f["kernel_ms"], f"{tag}_eager_ms": f["kernel_eager_ms"],
                f"{tag}_plain_ms": f["plain_ms"], f"{tag}_library_ms": f["library_ms"],
                f"{tag}_bound_ms": f["bound_ms"], f"{tag}_bound_by": f["bound_by"],
            })
    return kernels


# --------------------------------------------------------------------------
# The CPU halves of sft's parity, parity and train_parity, computed in a
# child process beside the card's phases
# --------------------------------------------------------------------------

# Phases whose CPU reference (the plain path at 2 layers, fp32) the child
# computes, in the order it writes them (the order the phases read them).
CPU_REF_PHASES = ("sft", "parity", "train_parity")
CPU_REF_THREADS = 4  # of the host's cores; the card's phases keep the rest
# The child starts before this phase: after the build (whose nvcc processes
# take every core) and the serve and static phases (whose host-bound
# tokens/s it would slow: serve read 238.0 tok/s beside it, 298.4 alone).
CPU_REFS_FROM = "push"
CPU_REFS_DIR = os.path.join(REPO, ".cpu_refs_tmp")
_CPU_REFS = {}  # the child: proc, dir, log, t0; and the refs read so far


def _inputs_print(tree):
    """A cheap fingerprint of a tensor tree's values (the raw words of
    every 997th element of each leaf, summed as integers: exact in any
    order, so on any thread count): the child and the phase hold the same
    seeded inputs."""
    import torch

    out = []
    for name, x in _flat_params(tree):
        w = x.detach().reshape(-1)[::997].contiguous()
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        out.append((name, tuple(x.shape), int(w.to(torch.int64).sum())))
    return out


def _start_cpu_refs(phases, seed):
    """Start the child that computes the CPU references of `phases` (the
    ones in CPU_REF_PHASES), each to its own file as it finishes, on
    CPU_REF_THREADS threads and with no card visible."""
    want = [p for p in CPU_REF_PHASES if p in phases]
    if not want:
        return
    os.makedirs(CPU_REFS_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="refs-", dir=CPU_REFS_DIR)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(CPU_REF_THREADS))
    logf = open(os.path.join(work, "child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-refs", work, "--seed", str(seed),
         "--phases", ",".join(want)],
        env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=REPO)
    _CPU_REFS.update(proc=proc, dir=work, log=logf, t0=time.monotonic())
    log(f"[cpu_refs] child {proc.pid} computes the CPU references of {want} on "
        f"{CPU_REF_THREADS} threads")


def _cpu_ref(name):
    """The child's result for phase `name`, waiting for its file."""
    import torch

    if name in _CPU_REFS:
        return _CPU_REFS[name]
    check("proc" in _CPU_REFS, f"[cpu_refs] no child computes {name}'s reference")
    path = os.path.join(_CPU_REFS["dir"], f"{name}.pt")
    t0 = time.monotonic()
    while not os.path.exists(path):
        rc = _CPU_REFS["proc"].poll()
        if rc is not None and not os.path.exists(path):
            with open(os.path.join(_CPU_REFS["dir"], "child.log")) as f:
                tail = f.read()[-4000:]
            check(False, f"[cpu_refs] the child exited {rc} before {name}'s reference:\n{tail}")
        time.sleep(0.2)
    ref = torch.load(path, weights_only=False)
    os.remove(path)
    log(f"[cpu_refs] {name}: read {time.monotonic() - t0:.1f} s after asking; the child "
        f"computed it in {ref['seconds']:.1f} s, {ref['done_at']:.1f} s after it started")
    _CPU_REFS[name] = ref
    return ref


def _stop_cpu_refs():
    import shutil

    proc = _CPU_REFS.pop("proc", None)
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        _CPU_REFS["log"].close()
        shutil.rmtree(_CPU_REFS["dir"], ignore_errors=True)


def cpu_refs_main(work, seed, phases):
    """The child: each phase's CPU reference to work/<phase>.pt (written
    whole, then renamed), in CPU_REF_PHASES' order."""
    import torch

    torch.set_num_threads(CPU_REF_THREADS)
    sys.path.insert(0, REPO)
    t_start = time.monotonic()
    makers = {"sft": _sft_parity_cpu, "parity": _parity_cpu,
              "train_parity": _train_parity_cpu}
    for name in CPU_REF_PHASES:
        if name in phases:
            t0 = time.monotonic()
            ref = makers[name](seed)
            ref.update(seconds=time.monotonic() - t0, done_at=time.monotonic() - t_start)
            tmp = os.path.join(work, f"{name}.pt.tmp")
            torch.save(ref, tmp)
            os.replace(tmp, os.path.join(work, f"{name}.pt"))
            print(f"[cpu_refs] {name}: {ref['seconds']:.1f} s", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--cpu-refs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")
    if args.cpu_refs:
        return cpu_refs_main(args.cpu_refs, args.seed, phases)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "areal_tpu_torch")):
        print("chip_smoke: areal_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.monotonic()
    report = {}  # each phase's numbers for the kernels line
    runners = {
        "build": phase_build,
        "kernel": lambda: phase_kernel(report, args.seed),
        "flash": lambda: phase_flash(report, args.seed),
        "serve": lambda: phase_serve(report, args.seed),
        "static": lambda: phase_static(report, args.seed),
        "push": lambda: phase_push(report, args.seed),
        "resume_parity": lambda: phase_resume_parity(report, args.seed),
        "train": lambda: phase_train(report, args.seed),
        "ppo": lambda: phase_ppo(report, args.seed),
        "sharded": lambda: phase_sharded(report, args.seed),
        "quickstart": lambda: phase_quickstart(report, args.seed),
        "sft": lambda: phase_sft(report, args.seed),
        "overlap": lambda: phase_overlap(report, args.seed),
        "trainmodes": lambda: phase_trainmodes(report, args.seed),
        "recover": lambda: phase_recover(report, args.seed),
        "genmodes": lambda: phase_genmodes(report, args.seed),
        "async": lambda: phase_async(report, args.seed),
        "multiproc": lambda: phase_multiproc(report, args.seed),
        "group": lambda: phase_group(report, args.seed),
        "fabric": lambda: phase_fabric(report, args.seed),
        "verifiers": lambda: phase_verifiers(report, args.seed),
        "supervisor": lambda: phase_supervisor(report, args.seed),
        "chaos": lambda: phase_chaos(report, args.seed),
        "families": lambda: phase_families(report, args.seed),
        "gemma": lambda: phase_gemma(report, args.seed),
        "episodes": lambda: phase_episodes(report, args.seed),
        "parity": lambda: phase_parity(args.seed),
        "train_parity": lambda: phase_train_parity(args.seed),
    }
    last_ckpt_user = [p for p in PHASES if p in phases and p in CKPT_PHASES][-1:]
    try:
        for name in PHASES:  # in this order, whatever the order asked
            if PHASES.index(name) >= PHASES.index(CPU_REFS_FROM) and "proc" not in _CPU_REFS:
                _start_cpu_refs(phases, args.seed)
            if name in phases:
                t0 = time.monotonic()
                runners[name]()
                log(f"[time] {name}: {time.monotonic() - t0:.1f} s")
                if [name] == last_ckpt_user:
                    _release_shared_checkpoints()
    finally:
        _stop_cpu_refs()
        _release_shared_checkpoints()
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    log_card()  # again here: a long run's output may keep only its tail
    print(json.dumps({"kernels": _kernels_line(report)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
