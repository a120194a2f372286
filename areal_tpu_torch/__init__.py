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
    interfaces/reward.py  MultiTaskRewardInterface (in-process math grading)
    engines/train.py      TrainEngine.train_batch / forward (AdamW, guard)
    models/transformer.py hidden_states / per_token_output over packed rows
    kernels/flash_attention.py flash_attention (CUDA, sm_90a; CPU: plain version)

Slice 3, the in-memory weight push mid-generation:

    system/gen_server.py  update_weights_inmem, pause/resume (POST /pause, /resume)
    engines/generator.py  interrupt -> park at a chunk boundary -> resume_generate
    models/transformer.py decode_step_spec_paged (the tail replay)
    kernels/paged_chunk_attention.py (CUDA, sm_90a; CPU: plain version)
"""
