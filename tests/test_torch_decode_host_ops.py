"""The host work of one decode step (fault 4 of the port's ROADMAP: the
pipeline-overlapped step paid each chunk's decode loop on the host).

- One tiny CPU `decode_step` (tiny_config, B = 4, the weight views bound
  once a burst through `layer_views`, as the generator's loops do) makes
  at most `OP_CEILING` aten calls, counted under a `TorchDispatchMode`.
  The step read 654 calls before each layer's weight views were bound
  once a burst and the plain decode attention became two batched
  matmuls under one window a step; 445 after.
- The plain decode attention's new form (`decode_window` +
  `decode_attention_chunk_kernel` on CPU tensors) equals
  `ops/attention.decode_attention_chunk` with every query live on edge
  windows (empty, one slot, the whole cache, ragged starts, Q = 1 and 5,
  fp32, bf16 and int8), with exact zeros where the plain version gives
  them.
- The static path's greedy tokens stay the JAX engine's, with the
  weight views bound once a burst."""

import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.kernels.decode_attention import (
    decode_attention_chunk_kernel,
    decode_window,
)
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.ops.attention import decode_attention_chunk
from areal_tpu_torch.ops.quant import kv_quant

# 445 counted after the change (654 before it); the ceiling leaves room
# for a few ops of a torch upgrade, not for a per-layer rebuild (~50 a
# layer).
OP_CEILING = 460


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_decode_step_op_count():
    cfg = tiny_config()
    params = tfm.init_params(cfg, 0, device="cpu")
    b, sp, total = 4, 16, 24
    lens = [16, 9, 12, 5]
    rng = np.random.default_rng(0)
    tokens = np.zeros((b, sp), np.int32)
    seg = np.zeros((b, sp), np.int32)
    for i, n in enumerate(lens):
        tokens[i, sp - n:] = rng.integers(8, cfg.vocab_size, n)
        seg[i, sp - n:] = 1
    cache = tfm.init_kv_cache(cfg, b, total, dtype=torch.float32, device="cpu")
    _, cache = tfm.prefill(params, cfg, torch.from_numpy(tokens), torch.from_numpy(seg), cache)
    vf = torch.tensor([sp - n for n in lens], dtype=torch.int32)
    layers = tfm.layer_views(params)
    tok = torch.from_numpy(rng.integers(8, cfg.vocab_size, b).astype(np.int32))
    pos = torch.tensor(lens, dtype=torch.int32)
    with torch.no_grad():
        want, _ = tfm.decode_step(params, cfg, tok, pos, cache, sp, vf)
        cache.k[:, :, sp] = 0
        cache.v[:, :, sp] = 0
        with _CountOps() as counter:
            got, _ = tfm.decode_step(params, cfg, tok, pos, cache, sp, vf, layers=layers)
    n = sum(counter.calls.values())
    assert n <= OP_CEILING, (n, counter.calls.most_common(10))
    # Bound views change no number.
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _window_case(rng, b, s, q, n_kv, rep, d, vf, vt0, dtype):
    qx = torch.from_numpy(rng.normal(size=(b, q, n_kv * rep, d)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(b, s, n_kv, d)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(b, s, n_kv, d)).astype(np.float32)).to(dtype)
    return qx, k, v, torch.tensor(vf, dtype=torch.int32), torch.tensor(vt0, dtype=torch.int32)


# (Q, valid_from, valid_to0): empty windows, a one-slot window, the whole
# cache, ragged starts, windows that end at the cache's last slot.
EDGES = {
    "q1_ragged": (1, [0, 5, 11, 15], [6, 9, 12, 16]),
    "q1_empty_rows": (1, [4, 7, 0, 9], [4, 7, 16, 10]),
    "q1_whole_cache": (1, [0, 0, 0, 0], [16, 16, 16, 16]),
    "q5_ragged": (5, [0, 3, 8, 2], [1, 6, 12, 3]),
    "q5_empty_first_queries": (5, [6, 9, 0, 11], [4, 7, 2, 12]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_decode_attention_matches_chunk_reference(case, dtype):
    q_len, vf, vt0 = EDGES[case]
    rng = np.random.default_rng(3)
    b, s, n_kv, rep, d = 4, 16, 2, 3, 16
    fdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qx, k, v, vf_t, vt_t = _window_case(rng, b, s, q_len, n_kv, rep, d, vf, vt0, fdt)
    ks = vs = None
    if dtype == "int8":
        k, ks = kv_quant(k)
        v, vs = kv_quant(v)
    want = decode_attention_chunk(qx, k, v, vf_t.long(), vt_t.long(),
                                  torch.full((b,), q_len, dtype=torch.long), ks, vs)
    win = decode_window(vf_t, vt_t, q_len, s)
    got = decode_attention_chunk_kernel(qx, k, v, vf_t, vt_t, ks, vs, window=win)
    assert got.dtype == want.dtype and got.shape == want.shape
    # Exact zeros where the plain version gives them (empty windows).
    zero_rows = (want == 0).all(dim=-1).all(dim=-1)
    assert torch.equal((got == 0).all(dim=-1).all(dim=-1), zero_rows)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    # The window built inside the call is the same as the shared one.
    torch.testing.assert_close(
        decode_attention_chunk_kernel(qx, k, v, vf_t, vt_t, ks, vs), got, rtol=0, atol=0)


def test_static_path_greedy_matches_jax_with_bound_views():
    """Five requests, two a static chunk, greedy: tokens identical to the
    JAX engine's static path, logprobs within 1e-4."""
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    lens = (4, 11, 6, 9, 5)
    rng = np.random.default_rng(42)
    data = np.concatenate([rng.integers(8, 512, size=n) for n in lens]).astype(np.int32)
    kw = dict(keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
              seqlens={"packed_prompts": [[n] for n in lens]})
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    eng_kw = dict(kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=7, kv_paged=True, **eng_kw)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=7, **eng_kw)
    oj = je.generate(JSample(data={"packed_prompts": data.copy()}, **kw), JSpec(),
                     JGen(n=1, max_new_tokens=10, greedy=True), inflight=False)
    ot = te.generate(SequenceSample(data={"packed_prompts": data.copy()}, **kw),
                     MicroBatchSpec(), GenerationHyperparameters(n=1, max_new_tokens=10,
                                                                 greedy=True),
                     inflight=False)
    assert te.static_chunks == 3 and te.static_decode_steps > 0
    assert ot.seqlens["packed_input_ids"] == oj.seqlens["packed_input_ids"]
    np.testing.assert_array_equal(ot.data["packed_input_ids"],
                                  np.asarray(oj.data["packed_input_ids"]))
    np.testing.assert_allclose(ot.data["packed_logprobs"],
                               np.asarray(oj.data["packed_logprobs"]), atol=1e-4, rtol=0)
