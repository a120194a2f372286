"""The port's speculative-decoding pieces against the JAX package's:

- `ops/ngram.propose_ngram`: twins of tests/test_spec_decode.py's
  proposal cases, and random histories against the JAX function;
- `ops/sampling.spec_accept`: greedy and sampled (the JAX draws passed
  in as `u_acc`, `u_res`), ragged with `n_valid`, top-k / top-p warped:
  emitted tokens and counts equal, logps within 1e-5; and the
  distribution checks of tests/test_spec_decode.py:96 and :122 on the
  port's own generator;
- K3's Q=1 wrapper (`paged_decode_attention_kernel`) and the plain
  `ops/attention.paged_decode_attention` against the JAX function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.attention import paged_decode_attention as jpaged_decode
from areal_tpu.ops.ngram import propose_ngram as jpropose
from areal_tpu.ops.sampling import spec_accept as jspec_accept
from areal_tpu_torch.kernels.paged_chunk_attention import paged_decode_attention_kernel
from areal_tpu_torch.ops.attention import paged_decode_attention
from areal_tpu_torch.ops.ngram import propose_ngram
from areal_tpu_torch.ops.sampling import apply_top_k, apply_top_p, spec_accept

torch.set_num_threads(2)


@pytest.mark.parametrize("row,lens,k,m,want", [
    ([1, 2, 3, 9, 8, 2, 3, 0, 0, 0, 0, 0], 7, 2, 2, [9, 8]),  # continuation of a match
    ([5, 6, 7, 1, 5, 6, 42, 3, 5, 6], 10, 1, 2, [42]),  # the most recent match wins
    ([4, 5, 6, 7, 0, 0], 4, 3, 2, [7, 7, 7]),  # no match: repeat the last token
    ([9, 0, 0, 0], 1, 2, 3, [9, 9]),  # history shorter than the gram
    ([1, 2, 8, 1, 2, 0, 0, 0], 5, 3, 2, [8, 1, 2]),  # continuation clamped to history
], ids=["continuation", "most_recent", "fallback", "short", "clamped"])
def test_propose_ngram_cases(row, lens, k, m, want):
    got = propose_ngram(torch.tensor([row]), torch.tensor([lens]), k=k, m=m)
    np.testing.assert_array_equal(got.numpy(), [want])
    j = jpropose(jnp.asarray([row], jnp.int32), jnp.asarray([lens]), k=k, m=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


@pytest.mark.parametrize("k,m", [(1, 2), (3, 3), (4, 1)])
def test_propose_ngram_matches_jax(k, m):
    """Small-alphabet histories (many matches) of varied lengths."""
    rng = np.random.default_rng(k * 10 + m)
    tokens = rng.integers(0, 4, (16, 40)).astype(np.int32)
    lens = rng.integers(0, 41, 16).astype(np.int32)
    lens[:3] = (0, 1, 40)
    got = propose_ngram(torch.from_numpy(tokens).long(), torch.from_numpy(lens), k=k, m=m)
    want = jpropose(jnp.asarray(tokens), jnp.asarray(lens), k=k, m=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _logits_drafts(seed, b=16, k=3, v=24):
    """Random logits and drafts that are the argmax for a random prefix
    of each row (so every accept count occurs), in both packages."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32) * 2.0
    argm = logits.argmax(-1)
    drafts = argm[:, :k].copy()
    for r in range(b):
        j = r % (k + 1)
        if j < k:
            drafts[r, j] = (drafts[r, j] + 1) % v
    return logits, drafts.astype(np.int32)


def _assert_same(got, want, atol=1e-5):
    (te, tl, tn), (je, jl, jn) = got, want
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)


def test_spec_accept_greedy_matches_jax():
    logits, drafts = _logits_drafts(0)
    got = spec_accept(torch.from_numpy(logits), torch.from_numpy(drafts).long(), greedy=True)
    want = jspec_accept(jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(0),
                        greedy=True)
    _assert_same(got, want)
    # Row r rejects draft r % 4 (none when r % 4 == 3): r % 4 + 1 emitted.
    np.testing.assert_array_equal(got[2].numpy(), np.arange(16) % 4 + 1)


@pytest.mark.parametrize("warp", [dict(), dict(temperature=0.7, top_k=5),
                                  dict(top_p=0.8)], ids=["plain", "top_k", "top_p"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "n_valid"])
def test_spec_accept_sampled_matches_jax_with_its_draws(warp, ragged):
    """The JAX function draws u_acc and u_res from two split keys; the
    port, given the same uniforms, emits the same tokens."""
    logits, drafts = _logits_drafts(1)
    b, k = drafts.shape
    key = jax.random.PRNGKey(7)
    _, k_acc, k_res = jax.random.split(key, 3)
    u_acc = np.array(jax.random.uniform(k_acc, (b, k)))
    u_res = np.array(jax.random.uniform(k_res, (b,)))
    n_valid = np.arange(b, dtype=np.int32) % (k + 2) if ragged else None
    want = jspec_accept(jnp.asarray(logits), jnp.asarray(drafts), key,
                        n_valid=None if n_valid is None else jnp.asarray(n_valid), **warp)
    got = spec_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts).long(),
        n_valid=None if n_valid is None else torch.from_numpy(n_valid),
        u_acc=torch.from_numpy(u_acc), u_res=torch.from_numpy(u_res), **warp,
    )
    _assert_same(got, want)


def test_spec_accept_k0_is_one_draw():
    """K=0: one emitted token a row, with sample_token's logp convention."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((8, 1, 32)).astype(np.float32))
    g = torch.Generator().manual_seed(7)
    emitted, logps, n = spec_accept(logits, torch.zeros((8, 0), dtype=torch.long), g)
    assert n.tolist() == [1] * 8
    ref = torch.log_softmax(logits[:, 0], -1).gather(1, emitted[:, :1])[:, 0]
    np.testing.assert_allclose(logps[:, 0].numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("top_p", [1.0, 0.8])
def test_spec_accept_marginal_distribution_preserved(top_p):
    """Twin of tests/test_spec_decode.py:96: position-0 emissions follow
    the warped model distribution whatever the draft."""
    v, n = 8, 40000
    rng = np.random.default_rng(2)
    row = rng.standard_normal((2, v)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(row, (n, 2, v)).copy())
    drafts = torch.full((n, 1), 3, dtype=torch.long)
    emitted, _, _ = spec_accept(logits, drafts, torch.Generator().manual_seed(3), top_p=top_p)
    counts = np.bincount(emitted[:, 0].numpy(), minlength=v) / n
    warped = apply_top_p(apply_top_k(torch.from_numpy(row[:1]), 0), top_p)[0].numpy()
    probs = np.exp(warped - warped.max())
    probs[warped < -1e9] = 0.0
    probs /= probs.sum()
    np.testing.assert_allclose(counts, probs, atol=0.012)


def test_spec_accept_second_position_conditional_distribution():
    """Twin of tests/test_spec_decode.py:122: among rows whose draft 0 was
    accepted, position-1 emissions follow position 1's distribution."""
    v, n = 6, 60000
    rng = np.random.default_rng(4)
    row = rng.standard_normal((3, v)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(row, (n, 3, v)).copy())
    drafts = torch.tensor([[2, 4]]).repeat(n, 1)
    emitted, _, n_emit = spec_accept(logits, drafts, torch.Generator().manual_seed(5))
    emitted, n_emit = emitted.numpy(), n_emit.numpy()
    reached = n_emit >= 2
    p0 = np.exp(row[0] - row[0].max())
    p0 /= p0.sum()
    np.testing.assert_allclose(reached.mean(), p0[2], atol=0.01)
    counts = np.bincount(emitted[reached, 1], minlength=v) / reached.sum()
    p1 = np.exp(row[1] - row[1].max())
    p1 /= p1.sum()
    np.testing.assert_allclose(counts, p1, atol=0.015)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_decode_attention_matches_jax(int8):
    """K3's Q=1 entry point on the CPU (its plain version) and the plain
    function against the JAX function's gather path: 5 slots, one with
    an empty window and one whose table ends in sentinels."""
    rng = np.random.default_rng(3)
    n_pool, ps, n_kv, n_q, d = 9, 8, 2, 4, 16
    q = rng.standard_normal((5, 1, n_q, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n_pool, ps, n_kv, d)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.02 + 0.01)
        vs = (np.abs(rng.standard_normal((n_pool, ps, n_kv))) * 0.02 + 0.01)
        ks, vs = (jnp.asarray(a, jnp.bfloat16) for a in (ks, vs))
        tks, tvs = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                    for a in (ks, vs))
    else:
        k = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
        v = rng.standard_normal((n_pool, ps, n_kv, d)).astype(np.float32)
        ks = vs = tks = tvs = None
    table = np.full((5, 3), n_pool, np.int32)
    table[0, :3] = (4, 1, 7)
    table[1, :1] = (0,)
    table[2, :2] = (8, 2)
    table[3, :1] = (5,)
    vt = np.array([20, 8, 9, 0, 1], np.int32)
    want = jpaged_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                         jnp.asarray(vt), ks, vs)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(vt), tks, tvs)
    for fn in (paged_decode_attention_kernel, paged_decode_attention):
        got = fn(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (paged_decode_attention_kernel(*args)[3] == 0).all()  # empty window
    with pytest.raises(ValueError, match="B, 1"):
        paged_decode_attention_kernel(torch.zeros((5, 2, n_q, d)), *args[1:])
