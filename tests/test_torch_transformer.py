"""The port's paged serving forward against the JAX package's on
tiny_config with one set of weights: `decode_step_ragged_paged` over a
mixed stream (decode lanes, a prefill slice, dead lanes) matches in
logits (atol 1e-5) and in the real pool pages, for fp32 and int8 pools;
`copy_pages` with sentinel padding and `_page_of` match too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

N_PAGES, PS, MP = 12, 8, 4


@pytest.fixture(scope="module")
def weights():
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _pools(rng, int8):
    """The same random pool for both packages (the port's has one more,
    trash, page)."""
    cfg = jtiny()
    shape = (cfg.n_layers, N_PAGES, PS, cfg.n_kv_heads, cfg.head_dim)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        jc = jtfm.PagedKVCache(
            k=jnp.asarray(k), v=jnp.asarray(v),
            k_scale=jnp.asarray(ks, jnp.bfloat16), v_scale=jnp.asarray(vs, jnp.bfloat16),
            page_size=PS,
        )
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jc = jtfm.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), page_size=PS)
    tc = ttfm.init_paged_kv_cache(
        ttiny(), N_PAGES, PS, dtype="int8" if int8 else torch.float32, device="cpu"
    )
    tc.k[:, :N_PAGES] = torch.from_numpy(k)
    tc.v[:, :N_PAGES] = torch.from_numpy(v)
    if int8:
        tc.k_scale[:, :N_PAGES] = torch.from_numpy(ks).to(torch.bfloat16)
        tc.v_scale[:, :N_PAGES] = torch.from_numpy(vs).to(torch.bfloat16)
    return jc, tc


def _real_pages(tc):
    out = [tc.k[:, :N_PAGES], tc.v[:, :N_PAGES]]
    if tc.quantized:
        out += [tc.k_scale[:, :N_PAGES], tc.v_scale[:, :N_PAGES]]
    return [a.float().numpy() for a in out]


def _jax_pages(jc):
    out = [jc.k, jc.v] + ([jc.k_scale, jc.v_scale] if jc.quantized else [])
    return [np.asarray(a.astype(jnp.float32)) for a in out]


def _stream():
    """3 slots: slot 0 decodes at position 13 (sentinels past its second
    page), slot 1 prefills positions 5..8 (a slice crossing its page
    boundary), slot 2 decodes at 30 (its fourth page); 3 dead lanes
    (row_of >= B).  `step` advances each live lane to its next write."""
    pt = np.full((3, MP), N_PAGES, np.int32)
    pt[0, :2] = (4, 9)
    pt[1, :2] = (0, 7)
    pt[2] = (2, 11, 5, 3)
    tokens = np.array([17, 40, 41, 42, 43, 99, 5, 6, 7], np.int32)
    pos = np.array([13, 5, 6, 7, 8, 30, 0, 0, 0], np.int32)
    row_of = np.array([0, 1, 1, 1, 1, 2, 3, 3, 3], np.int32)
    step = np.array([1, 4, 4, 4, 4, 1, 0, 0, 0], np.int32)
    return tokens, pos, pt, row_of, step


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_ragged_paged_matches_jax(weights, rng, int8):
    pj, pt_ = weights
    jc, tc = _pools(rng, int8)
    tokens, pos, pt, row_of, step = _stream()
    for _ in range(2):  # the second step reads what the first wrote
        lj, jc = jtfm.decode_step_ragged_paged(
            pj, jtiny(), jnp.asarray(tokens), jnp.asarray(pos), jc,
            jnp.asarray(pt), jnp.asarray(row_of),
        )
        lt, tc = ttfm.decode_step_ragged_paged(
            pt_, ttiny(), torch.from_numpy(tokens).long(),
            torch.from_numpy(pos).long(), tc, torch.from_numpy(pt),
            torch.from_numpy(row_of).long(),
        )
        live = row_of < 3
        np.testing.assert_allclose(
            lt.numpy()[live], np.asarray(lj)[live], atol=1e-5, rtol=0
        )
        assert np.isfinite(lt.numpy()).all()
        for got, want in zip(_real_pages(tc), _jax_pages(jc)):
            if int8 and got.dtype == np.float32 and np.abs(want).max() > 2:
                # int8 codes: a fresh value sitting on a rounding edge may
                # quantize one step apart; everything else is identical.
                assert np.abs(got - want).max() <= 1
                assert np.mean(got == want) > 0.999
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-2 if int8 else 0)
        tokens = tokens + 1
        pos = pos + step


def test_dead_lanes_write_only_the_trash_page(weights, rng):
    _, pt_ = weights
    _, tc = _pools(rng, False)
    before = [a.copy() for a in _real_pages(tc)]
    tokens, pos, pt, _, _ = _stream()
    dead = np.full_like(pos, 3)  # every lane dead
    ttfm.decode_step_ragged_paged(
        pt_, ttiny(), torch.from_numpy(tokens).long(), torch.from_numpy(pos).long(),
        tc, torch.from_numpy(pt), torch.from_numpy(dead).long(),
    )
    for a, b in zip(before, _real_pages(tc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("int8", [False, True])
def test_copy_pages_matches_jax(rng, int8):
    jc, tc = _pools(rng, int8)
    src = np.array([3, 0, N_PAGES, N_PAGES], np.int32)  # sentinel padding
    dst = np.array([10, 5, N_PAGES, N_PAGES], np.int32)
    jc = jtfm.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = ttfm.copy_pages(tc, torch.from_numpy(src), torch.from_numpy(dst))
    for got, want in zip(_real_pages(tc), _jax_pages(jc)):
        np.testing.assert_array_equal(got, want)


def test_page_of_matches_jax(rng):
    pt = rng.integers(0, 9, (5, 3)).astype(np.int32)
    pos = np.array([0, 7, 8, 23, 24], np.int32)  # 24 // 8 = 3 >= width: drop
    pj, oj = jtfm._page_of(jnp.asarray(pt), jnp.asarray(pos), 8)
    pg, og = ttfm._page_of(torch.from_numpy(pt), torch.from_numpy(pos).long(), 8)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(og.numpy(), np.asarray(oj))


def test_embed_clamps_out_of_vocab(weights):
    pj, pt_ = weights
    toks = np.array([0, 5, 511, 512, 10**6, -3], np.int32)
    want = jtfm._embed(pj, jtiny(), jnp.asarray(toks), jnp.zeros(6, jnp.int32))
    got = ttfm._embed(pt_, ttiny(), torch.from_numpy(toks).long(), torch.zeros(6).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
def test_mlp_and_norm_variants(weights, rng, act):
    pj, pt_ = weights
    cj = dataclasses.replace(jtiny(), hidden_act=act)
    ct = dataclasses.replace(ttiny(), hidden_act=act)
    h = rng.standard_normal((5, 64)).astype(np.float32)
    blk_j = jax.tree.map(lambda a: a[1], pj["blocks"])
    blk_t = {k: w[1] for k, w in pt_["blocks"].items()}
    want = jtfm._mlp_dense(jnp.asarray(h), blk_j, cj)
    got = ttfm._mlp_dense(torch.from_numpy(h), blk_t, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for norm in ("rms", "layernorm"):
        want = jtfm._norm(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                          dataclasses.replace(cj, norm_type=norm))
        got = ttfm._norm(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b),
                         dataclasses.replace(ct, norm_type=norm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# The packed-row forward (training and inference) against the JAX package
# --------------------------------------------------------------------------


def _packed_batch(rng, cfg, b=2, s=32):
    """tests/test_model.py's batch: row 0 holds segments of 10 and 15
    tokens then padding, row 1 one full segment."""
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    seg = np.zeros((b, s), dtype=np.int32)
    seg[0, :10] = 1
    seg[0, 10:25] = 2
    seg[1, :] = 1
    return tokens, seg


def _fwd(params, tokens, seg, **kw):
    return ttfm.forward(
        params, ttiny(), torch.from_numpy(tokens), torch.from_numpy(seg), **kw
    ).detach().numpy()


def test_positions_from_segments_matches_jax():
    seg = np.asarray([[1, 1, 1, 2, 2, 0, 0], [3, 3, 3, 3, 3, 3, 3]], np.int32)
    got = ttfm.positions_from_segments(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, [[0, 1, 2, 0, 1, 0, 1], [0, 1, 2, 3, 4, 5, 6]])
    np.testing.assert_array_equal(
        got, np.asarray(jtfm.positions_from_segments(jnp.asarray(seg)))
    )


def test_forward_matches_jax(weights, rng):
    """fp32 logits [B, S, V] over packed rows: atol 1e-5 (the same
    formulation; attention through each package's plain version)."""
    pj, pt_ = weights
    tokens, seg = _packed_batch(rng, ttiny(), s=128)
    want = jtfm.forward(pj, jtiny(), jnp.asarray(tokens), jnp.asarray(seg))
    got = _fwd(pt_, tokens, seg)
    assert got.dtype == np.float32 and got.shape == (2, 128, ttiny().vocab_size)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_per_token_output_matches_jax(weights, rng):
    """Fused next-token logprobs from the hidden states: atol 1e-5."""
    pj, pt_ = weights
    tokens, seg = _packed_batch(rng, ttiny())
    tj, sj = jnp.asarray(tokens), jnp.asarray(seg)
    xj, _ = jtfm.hidden_states(pj, jtiny(), tj, sj)
    want = jtfm.per_token_output(pj, jtiny(), xj, tj, sj, chunk_size=16)
    tt, st = torch.from_numpy(tokens), torch.from_numpy(seg)
    with torch.no_grad():
        xt = ttfm.hidden_states(pt_, ttiny(), tt, st)
        got = ttfm.per_token_output(pt_, ttiny(), xt, tt, st, chunk_size=16)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def critic_weights():
    pj = jtfm.init_params(jtiny(is_critic=True), jax.random.PRNGKey(12))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def test_critic_init_params_leaves_match_jax(critic_weights):
    """A critic's params: the JAX leaves and shapes, `value_head` [D, 1]
    in place of any LM head."""
    pj, _ = critic_weights
    got = ttfm.init_params(ttiny(is_critic=True), 0, device="cpu")
    want = jax.tree.map(np.asarray, pj)
    assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
    assert tuple(got["value_head"].shape) == (ttiny().hidden_dim, 1)
    assert "lm_head" not in got
    for k in want["blocks"]:
        assert tuple(got["blocks"][k].shape) == want["blocks"][k].shape, k


def test_critic_forward_matches_jax(critic_weights, rng):
    """A critic's values [B, S] fp32 from `forward` and from
    `per_token_output` over the hidden states: atol 1e-5."""
    pj, pt_ = critic_weights
    jcfg, tcfg = jtiny(is_critic=True), ttiny(is_critic=True)
    tokens, seg = _packed_batch(rng, tcfg, s=64)
    tj, sj = jnp.asarray(tokens), jnp.asarray(seg)
    tt, st = torch.from_numpy(tokens), torch.from_numpy(seg)
    want = np.asarray(jtfm.forward(pj, jcfg, tj, sj))
    xj, _ = jtfm.hidden_states(pj, jcfg, tj, sj)
    want_pto = np.asarray(jtfm.per_token_output(pj, jcfg, xj, tj, sj))
    with torch.no_grad():
        got = ttfm.forward(pt_, tcfg, tt, st)
        got_pto = ttfm.per_token_output(pt_, tcfg, ttfm.hidden_states(pt_, tcfg, tt, st), tt, st)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_pto.numpy(), want_pto, atol=1e-5, rtol=0)


class TestPackedForward:
    """Twins of tests/test_model.py TestForward :48-84 and :230."""

    def test_segment_isolation(self, weights, rng):
        _, pt_ = weights
        tokens, seg = _packed_batch(rng, ttiny())
        l1 = _fwd(pt_, tokens, seg)
        tokens2 = tokens.copy()
        tokens2[0, :10] = (tokens[0, :10] + 7) % ttiny().vocab_size
        l2 = _fwd(pt_, tokens2, seg)
        np.testing.assert_allclose(l1[0, 10:25], l2[0, 10:25], rtol=1e-5, atol=1e-5)
        assert not np.allclose(l1[0, :10], l2[0, :10])

    def test_causality(self, weights, rng):
        _, pt_ = weights
        tokens, seg = _packed_batch(rng, ttiny())
        l1 = _fwd(pt_, tokens, seg)
        tokens2 = tokens.copy()
        tokens2[1, 20] = (tokens[1, 20] + 3) % ttiny().vocab_size
        l2 = _fwd(pt_, tokens2, seg)
        np.testing.assert_allclose(l1[1, :20], l2[1, :20], rtol=1e-5, atol=1e-5)

    def test_remat_matches(self, weights, rng):
        """Every remat policy ("full", "dots", "dots_small") gives the
        same logits and the same parameter gradients as no remat."""
        _, pt_ = weights
        tokens, seg = _packed_batch(rng, ttiny())
        tt, st = torch.from_numpy(tokens), torch.from_numpy(seg)
        outs, grads = [], []
        for remat in (False, "full", "dots", "dots_small"):
            p = {k: v.clone().requires_grad_(True) for k, v in pt_["blocks"].items()}
            params = {**pt_, "blocks": p}
            x = ttfm.hidden_states(params, ttiny(), tt, st, remat=remat)
            lp = ttfm.per_token_output(params, ttiny(), x, tt, st)
            lp.sum().backward()
            outs.append(lp.detach().numpy())
            grads.append({k: v.grad.numpy() for k, v in p.items()})
        for out, grad in zip(outs[1:], grads[1:]):
            np.testing.assert_allclose(outs[0], out, rtol=1e-6)
            for k in grads[0]:
                np.testing.assert_allclose(grads[0][k], grad[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)

    @pytest.mark.parametrize("remat", ["dots", "dots_small", "bogus"])
    def test_unported_remat_raises(self, weights, rng, remat):
        """Once refused, "dots" and "dots_small" now run: the forward
        under each equals the forward without remat, bit for bit (the
        policies recompute, they do not change values); an unknown policy
        still raises."""
        _, pt_ = weights
        tokens, seg = _packed_batch(rng, ttiny())
        if remat == "bogus":
            with pytest.raises(ValueError):
                _fwd(pt_, tokens, seg, remat=remat)
            return
        np.testing.assert_array_equal(_fwd(pt_, tokens, seg, remat=remat),
                                      _fwd(pt_, tokens, seg, remat=False))


def test_value_head_bf16_gives_fp32_product(rng):
    """A critic's value head in bf16 at qwen2-1.5B's width: the values
    are an fp32 result of the bf16 product, as the JAX package's einsum
    with `preferred_element_type=jnp.float32` gives.  atol 1e-4."""
    d = 1536
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    w = (4.0 * rng.normal(size=(d, 1)) / np.sqrt(d)).astype(np.float32)
    cj = dataclasses.replace(jtiny(is_critic=True), hidden_dim=d)
    ct = dataclasses.replace(ttiny(is_critic=True), hidden_dim=d)
    want = np.asarray(jtfm._head({"value_head": jnp.asarray(w, jnp.bfloat16)}, cj,
                                 jnp.asarray(x, jnp.bfloat16)))
    got = ttfm._head({"value_head": torch.from_numpy(w).to(torch.bfloat16)}, ct,
                     torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8)
    assert np.abs(want).max() > 2.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_head_bf16_gives_fp32_product(rng):
    """bf16 operands at qwen2-1.5B's width (D=1536, |logit| <= ~4.7): the
    logits are an fp32 result of the bf16 product, as the JAX package's
    `preferred_element_type=jnp.float32` gives — not the product rounded
    to bf16 (about 1.2e-2 off at these magnitudes).  atol 1e-4."""
    d, v = 1536, 512
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    emb = (rng.normal(size=(v, d)) / np.sqrt(d)).astype(np.float32)
    cj = dataclasses.replace(jtiny(), hidden_dim=d)
    ct = dataclasses.replace(ttiny(), hidden_dim=d)
    pj = {"embed": jnp.asarray(emb, jnp.bfloat16), "lm_head": jnp.asarray(emb.T, jnp.bfloat16)}
    pt_ = {"embed": torch.from_numpy(emb).to(torch.bfloat16),
           "lm_head": torch.from_numpy(emb.T.copy()).to(torch.bfloat16)}
    want = np.asarray(jtfm._head(pj, cj, jnp.asarray(x, jnp.bfloat16)))
    got = ttfm._head(pt_, ct, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 2.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# The static generate path's forwards over a dense cache against the JAX
# package (twins of tests/test_model.py's TestDecode cases)
# --------------------------------------------------------------------------


def _right_aligned(rng, lens, sp):
    tokens = np.full((len(lens), sp), 7, np.int32)  # pad = the engine's EOS
    seg = np.zeros((len(lens), sp), np.int32)
    for r, n in enumerate(lens):
        tokens[r, sp - n :] = rng.integers(8, jtiny().vocab_size, n)
        seg[r, sp - n :] = 1
    return tokens, seg


@pytest.mark.parametrize("lens", [(5, 16, 11), (16, 16)])
def test_prefill_and_decode_step_match_jax(weights, rng, lens):
    """Right-aligned rows of different lengths: `prefill` then 8
    `decode_step`s on the same tokens.  Each logits [B, V] within atol
    1e-4 of JAX's, and the whole dense cache, leaf by leaf, within fp32
    rounding (atol 1e-5) of JAX's, its slots past the last write still
    exactly 0.  Each row's step logits also equal the port's full
    forward on that row's own sequence (2e-4, test_model.py's bound)."""
    pj, pt_ = weights
    b, sp, total = len(lens), 16, 24
    tokens, seg = _right_aligned(rng, lens, sp)
    gen = rng.integers(8, jtiny().vocab_size, (b, total - sp)).astype(np.int32)
    jc = jtfm.init_kv_cache(jtiny(), b, total, dtype=jnp.float32)
    tc = ttfm.init_kv_cache(ttiny(), b, total, dtype=torch.float32, device="cpu")
    jl, jc = jtfm.prefill(pj, jtiny(), jnp.asarray(tokens), jnp.asarray(seg), jc)
    tl, tc2 = ttfm.prefill(pt_, ttiny(), torch.from_numpy(tokens), torch.from_numpy(seg), tc)
    assert tc2 is tc and tl.dtype == torch.float32 and tuple(tl.shape) == (b, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    valid_from = np.asarray([sp - n for n in lens], np.int32)
    step_logits = []
    for step in range(total - sp):
        pos = np.asarray([n + step for n in lens], np.int32)
        jl, jc = jtfm.decode_step(
            pj, jtiny(), jnp.asarray(gen[:, step]), jnp.asarray(pos), jc,
            jnp.int32(sp + step), jnp.asarray(valid_from),
        )
        tl, _ = ttfm.decode_step(
            pt_, ttiny(), torch.from_numpy(gen[:, step]), torch.from_numpy(pos), tc,
            sp + step, torch.from_numpy(valid_from),
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"step {step}")
        step_logits.append(tl.numpy())
        if step == 3:  # slots past the last write are untouched
            assert (tc.k[:, :, sp + step + 1 :] == 0).all()
            assert (tc.v[:, :, sp + step + 1 :] == 0).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), atol=1e-5, rtol=0,
            err_msg=name,
        )
    for r, n in enumerate(lens):
        seq = np.concatenate([tokens[r, sp - n :], gen[r]])[None]
        full = _fwd(pt_, seq, np.ones_like(seq))[0]
        for step in range(total - sp):
            np.testing.assert_allclose(
                step_logits[step][r], full[n + step], atol=2e-4, rtol=2e-4,
                err_msg=f"row {r} step {step}",
            )


def test_init_kv_cache_shape_and_int8_not_ported():
    c = ttfm.init_kv_cache(ttiny(), 3, 40, dtype=torch.float32, device="cpu")
    assert tuple(c.k.shape) == (4, 3, 40, 2, 16) == tuple(c.v.shape)
    assert (c.k == 0).all() and (c.v == 0).all()
    # The int8 cache, refused here before it was ported, now has the JAX
    # package's layout: int8 codes and bf16 [L, B, S, n_kv] scales, less
    # than 0.6 of the bf16 cache's bytes (tests/test_generator.py:348).
    q = ttfm.init_kv_cache(ttiny(), 3, 40, dtype="int8", device="cpu")
    j = jtfm.init_kv_cache(jtiny(), 3, 40, dtype="int8")
    assert q.quantized and not c.quantized
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(q, name), getattr(j, name)
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == b.dtype.name
        assert (a == 0).all()
    b16 = ttfm.init_kv_cache(ttiny(), 3, 40, dtype=torch.bfloat16, device="cpu")
    assert q.nbytes() < 0.6 * b16.nbytes()
