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
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


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
        ttiny(), N_PAGES, PS, dtype="int8" if int8 else torch.float32
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
