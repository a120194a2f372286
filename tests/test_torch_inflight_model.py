"""The port's forwards of the generator's other inflight modes against the
JAX package's on tiny_config with one set of weights (fp32, the CPU):

- the dense window: `prefill(quantize_kv=True)`, `prefill_into_slots`
  (with padding rows whose writes drop), `decode_step_inflight` and
  `decode_step_spec`, each with an fp32 and an int8 cache;
- the two-program paged path: `prefill_into_pages` (sentinel chunks and
  a padding row) and `decode_step_paged`, fp32 and int8 pools.

Logits agree within 1e-4; written codes and scales are equal and float
entries agree within 1e-5; every cache entry a dropped write would have
touched is unchanged."""

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

torch.set_num_threads(1)

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _dense_pair(rng, b, s, int8):
    """The same random dense cache for both packages."""
    cfg = jtiny()
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    tc = ttfm.init_kv_cache(ttiny(), b, s, dtype="int8" if int8 else torch.float32,
                            device="cpu")
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        jc = jtfm.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          k_scale=jnp.asarray(ks, jnp.bfloat16),
                          v_scale=jnp.asarray(vs, jnp.bfloat16))
        tc.k_scale[:] = torch.from_numpy(ks).to(torch.bfloat16)
        tc.v_scale[:] = torch.from_numpy(vs).to(torch.bfloat16)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jc = jtfm.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc.k[:] = torch.from_numpy(k)
    tc.v[:] = torch.from_numpy(v)
    return jc, tc


def _fields(c, n=None):
    """Every cache tensor as fp32 numpy (pools: the first n pages)."""
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(c, name)
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            a = a[:, :n] if n is not None else a
            out.append((name, a.float().numpy()))
        else:
            out.append((name, np.asarray(a.astype(jnp.float32))))
    return out


def _assert_caches(jc, tc, n=None):
    for (name, want), (_, got) in zip(_fields(jc), _fields(tc, n)):
        if name in ("k", "v") and tc.quantized:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.endswith("scale"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_prefill_quantize_kv_matches_jax(weights, rng, int8):
    """`prefill` writes [:, :, :S] of the cache; with an int8 cache it
    emits the codes it quantized once and attends over their dequantized
    values."""
    pj, pt = weights
    tokens = rng.integers(8, 512, (3, 16)).astype(np.int32)
    seg = np.zeros((3, 16), np.int32)
    for r, n in enumerate((16, 9, 4)):
        seg[r, :n] = 1
    jc, tc = _dense_pair(rng, 3, 24, int8)
    lj, jc = jtfm.prefill(pj, jtiny(), jnp.asarray(tokens), jnp.asarray(seg), jc,
                          use_flash=False, quantize_kv=int8)
    lt, tc = ttfm.prefill(pt, ttiny(), _t(tokens), _t(seg), tc, quantize_kv=int8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
    _assert_caches(jc, tc)


def test_prefill_quantize_kv_needs_an_int8_cache(weights):
    tc = ttfm.init_kv_cache(ttiny(), 1, 8, dtype=torch.float32, device="cpu")
    tok = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="int8"):
        ttfm.prefill(weights[1], ttiny(), tok, tok, tc, quantize_kv=True)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_prefill_into_slots_drops_padding_rows(weights, rng, int8):
    """Four rows, two of them padding (slot id n_slots = 3): the real rows
    land in slots 2 and 0, slot 1 keeps its old contents, and the real
    rows' logits equal the JAX package's."""
    pj, pt = weights
    tokens = rng.integers(8, 512, (4, 16)).astype(np.int32)
    plens = np.array([11, 16, 1, 1], np.int32)
    slots = np.array([2, 0, 3, 3], np.int32)
    jc, tc = _dense_pair(rng, 3, 32, int8)
    before = [a.copy() for _, a in _fields(tc)]
    lj, jc = jtfm.prefill_into_slots(pj, jtiny(), jnp.asarray(tokens), jnp.asarray(plens),
                                     jc, jnp.asarray(slots), use_flash=False)
    lt, tc = ttfm.prefill_into_slots(pt, ttiny(), _t(tokens), _t(plens), tc,
                                     torch.from_numpy(slots))
    np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], atol=LOGIT_TOL, rtol=0)
    assert (lt[2:] == 0).all()
    _assert_caches(jc, tc)
    for (name, a), b in zip(_fields(tc), before):
        np.testing.assert_array_equal(a[:, 1], b[:, 1], err_msg=f"{name} slot 1")
        np.testing.assert_array_equal(a[:, :, 16:], b[:, :, 16:], err_msg=name)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_inflight_matches_jax(weights, rng, int8):
    """Rows at their own depths (one at the window's last slot): logits
    and the per-row writes, over three steps."""
    pj, pt = weights
    s = 24
    jc, tc = _dense_pair(rng, 3, s, int8)
    cache_len = np.array([5, 17, s - 3], np.int32)
    for step in range(3):
        tok = rng.integers(8, 512, 3).astype(np.int32)
        lj, jc = jtfm.decode_step_inflight(
            pj, jtiny(), jnp.asarray(tok), jnp.asarray(cache_len), jc,
            slots=jnp.asarray(cache_len), valid_to=jnp.asarray(cache_len + 1),
        )
        lt, tc = ttfm.decode_step_inflight(
            pt, ttiny(), _t(tok), _t(cache_len), tc, slots=_t(cache_len),
            valid_to=_t(cache_len + 1),
        )
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {step}")
        cache_len = cache_len + 1
    _assert_caches(jc, tc)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("q_len", [2, 4])
def test_decode_step_spec_matches_jax(weights, rng, int8, q_len):
    """Q = K+1 tokens per row written at slots0 .. slots0 + Q - 1 and
    attended causally; a second step from an earlier slot overwrites the
    stale entries of the first."""
    pj, pt = weights
    s = 32
    jc, tc = _dense_pair(rng, 3, s, int8)
    slots0 = np.array([4, 13, s - q_len], np.int32)
    for back in (0, 1):
        slots0 = slots0 - back
        tok = rng.integers(8, 512, (3, q_len)).astype(np.int32)
        pos = slots0[:, None] + np.arange(q_len)[None, :]
        lj, jc = jtfm.decode_step_spec(pj, jtiny(), jnp.asarray(tok), jnp.asarray(pos), jc,
                                       jnp.asarray(slots0))
        lt, tc = ttfm.decode_step_spec(pt, ttiny(), _t(tok), _t(pos), tc, _t(slots0))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
    _assert_caches(jc, tc)


def test_spec_step_equals_sequential_inflight_steps(weights, rng):
    """Twin of tests/test_spec_decode.py's sequential-steps case in the
    port: Q tokens through decode_step_spec give the logits and cache of Q
    decode_step_inflight calls."""
    _, pt = weights
    b, s, q = 2, 24, 3
    toks = _t(rng.integers(1, 512, (b, q)).astype(np.int64))
    c1 = ttfm.init_kv_cache(ttiny(), b, s, dtype=torch.float32, device="cpu")
    pos = torch.arange(q)[None, :].expand(b, q)
    spec, _ = ttfm.decode_step_spec(pt, ttiny(), toks, pos, c1, torch.zeros(b, dtype=torch.long))
    c2 = ttfm.init_kv_cache(ttiny(), b, s, dtype=torch.float32, device="cpu")
    for t in range(q):
        full = torch.full((b,), t)
        lg, _ = ttfm.decode_step_inflight(pt, ttiny(), toks[:, t], full, c2, slots=full,
                                          valid_to=full + 1)
        np.testing.assert_allclose(spec[:, t].numpy(), lg.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(c1.k.numpy(), c2.k.numpy(), atol=1e-5, rtol=1e-5)


N_PAGES, PS, MP = 10, 8, 4


def _paged_pair(rng, int8):
    cfg = jtiny()
    shape = (cfg.n_layers, N_PAGES, PS, cfg.n_kv_heads, cfg.head_dim)
    tc = ttfm.init_paged_kv_cache(ttiny(), N_PAGES, PS,
                                  dtype="int8" if int8 else torch.float32, device="cpu")
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        jc = jtfm.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                               k_scale=jnp.asarray(ks, jnp.bfloat16),
                               v_scale=jnp.asarray(vs, jnp.bfloat16), page_size=PS)
        tc.k_scale[:, :N_PAGES] = torch.from_numpy(ks).to(torch.bfloat16)
        tc.v_scale[:, :N_PAGES] = torch.from_numpy(vs).to(torch.bfloat16)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jc = jtfm.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), page_size=PS)
    tc.k[:, :N_PAGES] = torch.from_numpy(k)
    tc.v[:, :N_PAGES] = torch.from_numpy(v)
    return jc, tc


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_prefill_into_pages_matches_jax(weights, rng, int8):
    """Three rows of SP = 16 (two pages each): row 0's prompt fills pages
    3 and 7, row 1's (5 tokens) page 1 with its second chunk on the
    sentinel, row 2 is padding (all sentinel).  The mapped pages equal the
    JAX pool's, every other real page is unchanged."""
    pj, pt = weights
    tokens = rng.integers(8, 512, (3, 16)).astype(np.int32)
    plens = np.array([14, 5, 1], np.int32)
    page_rows = np.array([[3, 7], [1, N_PAGES], [N_PAGES, N_PAGES]], np.int32)
    jc, tc = _paged_pair(rng, int8)
    before = [a.copy() for _, a in _fields(tc, N_PAGES)]
    lj, jc = jtfm.prefill_into_pages(pj, jtiny(), jnp.asarray(tokens), jnp.asarray(plens),
                                     jc, jnp.asarray(page_rows), use_flash=False)
    lt, tc = ttfm.prefill_into_pages(pt, ttiny(), _t(tokens), _t(plens), tc, _t(page_rows))
    np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], atol=LOGIT_TOL, rtol=0)
    _assert_caches(jc, tc, N_PAGES)
    untouched = [p for p in range(N_PAGES) if p not in (1, 3, 7)]
    for (name, a), b in zip(_fields(tc, N_PAGES), before):
        np.testing.assert_array_equal(a[:, untouched], b[:, untouched], err_msg=name)


def test_prefill_into_pages_needs_whole_pages(weights):
    tc = ttfm.init_paged_kv_cache(ttiny(), 2, PS, dtype=torch.float32, device="cpu")
    tok = torch.ones((1, PS + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="multiple of page_size"):
        ttfm.prefill_into_pages(weights[1], ttiny(), tok, torch.ones(1), tc,
                                torch.zeros((1, 2), dtype=torch.long))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_paged_matches_jax(weights, rng, int8):
    """Three slots over the page table (slot 1 writes across a page
    boundary, slot 2 unmapped: its write drops), three steps: logits of
    the live slots and every real page."""
    pj, pt = weights
    table = np.full((3, MP), N_PAGES, np.int32)
    table[0, :2] = (6, 2)
    table[1, :3] = (0, 8, 5)
    pos = np.array([9, 15, 0], np.int32)
    jc, tc = _paged_pair(rng, int8)
    for step in range(3):
        tok = rng.integers(8, 512, 3).astype(np.int32)
        lj, jc = jtfm.decode_step_paged(pj, jtiny(), jnp.asarray(tok), jnp.asarray(pos), jc,
                                        jnp.asarray(table), jnp.asarray(pos),
                                        jnp.asarray(pos + 1))
        lt, tc = ttfm.decode_step_paged(pt, ttiny(), _t(tok), _t(pos), tc, _t(table),
                                        _t(pos), _t(pos + 1))
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], atol=LOGIT_TOL,
                                   rtol=0, err_msg=f"step {step}")
        pos = pos + np.array([1, 1, 0], np.int32)
    _assert_caches(jc, tc, N_PAGES)
