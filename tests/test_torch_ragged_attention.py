"""The port's ragged paged attention on CPU tensors (its plain version)
against the JAX package's Pallas kernel `ragged_paged_attention_kernel`
(run in interpret mode, as tests/test_paged_kv.py runs it) and its XLA
gather fallback, on the same mixed stream: fp32 at 2e-5, dead lanes
exactly 0, sentinel pages add no mass, int8 pools at 3e-5.  On the CPU
the dispatcher never launches the CUDA kernel.

The CUDA kernel is split-KV; its arithmetic (a partial per span of the
window, then the merge) is `ragged_paged_attention_split_reference`,
held here in fp32 against the same JAX kernels and the plain version at
the same tolerances, with split boundaries on a page edge, mid-page, at
exactly one span, past the table (a 2100 window over 16 pages of 16)
and at windows of 0 and 1."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.attention import ragged_paged_attention as jax_fallback
from areal_tpu.ops.pallas.paged_attention import ragged_paged_attention_kernel as jax_kernel
from areal_tpu_torch.kernels import ragged_paged_attention as rpa

torch.set_num_threads(2)

N_POOL, PS, N_KV, D, REP = 10, 8, 2, 16, 3


def _stream(rng):
    """4 rows: decode (1 lane), prefill slice (4 lanes), spec-style
    verify (3 lanes), dead row (0 lanes) + 4 slack lanes -> T = 12; the
    tables carry sentinels (N_POOL) past each row's pages."""
    k = rng.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
    v = rng.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
    pt = np.full((4, 3), N_POOL, np.int32)
    pt[0] = (0, 1, 2)
    pt[1, :2] = (3, 4)
    pt[2, 0] = 5
    pt[3] = (6, 7, 8)
    row_of = np.array([0, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 4], np.int32)
    pos = np.array([19, 9, 10, 11, 12, 2, 3, 4, 0, 0, 0, 0], np.int32)
    live = row_of < 4
    pt_tok = np.take(pt, np.minimum(row_of, 3), axis=0)
    vt = np.where(live, pos + 1, 0).astype(np.int32)
    q = rng.standard_normal((12, N_KV * REP, D)).astype(np.float32)
    return q, k, v, pt_tok, vt


def _port(q, k, v, pt, vt, ks=None, vs=None):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return rpa.ragged_paged_attention_kernel(
        t(q), t(k), t(v), t(pt), t(vt),
        None if ks is None else t(ks).to(torch.bfloat16),
        None if vs is None else t(vs).to(torch.bfloat16),
    ).numpy()


@pytest.fixture
def stream(rng):
    return _stream(rng)


def test_fp32_matches_jax_kernel_and_fallback(stream):
    q, k, v, pt, vt = stream
    args = [jnp.asarray(a) for a in (q, k, v, pt, vt)]
    out = _port(q, k, v, pt, vt)
    np.testing.assert_allclose(out, np.asarray(jax_kernel(*args)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(jax_fallback(*args)), atol=2e-5, rtol=2e-5)


def test_dead_lanes_exact_zero(stream):
    out = _port(*stream)
    assert float(np.abs(out[8:]).max()) == 0.0
    assert np.all(np.abs(out[:8]).max(axis=(1, 2)) > 0)  # live lanes are not


def test_sentinel_pages_add_no_mass(stream):
    q, k, v, pt, vt = stream
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[N_POOL - 1] = 1e9
    v_bad[N_POOL - 1] = 1e9
    np.testing.assert_array_equal(_port(q, k, v, pt, vt), _port(q, k_bad, v_bad, pt, vt))


def test_int8_pool_matches_jax(stream):
    q, _, _, pt, vt = stream
    r = np.random.default_rng(3)
    k8 = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
    v8 = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
    ks = (np.abs(r.standard_normal((N_POOL, PS, N_KV))) + 0.1).astype(np.float32)
    vs = (np.abs(r.standard_normal((N_POOL, PS, N_KV))) + 0.1).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (q, k8, v8, pt, vt)] + [
        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
    ]
    out = _port(q, k8, v8, pt, vt, ks, vs)
    np.testing.assert_allclose(out, np.asarray(jax_kernel(*jargs)), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out, np.asarray(jax_fallback(*jargs)), atol=3e-5, rtol=3e-5)


def test_cpu_dispatch_never_launches(stream):
    before = rpa.LAUNCHES
    _port(*stream)
    q, k, v, pt, vt = (torch.from_numpy(np.array(a)) for a in stream)
    rpa.ragged_paged_attention_kernel(q, k, v, pt, vt)
    assert rpa.LAUNCHES == before


def test_no_fallback_off_the_cpu(stream):
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    wrapper takes the plain version only for CPU tensors."""
    q, k, v, pt, vt = (torch.from_numpy(np.array(a)).to("meta") for a in stream)
    with pytest.raises(ValueError, match="device"):
        rpa.ragged_paged_attention_kernel(q, k, v, pt, vt)


def test_window_past_the_table_is_bounded_by_it(stream):
    """A window longer than max_pages * page_size sees only the pages its
    table addresses, as in the JAX kernel's grid and gather fallback."""
    q, k, v, pt, vt = stream
    vt = vt.copy()
    vt[0] = 100  # 3 pages of 8 positions in the table
    args = [jnp.asarray(a) for a in (q, k, v, pt, vt)]
    out = _port(q, k, v, pt, vt)
    np.testing.assert_allclose(out, np.asarray(jax_kernel(*args)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(jax_fallback(*args)), atol=2e-5, rtol=2e-5)


# --- the split-KV arithmetic of the CUDA kernel ----------------------------

LONG_PS, LONG_MP, LONG_POOL = 16, 16, 40


def _long_stream(rng):
    """7 lanes over tables of 16 pages of 16 (S = 256): a 2100 window
    (bounded by its table), windows of 1, 0, 255, 40 (mid-page), 16 (one
    page) and 17; sentinels past each lane's pages; pool page
    LONG_POOL - 1 never mapped."""
    vt = np.array([2100, 1, 0, 255, 40, 16, 17], np.int32)
    perm = rng.permutation(LONG_POOL - 1)
    pt = np.full((len(vt), LONG_MP), LONG_POOL, np.int32)
    used = 0
    for i, w in enumerate(vt):
        n = min(LONG_MP, -(-int(w) // LONG_PS))
        pt[i, :n] = np.resize(perm, used + n)[used:]
        used = (used + n) % (LONG_POOL - 1)
    k = rng.standard_normal((LONG_POOL, LONG_PS, N_KV, D)).astype(np.float32)
    v = rng.standard_normal((LONG_POOL, LONG_PS, N_KV, D)).astype(np.float32)
    q = rng.standard_normal((len(vt), N_KV * REP, D)).astype(np.float32)
    return q, k, v, pt, vt


def _int8(shape_pool, seed):
    r = np.random.default_rng(seed)
    k8 = r.integers(-127, 128, shape_pool).astype(np.int8)
    v8 = r.integers(-127, 128, shape_pool).astype(np.int8)
    ks = (np.abs(r.standard_normal(shape_pool[:3])) + 0.1).astype(np.float32)
    vs = (np.abs(r.standard_normal(shape_pool[:3])) + 0.1).astype(np.float32)
    return k8, v8, ks, vs


@functools.lru_cache(maxsize=None)
def _long_case(int8):
    """The long stream and the JAX Pallas kernel's output on it (computed
    once: its interpret-mode grid is 7 x 2 x 16 steps)."""
    q, k, v, pt, vt = _long_stream(np.random.default_rng(11))
    ks = vs = None
    if int8:
        k, v, ks, vs = _int8(k.shape, 12)
    jargs = [jnp.asarray(a) for a in (q, k, v, pt, vt)]
    if int8:
        jargs += [jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)]
    return (q, k, v, pt, vt, ks, vs), np.asarray(jax_kernel(*jargs))


def _split(q, k, v, pt, vt, ks=None, vs=None, *, span):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    bf = torch.bfloat16
    return rpa.ragged_paged_attention_split_reference(
        t(q), t(k), t(v), t(pt), t(vt),
        None if ks is None else t(ks).to(bf), None if vs is None else t(vs).to(bf),
        span=span,
    ).numpy()


@pytest.mark.parametrize("span", [8, 5, 24, 3, 1])
def test_split_reference_matches_jax_and_plain(stream, span):
    """The 3-page (24-position) tables of the mixed stream: spans on a
    page edge (8), mid-page (5, 3), exactly one span (24) and one
    position a span (1, most spans empty)."""
    q, k, v, pt, vt = stream
    args = [jnp.asarray(a) for a in (q, k, v, pt, vt)]
    out = _split(q, k, v, pt, vt, span=span)
    np.testing.assert_allclose(out, np.asarray(jax_kernel(*args)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(jax_fallback(*args)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, _port(q, k, v, pt, vt), atol=2e-5, rtol=2e-5)
    assert float(np.abs(out[8:]).max()) == 0.0  # dead lanes


@pytest.mark.parametrize("span", [16, 40, 256, 7])
def test_split_reference_past_the_table(span):
    """Windows of 2100 over 16 pages (bounded by the table), 0, 1, 255,
    40, 16 and 17: spans of one page, 2.5 pages (boundaries mid-page),
    the whole table (one span) and 7 positions, against the Pallas
    kernel and the plain version."""
    (q, k, v, pt, vt, _, _), want = _long_case(False)
    out = _split(q, k, v, pt, vt, span=span)
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, _port(q, k, v, pt, vt), atol=2e-5, rtol=2e-5)
    assert (out[vt == 0] == 0).all() and np.abs(out[vt == 1]).max() > 0


@pytest.mark.parametrize("span", [16, 40, 256])
def test_split_reference_int8_pool(span):
    """int8 pools with bf16 scales, dequantized in fp32: the Pallas
    kernel's 3e-5 bound."""
    (q, k8, v8, pt, vt, ks, vs), want = _long_case(True)
    out = _split(q, k8, v8, pt, vt, ks, vs, span=span)
    np.testing.assert_allclose(out, want, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out, _port(q, k8, v8, pt, vt, ks, vs), atol=3e-5, rtol=3e-5)
    assert (out[vt == 0] == 0).all()


def test_split_reference_empty_splits_add_no_mass(stream):
    """Widening every table by 8 sentinel pages adds spans past every
    window: they must add no mass, and the sentinel-clamped last page
    (poisoned) must not leak in."""
    q, k, v, pt, vt = stream
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[N_POOL - 1] = v_bad[N_POOL - 1] = 1e9
    wide = np.concatenate([pt, np.full((pt.shape[0], 8), N_POOL, np.int32)], axis=1)
    base = _split(q, k, v, pt, vt, span=PS)
    np.testing.assert_allclose(_split(q, k_bad, v_bad, wide, vt, span=PS), base,
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_split(q, k_bad, v_bad, pt, vt, span=PS), base)


def test_split_plan_from_shapes_alone():
    """Whole pages of about 256 positions a span, covering the table."""
    assert rpa.split_plan(16, 128) == (2, 8)
    assert rpa.split_plan(3, 8) == (32, 1)
    assert rpa.split_plan(17, 128) == (2, 9)
    assert rpa.split_plan(4, 512) == (1, 4)


# --- bf16 q over an int8 pool: the tensor-core int8 path -------------------


def _row_err(got, want):
    """Largest per-row error relative to the row's largest |want| (rows
    under the output's RMS take the RMS), as chip_smoke.py measures."""
    err = np.abs(got - want).max(-1)
    mag = np.abs(want).max(-1)
    live = want[mag > 0]
    rms = float(np.sqrt(np.mean(live**2))) if live.size else 1.0
    return float((err / np.maximum(mag, rms)).max())


@functools.lru_cache(maxsize=None)
def _long_case_bf16q():
    """The long stream's int8 pool with q rounded to bf16, and the JAX
    Pallas kernel's output on an fp32 copy of that q (computed once)."""
    (q, k8, v8, pt, vt, ks, vs), _ = _long_case(True)
    q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    jargs = [jnp.asarray(a) for a in (q, k8, v8, pt, vt)]
    jargs += [jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)]
    return (q, k8, v8, pt, vt, ks, vs), np.asarray(jax_kernel(*jargs))


@pytest.mark.parametrize("span", [16, 40, 256])
def test_split_reference_bf16q_int8_matches_jax(span):
    """The model of the int8 tensor-core path (bf16 q, scores scaled by
    s_k, P' = bf16(P s_v), l over the unscaled P) against the Pallas
    kernel in interpret mode on an fp32 copy of the same q: within the
    bf16 row tolerance 2^-7, over windows past the table, of 0 and 1,
    ending mid-page and mid-span; dead lanes exactly 0."""
    (q, k8, v8, pt, vt, ks, vs), want = _long_case_bf16q()
    bf = torch.bfloat16
    got = rpa.ragged_paged_attention_split_reference(
        torch.from_numpy(q).to(bf), *(torch.from_numpy(a) for a in (k8, v8, pt, vt)),
        torch.from_numpy(ks).to(bf), torch.from_numpy(vs).to(bf), span=span,
    ).numpy()
    assert _row_err(got, want) <= 2**-7
    assert (got[vt == 0] == 0).all() and (want[vt == 0] == 0).all()
    assert (np.abs(got[vt > 0]).max(-1) > 0).all()


def test_split_reference_bf16q_int8_sentinel_pages_add_no_mass(stream):
    """bf16 q over an int8 pool: the sentinel-clamped last page, its codes
    and scales poisoned, changes nothing; 8 sentinel pages more add
    spans with no mass."""
    q, _, _, pt, vt = stream
    k8, v8, ks, vs = (a.copy() for a in _int8((N_POOL, PS, N_KV, D), 5))
    bf = torch.bfloat16

    def split(k8, v8, ks, vs, pt):
        return rpa.ragged_paged_attention_split_reference(
            torch.from_numpy(q).to(bf), *(torch.from_numpy(a) for a in (k8, v8, pt, vt)),
            torch.from_numpy(ks).to(bf), torch.from_numpy(vs).to(bf), span=PS,
        ).numpy()

    base = split(k8, v8, ks, vs, pt)
    k8[N_POOL - 1] = v8[N_POOL - 1] = 127
    ks[N_POOL - 1] = vs[N_POOL - 1] = 1e9
    wide = np.concatenate([pt, np.full((pt.shape[0], 8), N_POOL, np.int32)], axis=1)
    np.testing.assert_array_equal(split(k8, v8, ks, vs, pt), base)
    np.testing.assert_array_equal(split(k8, v8, ks, vs, wide), base)
    assert float(np.abs(base[8:]).max()) == 0.0


def test_split_plan_shortens_spans_of_small_grids():
    """Given the (token, kv head) pairs, the span halves while the grid
    would hold fewer than SPLIT_MIN_BLOCKS blocks: 16 one-token slots of a
    6-page table of 128 (K3's Q=1 entry point) take one-page spans, 64
    slots and the 96-lane stream keep two."""
    assert rpa.SPLIT_MIN_BLOCKS == 132
    assert rpa.split_plan(6, 128, 16 * 2) == (1, 6)
    assert rpa.split_plan(6, 128, 64 * 2) == (2, 3)
    assert rpa.split_plan(16, 128, 96 * 2) == (2, 8)
    assert rpa.split_plan(6, 16, 8) == (1, 6)  # 16 pages of 16 halve to 1
    assert rpa.split_plan(64, 16, 8) == (2, 32)  # 16 -> 8 -> 4 -> 2 pages
    assert rpa.split_plan(3, 8) == rpa.split_plan(3, 8, 0) == (32, 1)
