"""The port's dense decode attention (K4) against the JAX package on the
CPU: twins of TestDecodeAttentionKernel in tests/test_flash_attention.py.

K4's plain versions — `ops/attention.decode_attention` (Q=1) and the
kernel wrapper on CPU tensors, which is `decode_attention_chunk` with
every query live — against the Pallas kernels `decode_attention_kernel`
and `decode_attention_chunk_kernel` in interpret mode (as the JAX
package's own tests run them): fp32 within atol/rtol 2e-5, an int8 cache
with scales within 3e-4 (the JAX tests' bounds between their two paths);
rows whose window is empty exactly 0 on both sides.

The CUDA kernel is split-KV; its arithmetic (a partial per span of the
window from valid_from, then the merge) is
`decode_attention_chunk_split_reference`, held here in fp32 against the
same Pallas kernels and the plain version at the same tolerances, with
split boundaries mid-window, on window edges, at exactly one span and at
windows of 0 and 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models.transformer import kv_quant as jax_kv_quant
from areal_tpu.ops.pallas.decode_attention import (
    decode_attention_chunk_kernel as jax_chunk_kernel,
)
from areal_tpu.ops.pallas.decode_attention import decode_attention_kernel as jax_kernel
from areal_tpu_torch.kernels import decode_attention as da
from areal_tpu_torch.ops.attention import decode_attention

torch.set_num_threads(2)


def _mk(rng, b=4, s=256, nq=8, nkv=2, d=128, nq_tok=1):
    q = rng.standard_normal((b, nq_tok, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, d)).astype(np.float32)
    lo = rng.integers(0, s // 4, b).astype(np.int32)
    hi = rng.integers(s // 2, s, b).astype(np.int32)
    return q, k, v, lo, hi


def _t(a, dtype=None):
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def _port_kernel(q, k, v, lo, hi, ks=None, vs=None):
    bf = torch.bfloat16
    return da.decode_attention_chunk_kernel(
        _t(q), _t(k), _t(v), _t(lo), _t(hi),
        None if ks is None else _t(ks, bf), None if vs is None else _t(vs, bf),
    ).numpy()


def _port_plain_q1(q, k, v, lo, hi, ks=None, vs=None):
    bf = torch.bfloat16
    return decode_attention(
        _t(q), _t(k), _t(v), _t(lo).long(), _t(hi).long(),
        None if ks is None else _t(ks, bf), None if vs is None else _t(vs, bf),
    ).numpy()


def _jax(q, k, v, lo, hi, ks=None, vs=None, chunk=False, **kw):
    fn = jax_chunk_kernel if chunk else jax_kernel
    return np.asarray(fn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lo),
        jnp.asarray(hi),
        k_scale=None if ks is None else jnp.asarray(ks, jnp.bfloat16),
        v_scale=None if vs is None else jnp.asarray(vs, jnp.bfloat16), **kw,
    ))


@pytest.mark.parametrize("form", ["wrapper", "plain_q1"])
def test_matches_jax_kernel(rng, form):
    q, k, v, lo, hi = _mk(rng)
    want = _jax(q, k, v, lo, hi, block_k=64)
    port = _port_kernel if form == "wrapper" else _port_plain_q1
    np.testing.assert_allclose(port(q, k, v, lo, hi), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("form", ["wrapper", "plain_q1"])
def test_matches_jax_kernel_int8(rng, form):
    q, k, v, lo, hi = _mk(rng)
    kq, ks = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(v)))
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)  # exact bf16 values
    want = _jax(q, kq, vq, lo, hi, ks, vs, block_k=64)
    port = _port_kernel if form == "wrapper" else _port_plain_q1
    np.testing.assert_allclose(
        port(q, kq, vq, lo, hi, ks, vs), want, rtol=3e-4, atol=3e-4
    )


def test_scalar_valid_to(rng):
    """JAX's generator passes one valid_to for every row; the port's
    wrapper takes it per row."""
    q, k, v, lo, _ = _mk(rng)
    want = np.asarray(jax_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lo),
        jnp.int32(200), block_k=64,
    ))
    hi = np.full((q.shape[0],), 200, np.int32)
    np.testing.assert_allclose(_port_kernel(q, k, v, lo, hi), want, rtol=2e-5, atol=2e-5)


def test_default_block_on_bucketed_window(rng):
    """A 1280 window, which the default 512 block does not divide: JAX
    halves its block; the port has no block to fit."""
    q, k, v, lo, hi = _mk(rng, b=2, s=1280)
    want = _jax(q, k, v, lo, hi)
    np.testing.assert_allclose(_port_kernel(q, k, v, lo, hi), want, rtol=2e-5, atol=2e-5)


def test_chunk_kernel_matches_jax(rng):
    b, s, Q = 3, 256, 4
    q, k, v, _, _ = _mk(rng, b=b, s=s, nq_tok=Q)
    lo = rng.integers(0, 32, b).astype(np.int32)
    hi0 = rng.integers(64, s - Q, b).astype(np.int32)
    want = _jax(q, k, v, lo, hi0, chunk=True, block_k=64)
    np.testing.assert_allclose(_port_kernel(q, k, v, lo, hi0), want, rtol=2e-5, atol=2e-5)


def test_empty_window_rows_exactly_zero(rng):
    """valid_from >= valid_to: exact zeros on both sides, the live row
    real and equal."""
    s = 128
    q, k, v, _, _ = _mk(rng, b=4, s=s)
    lo = np.array([0, 64, s, 100], np.int32)
    hi = np.array([64, 64, 64, 40], np.int32)  # rows 1-3 empty
    empty = lo >= hi
    want = _jax(q, k, v, lo, hi, block_k=64)
    got = _port_kernel(q, k, v, lo, hi)
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    assert np.abs(got[~empty]).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_empty_window_rows_exactly_zero_chunk(rng):
    """Chunk form: query i sees [valid_from, valid_to0 + i), so a row
    with valid_from >= valid_to0 + Q - 1 has every query empty, and row
    2 here has its first queries empty and its last live."""
    s, Q = 128, 3
    q, k, v, _, _ = _mk(rng, b=3, s=s, nq_tok=Q)
    lo = np.array([0, s, 31], np.int32)
    to0 = np.array([64, 64, 30], np.int32)
    want = _jax(q, k, v, lo, to0, chunk=True, block_k=64)
    got = _port_kernel(q, k, v, lo, to0)
    assert (got[1] == 0).all() and (got[2, :2] == 0).all()
    assert (want[1] == 0).all() and np.abs(got[2, 2]).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_launches_nothing(rng):
    q, k, v, lo, hi = _mk(rng, b=2, s=64)
    before = da.LAUNCHES
    _port_kernel(q, k, v, lo, hi)
    da.decode_attention_kernel(_t(q), _t(k), _t(v), _t(lo), _t(hi))
    assert da.LAUNCHES == before
    with pytest.raises(ValueError, match="B, 1"):
        da.decode_attention_kernel(_t(q).repeat(1, 2, 1, 1), _t(k), _t(v), _t(lo), _t(hi))


@pytest.mark.parametrize("bad", ["lo_dtype", "lo_shape", "rows", "scales", "head_dim"])
def test_card_input_checks(rng, bad):
    """What the kernel reads through raw pointers is checked before a
    launch (the checks run on any device)."""
    q, k, v, lo, hi = (_t(x) for x in _mk(rng, b=2, s=64))
    ks = vs = None
    if bad == "lo_dtype":
        lo = lo.long()
    elif bad == "lo_shape":
        lo = lo[:1]
    elif bad == "rows":
        k, v = k[:1], v[:1]
    elif bad == "scales":
        ks = vs = torch.ones(k.shape[:3], dtype=torch.bfloat16)
    else:
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    with pytest.raises((ValueError, TypeError)):
        da._check(q.contiguous(), k.contiguous(), v.contiguous(), lo, hi, ks, vs)


# --- the split-KV arithmetic of the CUDA kernel ----------------------------


def _split(q, k, v, lo, hi, ks=None, vs=None, *, span):
    bf = torch.bfloat16
    return da.decode_attention_chunk_split_reference(
        _t(q), _t(k), _t(v), _t(lo), _t(hi),
        None if ks is None else _t(ks, bf), None if vs is None else _t(vs, bf),
        span=span,
    ).numpy()


def _edge_rows(rng, s=256):
    """Windows of 0, 1, 64 +- 1 and the whole cache from random starts."""
    lo = np.array([0, 7, 3, 5, 0, 100, 200, 255], np.int32)
    lens = np.array([s, 1, 63, 64, 65, 0, 56, 1], np.int32)
    q, k, v, _, _ = _mk(rng, b=len(lo), s=s)
    return q, k, v, lo, lo + lens


@pytest.mark.parametrize("span", [64, 50, 256, 16, 1])
def test_split_reference_matches_jax_kernel(rng, span):
    """Spans that end on the 64-position Pallas block (64, 16), fall
    mid-block (50), cover the whole cache in one span (256) and hold one
    position each (1)."""
    q, k, v, lo, hi = _edge_rows(rng)
    want = _jax(q, k, v, lo, hi, block_k=64)
    got = _split(q, k, v, lo, hi, span=span)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _port_kernel(q, k, v, lo, hi), rtol=2e-5, atol=2e-5)
    empty = lo >= hi
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    assert (np.abs(got[~empty]).max(axis=(1, 2, 3)) > 0).all()


@pytest.mark.parametrize("span", [64, 50, 256])
def test_split_reference_chunk_matches_jax(rng, span):
    """Chunk form: query i sees [valid_from, valid_to0 + i); row 1 has
    every query empty, row 2 its first two."""
    s, Q = 256, 3
    q, k, v, _, _ = _mk(rng, b=4, s=s, nq_tok=Q)
    lo = np.array([0, s, 31, 10], np.int32)
    to0 = np.array([64, 64, 30, 200], np.int32)
    want = _jax(q, k, v, lo, to0, chunk=True, block_k=64)
    got = _split(q, k, v, lo, to0, span=span)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _port_kernel(q, k, v, lo, to0), rtol=2e-5, atol=2e-5)
    assert (got[1] == 0).all() and (got[2, :2] == 0).all()


@pytest.mark.parametrize("span", [64, 50])
def test_split_reference_int8_cache(rng, span):
    """int8 cache with bf16 scales: the JAX tests' 3e-4 bound."""
    q, k, v, lo, hi = _edge_rows(rng)
    kq, ks = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(v)))
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    want = _jax(q, kq, vq, lo, hi, ks, vs, block_k=64)
    got = _split(q, kq, vq, lo, hi, ks, vs, span=span)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        got, _port_kernel(q, kq, vq, lo, hi, ks, vs), rtol=3e-4, atol=3e-4
    )
    assert (got[lo >= hi] == 0).all()


def test_split_reference_empty_splits_add_no_mass(rng):
    """64 more positions past every window add a span with no mass, and
    K/V poisoned outside every window change nothing."""
    q, k, v, lo, hi = _edge_rows(rng)
    base = _split(q, k, v, lo, hi, span=64)
    pad = rng.standard_normal((k.shape[0], 64) + k.shape[2:]).astype(np.float32)
    wide = [np.concatenate([x, pad], axis=1) for x in (k, v)]
    np.testing.assert_allclose(_split(q, *wide, lo, hi, span=64), base, atol=1e-6, rtol=1e-6)
    pos = np.arange(k.shape[1])
    outside = (pos[None, :] < lo[:, None]) | (pos[None, :] >= hi[:, None])
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[outside] = v_bad[outside] = 1e9
    np.testing.assert_array_equal(_split(q, k_bad, v_bad, lo, hi, span=64), base)


def test_split_plan_from_shapes_alone():
    """Spans of 256 positions covering the S-position cache."""
    assert da.split_plan(1024) == (256, 4)
    assert da.split_plan(1280) == (256, 5)
    assert da.split_plan(256) == (256, 1)
    assert da.split_plan(257) == (256, 2)


# --- bf16 q over an int8 cache: the tensor-core int8 path ------------------


def _row_err(got, want):
    """Largest per-row error relative to the row's largest |want| (rows
    under the output's RMS take the RMS), as chip_smoke.py measures."""
    err = np.abs(got - want).max(-1)
    mag = np.abs(want).max(-1)
    live = want[mag > 0]
    rms = float(np.sqrt(np.mean(live**2))) if live.size else 1.0
    return float((err / np.maximum(mag, rms)).max())


def _bf16(a):
    """The bf16 value of each element, held as fp32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _split_bf16q(q, k, v, lo, hi, ks, vs, *, span):
    bf = torch.bfloat16
    return da.decode_attention_chunk_split_reference(
        _t(q, bf), _t(k), _t(v), _t(lo), _t(hi), _t(ks, bf), _t(vs, bf), span=span,
    ).numpy()


@pytest.mark.parametrize("nq_tok", [1, 5])
@pytest.mark.parametrize("span", [64, 50])
def test_split_reference_bf16q_int8_matches_jax(rng, nq_tok, span):
    """The model of the int8 tensor-core path (bf16 q, the scores scaled
    by s_k, P' = bf16(P s_v), l over the unscaled P) against the Pallas
    chunk kernel in interpret mode on an fp32 copy of the same bf16 q:
    within the bf16 row tolerance 2^-7.  Windows end mid-span and on
    span edges; rows 0 and 5 see nothing (exactly 0 on both sides)."""
    s = 256
    lo = np.array([200, 7, 3, 5, 0, 100, 31, 1], np.int32)
    hi0 = np.array([40, 8, 70, 69, 256 - nq_tok, 100 - nq_tok, 150, 129], np.int32)
    q, k, v, _, _ = _mk(rng, b=len(lo), s=s, nq_tok=nq_tok)
    q = _bf16(q)
    kq, ks = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in jax_kv_quant(jnp.asarray(v)))
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    want = _jax(q, kq, vq, lo, hi0, ks, vs, chunk=True, block_k=64)
    got = _split_bf16q(q, kq, vq, lo, hi0, ks, vs, span=span)
    assert _row_err(got, want) <= 2**-7
    empty = lo[:, None] >= hi0[:, None] + np.arange(nq_tok)[None, :]  # [B, Q]
    assert empty[0].all() and empty[5].all()
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    assert (np.abs(got[~empty]).max(-1) > 0).all()


def test_split_reference_int8_unit_scales_is_the_bf16_path(rng):
    """With every scale 1, bf16 q over the int8 codes is the bf16 path on
    the same values (int8 is exact in bf16): bit for bit."""
    q, k, v, lo, hi = _edge_rows(rng)
    k8 = rng.integers(-127, 128, k.shape).astype(np.int8)
    v8 = rng.integers(-127, 128, v.shape).astype(np.int8)
    ones = np.ones(k.shape[:3], np.float32)
    bf = torch.bfloat16
    want = da.decode_attention_chunk_split_reference(
        _t(q, bf), _t(k8, bf), _t(v8, bf), _t(lo), _t(hi), span=64,
    ).numpy()
    np.testing.assert_array_equal(_split_bf16q(q, k8, v8, lo, hi, ones, ones, span=64), want)


def test_split_reference_bf16q_int8_poison_outside_windows(rng):
    """Codes and scales poisoned outside every window change nothing."""
    q, k, v, lo, hi = _edge_rows(rng)
    kq, ks = (np.asarray(x).copy() for x in jax_kv_quant(jnp.asarray(k)))
    vq, vs = (np.asarray(x).copy() for x in jax_kv_quant(jnp.asarray(v)))
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    base = _split_bf16q(q, kq, vq, lo, hi, ks, vs, span=64)
    pos = np.arange(k.shape[1])
    outside = (pos[None, :] < lo[:, None]) | (pos[None, :] >= hi[:, None])
    kq[outside], vq[outside] = 127, 127
    ks[outside], vs[outside] = 1e9, 1e9
    np.testing.assert_array_equal(_split_bf16q(q, kq, vq, lo, hi, ks, vs, span=64), base)
