"""The port's ops against the JAX package's on the same numpy inputs
(fp32): norms and RoPE (atol 1e-6), the int8 KV quantizer (bit-identical),
sampling warpers and draws (identical tokens), and the plain decode
attention and page gather."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import attention as jatt
from areal_tpu.ops import norms as jnorms
from areal_tpu.ops import quant as jquant
from areal_tpu.ops import sampling as jsamp
from areal_tpu_torch.ops import attention as tatt
from areal_tpu_torch.ops import norms as tnorms
from areal_tpu_torch.ops import quant as tquant
from areal_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def test_rms_norm(rng):
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1000000.0)])
def test_rope_cos_sin(rng, head_dim, theta):
    pos = rng.integers(0, 300, (6, 5)).astype(np.int32)
    cj, sj = jnorms.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    ct, st = tnorms.rope_cos_sin(torch.from_numpy(pos).long(), head_dim, theta)
    np.testing.assert_allclose(_np(ct), np.asarray(cj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(st), np.asarray(sj), atol=1e-6, rtol=0)


def test_apply_rotary(rng):
    q = rng.standard_normal((3, 4, 6, 16)).astype(np.float32)
    k = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (3, 4)).astype(np.int32)
    cj, sj = jnorms.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    qj, kj = jnorms.apply_rotary(jnp.asarray(q), jnp.asarray(k), cj, sj)
    ct, st = torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj))
    qt, kt = tnorms.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), ct, st)
    np.testing.assert_allclose(_np(qt), np.asarray(qj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(kt), np.asarray(kj), atol=1e-6, rtol=0)


def test_kv_quant_bit_identical(rng):
    x = (rng.standard_normal((4, 9, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero head: the 1e-8 scale floor
    qj, sj = jquant.kv_quant(jnp.asarray(x))
    qt, st = tquant.kv_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(
        st.float().numpy(), np.asarray(sj.astype(jnp.float32))
    )
    dj = jquant.kv_dequant(qj, sj, jnp.float32)
    dt = tquant.kv_dequant(qt, st, torch.float32)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_mask(rng, k):
    lg = rng.standard_normal((4, 64)).astype(np.float32)
    want = jsamp.apply_top_k(jnp.asarray(lg), k)
    got = tsamp.apply_top_k(torch.from_numpy(lg), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.3, 0.9])
def test_top_p_mask(rng, p):
    lg = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
    want = jsamp.apply_top_p(jnp.asarray(lg), p)
    got = tsamp.apply_top_p(torch.from_numpy(lg), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_sample_token(rng):
    lg = rng.standard_normal((8, 512)).astype(np.float32)
    tj, lj = jsamp.sample_token(
        jnp.asarray(lg), jax.random.PRNGKey(0), temperature=0.7, greedy=True
    )
    tt, lt = tsamp.sample_token(torch.from_numpy(lg), temperature=0.7, greedy=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (20, 1.0), (0, 0.8), (30, 0.9)])
def test_sampled_draw_on_shared_u(rng, top_k, top_p):
    """The same uniforms give the same tokens: the inverse-CDF transform
    and the warpers are the JAX package's."""
    lg = rng.standard_normal((16, 512)).astype(np.float32)
    u = rng.random(16).astype(np.float32)
    scaled = jnp.asarray(lg) / 0.8
    warped = jsamp.apply_top_p(jsamp.apply_top_k(scaled, top_k), top_p)
    tj = jsamp._inverse_cdf_draw(warped, jnp.asarray(u))
    tt, lt = tsamp.sample_token(
        torch.from_numpy(lg), temperature=0.8, top_k=top_k, top_p=top_p,
        u=torch.from_numpy(u),
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # Behaviour logprob: the unwarped temperature-scaled density.
    lse = jax.nn.logsumexp(scaled, axis=-1)
    want = np.take_along_axis(np.asarray(scaled), np.asarray(tj)[:, None], 1)[:, 0]
    np.testing.assert_allclose(lt.numpy(), want - np.asarray(lse), atol=1e-6)


def test_inverse_cdf_draw(rng):
    w = rng.standard_normal((32, 100)).astype(np.float32)
    u = rng.random(32).astype(np.float32)
    u[0], u[1] = 0.0, np.float32(1.0 - 1e-7)  # both ends of [0, 1)
    tj = jsamp._inverse_cdf_draw(jnp.asarray(w), jnp.asarray(u))
    tt = tsamp._inverse_cdf_draw(torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_plain(rng, int8):
    b, s, n_kv, rep, d = 5, 12, 2, 3, 16
    q = rng.standard_normal((b, 1, n_kv * rep, d)).astype(np.float32)
    vf = np.array([0, 2, 0, 5, 3], np.int32)
    vt = np.array([12, 7, 0, 6, 3], np.int32)  # rows 2, 4: empty windows
    if int8:
        k = rng.integers(-127, 128, (b, s, n_kv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, s, n_kv, d)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((b, s, n_kv))) * 0.02).astype(np.float32)
        vs = (np.abs(rng.standard_normal((b, s, n_kv))) * 0.02).astype(np.float32)
        jk = dict(k_scale=jnp.asarray(ks, jnp.bfloat16), v_scale=jnp.asarray(vs, jnp.bfloat16))
        tk = dict(
            k_scale=torch.from_numpy(ks).to(torch.bfloat16),
            v_scale=torch.from_numpy(vs).to(torch.bfloat16),
        )
    else:
        k = rng.standard_normal((b, s, n_kv, d)).astype(np.float32)
        v = rng.standard_normal((b, s, n_kv, d)).astype(np.float32)
        jk, tk = {}, {}
    want = jatt.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vf),
        jnp.asarray(vt), **jk,
    )
    got = tatt.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vf).long(), torch.from_numpy(vt).long(), **tk,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert float(got[2].abs().max()) == 0.0 and float(got[4].abs().max()) == 0.0


def test_paged_gather_and_clamp(rng):
    pool = rng.standard_normal((6, 4, 2, 3)).astype(np.float32)
    pt = np.array([[0, 5, 6], [3, 6, 9]], np.int32)  # sentinels 6, 9
    np.testing.assert_array_equal(
        tatt.clamp_page_table(torch.from_numpy(pt), 6).numpy(),
        np.asarray(jatt.clamp_page_table(jnp.asarray(pt), 6)),
    )
    np.testing.assert_array_equal(
        tatt.paged_gather_layer(torch.from_numpy(pool), torch.from_numpy(pt)).numpy(),
        np.asarray(jatt.paged_gather_layer(jnp.asarray(pool), jnp.asarray(pt))),
    )
