"""The port's packed attention against the JAX package's, on the CPU, in
fp32: the plain version (`packed_attention_reference`, `make_packed_mask`,
`repeat_kv`) and `flash_attention`'s CPU path with its autograd grads,
held against JAX's dense reference and against JAX's Pallas flash kernel
in interpret mode (as tests/test_flash_attention.py runs it).  The bf16
kernels' own arithmetic is held against the Pallas kernels over segments
of 1 to 129 positions: `flash_fwd_bf16_reference` (the online softmax
over 64-key tiles, P rounded to bf16 before P·V) against the forward,
`flash_dq_bf16_reference` (dS split into a bf16 hi + lo pair before
dS·K) and
`flash_dkv_bf16_reference` (P and dS rounded to bf16 before their
products) against jax.vjp.  The CUDA kernels themselves run only on the
card (chip_smoke.py's flash phase)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import attention as jatt
from areal_tpu.ops.pallas.flash_attention import flash_attention as jflash
from areal_tpu_torch.kernels import flash_attention as tfa
from areal_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)


def _inputs(rng, b=2, s=256, hq=4, hkv=2, d=32):
    """Numpy q/k/v and segment ids (tests/test_flash_attention.py's
    layout): row 0 holds two segments (40% + 30% of s) then padding,
    the other rows one full segment."""
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    a_end, b_end = int(s * 0.4), int(s * 0.7)
    seg[0, :a_end] = 1
    seg[0, a_end:b_end] = 2
    seg[1:, :] = 1
    return q, k, v, seg


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_mask_matches_jax(rng, causal):
    _, _, _, seg = _inputs(rng, s=128)
    want = np.asarray(jatt.make_packed_mask(jnp.asarray(seg), causal=causal))
    got = tatt.make_packed_mask(torch.from_numpy(seg), causal=causal).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv_matches_jax(rng, n_rep):
    x = rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
    want = np.asarray(jatt.repeat_kv(jnp.asarray(x), n_rep))
    np.testing.assert_array_equal(tatt.repeat_kv(torch.from_numpy(x), n_rep).numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax_reference(rng, causal):
    """fp32, the same dense formulation: atol 1e-5."""
    q, k, v, seg = _inputs(rng)
    want = jatt.packed_attention_reference(*map(jnp.asarray, (q, k, v, seg)), causal=causal)
    got = tatt.packed_attention_reference(*_t(q, k, v, seg), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


class TestFlashForward:
    """Twins of tests/test_flash_attention.py TestFlashForward: the port's
    `flash_attention` (CPU: the plain version) against JAX's Pallas
    kernel in interpret mode, rtol = atol = 2e-4 as there."""

    def test_matches_reference(self, rng):
        q, k, v, seg = _inputs(rng)
        want = jflash(*map(jnp.asarray, (q, k, v, seg)), block_q=64, block_k=64)
        got = tfa.flash_attention(*_t(q, k, v, seg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_single_block(self, rng):
        q, k, v, seg = _inputs(rng, s=128)
        want = jflash(*map(jnp.asarray, (q, k, v, seg)), block_q=128, block_k=128)
        got = tfa.flash_attention(*_t(q, k, v, seg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_non_causal(self, rng):
        q, k, v, seg = _inputs(rng, s=128)
        want = jflash(*map(jnp.asarray, (q, k, v, seg)), causal=False,
                      block_q=64, block_k=64)
        got = tfa.flash_attention(*_t(q, k, v, seg), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_padding_rows_zero(self, rng):
        """Padding rows are exactly 0 (JAX's kernel: within 1e-6)."""
        q, k, v, seg = _inputs(rng)
        got = tfa.flash_attention(*_t(q, k, v, seg)).numpy()
        assert (got[0, int(256 * 0.7):] == 0.0).all()
        want = np.asarray(jflash(*map(jnp.asarray, (q, k, v, seg)), block_q=64, block_k=64))
        assert np.allclose(want[0, int(256 * 0.7):], 0.0, atol=1e-6)

    def test_rejects_unaligned(self, rng):
        q, k, v, seg = _inputs(rng, s=200)
        with pytest.raises(ValueError):
            tfa.flash_attention(*_t(q, k, v, seg))
        with pytest.raises(ValueError):
            jflash(*map(jnp.asarray, (q, k, v, seg)), block_q=128, block_k=128)

    @pytest.mark.parametrize("bad", ["gqa", "segment_shape", "device"])
    def test_rejects_bad_inputs(self, rng, bad):
        q, k, v, seg = _t(*_inputs(rng, s=128))
        if bad == "gqa":
            k, v = k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1)
        elif bad == "segment_shape":
            seg = seg[:, :64]
        else:
            q = q.to("meta")
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, v, seg)

    def test_packed_attention_dispatch(self, rng):
        """`flash_attention` (the model's attention call) on CPU tensors
        is the plain version, exactly."""
        q, k, v, seg = _t(*_inputs(rng, s=128))
        np.testing.assert_array_equal(
            tfa.flash_attention(q, k, v, seg).numpy(),
            tatt.packed_attention_reference(q, k, v, seg).numpy(),
        )


def _grads(fn, q, k, v):
    qt, kt, vt = _t(q, k, v, grad=True)
    fn(qt, kt, vt).backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


class TestFlashBackward:
    """Twins of tests/test_flash_attention.py TestFlashBackward: autograd
    through the port against jax.grad through the Pallas kernel
    (interpret mode) and through JAX's dense reference."""

    def test_grads_match_reference(self, rng):
        q, k, v, seg = _inputs(rng, b=1, s=128, hq=2, hkv=1, d=16)
        st = torch.from_numpy(seg)
        got = _grads(lambda q, k, v: (tfa.flash_attention(q, k, v, st) ** 2).sum(), q, k, v)
        sj = jnp.asarray(seg)
        for fn in (
            lambda q, k, v: jflash(q, k, v, sj, block_q=64, block_k=64),
            lambda q, k, v: jatt.packed_attention_reference(q, k, v, sj),
        ):
            want = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), argnums=(0, 1, 2))(
                *map(jnp.asarray, (q, k, v))
            )
            for a, b, name in zip(got, want, "qkv"):
                np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-4,
                                           err_msg=f"d{name}")

    def test_grad_multi_segment(self, rng):
        q, k, v, seg = _inputs(rng, b=2, s=256, hq=2, hkv=2, d=32)
        st = torch.from_numpy(seg)
        got = _grads(lambda q, k, v: tfa.flash_attention(q, k, v, st).abs().sum(), q, k, v)
        sj = jnp.asarray(seg)
        want = jax.grad(
            lambda q, k, v: jnp.sum(jnp.abs(jflash(q, k, v, sj, block_q=64, block_k=64))),
            argnums=(0, 1, 2),
        )(*map(jnp.asarray, (q, k, v)))
        for a, b, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-3,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
    def test_plain_backward_matches_jax_grad(self, rng, hq, hkv):
        """`flash_bwd_reference` (the plain version of K1dq and K1dkv) fed
        Δ = rowsum(o∘dO) of the fp32 output gives jax.grad of JAX's dense
        reference: atol 1e-5."""
        q, k, v, seg = _inputs(rng, b=2, s=128, hq=hq, hkv=hkv, d=16)
        do = rng.normal(size=q.shape).astype(np.float32)
        qt, kt, vt, st, dot = _t(q, k, v, seg, do)
        o = tatt.packed_attention_reference(qt, kt, vt, st)
        got = tfa.flash_bwd_reference(qt, kt, vt, st, dot, tfa.flash_delta(o, dot))
        sj = jnp.asarray(seg)
        _, vjp = jax.vjp(lambda q, k, v: jatt.packed_attention_reference(q, k, v, sj),
                         *map(jnp.asarray, (q, k, v)))
        for a, b, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5,
                                       err_msg=f"d{name}")
            assert (a.numpy()[seg == 0] == 0.0).all()

    def test_padding_grads_zero(self, rng):
        """Padding positions get exactly 0 in dq, dk and dv."""
        q, k, v, seg = _inputs(rng)
        st = torch.from_numpy(seg)
        got = _grads(lambda q, k, v: (tfa.flash_attention(q, k, v, st) ** 2).sum(), q, k, v)
        for g in got:
            assert (g[seg == 0] == 0.0).all()


def test_launch_counters_start_at_zero():
    tfa.reset_launches()
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


def _dkv_rows(rng, hq, hkv, d=16):
    """S=256 in three rows: segments of 1, 63, 64 and 65 positions then
    63 of padding; 127 and 129; 128 then 128 of padding.  q, k, v and dO
    hold bf16 values (the kernel's inputs), as fp32."""
    b, s = 3, 256
    seg = np.zeros((b, s), np.int32)
    for r, lens in enumerate(((1, 63, 64, 65), (127, 129), (128,))):
        off = 0
        for sid, n in enumerate(lens, 1):
            seg[r, off : off + n] = sid
            off += n
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv, hq)]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays)
    return q, k, v, do, seg


def _row_err(got, want):
    """Largest per-row error relative to the row's largest |want| (rows
    under the output's RMS take the RMS), as chip_smoke.py measures."""
    err = np.abs(got - want).max(-1)
    mag = np.abs(want).max(-1)
    live = want[mag > 0]
    rms = float(np.sqrt(np.mean(live**2))) if live.size else 1.0
    return float((err / np.maximum(mag, rms)).max())


def _dense_lse(qt, kt, st, causal):
    """logsumexp of each row's masked fp32 logits, [B, S, Hq] (-inf on
    rows that attend nothing)."""
    logits = torch.einsum(
        "bqhd,bkhd->bhqk", qt, tatt.repeat_kv(kt, qt.shape[2] // kt.shape[2])
    ) * qt.shape[-1] ** -0.5
    mask = tatt.make_packed_mask(st, causal=causal)
    return torch.logsumexp(torch.where(mask, logits, -math.inf), -1).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(6, 1), (2, 2)])
def test_fwd_bf16_reference_matches_jax(rng, hq, hkv, causal):
    """o of `flash_fwd_bf16_reference` against the Pallas forward in
    interpret mode: each row within 2^-7 of its largest value (P is
    rounded to bf16 before P·V, as on the card; chip_smoke's bf16
    tolerance); padding rows exactly 0.  Its lse against the dense
    logsumexp within 1e-5 (fp32 in both, sums in another order), -1e30
    at padding."""
    q, k, v, _, seg = _dkv_rows(rng, hq, hkv)
    qt, kt, vt, st = _t(q, k, v, seg)
    o, lse = tfa.flash_fwd_bf16_reference(qt, kt, vt, st, causal=causal)
    want = jflash(*map(jnp.asarray, (q, k, v, seg)), causal=causal, block_q=64, block_k=64)
    o = o.numpy()
    assert _row_err(o, np.asarray(want)) <= 2**-7
    assert (o[seg == 0] == 0.0).all()
    real = seg > 0
    want_lse = _dense_lse(qt, kt, st, causal).numpy()
    np.testing.assert_allclose(lse.numpy()[real], want_lse[real], rtol=0, atol=1e-5)
    assert (lse.numpy()[~real] == tfa.KERNEL_NEG).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(6, 1), (2, 2)])
def test_dq_bf16_reference_matches_jax(rng, hq, hkv, causal):
    """dq of `flash_dq_bf16_reference` (given the fp32 lse and Δ of the
    fp32 forward) against jax.vjp through the Pallas kernels in
    interpret mode: each row within 2^-7 of its largest value (dS is split
    into a bf16 hi + lo pair before dS·K, as on the card); padding rows
    exactly 0."""
    q, k, v, do, seg = _dkv_rows(rng, hq, hkv)
    qt, kt, vt, dot, st = _t(q, k, v, do, seg)
    o = tatt.packed_attention_reference(qt, kt, vt, st, causal=causal)
    dq = tfa.flash_dq_bf16_reference(
        qt, kt, vt, st, dot, _dense_lse(qt, kt, st, causal), tfa.flash_delta(o, dot),
        causal=causal,
    ).numpy()
    sj = jnp.asarray(seg)
    _, vjp = jax.vjp(
        lambda q, k, v: jflash(q, k, v, sj, causal=causal, block_q=64, block_k=64),
        *map(jnp.asarray, (q, k, v)),
    )
    want_dq = np.asarray(vjp(jnp.asarray(do))[0])
    assert _row_err(dq, want_dq) <= 2**-7
    assert (dq[seg == 0] == 0.0).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(6, 1), (2, 2)])
def test_dkv_bf16_reference_matches_jax(rng, hq, hkv, causal):
    """dk, dv of `flash_dkv_bf16_reference` (given the fp32 lse and Δ of
    the fp32 forward) against jax.vjp through the Pallas kernels in
    interpret mode: each row within 2^-7 of its largest value (P and dS
    are rounded to bf16 before the products, as on the card; chip_smoke's
    bf16 tolerance); padding rows exactly 0."""
    q, k, v, do, seg = _dkv_rows(rng, hq, hkv)
    qt, kt, vt, dot, st = _t(q, k, v, do, seg)
    o = tatt.packed_attention_reference(qt, kt, vt, st, causal=causal)
    dk, dv = tfa.flash_dkv_bf16_reference(
        qt, kt, vt, st, dot, _dense_lse(qt, kt, st, causal), tfa.flash_delta(o, dot),
        causal=causal,
    )
    sj = jnp.asarray(seg)
    _, vjp = jax.vjp(
        lambda q, k, v: jflash(q, k, v, sj, causal=causal, block_q=64, block_k=64),
        *map(jnp.asarray, (q, k, v)),
    )
    _, want_dk, want_dv = vjp(jnp.asarray(do))
    for got, want, name in ((dk, want_dk, "dk"), (dv, want_dv, "dv")):
        got = got.numpy()
        assert _row_err(got, np.asarray(want)) <= 2**-7, name
        assert (got[seg == 0] == 0.0).all(), name
    # (dk of a one-position segment is 0 in exact arithmetic: dS = 0 there)
    assert (np.abs(dv.numpy()[seg > 0]).max(-1) > 0).all()
