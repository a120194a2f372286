"""The port's log-prob numerics against the JAX package's
(areal_tpu/ops/functional.py) on the same numpy inputs, fp32 on the CPU:
`shifted_label_mask`, `next_token_logprobs`, the chunked
`fused_next_token_logprobs` and its gradients, `masked_normalization`,
and the fp32-output head product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import functional as jF
from areal_tpu_torch.ops import functional as tF

torch.set_num_threads(2)


def _packed(rng, b=3, s=24, v=50, d=16):
    seg = np.zeros((b, s), np.int32)
    seg[0, :10], seg[0, 10:19] = 1, 2
    seg[1, :24] = 1
    seg[2, :5], seg[2, 5:6], seg[2, 6:20] = 1, 2, 3  # a 1-token segment
    tokens = rng.integers(0, v, (b, s)).astype(np.int32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    return seg, tokens, x, head


def test_shifted_label_mask(rng):
    seg, _, _, _ = _packed(rng)
    want = np.asarray(jF.shifted_label_mask(jnp.asarray(seg)))
    np.testing.assert_array_equal(tF.shifted_label_mask(torch.from_numpy(seg)).numpy(), want)


def test_next_token_logprobs(rng):
    seg, tokens, x, head = _packed(rng)
    logits = x @ head
    want = jF.next_token_logprobs(*map(jnp.asarray, (logits, tokens, seg)))
    got = tF.next_token_logprobs(*map(torch.from_numpy, (logits, tokens, seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [7, 512])
def test_fused_logprobs_and_grads(rng, chunk):
    """Values atol 1e-5; gradients of a weighted sum w.r.t. the hidden
    states and the head atol 1e-5 (fp32, one formulation)."""
    seg, tokens, x, head = _packed(rng)
    w = rng.normal(size=seg.shape).astype(np.float32)

    def jloss(x, head):
        lp = jF.fused_next_token_logprobs(x, head, jnp.asarray(tokens), jnp.asarray(seg), chunk)
        return jnp.sum(lp * w), lp

    (_, want), (gx, gh) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(head)
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head).requires_grad_(True)
    lp = tF.fused_next_token_logprobs(
        xt, ht, torch.from_numpy(tokens), torch.from_numpy(seg), chunk
    )
    (lp * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), atol=1e-5, rtol=0)


def test_fused_equals_unfused(rng):
    """The chunked form equals log-softmax of the full logits."""
    seg, tokens, x, head = _packed(rng)
    xt, ht = torch.from_numpy(x), torch.from_numpy(head)
    st, tt = torch.from_numpy(seg), torch.from_numpy(tokens)
    with torch.no_grad():
        fused = tF.fused_next_token_logprobs(xt, ht, tt, st, 5)
    np.testing.assert_allclose(
        fused.numpy(), tF.next_token_logprobs(xt @ ht, tt, st).numpy(), atol=1e-5, rtol=0
    )


def test_masked_normalization(rng):
    x = rng.normal(loc=3.0, scale=2.0, size=(4, 9)).astype(np.float32)
    mask = rng.random((4, 9)) > 0.3
    want = jF.masked_normalization(jnp.asarray(x), jnp.asarray(mask))
    got = tF.masked_normalization(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (got.numpy()[~mask] == 0.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_fp32_out_on_cpu(rng, dtype):
    """An fp32 result of the product of the operands as given (bf16
    operands are widened exactly, so the product is not rounded to
    bf16)."""
    x = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)).to(dtype)
    got = tF.matmul_fp32_out(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 6)
    np.testing.assert_allclose(
        got.numpy(), x.float().numpy() @ w.float().numpy(), atol=1e-5, rtol=0
    )
