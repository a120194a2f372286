"""The port's `gae_packed` (a log-depth scan in PyTorch) against the JAX
package's (`jax.lax.associative_scan`) and the numpy oracle
`pygae_packed`, on the CPU in fp32: rtol 1e-4, atol 1e-5 (the JAX
suite's own tolerance, tests/test_ppo.py TestGAE)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.gae import gae_packed as jgae
from areal_tpu.ops.gae import pygae_packed as jpygae
from areal_tpu_torch.ops.gae import gae_packed, pygae_packed

torch.set_num_threads(2)


def _packed(rng, seqlens, pad=0):
    """Rewards, values, segment ids and bootstrap for sequences packed
    end to end, then `pad` padding positions."""
    t = sum(seqlens) + pad
    rewards = rng.normal(size=t).astype(np.float32)
    values = rng.normal(size=t).astype(np.float32)
    boot_seq = rng.normal(size=len(seqlens)).astype(np.float32)
    seg = np.zeros(t, np.int32)
    boot = np.zeros(t, np.float32)
    off = 0
    for i, n in enumerate(seqlens):
        seg[off : off + n] = i + 1
        boot[off + n - 1] = boot_seq[i]
        off += n
    values[off:] = 0.0
    return rewards, values, seg, boot, boot_seq


def _port(rewards, values, seg, boot, gamma, lam):
    adv, ret = gae_packed(*(torch.from_numpy(a) for a in (rewards, values, seg, boot)),
                          gamma, lam)
    return adv.numpy(), ret.numpy()


def _jax(rewards, values, seg, boot, gamma, lam):
    adv, ret = jgae(*(jnp.asarray(a) for a in (rewards, values, seg, boot)), gamma, lam)
    return np.asarray(adv), np.asarray(ret)


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.99, 0.95), (0.9, 0.5)])
@pytest.mark.parametrize("seqlens", [[5, 1, 9, 3], [1, 1, 1], [200, 37, 1, 600, 5]])
def test_matches_jax_and_oracle(rng, gamma, lam, seqlens):
    """Advantages and returns against JAX and the oracle; length-1
    sequences included, and sequences longer than a few scan rounds."""
    rewards, values, seg, boot, boot_seq = _packed(rng, seqlens)
    adv, ret = _port(rewards, values, seg, boot, gamma, lam)
    assert adv.dtype == ret.dtype == np.float32
    adv_ref, ret_ref = pygae_packed(rewards, values, seqlens, boot_seq, gamma, lam)
    adv_j, ret_j = _jax(rewards, values, seg, boot, gamma, lam)
    for got, want in ((adv, adv_ref), (ret, ret_ref), (adv, adv_j), (ret, ret_j)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_oracle_is_the_jax_oracle(rng):
    """The port's copy of `pygae_packed` is the JAX package's."""
    seqlens = [4, 1, 7]
    rewards, values, _, _, boot_seq = _packed(rng, seqlens)
    for a, b in zip(pygae_packed(rewards, values, seqlens, boot_seq, 0.99, 0.95),
                    jpygae(rewards, values, seqlens, boot_seq, 0.99, 0.95)):
        np.testing.assert_array_equal(a, b)


def test_length_one_sequences_are_one_step(rng):
    """A length-1 sequence: adv = r + γ·bootstrap − V, nothing carried
    across the boundary."""
    rewards, values, seg, boot, boot_seq = _packed(rng, [1, 1, 1, 1])
    adv, ret = _port(rewards, values, seg, boot, 0.9, 0.5)
    np.testing.assert_allclose(adv, rewards + 0.9 * boot_seq - values, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret, adv + values, rtol=1e-6, atol=1e-6)


def test_padding_is_exactly_zero(rng):
    """Padding positions (segment 0) give exactly 0, whatever their
    rewards; tests/test_ppo.py's case: rewards 1 over 3 tokens give
    advantages 3, 2, 1 at γ = λ = 1."""
    rewards, values, seg, boot, _ = _packed(rng, [6, 3], pad=7)
    rewards[-7:] = 5.0
    adv, ret = _port(rewards, values, seg, boot, 0.99, 0.95)
    assert (adv[-7:] == 0).all() and (ret[-7:] == 0).all()
    r = np.zeros(8, np.float32)
    r[:3] = 1.0
    seg = np.asarray([1, 1, 1, 0, 0, 0, 0, 0], np.int32)
    adv, ret = _port(r, np.zeros(8, np.float32), seg, np.zeros(8, np.float32), 1.0, 1.0)
    np.testing.assert_array_equal(adv, [3.0, 2.0, 1.0, 0, 0, 0, 0, 0])


def test_long_low_discount_stays_finite():
    """γλ = 0.45 over 12k tokens (the smoke's packed length): coefficient
    products underflow to 0 without producing NaN or inf, and the result
    still matches the oracle."""
    rng = np.random.default_rng(3)
    seqlens = [4000, 8000]
    rewards, values, seg, boot, boot_seq = _packed(rng, seqlens)
    adv, ret = _port(rewards, values, seg, boot, 0.9, 0.5)
    assert np.isfinite(adv).all() and np.isfinite(ret).all()
    adv_ref, ret_ref = pygae_packed(rewards, values, seqlens, boot_seq, 0.9, 0.5)
    np.testing.assert_allclose(adv, adv_ref, rtol=1e-4, atol=1e-5)
