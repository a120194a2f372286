"""The port's copy of the value-norm running statistics against the JAX
package's classes: the same masked stream gives the same moments (mean
and std within 1e-9), `normalize`/`denormalize` invert each other, the
state round-trips, and an empty mask changes nothing."""

import numpy as np
import pytest

from areal_tpu.interfaces import value_norm as jvn
from areal_tpu_torch.interfaces import value_norm as tvn

KINDS = ["exp", "ma"]


def _pair(kind):
    return (tvn.make_value_norm(kind, 0.9, 1e-5), jvn.make_value_norm(kind, 0.9, 1e-5))


def _stream(rng, n_batches=5, t=64):
    for i in range(n_batches):
        x = (3.0 * rng.standard_normal(t) + i).astype(np.float32)
        mask = (rng.random(t) < 0.7).astype(np.float32)
        yield x, (mask if i % 2 == 0 else None)


@pytest.mark.parametrize("kind", KINDS)
def test_moments_match_jax(rng, kind):
    t, j = _pair(kind)
    assert t.mean_std() == j.mean_std() == (0.0, 1.0)
    for x, mask in _stream(rng):
        t.update(x, mask=mask)
        j.update(x, mask=mask)
        (tm, ts), (jm, js) = t.mean_std(), j.mean_std()
        assert abs(tm - jm) <= 1e-9 and abs(ts - js) <= 1e-9
        np.testing.assert_array_equal(t.normalize(x), j.normalize(x))
        np.testing.assert_array_equal(t.denormalize(x), j.denormalize(x))
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("kind", KINDS)
def test_normalize_round_trip(rng, kind):
    t, _ = _pair(kind)
    for x, mask in _stream(rng):
        t.update(x, mask=mask)
    x = (10.0 * rng.standard_normal(100)).astype(np.float32)
    np.testing.assert_allclose(t.denormalize(t.normalize(x)), x, rtol=1e-5, atol=1e-5)
    m, s = t.mean_std()
    np.testing.assert_allclose(t.normalize(x), (x - m) / s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_round_trip(rng, kind):
    t, _ = _pair(kind)
    for x, mask in _stream(rng):
        t.update(x, mask=mask)
    fresh, _ = _pair(kind)
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict()
    assert fresh.mean_std() == t.mean_std()


@pytest.mark.parametrize("kind", KINDS)
def test_empty_mask_is_a_no_op(rng, kind):
    t, j = _pair(kind)
    x, _ = next(_stream(rng))
    t.update(x)
    j.update(x)
    before = t.state_dict()
    t.update(x * 100.0, mask=np.zeros_like(x))
    j.update(x * 100.0, mask=np.zeros_like(x))
    assert t.state_dict() == before == j.state_dict()


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        tvn.make_value_norm("bogus", 0.9, 1e-5)
