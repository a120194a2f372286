"""The sharded data plane across real process boundaries (the port's
twin of `tests/test_sharded_multiprocess.py`): gloo processes form one
mesh whose batch axis spans them, and each member's host arrays are
divergent, real only for the rows it owns and zero elsewhere, tagged
`shard_of` (what the master's shard-exact dispatch, item 8.6a, ships).  Held against the
same run with the full data on every member and the numpy oracle:

- `TrainEngine.masked_moments` and one `train_batch` (loss and grad
  norm: the gradients flow through the placed rows, so a mis-shipped row
  would move them), at d2 and at d2m2 (the model axis's ranks share a
  row block);
- the full PPO actor (adaptive KL, KL-in-reward, batch `adv_norm`):
  loss, ref-KL, |adv| and the KL controller equal the full-data run's
  (rel 2e-4, as the JAX test asserts), and every member advances the
  controller in lockstep (rel 1e-6)."""

import numpy as np
import pytest

from areal_tpu_torch.base.topology import ParallelConfig
from tests import torch_spmd


@pytest.fixture(scope="module")
def actor_npz(tmp_path_factory):
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.weights import params_to_numpy

    path = tmp_path_factory.mktemp("weights") / "actor.npz"
    np.savez(path, **torch_spmd.flatten(params_to_numpy(tfm.init_params(tiny_config(), 0,
                                                                          device="cpu"))))
    return path


def _run(body, layout, sharded, tmp_path, actor_npz):
    d = tmp_path / f"{body}_{layout}_{'sharded' if sharded else 'full'}"
    d.mkdir()
    (d / "actor.npz").write_bytes(actor_npz.read_bytes())
    return torch_spmd.run_spmd(body, ParallelConfig.from_str(layout).world_size, d,
                               {"layout": layout, "sharded": sharded})


@pytest.mark.parametrize("layout", ["d2", "d2m2"])
def test_sharded_dispatch_across_processes(layout, tmp_path, actor_npz):
    from areal_tpu_torch.models.config import tiny_config

    sharded = _run("sharded_plane", layout, True, tmp_path, actor_npz)
    full = _run("sharded_plane", layout, False, tmp_path, actor_npz)
    arrays = torch_spmd.sample_arrays(tiny_config().vocab_size, seed=7)
    m = arrays["loss_mask"] > 0
    x = arrays["x"][m].astype(np.float64)
    for s in sharded:
        assert float(s["count"]) == m.sum()
        np.testing.assert_allclose(s["x"], [x.sum(), (x * x).sum(), np.abs(x).sum()], rtol=1e-5)
    assert sorted({int(s["shard"]) for s in sharded}) == [0, 1]
    for s, f in zip(sharded, full):
        np.testing.assert_allclose(s["x"], f["x"], rtol=1e-6)
        assert float(s["loss"]) == pytest.approx(float(f["loss"]), rel=1e-5)
        assert float(s["grad_norm"]) == pytest.approx(float(f["grad_norm"]), rel=1e-5)
    for s in sharded[1:]:
        for k in ("x", "loss", "grad_norm"):
            np.testing.assert_array_equal(s[k], sharded[0][k])


def test_full_ppo_interface_across_processes(tmp_path, actor_npz):
    sharded = _run("ppo", "d2", True, tmp_path, actor_npz)
    full = _run("ppo", "d2", False, tmp_path, actor_npz)
    for key in ("loss", "ref_kl", "adv_abs", "kl_after"):
        assert float(sharded[0][key]) == pytest.approx(float(full[0][key]), rel=2e-4), key
    r0, r1 = sharded
    assert int(r0["shard"]) != int(r1["shard"])
    for key in ("ref_kl", "kl_after", "loss", "adv_abs"):
        assert float(r0[key]) == pytest.approx(float(r1[key]), rel=1e-6), key
