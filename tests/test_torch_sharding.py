"""The port's trainer over a device mesh against the JAX package's on the
same layout.  The rule table: every leaf's rule equal to the JAX
package's (dense, critic, MoE, gpt2, tied).  At layouts d2, f2, m2 (two
gloo processes) and d2m2 (four),
the port's `TrainEngine` on a `DeviceMesh` (`tests/torch_spmd.py`'s
`layout` body) against the JAX package's `TrainEngine` on its
8-virtual-device CPU mesh, from the same fp32 weights and data: the
actor's and the critic's forward, one `train_batch` each (loss, grad
norm, the params after the step) and `masked_moments` (against the numpy
oracle too); the `InferenceEngine`, offload and the streamed step on the
mesh.  In the children: every leaf has its rule's placement and
shard shape, the carry-over (`params_from_numpy(mesh=...)`) and
`params_to_numpy` of a sharded tree give the input back bit for bit, the
optimizer state saved after the step loads back into a fresh engine on
the mesh shard for shard, and a model axis that does not divide
the head counts, MoE on any mesh and an indivisible
`flash_attention_sharded` are refused.

Tolerance, fp32: the forward 2e-4 (the JAX package's own sharded-forward
test), loss and grad norm 1e-5 relative, the params after one AdamW step
2e-6 absolute (lr 1e-3; the reduction order over shards differs from
GSPMD's, so the two are equal to rounding, not bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from areal_tpu.api import data_api as jdata
from areal_tpu.api.model_api import OptimizerConfig
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.train import TrainEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config
from tests import torch_spmd

# Leaf -> {mesh axis: the tensor dim it shards}: the rules, written out.
EXPECT = {
    "embed": {"model": 0, "fsdp": 1},
    "lm_head": {"fsdp": 0, "model": 1},
    "value_head": {"fsdp": 0},
    "wq": {"fsdp": 1, "model": 2}, "wk": {"fsdp": 1, "model": 2}, "wv": {"fsdp": 1, "model": 2},
    "bq": {"model": 1}, "bk": {"model": 1}, "bv": {"model": 1},
    "wo": {"model": 1, "fsdp": 2},
    "wg": {"fsdp": 1, "model": 2}, "wu": {"fsdp": 1, "model": 2},
    "wd": {"model": 1, "fsdp": 2},
}


def _jax_loss(out, batch):
    loss = jnp.where(batch["loss_mask"] > 0, out * batch["adv"], 0.0).sum()
    return loss, {"loss_sum": loss}


def _jax_critic_loss(values, batch):
    loss = 0.5 * jnp.where(batch["loss_mask"] > 0, (values - batch["ret"]) ** 2, 0.0).sum()
    return loss, {"value_loss_sum": loss}


def _jax_run(layout, params):
    pc = ParallelConfig.from_str(layout)
    mesh = make_mesh(pc, jax.devices()[: pc.world_size])
    arrays = torch_spmd.sample_arrays(tiny_config().vocab_size)
    mb = jdata.MicroBatchSpec(max_tokens_per_mb=torch_spmd.MB_TOKENS)
    weight = lambda a: float((a["loss_mask"] > 0).sum())
    out = {}
    for role, cfg, loss_fn, keys in (
        ("actor", tiny_config(), _jax_loss, ("adv", "loss_mask")),
        ("critic", tiny_config(is_critic=True), _jax_critic_loss, ("ret", "loss_mask")),
    ):
        eng = TrainEngine(cfg, jax.tree.map(jnp.asarray, params[role]), mesh,
                          optimizer_config=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0))
        sample = torch_spmd.make_sample(jdata, arrays, ("packed_input_ids",) + keys)
        fwd = eng.forward(sample, mb, lambda o, b: o, "out")
        stats = eng.train_batch(sample, mb, loss_fn, weight, extra_keys=keys)
        out[f"{role}.fwd"] = np.asarray(fwd.data["out"])
        out[f"{role}.loss"], out[f"{role}.grad_norm"] = stats["loss"], stats["grad_norm"]
        out[f"{role}.n_micro_batches"] = stats["n_micro_batches"]
        for k, v in torch_spmd.flatten(jax.tree.map(np.asarray, eng.get_params())).items():
            out[f"{role}.after.{k}"] = v
        if role == "actor":
            mom = eng.masked_moments(
                torch_spmd.make_sample(jdata, arrays, ("packed_input_ids", "x", "loss_mask")),
                jdata.MicroBatchSpec(), ("x",))
            out["moments.count"], out["moments.x"] = mom["count"], mom["x"]
    return out


def _jax_rule(spec):
    return tuple(e if e is None or isinstance(e, str) else tuple(e) for e in spec)


@pytest.mark.parametrize("kind", ["dense", "critic", "moe", "gpt2", "tied"])
def test_rules_match_jax(kind):
    """The rule of every leaf, dense, critic, MoE (expert axis over fsdp,
    hidden over model), gpt2's LayerNorm biases and learned positions, a
    tied head: the port's table is the JAX package's."""
    import dataclasses

    from areal_tpu.parallel import sharding as jsharding
    from areal_tpu_torch.models import transformer as ttfm
    from areal_tpu_torch.models.config import tiny_config as t_tiny
    from areal_tpu_torch.parallel import sharding as tsharding

    kw = {"critic": dict(is_critic=True), "moe": dict(n_experts=4)}.get(kind, {})
    jcfg, tcfg = tiny_config(**kw), t_tiny(**kw)
    if kind == "gpt2":
        extra = dict(norm_type="layernorm", pos_emb="learned", proj_bias=True, mlp_gated=False,
                     hidden_act="gelu", qkv_bias=True)
        jcfg, tcfg = dataclasses.replace(jcfg, **extra), dataclasses.replace(tcfg, **extra)
    if kind == "tied":
        jcfg = dataclasses.replace(jcfg, tied_embeddings=True)
        tcfg = dataclasses.replace(tcfg, tied_embeddings=True)
    want = jax.tree.map(_jax_rule, jsharding.param_pspecs(jtfm.init_params(jcfg, jax.random.PRNGKey(0))),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tsharding.param_pspecs(ttfm.init_params(tcfg, 0, device="cpu"))
    assert _flat_rules(got) == _flat_rules(want)
    if kind == "moe":
        assert got["blocks"]["wg"] == ("pipe", "fsdp", None, "model")
        assert got["blocks"]["router"] == ("pipe", "fsdp", None)


def _flat_rules(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_rules(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


@pytest.fixture(scope="module")
def params():
    return {
        "actor": jax.tree.map(np.asarray, jtfm.init_params(tiny_config(), jax.random.PRNGKey(0))),
        "critic": jax.tree.map(np.asarray, jtfm.init_params(tiny_config(is_critic=True),
                                                            jax.random.PRNGKey(1))),
    }


@pytest.mark.parametrize("layout", ["d2", "f2", "m2", "d2m2"])
def test_sharded_trainer_matches_jax(layout, params, tmp_path):
    for role, tree in params.items():
        np.savez(tmp_path / f"{role}.npz", **torch_spmd.flatten(tree))
    world = ParallelConfig.from_str(layout).world_size
    ranks = torch_spmd.run_spmd("layout", world, tmp_path, {"layout": layout, "expect": EXPECT})
    want = _jax_run(layout, params)
    got = ranks[0]
    for role in ("actor", "critic"):
        np.testing.assert_allclose(got[f"{role}.fwd"], want[f"{role}.fwd"], rtol=2e-4, atol=2e-4)
        assert float(got[f"{role}.n_micro_batches"]) == want[f"{role}.n_micro_batches"]
        for k in ("loss", "grad_norm"):
            assert float(got[f"{role}.{k}"]) == pytest.approx(want[f"{role}.{k}"], rel=1e-5), k
        after = [k for k in want if k.startswith(f"{role}.after.")]
        assert after
        for k in after:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6, err_msg=k)
    # The InferenceEngine on the mesh gives the actor's forward; offload
    # and reload keep it; the streamed step (two chunks) equals
    # train_batch up to float reassociation.
    np.testing.assert_allclose(got["inference.fwd"], want["actor.fwd"], rtol=2e-4, atol=2e-4)
    assert bool(got["offload_round_trip"])
    assert bool(got["opt_round_trip"])
    for k in ("loss", "grad_norm"):
        assert float(got[f"stream.{k}"]) == pytest.approx(want[f"actor.{k}"], rel=1e-5), k
    # Every rank ends in lockstep: the same stats and the same params.
    for r in ranks[1:]:
        for k in got:
            np.testing.assert_array_equal(r[k], got[k], err_msg=k)
    # masked_moments: the JAX engine's and the numpy oracle's.
    arrays = torch_spmd.sample_arrays(tiny_config().vocab_size)
    m = arrays["loss_mask"] > 0
    x = arrays["x"][m].astype(np.float64)
    assert float(got["moments.count"]) == want["moments.count"] == m.sum()
    np.testing.assert_allclose(got["moments.x"], want["moments.x"], rtol=1e-5)
    np.testing.assert_allclose(got["moments.x"], [x.sum(), (x * x).sum(), np.abs(x).sum()],
                               rtol=1e-5)
    assert bool(got["refused.heads"]) and bool(got["refused.moe"])
    if "refused.flash" in got:
        assert bool(got["refused.flash"])
