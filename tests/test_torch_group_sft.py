"""The SPMD worker group across real processes (ROADMAP queue 1, item
8.6a), twin of tests/test_runtime_zmq.py::test_sft_multihost_spmd:

- `quickstart sft --allocation d2` on the CPU: one model over two worker
  processes, the ranks of one gloo world, each placing its own rows
  (the master ships them shard-exactly).  Each step's loss, nll, grad
  and update norms equal the one-process trial's (`--allocation d1`, no
  mesh) and the JAX CLI's `d2` trial on its CPU mesh within rtol 1e-4
  (tests/test_torch_sft.py's tolerance; the per-micro-batch counters
  are each member's own), and the step-3 checkpoint,
  gathered and written by rank 0 alone, equals the one-process trial's
  within rtol 1e-4, atol 1e-6.
- `parallel/sharding.place_rows` and `replicate` over a gloo d2 world
  against the JAX functions on a two-device CPU mesh: each rank's block
  is JAX's shard on the same mesh position, and a replicated tree is
  whole (and marked replicated) on every rank."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from areal_tpu.base.topology import ParallelConfig as JParallelConfig
from areal_tpu.base.topology import make_mesh as jmake_mesh
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.parallel import sharding as jshd
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.models.weights import params_to_numpy
from tests import torch_spmd


@pytest.fixture(autouse=True)
def _restore_runtime_env():
    """The multi-process runtime points this process at the trial's
    name-resolve store and authkey; later tests get theirs back."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.stream import ENV_AUTHKEY

    keys = ("AREAL_NAME_RESOLVE", "AREAL_NAME_RESOLVE_ROOT", ENV_AUTHKEY)
    saved = {k: os.environ.get(k) for k in keys}
    default = name_resolve._default
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    name_resolve._default = default


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_quickstart_sft_group_matches_one_process_and_jax(tmp_path, monkeypatch):
    from areal_tpu.apps import quickstart as jquickstart

    jseen = []

    def run(*a, _real=jquickstart._run, **k):
        jseen.append(_real(*a, **k))
        return jseen[-1]

    monkeypatch.setattr(jquickstart, "_run", run)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(1)),
                           model_type="qwen2")
    data = tmp_path / "sft.jsonl"
    rng = np.random.default_rng(2)
    with open(data, "w") as f:
        for i in range(12):
            a, b = (int(x) for x in rng.integers(1, 100, 2))
            f.write(json.dumps({"id": f"r{i}", "prompt": f"Q: {a} + {b} = ",
                                "answer": f"{a + b}. " * int(rng.integers(1, 4))}) + "\n")

    def argv(root, layout):
        return ["sft", "--model.path", ckpt, "--dataset.path", str(data),
                "--tokenizer-path", "char:512", "--batch-size", "4", "--lr", "1e-3",
                "--max-tokens-per-mb", "48", "--save-freq-steps", "3",
                "--allocation", layout, "--fileroot", str(root)]

    group = quickstart.main(argv(tmp_path / "group", "d2"), device="cpu")
    solo = quickstart.main(argv(tmp_path / "solo", "d1"), device="cpu")
    jquickstart.main(argv(tmp_path / "jax", "d2"))
    (jstats,) = jseen
    assert len(group) == len(solo) == len(jstats) == 3
    for got, one, want in zip(group, solo, jstats):
        for k in ("loss", "nll", "grad_norm", "update_norm"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        # Each member packs its own rows into micro-batches of its own
        # (`engines/packing.split_sharded`), so the per-micro-batch
        # counters are a member's: fewer micro-batches than the whole
        # batch's (JAX's d2 packs the global rows, as the one process).
        assert one["n_micro_batches"] == want["n_micro_batches"]
        assert 1 <= got["n_micro_batches"] <= one["n_micro_batches"]
    saved = {r: os.path.join(tmp_path, r, "checkpoints", "sft", "trial0", "default@0",
                             "step_3") for r in ("group", "solo")}
    _, got = hf.load_hf_checkpoint(saved["group"], dtype=torch.float32, device="cpu")
    _, want = hf.load_hf_checkpoint(saved["solo"], dtype=torch.float32, device="cpu")
    fg, fw = _flat(params_to_numpy(got)), _flat(params_to_numpy(want))
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # Both members ran each step: each wrote its own log, and one rank
    # wrote the checkpoint (a lone file set, no second writer's leftovers).
    logs = os.path.join(tmp_path, "group", "logs", "sft_trial0-attempt0")
    assert sorted(os.listdir(logs)) == ["model_worker-0.log", "model_worker-1.log"]
    assert sorted(f for f in os.listdir(saved["group"]) if f.endswith(".safetensors")) == \
        ["model.safetensors"]


def test_place_rows_and_replicate_match_jax(tmp_path):
    from jax.sharding import PartitionSpec as P

    rows = 8
    ranks = torch_spmd.run_spmd("place_rows", 2, tmp_path, {"layout": "d2", "rows": rows})
    value = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    mesh = jmake_mesh(JParallelConfig.from_str("d2"), jax.devices()[:2])
    placed = jshd.place_rows(mesh, value, P("data"))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    flat_devices = list(mesh.devices.flat)
    rep = jshd.replicate({"plain": np.arange(6, dtype=np.float32).reshape(2, 3)}, mesh)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["local"], shards[flat_devices[r]])
        np.testing.assert_array_equal(got["full"], np.asarray(placed))
        np.testing.assert_array_equal(got["rep_plain"], np.asarray(rep["plain"]))
        np.testing.assert_array_equal(got["rep_rows"], value)
        assert got["rep_replicated"].all()
    assert not np.array_equal(ranks[0]["local"], ranks[1]["local"])
