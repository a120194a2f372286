"""The port's topology arithmetic (`areal_tpu_torch/base/topology.py`)
against the JAX package's (`areal_tpu/base/topology.py`) on the same
inputs: allocation strings both ways, coords <-> ranks, the rank lists of
an axis, and the batch rows each process owns (the twins of the
topology cases of `tests/test_base.py` and of `TestLocalBatchShard` in
`tests/test_sharded_data.py`).  Host-only: no process group."""

import dataclasses

import numpy as np
import pytest

from areal_tpu.base import topology as jtop
from areal_tpu_torch.base import topology as ttop

LAYOUTS = ["d1", "d4f2m2", "d64p1m1", "d2p2m2s2", "f4", "m8", "d2m2", "d2f2m2", "p2s2"]


def _fields(pc):
    return {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}


@pytest.mark.parametrize("s", LAYOUTS)
def test_parse_and_print_match_jax(s):
    j, t = jtop.ParallelConfig.from_str(s), ttop.ParallelConfig.from_str(s)
    assert _fields(t) == _fields(j)
    assert t.to_str() == j.to_str()
    assert ttop.ParallelConfig.from_str(t.to_str()) == t
    assert (t.world_size, t.dp_size) == (j.world_size, j.dp_size)
    assert t.axis_sizes() == j.axis_sizes()


@pytest.mark.parametrize("s", ["x3", "d2d4", "", "d2x", "2d", "d0"])
def test_parse_rejects_what_jax_rejects(s):
    with pytest.raises(ValueError):
        jtop.ParallelConfig.from_str(s)
    with pytest.raises(ValueError):
        ttop.ParallelConfig.from_str(s)


def test_axis_names_match_jax():
    assert ttop.AXIS_ORDER == jtop.AXIS_ORDER
    assert ttop.BATCH_AXES == jtop.BATCH_AXES


@pytest.mark.parametrize("s", ["d2f2m2", "d2p2m2s2", "d3m2", "f4"])
def test_coords_and_ranks_match_jax(s):
    j, t = jtop.ParallelConfig.from_str(s), ttop.ParallelConfig.from_str(s)
    for r in range(t.world_size):
        c = ttop.coords_of_rank(t, r)
        assert c == jtop.coords_of_rank(j, r)
        assert ttop.rank_of_coords(t, **c) == r == jtop.rank_of_coords(j, **c)
    with pytest.raises(ValueError):
        ttop.coords_of_rank(t, t.world_size)
    with pytest.raises(ValueError):
        ttop.rank_of_coords(t, model=t.model)


@pytest.mark.parametrize("s", ["d2m2", "d2f2m2", "d2p2m2s2"])
def test_ranks_on_axis_match_jax(s):
    j, t = jtop.ParallelConfig.from_str(s), ttop.ParallelConfig.from_str(s)
    for axis in ttop.AXIS_ORDER:
        for fixed in ({}, {"data": 1}, {"model": 1}):
            fixed = {k: v for k, v in fixed.items() if v < t.axis_sizes()[k] and k != axis}
            assert ttop.ranks_on_axis(t, axis, **fixed) == jtop.ranks_on_axis(j, axis, **fixed)
    assert ttop.ranks_on_axis(ttop.ParallelConfig(data=2, model=2), "model", data=1) == [2, 3]


class _FakeDev:
    def __init__(self, pi):
        self.process_index = pi


class _FakeMesh:
    def __init__(self, shape, process_indices):
        self.devices = np.array([_FakeDev(p) for p in process_indices],
                                dtype=object).reshape(shape)


# (mesh shape in AXIS_ORDER, the process of each position): the cases of
# TestLocalBatchShard, plus the port's own one-process-a-device meshes.
OWNERSHIP = [
    ((1, 2, 1, 1, 1), [0, 0]),
    ((1, 4, 1, 1, 1), [0, 0, 1, 1]),
    ((1, 2, 1, 1, 2), [0, 1, 0, 1]),
    ((1, 2, 1, 1, 2), [0, 1, 2, 3]),
    ((2, 2, 1, 1, 1), [0, 0, 1, 1]),
    ((1, 1, 4, 1, 1), [0, 0, 1, 1]),
    ((1, 4, 1, 1, 1), [0, 0, 0, 1]),
    ((1, 2, 2, 1, 2), list(range(8))),
    ((1, 1, 2, 1, 2), list(range(4))),
    ((1, 4, 1, 1, 1), list(range(4))),
]


@pytest.mark.parametrize("shape,owners", OWNERSHIP)
def test_batch_ownership_matches_jax(shape, owners):
    mesh = _FakeMesh(shape, owners)
    arr = np.asarray(owners).reshape(shape)
    for p in sorted(set(owners)):
        assert ttop.batch_shard_of_owners(arr, p) == jtop.local_batch_shard(mesh, p)


def test_one_rank_a_device_owns_its_batch_coordinate():
    """On the port each rank is a process of its own: at d2f2m2 a rank
    owns the block of its (data, fsdp) coordinate, shared along model."""
    pc = ttop.ParallelConfig.from_str("d2f2m2")
    arr = np.arange(pc.world_size).reshape([pc.axis_sizes()[a] for a in ttop.AXIS_ORDER])
    for r in range(pc.world_size):
        c = ttop.coords_of_rank(pc, r)
        assert ttop.batch_shard_of_owners(arr, r) == (c["data"] * pc.fsdp + c["fsdp"], 4)


@pytest.mark.parametrize("s", ["p2", "s2", "d2p2m2s2"])
def test_pipe_and_seq_are_refused_naming_item_8_5(s):
    with pytest.raises(NotImplementedError, match="item 8.5"):
        ttop.make_mesh(ttop.ParallelConfig.from_str(s), device="cpu")


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        ttop.make_mesh(ttop.ParallelConfig(data=2), device="cpu")


@pytest.mark.parametrize("bad", [0, -1, 1.5])
def test_non_positive_degrees_are_refused(bad):
    with pytest.raises(ValueError):
        ttop.ParallelConfig(data=bad)
    with pytest.raises(ValueError):
        jtop.ParallelConfig(data=bad)


def test_entry_points_default_to_the_card():
    """Without a card, the world and the mesh check refuse rather than
    fall back to the CPU; asked for the CPU, the world forms over gloo."""
    import torch.distributed as dist

    from areal_tpu_torch.base import distributed
    from areal_tpu_torch.scripts import mesh_check

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("e", "t", 0, 1)
    assert not dist.is_initialized()
    assert mesh_check.main(["--world", "2"]) == 2
    assert distributed.backend_for("cpu") == "gloo"
