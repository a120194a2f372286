"""Parallel topology -> `torch.distributed` device meshes (port of
areal_tpu/base/topology.py).

The JAX package lays one named `jax.sharding.Mesh` over devices that one
process drives.  Here every GPU is a process of its own, so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the world
(`base/distributed.initialize`), its dims named by the same axes in the
same order (those of size above 1, `make_mesh`).  What is shared is the arithmetic: a flat rank <-> named-axis
coordinates, and which batch rows a member owns.

Axes (outermost first, as the JAX package orders them):

    pipe   pipeline stages (not ported: ROADMAP queue 1, item 8.5)
    data   pure data parallel (params replicated, batch sharded)
    fsdp   ZeRO-style parameter and optimizer sharding (batch sharded
           jointly with `data`)
    seq    context parallel over the sequence (ring attention, item 8.5)
    model  tensor parallel (heads, MLP hidden, vocab)
"""

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# Outermost (slowest-varying over ranks) first: consecutive ranks land on
# `model`, whose collectives are the most latency-sensitive.
AXIS_ORDER: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, FSDP_AXIS, SEQ_AXIS, MODEL_AXIS)

# Axes along which the global batch is split.
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Degrees of parallelism for one model's layout, parsed from and
    printed as the JAX package's allocation strings ("d4f2m2")."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not (isinstance(v, int) and v >= 1):
                raise ValueError(f"ParallelConfig.{f.name} must be a positive int, got {v!r}")

    @property
    def world_size(self) -> int:
        return self.data * self.fsdp * self.model * self.pipe * self.seq

    @property
    def dp_size(self) -> int:
        """Total batch-sharding degree (data * fsdp)."""
        return self.data * self.fsdp

    def axis_sizes(self) -> Dict[str, int]:
        return {
            PIPE_AXIS: self.pipe,
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            SEQ_AXIS: self.seq,
            MODEL_AXIS: self.model,
        }

    _TOKEN = re.compile(r"([dfmps])(\d+)")
    _LETTER = {"d": "data", "f": "fsdp", "m": "model", "p": "pipe", "s": "seq"}

    @classmethod
    def from_str(cls, s: str) -> "ParallelConfig":
        s = s.strip().lower()
        kwargs: Dict[str, int] = {}
        pos = 0
        for m in cls._TOKEN.finditer(s):
            if m.start() != pos:
                raise ValueError(f"cannot parse allocation string {s!r}")
            pos = m.end()
            field = cls._LETTER[m.group(1)]
            if field in kwargs:
                raise ValueError(f"duplicate axis {m.group(1)!r} in {s!r}")
            kwargs[field] = int(m.group(2))
        if pos != len(s) or not kwargs:
            raise ValueError(f"cannot parse allocation string {s!r}")
        return cls(**kwargs)

    def to_str(self) -> str:
        parts = []
        for letter, field in self._LETTER.items():
            v = getattr(self, field)
            if v != 1 or letter == "d":
                parts.append(f"{letter}{v}")
        return "".join(parts)


def check_ported(parallel: ParallelConfig) -> None:
    """Refuse the axes the port does not run yet."""
    if parallel.pipe > 1 or parallel.seq > 1:
        raise NotImplementedError(
            f"layout {parallel.to_str()}: pipeline stages and sequence (ring) "
            "parallelism are not ported (ROADMAP queue 1, item 8.5)"
        )


def make_mesh(parallel: ParallelConfig, device=None):
    """A `DeviceMesh` realizing `parallel` over the ranks of the current
    `torch.distributed` world, ranks laid out row-major over AXIS_ORDER
    (`model` innermost).  Its dims are the axes of size above 1, in that
    order and named by them (`data` alone, of size 1, for one rank): an
    axis of size 1 shards nothing, and every mesh dim multiplies the
    sharding strategies DTensor weighs at each op.  `mesh_sizes` gives
    every axis's size, 1 for the axes left out.  The world must already be formed
    (`base/distributed.initialize`) with exactly `parallel.world_size`
    ranks.  `device` picks the device type: the CUDA card unless the
    caller asks for the CPU (`base/device.resolve_device`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from areal_tpu_torch.base.device import resolve_device

    check_ported(parallel)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: call "
                           "base.distributed.initialize first")
    world = dist.get_world_size()
    if world != parallel.world_size:
        raise ValueError(
            f"parallel config {parallel.to_str()} needs {parallel.world_size} "
            f"ranks, the world has {world}"
        )
    dev = resolve_device(device)
    sizes = parallel.axis_sizes()
    names = tuple(a for a in AXIS_ORDER if sizes[a] > 1) or (DATA_AXIS,)
    ranks = torch.arange(world).reshape(tuple(sizes[a] for a in names))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size for every axis of AXIS_ORDER (1 for an axis the
    mesh leaves out)."""
    got = {a: int(mesh.size(i)) for i, a in enumerate(mesh.mesh_dim_names)}
    return {a: got.get(a, 1) for a in AXIS_ORDER}


def coords_of_rank(parallel: ParallelConfig, rank: int) -> Dict[str, int]:
    """Named-axis coordinates of a flat rank (row-major over AXIS_ORDER)."""
    sizes = parallel.axis_sizes()
    coords: Dict[str, int] = {}
    rem = rank
    for a in reversed(AXIS_ORDER):
        coords[a] = rem % sizes[a]
        rem //= sizes[a]
    if rem:
        raise ValueError(f"rank {rank} out of range for {parallel.to_str()}")
    return coords


def rank_of_coords(parallel: ParallelConfig, **coords: int) -> int:
    """Inverse of coords_of_rank; unspecified axes default to 0."""
    sizes = parallel.axis_sizes()
    rank = 0
    for a in AXIS_ORDER:
        c = coords.get(a, 0)
        if not 0 <= c < sizes[a]:
            raise ValueError(f"coord {a}={c} out of range (size {sizes[a]})")
        rank = rank * sizes[a] + c
    return rank


def ranks_on_axis(parallel: ParallelConfig, axis: str, **fixed: int) -> List[int]:
    """All flat ranks sweeping `axis` with the other coords fixed (default
    0): the rank list of one process group along that axis."""
    sizes = parallel.axis_sizes()
    return [rank_of_coords(parallel, **{**fixed, axis: i}) for i in range(sizes[axis])]


def batch_sharding_degree(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[a] for a in BATCH_AXES]))


def batch_shard_of_owners(owners: np.ndarray, process_index: int) -> Tuple[int, int]:
    """(shard_rank, n_shards) of the batch rows that `process_index` owns,
    given the owning process of every mesh position (`owners`, shaped by
    AXIS_ORDER): the JAX package's `local_batch_shard` arithmetic.  A
    packed batch's rows map contiguously onto the flattened (data, fsdp)
    coordinates.  (0, 1), "needs the full batch", when the process owns
    every batch coordinate, or when ownership is not one equal contiguous
    block a process."""
    arr = np.moveaxis(np.asarray(owners), 0, 2)  # (data, fsdp, pipe, seq, model)
    n_batch = arr.shape[0] * arr.shape[1]
    flat = arr.reshape(n_batch, -1)
    owner_sets = [frozenset(int(p) for p in row) for row in flat]
    if all(process_index in o for o in owner_sets):
        return 0, 1
    blocks: List[Tuple[int, int, frozenset]] = []
    start = 0
    for i in range(1, n_batch + 1):
        if i == n_batch or owner_sets[i] != owner_sets[start]:
            blocks.append((start, i, owner_sets[start]))
            start = i
    sizes = {stop - begin for begin, stop, _ in blocks}
    mine = [b for b, (_, _, o) in enumerate(blocks) if process_index in o]
    if len(sizes) != 1 or len(mine) != 1:
        return 0, 1
    return mine[0], len(blocks)


def local_batch_shard(mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """(shard_rank, n_shards) of the batch rows this rank places.  Every
    rank is a process of its own, so a rank owns the batch coordinate
    data * fsdp_size + fsdp of its position; ranks along `model` share
    it.  (0, 1) on a mesh with no batch sharding."""
    import torch.distributed as dist

    if rank is None:
        rank = dist.get_rank()
    sizes = mesh_sizes(mesh)
    owners = mesh.mesh.numpy().reshape(tuple(sizes[a] for a in AXIS_ORDER))
    return batch_shard_of_owners(owners, rank)
