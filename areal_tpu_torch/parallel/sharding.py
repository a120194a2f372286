"""The sharding rules of the transformer's parameter tree as DTensor
placements (port of areal_tpu/parallel/sharding.py).

The JAX package annotates its functional model with PartitionSpecs and
lets GSPMD partition it.  The port's model is functional too (a dict of
tensors, not `nn.Module`s), so the direct analogue is to place each leaf
with `distribute_tensor` by the same rule table: a rule names, for each
tensor dim, the mesh axis that shards it (or None), and becomes one
placement per mesh dim, `Shard(d)` or `Replicate()`.

- `model`: tensor parallel (heads, MLP hidden, vocab).
- `fsdp`: the remaining parameter dim, ZeRO-style; the batch too.
- `data`: parameters replicated, batch sharded.
- `pipe`, `seq`: refused (ROADMAP queue 1, item 8.5).

The forward (`models/transformer.hidden_states_sharded`) runs on the
leaves' compute layout (`compute_params`: `fsdp` gathered, the `model`
shards kept) with the batch rows sharded over (data, fsdp), and the
attention through `kernels/flash_attention.flash_attention_sharded`.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.base.topology import (
    AXIS_ORDER,
    BATCH_AXES,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    batch_sharding_degree,
    mesh_sizes,
)

BATCH = BATCH_AXES

# Leaf name -> the mesh axis sharding each tensor dim (None: whole).  The
# leading layer-stack dim of the block leaves is the pipe axis's.
_BLOCK_RULES: Dict[str, Tuple] = {
    "ln1": (PIPE_AXIS, None),
    "ln2": (PIPE_AXIS, None),
    "ln1_b": (PIPE_AXIS, None),
    "ln2_b": (PIPE_AXIS, None),
    "bo": (PIPE_AXIS, None),
    "bproj": (PIPE_AXIS, None),
    "bfc": (PIPE_AXIS, MODEL_AXIS),  # matches wg's model-sharded output
    "wq": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS),
    "wk": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS),
    "wv": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS),
    "bq": (PIPE_AXIS, MODEL_AXIS),
    "bk": (PIPE_AXIS, MODEL_AXIS),
    "bv": (PIPE_AXIS, MODEL_AXIS),
    "wo": (PIPE_AXIS, MODEL_AXIS, FSDP_AXIS),
    # Dense MLP
    "wg": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS),
    "wu": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS),
    "wd": (PIPE_AXIS, MODEL_AXIS, FSDP_AXIS),
    # MoE: the expert axis over fsdp (expert parallelism), hidden over model.
    "router": (PIPE_AXIS, FSDP_AXIS, None),
    "moe_wg": (PIPE_AXIS, FSDP_AXIS, None, MODEL_AXIS),
    "moe_wu": (PIPE_AXIS, FSDP_AXIS, None, MODEL_AXIS),
    "moe_wd": (PIPE_AXIS, FSDP_AXIS, MODEL_AXIS, None),
}

_TOP_RULES: Dict[str, Tuple] = {
    "embed": (MODEL_AXIS, FSDP_AXIS),
    "pos_embed": (None, FSDP_AXIS),
    "final_ln": (None,),
    "final_ln_b": (None,),
    "lm_head": (FSDP_AXIS, MODEL_AXIS),
    "value_head": (FSDP_AXIS, None),
}


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The rule (a tuple of axis names or None, one a tensor dim) of every
    leaf, in the params' tree: the JAX package's PartitionSpec tree."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "blocks":
            out[k] = {
                bk: _BLOCK_RULES["moe_" + bk if bk in ("wg", "wu", "wd") and bv.dim() == 4 else bk]
                for bk, bv in v.items()
            }
        else:
            out[k] = _TOP_RULES[k]
    return out


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: Tuple, mesh) -> Tuple:
    """One placement per mesh dim (in the mesh's order) for a rule: a
    mesh axis of size > 1 named at tensor dim d is `Shard(d)`; every other
    mesh dim is `Replicate()`.  A tensor dim named by two axes (the
    batch's (data, fsdp)) is sharded over both, data major, as a
    PartitionSpec's tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec) if axis in _axes(e)), None)
        out.append(Shard(dim) if dim is not None and sizes[axis] > 1 else Replicate())
    return tuple(out)


def _map(fn, tree, *rest):
    return {
        k: _map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


def param_placements(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Every leaf's placements under the rules (`param_pspecs`)."""
    return _map(lambda _, s: spec_placements(s, mesh), params, param_pspecs(params))


def batch_spec(ndim: int = 2) -> Tuple:
    """The rule of a [B, S, ...] batch array: rows over (data, fsdp)."""
    return (BATCH,) + (None,) * (ndim - 1)


def batch_placements(mesh, ndim: int = 2) -> Tuple:
    return spec_placements(batch_spec(ndim), mesh)


def check_divisibility(params: Dict[str, Any], mesh) -> Optional[str]:
    """An error string if a leaf's dim does not divide by its mesh axes."""
    sizes = mesh_sizes(mesh)

    def walk(tree, specs, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                err = walk(v, specs[k], path + [k])
            else:
                err = None
                for dim, entry in zip(v.shape, specs[k]):
                    axes = _axes(entry)
                    total = int(np.prod([sizes[a] for a in axes])) if axes else 1
                    if dim % total:
                        err = f"{'/'.join(path + [k])}: dim {dim} % {axes}={total}"
                        break
            if err:
                return err
        return None

    return walk(params, param_pspecs(params), [])


def distribute(x: torch.Tensor, mesh, placements):
    """`distribute_tensor` of a full tensor that every rank holds alike:
    each rank keeps its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Place a param tree (full tensors, the same on every rank) on the
    mesh by the rules."""
    dev = mesh.device_type
    return _map(lambda x, pl: distribute(x.detach().to(dev), mesh, pl),
                params, param_placements(params, mesh))


def compute_placements(placements: Tuple, mesh) -> Tuple:
    """A leaf's layout in the forward: every axis but `model` gathered
    (the FSDP all-gather), the `model` shards kept (tensor parallel)."""
    from torch.distributed.tensor import Replicate

    return tuple(p if a == MODEL_AXIS else Replicate()
                 for a, p in zip(mesh.mesh_dim_names, placements))


def compute_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The params in their forward layout (`compute_placements`),
    differentiably: a gradient flows back as the reduce-scatter over
    `fsdp` and the all-reduce over `data`."""
    return _map(lambda x: x.redistribute(mesh, list(compute_placements(x.placements, mesh))),
                params)


def local_replica(x, mesh) -> torch.Tensor:
    """A leaf gathered whole on every rank, as a local tensor whose
    gradient is this rank's share: summed over the batch axes (each rank
    differentiates its own rows), the same on every other axis."""
    from torch.distributed.tensor import Partial, Replicate

    sizes = mesh_sizes(mesh)
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    grads = [Partial() if a in BATCH and sizes[a] > 1 else Replicate()
             for a in mesh.mesh_dim_names]
    return full.to_local(grad_placements=grads)


def rows_dtensor(local: torch.Tensor, mesh):
    """This rank's rows [B_local, ...] as the batch-sharded DTensor
    [B, ...] (differentiable both ways)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, list(batch_placements(mesh, local.dim())),
                              run_check=False)


def rows_local(x) -> torch.Tensor:
    """A batch-sharded DTensor's local rows; the gradient comes back
    batch-sharded."""
    mesh = x.device_mesh
    return x.redistribute(mesh, list(batch_placements(mesh, x.dim()))).to_local(
        grad_placements=list(batch_placements(mesh, x.dim())))


def local_rows(mesh, value: np.ndarray, rank: Optional[int] = None) -> np.ndarray:
    """This rank's own row block of a [B, ...] host batch array: rows map
    contiguously onto the flattened (data, fsdp) coordinates.  Under the
    sharded data plane the other blocks of `value` are placeholders
    (`engines/packing.pack_sample(shard_blocks=...)`)."""
    from areal_tpu_torch.base.topology import local_batch_shard

    shard, n = local_batch_shard(mesh, rank)
    b = value.shape[0]
    if b % n:
        raise ValueError(f"batch rows ({b}) must divide the shard count ({n}); the packer "
                         "pads rows to the mesh's batch degree")
    lo = shard * (b // n)
    return np.ascontiguousarray(value[lo: lo + b // n])


def place_rows(mesh, value: np.ndarray, device):
    """A row-major [B, ...] host batch array as the batch-sharded DTensor
    [B, ...]: each rank places only its own row block (`local_rows`),
    the JAX package's `place_rows` through
    `make_array_from_process_local_data`.  Under the shard-exact dispatch
    the other blocks of `value` are placeholders, never read.  On the
    card the block goes through pinned memory with a non-blocking copy."""
    local = torch.from_numpy(local_rows(mesh, value))
    if torch.device(device).type == "cuda":
        local = local.pin_memory().to(device, non_blocking=True)
    else:
        local = local.to(device)
    return rows_dtensor(local, mesh)


def replicate(tree: Any, mesh) -> Any:
    """Every leaf of `tree` replicated over the mesh, as DTensors: a
    DTensor leaf gathered (a collective: every rank calls it), a plain
    tensor (the same on every rank) placed with no collective.  Its
    `to_local()` is the whole tensor on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim

    def one(x):
        if isinstance(x, DTensor):
            return x.redistribute(mesh, rep)
        return distribute(x, mesh, rep)

    return _map(one, tree) if isinstance(tree, dict) else one(tree)


def mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over every rank of the mesh (which spans the world,
    `base/topology.make_mesh`) of each rank's `t`, the same on every rank
    after: one all-reduce (not differentiable)."""
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out)
    return out


def batch_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the batch axes of every rank's `t` (each rank holding
    its own rows' share; the ranks of one row block hold the same), the
    same on every rank after: `mesh_sum` of each rank's share divided by
    the number of ranks holding its row block."""
    share = mesh.size() // batch_sharding_degree(mesh)
    return mesh_sum(t if share == 1 else t / share, mesh)


def replication(placements: Tuple, mesh) -> int:
    """How many ranks hold each element of a DTensor of `placements`: the
    product of the sizes of the mesh dims it is not sharded over."""
    sizes = [int(mesh.size(i)) for i in range(mesh.ndim)]
    return int(np.prod([n for n, p in zip(sizes, placements) if not p.is_shard()]))


def check_layout(cfg, mesh, params: Optional[Dict[str, Any]] = None) -> None:
    """Refuse a layout the port cannot run: pipe or seq above 1 (item
    8.5), a MoE model on any mesh (its grouped products take no
    DTensor and its capacity and aux loss are batch-global: item 8.7),
    and a leaf that does not divide by its mesh axes.  The heads'
    rule is `attn_dispatch`'s."""
    from areal_tpu_torch.base.topology import ParallelConfig, check_ported

    sizes = mesh_sizes(mesh)
    check_ported(ParallelConfig(**{a: sizes[a] for a in AXIS_ORDER}))
    if cfg.is_moe:
        raise NotImplementedError(
            "a MoE model on a device mesh is not ported (ROADMAP queue 1, item 8.7): "
            "torch._grouped_mm takes no DTensor, and the capacity and the aux loss are "
            "batch-global"
        )
    if params is not None:
        err = check_divisibility(params, mesh)
        if err:
            raise ValueError(f"the params do not divide over the mesh: {err}")


def attn_dispatch(mesh, cfg) -> Tuple[Any, int]:
    """(use_flash, rows_multiple): the mesh itself (the forward's
    attention is `flash_attention_sharded` over it, batch over (data,
    fsdp), heads over `model`), and what packed row counts must divide
    by, the batch-sharding degree.  A layout whose model axis does not
    divide the head counts is refused, not sent to a plain attention:
    the JAX package falls back to XLA attention there."""
    m = mesh_sizes(mesh)[MODEL_AXIS]
    if cfg.n_q_heads % m or cfg.n_kv_heads % m:
        raise ValueError(
            f"the model axis ({m}) must divide both head counts ({cfg.n_q_heads}q/"
            f"{cfg.n_kv_heads}kv): the flash kernels shard whole q-head groups"
        )
    return mesh, batch_sharding_degree(mesh)
