"""Host offload shared by the engines (port of areal_tpu/engines/offload.py).

A synchronous host round trip: `offload()` copies the engine's device
state to host memory and drops the device tensors, so the card's memory
is free while the model is idle; `_ensure_loaded()` copies it back on the
engine's next call.  The round trip is exact (a copy, no cast).  The
host copies of a card's tensors are page-locked, and kept so that later
offloads reuse them: a device-to-host copy into pageable memory ran at
2.6 GB/s on an H100's host (`chip_smoke.py`'s ppo phase).  A DTensor
(an engine on a device mesh) offloads its rank's own shard and comes
back as the same DTensor.
"""

from typing import Any, Dict, Optional, Tuple

import dataclasses

import torch
from torch.distributed.tensor import DTensor


def buffers_alias(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two tensors share any memory.  Object identity is not
    enough: `.to()` of a tensor already in the target dtype and device
    returns the SAME tensor, and a view is a distinct tensor over its
    base's memory, so a private copy must be checked by the byte ranges
    of the storages underneath."""
    if a is b:
        return True
    if a.device != b.device:
        return False
    sa, sb = a.untyped_storage(), b.untyped_storage()
    a0, b0 = sa.data_ptr(), sb.data_ptr()
    return a0 < b0 + sb.nbytes() and b0 < a0 + sa.nbytes()


@dataclasses.dataclass
class _Shard:
    """Where an offloaded DTensor's local shard goes back to."""

    mesh: Any
    placements: Tuple
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]


def _map_state(fn, state, path=()):
    """`fn(path, leaf)` over nested tuples and dicts of tensors."""
    if isinstance(state, dict):
        return {k: _map_state(fn, v, path + (k,)) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_map_state(fn, v, path + (i,)) for i, v in enumerate(state))
    return fn(path, state)


class HostOffloadMixin:
    """Params-only offload; TrainEngine extends it with the optimizer
    state.  The engine provides `device` and `params`."""

    _host_offload: Optional[Tuple[Any, ...]] = None
    _host_buffers: Optional[Dict[Tuple, torch.Tensor]] = None

    def _offload_state(self) -> Tuple[Any, ...]:
        return (self.params,)

    def _restore_state(self, state: Tuple[Any, ...]) -> None:
        (self.params,) = state

    def _drop_state(self) -> None:
        self.params = None

    def offload(self) -> None:
        """Move the device state to host memory while the model is idle;
        the next engine call reloads it."""
        if self._host_offload is not None:
            return
        if self._host_buffers is None:
            self._host_buffers = {}
        bufs = self._host_buffers

        def to_host(path, x):
            shard = None
            if isinstance(x, DTensor):  # a rank keeps its own shard
                shard, x = _Shard(x.device_mesh, x.placements, x.shape, x.stride()), x.to_local()
            buf = bufs.get(path)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = bufs[path] = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            buf.copy_(x, non_blocking=True)
            return buf if shard is None else [shard, buf]

        with torch.no_grad():
            self._host_offload = _map_state(to_host, self._offload_state())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._drop_state()

    def _ensure_loaded(self) -> None:
        if self._host_offload is None:
            return
        def back(_, x):
            if isinstance(x, list):
                shard, buf = x
                return DTensor.from_local(buf.to(self.device, non_blocking=True), shard.mesh,
                                          shard.placements, run_check=False, shape=shard.shape,
                                          stride=shard.stride)
            return x.to(self.device, non_blocking=True)

        state = _map_state(back, self._host_offload)
        self._host_offload = None
        self._restore_state(state)
