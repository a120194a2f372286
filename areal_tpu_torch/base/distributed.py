"""The `torch.distributed` world (port of areal_tpu/base/distributed.py).

The JAX package forms a multi-controller world with
`jax.distributed.initialize`; here every member of a trial's SPMD group
is one process driving one device, and `initialize` forms the
`torch.distributed` world over them: NCCL on the CUDA card, gloo when
the caller asks for the CPU.  The rendezvous goes through the port's
own `name_resolve`, as the JAX package's does: process 0 binds a TCP
store and publishes its address, every other process waits for it.
The device choice stays in `base/device.py`; there is no
`is_tpu_backend`.
"""

import logging
from typing import Optional

from areal_tpu_torch.base import name_resolve, names, network
from areal_tpu_torch.base.device import resolve_device

logger = logging.getLogger("distributed")


def coordinator_name(experiment_name: str, trial_name: str, rendezvous: str = "") -> str:
    """The name_resolve key of the world's address; `rendezvous` tells a
    launch attempt's world from an earlier attempt's stale entry."""
    key = names.trial_root(experiment_name, trial_name) + "/torch_coordinator"
    return f"{key}/{rendezvous}" if rendezvous else key


def backend_for(device) -> str:
    """NCCL for the CUDA card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(
    experiment_name: str,
    trial_name: str,
    process_id: int,
    num_processes: int,
    device=None,
    timeout: float = 300.0,
    init_method: Optional[str] = None,
    rendezvous: str = "",
) -> None:
    """Form the world of `num_processes` ranks, this process being rank
    `process_id`.  A world of one rank is formed too (a mesh needs a
    process group).  `init_method` overrides the rendezvous (a
    `file://` path, or `tcp://host:port`); by default process 0 publishes
    `tcp://<its ip>:<free port>` under the trial's name_resolve key
    (`coordinator_name`, with `rendezvous` to tell launch attempts apart)
    and the others wait for it.  `timeout` bounds the rendezvous and
    every collective.  On the card each rank takes device `process_id`:
    NCCL puts no two ranks of a world on one card, so a world larger than
    the card count is refused, never moved to gloo or the CPU."""
    import datetime

    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    if dev.type == "cuda" and num_processes > torch.cuda.device_count():
        raise RuntimeError(
            f"a world of {num_processes} ranks needs {num_processes} CUDA cards, one a rank "
            f"(NCCL takes no two ranks on one card); this machine has "
            f"{torch.cuda.device_count()}"
        )
    if init_method is None:
        key = coordinator_name(experiment_name, trial_name, rendezvous)
        if process_id == 0:
            init_method = f"tcp://{network.gethostip()}:{network.find_free_port()}"
            name_resolve.add(key, init_method, replace=True)
        else:
            init_method = name_resolve.wait(key, timeout=timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id)
    logger.info(f"process {process_id}/{num_processes} joining the world at {init_method}")
    dist.init_process_group(
        backend=backend_for(dev), init_method=init_method, rank=process_id,
        world_size=num_processes, timeout=datetime.timedelta(seconds=timeout),
    )


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes files and returns results."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
