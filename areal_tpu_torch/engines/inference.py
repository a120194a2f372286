"""Forward-only inference engine for the reference model's logprobs
(port of areal_tpu/engines/inference.py).

Frozen params in the compute dtype (bf16 on the card, fp32 on the CPU,
as `TrainEngine` computes), no optimizer state; `forward` has
`TrainEngine.forward`'s packing contract (`engines/train.forward_sample`)
and runs the same packed forward (K1f on the card).  `offload()` parks
the params in host memory between calls.  On a device mesh (`mesh=`)
the params are DTensors placed by the sharding rules and the forward is
`TrainEngine.forward`'s over the mesh.
"""

from typing import Any, Callable, Dict, Sequence

import torch
from torch.distributed.tensor import DTensor

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.engines.offload import HostOffloadMixin, buffers_alias
from areal_tpu_torch.engines.train import _map_tree, compute_tree, forward_sample, model_out
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.parallel import sharding as shd

Params = Dict[str, Any]


class InferenceEngine(HostOffloadMixin):
    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        device=None,
        compute_dtype: torch.dtype = torch.bfloat16,
        mesh=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an engine on {self.device}")
            shd.check_layout(cfg, mesh, params)
            shd.attn_dispatch(mesh, cfg)
        self.compute_dtype = torch.float32 if self.device.type == "cpu" else compute_dtype
        self.set_params(params)

    def set_params(self, params: Params) -> None:
        """Private copies of `params` in the compute dtype on the engine's
        device.  A cast to the dtype and device a leaf already has returns
        the SAME tensor, and a `TrainEngine` updates its masters in place:
        a ref built from the actor's live weights would drift with every
        update, so any leaf that still shares memory with its source is
        copied.  New weights supersede an offloaded copy."""
        self._host_offload = None

        def private(x: torch.Tensor) -> torch.Tensor:
            if isinstance(x, DTensor):
                x = x.full_tensor()
            dtype = self.compute_dtype if x.is_floating_point() else x.dtype
            y = x.detach().to(self.device, dtype)
            return y.clone() if buffers_alias(y, x) else y

        params = _map_tree(private, params)
        self.params = params if self.mesh is None else shd.shard_params(params, self.mesh)

    def get_params(self) -> Params:
        self._ensure_loaded()
        return self.params

    def train_batch(self, *args, **kwargs):
        raise NotImplementedError("InferenceEngine cannot train")

    def forward(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        post_fn: Callable,
        output_key: str,
        token_key: str = "packed_input_ids",
        extra_keys: Sequence[str] = (),
    ) -> SequenceSample:
        """`post_fn(per_token_output, batch) -> [B, S]` per packed
        micro-batch, re-packed token-aligned under `output_key` in the
        sample's id order."""
        self._ensure_loaded()
        with torch.no_grad():
            pc = compute_tree(self.params, self.compute_dtype, self.mesh)
        return forward_sample(
            lambda b: post_fn(model_out(pc, self.cfg, b, remat=False, mesh=self.mesh), b),
            self.device, sample, mb_spec, output_key, token_key, extra_keys, self.mesh,
        )
