"""Forward-only inference engine for the reference model's logprobs
(port of areal_tpu/engines/inference.py, one device).

Frozen params in the compute dtype (bf16 on the card, fp32 on the CPU,
as `TrainEngine` computes), no optimizer state; `forward` has
`TrainEngine.forward`'s packing contract (`engines/train.forward_sample`)
and runs the same packed forward (K1f on the card).  `offload()` parks
the params in host memory between calls.
"""

from typing import Any, Callable, Dict, Sequence

import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.engines.offload import HostOffloadMixin, buffers_alias
from areal_tpu_torch.engines.train import _map_tree, forward_sample, model_out
from areal_tpu_torch.models.config import ModelConfig

Params = Dict[str, Any]


class InferenceEngine(HostOffloadMixin):
    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        device=None,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        if cfg.is_moe:
            raise NotImplementedError("MoE models are not yet ported")
        self.cfg = cfg
        self.device = resolve_device(device)
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
            dtype = self.compute_dtype if x.is_floating_point() else x.dtype
            y = x.detach().to(self.device, dtype)
            return y.clone() if buffers_alias(y, x) else y

        self.params = _map_tree(private, params)

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
        return forward_sample(
            lambda b: post_fn(model_out(self.params, self.cfg, b, remat=False), b),
            self.device, sample, mb_spec, output_key, token_key, extra_keys,
        )
