"""Hand one set of weights between the JAX package and the port.

The port's params dict has the JAX package's layout (`embed`, layer-
stacked `blocks`, `final_ln`, optional `lm_head`), so conversion is a
leaf-by-leaf map: the caller turns the JAX pytree's leaves into numpy
arrays (`jax.tree.map(np.asarray, params)`), and these functions do the
rest.  No JAX import here.
"""

from typing import Any, Dict

import numpy as np
import torch

from areal_tpu_torch.base.device import resolve_device


def params_from_numpy(tree: Dict[str, Any], device=None, dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    `device` (the CUDA card unless told otherwise); floating leaves are
    cast to `dtype` when given."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    x = torch.from_numpy(np.array(tree)).to(device)  # a private copy
    if dtype is not None and x.is_floating_point():
        x = x.to(dtype)
    return x


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: torch tensors -> numpy arrays on the host (bf16 and
    fp16 leaves widen to float32, which numpy can hold exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    x = tree.detach().cpu()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.numpy()
