"""Several inference interfaces in one MFC (port of
areal_tpu/interfaces/fused.py, `FusedThreadingInterface`, registered
"fused").

The ppo-math trial's `fuse_rew_ref` runs the reward's grading and the
reference model's forward as one MFC on the ref's worker: each
sub-interface's `inference` runs on its own thread, so the grading on
the host overlaps the forward on the card (torch releases the
interpreter lock while the card computes).  The results merge with
`SequenceSample.update_` in sorted-name order; the sub-interfaces
produce disjoint keys, so the order fixes only which error is raised
first.
"""

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Union

from areal_tpu_torch.api.config import ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    Model,
    ModelInterface,
    make_interface,
    register_interface,
)

logger = logging.getLogger("areal_tpu_torch.fused")


class FusedThreadingInterface(ModelInterface):
    """`interfaces` maps a name to a sub-interface, as a
    ModelInterfaceAbstraction or as a dict {"type_": ..., "args": ...}."""

    def __init__(self, interfaces: Dict[str, Union[ModelInterfaceAbstraction, Dict[str, Any]]]):
        self.sub_interfaces: Dict[str, ModelInterface] = {}
        for key, spec in interfaces.items():
            if isinstance(spec, dict):
                spec = ModelInterfaceAbstraction(spec["type_"], spec.get("args", {}))
            self.sub_interfaces[key] = make_interface(spec.type_, **spec.args)

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        def run_one(name: str):
            t0 = time.monotonic()
            res = self.sub_interfaces[name].inference(model, sample, mb_spec)
            logger.info(f"fused sub-interface {name} took {time.monotonic() - t0:.3f}s")
            return res

        with ThreadPoolExecutor(max_workers=len(self.sub_interfaces)) as pool:
            futures = {name: pool.submit(run_one, name) for name in self.sub_interfaces}
            results = {name: fut.result() for name, fut in sorted(futures.items())}

        merged: Optional[SequenceSample] = None
        for name in sorted(results):
            res = results[name]
            if res is None:
                continue
            if merged is None:
                merged = res
            else:
                merged.update_(res)
        return merged


register_interface("fused", FusedThreadingInterface)
