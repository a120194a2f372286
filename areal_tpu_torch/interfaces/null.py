"""The no-op interface of the null trials (port of
areal_tpu/interfaces/null.py, `NullInterface`, registered "null").

`inference` makes one random reward per sequence, shaped as the math
reward interface's output, from a numpy generator seeded as the JAX
package seeds it (so both packages draw the same rewards); `train_step`
consumes its batch and returns `null/n_seqs`.  The trial's dispatch,
data plane and buffer run with no device compute.  The generator's state
goes into recover checkpoints (`state_dict`), so a resumed trial draws
the rewards the uninterrupted one draws; the JAX package's restarts its
stream from the seed.
"""

from typing import Dict

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface


class NullInterface(ModelInterface):
    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        key = "packed_prompts" if "packed_prompts" in sample.keys else "packed_input_ids"
        groups = [len(row) for row in sample.seqlens[key]]
        scores = self._rng.standard_normal(sum(groups)).astype(np.float32)
        return SequenceSample(
            keys={"rewards"},
            ids=list(sample.ids),
            seqlens={"rewards": [[1] * g for g in groups]},
            data={"rewards": scores},
        )

    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        return {"null/n_seqs": float(len(sample.ids))}

    def state_dict(self) -> Dict:
        return {"rng": self._rng.bit_generator.state}

    def load_state_dict(self, sd: Dict) -> None:
        if "rng" in sd:
            self._rng.bit_generator.state = sd["rng"]


register_interface("null", NullInterface)
