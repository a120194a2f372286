"""Model/algorithm API (port of areal_tpu/api/model_api.py): generation
request/config dataclasses with the JAX package's fields and wire names,
the optimizer and finetune specs, the `Model` bundle, and the
`ModelInterface` registry."""

import dataclasses
from typing import Any, Dict, Optional

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class GenerationHyperparameters:
    """Sampling config."""

    n: int = 1  # group size (responses per prompt)
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    temperature: float = 1.0
    # Speculative decoding: not yet ported (the engine raises for k > 0).
    spec_decode_k: int = 0
    spec_ngram: int = 3
    # Stop sequences: tuple of token-id tuples; a row whose tail matches
    # one finishes there (the stop tokens stay in the output).  Normalized
    # to tuples so the config stays hashable and survives a JSON trip.
    stop: tuple = ()

    def __post_init__(self):
        self.stop = tuple(tuple(int(t) for t in s) for s in self.stop)

    def new(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class APIGenerateInput:
    """One generation request to a generation server."""

    qid: str
    prompt_ids: list  # List[int]
    gconfig: GenerationHyperparameters
    # Seeded requests only co-batch with same-seed requests server-side.
    seed: Optional[int] = None
    trace_id: Optional[str] = None


@dataclasses.dataclass
class APIGenerateOutput:
    """Grouped responses for one request."""

    qid: str
    prompt_ids: list  # List[int]
    output_ids: list  # List[List[int]] — gconfig.n responses
    output_logprobs: list  # List[List[float]]
    no_eos: list  # List[bool] — hit max_new_tokens without EOS
    version: int = 0  # server weight version that produced this
    version_start: int = 0  # weight version sampling started under

    @classmethod
    def from_input(cls, inp: "APIGenerateInput") -> "APIGenerateOutput":
        return cls(
            qid=inp.qid, prompt_ids=list(inp.prompt_ids),
            output_ids=[], output_logprobs=[], no_eos=[],
        )

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def output_lens(self) -> list:
        return [len(x) for x in self.output_ids]


@dataclasses.dataclass
class OptimizerConfig:
    """AdamW with global-norm clipping and an lr schedule."""

    type: str = "adam"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.02
    gradient_clipping: float = 1.0


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int = 1
    dataset_size: int = 0
    train_batch_size: int = 1

    @property
    def steps_per_epoch(self) -> int:
        return max(
            1, (self.dataset_size + self.train_batch_size - 1) // self.train_batch_size
        )

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch


@dataclasses.dataclass
class Model:
    """A named model bundle: an engine (TrainEngine or GeneratorEngine),
    its tokenizer and config, and the weight version."""

    name: str
    engine: Any
    tokenizer: Any
    config: Optional[ModelConfig]
    version: int = 0

    def inc_version(self):
        self.version += 1


ALL_INTERFACES: Dict[str, type] = {}


class ModelInterface:
    """An algorithm: maps (model, data) -> data or stats.  Subclasses
    override any subset."""

    def generate(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        raise NotImplementedError

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        raise NotImplementedError

    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        pass


def register_interface(name: str, cls: type) -> None:
    if name in ALL_INTERFACES:
        raise ValueError(f"interface {name!r} already registered")
    ALL_INTERFACES[name] = cls


def make_interface(name: str, **kwargs) -> ModelInterface:
    return ALL_INTERFACES[name](**kwargs)
