"""Generation request/config dataclasses (port of the generation part of
areal_tpu/api/model_api.py), with the JAX package's fields and wire
names."""

import dataclasses
from typing import Optional


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
