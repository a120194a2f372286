"""Core abstractions (port of areal_tpu/api/config.py): model names,
interface types and the string-keyed factory specs an experiment plan
is written in."""

import dataclasses
import enum
from typing import Any, Dict


class ModelInterfaceType(enum.Enum):
    GENERATE = "generate"
    INFERENCE = "inference"
    TRAIN_STEP = "train_step"
    EVALUATE = "evaluate"


@dataclasses.dataclass(frozen=True, order=True)
class ModelName:
    role: str
    replica_id: int = 0

    def __str__(self):
        return f"{self.role}@{self.replica_id}"


@dataclasses.dataclass
class ModelInterfaceAbstraction:
    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelBackendAbstraction:
    """Which engine to build for a model: 'train', 'inference',
    'generator' or 'null' (no engine)."""

    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelAbstraction:
    """How to build the model params: 'hf' (checkpoint dir), 'random'
    or 'null' (no weights)."""

    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
