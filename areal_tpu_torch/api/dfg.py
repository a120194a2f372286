"""The dataflow graph of model function calls (MFCs) (port of
areal_tpu/api/dfg.py): an RL algorithm is a DAG whose nodes are
generate/inference/train calls on named models and whose edges are
inferred from which node produces the data keys another consumes.

One device, so no `shard_keys` (the sharded data plane of ROADMAP
queue 1, item 8)."""

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from areal_tpu_torch.api.config import (
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)
from areal_tpu_torch.api.data_api import MicroBatchSpec


@dataclasses.dataclass
class ParamReallocHook:
    """Sync params into another model after an MFC (eta 1.0: copy; eta
    below 1 is an EMA, not yet ported)."""

    target: ModelName
    eta: float = 1.0


@dataclasses.dataclass
class OffloadHook:
    """Move a model's params to host memory after the call; `target`
    defaults to the MFC's own model."""

    target: Optional[ModelName] = None


@dataclasses.dataclass
class MFCDef:
    name: str
    model_name: ModelName
    interface_type: ModelInterfaceType
    interface_impl: ModelInterfaceAbstraction
    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()
    # Rename graph keys -> interface-local keys on input, and
    # interface-local -> graph keys on output.
    input_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    output_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    n_seqs: int = 1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    pre_hooks: List = dataclasses.field(default_factory=list)
    post_hooks: List = dataclasses.field(default_factory=list)

    # Filled by build_graph:
    children: List["MFCDef"] = dataclasses.field(default_factory=list, repr=False)
    parents: List["MFCDef"] = dataclasses.field(default_factory=list, repr=False)

    @property
    def is_src(self) -> bool:
        return not self.parents

    @property
    def is_dst(self) -> bool:
        return not self.children

    @property
    def role(self) -> str:
        return self.model_name.role

    def __hash__(self):
        return hash(self.name)


@dataclasses.dataclass
class DFG:
    nodes: List[MFCDef]
    data_producers: Dict[str, Optional[MFCDef]]  # None = dataset-sourced
    data_consumers: Dict[str, List[MFCDef]]

    @property
    def dataset_keys(self) -> Set[str]:
        return {k for k, p in self.data_producers.items() if p is None}

    def topological_order(self) -> List[List[MFCDef]]:
        """Nodes grouped by topological level."""
        indeg = {n.name: len(n.parents) for n in self.nodes}
        level = [n for n in self.nodes if indeg[n.name] == 0]
        out = []
        seen = 0
        while level:
            out.append(level)
            seen += len(level)
            nxt: List[MFCDef] = []
            for n in level:
                for c in n.children:
                    indeg[c.name] -= 1
                    if indeg[c.name] == 0:
                        nxt.append(c)
            level = nxt
        if seen != len(self.nodes):
            raise ValueError("DFG has a cycle")
        return out


def build_graph(nodes: List[MFCDef]) -> DFG:
    """Infer edges: an MFC consuming key K is a child of the MFC producing
    K (dataset keys have no producer)."""
    names = [n.name for n in nodes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate MFC names: {names}")
    producers: Dict[str, Optional[MFCDef]] = {}
    consumers: Dict[str, List[MFCDef]] = {}
    for n in nodes:
        n.children, n.parents = [], []
        for k in n.output_keys:
            if k in producers and producers[k] is not None:
                raise ValueError(
                    f"key {k!r} produced by both {producers[k].name} and {n.name}"
                )
            producers[k] = n
    for n in nodes:
        for k in n.input_keys:
            producers.setdefault(k, None)  # dataset-sourced
            consumers.setdefault(k, []).append(n)
    for n in nodes:
        parent_set = []
        for k in n.input_keys:
            p = producers[k]
            if p is not None and p is not n and p not in parent_set:
                parent_set.append(p)
        n.parents = parent_set
        for p in parent_set:
            p.children.append(n)
    dfg = DFG(nodes=nodes, data_producers=producers, data_consumers=consumers)
    dfg.topological_order()  # raises on cycles
    return dfg
