"""Packed sequence batches and the dataset registry (port of the parts of
areal_tpu/api/data_api.py that generation, the train step, the master's
buffer and the data loader use: `MicroBatchSpec`, `SequenceSample`'s
construction, lengths, selection, key merging, gathering, splitting and
metadata-only copies, and `DatasetAbstraction` with its registry).  Host
data stays numpy; the engines move it to the device.  One device: there
are no data-plane shards."""

import dataclasses
import itertools
import json
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np

from areal_tpu_torch.base import datapack


@dataclasses.dataclass(frozen=True)
class MicroBatchSpec:
    """How to split a batch into micro-batches: `n_mbs` is the minimum
    number, `max_tokens_per_mb` caps tokens per micro-batch (None = no
    cap)."""

    n_mbs: int = 1
    max_tokens_per_mb: Optional[int] = None


def _flat2d(xs: Sequence[Sequence[Any]]) -> List[Any]:
    return list(itertools.chain.from_iterable(xs))


@dataclasses.dataclass
class SequenceSample:
    """A packed, variable-length batch.

    seqlens[key][i] is the list of sequence lengths that batch element i
    owns under `key`; data[key] is the concatenation of all those
    sequences along axis 0 (trailing dims allowed)."""

    keys: Set[str]
    ids: List[Hashable]
    seqlens: Dict[str, List[List[int]]]
    data: Optional[Dict[str, Optional[np.ndarray]]] = None
    metadata: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    dtypes: Dict[str, Optional[np.dtype]] = dataclasses.field(default_factory=dict)
    trailing_shapes: Dict[str, Optional[Tuple[int, ...]]] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        self.keys = set(self.keys)
        if len(self.ids) != len(set(self.ids)):
            raise ValueError(f"duplicate ids: {self.ids}")
        for k in self.keys:
            if k not in self.seqlens:
                raise ValueError(f"missing seqlens for key {k!r}")
            if len(self.seqlens[k]) != self.bs:
                raise ValueError(
                    f"seqlens[{k!r}] has {len(self.seqlens[k])} entries, "
                    f"batch size is {self.bs}"
                )
        if self.data is not None:
            for k in self.keys:
                v = self.data.get(k)
                if v is None:
                    continue
                v = np.asarray(v)
                self.data[k] = v
                want = sum(sum(s) for s in self.seqlens[k])
                if v.shape[0] != want:
                    raise ValueError(
                        f"data[{k!r}] axis-0 is {v.shape[0]}, seqlens sum to {want}"
                    )
                self.dtypes.setdefault(k, v.dtype)
                self.trailing_shapes.setdefault(k, tuple(v.shape[1:]))
        for k, v in self.metadata.items():
            if not isinstance(v, list) or len(v) != self.bs:
                raise ValueError(
                    f"metadata[{k!r}] must be a list of length bs={self.bs}"
                )

    @property
    def bs(self) -> int:
        return len(self.ids)

    def total_len(self, key: str) -> int:
        return sum(sum(s) for s in self.seqlens[key])

    def seqlens_of(self, key: str) -> List[int]:
        """Flat per-sequence lengths for a key."""
        return _flat2d(self.seqlens[key])

    def cu_seqlens(self, key: str) -> np.ndarray:
        """Cumulative sequence boundaries [0, l0, l0+l1, ...] (int32)."""
        return np.cumsum([0] + self.seqlens_of(key)).astype(np.int32)

    def select_idx(self, indices: Sequence[int]) -> "SequenceSample":
        """New sample containing the given batch elements, in order."""
        indices = list(indices)
        seqlens = {k: [self.seqlens[k][i] for i in indices] for k in self.keys}
        data = None
        if self.data is not None:
            data = {}
            for k in self.keys:
                v = self.data.get(k)
                if v is None:
                    data[k] = None
                    continue
                bounds = np.cumsum([0] + [sum(s) for s in self.seqlens[k]])
                parts = [v[bounds[i] : bounds[i + 1]] for i in indices]
                data[k] = np.concatenate(parts, axis=0) if parts else v[:0]
        return SequenceSample(
            keys=set(self.keys),
            ids=[self.ids[i] for i in indices],
            seqlens=seqlens,
            data=data,
            metadata={k: [v[i] for i in indices] for k, v in self.metadata.items()},
            dtypes=dict(self.dtypes),
            trailing_shapes=dict(self.trailing_shapes),
        )

    def unpack(self) -> List["SequenceSample"]:
        return [self.select_idx([i]) for i in range(self.bs)]

    def meta(self) -> "SequenceSample":
        """Metadata-only copy (the master's currency): no data, the
        layout, dtypes and trailing shapes kept."""
        return SequenceSample(
            keys=set(self.keys),
            ids=list(self.ids),
            seqlens={k: [list(s) for s in v] for k, v in self.seqlens.items()},
            data=None,
            metadata={k: list(v) for k, v in self.metadata.items()},
            dtypes=dict(self.dtypes),
            trailing_shapes=dict(self.trailing_shapes),
        )

    @classmethod
    def gather(cls, samples: Sequence["SequenceSample"]) -> "SequenceSample":
        """Concatenate samples with the same keys (inverse of split)."""
        samples = list(samples)
        if not samples:
            raise ValueError("cannot gather zero samples")
        keys = samples[0].keys
        for s in samples[1:]:
            if s.keys != keys:
                raise ValueError(f"key mismatch in gather: {s.keys} vs {keys}")
        data = None
        if samples[0].data is not None:
            data = {}
            for k in keys:
                vals = [s.data[k] for s in samples]
                data[k] = (
                    None if any(v is None for v in vals)
                    else np.concatenate([np.asarray(v) for v in vals], axis=0)
                )
        dtypes: Dict[str, Optional[np.dtype]] = {}
        trailing: Dict[str, Optional[Tuple[int, ...]]] = {}
        for s in samples:
            for k, v in s.dtypes.items():
                if v is not None:
                    dtypes.setdefault(k, v)
            for k, v in s.trailing_shapes.items():
                if v is not None:
                    trailing.setdefault(k, v)
        return cls(
            keys=keys,
            ids=_flat2d([s.ids for s in samples]),
            seqlens={k: _flat2d([s.seqlens[k] for s in samples]) for k in keys},
            data=data,
            metadata={
                k: _flat2d([s.metadata.get(k, []) for s in samples])
                for k in samples[0].metadata
            },
            dtypes=dtypes,
            trailing_shapes=trailing,
        )

    def main_key(self) -> str:
        """The key with the largest total length (ties broken
        lexicographically): it carries the token accounting of splits."""
        return max(sorted(self.keys), key=self.total_len)

    def select_keys(self, keys: Sequence[str]) -> "SequenceSample":
        keys = set(keys)
        missing = keys - self.keys
        if missing:
            raise KeyError(f"keys not in sample: {missing}")
        return SequenceSample(
            keys=keys,
            ids=list(self.ids),
            seqlens={k: self.seqlens[k] for k in keys},
            data=None if self.data is None else {k: self.data[k] for k in keys},
            metadata={k: list(v) for k, v in self.metadata.items()},
            dtypes={k: self.dtypes.get(k) for k in keys},
            trailing_shapes={k: self.trailing_shapes.get(k) for k in keys},
        )

    def update_(self, other: "SequenceSample") -> None:
        """Merge keys from `other` (same ids, same order) into self."""
        if other.ids != self.ids:
            raise ValueError("update_ requires identical ids in identical order")
        self.keys |= other.keys
        self.seqlens.update(other.seqlens)
        if other.data is not None:
            if self.data is None:
                self.data = {}
            self.data.update(other.data)
        self.metadata.update(other.metadata)
        self.dtypes.update(other.dtypes)
        self.trailing_shapes.update(other.trailing_shapes)

    def remap_keys_(self, mapping: Dict[str, str]) -> None:
        """Rename keys in place (a dataflow's output key remapping, e.g.
        the reference model's `logprobs` -> `packed_ref_logprobs`)."""
        for old, new in mapping.items():
            if old not in self.keys:
                continue
            self.keys.discard(old)
            self.keys.add(new)
            self.seqlens[new] = self.seqlens.pop(old)
            if self.data is not None and old in self.data:
                self.data[new] = self.data.pop(old)
            if old in self.dtypes:
                self.dtypes[new] = self.dtypes.pop(old)
            if old in self.trailing_shapes:
                self.trailing_shapes[new] = self.trailing_shapes.pop(old)

    def split_groups(self, mb_spec: MicroBatchSpec) -> List[List[int]]:
        """Index groups for micro-batching: FFD under max_tokens_per_mb,
        at least n_mbs groups."""
        lens = [sum(self.seqlens[self.main_key()][i]) for i in range(self.bs)]
        cap = mb_spec.max_tokens_per_mb or (sum(lens) + 1)
        return datapack.ffd_allocate(lens, capacity=cap, min_groups=mb_spec.n_mbs)

    def split(self, mb_spec: MicroBatchSpec) -> List["SequenceSample"]:
        return [self.select_idx(g) for g in self.split_groups(mb_spec) if g]

    def split_balanced(self, k: int) -> List["SequenceSample"]:
        """Exactly k token-balanced, non-empty parts (bs >= k)."""
        if self.bs < k:
            raise ValueError(f"cannot split bs={self.bs} into {k} parts")
        key = self.main_key()
        lens = [sum(self.seqlens[key][i]) for i in range(self.bs)]
        return [self.select_idx(g) for g in datapack.partition_balanced(lens, k)]


# ---------------- dataset registry ----------------


@dataclasses.dataclass
class DatasetAbstraction:
    """String-keyed dataset factory spec."""

    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


ALL_DATASET_CLASSES: Dict[str, Any] = {}


def register_dataset(name: str, cls) -> None:
    if name in ALL_DATASET_CLASSES:
        raise ValueError(f"dataset {name!r} already registered")
    ALL_DATASET_CLASSES[name] = cls


def make_dataset(spec: DatasetAbstraction, seed: int, dp_rank: int, world_size: int,
                 tokenizer=None):
    cls = ALL_DATASET_CLASSES[spec.type_]
    return cls(seed=seed, dp_rank=dp_rank, world_size=world_size, tokenizer=tokenizer,
               **spec.args)


def load_shuffle_split_dataset(
    path: str, seed: int, dp_rank: int, world_size: int
) -> List[Dict[str, Any]]:
    """Load a jsonl dataset, shuffle it with numpy's `default_rng(seed)`
    (as the JAX package does, so both read rows in one order) and return
    this dp_rank's contiguous shard."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    order = np.random.default_rng(seed).permutation(len(rows))
    shard = np.array_split(order, world_size)[dp_rank]
    return [rows[i] for i in shard]
