"""SFT and RL prompt datasets and the packed batch loader (port of
`PromptAnswerDataset`, `PromptDataset`, `MathCodePromptDataset` and
`PackedDataLoader` in areal_tpu/data/datasets.py).  The jsonl contracts
are the JAX package's:

- SFT rows:        {"id", "prompt", "answer"}
- RL prompt rows:  {"query_id" | "id", "prompt"}
- math rows:       {"query_id", "prompt", "task": "math", "solutions": [...]}

Rows are shuffled and batches ordered with numpy's `default_rng` as in
the JAX package, so both packages see the same batches in the same order.
`filter` (the master's difficulty filter) removes ids from a math
dataset; the loader then drops the snapshot permutation's indices past
the shrunken dataset, as the JAX loader does.  Code rows (`"task":
"code"`, with `"input_output"`) are kept, as JAX keeps them, and graded
in the sandbox (`interfaces/reward.py`)."""

import json
import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api import data_api
from areal_tpu_torch.api.data_api import SequenceSample

logger = logging.getLogger("areal_tpu_torch.datasets")


def _load_rows(dataset_path, dataset_builder, seed, dp_rank, world_size) -> List[Dict[str, Any]]:
    """This rank's shuffled share of the jsonl rows (or of the builder's)."""
    if dataset_path is not None:
        return data_api.load_shuffle_split_dataset(dataset_path, seed, dp_rank, world_size)
    if dataset_builder is None:
        raise ValueError("need dataset_path or dataset_builder")
    rows = dataset_builder()
    order = np.random.default_rng(seed).permutation(len(rows))
    shard = np.array_split(order, world_size)[dp_rank]
    return [rows[i] for i in shard]


class PromptAnswerDataset:
    """SFT rows: each item is a bs=1 SequenceSample of prompt + answer +
    EOS tokens cut to `max_length` (`packed_input_ids`, int32) and
    `prompt_mask` (bool, True on the prompt's tokens, which the loss
    leaves out)."""

    def __init__(
        self,
        seed: int,
        dp_rank: int,
        world_size: int,
        tokenizer,
        max_length: int = 1024,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        rows = _load_rows(dataset_path, dataset_builder, seed, dp_rank, world_size)
        self.ids: List[str] = []
        self.tokens: List[np.ndarray] = []
        self.prompt_masks: List[np.ndarray] = []
        eos = tokenizer.eos_token_id
        for x in rows:
            n_prompt = len(tokenizer.encode(x["prompt"]))
            full = (list(tokenizer.encode(x["prompt"] + x["answer"])) + [eos])[:max_length]
            mask = np.zeros(len(full), dtype=bool)
            mask[: min(n_prompt, len(full))] = True
            self.ids.append(str(x["id"]))
            self.tokens.append(np.asarray(full, dtype=np.int32))
            self.prompt_masks.append(mask)
        logger.info(f"PromptAnswerDataset: {len(self.ids)} seqs on dp_rank {dp_rank}/{world_size}")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> SequenceSample:
        toks, mask = self.tokens[idx], self.prompt_masks[idx]
        return SequenceSample(
            keys={"packed_input_ids", "prompt_mask"},
            ids=[self.ids[idx]],
            seqlens={"packed_input_ids": [[len(toks)]], "prompt_mask": [[len(toks)]]},
            data={"packed_input_ids": toks, "prompt_mask": mask},
        )

    def filter(self, to_remove_ids) -> int:
        """A static dataset: removes nothing."""
        return 0


class PromptDataset:
    """Map-style dataset over jsonl rows; each item is a bs=1
    SequenceSample with key `packed_prompts`."""

    def __init__(
        self,
        seed: int,
        dp_rank: int,
        world_size: int,
        tokenizer,
        max_length: int = 1024,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.seed = seed
        self.dp_rank = dp_rank
        self.world_size = world_size
        self.tokenizer = tokenizer
        rows = _load_rows(dataset_path, dataset_builder, seed, dp_rank, world_size)
        self.ids: List[str] = []
        self.prompts: List[np.ndarray] = []
        self.metadata_rows: List[Dict[str, Any]] = []
        for x in rows:
            qid = str(x.get("query_id", x.get("id")))
            ids = tokenizer.encode(x["prompt"])[:max_length]
            if not ids:
                continue
            self.ids.append(qid)
            self.prompts.append(np.asarray(ids, dtype=np.int32))
            self.metadata_rows.append(x)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> SequenceSample:
        p = self.prompts[idx]
        return SequenceSample(
            keys={"packed_prompts"},
            ids=[self.ids[idx]],
            seqlens={"packed_prompts": [[len(p)]]},
            data={"packed_prompts": p},
        )

    def filter(self, to_remove_ids) -> int:
        """Drop samples by id; returns the number removed.  A plain
        prompt dataset removes nothing."""
        return 0


class MathCodePromptDataset(PromptDataset):
    """RL math/code prompts with their verification rows (`id2info`) and
    each item's task in its metadata.  Rows whose task is unknown or whose
    solutions are malformed are dropped.  `filter` removes the ids the
    difficulty filter flags, at most `max_filter_percentage` of the
    dataset a call (1.0: uncapped)."""

    def __init__(self, *args, max_filter_percentage: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_filter_percentage = max_filter_percentage
        self.id2info: Dict[str, Dict] = {}
        keep = []
        for i, row in enumerate(self.metadata_rows):
            task = row.get("task", "math")
            try:
                if task == "math":
                    if not isinstance(row.get("solutions", None), list):
                        raise ValueError("solutions must be a list")
                elif task == "code":
                    io = json.loads(row["input_output"])
                    if len(io["inputs"]) != len(io["outputs"]):
                        raise ValueError("inputs and outputs differ in length")
                else:
                    raise ValueError(f"unknown task {task}")
            except (KeyError, TypeError, ValueError) as e:
                logger.warning(f"dropping invalid row query_id={self.ids[i]}: {e}")
                continue
            row = dict(row)
            row["task"] = task
            self.id2info[self.ids[i]] = row
            keep.append(i)
        self.ids = [self.ids[i] for i in keep]
        self.prompts = [self.prompts[i] for i in keep]
        self.metadata_rows = [self.metadata_rows[i] for i in keep]

    def __getitem__(self, idx: int) -> SequenceSample:
        s = super().__getitem__(idx)
        s.metadata = {"task": [self.id2info[self.ids[idx]]["task"]]}
        return s

    def filter(self, to_remove_ids) -> int:
        to_remove = set(map(str, to_remove_ids))
        if not to_remove:
            return 0
        n_max = int(len(self.ids) * self.max_filter_percentage)
        removed = 0
        keep = []
        for i, qid in enumerate(self.ids):
            if qid in to_remove and removed < n_max:
                removed += 1
                continue
            keep.append(i)
        self.ids = [self.ids[i] for i in keep]
        self.prompts = [self.prompts[i] for i in keep]
        self.metadata_rows = [self.metadata_rows[i] for i in keep]
        logger.info(f"filtered {removed} prompts; {len(self.ids)} remain")
        return removed


class PackedDataLoader:
    """Deterministic shuffling batch iterator: epoch e visits the items in
    `default_rng(seed + e).permutation`, `batch_size` at a time, each
    batch gathered into one SequenceSample.  The permutation is drawn
    when the epoch starts: if the difficulty filter shrinks the dataset
    mid-epoch, indices past its new length are dropped (so a batch may
    come up short, and later positions index the shrunken list)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __iter__(self):
        n = len(self.dataset)
        order = np.random.default_rng(self.seed + self._epoch).permutation(n)
        self._epoch += 1
        for i in range(0, n, self.batch_size):
            idx = [int(j) for j in order[i : i + self.batch_size] if j < len(self.dataset)]
            if not idx:
                continue
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield SequenceSample.gather([self.dataset[j] for j in idx])


data_api.register_dataset("prompt_answer", PromptAnswerDataset)
data_api.register_dataset("prompt", PromptDataset)
data_api.register_dataset("math_code_prompt", MathCodePromptDataset)
