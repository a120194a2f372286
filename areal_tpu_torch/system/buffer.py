"""The master's data-readiness ledger (port of `SequenceBuffer` in
areal_tpu/system/buffer.py): metadata-only samples, one entry per data
id; an MFC's coroutine blocks until `n_seqs` entries carry all of its
input keys and have not been consumed by it yet, and an entry is
evicted once every registered consumer has used it.

For asynchronous RL an entry carries the master step it was registered
at: `max_age_steps` evicts entries that sat unconsumed for more steps
(stragglers of long-dead rollout batches), `stats()` reports the
resident entries' largest age, and `drop_ids` removes the entries of a
batch the replay buffer rejected or dropped."""

import asyncio
import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Set

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import MFCDef

logger = logging.getLogger("areal_tpu_torch.buffer")


@dataclasses.dataclass
class _Entry:
    sample: SequenceSample  # metadata-only, bs == 1
    consumed_by: Set[str] = dataclasses.field(default_factory=set)
    birth_step: int = 0


class SequenceBuffer:
    def __init__(self, consumers: Dict[str, Sequence[str]],
                 max_age_steps: Optional[int] = None):
        """consumers: MFC name -> its input keys (every one must consume
        an entry before it is evicted).  `max_age_steps`: an entry older
        than this many master steps is evicted at the next put (counted
        in `evicted_aged`); None keeps entries forever."""
        self._entries: Dict[str, _Entry] = {}
        self._consumers = {k: tuple(v) for k, v in consumers.items()}
        self._cond = asyncio.Condition()
        self.max_age_steps = max_age_steps
        self._step = 0
        self.evicted_aged = 0

    def __len__(self):
        return len(self._entries)

    def ids(self) -> List[str]:
        return list(self._entries)

    def staleness_histogram(self) -> Dict[int, int]:
        """Resident entries by age (current step - birth step)."""
        hist: Dict[int, int] = {}
        for e in self._entries.values():
            age = self._step - e.birth_step
            hist[age] = hist.get(age, 0) + 1
        return hist

    def stats(self) -> Dict[str, int]:
        """The occupancy the master logs each step."""
        hist = self.staleness_histogram()
        return {
            "size": len(self._entries),
            "evicted_aged": self.evicted_aged,
            "max_age": max(hist) if hist else 0,
        }

    def clear(self) -> None:
        """Forget every entry (an aborted step)."""
        self._entries.clear()

    async def put_batch(self, sample: SequenceSample, step: int = 0) -> None:
        """Register a batch's entries (new ids, born at master step
        `step`) or merge its keys into existing ones."""
        async with self._cond:
            self._step = max(self._step, step)
            for one in sample.unpack():
                (sid,) = one.ids
                if sid in self._entries:
                    self._entries[sid].sample.update_(one)
                else:
                    self._entries[sid] = _Entry(sample=one, birth_step=step)
            self._evict_aged()
            self._cond.notify_all()

    async def amend_batch(self, sample: SequenceSample) -> None:
        """Merge an MFC's output keys into the entries (a new id is born
        at step 0, as in the JAX package)."""
        async with self._cond:
            for one in sample.unpack():
                (sid,) = one.ids
                if sid in self._entries:
                    self._entries[sid].sample.update_(one)
                else:
                    self._entries[sid] = _Entry(sample=one)
            self._cond.notify_all()

    async def drop_ids(self, ids: Sequence[str]) -> None:
        """Remove entries outright: an asynchronous-RL batch the replay
        buffer rejected or dropped must leave the ledger too, or a
        downstream MFC would train on it."""
        async with self._cond:
            for sid in ids:
                self._entries.pop(sid, None)

    def _evict_aged(self):
        if self.max_age_steps is None:
            return
        dead = [sid for sid, e in self._entries.items()
                if self._step - e.birth_step > self.max_age_steps]
        for sid in dead:
            del self._entries[sid]
            self.evicted_aged += 1
        if dead:
            logger.warning(f"evicted {len(dead)} entries older than {self.max_age_steps} steps")

    def _ready_ids(self, rpc: MFCDef) -> List[str]:
        need = set(rpc.input_keys)
        return [
            sid for sid, e in self._entries.items()
            if rpc.name not in e.consumed_by and need <= e.sample.keys
        ]

    async def get_batch_for_rpc(
        self, rpc: MFCDef, timeout: Optional[float] = None
    ) -> SequenceSample:
        """Wait until rpc.n_seqs entries are ready; mark them consumed;
        evict the entries every consumer has used.  Returns the gathered
        metadata sample restricted to rpc.input_keys."""

        async def _wait():
            async with self._cond:
                while True:
                    ready = self._ready_ids(rpc)
                    if len(ready) >= rpc.n_seqs:
                        parts = []
                        for sid in ready[: rpc.n_seqs]:
                            e = self._entries[sid]
                            e.consumed_by.add(rpc.name)
                            parts.append(e.sample.select_keys(set(rpc.input_keys) & e.sample.keys))
                        self._evict()
                        return SequenceSample.gather(parts)
                    await self._cond.wait()

        return await asyncio.wait_for(_wait(), timeout)

    def _evict(self):
        every = set(self._consumers)
        for sid in [s for s, e in self._entries.items() if every and every <= e.consumed_by]:
            del self._entries[sid]
