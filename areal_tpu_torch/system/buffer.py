"""The master's data-readiness ledger (port of `SequenceBuffer` in
areal_tpu/system/buffer.py): metadata-only samples, one entry per data
id; an MFC's coroutine blocks until `n_seqs` entries carry all of its
input keys and have not been consumed by it yet, and an entry is
evicted once every registered consumer has used it."""

import asyncio
import dataclasses
from typing import Dict, List, Optional, Sequence, Set

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import MFCDef


@dataclasses.dataclass
class _Entry:
    sample: SequenceSample  # metadata-only, bs == 1
    consumed_by: Set[str] = dataclasses.field(default_factory=set)


class SequenceBuffer:
    def __init__(self, consumers: Dict[str, Sequence[str]]):
        """consumers: MFC name -> its input keys (every one must consume
        an entry before it is evicted)."""
        self._entries: Dict[str, _Entry] = {}
        self._consumers = {k: tuple(v) for k, v in consumers.items()}
        self._cond = asyncio.Condition()

    def __len__(self):
        return len(self._entries)

    def ids(self) -> List[str]:
        return list(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"size": len(self._entries)}

    def clear(self) -> None:
        """Forget every entry (an aborted step)."""
        self._entries.clear()

    async def put_batch(self, sample: SequenceSample) -> None:
        """Register a batch's entries (new ids) or merge its keys into
        existing ones."""
        async with self._cond:
            for one in sample.unpack():
                (sid,) = one.ids
                if sid in self._entries:
                    self._entries[sid].sample.update_(one)
                else:
                    self._entries[sid] = _Entry(sample=one)
            self._cond.notify_all()

    # An MFC's outputs merge into existing entries the same way.
    amend_batch = put_batch

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
