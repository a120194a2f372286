"""Host-side refcounted free-list page allocator for the paged KV pool
(port of areal_tpu/engines/paging.py; the metrics-registry counters are
left out, the allocator's own counters stay).

The device pool (`models/transformer.py PagedKVCache`) is a dumb array of
pages; all placement lives here, on the host, between serving chunks:
which pages belong to which slot, in what order, which are free, and
which are SHARED between slots.  `table` is shipped to the device as the
page table each chunk.

Sharing model (copy-on-write): a page may be mapped by several slots (a
GRPO group's responses mapping the same prompt pages, or a prefix-cache
hit).  `refcount[p]` counts the mappings plus prefix-cache holds.
Shared pages are read-only: before a write inside a slot's window the
engine calls `ensure_writable`, which privatises still-shared pages and
returns (src, dst) pairs for the device page copy.
"""

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """The KV page pool has no free page for a required allocation.
    Raised before any state changes: a clean capacity error."""


class PageAllocator:
    """Refcounted free-list allocator over `n_pages` pages of `page_size`
    tokens.  `table[slot, j]` is the pool page holding the slot's flat
    positions [j*page_size, (j+1)*page_size); unmapped entries hold the
    sentinel `n_pages`."""

    def __init__(
        self, n_pages: int, page_size: int, n_slots: int, max_pages: int
    ):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.sentinel = int(n_pages)
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.table = np.full((n_slots, max_pages), self.sentinel, np.int32)
        self.used = np.zeros((n_slots,), np.int32)
        self.refcount = np.zeros((n_pages,), np.int32)
        # Prefix cache: prompt-hash -> page list, LRU-ordered; each entry
        # holds one ref per page.
        self._prefix_cache: "OrderedDict[object, List[int]]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self._freed_ever: set = set()
        self.pages_recycled = 0
        self.peak_pages_used = 0
        self.cow_copies = 0
        self.shared_mappings = 0
        # Device bytes per pool page (all layers, K+V, codes + scales for
        # int8 pools); stamped by the engine after building the pool.
        self.page_bytes = 0

    # ---------------------------------------------------------------- core

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def allocated_pages(self) -> int:
        return self.n_pages - len(self.free)

    def pool_bytes(self) -> int:
        """Total device bytes of the backing pool, free pages included."""
        return self.n_pages * int(self.page_bytes)

    def _alloc_page(self) -> int:
        p = self.free.pop()
        if p in self._freed_ever:
            self.pages_recycled += 1
        self.refcount[p] = 1
        return p

    def _unref(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self.free.append(p)
            self._freed_ever.add(p)

    def can_reserve(self, slot: int, tokens: int) -> bool:
        need = self.pages_for(tokens)
        if need > self.max_pages:
            return False
        return need - int(self.used[slot]) <= len(self.free)

    def reserve(self, slot: int, tokens: int) -> None:
        """Ensure `slot` has mapped pages covering flat positions
        [0, tokens); raises `PagePoolExhausted` when the pool or the
        table width cannot."""
        need = self.pages_for(tokens)
        if need > self.max_pages:
            raise PagePoolExhausted(
                f"slot {slot} needs {need} pages for {tokens} tokens but "
                f"the page table holds max_pages={self.max_pages} "
                f"(page_size={self.page_size})"
            )
        grow = need - int(self.used[slot])
        if grow > len(self.free):
            raise PagePoolExhausted(
                f"KV page pool exhausted: slot {slot} needs {grow} more "
                f"page(s) for {tokens} tokens but only {len(self.free)} of "
                f"{self.n_pages} are free (page_size={self.page_size}); "
                f"raise kv_pool_pages or admit fewer concurrent requests"
            )
        while self.used[slot] < need:
            self.table[slot, self.used[slot]] = self._alloc_page()
            self.used[slot] += 1
        self.peak_pages_used = max(self.peak_pages_used, self.allocated_pages())

    def release(self, slot: int) -> None:
        """Drop all of `slot`'s mappings; pages whose last reference this
        was go back on the free list."""
        for j in range(int(self.used[slot])):
            self._unref(int(self.table[slot, j]))
        self.table[slot, :] = self.sentinel
        self.used[slot] = 0

    # ------------------------------------------------------------- sharing

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Map `pages` (in order) into the FRONT of the empty `slot`'s
        table, bumping each page's refcount."""
        if int(self.used[slot]) != 0:
            raise ValueError(
                f"share() into non-empty slot {slot} "
                f"(used={int(self.used[slot])})"
            )
        if len(pages) > self.max_pages:
            raise PagePoolExhausted(
                f"slot {slot} cannot map {len(pages)} shared pages: the "
                f"page table holds max_pages={self.max_pages}"
            )
        for j, p in enumerate(pages):
            p = int(p)
            if self.refcount[p] <= 0:
                raise ValueError(f"share() of unmapped page {p}")
            self.refcount[p] += 1
            self.table[slot, j] = p
            self.shared_mappings += 1
        self.used[slot] = len(pages)
        self.peak_pages_used = max(self.peak_pages_used, self.allocated_pages())

    def is_shared(self, slot: int, page_idx: int) -> bool:
        """Whether the page at `slot`'s table entry `page_idx` is mapped
        by another slot or held by the prefix cache too."""
        p = int(self.table[slot, page_idx])
        return p != self.sentinel and int(self.refcount[p]) > 1

    def ensure_writable(
        self, slot: int, lo_tok: int, hi_tok: int
    ) -> List[Tuple[int, int]]:
        """Copy-on-write: privatise every still-shared page of `slot`
        covering flat positions [lo_tok, hi_tok).  Returns the
        (src_page, dst_page) pairs to copy on the device before the next
        write into that window."""
        if hi_tok <= lo_tok:
            return []
        j_lo = int(lo_tok) // self.page_size
        j_hi = (int(hi_tok) - 1) // self.page_size
        pairs: List[Tuple[int, int]] = []
        for j in range(j_lo, min(j_hi + 1, int(self.used[slot]))):
            src = int(self.table[slot, j])
            if src == self.sentinel or int(self.refcount[src]) <= 1:
                continue
            if not self.free:
                raise PagePoolExhausted(
                    f"KV page pool exhausted: slot {slot} needs 1 page to "
                    f"privatise shared page {src} (copy-on-write) but 0 of "
                    f"{self.n_pages} are free (page_size={self.page_size}); "
                    f"raise kv_pool_pages or admit fewer concurrent requests"
                )
            dst = self._alloc_page()
            self.refcount[src] -= 1  # never hits 0: it was > 1
            self.table[slot, j] = dst
            self.cow_copies += 1
            pairs.append((src, dst))
        self.peak_pages_used = max(self.peak_pages_used, self.allocated_pages())
        return pairs

    # -------------------------------------------------------- prefix cache

    def prefix_lookup(self, key) -> Optional[List[int]]:
        """Pages cached for prompt-hash `key` (LRU-refreshed), or None."""
        pages = self._prefix_cache.get(key)
        if pages is None:
            self.prefix_misses += 1
            return None
        self._prefix_cache.move_to_end(key)
        self.prefix_hits += 1
        return list(pages)

    def prefix_insert(self, key, pages: Sequence[int]) -> None:
        """Hold `pages` (a slot's full prompt pages) under `key`, one ref
        per page, so they survive the inserting slot's retirement."""
        if key in self._prefix_cache or len(pages) == 0:
            return
        for p in pages:
            p = int(p)
            if self.refcount[p] <= 0:
                raise ValueError(f"prefix_insert of unmapped page {p}")
            self.refcount[p] += 1
        self._prefix_cache[key] = [int(p) for p in pages]

    def prefix_evict(self, need_free: int = 1) -> int:
        """Drop least-recently-used prefix entries until `need_free` pages
        are free (or the cache is empty).  Returns entries evicted."""
        evicted = 0
        while self._prefix_cache and len(self.free) < need_free:
            _, pages = self._prefix_cache.popitem(last=False)
            for p in pages:
                self._unref(int(p))
            evicted += 1
        return evicted

    def prefix_clear(self) -> int:
        """Drop every prefix-cache hold (a weight update invalidates all
        cached KV).  Returns entries dropped."""
        n = len(self._prefix_cache)
        while self._prefix_cache:
            _, pages = self._prefix_cache.popitem(last=False)
            for p in pages:
                self._unref(int(p))
        return n
