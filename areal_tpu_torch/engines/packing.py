"""SequenceSample <-> dense packed rows (port of areal_tpu/engines/
packing.py).

Sequences are FFD-packed into rows of a bucketed length (a multiple of
128, which the flash kernels' shape rule needs), each sequence a segment
(ids 1, 2, ... within its row, 0 = padding), and outputs scatter back to
the original per-sequence packed order.

On a mesh the row count is padded to the batch-sharding degree, and a
sample tagged `shard_of` (the sharded data plane) packs each shard's
sequences into its own equal contiguous row block (`split_sharded`,
`pack_sample(shard_blocks=...)`), the block that member places."""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.base import datapack

_LARGE_STEP = 1024


def bucket_len(n: int) -> int:
    """Round a row length up: 128, then powers of two up to 1024, then
    multiples of 1024."""
    n = max(n, 1)
    if n <= 128:
        return 128
    if n <= 1024:
        p = 128
        while p < n:
            p *= 2
        return p
    return -(-n // _LARGE_STEP) * _LARGE_STEP


def split_sharded(
    sample: SequenceSample, mb_spec
) -> List[Tuple[SequenceSample, Optional[List[List[int]]]]]:
    """A micro-batch split that every member of a sharded data plane
    derives alike from metadata alone: each shard (`shard_blocks`) is
    FFD-split on its own into a common group count k, micro-batch j joins
    every shard's j-th group, and each micro-batch comes with its
    per-shard SEQUENCE index blocks (for `pack_sample`).  Without shard
    tags this is `sample.split(mb_spec)` with no blocks."""
    blocks = sample.shard_blocks()
    if not blocks or len(blocks) <= 1:
        return [(mb, None) for mb in sample.split(mb_spec)]
    key = sample.main_key()
    lens = [sum(sample.seqlens[key][i]) for i in range(sample.bs)]
    cap = mb_spec.max_tokens_per_mb or (sum(lens) + 1)
    k = max(mb_spec.n_mbs, 1)
    while True:
        per = [
            datapack.ffd_allocate([lens[i] for i in b], capacity=cap, min_groups=min(k, len(b)))
            if b else []
            for b in blocks
        ]
        k2 = max((len(g) for g in per), default=1)
        if k2 <= k:
            break
        k = k2  # a shard needed more groups: split every shard again
    out = []
    for j in range(k):
        idx: List[int] = []
        row_blocks: List[List[int]] = []
        for b, gs in zip(blocks, per):
            g = [b[i] for i in gs[j]] if j < len(gs) else []
            row_blocks.append(list(range(len(idx), len(idx) + len(g))))
            idx.extend(g)
        if not idx:
            continue
        mb = sample.select_idx(idx)
        # The blocks index sequences, not batch elements (a PPO element
        # holds `group` sequences): widen each shard's element range to
        # its sequence range (shard-major order keeps them contiguous).
        row_nseq = [len(sample.seqlens[key][i]) for i in idx]
        mb_blocks: List[List[int]] = []
        pos = 0
        for rb in row_blocks:
            n_seq = sum(row_nseq[r] for r in rb)
            mb_blocks.append(list(range(pos, pos + n_seq)))
            pos += n_seq
        out.append((mb, mb_blocks))
    return out


@dataclasses.dataclass
class RowPack:
    """Dense row layout plus the map back to packed-1D order.

    arrays: key -> [B, S, *trailing] (tokens, segment_ids, positions and
    the aligned extra keys).  seq_map: per original sequence, in packed
    order, (row, start, length)."""

    arrays: Dict[str, np.ndarray]
    seq_map: List[Tuple[int, int, int]]
    n_rows: int
    row_len: int

    def unpack(self, dense: np.ndarray) -> np.ndarray:
        """[B, S, ...] -> packed 1D [sum(lens), ...] in original order."""
        parts = [dense[r, s : s + l] for (r, s, l) in self.seq_map]
        return np.concatenate(parts, axis=0)


def pack_sample(
    sample: SequenceSample,
    token_key: str,
    extra_keys: Sequence[str] = (),
    max_tokens_per_row: Optional[int] = None,
    n_rows_multiple: int = 1,
    shard_blocks: Optional[List[List[int]]] = None,
) -> RowPack:
    """Pack every sequence of `sample[token_key]` into dense rows of at
    least `max_tokens_per_row` capacity (the longest sequence if more).
    The extra keys must be token-aligned with token_key.  The row count
    is padded with empty rows to a multiple of `n_rows_multiple` (a
    mesh's batch-sharding degree).  `shard_blocks` (per-shard lists of
    sequence indices that partition the sequences) pins each shard's
    sequences to its own equal contiguous row block, in shard order: the
    rows a member places (`parallel/sharding.local_rows`)."""
    lens = sample.seqlens_of(token_key)
    for k in extra_keys:
        if sample.seqlens_of(k) != lens:
            raise ValueError(
                f"extra key {k!r} is not token-aligned with {token_key!r}"
            )
    cap = max(max_tokens_per_row or 0, max(lens, default=1))
    mult = max(n_rows_multiple, 1)
    if shard_blocks is not None and len(shard_blocks) > 1:
        n_shards = len(shard_blocks)
        if sorted(i for b in shard_blocks for i in b) != list(range(len(lens))):
            raise ValueError("shard_blocks must partition the sequences")
        per_groups = [datapack.ffd_allocate([lens[i] for i in b], capacity=cap)
                      for b in shard_blocks]
        # Equal blocks, each a multiple of its shard's slice of the degree.
        per_mult = max(mult // n_shards, 1) if mult % n_shards == 0 else mult
        rows_per_shard = max(len(g) for g in per_groups)
        rows_per_shard = -(-rows_per_shard // per_mult) * per_mult
        groups = []
        for block, gs in zip(shard_blocks, per_groups):
            groups.extend([[block[i] for i in g] for g in gs])
            groups.extend([] for _ in range(rows_per_shard - len(gs)))
    else:
        groups = datapack.ffd_allocate(lens, capacity=cap)
        groups.extend([] for _ in range(-len(groups) % mult))
    n_rows = len(groups)
    s_pad = bucket_len(max((sum(lens[i] for i in g) for g in groups), default=1))

    tok_src = np.asarray(sample.data[token_key])
    bounds = sample.cu_seqlens(token_key)
    extra_src = {k: np.asarray(sample.data[k]) for k in extra_keys}
    ex_bounds = {k: sample.cu_seqlens(k) for k in extra_keys}

    def alloc(src):
        return np.zeros((n_rows, s_pad) + src.shape[1:], dtype=src.dtype)

    tokens = alloc(tok_src)
    seg = np.zeros((n_rows, s_pad), np.int32)
    pos = np.zeros((n_rows, s_pad), np.int32)
    extras = {k: alloc(v) for k, v in extra_src.items()}
    seq_map: List[Optional[Tuple[int, int, int]]] = [None] * len(lens)
    for r, g in enumerate(groups):
        off = 0
        for seq_no, i in enumerate(g, start=1):
            l = lens[i]
            tokens[r, off : off + l] = tok_src[bounds[i] : bounds[i + 1]]
            seg[r, off : off + l] = seq_no
            pos[r, off : off + l] = np.arange(l)
            for k in extra_keys:
                eb = ex_bounds[k]
                extras[k][r, off : off + l] = extra_src[k][eb[i] : eb[i + 1]]
            seq_map[i] = (r, off, l)
            off += l
    arrays = {"tokens": tokens, "segment_ids": seg, "positions": pos}
    arrays.update(extras)
    return RowPack(arrays=arrays, seq_map=seq_map, n_rows=n_rows, row_len=s_pad)
