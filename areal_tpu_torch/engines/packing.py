"""SequenceSample <-> dense packed rows (port of areal_tpu/engines/
packing.py, one device).

Sequences are FFD-packed into rows of a bucketed length (a multiple of
128, which the flash kernels' shape rule needs), each sequence a segment
(ids 1, 2, ... within its row, 0 = padding), and outputs scatter back to
the original per-sequence packed order."""

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
) -> RowPack:
    """Pack every sequence of `sample[token_key]` into dense rows of at
    least `max_tokens_per_row` capacity (the longest sequence if more).
    The extra keys must be token-aligned with token_key."""
    lens = sample.seqlens_of(token_key)
    for k in extra_keys:
        if sample.seqlens_of(k) != lens:
            raise ValueError(
                f"extra key {k!r} is not token-aligned with {token_key!r}"
            )
    cap = max(max_tokens_per_row or 0, max(lens, default=1))
    groups = datapack.ffd_allocate(lens, capacity=cap)
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
