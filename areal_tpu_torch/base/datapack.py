"""Sequence packing and partitioning (port of areal_tpu/base/datapack.py:
`flat2d`, `ffd_allocate`, `partition_balanced`)."""

from typing import List, Sequence

import numpy as np


def flat2d(xs: Sequence[Sequence]) -> List:
    """Flatten one nesting level."""
    return [x for sub in xs for x in sub]


def ffd_allocate(
    sizes: Sequence[int], capacity: int, min_groups: int = 1
) -> List[List[int]]:
    """First-fit-decreasing bin packing of item `sizes` under `capacity`.

    Returns groups of original indices; every group's total size is <=
    capacity (items larger than capacity get their own group).  At least
    `min_groups` groups are returned when there are enough items: the
    heaviest multi-item group is split until then."""
    order = np.argsort(-np.asarray(sizes, dtype=np.int64), kind="stable")
    groups: List[List[int]] = []
    loads: List[int] = []
    for idx in order:
        size = int(sizes[idx])
        for g in range(len(groups)):
            if loads[g] + size <= capacity:
                groups[g].append(int(idx))
                loads[g] += size
                break
        else:
            groups.append([int(idx)])
            loads.append(size)
    while len(groups) < min_groups:
        cand = sorted(
            (g for g in range(len(groups)) if len(groups[g]) > 1),
            key=lambda g: -loads[g],
        )
        if not cand:
            break
        g = cand[0]
        items = sorted(groups[g], key=lambda i: -sizes[i])
        keep, move = items[::2], items[1::2]
        groups[g] = keep
        loads[g] = sum(int(sizes[i]) for i in keep)
        groups.append(move)
        loads.append(sum(int(sizes[i]) for i in move))
    # Deterministic order: by smallest contained index.
    for g in groups:
        g.sort()
    groups.sort(key=lambda g: g[0] if g else 1 << 62)
    return groups


def partition_balanced(sizes: Sequence[int], k: int) -> List[List[int]]:
    """Exactly k groups of near-equal total size (greedy longest-
    processing-time); groups may be empty when len(sizes) < k."""
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    order = np.argsort(-np.asarray(sizes, dtype=np.int64), kind="stable")
    groups: List[List[int]] = [[] for _ in range(k)]
    loads = np.zeros(k, dtype=np.int64)
    for idx in order:
        g = int(np.argmin(loads))
        groups[g].append(int(idx))
        loads[g] += int(sizes[idx])
    for g in groups:
        g.sort()
    return groups
