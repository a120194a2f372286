"""Merging scalar stat dicts (port of `merge_stats` in
areal_tpu/base/stats.py)."""

import logging
from collections import defaultdict
from typing import Dict, List

import numpy as np

logger = logging.getLogger("areal_tpu_torch.stats")

_warned_partial_denominator = set()


def merge_stats(stats: List[Dict[str, float]]) -> Dict[str, float]:
    """Merge per-part stat dicts.  A key with a matching
    ``<key>_denominator`` in every part is a denominator-weighted mean;
    denominator keys sum; everything else is the unweighted mean.  A key
    with a denominator in some parts but not all is dropped (with a
    log-once warning) rather than merged wrongly."""
    merged: Dict[str, List[float]] = defaultdict(list)
    for s in stats:
        for k, v in s.items():
            merged[k].append(float(v))
    out: Dict[str, float] = {}
    for k, vals in merged.items():
        if k.endswith("_denominator"):
            out[k] = float(np.sum(vals))
            continue
        weights = merged.get(f"{k}_denominator")
        if weights is not None:
            if len(weights) != len(vals):
                if k not in _warned_partial_denominator:
                    _warned_partial_denominator.add(k)
                    logger.warning(
                        "merge_stats: %r has a denominator in %d/%d parts; "
                        "dropping the key", k, len(weights), len(vals),
                    )
                continue
            total = float(np.sum(weights))
            if total > 0:
                out[k] = float(np.dot(vals, weights) / total)
                continue
        out[k] = float(np.mean(vals))
    return out
