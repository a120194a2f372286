"""The step-composition rule of the cost model (port of `compose_step`
from areal_tpu/analysis/costmodel.py).

The master composes each step's measured per-MFC walls through the DFG's
levels with `compose_step` and publishes how far the composition is from
the measured step (``areal_master_advisor_pred_err_ratio``).  The rest of
the cost model and the placement advisor that ranks layouts with it are
ROADMAP queue 1 item 10.
"""

from typing import Dict, Sequence


def compose_step(
    levels: Sequence[Sequence[str]],
    walls: Dict[str, float],
    extra_s: float = 0.0,
) -> float:
    """Barrier composition: each level waits for its slowest MFC.  MFCs
    absent from ``walls`` contribute nothing (a level of unknowns is
    free, not infinite)."""
    total = extra_s
    for level in levels:
        vals = [walls[m] for m in level if m in walls]
        if vals:
            total += max(vals)
    return total
