"""Anomaly verdict bits of the train step (port of the verdict part of
areal_tpu/base/integrity.py).

A train step's verdict is a small integer carried as a float through the
stats; each set bit names one anomaly.  The port's engine sets only
NONFINITE (its always-on guard); the other bits belong to the tunable
sentinels, which are not yet ported, and keep their values so verdicts
read the same in both packages.  `record_anomaly` counts trips by kind
in `ANOMALY_COUNTS` (the JAX package bumps a metrics counter)."""

import collections
from typing import List

NONFINITE = 1        # non-finite loss or grad norm (engine)
GRAD_SPIKE = 2       # grad norm > mult x running EWMA (engine)
UPDATE_NORM = 4      # update norm above the configured ceiling (engine)
KL_BLOWUP = 8        # batch mean |KL(policy, ref)| above anomaly_kl_max
IMP_RATIO = 16       # behavior/ref importance ratio collapsed or exploded
DEGENERATE_VAR = 32  # every GRPO group's scores have zero variance

_KIND_BITS = (
    (NONFINITE, "nonfinite"),
    (GRAD_SPIKE, "grad_spike"),
    (UPDATE_NORM, "update_norm"),
    (KL_BLOWUP, "kl_blowup"),
    (IMP_RATIO, "imp_ratio"),
    (DEGENERATE_VAR, "degenerate_variance"),
)

ANOMALY_COUNTS: "collections.Counter[str]" = collections.Counter()


def verdict_kinds(verdict: float) -> List[str]:
    """Decode a packed verdict scalar into its anomaly kind names."""
    v = int(verdict)
    return [name for bit, name in _KIND_BITS if v & bit]


def record_anomaly(verdict: float) -> None:
    """Count one trip per set bit of `verdict`."""
    ANOMALY_COUNTS.update(verdict_kinds(verdict))
