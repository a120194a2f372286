"""Anomaly verdict bits of the train step and the weight checksum (port
of the verdict and checksum parts of areal_tpu/base/integrity.py).

A train step's verdict is a small integer carried as a float through the
stats; each set bit names one anomaly.  The port's engine sets only
NONFINITE (its always-on guard); the other bits belong to the tunable
sentinels, which are not yet ported, and keep their values so verdicts
read the same in both packages.  `record_anomaly` counts trips by kind
in `ANOMALY_COUNTS` (the JAX package bumps a metrics counter).

The weight checksum is a cheap per-leaf L2-norm vector (plus leaf and
element counts) stamped by the pusher and verified by the receiver
before a weight swap: a corrupted push is refused, not served.  Leaves
are taken in sorted-key order, as `jax.tree.leaves` orders a dict, so a
checksum taken on the JAX package's tree verifies against the port's.

A quarantined step goes into the master's ledger as a `QuarantineEntry`
(step, verdict, its kinds, the step's data ids)."""

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


# ---------------- weight checksum ----------------


class WeightChecksumError(RuntimeError):
    """A pushed params tree failed its content checksum."""


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def params_checksum(tree: Any) -> np.ndarray:
    """Content fingerprint of a params tree (nested dicts of torch
    tensors on one device, or of numpy arrays): float64 ``[n_leaves,
    total_elements, leaf_l2_norms...]``.  Tensor leaves are reduced where
    they lie and fetched with one transfer; numpy leaves are reduced on
    the host."""
    leaves = _leaves(tree)
    n_elems = float(sum(int(np.prod(x.shape)) for x in leaves))
    head = [float(len(leaves)), n_elems]
    if not leaves:
        return np.asarray(head, np.float64)
    if all(isinstance(x, np.ndarray) for x in leaves):
        norms = [
            float(np.linalg.norm(np.asarray(x, np.float32).ravel()))
            for x in leaves
        ]
    else:
        stacked = torch.stack([
            torch.linalg.vector_norm(x.detach().float().reshape(-1))
            for x in leaves
        ])
        norms = stacked.cpu().double().tolist()
    return np.asarray(head + norms, np.float64)


# Checksum tolerances: they absorb reduction-order differences between
# devices and libraries, far below any rescaled or shifted leaf.
CHECKSUM_RTOL = 1e-4
CHECKSUM_ATOL = 1e-5


def checksum_matches(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two checksums describe the same params content, within
    CHECKSUM_RTOL / CHECKSUM_ATOL."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or a.shape[0] < 2:
        return False
    if a[0] != b[0] or a[1] != b[1]:
        return False
    return bool(np.allclose(a, b, rtol=CHECKSUM_RTOL, atol=CHECKSUM_ATOL))


def verify_checksum(tree: Any, expected: np.ndarray) -> None:
    """Raise WeightChecksumError unless `tree` matches `expected`."""
    got = params_checksum(tree)
    if not checksum_matches(got, np.asarray(expected, np.float64)):
        raise WeightChecksumError(
            "weight push rejected: params checksum mismatch "
            f"(expected {np.asarray(expected)[:4]}..., got {got[:4]}...); "
            "the payload was corrupted in flight — retry the push"
        )


# ---------------- quarantine ledger entries ----------------


@dataclasses.dataclass
class QuarantineEntry:
    """One quarantined step, kept in RecoverInfo's ledger."""

    step: int
    verdict: int
    kinds: Tuple[str, ...]
    ids: Tuple[str, ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def quarantine_entry(step: int, verdict: float, ids: Optional[List[str]] = None) -> QuarantineEntry:
    return QuarantineEntry(
        step=int(step),
        verdict=int(verdict),
        kinds=tuple(verdict_kinds(verdict)),
        ids=tuple(str(i) for i in (ids or ())),
    )
