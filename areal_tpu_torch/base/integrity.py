"""Anomaly verdict bits of the train step and the weight checksum (port
of the verdict and checksum parts of areal_tpu/base/integrity.py).

A train step's verdict is a small integer carried as a float through the
stats; each set bit names one anomaly.  The engine sets NONFINITE (its
always-on guard) and the tunable GRAD_SPIKE and UPDATE_NORM sentinels
(`engines/train.py`); the batch sentinels (`interfaces/ppo.py`) set
KL_BLOWUP, IMP_RATIO and DEGENERATE_VAR.  The bits keep the JAX
package's values, so verdicts read the same in both packages.
`record_anomaly` bumps `areal_train_anomaly_total{kind}` once per set
bit, as the JAX package does.

The weight checksum is a cheap per-leaf L2-norm vector (plus leaf and
element counts) stamped by the pusher and verified by the receiver
before a weight swap: a corrupted push is refused, not served.  Leaves
are taken in sorted-key order, as `jax.tree.leaves` orders a dict, so a
checksum taken on the JAX package's tree verifies against the port's.

A quarantined step goes into the master's ledger as a `QuarantineEntry`
(step, verdict, its kinds, the step's data ids)."""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import metrics

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

def verdict_kinds(verdict: float) -> List[str]:
    """Decode a packed verdict scalar into its anomaly kind names."""
    v = int(verdict)
    return [name for bit, name in _KIND_BITS if v & bit]


def record_anomaly(verdict: float) -> None:
    """Bump `areal_train_anomaly_total{kind=...}` once per set bit."""
    for kind in verdict_kinds(verdict):
        M_ANOMALY.labels(kind).inc()


# ---------------- weight checksum ----------------


class WeightChecksumError(RuntimeError):
    """A pushed params tree failed its content checksum."""


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# A tensor leaf is reduced a chunk at a time: no float64 copy of a whole
# leaf.
_NORM_CHUNK = 1 << 24


def _tensor_norm(x: torch.Tensor, device=None) -> torch.Tensor:
    """A tensor leaf's L2 norm, its squares summed in float64, as a
    scalar on `device` (default: the leaf's), to which the leaf streams
    a chunk at a time."""
    flat = x.detach().reshape(-1)
    device = flat.device if device is None else torch.device(device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for i in range(0, flat.numel(), _NORM_CHUNK):
        c = flat[i:i + _NORM_CHUNK].to(device).double()
        total += torch.dot(c, c)
    return total.sqrt()


def params_checksum(tree: Any, device=None) -> np.ndarray:
    """Content fingerprint of a params tree (nested dicts of torch
    tensors on one device, or of numpy arrays): float64 ``[n_leaves,
    total_elements, leaf_l2_norms...]``.  Tensor leaves are reduced where
    they lie, their squares summed in float64, and fetched with one
    transfer: the card's and the host's norms of one leaf agree to
    ~1e-12 at any size.  Numpy leaves are reduced on the host as the JAX
    package reduces them (float32, bit for bit), which drifts past
    CHECKSUM_RTOL from the exact norm for a leaf of 64M elements and
    more (ROADMAP queue 3): a host tree is verified against a host
    tree's checksum.  With `device`, tensor leaves are reduced there (a
    receiver's host leaves on its card, a chunk in memory at a time)."""
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
        norms = torch.stack([_tensor_norm(x, device) for x in leaves]).cpu().tolist()
    return np.asarray(head + norms, np.float64)


M_ANOMALY = metrics.default_registry().counter(
    "areal_train_anomaly_total",
    "train-step anomaly sentinel trips, by kind",
    ("kind",),
)
M_PUSH_REJECTED = metrics.default_registry().counter(
    "areal_gen_weight_push_rejected_total",
    "weight pushes rejected by the receiver's content checksum",
)

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


def verify_checksum(tree: Any, expected: np.ndarray, device=None) -> None:
    """Raise WeightChecksumError (and count it in
    ``areal_gen_weight_push_rejected_total``) unless `tree` matches
    `expected` (its tensor leaves reduced on `device` when given)."""
    got = params_checksum(tree, device)
    if not checksum_matches(got, np.asarray(expected, np.float64)):
        M_PUSH_REJECTED.inc()
        raise WeightChecksumError(
            "weight push rejected: params checksum mismatch "
            f"(expected {np.asarray(expected)[:4]}..., got {got[:4]}...); "
            "the payload was corrupted in flight — retry the push"
        )


def corrupt_params(tree: Any) -> Any:
    """The ``corrupt_push`` fault's payload corruption: a copy of the
    tree (nested dicts of torch tensors on any device, or of numpy
    arrays) whose first floating leaf, in sorted-key order, is x * 1.5 +
    1.0 in its own dtype.  The caller's leaves stay as they were."""

    def floating(x):
        if torch.is_tensor(x):
            return x.is_floating_point()
        return isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating)

    def first(t, path=()):
        if not isinstance(t, dict):
            return path if floating(t) else None
        for k in sorted(t):
            found = first(t[k], path + (k,))
            if found is not None:
                return found
        return None

    def replace(t, path):
        if not path:
            return (t.detach() if torch.is_tensor(t) else t) * 1.5 + 1.0
        return {k: replace(v, path[1:]) if k == path[0] else v for k, v in t.items()}

    path = first(tree)
    return tree if path is None else replace(tree, path)


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
