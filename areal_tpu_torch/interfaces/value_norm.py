"""Running mean/std normalizers for critic value targets (port of
areal_tpu/interfaces/value_norm.py; host-side numpy, the port's own copy).

The critic head learns NORMALIZED returns; its predictions are
denormalized before GAE.  float64 accumulators with debiasing.  One
device: the moments live with the critic interface; `update_moments`
(batch moments from a sharded reduction) and the broadcast to
inference-only replicas come with multi-GPU.
"""

from typing import Dict, Optional

import numpy as np


class ExponentialRunningMeanStd:
    def __init__(self, beta: float = 0.99995, epsilon: float = 1e-5):
        self.beta = float(beta)
        self.eps = float(epsilon)
        self.reset()

    def reset(self):
        self._mean = 0.0
        self._mean_sq = 0.0
        self._debias = 0.0

    def update(self, x: np.ndarray, mask: Optional[np.ndarray] = None):
        x = np.asarray(x, np.float64)
        if mask is not None:
            mask = np.asarray(mask, np.float64)
            denom = mask.sum()
            if denom == 0:
                return
            bm = float((x * mask).sum() / denom)
            bmsq = float((np.square(x) * mask).sum() / denom)
        else:
            bm = float(x.mean())
            bmsq = float(np.square(x).mean())
        self._mean = self.beta * self._mean + (1.0 - self.beta) * bm
        self._mean_sq = self.beta * self._mean_sq + (1.0 - self.beta) * bmsq
        self._debias = self.beta * self._debias + (1.0 - self.beta)

    def mean_std(self):
        if self._debias == 0.0:
            return 0.0, 1.0
        m = self._mean / self._debias
        var = max(self._mean_sq / self._debias - m * m, 0.0)
        return m, float(np.sqrt(var + self.eps))

    def normalize(self, x: np.ndarray) -> np.ndarray:
        m, s = self.mean_std()
        return ((np.asarray(x, np.float64) - m) / s).astype(np.float32)

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        m, s = self.mean_std()
        return (np.asarray(x, np.float64) * s + m).astype(np.float32)

    def state_dict(self) -> Dict[str, float]:
        return {
            "mean": self._mean,
            "mean_sq": self._mean_sq,
            "debias": self._debias,
        }

    def load_state_dict(self, sd: Dict[str, float]):
        self._mean = float(sd["mean"])
        self._mean_sq = float(sd["mean_sq"])
        self._debias = float(sd["debias"])


class MovingAverageRunningMeanStd:
    """Unweighted all-history moments (value_norm_type="ma")."""

    def __init__(self, epsilon: float = 1e-5):
        self.eps = float(epsilon)
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._sum_sq = 0.0
        self._count = 0.0

    def update(self, x: np.ndarray, mask: Optional[np.ndarray] = None):
        x = np.asarray(x, np.float64)
        if mask is not None:
            mask = np.asarray(mask, np.float64)
            self._sum += float((x * mask).sum())
            self._sum_sq += float((np.square(x) * mask).sum())
            self._count += float(mask.sum())
        else:
            self._sum += float(x.sum())
            self._sum_sq += float(np.square(x).sum())
            self._count += float(x.size)

    def mean_std(self):
        if self._count == 0.0:
            return 0.0, 1.0
        m = self._sum / self._count
        var = max(self._sum_sq / self._count - m * m, 0.0)
        return m, float(np.sqrt(var + self.eps))

    normalize = ExponentialRunningMeanStd.normalize
    denormalize = ExponentialRunningMeanStd.denormalize

    def state_dict(self) -> Dict[str, float]:
        return {
            "sum": self._sum, "sum_sq": self._sum_sq, "count": self._count
        }

    def load_state_dict(self, sd: Dict[str, float]):
        self._sum = float(sd["sum"])
        self._sum_sq = float(sd["sum_sq"])
        self._count = float(sd["count"])


def make_value_norm(kind: str, beta: float, eps: float):
    if kind == "exp":
        return ExponentialRunningMeanStd(beta=beta, epsilon=eps)
    if kind == "ma":
        return MovingAverageRunningMeanStd(epsilon=eps)
    raise ValueError(f"unknown value_norm_type {kind!r}")
