"""KL-coefficient controllers for the PPO reward penalty (a copy of
areal_tpu/interfaces/kl.py).  The adaptive rule is the Ziegler et al.
(arXiv:1909.08593) proportional controller: after each train step, nudge
the coefficient toward holding the measured policy-reference KL at
`target`:

    err   = clip(observed_kl / target - 1, -0.2, 0.2)
    value *= 1 + err * n_steps / horizon

Host-side control flow, one scalar update per train step.  The value is
algorithm state and rides the owning interface's state_dict.
"""

import dataclasses


@dataclasses.dataclass
class FixedKLController:
    value: float = 0.0

    def update(self, observed_kl: float, n_steps: int) -> None:
        pass

    def state_dict(self):
        return {"value": float(self.value)}

    def load_state_dict(self, sd) -> None:
        if sd:
            self.value = float(sd["value"])


@dataclasses.dataclass
class AdaptiveKLController(FixedKLController):
    target: float = 6.0
    horizon: float = 10000.0

    def update(self, observed_kl: float, n_steps: int) -> None:
        err = min(max(observed_kl / self.target - 1.0, -0.2), 0.2)
        self.value *= 1.0 + err * n_steps / self.horizon


def make_kl_controller(
    init: float, adaptive: bool, target: float, horizon: float
):
    if adaptive:
        return AdaptiveKLController(
            value=init, target=target, horizon=horizon
        )
    return FixedKLController(value=init)
