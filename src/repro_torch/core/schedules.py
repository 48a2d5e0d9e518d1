"""Stepsize schedules for mini-batch SSCA (eqs. (3) and (5) of the paper).

The port of ``repro/core/schedules.py``.  The surrogate stepsize
``rho^t`` must satisfy (3):

    rho^t > 0,  rho^t -> 0,  sum_t rho^t = inf

and the iterate stepsize ``gamma^t`` must satisfy (5):

    gamma^t > 0,  gamma^t -> 0,  sum_t gamma^t = inf,
    sum_t (gamma^t)^2 < inf,  gamma^t / rho^t -> 0.

The paper's Section VI uses the power-law family

    rho^t   = a1 / t^alpha
    gamma^t = a2 / t^(alpha + 0.05)

with (a1, a2, alpha) = (0.4, 0.4, 0.4), (0.6, 0.9, 0.3), (0.9, 0.9, 0.3)
for batch sizes B = 1, 10, 100 respectively.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PowerLaw:
    """``a / t**alpha`` with ``t`` counted from 1, in float32 as in the
    reference.  Returns a 0-d f32 tensor on the CPU."""

    a: float
    alpha: float

    def __call__(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.tensor(self.a, dtype=torch.float32) \
            / torch.pow(t, torch.tensor(self.alpha, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class SSCASchedules:
    """A (rho, gamma) pair, with validity checks for (3)/(5)."""

    rho: PowerLaw
    gamma: PowerLaw

    def __post_init__(self):
        if not (self.rho.a > 0 and self.gamma.a > 0):
            raise ValueError("stepsizes must be positive")
        # (3): 0 < alpha_rho <= 1 gives rho->0 and sum rho = inf.
        if not (0.0 < self.rho.alpha <= 1.0):
            raise ValueError(f"rho alpha {self.rho.alpha} violates (3)")
        # (5): sum gamma = inf needs alpha_gamma <= 1; sum gamma^2 < inf
        # needs alpha_gamma > 0.5; gamma/rho -> 0 needs alpha_gamma > alpha_rho.
        if not (0.5 < self.gamma.alpha <= 1.0):
            raise ValueError(f"gamma alpha {self.gamma.alpha} violates (5)")
        if not (self.gamma.alpha > self.rho.alpha):
            raise ValueError("(5) requires gamma^t/rho^t -> 0, i.e. "
                             f"alpha_gamma > alpha_rho "
                             f"({self.gamma.alpha} <= {self.rho.alpha})")


# The paper's Section-VI tunings, keyed by batch size (empirical choices
# for T=100 rounds; the printed alphas do not satisfy every part of (5):
# ``strict_schedules`` enforces it for convergence experiments).
_PAPER_TABLE = {
    1: (0.4, 0.4, 0.4),
    10: (0.6, 0.9, 0.3),
    100: (0.9, 0.9, 0.3),
}


def paper_schedules(batch_size: int) -> "tuple[PowerLaw, PowerLaw]":
    """Exact Section-VI tunings (no (5)-validation: empirical, finite-T)."""
    if batch_size not in _PAPER_TABLE:
        # Interpolate sensibly for other batch sizes.
        a1, a2, alpha = _PAPER_TABLE[100] if batch_size > 10 else _PAPER_TABLE[10]
    else:
        a1, a2, alpha = _PAPER_TABLE[batch_size]
    return PowerLaw(a1, alpha), PowerLaw(a2, alpha + 0.05)


def strict_schedules(a1: float = 0.9, a2: float = 0.9,
                     alpha_rho: float = 0.45,
                     alpha_gamma: float = 0.55) -> SSCASchedules:
    """Schedules provably satisfying (3) and (5)."""
    return SSCASchedules(PowerLaw(a1, alpha_rho), PowerLaw(a2, alpha_gamma))


def sgd_learning_rate(a: float = 0.1, alpha: float = 0.5) -> PowerLaw:
    """``r = a / t^alpha`` used by the SGD baselines [3]-[5] (grid-searched)."""
    return PowerLaw(a, alpha)
