"""Stepsize schedules for mini-batch SSCA (eqs. (3) and (5) of the paper).

The port of ``repro/core/schedules.py``'s ``PowerLaw`` and
``paper_schedules``.  The paper's Section VI uses the power-law family

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


# The paper's Section-VI tunings, keyed by batch size (empirical choices
# for T=100 rounds; the printed alphas do not satisfy every part of (5)).
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
