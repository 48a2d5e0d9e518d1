"""Algorithm 1 — mini-batch SSCA for unconstrained federated optimization.

The port of ``repro/core/ssca.py``.  Under the canonical surrogate (6)
the recursively averaged surrogate is the quadratic
⟨lin^t, ω⟩ + τ‖ω‖² (+ 2λ⟨β^t, ω⟩ for the ℓ2-regularized objective), with

    lin^t  = (1 − ρ^t) lin^{t−1} + ρ^t (ĝ^t − 2τ ω^t)          # (14)/(15)
    β^t    = (1 − ρ^t) β^{t−1}  + ρ^t ω^t                       # (13)

closed-form minimizer (16)/(17)  ω̄^t = −(lin^t + 2λ β^t) / (2τ), and
iterate move (4)  ω^{t+1} = (1 − γ^t) ω^t + γ^t ω̄^t.  Parameters and
state are trees of tensors (:mod:`repro_torch.tree`) shaped like the
params.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import Device, tree
from repro_torch.core.schedules import PowerLaw
from repro_torch.kernels import ops

Params = tree.Tree


class SSCAHyperParams(NamedTuple):
    tau: float = 0.1          # strong-convexity constant of (6)
    lam: float = 0.0          # ℓ2 regularization weight λ (eq. 11)
    rho: PowerLaw = PowerLaw(0.9, 0.3)
    gamma: PowerLaw = PowerLaw(0.9, 0.35)


class SSCAState(NamedTuple):
    """Server-side surrogate state."""

    step: int                  # t, starts at 1
    lin: Params                # lin^t — EMA of (ĝ − 2τω)
    beta: Params               # β^t — EMA of ω (only consumed when λ > 0)


def init(params: Params) -> SSCAState:
    return SSCAState(step=1,
                     lin=tree.map(torch.zeros_like, params),
                     beta=tree.map(torch.zeros_like, params))


def ema(old: Params, new: Params, rho) -> Params:
    return tree.map(lambda o, n: (1.0 - rho) * o + rho * n, old, new)


def solve_surrogate(state: SSCAState, hp: SSCAHyperParams) -> Params:
    """Closed-form minimizer of Problem 2 under surrogate (6): (16)/(17)."""
    two_tau = 2.0 * hp.tau
    if hp.lam:
        return tree.map(lambda b, be: -(b + 2.0 * hp.lam * be) / two_tau,
                        state.lin, state.beta)
    return tree.map(lambda b: -b / two_tau, state.lin)


def server_update(state: SSCAState, params: Params, grad_agg: Params,
                  hp: SSCAHyperParams, *, fused: bool = False,
                  device: Device = None) -> tuple[Params, SSCAState]:
    """One server round: recursions (14)/(15), closed form (16)/(17), move (4).

    ``grad_agg`` is the aggregated ĝ^t.  ``fused=True`` runs the whole
    update as one launch of the fused kernel (:mod:`repro_torch.kernels.
    ssca_update`); ``device`` is passed to its wrapper.  β advances only
    when λ > 0, on both paths.
    """
    rho = hp.rho(state.step)
    gamma = hp.gamma(state.step)

    if fused:
        new_params, lin, beta = ops.ssca_update(
            params, state.lin, grad_agg, state.beta, rho=rho, gamma=gamma,
            tau=hp.tau, lam=hp.lam, device=device)
        new_state = SSCAState(step=state.step + 1, lin=lin,
                              beta=beta if hp.lam else state.beta)
        return new_params, new_state

    lin = ema(state.lin,
              tree.map(lambda g, w: g - 2.0 * hp.tau * w, grad_agg, params),
              rho)
    beta = ema(state.beta, params, rho) if hp.lam else state.beta
    new_state = SSCAState(step=state.step + 1, lin=lin, beta=beta)

    omega_bar = solve_surrogate(new_state, hp)
    new_params = tree.map(lambda w, wb: (1.0 - gamma) * w + gamma * wb,
                          params, omega_bar)
    return new_params, new_state
