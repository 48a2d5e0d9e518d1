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

from typing import NamedTuple, Optional

import torch

from repro_torch import Device, tree
from repro_torch.core.schedules import PowerLaw, paper_schedules
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
    beta: Optional[Params]     # β^t — EMA of ω (only consumed when λ > 0)


def init(params: Params, with_beta: bool = True) -> SSCAState:
    """``with_beta=False`` (λ = 0 objectives) skips the β buffer — saves one
    model-sized state tensor for large-scale LM training."""
    beta = tree.map(torch.zeros_like, params) if with_beta else None
    return SSCAState(step=1, lin=tree.map(torch.zeros_like, params),
                     beta=beta)


def promoted(x: torch.Tensor) -> torch.Tensor:
    """``x`` as JAX promotes it against an f32 array: a bf16 leaf to f32,
    an f32 one unchanged (no copy).  A torch bf16 tensor times a 0-d f32
    tensor stays bf16, so the updates below cast explicitly."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ema(old: Params, new: Params, rho) -> Params:
    return tree.map(lambda o, n: (1.0 - rho) * promoted(o)
                    + rho * promoted(n), old, new)


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
    ssca_update`: its ``lambda0`` variant at λ = 0, which reads no β);
    ``device`` is passed to its wrapper.  β advances only when λ > 0 and
    ``state.beta`` is not None, on both paths.  Without β (``init(params,
    with_beta=False)``) the fused update at λ > 0 runs on a zero β and
    discards β', as the reference's does; the unfused one raises, where
    the reference's fails.
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

    if hp.lam and state.beta is None:
        raise ValueError("the unfused update at lam > 0 needs the beta "
                         "state: init(params, with_beta=True)")
    lin = ema(state.lin,
              tree.map(lambda g, w: g - 2.0 * hp.tau * w, grad_agg, params),
              rho)
    beta = ema(state.beta, params, rho) if hp.lam else state.beta
    new_state = SSCAState(step=state.step + 1, lin=lin, beta=beta)

    omega_bar = solve_surrogate(new_state, hp)
    new_params = tree.map(lambda w, wb: (1.0 - gamma) * promoted(w)
                          + gamma * wb, params, omega_bar)
    return new_params, new_state


def surrogate_value(state: SSCAState, hp: SSCAHyperParams,
                    params: Params) -> torch.Tensor:
    """F̄0^t(ω) up to its constant term — used by tests/diagnostics."""
    val = tree.vdot(state.lin, params) + hp.tau * tree.sq_norm(params)
    if hp.lam:
        val = val + 2.0 * hp.lam * tree.vdot(state.beta, params)
    return val


def surrogate_grad(state: SSCAState, hp: SSCAHyperParams,
                   params: Params) -> Params:
    """∇F̄^t(ω) = lin^t + 2τω (+ 2λβ^t) — used to verify the Theorem-1
    consistency condition ‖∇F̄^t(ω^t) − ∇F(ω^t)‖ → 0 ([11, Lemma 1])."""
    g = tree.map(lambda b, w: b + 2.0 * hp.tau * w, state.lin, params)
    if hp.lam and state.beta is not None:
        g = tree.map(lambda gg, bt: gg + 2.0 * hp.lam * bt, g, state.beta)
    return g


def kkt_residual(grad: Params) -> torch.Tensor:
    """‖∇F0(ω)‖₂ — the unconstrained KKT (stationarity) residual."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grad)))


def default_hparams(batch_size: int, tau: float = 0.1,
                    lam: float = 0.0) -> SSCAHyperParams:
    rho, gamma = paper_schedules(batch_size)
    return SSCAHyperParams(tau=tau, lam=lam, rho=rho, gamma=gamma)
