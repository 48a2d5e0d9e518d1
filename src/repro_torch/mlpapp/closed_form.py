"""Explicit Section-V recursions — the paper's closed forms, verbatim.

The port of ``repro/mlpapp/closed_form.py``.  These duplicate what
autodiff + :mod:`repro_torch.core.ssca` / :mod:`repro_torch.core.
constrained` compute, on purpose: the paper derives B̄_{j,k}, C̄_{l,j}, Ā
explicitly (the text below each equation), and tests assert that the
explicit forms agree with autodiff to numerical precision, validating
both the derivation and the generic core.

Conventions: batches carry per-sample aggregation weights ``w_n`` so that
Σ_n w_n (...) equals Σ_i (N_i/BN) Σ_{n∈N_i^t} (...) of eqs. (14)/(15)/(20).
Parameters are the ``{"w1", "w2"}`` dict of :mod:`repro_torch.mlpapp.model`.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.mlpapp.model import (Params, hidden, predict, sparsity,
                                      swish, swish_prime)


def bbar_cbar(params: Params, x, y, wn):
    """B̄^t_{j,k} and C̄^t_{l,j} — the explicit mini-batch gradient sums.

    x: (B, K), y: (B, L) one-hot, wn: (B,) aggregation weights.
    Returns (B̄ ∈ (J,K), C̄ ∈ (L,J)).
    """
    z = hidden(params, x)              # (B, J) pre-activations
    delta = predict(params, x) - y     # (B, L)
    # B̄_{j,k} = Σ_n w_n Σ_l δ_{n,l} S'(z_{n,j}) ω2_{l,j} x_{n,k}
    dj = (delta @ params["w2"]) * swish_prime(z)        # (B, J)
    bbar = torch.einsum('b,bj,bk->jk', wn, dj, x)
    # C̄_{l,j} = Σ_n w_n δ_{n,l} S(z_{n,j})
    cbar = torch.einsum('b,bl,bj->lj', wn, delta, swish(z))
    return bbar, cbar


def abar(params: Params, x, y, wn, tau: float):
    """Ā^t of eq. (20)'s text: the mini-batch cost value plus τ‖ω‖².

    The paper's printed (20) reads ``Σ y log Q + τ‖ω‖²``; since
    F = −(1/N)ΣΣ y log Q, the mini-batch *cost estimate* is
    −Σ_n w_n Σ_l y log Q, so Ā = F̂_batch + τ‖ω‖² (with the printed sign
    the surrogate would track −F and the constraint F̄ ≤ s would be
    vacuous).
    """
    q = predict(params, x)
    fhat = -torch.einsum('b,bl->', wn,
                         y * torch.log(torch.clamp_min(q, 1e-30)))
    return fhat + tau * sparsity(params)


def alg1_update(state, params: Params, x, y, wn, *, rho, gamma,
                tau: float, lam: float):
    """One full Algorithm-1 round via eqs. (13)–(17), no autodiff.

    ``state`` is a dict with keys B (J,K), C (L,J), beta (params).
    Returns (new_params, new_state).
    """
    bbar, cbar = bbar_cbar(params, x, y, wn)
    B = (1 - rho) * state["B"] + rho * (bbar - 2 * tau * params["w1"])  # (14)
    C = (1 - rho) * state["C"] + rho * (cbar - 2 * tau * params["w2"])  # (15)
    beta = tree.map(lambda b, w: (1 - rho) * b + rho * w,
                    state["beta"], params)                             # (13)
    w1_bar = -(B + 2 * lam * beta["w1"]) / (2 * tau)                   # (16)
    w2_bar = -(C + 2 * lam * beta["w2"]) / (2 * tau)                   # (17)
    new_params = {"w1": (1 - gamma) * params["w1"] + gamma * w1_bar,   # (4)
                  "w2": (1 - gamma) * params["w2"] + gamma * w2_bar}
    return new_params, {"B": B, "C": C, "beta": beta}


def alg2_update(state, params: Params, x, y, wn, *, rho, gamma,
                tau: float, c: float, limit_u: float):
    """One full Algorithm-2 round via eqs. (13)–(15), (20)–(23), no autodiff.

    ``state``: dict with B, C, A (scalar).  Objective ‖ω‖², constraint
    F(ω) ≤ U (eq. (18)).
    """
    bbar, cbar = bbar_cbar(params, x, y, wn)
    B = (1 - rho) * state["B"] + rho * (bbar - 2 * tau * params["w1"])
    C = (1 - rho) * state["C"] + rho * (cbar - 2 * tau * params["w2"])
    a_bar = abar(params, x, y, wn, tau)
    # (20): A = EMA( Ā − Σ B̄ ω1 − Σ C̄ ω2 )
    a_inner = (a_bar - torch.sum(bbar * params["w1"])
               - torch.sum(cbar * params["w2"]))
    A = (1 - rho) * state["A"] + rho * a_inner
    # (23)
    b = torch.sum(B * B) + torch.sum(C * C)
    disc = b + 4 * tau * (limit_u - A)
    nu_int = (torch.sqrt(b / torch.clamp_min(disc, 1e-30)) - 1.0) / tau
    nu = torch.where(disc > 0, torch.clamp(nu_int, 0.0, c),
                     torch.full_like(nu_int, c))
    # (21)/(22)
    w1_bar = -nu * B / (2 * (1 + nu * tau))
    w2_bar = -nu * C / (2 * (1 + nu * tau))
    new_params = {"w1": (1 - gamma) * params["w1"] + gamma * w1_bar,
                  "w2": (1 - gamma) * params["w2"] + gamma * w2_bar}
    return new_params, {"B": B, "C": C, "A": A}


def init_alg1_state(params: Params):
    return {"B": torch.zeros_like(params["w1"]),
            "C": torch.zeros_like(params["w2"]),
            "beta": tree.map(torch.zeros_like, params)}


def init_alg2_state(params: Params):
    return {"B": torch.zeros_like(params["w1"]),
            "C": torch.zeros_like(params["w2"]),
            "A": torch.zeros((), dtype=torch.float32,
                             device=params["w1"].device)}
