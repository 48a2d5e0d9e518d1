"""Algorithm 2 — mini-batch SSCA for constrained federated optimization.

The port of ``repro/core/constrained.py``: the paper's Section IV, the
exact-penalty transformed Problem 4, the per-round convex approximate
Problem 5, and two solvers for it:

1. ``solve_lemma1`` — the paper's closed form (Lemma 1, eqs. (21)–(23)) for
   the Section V-B instance:  min ‖ω‖² + c·s  s.t. ⟨B, ω⟩ + τ‖ω‖² + A − U ≤ s,
   s ≥ 0, where B stacks the (B_{j,k}, C_{l,j}) coefficients.
2. ``solve_dual`` — a generic projected-dual-ascent solver for M ≥ 1
   quadratic constraint surrogates sharing the Hessian 2τI with a quadratic
   objective surrogate; every inner minimization is closed form, the dual is
   concave, and the multipliers live in [0, c]^M (the exact-penalty box).

Surrogate recursions: the objective uses ``lin0`` exactly as Algorithm 1;
each constraint m keeps a linear coefficient ``lin_m`` (eq. (7) ⇒ (14)-like)
and a *constant* scalar ``A_m`` (eq. (20) generalized):

    A_m^t = (1 − ρ^t) A_m^{t−1} + ρ^t ( f_m(ω^t) − ⟨ĝ_m^t, ω^t⟩ + τ‖ω^t‖² )

so that  F̄_m^t(ω) = ⟨lin_m^t, ω⟩ + τ‖ω‖² + A_m^t.  Everything is f32, as
in the reference; parameters and state are trees of tensors
(:mod:`repro_torch.tree`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch import tree
from repro_torch.core import autodiff, ssca
from repro_torch.core.schedules import PowerLaw

Params = tree.Tree


class ConstrainedHyperParams(NamedTuple):
    tau: float = 0.1
    c: float = 1e5              # exact-penalty weight (paper uses 1e5)
    rho: PowerLaw = PowerLaw(0.9, 0.3)
    gamma: PowerLaw = PowerLaw(0.9, 0.35)


class ConstrainedState(NamedTuple):
    step: int                # t, starts at 1
    lin_c: Params            # linear coefficients of the constraint
                             # surrogate(s): a tree like params with a
                             # leading axis of size M on every leaf
    a_c: torch.Tensor        # (M,) constant terms A_m^t
    slack: torch.Tensor      # (M,) last solved slack s^t


def init(params: Params, num_constraints: int = 1) -> ConstrainedState:
    lin = tree.map(lambda w: w.new_zeros((num_constraints,) + w.shape),
                   params)
    dev = tree.leaves(params)[0].device
    zeros = torch.zeros(num_constraints, dtype=torch.float32, device=dev)
    return ConstrainedState(step=1, lin_c=lin, a_c=zeros,
                            slack=zeros.clone())


def _stacked_dots(stacked: Params, w: Params, m: int) -> torch.Tensor:
    """(M,) ⟨stacked[m], w⟩ for every m."""
    return torch.stack([
        sum(torch.sum(g[i] * ww) for g, ww in
            zip(tree.leaves(stacked), tree.leaves(w)))
        for i in range(m)])


def update_constraint_surrogate(
        state: ConstrainedState, params: Params,
        cons_vals: torch.Tensor,     # (M,) aggregated batch values f_m(ω^t)
        cons_grads: Params,          # like lin_c: stacked ĝ_m^t
        tau: float, rho) -> ConstrainedState:
    """Recursions (7)/(14)/(20) for every constraint m."""
    lin_new = tree.map(lambda g, w: g - 2.0 * tau * w[None], cons_grads,
                       params)
    lin_c = ssca.ema(state.lin_c, lin_new, rho)
    # Ā_m = f_m(ω) − ⟨ĝ_m, ω⟩ + τ‖ω‖²   (constant term of surrogate (8))
    g_dot_w = _stacked_dots(cons_grads, params, cons_vals.shape[0])
    a_bar = cons_vals - g_dot_w + tau * tree.sq_norm(params)
    a_c = (1.0 - rho) * state.a_c + rho * a_bar
    return state._replace(lin_c=lin_c, a_c=a_c)


# ---------------------------------------------------------------------------
# Lemma 1 closed form (Section V-B: objective ‖ω‖², single constraint)
# ---------------------------------------------------------------------------

def solve_lemma1(lin_c: Params, a_t, limit_u, tau: float, c: float):
    """Closed-form (ω̄, s, ν) of problem (19) per Lemma 1 / eqs. (21)–(23).

    ``lin_c`` here is the *single* constraint's linear coefficient tree
    (no leading M axis).  Returns the minimizer, the implied slack and the
    multiplier ν.  ``disc ≤ 0`` takes ν = c; the interior formula's
    ``max(disc, 1e-30)`` then only keeps the discarded branch finite or
    infinite, never NaN.
    """
    b = tree.sq_norm(lin_c)  # eq. (23): Σ B² + Σ C²
    disc = b + 4.0 * tau * (limit_u - a_t)
    nu_interior = (torch.sqrt(b / torch.clamp_min(disc, 1e-30)) - 1.0) / tau
    nu = torch.where(disc > 0.0, torch.clamp(nu_interior, 0.0, c),
                     torch.full_like(nu_interior, c))
    omega_bar = tree.map(lambda bb: -nu * bb / (2.0 * (1.0 + nu * tau)),
                         lin_c)
    # slack = [F̄(ω̄) + A − U]_+  (complementarity: s = max(0, violation))
    fbar = (tree.vdot(lin_c, omega_bar) + tau * tree.sq_norm(omega_bar)
            + a_t - limit_u)
    s = torch.clamp_min(fbar, 0.0)
    return omega_bar, s, nu


# ---------------------------------------------------------------------------
# Generic dual solver for Problem 5 with quadratic surrogates
# ---------------------------------------------------------------------------

def solve_dual(lin0: Params, beta: Params, lam_obj: float,
               obj_quad: float,
               lin_c: Params, a_c: torch.Tensor, tau: float,
               c: float, iters: int = 50, lr: float = 0.5):
    """Projected dual ascent on ν ∈ [0, c]^M for Problem 5.

    Primal:  min_ω  ⟨lin0 + 2λβ, ω⟩ + obj_quad·‖ω‖²  + c Σ s_m
             s.t.   ⟨lin_m, ω⟩ + τ‖ω‖² + A_m ≤ s_m,  s_m ≥ 0.

    With multiplier ν_m ∈ [0, c] (the s_m subproblem caps ν at c), the inner
    minimizer is closed form:

        ω(ν) = −(lin0 + 2λβ + Σ_m ν_m lin_m) / (2 (obj_quad + τ Σ_m ν_m))

    and the dual function's gradient is the constraint violation at ω(ν).
    ``iters`` ascent steps from ν = c/2, step i of size lr/√(1+i).
    """
    m = a_c.shape[0]
    base = tree.map(lambda l, bt: l + 2.0 * lam_obj * bt, lin0, beta) \
        if lam_obj else lin0

    def omega_of(nu):
        denom = 2.0 * (obj_quad + tau * torch.sum(nu))
        return tree.map(
            lambda b0, bc: -(b0 + torch.tensordot(nu, bc, dims=1)) / denom,
            base, lin_c)

    def violation(nu):
        w = omega_of(nu)
        return _stacked_dots(lin_c, w, m) + tau * tree.sq_norm(w) + a_c

    nu = torch.full((m,), 0.5 * c, dtype=torch.float32, device=a_c.device)
    for i in range(iters):
        step = lr / torch.sqrt(torch.tensor(1.0 + i, dtype=torch.float32))
        nu = torch.clamp(nu + step * violation(nu), 0.0, c)
    w = omega_of(nu)
    s = torch.clamp_min(violation(nu), 0.0)
    return w, s, nu


# ---------------------------------------------------------------------------
# Full Algorithm 2 round (Section V-B instance, generic model)
# ---------------------------------------------------------------------------

def round_fn(cost_fn: Callable[[Params, Any], torch.Tensor],
             limit_u: float, hp: ConstrainedHyperParams,
             aggregate=None):
    """One Algorithm-2 round for  min ‖ω‖²  s.t.  cost(ω) ≤ U   (eq. (18)).

    ``cost_fn(params, batch)`` is the mini-batch estimate of F(ω); its value
    and gradient form the client upload ``q1`` (q0 needs no upload here —
    the objective ‖ω‖² is known to the server).
    """
    def one_round(params, state: ConstrainedState, batch, weight=1.0):
        val, grad = autodiff.value_and_grad(cost_fn, params, batch)
        val = val * weight
        grad = tree.map(lambda g: g * weight, grad)
        if aggregate is not None:
            val, grad = aggregate((val, grad))
        return server_update(state, params, val, grad, limit_u, hp)

    return one_round


def server_update(state: ConstrainedState, params: Params, val, grad,
                  limit_u: float, hp: ConstrainedHyperParams):
    """The server's half of a round from the aggregated (value, gradient)
    q1: the surrogate recursions, Lemma 1 and move (4).  Returns
    (params', state')."""
    rho, gamma = hp.rho(state.step), hp.gamma(state.step)
    grads = tree.map(lambda g: g[None], grad)              # stack M=1
    # A^t tracks the constant of F's surrogate; U is subtracted at solve
    # time, exactly like the paper's (19) which uses "A^t − U".
    state = update_constraint_surrogate(
        state, params, torch.reshape(val, (1,)), grads, hp.tau, rho)
    lin1 = tree.map(lambda l: l[0], state.lin_c)
    omega_bar, s, _ = solve_lemma1(lin1, state.a_c[0], limit_u, hp.tau,
                                   hp.c)
    new_params = tree.map(lambda w, wb: (1.0 - gamma) * w + gamma * wb,
                          params, omega_bar)
    return new_params, state._replace(step=state.step + 1, slack=s[None])


def penalty_continuation(c_schedule: Sequence[float]):
    """The practical c_j ↑ ∞ loop after Theorem 2: repeat Algorithm 2 with
    increasing penalty until ‖s*‖ is small.  Returns the c sequence used."""
    cs = list(c_schedule)
    if any(c2 <= c1 for c1, c2 in zip(cs, cs[1:])):
        raise ValueError("Theorem 2 requires 0 < c_j < c_{j+1}")
    return cs
