"""SGD and momentum as (init, update) pairs.

The port of ``repro/optim/optimizers.py``'s ``sgd`` and ``momentum``,
the pairs FedAvg's local loop uses (:func:`repro_torch.core.fedavg.
local_sgd`).  ``update(grads, state, params) -> (new_params,
new_state)``; the learning rate is a callable of the (1-based) step, so
the baselines can use the paper's decaying ``r = ā/t^ᾱ`` schedules
directly.  Both are purely functional (no tensor is updated in place),
so they run under ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree

Schedule = Callable[[Any], torch.Tensor]


class SGDState(NamedTuple):
    step: int


class MomentumState(NamedTuple):
    step: int
    velocity: tree.Tree


def sgd(lr: Schedule):
    def init(params):
        del params
        return SGDState(step=1)

    def update(grads, state, params):
        r = lr(state.step)
        new = tree.map(lambda w, g: w - r * g, params, grads)
        return new, SGDState(step=state.step + 1)

    return init, update


def momentum(lr: Schedule, beta: float = 0.9, nesterov: bool = False):
    def init(params):
        return MomentumState(step=1,
                             velocity=tree.map(torch.zeros_like, params))

    def update(grads, state, params):
        r = lr(state.step)
        vel = tree.map(lambda v, g: beta * v + g, state.velocity, grads)
        step_dir = tree.map(lambda v, g: beta * v + g, vel, grads) \
            if nesterov else vel
        new = tree.map(lambda w, d: w - r * d, params, step_dir)
        return new, MomentumState(step=state.step + 1, velocity=vel)

    return init, update
