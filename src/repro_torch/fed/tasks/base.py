"""The task contract the federated engine trains against.

The port of ``repro/fed/tasks/base.py``'s ``TaskData``, ``SumLoss``,
``LocalObjective`` and ``l2``.  A task supplies
``init_params(generator)``; ``loss_sum(params, (x, y, w))``, the
per-sample-weighted batch **sum** Σ_n w_n ℓ_n, whose gradient on the
eq.-(2)-weighted super-batch is ĝ^t and, with w = λ_i·1, one client's
secure upload; ``mean_loss(params, (x, y))``, the per-batch mean
objective FedAvg's local SGD descends; ``metric_names`` /
``measure(...)``; and ``default_data(...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree


class TaskData(NamedTuple):
    """Row-indexable dataset (numpy arrays) in the engine's gather layout."""
    x_train: Any
    y_train: Any
    x_test: Any
    y_test: Any


def l2(params) -> torch.Tensor:
    """‖params‖² over all leaves — the shared ridge regularizer."""
    return tree.sq_norm(params)


@dataclasses.dataclass(frozen=True)
class SumLoss:
    """The task's ``loss_sum`` as a value-comparable callable: two equal
    tasks give equal losses, so algorithm dataclasses built from them
    compare equal (a bound method compares its ``__self__`` by
    identity)."""
    task: Any

    def __call__(self, params, batch) -> torch.Tensor:
        return self.task.loss_sum(params, batch)


@dataclasses.dataclass(frozen=True)
class LocalObjective:
    """FedAvg's local objective: the task's mean loss + λ‖ω‖², as a
    value-comparable callable (equal ``(task, lam)`` pairs build equal
    losses)."""
    task: Any
    lam: float

    def __call__(self, params, batch) -> torch.Tensor:
        return self.task.mean_loss(params, batch) + self.lam * l2(params)
