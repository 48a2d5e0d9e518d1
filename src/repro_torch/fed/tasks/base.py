"""The task contract the federated engine trains against.

The port of ``repro/fed/tasks/base.py``'s ``TaskData`` and ``SumLoss``.
A task supplies ``init_params(generator)``, ``loss_sum(params, (x, y,
w))`` — the per-sample-weighted batch **sum** Σ_n w_n ℓ_n, whose gradient
on the eq.-(2)-weighted super-batch is ĝ^t and, with w = λ_i·1, one
client's secure upload — ``metric_names`` / ``measure(...)`` and
``default_data(...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


class TaskData(NamedTuple):
    """Row-indexable dataset (numpy arrays) in the engine's gather layout."""
    x_train: Any
    y_train: Any
    x_test: Any
    y_test: Any


@dataclasses.dataclass(frozen=True)
class SumLoss:
    """The task's ``loss_sum`` as a value-comparable callable: two equal
    tasks give equal losses, so algorithm dataclasses built from them
    compare equal (a bound method compares its ``__self__`` by
    identity)."""
    task: Any

    def __call__(self, params, batch) -> torch.Tensor:
        return self.task.loss_sum(params, batch)
