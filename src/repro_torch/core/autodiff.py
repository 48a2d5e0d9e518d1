"""Gradients of a loss over a parameter tree, through ``vjp`` with
``create_graph=False``.

``torch.func.grad`` always builds the graph of its backward
(``create_graph=True``), which keeps every saved activation and every
backward intermediate alive to the end of the backward: at the LM's full
width, under the engine's ``vmap`` over clients, tens of GB.  A ``vjp``
whose pullback runs with ``create_graph=False`` frees them as it goes.
Both helpers compose with ``torch.func.vmap`` (the engine's per-client
uploads, FedAvg's local loop).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import vjp

from repro_torch import tree

Loss = Callable[[tree.Tree, Any], torch.Tensor]


def value_and_grad(fn: Loss, params: tree.Tree, batch):
    """(fn(params, batch), ∇_params fn(params, batch))."""
    val, pullback = vjp(lambda p: fn(p, batch), params)
    return val, pullback(torch.ones_like(val), retain_graph=False,
                         create_graph=False)[0]


def grad(fn: Loss, params: tree.Tree, batch) -> tree.Tree:
    """∇_params fn(params, batch)."""
    return value_and_grad(fn, params, batch)[1]
