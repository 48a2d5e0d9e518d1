"""The paper's Section-V application model.

A three-layer network for L-class classification (eq. (10)):

    input  K cells →  hidden J cells, swish S(z) = z·sigmoid(z) [13]
                   →  output L cells, softmax

with cross-entropy cost (9) and parameters ω = (ω1 ∈ R^{J×K},
ω2 ∈ R^{L×J}), kept in the reference's layout.  The port of
``repro/mlpapp/model.py``: the functional forms work on a ``{"w1", "w2"}``
tensor dict (what the federated engine carries and differentiates with
``torch.func``); :class:`MLP` wraps the same weights as an ``nn.Module``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device, tree

Params = Dict[str, torch.Tensor]


def init_params(generator: torch.Generator, k: int, j: int, l: int,
                scale: float = 0.05) -> Params:
    """Gaussian init drawn from ``generator`` (a CPU generator, so a seed
    gives the same weights whatever device they move to).  The reference
    draws with ``jax.random.normal``, which the port does not reproduce:
    to start both from one point, carry weights with
    :func:`params_from_numpy`."""
    return {"w1": scale * torch.randn(j, k, generator=generator),
            "w2": scale * torch.randn(l, j, generator=generator)}


def params_from_numpy(arrays: Sequence[np.ndarray],
                      device: Device = None) -> Params:
    """(w1, w2) arrays — e.g. the reference's ``MLPParams`` — → the port's
    f32 parameter dict on ``device``."""
    w1, w2 = arrays
    dev = resolve_device(device)
    return {"w1": torch.tensor(np.asarray(w1, np.float32), device=dev),
            "w2": torch.tensor(np.asarray(w2, np.float32), device=dev)}


def params_to_numpy(params: Params) -> tuple:
    """The port's parameter dict → (w1, w2) numpy arrays, the field order
    of the reference's ``MLPParams``."""
    return tuple(params[k].detach().cpu().numpy() for k in ("w1", "w2"))


def swish(z):
    """S(z) = z / (1 + exp(−z))."""
    return z * torch.sigmoid(z)


def swish_prime(z):
    """S'(z) = σ(z)(1 + z(1 − σ(z))) — used by the explicit recursions."""
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def hidden(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Pre-activation of the hidden layer: x @ ω1ᵀ, shape (..., J)."""
    return x @ params["w1"].T


def logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return swish(hidden(params, x)) @ params["w2"].T


def predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Q_l(ω, x) of eq. (10): softmax class probabilities."""
    return torch.softmax(logits(params, x), dim=-1)


def cross_entropy(params: Params, batch) -> torch.Tensor:
    """F(ω) of eq. (9) over a batch: −mean_n Σ_l y_{n,l} log Q_l."""
    x, y = batch
    logp = torch.log_softmax(logits(params, x), dim=-1)
    return -torch.mean(torch.sum(y * logp, dim=-1))


def cross_entropy_sum(params: Params, batch) -> torch.Tensor:
    """Σ_n Σ_l −y log Q — un-normalized, for explicit client weights."""
    x, y = batch
    logp = torch.log_softmax(logits(params, x), dim=-1)
    return -torch.sum(y * logp)


def l2_objective(lam: float):
    """F0(ω) = F(ω) + λ‖ω‖² of eq. (11)."""
    def loss(params: Params, batch):
        return cross_entropy(params, batch) + lam * sparsity(params)
    return loss


def accuracy(params: Params, x: torch.Tensor, y_onehot: torch.Tensor):
    pred = torch.argmax(logits(params, x), dim=-1)
    return torch.mean((pred == torch.argmax(y_onehot, dim=-1)).float())


def sparsity(params: Params) -> torch.Tensor:
    """‖ω‖² — the paper's Fig.-3 'model sparsity' proxy."""
    return tree.sq_norm(params)


class MLP(nn.Module):
    """The same network as an ``nn.Module``: ``w1`` (J, K), ``w2`` (L, J)."""

    def __init__(self, params: Params):
        super().__init__()
        self.w1 = nn.Parameter(params["w1"].detach().clone())
        self.w2 = nn.Parameter(params["w2"].detach().clone())

    def params(self) -> Params:
        return {"w1": self.w1, "w2": self.w2}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logits(self.params(), x)
