"""Federated algorithms behind one interface.

The port of ``repro/core/protocol.py``'s ``SSCAUnconstrained`` and the
``_Base`` defaults it needs.  An algorithm is the triple

    init_state(params)                  -> state            (server side)
    client_upload(params, state, batch) -> message          (per client)
    server_step(params, state, agg)     -> (params, state)  (server side)

where ``agg`` is the aggregated client message.  Sum-combine uploads are
additive in the batch, so a linear aggregation can evaluate the aggregate
on the weighted super-batch directly (see :mod:`repro_torch.fed.engine`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.func import vjp

from repro_torch import Device, tree
from repro_torch.core import ssca


class UploadSpec(NamedTuple):
    """Wire metadata of one client upload: how many elements the message
    carries, across how many leaves, at what element width."""
    elements: int
    leaves: int
    elem_bytes: int


class _Base:
    """Shared defaults: sum-combine with eq.-(2) weights, a dense float32
    model-shaped upload."""

    combine = "sum"
    upload_dtype = torch.float32

    def client_weights(self, part, batch_size: int) -> np.ndarray:
        return part.weights(batch_size)            # N_i / (B·N)

    def upload_spec(self, params) -> UploadSpec:
        return UploadSpec(
            elements=tree.numel(params),
            leaves=len(tree.leaves(params)),
            elem_bytes=self.upload_dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class SSCAUnconstrained(_Base):
    """Algorithm 1 (mini-batch SSCA, unconstrained).

    ``loss_fn(params, (x, y, w))`` is the per-sample-weighted batch sum
    Σ_n w_n ℓ_n, so its gradient on the weighted super-batch is ĝ^t of
    eq. (2), and the per-client gradient (w = λ_i) is the secure upload.
    ``fused=True`` runs the server update through the fused kernel.
    """
    loss_fn: Callable[[Any, Any], torch.Tensor]
    hp: ssca.SSCAHyperParams
    fused: bool = False

    def init_state(self, params):
        return ssca.init(params)

    def client_upload(self, params, state, batch):
        """∇ loss_fn at ``params``: ``grad``'s value, through ``vjp`` with
        ``create_graph=False``.  ``torch.func.grad`` always builds the
        graph of its backward (``create_graph=True``), which keeps every
        saved activation and every backward intermediate alive to the
        end of the backward: at the LM's full width, under the engine's
        ``vmap`` over clients, tens of GB."""
        del state
        loss, pullback = vjp(lambda p: self.loss_fn(p, batch), params)
        return pullback(torch.ones_like(loss), retain_graph=False,
                        create_graph=False)[0]

    def server_step(self, params, state, agg, *, device: Device = None):
        return ssca.server_update(state, params, agg, self.hp,
                                  fused=self.fused, device=device)
