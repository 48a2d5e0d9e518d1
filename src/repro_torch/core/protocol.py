"""Federated algorithms behind one interface.

The port of ``repro/core/protocol.py``: Algorithm 1
(:class:`SSCAUnconstrained`), Algorithm 2 (:class:`SSCAConstrained`) and
the baselines :class:`FedSGD` and :class:`FedAvg`.  An algorithm is the
triple

    init_state(params)                  -> state            (server side)
    client_upload(params, state, batch) -> message          (per client)
    server_step(params, state, agg)     -> (params, state)  (server side)

where ``agg`` is the aggregated client message.  Aggregation semantics are
declared by ``combine``:

* ``"sum"`` — the upload is a per-sample-weighted statistic (the
  mini-batch gradient of Σ_n w_n ℓ_n, or Algorithm 2's (value,
  gradient)); ``batch`` is ``(x, y, w)`` with ``w`` the eq.-(2) weights
  N_i/(B·N).  The upload is additive in the batch, so a linear
  aggregation can evaluate the aggregate on the weighted super-batch
  directly (see :mod:`repro_torch.fed.engine`);
* ``"mean"`` — the upload is a locally updated *model* (FedAvg);
  ``batch`` is ``(x, y)`` with a leading E axis of local steps, and the
  engine averages the models with λ_i = N_i/N.

``server_step`` takes the ``device=`` keyword the engine passes (the
fused kernel's wrapper reads it); ``round_metrics(state)`` returns device
scalars, read back once after the round loop.  ``client_state(state)``
is the state slice an upload reads, snapshotted beside the parameters by
the engine's async rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.core import autodiff, constrained, fedavg, ssca


class UploadSpec(NamedTuple):
    """Wire metadata of one client upload: how many elements the message
    carries, across how many leaves, at what element width."""
    elements: int
    leaves: int
    elem_bytes: int


class _Base:
    """Shared defaults: E = 1, sum-combine with eq.-(2) weights, a dense
    float32 model-shaped upload."""

    combine = "sum"
    local_steps = 1
    upload_dtype = torch.float32

    def client_weights(self, part, batch_size: int) -> np.ndarray:
        return part.weights(batch_size)            # N_i / (B·N)

    def client_state(self, state):
        """The state slice ``client_upload`` reads, which the async engine
        snapshots beside the parameters so a delayed upload replays
        faithfully.  Sum-combine uploads are pure functions of (params,
        batch): the empty tree."""
        del state
        return ()

    def round_metrics(self, state) -> Dict[str, Any]:
        del state
        return {}

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
        """The surrogate state; β only where λ > 0 reads it, as the
        reference's LM trainer keeps it."""
        return ssca.init(params, with_beta=bool(self.hp.lam))

    def client_upload(self, params, state, batch):
        """∇ loss_fn at ``params``, through ``vjp`` with
        ``create_graph=False`` (:mod:`repro_torch.core.autodiff`)."""
        del state
        return autodiff.grad(self.loss_fn, params, batch)

    def server_step(self, params, state, agg, *, device: Device = None):
        return ssca.server_update(state, params, agg, self.hp,
                                  fused=self.fused, device=device)


class CounterState(NamedTuple):
    """State of the stateless SGD baselines: just the round counter t."""
    step: int


@dataclasses.dataclass(frozen=True)
class SSCAConstrained(_Base):
    """Algorithm 2 (constrained, exact penalty) behind the protocol.

    The upload is q1 = (mini-batch cost value, gradient), a tuple whose
    value is flat leaf 0; the objective ‖ω‖² is known to the server, so
    q0 needs no upload (paper §V-B).  Secure aggregation masks both the
    value and the gradient.
    """
    cost_fn: Callable[[Any, Any], torch.Tensor]    # weighted batch sum
    limit_u: float
    hp: constrained.ConstrainedHyperParams

    def init_state(self, params):
        return constrained.init(params, num_constraints=1)

    def client_upload(self, params, state, batch):
        del state
        return autodiff.value_and_grad(self.cost_fn, params, batch)

    def server_step(self, params, state, agg, *, device: Device = None):
        del device
        val, grad = agg
        return constrained.server_update(state, params, val, grad,
                                         self.limit_u, self.hp)

    def round_metrics(self, state):
        # a device scalar: the engine reads every metric back once, after
        # the round loop
        return {"slack": state.slack[0]}

    def upload_spec(self, params) -> UploadSpec:
        return UploadSpec(                                   # + the value
            elements=tree.numel(params) + 1,
            leaves=len(tree.leaves(params)) + 1,
            elem_bytes=self.upload_dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class FedSGD(_Base):
    """E = 1 SGD baseline [3],[4] on F(ω) + λ‖ω‖².

    The ℓ2 term is server-side (its gradient 2λω needs no data), so the
    client upload is the plain weighted mini-batch gradient — identical
    uplink to Algorithm 1.
    """
    loss_fn: Callable[[Any, Any], torch.Tensor]    # weighted batch sum
    hp: fedavg.SGDHyperParams
    lam: float = 0.0

    def init_state(self, params):
        del params
        return CounterState(step=1)

    def client_upload(self, params, state, batch):
        del state
        return autodiff.grad(self.loss_fn, params, batch)

    def server_step(self, params, state, agg, *, device: Device = None):
        del device
        lr = self.hp.lr(state.step)
        g = tree.map(lambda gg, w: gg + 2.0 * self.lam * w, agg, params)
        new_params = tree.map(lambda w, gg: w - lr * gg, params, g)
        return new_params, CounterState(step=state.step + 1)


@dataclasses.dataclass(frozen=True)
class FedAvg(_Base):
    """FedAvg [3] / parallel-restarted SGD [5]: E local steps, model avg.

    The upload is the locally updated *model*; ``combine="mean"`` tells
    the engine to average with λ_i = N_i/N.
    """
    loss_fn: Callable[[Any, Any], torch.Tensor]    # local objective (mean)
    hp: fedavg.SGDHyperParams

    combine = "mean"

    @property
    def local_steps(self) -> int:
        return int(self.hp.local_steps)

    def init_state(self, params):
        del params
        return CounterState(step=1)

    def client_state(self, state):
        # local SGD reads the round counter (its lr schedule): a delayed
        # client replays with the lr of the round it computed at
        return state

    def client_upload(self, params, state, batch):
        lr = self.hp.lr(state.step)
        return fedavg.local_sgd(self.loss_fn, self.hp)(params, batch, lr)

    def server_step(self, params, state, agg, *, device: Device = None):
        del params, device
        return agg, CounterState(step=state.step + 1)

    def client_weights(self, part, batch_size: int) -> np.ndarray:
        del batch_size
        return (part.sizes / part.total).astype(np.float32)  # N_i / N
