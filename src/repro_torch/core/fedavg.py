"""SGD-based federated baselines the paper compares against ([3]–[5]).

The port of ``repro/core/fedavg.py``.

* **FedSGD** — E = 1: each client computes one mini-batch gradient; the
  server averages (weighted by N_i/N) and takes an SGD step.  Identical
  per-round communication to Algorithm 1.
* **FedAvg** [3] — E > 1: each client runs E local SGD steps from the
  current global model; the server averages the resulting models.
* **Parallel-restarted SGD** [5] — FedAvg with all clients participating
  and a common decaying learning rate (the form analysed in [5]); provided
  as a named alias with the restart interval E.

All are pure-functional: ``round(params, batches, t) -> params``.
``batches`` carries a leading client axis so the local loops vmap across
clients (``torch.func.vmap``): the local loop rebinds the parameter tree
each step and updates no tensor in place.

The engine runs these baselines through :class:`repro_torch.core.protocol.
FedSGD` / ``FedAvg`` and uses only :func:`local_sgd` from here; the
``*_round`` functions are the reference's standalone API, kept for
parity with it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from repro_torch import optim, tree
from repro_torch.core import autodiff
from repro_torch.core.schedules import PowerLaw

Params = tree.Tree


class SGDHyperParams(NamedTuple):
    lr: PowerLaw = PowerLaw(0.1, 0.5)   # r = ā / t^ᾱ, grid-searched in §VI
    local_steps: int = 1                # E
    momentum: float = 0.0


def fedsgd_round(loss_fn: Callable[[Params, Any], torch.Tensor],
                 hp: SGDHyperParams):
    """E = 1 baseline: aggregate weighted grads, one SGD step.  The
    reference's standalone round; the engine does not call it."""
    def one_round(params, batch, t, weight=1.0, aggregate=None):
        g = tree.map(lambda x: x * weight,
                     autodiff.grad(loss_fn, params, batch))
        if aggregate is not None:
            g = aggregate(g)
        lr = hp.lr(t)
        return tree.map(lambda w, gg: w - lr * gg, params, g)

    return one_round


def local_sgd(loss_fn: Callable[[Params, Any], torch.Tensor],
              hp: SGDHyperParams):
    """The client-side E-step local SGD(+momentum) loop of FedAvg.

    Returns ``local_update(params, batches_e, lr)`` where ``batches_e`` is
    a tree with a leading E axis (stepped over in order).  Exposed
    separately so the engine (:mod:`repro_torch.fed.engine`) can use it
    as the FedAvg ``client_upload`` while :func:`fedavg_round` keeps the
    legacy shape.
    """
    def local_update(params, batches_e, lr):
        init, update = (optim.momentum(lambda t: lr, hp.momentum)
                        if hp.momentum else optim.sgd(lambda t: lr))
        p, st = params, init(params)
        for e in range(tree.leaves(batches_e)[0].shape[0]):
            b = tree.map(lambda v: v[e], batches_e)
            p, st = update(autodiff.grad(loss_fn, p, b), st, p)
        return p

    return local_update


def fedavg_round(loss_fn: Callable[[Params, Any], torch.Tensor],
                 hp: SGDHyperParams):
    """FedAvg [3]: per-client E local SGD(+momentum) steps, then weighted
    model average.

    ``client_batches`` has a leading axis (I, E, ...) — one E-sequence of
    mini-batches per client; ``client_weights`` is (I,) with Σ = 1 (N_i/N).
    The reference's standalone round; the engine does not call it.
    """
    local_update = local_sgd(loss_fn, hp)

    def one_round(params, client_batches, client_weights, t):
        lr = hp.lr(t)
        locals_ = vmap(lambda be: local_update(params, be, lr))(
            client_batches)
        return tree.map(
            lambda ws: torch.tensordot(client_weights, ws, dims=1), locals_)

    return one_round


def prsgd_round(loss_fn, hp: SGDHyperParams):
    """Parallel-restarted SGD [5] == FedAvg with full participation and a
    common decaying lr; alias kept so benchmarks can name it."""
    return fedavg_round(loss_fn, hp)
