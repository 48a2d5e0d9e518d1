"""Single-host federated simulation runtime (the paper's experimental rig).

The port of ``repro/fed/runtime.py::run_alg1``: Algorithm 1 (mini-batch
SSCA, unconstrained) on the paper's MLP task by default, or on a
decoder-only LM task (:func:`repro_torch.fed.tasks.transformer_task`),
with plain or secure aggregation and optionally compressed or sketched
uploads, on one device.
"""
from __future__ import annotations

from typing import Union

from repro_torch import Device, resolve_device
from repro_torch.core import protocol, ssca
from repro_torch.core.schedules import paper_schedules
from repro_torch.data.partition import Partition
from repro_torch.fed import aggregation as agg_mod
from repro_torch.fed import engine
from repro_torch.fed.engine import History  # noqa: F401  (public re-export)
from repro_torch.fed.tasks.base import SumLoss
from repro_torch.fed.tasks.mlp import MLPTask
from repro_torch.fed.tasks.transformer import LMTask


def _resolve_task(task, data, hidden: int):
    """``task=None`` is the paper's MLP with input/label widths read off
    the data and the ``hidden=`` width."""
    if task is not None:
        return task
    k, l = data.x_train.shape[1], data.y_train.shape[1]
    return MLPTask(k=k, hidden=hidden, l=l)


def _resolve_aggregation(aggregation, secure: bool):
    """``secure=True`` is shorthand for ``aggregation=secure()``; passing
    both is ambiguous and refused rather than silently dropping one."""
    if secure and aggregation is not None:
        raise ValueError(
            "pass either secure=True or an explicit aggregation=, not both")
    return agg_mod.secure() if secure else aggregation


def run_alg1(data, part: Partition, *, batch_size: int, rounds: int,
             lam: float = 1e-5, tau: float = 0.1, seed: int = 0,
             params=None, task: Union[MLPTask, LMTask, None] = None,
             hidden: int = 128, eval_every: int = 1,
             eval_samples: int = 10000, secure: bool = False,
             fused: bool = False, aggregation=None, compressor=None,
             mesh=None, staleness=None, staleness_trace=None, arena=None,
             pipeline: bool = False, profile_dir=None,
             device: Device = None) -> tuple:
    """Algorithm 1 on the eq.-(11) objective F(ω) + λ‖ω‖².

    ``secure=True`` is shorthand for ``aggregation=aggregation.secure()``
    (pairwise masking in Z_{2^32}: the server only sees Σ_i q_i).
    ``fused=True`` runs the server update through the fused kernel.
    ``compressor`` is one of :func:`repro_torch.fed.compression.qsgd`,
    :func:`~repro_torch.fed.compression.topk` or
    :func:`repro_torch.fed.sketch.sketch` (or the identity).
    ``task`` is the paper's MLP by default (widths from the data and
    ``hidden``) or an :class:`~repro_torch.fed.tasks.transformer.LMTask`.
    ``params`` is an optional parameter tree of the task: ``{"w1", "w2"}``
    for the MLP (see :func:`repro_torch.mlpapp.model.params_from_numpy`),
    the layer-stacked tree for an LM (see
    :func:`repro_torch.models.transformer.params_from_numpy`).  Runs on ``cuda``
    unless ``device="cpu"`` is passed.

    ``mesh``, ``staleness``, ``staleness_trace``, ``arena``, ``pipeline``
    and ``profile_dir`` keep the reference's signature but are not ported
    yet: setting one raises.
    """
    dev = resolve_device(device)
    unported = {"mesh": mesh,
                "staleness": staleness, "staleness_trace": staleness_trace,
                "arena": arena, "pipeline": pipeline or None,
                "profile_dir": profile_dir}
    unported = sorted(k for k, v in unported.items() if v is not None)
    if unported:
        raise NotImplementedError(
            f"run_alg1: {', '.join(unported)} not ported to repro_torch yet")
    task = _resolve_task(task, data, hidden)
    rho, gamma = paper_schedules(batch_size)
    hp = ssca.SSCAHyperParams(tau=tau, lam=lam, rho=rho, gamma=gamma)
    alg = protocol.SSCAUnconstrained(loss_fn=SumLoss(task), hp=hp,
                                     fused=fused)
    aggregation = _resolve_aggregation(aggregation, secure)
    return engine.run(alg, data, part, task=task, batch_size=batch_size,
                      rounds=rounds, params=params, seed=seed,
                      eval_every=eval_every, eval_samples=eval_samples,
                      aggregation=aggregation, compressor=compressor,
                      device=dev)
