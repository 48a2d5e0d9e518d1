"""Single-host federated simulation runtime (the paper's experimental rig).

The port of ``repro/fed/runtime.py``: the four algorithms of the paper's
Section VI, each a thin wrapper over :func:`run` that builds one
algorithm (:mod:`repro_torch.core.protocol`) from the task's loss:

* Algorithm 1 (mini-batch SSCA, unconstrained)      — ``run_alg1``
* Algorithm 2 (mini-batch SSCA, constrained)        — ``run_alg2``
* FedSGD / SGD with E=1 [3],[4]                     — ``run_fedsgd``
* FedAvg / parallel-restarted SGD with E>1 [3],[5]  — ``run_fedavg``

on the paper's MLP task by default, or on a decoder-only LM task
(:func:`repro_torch.fed.tasks.transformer_task`,
:func:`~repro_torch.fed.tasks.rwkv6_task`), with plain, secure or
hierarchical (``hierarchical(inner, G)``) aggregation, full or partial
participation (``sampled(S)``, ``secure(num_sampled=S)``), synchronous,
async (``staleness=``) or pipelined (``pipeline=True``) rounds and
optionally compressed or sketched uploads, on one device or, with
``mesh=`` (:func:`repro_torch.launch.make_client_mesh`), with the cohort
sharded over the ranks of a ``torch.distributed`` group, or the tree's
(groups, members) grid tiled over a 2-D mesh of them
(:func:`repro_torch.launch.make_group_mesh`).  The
mini-batch schedule is shared across the sum-combine algorithms (same
seed ⇒ same sample draws), so convergence comparisons are paired;
FedAvg draws its local steps under their own ids.
"""
from __future__ import annotations

from typing import Union

from repro_torch import Device
from repro_torch.core import constrained, fedavg, protocol, ssca
from repro_torch.core.schedules import paper_schedules, sgd_learning_rate
from repro_torch.data.partition import Partition
from repro_torch.fed import aggregation as agg_mod
from repro_torch.fed import engine
from repro_torch.fed.engine import History  # noqa: F401  (public re-export)
from repro_torch.fed.tasks.base import LocalObjective, SumLoss
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


def run(task, algorithm, data, part: Partition, *, batch_size: int,
        rounds: int, params=None, seed: int = 0, eval_every: int = 1,
        eval_samples: int = 10000, aggregation=None, compressor=None,
        mesh=None, staleness=None, staleness_trace=None, arena=None,
        pipeline: bool = False, profile_dir=None,
        device: Device = None) -> tuple:
    """The generic task × algorithm entry all four wrappers reduce to.

    ``params=None`` initializes from ``task.init_params`` seeded by
    ``seed`` (in :func:`repro_torch.fed.engine.run`).  Runs on ``cuda``
    unless ``device="cpu"`` is passed.  ``aggregation`` may sample a
    cohort (``sampled(S)``, ``secure(num_sampled=S)``) or be the
    two-level tree (``hierarchical(inner, groups)``); ``staleness`` (a
    :class:`repro_torch.fed.staleness.StalenessConfig`) and
    ``staleness_trace`` run async rounds; ``pipeline=True`` runs the
    reference's pipelined rounds (the async mode at the constant τ ≡ 1
    trace; it refuses ``staleness=``); ``profile_dir`` writes a
    ``torch.profiler`` Chrome trace of the timed loop there.

    ``mesh`` (:func:`repro_torch.launch.make_client_mesh`, every rank of
    the group making the same call) shards each round's cohort over the
    ranks, the aggregate one psum of their partials (a chunked ring of
    them in pipelined rounds); it then runs on the mesh rank's device.
    ``arena`` must be ``None``, ``"replicated"`` or ``"sharded"`` (the
    default with a mesh): where the population's residual rows and
    weights, and the async snapshot ring, live on the mesh; one device
    has nothing to shard, so without a mesh it is ignored, as in the
    reference.  The client mesh runs synchronous, async and pipelined
    rounds of a flat strategy (``hierarchical(...)`` on it raises
    ``ValueError``); ``mesh=make_group_mesh(g, c)`` runs them for the
    tree (g dividing its G), each rank a (G/g, M_pad/c) tile of the
    blocked cohort, the level-1 sums completed over the clients axis and
    the root over the groups axis.
    """
    return engine.run(algorithm, data, part, task=task,
                      batch_size=batch_size, rounds=rounds, params=params,
                      seed=seed, eval_every=eval_every,
                      eval_samples=eval_samples, aggregation=aggregation,
                      compressor=compressor, mesh=mesh, arena=arena,
                      staleness=staleness, staleness_trace=staleness_trace,
                      pipeline=pipeline, profile_dir=profile_dir,
                      device=device)


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

    ``aggregation`` may sample a cohort (``sampled(S)``,
    ``secure(num_sampled=S)``) or be the tree (``hierarchical(inner,
    groups)``); ``staleness`` / ``staleness_trace`` run async rounds,
    ``pipeline=True`` pipelined ones; ``profile_dir`` traces the timed
    loop; ``mesh`` (a client mesh of ranks) shards the cohort and
    ``arena`` places its population state (:func:`run`).
    """
    task = _resolve_task(task, data, hidden)
    rho, gamma = paper_schedules(batch_size)
    hp = ssca.SSCAHyperParams(tau=tau, lam=lam, rho=rho, gamma=gamma)
    alg = protocol.SSCAUnconstrained(loss_fn=SumLoss(task), hp=hp,
                                     fused=fused)
    aggregation = _resolve_aggregation(aggregation, secure)
    return run(task, alg, data, part, batch_size=batch_size, rounds=rounds,
               params=params, seed=seed, eval_every=eval_every,
               eval_samples=eval_samples, aggregation=aggregation,
               compressor=compressor, mesh=mesh, staleness=staleness,
               staleness_trace=staleness_trace, arena=arena,
               pipeline=pipeline, profile_dir=profile_dir, device=device)


def run_alg2(data, part: Partition, *, batch_size: int, rounds: int,
             limit_u: float = 0.13, tau: float = 0.1, c: float = 1e5,
             seed: int = 0, params=None,
             task: Union[MLPTask, LMTask, None] = None, hidden: int = 128,
             eval_every: int = 1, eval_samples: int = 10000,
             secure: bool = False, aggregation=None, compressor=None,
             mesh=None, staleness=None, staleness_trace=None, arena=None,
             pipeline: bool = False, profile_dir=None,
             device: Device = None) -> tuple:
    """Algorithm 2 on eq. (18): min ‖ω‖² s.t. F(ω) ≤ U.

    ``secure=True`` masks the (value, gradient) upload q1 — the secure
    constrained variant the paper's §III-B requires.  The slack s^t at
    each eval point is ``History.slack``.  Other arguments as
    :func:`run_alg1`'s: cohorts, the hierarchical tree, compressors,
    async and pipelined rounds, ``profile_dir``, ``mesh`` and ``arena``."""
    task = _resolve_task(task, data, hidden)
    rho, gamma = paper_schedules(batch_size)
    hp = constrained.ConstrainedHyperParams(tau=tau, c=c, rho=rho,
                                            gamma=gamma)
    alg = protocol.SSCAConstrained(cost_fn=SumLoss(task),
                                   limit_u=limit_u, hp=hp)
    aggregation = _resolve_aggregation(aggregation, secure)
    return run(task, alg, data, part, batch_size=batch_size, rounds=rounds,
               params=params, seed=seed, eval_every=eval_every,
               eval_samples=eval_samples, aggregation=aggregation,
               compressor=compressor, mesh=mesh, staleness=staleness,
               staleness_trace=staleness_trace, arena=arena,
               pipeline=pipeline, profile_dir=profile_dir, device=device)


def run_fedsgd(data, part: Partition, *, batch_size: int, rounds: int,
               lam: float = 1e-5, lr_a: float = 0.5, lr_alpha: float = 0.3,
               seed: int = 0, params=None,
               task: Union[MLPTask, LMTask, None] = None, hidden: int = 128,
               eval_every: int = 1, eval_samples: int = 10000,
               aggregation=None, compressor=None, mesh=None,
               staleness=None, staleness_trace=None, arena=None,
               pipeline: bool = False, profile_dir=None,
               device: Device = None) -> tuple:
    """E = 1 SGD baseline [3],[4] on the same objective as Algorithm 1,
    learning rate ``lr_a / t^lr_alpha``.  Other arguments as
    :func:`run_alg1`'s: cohorts, the hierarchical tree, compressors,
    async and pipelined rounds, ``profile_dir``, ``mesh`` and ``arena``."""
    task = _resolve_task(task, data, hidden)
    hp = fedavg.SGDHyperParams(lr=sgd_learning_rate(lr_a, lr_alpha))
    alg = protocol.FedSGD(loss_fn=SumLoss(task), hp=hp, lam=lam)
    return run(task, alg, data, part, batch_size=batch_size, rounds=rounds,
               params=params, seed=seed, eval_every=eval_every,
               eval_samples=eval_samples, aggregation=aggregation,
               compressor=compressor, mesh=mesh, staleness=staleness,
               staleness_trace=staleness_trace, arena=arena,
               pipeline=pipeline, profile_dir=profile_dir, device=device)


def run_fedavg(data, part: Partition, *, batch_size: int, rounds: int,
               local_steps: int = 2, lam: float = 1e-5, lr_a: float = 0.5,
               lr_alpha: float = 0.3, seed: int = 0, params=None,
               task: Union[MLPTask, LMTask, None] = None, hidden: int = 128,
               eval_every: int = 1, eval_samples: int = 10000,
               aggregation=None, compressor=None, mesh=None,
               staleness=None, staleness_trace=None, arena=None,
               pipeline: bool = False, profile_dir=None,
               device: Device = None) -> tuple:
    """FedAvg [3] / PR-SGD [5]: E local steps per round, then model average.

    Per-client batches are (I, E, B) samples; aggregation weight N_i/N.
    The local objective is the task's mean loss + λ‖ω‖²
    (:class:`repro_torch.fed.tasks.base.LocalObjective`).  Other arguments
    as :func:`run_alg1`'s: cohorts, the hierarchical tree, compressors,
    async and pipelined rounds, ``profile_dir``, ``mesh`` and ``arena``.
    """
    task = _resolve_task(task, data, hidden)
    hp = fedavg.SGDHyperParams(lr=sgd_learning_rate(lr_a, lr_alpha),
                               local_steps=local_steps)
    alg = protocol.FedAvg(loss_fn=LocalObjective(task, lam), hp=hp)
    return run(task, alg, data, part, batch_size=batch_size, rounds=rounds,
               params=params, seed=seed, eval_every=eval_every,
               eval_samples=eval_samples, aggregation=aggregation,
               compressor=compressor, mesh=mesh, staleness=staleness,
               staleness_trace=staleness_trace, arena=arena,
               pipeline=pipeline, profile_dir=profile_dir, device=device)
