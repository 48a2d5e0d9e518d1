"""Train and serve step factories: the paper's technique on one model.

The port of ``repro/launch/steps.py``.  ``make_train_step`` is one round
of Algorithm 1 on an LM: the mean-loss gradient over the batch is the
aggregated client message ĝ^t (with every client holding N/I samples the
paper's weights N_i/(B·N) reduce to the uniform mean over the batch),
and the SSCA server update (recursions (14)/(15), closed form (16)/(17),
move (4)) runs as one launch of the fused kernel
(:func:`repro_torch.core.ssca.server_update` with ``fused=True``: its
``lambda0`` variant at the default λ = 0).  ``make_sgd_train_step`` is
the FedSGD baseline on the same batch; ``make_prefill_step`` and
``make_decode_step`` are the serving path.

``make_train_step`` of a model on a production mesh (every family; the
moe family in ``moe_weight_mode="fsdp"``) takes this rank's blocks of
the parameters and the state and its rows of the batch: the loss is the
rank's share of the mean, its gradient comes from ``torch.autograd.grad``
(the layers run under ``torch.utils.checkpoint``, which
``torch.func.vjp`` refuses), the gradient of each leaf reaches its block
through the collectives' backwards and one all-reduce a set of axes for
what the placements leave whole, and the fused update runs on the rank's
flat blocks (``lin`` placed as the parameters).  The metrics are the
global mean loss and ‖g‖.

Each step follows its tensors' device: the kernels for CUDA tensors,
their plain versions for CPU ones, which the caller placed there.  The
reference jit-compiles each factory's function; the port runs it
eagerly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import autodiff, ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.models import sharded
from repro_torch.models.transformer import Model


def _device(params) -> torch.device:
    return tree.leaves(params)[0].device


def make_train_step(model: Model,
                    hp: Optional[ssca.SSCAHyperParams] = None,
                    microbatches: int = 1):
    """One Algorithm-1 round, ``(params, state, batch) → (params', state',
    {"loss", "kkt_residual"})``.  ``microbatches > 1`` accumulates the
    message ĝ over that many equal slices of the batch's leading axis
    (the same math: eq. (2) is a sum), in a Python loop where the
    reference scans, summing from zero in the reference's order.  bf16
    parameters (the published MoE configs') give bf16 gradients, and the
    fused update's flat f32 buffer returns f32 parameters and ``lin``, as
    the reference's f32 ρ and γ promote them."""
    hp = hp or ssca.SSCAHyperParams(tau=0.1, lam=0.0,
                                    rho=PowerLaw(0.9, 0.3),
                                    gamma=PowerLaw(0.9, 0.35))
    mesh = model.mesh
    if mesh is not None and model.expert_parallel \
            and model.moe_weight_mode == "stationary":
        raise ValueError(
            "a train step in moe_weight_mode='stationary': its combine sums "
            "every rank's whole batch over (data, model), which has no "
            "adjoint over the data axes that returns each rank its rows' "
            "gradient; it is a forward (decode) mode, as in the reference. "
            "Train with moe_weight_mode='fsdp'")

    # the mesh's layers run under torch.utils.checkpoint
    value_and_grad = autodiff.value_and_grad if mesh is None \
        else autodiff.autograd_value_and_grad

    def train_step(params, state: ssca.SSCAState, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"{microbatches} microbatches do not divide "
                             f"the batch of {rows}")
        if microbatches == 1:
            loss, grads = value_and_grad(model.loss, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=_device(params))
            grads = tree.map(torch.zeros_like, params)
            for i in range(microbatches):
                part = {k: v.narrow(0, i * (v.shape[0] // microbatches),
                                    v.shape[0] // microbatches)
                        for k, v in batch.items()}
                li, gi = value_and_grad(model.loss, params, part)
                loss = loss + li
                grads = tree.map(torch.add, grads, gi)
            loss = loss / microbatches
            grads = tree.map(lambda g: g / microbatches, grads)
        if mesh is None:
            metrics = {"loss": loss, "kkt_residual": ssca.kkt_residual(grads)}
        else:
            grads, metrics = _mesh_grads(model, params, loss, grads)
        new_params, new_state = ssca.server_update(
            state, params, grads, hp, fused=True, device=_device(params))
        return new_params, new_state, metrics

    return train_step


def _mesh_grads(model: Model, params, loss, grads):
    """On a production mesh: each leaf's gradient summed over the axes its
    placement leaves whole (``models.sharded.reduce_replicated``), and the
    metrics by one all-reduce over the whole mesh — the loss shares of
    model rank 0 (the global mean) and each owned block's Σ g² (the
    global ‖g‖², replicated leaves counted once)."""
    mesh = model.mesh
    pspec = model.mesh_context().pspec
    specs = sharded.leaf_specs(params, pspec)
    grads = sharded.reduce_replicated(grads, mesh, specs)
    share = loss.detach() if mesh.axis_index("model") == 0 \
        else torch.zeros_like(loss)
    both = mesh.all_reduce(torch.stack([share.float(), sharded.owned_sq_sum(
        grads, mesh, specs)]), mesh.axis_names)
    return grads, {"loss": both[0], "kkt_residual": torch.sqrt(both[1])}


def make_sgd_train_step(model: Model, lr: Optional[PowerLaw] = None):
    """The FedSGD step, ``(params, step, batch) → (params', step + 1,
    {"loss"})`` with ``step`` a 0-d int32 tensor counted from 1 and the
    rate ``lr(step)``; bf16 parameters come back f32, as the reference's
    f32 rate promotes them."""
    lr = lr or PowerLaw(0.1, 0.5)

    def train_step(params, step, batch):
        loss, grads = autodiff.value_and_grad(model.loss, params, batch)
        r = lr(step.float()).to(_device(params))
        new_params = tree.map(
            lambda w, g: ssca.promoted(w) - r * ssca.promoted(g), params,
            grads)
        return new_params, step + 1, {"loss": loss}

    return train_step


def make_prefill_step(model: Model):
    """``(params, batch) → (B, padded_vocab)`` logits of the last position
    of ``model.forward`` (the flash or the WKV kernel on the card), without
    autograd.  On a mesh: the rank's rows, the vocab gathered over
    ``model``."""
    mesh = model.mesh

    @torch.no_grad()
    def prefill_step(params, batch):
        logits = model.forward(params, batch)[:, -1, :]
        if mesh is not None and model.shard_logits:
            logits = mesh.all_gather(logits, "model", -1)
        return logits
    return prefill_step


def make_decode_step(model: Model):
    """``(params, state, batch) → (logits, state')``: one token of
    ``batch["tokens"]`` (B, 1) through ``model.decode_step``."""
    def decode_step(params, state, batch):
        return model.decode_step(params, state, batch["tokens"])
    return decode_step
