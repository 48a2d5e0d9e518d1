"""Collectives that carry a gradient, over a set of axes of a
:class:`repro_torch.launch.mesh.ProductionMesh`, and the mesh's data
axes.  The models' mesh path (:mod:`repro_torch.models.sharded`,
``models.moe.moe_ffn_sharded``) and ``launch`` both read this module,
which reads neither.

The reference's sharded train step leaves its collectives to XLA, which
differentiates them; the port's mesh path calls these, each a
``torch.autograd.Function`` whose backward is the adjoint collective:

* :func:`all_gather` (concatenate along a dim) — backward the
  reduce-scatter (sum) of the gradient along that dim: each rank's copy
  of the gathered tensor feeds a different part of the loss (its batch
  shard, its heads), so the shard's gradient sums them;
* :func:`reduce_scatter` — backward the all-gather;
* :func:`all_reduce` (sum) — backward the all-reduce (sum);
* Megatron's pair over the tensor-parallel axis, where every rank of
  the group holds the same activation and the same loss:
  :func:`copy_to` (``f``: identity forward, all-reduce backward) where a
  replicated activation enters rank-partial work (a column-parallel
  product), and :func:`reduce_from` (``g``: all-reduce forward, identity
  backward) where rank-partial sums become the replicated activation
  (after a row-parallel product);
* :func:`gather_from` (all-gather forward, this rank's block of the
  gradient backward) where each rank's block of a replicated activation
  is put together and read whole by work every rank repeats: each
  rank's gradient of the whole is then the whole gradient, not a part.

Every call counts on the mesh (``ProductionMesh.calls``), forward and
backward alike.
"""
from __future__ import annotations

import torch


def data_axes(mesh) -> tuple:
    """The axes the global batch (= federated clients) shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _own(out, x):
    """A collective over one rank returns its input; a Function's output
    must not be its input itself."""
    return out.view_as(out) if out is x else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes, dim):
        return _own(mesh.all_gather(x, axes, dim), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes, ctx.dim = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes, dim):
        return _own(mesh.reduce_scatter(x, axes, dim), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes, ctx.dim = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes):
        return _own(mesh.all_reduce(x, axes), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes):
        return _own(mesh.all_reduce(x, axes), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes, dim):
        return _own(mesh.all_gather(x, axes, dim), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes, ctx.dim = inputs[1:]
        ctx.size = inputs[0].shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.axis_index(ctx.axes) * ctx.size,
                        ctx.size), None, None, None


def all_gather(x, mesh, axes, dim: int = 0):
    """The group's ``x`` concatenated along ``dim``; backward the
    reduce-scatter (sum)."""
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x, mesh, axes, dim: int = 0):
    """This rank's block along ``dim`` of the group's sum; backward the
    all-gather."""
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_reduce(x, mesh, axes):
    """The group's sum; backward the all-reduce (sum)."""
    return _AllReduce.apply(x, mesh, axes)


def copy_to(x, mesh, axes):
    """Megatron's ``f``: ``x`` unchanged; backward the all-reduce (sum)."""
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    """Megatron's ``g``: the group's sum; backward the identity."""
    return _ReduceFrom.apply(x, mesh, axes)


def gather_from(x, mesh, axes, dim: int = 0):
    """The group's blocks concatenated along ``dim``, read whole by every
    rank alike; backward this rank's block of the gradient."""
    return _GatherFrom.apply(x, mesh, axes, dim)
