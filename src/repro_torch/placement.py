"""Where a production mesh keeps each block of a tensor, and the decode
state's placement table.

A placement ("spec") is a tuple with one entry a dimension: ``None``
(whole), an axis name, or a tuple of axis names (the dimension split
over their product, row-major), as ``launch.sharding`` describes it.
This module cuts a rank's block out of a whole tensor
(:func:`local_block`), gives a block's shape from the whole's and back
(:func:`block_shape`, :func:`whole_shape`) and gathers the blocks
(:func:`gather_block`); and it holds :func:`decode_state_shardings`,
the port of ``repro/launch/sharding.py``'s decode table, the one source
of the decode layout.  ``launch.sharding`` exports all of it; the
models' mesh path (``Model.init_decode`` and ``decode_step``) and
``ckpt.io`` read it here, which reads nothing of ``models``,
``launch`` or ``ckpt``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.parallel import data_axes

Spec = tuple


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (an axis name or a tuple of them)."""
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``
    (:func:`local_block`'s, without the tensor); raises where a size does
    not divide."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {entry} ({n} ranks)")
        out[dim] //= n
    return tuple(out)


def whole_shape(shape, spec: Spec, mesh) -> tuple:
    """The whole tensor's shape from one rank's block ``shape`` under
    ``spec``: the inverse of :func:`block_shape`."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] *= mesh.axis_size(entry_axes(entry))
    return tuple(out)


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each
    split dimension cut into the product of its axes' sizes, the block
    at this rank's row-major index over them.  ``x`` itself where no
    dimension is split; raises where a size does not divide."""
    size = block_shape(x.shape, spec, mesh)
    out = x
    for dim, entry in enumerate(spec):
        if entry is not None:
            out = out.narrow(dim, mesh.axis_index(entry_axes(entry))
                             * size[dim], size[dim])
    return x if out.shape == x.shape else out.contiguous()


def gather_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``, each
    split dimension all-gathered over its axes (counted on the mesh)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = mesh.all_gather(x, entry_axes(entry), dim)
    return x


def batch_spec(shape: InputShape, mesh, dp_override=None):
    """The batch dim's entry: the data axes (one axis by its name, as a
    ``PartitionSpec`` normalises it) when they divide the global batch."""
    dp = tuple(dp_override) if dp_override is not None else data_axes(mesh)
    ndev = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if not dp or shape.global_batch % ndev:
        return None
    return dp[0] if len(dp) == 1 else dp


def decode_shape(batch: int, max_len: int) -> InputShape:
    """The decode :class:`InputShape` of ``batch`` sequences of at most
    ``max_len`` tokens (the table reads its global batch)."""
    return InputShape("decode", int(max_len), int(batch), "decode")


def decode_state_shardings(cfg: ModelConfig, shape: InputShape, mesh,
                           state):
    """Decode caches: batch over data axes; the KV caches' sequence over
    model; recurrent state heads over model.  ``state`` is a
    ``DecodeState`` (of tensors or meta tensors); returns one of specs.
    The one source of the decode layout: ``Model.init_decode`` on a mesh
    allocates each rank's :func:`block_shape` of these specs, and
    :func:`decode_rows` cuts a decode batch by the same batch entry."""
    b = batch_spec(shape, mesh)
    m = "model"

    def spec_for(name, leaf) -> Spec:
        if leaf.dim() == 0 or leaf.numel() == 0:
            return ()
        if name in ("kv_k", "kv_v", "cross_k", "cross_v"):
            # (n_layers, B, C, Hkv, hd): the cache's sequence over model
            cap = leaf.shape[2]
            cspec = m if cap % mesh.shape["model"] == 0 else None
            return (None, b, cspec, None, None)
        if name == "rec_h":
            if leaf.dim() == 5:      # rwkv wkv (L, B, H, dk, dv)
                return (None, b, m, None, None)
            return (None, b, m)      # rglru (L, B, D)
        if name == "rec_conv" and leaf.dim() == 4:
            # (L, B, W-1, D) or rwkv shifts (L, 2, B, D)
            if cfg.family == "ssm":
                return (None, None, b, m)
            return (None, b, None, m)
        return ()

    return type(state)(*(spec_for(f, getattr(state, f))
                         for f in state._fields))


def decode_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a decode batch's (B, …) tensor (tokens, frame
    embeddings) by :func:`decode_state_shardings`' batch entry: split
    over the data axes where they divide B, else all B rows."""
    spec = (batch_spec(decode_shape(x.shape[0], 1), mesh),)
    return local_block(x, spec, mesh)


def gather_rows(x: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The inverse of :func:`decode_rows` for a decode batch of ``batch``
    rows: every rank's rows of ``x`` gathered over the data axes where
    the table splits them."""
    return gather_block(x, (batch_spec(decode_shape(batch, 1), mesh),),
                        mesh)
