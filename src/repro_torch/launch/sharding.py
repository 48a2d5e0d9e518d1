"""Placement tables: which mesh axes each dimension of a parameter, a
state, a batch or a decode cache is split over.

The port of ``repro/launch/sharding.py``.  Scheme (the reference's
baseline): 2-D FSDP × TP.

* ``model`` axis — tensor parallelism: attention heads / ffn hidden /
  vocab / experts.
* ``data`` axis (and ``pod`` when present) — the federated-client axis:
  the global batch shards over it, and parameters and SSCA state also
  shard over ``data`` FSDP-style on a non-TP dimension.

A placement ("spec") is a tuple with one entry a dimension: ``None``
(whole), an axis name, or a tuple of axis names (the dimension split
over their product, row-major) — the entries of the reference's
``PartitionSpec``, ``tuple(spec)`` of which it equals entry for entry.
Rules are name-based over the stacked-parameter tree; unknown leaves
replicate (``()``), as in the reference.  The reference hands these to
XLA as ``NamedSharding``s; the port cuts each rank's block out of a
full tensor (:func:`shard_params`, :func:`local_batch`) and puts the
blocks back together (:func:`gather_params`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.ssca import SSCAState
from repro_torch.parallel import data_axes
from repro_torch.tree import named_leaves, rebuild

Spec = tuple


def _fsdp(mesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def _param_spec(name: str, shape: tuple, mesh, *, fsdp_params: bool = True,
                moe_fsdp_dim: str = "d") -> Spec:
    """The reference's table, name for name.  moe_fsdp_dim: which expert
    weight dim carries the FSDP shard — "d" (d_model; train default) or
    "f" (d_ff; weight-stationary decode TP)."""
    d = _fsdp(mesh) if fsdp_params else None
    m = "model"
    n = name.split("/")[-1]
    base = n[2:] if n.startswith(("d_", "m_")) else n
    for r in range(4):
        if base.startswith((f"r{r}_", f"a{r}_")):
            base = base[3:]
    rank = len(shape)

    def stacked(spec):
        """None for the layer-stack axis when present."""
        return tuple([None] * (rank - len(spec)) + list(spec))

    if base == "embed":
        return (m, d)
    if base in ("wq", "wk", "wv", "xwq", "xwk", "xwv", "wg", "wu", "wi",
                "wx", "wgate", "w_ri", "ck", "cr", "wr", "wkk", "wvv",
                "img_proj"):
        return stacked([d, m])
    if base in ("wo", "xwo", "wd", "wo2", "w_out", "cv", "swd", "ewd"):
        if base == "ewd":                       # (L, E, F, D)
            # experts always carry a data-axis shard (they never fit
            # model-only), even when fsdp_params=False for the rest
            de = _fsdp(mesh)
            return stacked([m, de, None]) if moe_fsdp_dim == "f" \
                else stacked([m, None, de])
        return stacked([m, d])
    if base in ("ewg", "ewu"):                  # (L, E, D, F)
        de = _fsdp(mesh)
        return stacked([m, None, de]) if moe_fsdp_dim == "f" \
            else stacked([m, de, None])
    if base in ("swg", "swu"):
        return stacked([d, m])
    if base == "router":                        # (L, D, E)
        return stacked([d, None])
    if base in ("decay_w1",):
        return stacked([d, None])
    if base in ("decay_w2",):
        return stacked([None, m])
    if base in ("bonus", "ln_w", "ln_b"):       # (L, H, hd)
        return stacked([m, None])
    if base in ("wk_rwkv",):
        return stacked([d, m])
    # rwkv big square projections
    if base in ("wkx",):
        return stacked([d, m])
    if base == "conv_w":                        # (L, W, D)
        return stacked([None, m])
    # everything else (norms, mixes, biases, lam, decay_base) replicates
    return ()


def layer_pspec_fn(mesh, *, fsdp_params: bool = True,
                   moe_fsdp_dim: str = "d"):
    """``fn(name, per-layer shape)`` → the spec of one layer's slice of a
    block leaf (no stack axis), which the model reads to gather each
    layer's FSDP shard inside its layer loop."""
    def fn(name: str, shape: tuple) -> Spec:
        spec = _param_spec(name, (0,) + tuple(shape), mesh,
                           fsdp_params=fsdp_params, moe_fsdp_dim=moe_fsdp_dim)
        return spec[1:] if len(spec) > len(shape) else spec
    return fn


def param_shardings(params, mesh, *, fsdp_params: bool = True,
                    moe_fsdp_dim: str = "d"):
    """The spec of every leaf of a parameter tree (tensors, meta tensors
    or anything with a ``shape``)."""
    return rebuild(params, {
        name: _param_spec(name, tuple(leaf.shape), mesh,
                          fsdp_params=fsdp_params, moe_fsdp_dim=moe_fsdp_dim)
        for name, leaf in named_leaves(params)})


def _entry_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each
    split dimension cut into the product of its axes' sizes, the block
    at this rank's row-major index over them.  ``x`` itself where no
    dimension is split; raises where a size does not divide."""
    out = x
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(_entry_axes(entry))
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {entry} ({n} ranks)")
        size = x.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(_entry_axes(entry)) * size,
                         size)
    return x if out.shape == x.shape else out.contiguous()


def shard_params(params, mesh, *, fsdp_params: bool = True,
                 moe_fsdp_dim: str = "d"):
    """Each leaf's block on this rank (:func:`local_block` of its spec) —
    the port's counterpart of placing the reference's parameters with
    ``param_shardings``."""
    specs = dict(named_leaves(param_shardings(
        params, mesh, fsdp_params=fsdp_params, moe_fsdp_dim=moe_fsdp_dim)))
    return rebuild(params, {name: local_block(leaf, specs[name], mesh)
                             for name, leaf in named_leaves(params)})


def gather_params(local, mesh, *, fsdp_params: bool = True,
                  moe_fsdp_dim: str = "d"):
    """The inverse of :func:`shard_params` on every rank: each split
    dimension all-gathered over its axes (counted on the mesh)."""
    out = {}
    for name, leaf in named_leaves(local):
        spec = _param_spec(name, tuple(leaf.shape), mesh,
                           fsdp_params=fsdp_params, moe_fsdp_dim=moe_fsdp_dim)
        for dim, entry in enumerate(spec):
            if entry is not None:
                leaf = mesh.all_gather(leaf, _entry_axes(entry), dim)
        out[name] = leaf
    return rebuild(local, out)


def state_shardings(state: SSCAState, params_sh, mesh) -> SSCAState:
    """SSCA state: lin/beta like params; the step replicated."""
    return SSCAState(step=(), lin=params_sh,
                     beta=None if state.beta is None else params_sh)


def _batch_spec(shape: InputShape, mesh, dp_override=None):
    """The batch dim's entry: the data axes (one axis by its name, as a
    ``PartitionSpec`` normalises it) when they divide the global batch."""
    dp = tuple(dp_override) if dp_override is not None else data_axes(mesh)
    ndev = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if not dp or shape.global_batch % ndev:
        return None
    return dp[0] if len(dp) == 1 else dp


def batch_shardings(cfg: ModelConfig, shape: InputShape, mesh,
                    dp_override=None) -> dict:
    """Specs of the train/prefill batch dict: its batch dim over the data
    axes when they divide the global batch, else whole."""
    bspec = _batch_spec(shape, mesh, dp_override)
    out = {"tokens": (bspec, None)}
    if cfg.family == "vlm":
        out["img_embeds"] = (bspec, None, None)
    if cfg.family == "audio":
        out["frame_embeds"] = (bspec, None, None)
    return out


def local_batch(batch: dict, mesh, dp_axes=None) -> dict:
    """This rank's rows of a global batch dict: the leading dim split over
    ``dp_axes`` (the mesh's data axes by default), which must divide it."""
    dp = data_axes(mesh) if dp_axes is None else tuple(dp_axes)
    return {k: local_block(v, (dp,) if dp else (), mesh)
            for k, v in batch.items()}


def decode_state_shardings(cfg: ModelConfig, shape: InputShape, mesh,
                           state):
    """Decode caches: batch over data axes; the KV caches' sequence over
    model; recurrent state heads over model.  ``state`` is a
    ``DecodeState`` (of tensors or meta tensors); returns one of specs."""
    b = _batch_spec(shape, mesh)
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


def replicated(mesh) -> Spec:
    """The spec of a whole (replicated) array."""
    del mesh
    return ()

