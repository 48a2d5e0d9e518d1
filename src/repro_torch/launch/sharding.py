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
blocks back together (:func:`gather_params`).  The blocks' helpers and
the decode state's table (``decode_state_shardings``) live in
:mod:`repro_torch.placement`, below the models, which read them there;
this module exports them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.ssca import SSCAState
from repro_torch.parallel import data_axes
from repro_torch.placement import (  # noqa: F401  (this module's API)
    Spec, block_shape, decode_rows, decode_shape, decode_state_shardings,
    gather_block, gather_rows, local_block, whole_shape)
from repro_torch.placement import batch_spec as _batch_spec
from repro_torch.tree import named_leaves, rebuild


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
    return rebuild(local, {
        name: gather_block(leaf, _param_spec(
            name, tuple(leaf.shape), mesh, fsdp_params=fsdp_params,
            moe_fsdp_dim=moe_fsdp_dim), mesh)
        for name, leaf in named_leaves(local)})


def state_shardings(state: SSCAState, params_sh, mesh) -> SSCAState:
    """SSCA state: lin/beta like params; the step replicated."""
    return SSCAState(step=(), lin=params_sh,
                     beta=None if state.beta is None else params_sh)


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


def replicated(mesh) -> Spec:
    """The spec of a whole (replicated) array."""
    del mesh
    return ()

