"""Tree checkpointing: save and restore parameter and optimizer trees as
a ``.npz`` archive beside a JSON manifest, in the reference's format.

The port of ``repro/ckpt/io.py``.  On disk, in a directory:

* ``arrays.npz`` — one array a leaf, keyed by the leaf's path with
  ``/`` → ``__``; bfloat16 stored as its uint16 bits (npz has no bf16);
* ``manifest.json`` — ``step``, ``keys`` (the ``/`` paths in leaf
  order), ``dtypes`` (a name a key: ``bfloat16`` for the uint16 bits,
  else numpy's name), ``treedef`` and ``extra``.

A checkpoint written by either side is read by the other.  Paths follow
the reference's: a dict key, a tuple position, a NamedTuple field as
``.field``; leaves in ``jax.tree`` order (:mod:`repro_torch.tree`).  The
reference writes ``str(treedef)`` of JAX's tree structure as
``treedef``, which the port cannot make: the port writes a plain
description of the tree there instead, and neither side's ``restore``
reads it.

A model on a production mesh (``model=``, its ``mesh`` set) saves and
restores in the same format: :func:`save` gathers every leaf of the
ranks' blocks whole by the placement the model itself reads, its
``layer_pspec_fn`` (the parameters', and SSCA's ``lin`` and ``beta``
like them, as ``launch.sharding.state_shardings`` places them; its step
whole), one rank writes, the others wait at a barrier; and
:func:`restore` gives each rank its block of every leaf by the same
placement.  Such an archive is the one-device model's, read by either
side.  ``like`` holds the model's whole shapes: a leaf of another shape
(one rank's block handed over as if it were whole) raises before
anything is written.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import Device, placement, resolve_device

TREEDEF = ("repro_torch.ckpt: nested dicts keyed by the '/' paths in "
           "'keys' (JAX's treedef string is not written)")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by '/' path, in ``jax.tree`` order: dicts by sorted key,
    tuples by position (a NamedTuple's fields as ``.name``); None holds
    no leaf, as in ``jax.tree``."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None)
        items = [(f".{names[i]}" if names else str(i), v)
                 for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (tensor, array or scalar) → (numpy array, dtype name), bf16
    as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return leaf.numpy(), str(leaf.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(directory, tree: Any, *, step: int = 0, extra: dict = None,
         model=None, like: Any = None) -> int:
    """Write ``tree`` (nested dicts and tuples of tensors, arrays or
    scalars) under ``directory``; returns the archive's size in bytes.

    ``like``: a tree of the same paths whose leaves carry the whole
    shapes (tensors or meta tensors, e.g. ``launch.specs.param_specs``),
    each leaf to be written held to its shape; a mismatch raises
    ``ValueError``.  ``model``: on a production mesh, ``tree`` holds this
    rank's blocks, placed by the model's ``layer_pspec_fn``; every rank
    calls, each leaf is gathered whole over the mesh, the rank at the
    mesh's origin writes and the others wait at a barrier (the directory
    on a file system every rank sees).  A mesh save needs ``like``."""
    flat = _flatten(tree)
    mesh = None if model is None else model.mesh
    if mesh is not None:
        if like is None:
            raise ValueError("save on a production mesh checks the gathered "
                             "leaves against the model's whole shapes: pass "
                             "like= (e.g. launch.specs.param_specs(model))")
        flat = {k: placement.gather_block(v, _spec(model, k, v.shape), mesh)
                for k, v in flat.items()}
    if like is not None:
        _check_shapes(flat, _flatten(like))
    directory = Path(directory)
    if mesh is None or not any(mesh.coords):
        _write(directory, flat, step, extra)
    if mesh is not None:
        mesh.barrier()
    return (directory / "arrays.npz").stat().st_size


def _spec(model, path: str, shape) -> tuple:
    """The placement of the leaf at ``path`` on ``model``'s mesh: its
    ``layer_pspec_fn`` reads the leaf's name and rank only, so a block
    and the whole leaf have one spec."""
    return model.layer_pspec_fn(path, tuple(shape))


def _check_shapes(flat: Dict[str, Any], want: Dict[str, Any]) -> None:
    """Every leaf of ``flat`` at the shape of ``want``'s at its path."""
    if set(flat) != set(want):
        raise ValueError(f"save: the tree's paths differ from the model's "
                         f"at {sorted(set(flat) ^ set(want))}")
    for k, leaf in flat.items():
        got, shape = tuple(np.shape(leaf)), tuple(want[k].shape)
        if got != shape:
            raise ValueError(
                f"save: leaf {k} is {got}, the model's is {shape} (one "
                "rank's block? save a mesh's blocks with model=)")


def _write(directory: Path, flat: Dict[str, Any], step: int,
           extra: dict) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k.replace("/", "__")], dtypes[k] = _to_numpy(v)
    np.savez(directory / "arrays.npz", **arrays)
    manifest = {"step": int(step), "keys": list(flat), "dtypes": dtypes,
                "treedef": TREEDEF, "extra": extra or {}}
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=1))


def restore(directory, device: Device = None, *, model=None
            ) -> Tuple[Dict[str, Any], dict]:
    """(nested-dict tree of tensors on ``device``, manifest).  Keys with
    '/' are rebuilt into nested dicts, tuple positions and NamedTuple
    fields becoming dict keys, as the reference's ``restore`` does.
    ``model`` on a production mesh: each leaf is cut to this rank's block
    by the model's placement on the host before it moves to
    ``device``."""
    dev = resolve_device(device)
    mesh = None if model is None else model.mesh
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    out: Dict[str, Any] = {}
    with np.load(directory / "arrays.npz") as arrays:
        for key in manifest["keys"]:
            arr = arrays[key.replace("/", "__")]
            if manifest["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if mesh is not None:
                t = placement.local_block(t, _spec(model, key, t.shape), mesh)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.to(dev)
    return out, manifest


def latest(root) -> Path:
    """The ``step_N`` subdirectory of ``root`` with the largest N."""
    root = Path(root)
    cands = [p for p in root.iterdir()
             if p.is_dir() and p.name.startswith("step_")]
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {root}")
    return max(cands, key=lambda p: int(p.name.split("_")[1]))
