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
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device

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


def save(directory, tree: Any, *, step: int = 0, extra: dict = None) -> int:
    """Write ``tree`` (nested dicts and tuples of tensors, arrays or
    scalars) under ``directory``; returns the archive's size in bytes.
    The leaves are written as they are: a production mesh's parameters
    are saved whole, ``launch.sharding.gather_params`` first."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k.replace("/", "__")], dtypes[k] = _to_numpy(v)
    np.savez(directory / "arrays.npz", **arrays)
    manifest = {"step": int(step), "keys": list(flat), "dtypes": dtypes,
                "treedef": TREEDEF, "extra": extra or {}}
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return (directory / "arrays.npz").stat().st_size


def restore(directory, device: Device = None) -> Tuple[Dict[str, Any], dict]:
    """(nested-dict tree of tensors on ``device``, manifest).  Keys with
    '/' are rebuilt into nested dicts, tuple positions and NamedTuple
    fields becoming dict keys, as the reference's ``restore`` does."""
    dev = resolve_device(device)
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
