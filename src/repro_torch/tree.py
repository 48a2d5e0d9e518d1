"""Parameter trees: nested dicts of tensors, in ``jax.tree`` leaf order.

A tree is a tensor or a dict whose values are trees.  Its leaves are
visited in the reference's order: keys sorted, depth first.  The MLP's
``{"w1", "w2"}`` is a tree of depth one; the LM's ``{"blocks": {...},
"embed", "final_norm"}`` one of depth two.  That order fixes each
element's flat index, hence its PRF counter in the secure masks and in
qsgd's per-leaf counter bases, so every flatten of the port walks it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import torch

Tree = Union[torch.Tensor, Dict[str, Any]]


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree`` order: sorted keys, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like: Tree, values) -> Tree:
    """A tree of ``like``'s structure holding ``values`` (an iterable in
    leaf order) at its leaves."""
    return _build(like, list(values), 0)[0]


def _build(node, values, i):
    # a module-level recursion: a nested function calling itself would
    # sit in a reference cycle with the leaves and keep them alive until
    # the garbage collector ran (gigabytes at the LM's full width)
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            out[k], i = _build(node[k], values, i)
        return out, i
    return values[i], i + 1


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """``fn`` applied leaf by leaf (in leaf order) over trees of one
    structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def numel(tree: Tree) -> int:
    return sum(x.numel() for x in leaves(tree))
