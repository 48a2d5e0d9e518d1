"""Parameter trees: nested dicts and tuples of tensors, in ``jax.tree``
leaf order.

A tree is a tensor, a dict whose values are trees, or a tuple of trees.
Its leaves are visited in the reference's order, depth first: dicts by
sorted key, tuples by position.  The MLP's ``{"w1", "w2"}`` is a tree of
depth one; the LM's ``{"blocks": {...}, "embed", "final_norm"}`` one of
depth two; Algorithm 2's upload ``(value, {"w1", "w2"})`` a tuple whose
value is leaf 0.  That order fixes each
element's flat index, hence its PRF counter in the secure masks and in
qsgd's per-leaf counter bases, so every flatten of the port walks it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Union

import torch

Tree = Union[torch.Tensor, Dict[str, Any], Sequence[Any]]


def _children(node):
    """The subtrees of an inner node in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, tuple):
        return list(node)
    return None


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree`` order: depth first, dicts by sorted
    key, tuples by position."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for k in kids for x in leaves(k)]


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
    if isinstance(node, tuple):
        kids = []
        for k in node:
            kid, i = _build(k, values, i)
            kids.append(kid)
        if hasattr(node, "_fields"):                 # a NamedTuple
            return type(node)(*kids), i
        return tuple(kids), i
    return values[i], i + 1


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """``fn`` applied leaf by leaf (in leaf order) over trees of one
    structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def numel(tree: Tree) -> int:
    return sum(x.numel() for x in leaves(tree))


def vdot(a: Tree, b: Tree) -> torch.Tensor:
    """Σ over leaves of ⟨a, b⟩, leaf by leaf in leaf order."""
    return sum(torch.sum(x * y) for x, y in zip(leaves(a), leaves(b)))


def sq_norm(a: Tree) -> torch.Tensor:
    """‖a‖² over all leaves, leaf by leaf in leaf order."""
    return sum(torch.sum(x * x) for x in leaves(a))


def named_leaves(tree, prefix=""):
    """(path "a/b", leaf) of a tree of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def rebuild(tree, values: dict, prefix=""):
    """``tree``'s structure with the leaf at path p taken from
    ``values[p]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    return values[prefix[:-1]]
