"""Trees of tensors walked in the reference's leaf order.

JAX flattens a tree depth first: dict keys sorted, lists, tuples and
NamedTuples in order, a registered class by its children, ``None`` as
a node without leaves.  ``jax.tree_util.keystr`` names a leaf's path
``['k']`` for a dict key, ``[i]`` for a list or tuple index, ``.name``
for a NamedTuple field and ``[<flat index i>]`` for the i-th child of a
class registered with ``register_pytree_node_class`` (a ``QLinear``'s
eight fields in ``FIELDS`` order, a ``QLinearGroup``'s inner).  The
checkpoint store, the optimizer and the gradient compressor walk the
port's trees the same way, so a leaf has the reference's index and path.

A :class:`Layers` is one leaf made of several tensors: a stage leaf
that the reference stacks on a leading layer axis, held as the port's
per-layer tensors (``bridge.layer_groups``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

from repro_torch.core.qlinear import FIELDS, QLinear, QLinearGroup

Tree = Any


class Layers(tuple):
    """The per-layer parts of one stacked leaf, walked as one leaf."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container in flatten order, or None for
    a leaf."""
    if node is None:
        return []
    if isinstance(node, Layers):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if isinstance(node, QLinear):
        return [(f"[<flat index {i}>]", getattr(node, f))
                for i, f in enumerate(FIELDS)]
    if isinstance(node, QLinearGroup):
        return [("[<flat index 0>]", node.inner)]
    return None


def leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out.extend(leaves_with_path(child, prefix + key))
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def _rebuild(node, it: Iterator):
    if node is None:
        return None
    if isinstance(node, Layers):
        return next(it)
    if isinstance(node, dict):
        vals = {k: _rebuild(node[k], it) for k in sorted(node)}
        return {k: vals[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), it)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)([_rebuild(v, it) for v in node])
    if isinstance(node, QLinear):
        return dataclasses.replace(
            node, **{f: _rebuild(getattr(node, f), it) for f in FIELDS})
    if isinstance(node, QLinearGroup):
        return QLinearGroup(_rebuild(node.inner, it), node.splits)
    return next(it)


def unflatten(tree: Tree, new_leaves) -> Tree:
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
