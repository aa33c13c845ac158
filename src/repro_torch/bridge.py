"""Carry a ``repro`` parameter tree across to the port.

The input is ``repro``'s tree with every array already turned into a
numpy array (the caller does ``np.asarray`` on the JAX side, so this
module needs no JAX): nested dicts, lists and tuples, with ``QLinear``
and ``QLinearGroup`` objects recognised by their fields.  bf16 arrays
cross through a 16-bit integer view.

``repro`` stacks each stage's layers on a leading axis and scans them;
the port keeps one entry per layer, so stage trees are split along that
axis here (``stages[s][pattern_pos][leaf][layer]`` becomes
``stages[s][layer][pattern_pos][leaf]``), an encoder-decoder model's
``enc.stages`` too.  Decode caches keep the reference's layout (per
stage and pattern position, tensors stacked over layers; ``{"self",
"xk", "xv"}`` for a cross-attention block), so ``convert`` carries
them across as they are.

:func:`params_to_repro` goes the other way: it stacks each stage's
per-layer entries on a leading axis, so a port tree takes the
reference's paths, shapes and dtypes (the checkpoint layout of
``checkpoint/store.py``).  With ``stack=Layers`` it stacks nothing and
groups each stage leaf's per-layer tensors instead:
:func:`layer_groups` lists those groups in the reference's leaf order,
which the gradient compressor, the clipping norm and ``wire_bytes``
walk as the reference walks its stacked leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.qlinear import FIELDS, QLinear, QLinearGroup
from repro_torch.pytree import Layers

Tree = Any


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (bf16 included, as ``ml_dtypes.bfloat16``) -> tensor;
    a tensor moves to ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a, order="C")      # a copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _is_qlinear(x) -> bool:
    return all(hasattr(x, f) for f in FIELDS + ("k_s", "k", "n"))


def _is_group(x) -> bool:
    return hasattr(x, "inner") and hasattr(x, "splits")


def convert(tree: Tree, device="cpu") -> Tree:
    """Convert leaves: arrays -> tensors, QLinear / QLinearGroup ->
    their torch twins; tensors move to ``device``.  Structure is kept as
    it is."""
    if _is_group(tree):
        return QLinearGroup(convert(tree.inner, device),
                            tuple(int(s) for s in tree.splits))
    if _is_qlinear(tree):
        return QLinear(*(to_tensor(getattr(tree, f), device)
                         for f in FIELDS),
                       k_s=int(tree.k_s), k=int(tree.k), n=int(tree.n))
    if isinstance(tree, dict):
        return {k: convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert(v, device) for v in tree)
    return to_tensor(tree, device)


def _layer(tree: Tree, i: int) -> Tree:
    if isinstance(tree, QLinearGroup):
        return QLinearGroup(_layer(tree.inner, i), tree.splits)
    if isinstance(tree, QLinear):
        return tree.map(lambda t: t[i].contiguous())
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_layer(v, i) for v in tree)
    return tree[i].contiguous()


def _n_layers(tree: Tree) -> int:
    if isinstance(tree, QLinearGroup):
        return _n_layers(tree.inner)
    if isinstance(tree, QLinear):
        return tree.perm.shape[0]
    if isinstance(tree, dict):
        return _n_layers(next(iter(tree.values())))
    return tree.shape[0]


def _unstack_stages(stages) -> list:
    return [[tuple(_layer(bp, i) for bp in stage)
             for i in range(_n_layers(stage[0]))] for stage in stages]


def params_from_repro(tree: Tree, device="cpu") -> Tree:
    """A ``repro`` model parameter tree (numpy or tensor leaves, stacked
    stages) -> the port's per-layer parameter tree on ``device``.  A
    tree without ``stages`` (a 0-d residual) is converted alone."""
    t = convert(tree, device)
    if not isinstance(t, dict) or "stages" not in t:
        return t
    out = dict(t)
    out["stages"] = _unstack_stages(t["stages"])
    if "enc" in t:
        out["enc"] = dict(t["enc"], stages=_unstack_stages(t["enc"]["stages"]))
    return out


def _stack_layers(layers: List[Tree], stack: Callable) -> Tree:
    first = layers[0]
    if isinstance(first, QLinearGroup):
        return QLinearGroup(_stack_layers([x.inner for x in layers], stack),
                            first.splits)
    if isinstance(first, QLinear):
        return dataclasses.replace(first, **{
            f: stack([getattr(x, f) for x in layers]) for f in FIELDS})
    if isinstance(first, dict):
        return {k: _stack_layers([x[k] for x in layers], stack)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)([_stack_layers([x[i] for x in layers], stack)
                            for i in range(len(first))])
    return stack(list(layers))


def _stack_stages(stages, stack: Callable) -> list:
    return [tuple(_stack_layers([layer[pos] for layer in stage], stack)
                  for pos in range(len(stage[0]))) for stage in stages]


def params_to_repro(tree: Tree, stack: Callable = torch.stack) -> Tree:
    """The inverse of :func:`params_from_repro` (on tensors): each
    stage's per-layer entries stacked on a leading axis by ``stack``, as
    the reference scans them (``stages[s][layer][pos]`` becomes
    ``stages[s][pos]``, ``enc.stages`` too).  Other leaves are kept as
    they are, and a tree without ``stages`` is returned unchanged."""
    if not isinstance(tree, dict) or "stages" not in tree:
        return tree
    out = dict(tree)
    out["stages"] = _stack_stages(tree["stages"], stack)
    if "enc" in tree:
        out["enc"] = dict(tree["enc"],
                          stages=_stack_stages(tree["enc"]["stages"], stack))
    return out


def layer_groups(tree: Tree) -> list:
    """The reference's leaves of a port tree, in its order: a tensor, or
    a :class:`~repro_torch.pytree.Layers` of a stage leaf's per-layer
    tensors."""
    return pytree.leaves(params_to_repro(tree, stack=Layers))
