"""Carry a ``repro`` parameter tree across to the port.

The input is ``repro``'s tree with every array already turned into a
numpy array (the caller does ``np.asarray`` on the JAX side, so this
module needs no JAX): nested dicts, lists and tuples, with ``QLinear``
and ``QLinearGroup`` objects recognised by their fields.  bf16 arrays
cross through a 16-bit integer view.

``repro`` stacks each stage's layers on a leading axis and scans them;
the port keeps one entry per layer, so stage trees are split along that
axis here (``stages[s][pattern_pos][leaf][layer]`` becomes
``stages[s][layer][pattern_pos][leaf]``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.qlinear import FIELDS, QLinear, QLinearGroup

Tree = Any


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (bf16 included, as ``ml_dtypes.bfloat16``) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_qlinear(x) -> bool:
    return all(hasattr(x, f) for f in FIELDS + ("k_s", "k", "n"))


def _is_group(x) -> bool:
    return hasattr(x, "inner") and hasattr(x, "splits")


def convert(tree: Tree, device="cpu") -> Tree:
    """Convert leaves: arrays -> tensors, QLinear / QLinearGroup ->
    their torch twins.  Structure is kept as it is."""
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


def params_from_repro(tree: Tree, device="cpu") -> Tree:
    """A ``repro`` model parameter tree (numpy leaves) -> the port's
    per-layer parameter tree on ``device``."""
    t = convert(tree, device)
    out = dict(t)
    out["stages"] = []
    for stage in t["stages"]:
        n = _n_layers(stage[0])
        out["stages"].append([tuple(_layer(bp, i) for bp in stage)
                              for i in range(n)])
    return out
