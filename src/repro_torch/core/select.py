"""Selection of quantizable weight leaves (twin of ``repro.core.select``).

PTQ1.61 quantizes the linear projection matrices of every block;
embeddings, the head, norms and biases stay in floating point.  The
port's parameter trees are nested dicts, lists and tuples of tensors, so
the walk is written out here.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

QUANT_NAMES = frozenset({
    "wq", "wk", "wv", "wo",
    "wg", "wu", "wd",
    "w_x", "w_gate", "w_out",
    "w_q", "w_k", "w_v",
    "w_gates", "w_up", "w_down",
})


def is_quantizable(path: Tuple, leaf, min_dim: int) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not path or path[-1] not in QUANT_NAMES:
        return False
    k, n = leaf.shape[-2], leaf.shape[-1]
    return k >= min_dim and n >= 16


def map_tree(tree: Any, fn: Callable[[Tuple, Any], Any],
             path: Tuple = ()) -> Any:
    """Rebuild ``tree`` with every non-container leaf replaced by
    ``fn(path, leaf)``.  Containers are dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree)


def map_quantizable(tree: Any, fn: Callable[[Tuple, Any], Any],
                    min_dim: int = 64) -> Any:
    """Replace each quantizable leaf by fn(path, leaf); others unchanged."""
    return map_tree(tree, lambda p, x: fn(p, x)
                    if is_quantizable(p, x, min_dim) else x)
