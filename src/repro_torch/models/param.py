"""Parameter declaration and initialisation (twin of
``repro.models.param``).

Model init functions build a tree of :class:`P` leaves (shape, logical
sharding axes, init style, dtype); :func:`materialize` turns it into
tensors on a device, and ``repro_torch.distributed.sharding`` turns the
axes into a spec per leaf for any mesh.

Logical axis vocabulary (the reference's):
  "embed"     model width (d_model)            -> FSDP (data) or replicated
  "heads"     attention query heads x head_dim -> TP ("model")
  "kv_heads"  kv heads x head_dim              -> TP ("model"), replicated
                                                  to the TP degree at run
                                                  time by the model
  "ffn"       MLP hidden                       -> TP ("model")
  "vocab"     vocabulary                       -> TP ("model")
  "experts"   MoE expert dim                   -> EP ("model") or none
  "rnn"       recurrence width                 -> TP ("model")
  None        replicated small vectors

The port keeps a stage's layers as a list, so its leaves carry no
"layers" axis: the reference's stacked leaf has ``("layers",) + axes``.
Each leaf draws from its own ``torch.Generator`` seeded from the run
seed and a crc32 of the leaf's path, so init does not depend on tree
order or on the process.  ``jax.random`` streams cannot be reproduced:
tests that compare with ``repro`` carry ``repro``'s weights across with
``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.select import map_tree


@dataclass(frozen=True)
class P:
    """Declarative parameter leaf."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | neg_ones | scaled
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def _init_leaf(p: P, gen: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "neg_ones":
        return torch.full(p.shape, -1, dtype=p.dtype, device=device)
    if p.init in ("normal", "scaled"):
        if p.init == "normal":
            std = 0.02
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
        w = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * std).to(p.dtype)
    raise ValueError(f"unknown init {p.init!r}")


def materialize(tree: Any, seed: int, device="cpu",
                prefix: Tuple = ()) -> Any:
    """P tree -> tensors on ``device``.  A subtree given with its
    ``prefix`` (its path in the whole tree) gets the tensors a whole
    materialize gives it, so a model too large to hold in bf16 can be
    built part by part."""
    device = torch.device(device)

    def leaf(path, p):
        if not isinstance(p, P):
            return p
        key = "/".join(str(k) for k in path)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 1_000_003 + zlib.crc32(key.encode()))
                        % (2 ** 63))
        return _init_leaf(p, gen, device)

    return map_tree(tree, leaf, tuple(prefix))


def count_params(tree: Any) -> int:
    """Elements of every P leaf of a declaration tree."""
    n = 0

    def leaf(_, p):
        nonlocal n
        if isinstance(p, P):
            n += math.prod(p.shape)
        return p

    map_tree(tree, leaf)
    return n


def tree_to(tree: Any, device=None, float_dtype=None) -> Any:
    """Move every tensor of a parameter tree (packed ``QLinear`` fields
    and ``QLinearGroup`` inners included) to ``device``; with
    ``float_dtype``, also cast bf16 tensors to that dtype (packed fields
    keep their own dtypes)."""
    from repro_torch.core.qlinear import QLinear, QLinearGroup

    def move(t: torch.Tensor) -> torch.Tensor:
        if float_dtype is not None and t.dtype == torch.bfloat16:
            t = t.to(float_dtype)
        return t if device is None else t.to(device)

    def leaf(_, x):
        if isinstance(x, QLinearGroup):
            return QLinearGroup(leaf(None, x.inner), x.splits)
        if isinstance(x, QLinear):
            return x.map(move)
        if isinstance(x, torch.Tensor):
            return move(x)
        return x

    return map_tree(tree, leaf)


def stack_p(tree: Any, n: int) -> Any:
    """Prepend a stacked ``layers`` dim of ``n`` to every P leaf (the
    reference's ``transformer.stack_p``; decode caches keep the
    reference's stacked layout)."""
    return map_tree(tree, lambda _, p: P((n,) + p.shape, ("layers",) + p.axes,
                                         p.init, p.dtype)
                    if isinstance(p, P) else p)
