"""Parameter declaration and initialisation (twin of
``repro.models.param``, without the sharding axes).

Model init functions build a tree of :class:`P` leaves (shape, init
style, dtype); :func:`materialize` turns it into tensors on a device.
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
from typing import Any, Tuple

import torch

from repro_torch.core.select import map_tree


@dataclass(frozen=True)
class P:
    """Declarative parameter leaf."""

    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | scaled (fan-in)
    dtype: torch.dtype = torch.bfloat16


def _init_leaf(p: P, gen: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
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


def materialize(tree: Any, seed: int, device="cpu") -> Any:
    """P tree -> tensors on ``device``."""
    device = torch.device(device)

    def leaf(path, p):
        if not isinstance(p, P):
            return p
        key = "/".join(str(k) for k in path)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 1_000_003 + zlib.crc32(key.encode()))
                        % (2 ** 63))
        return _init_leaf(p, gen, device)

    return map_tree(tree, leaf)


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
