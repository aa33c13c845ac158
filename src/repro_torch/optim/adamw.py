"""AdamW as PTQ1.61's block-wise scale learning uses it (twin of
``repro.optim.adamw`` at its defaults: b1 0.9, b2 0.999, eps 1e-8, zero
weight decay, no clipping, no schedule).

Written out rather than taken from ``torch.optim.AdamW`` so that each
step computes the reference's expression in the reference's order:
``p − lr·m̂ / (√v̂ + eps)`` with ``m̂ = m / (1 − b1^t)`` and
``v̂ = v / (1 − b2^t)``, moments in f32.  Parameters are dictionaries of
dictionaries of tensors (``blockwise.extract_scales``), updated out of
place under ``torch.no_grad``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import torch

Tree = Dict[str, Any]

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def _map(fn, *trees: Tree) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3

    def init(self, params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, _map(zeros, params), _map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree):
        step = state.step + 1
        # bias corrections in f32, as the reference computes them
        c1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** step)
        c2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** step)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m = B1 * m + (1 - B1) * gf
            v = B2 * v + (1 - B2) * (gf * gf)
            delta = (m / c1) / (torch.sqrt(v / c2) + EPS)
            return (p.to(torch.float32) - self.lr * delta).to(p.dtype), m, v

        out = _map(upd, grads, state.mu, state.nu, params)
        return (_pick(out, 0),
                AdamWState(step, _pick(out, 1), _pick(out, 2)))


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
