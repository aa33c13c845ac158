"""AdamW with decoupled weight decay, global-norm clipping and schedules
(twin of ``repro.optim.adamw``).

Used by the training launcher (weight decay 0.01, clipping at 1.0, the
cosine schedule) and, at the defaults (no weight decay, clipping or
schedule), by PTQ1.61's block-wise scale learning and restorative-LoRA
preprocessing.  b1 0.9, b2 0.999 and eps 1e-8 are the reference's
defaults, which no caller of either package changes.

Written out rather than taken from ``torch.optim.AdamW`` so that each
step computes the reference's expression in the reference's order:
``p − lr·(m̂ / (√v̂ + eps) + wd·p)`` with ``m̂ = m / (1 − b1^t)`` and
``v̂ = v / (1 − b2^t)``, moments in f32.  The step counter is a 0-d
int32 tensor; ``t``, the bias corrections, the clipping scale and the
schedule are f32 tensors with tensor divisors, as the reference's jitted
``step.astype(f32)`` computes them (a Python float is f64, and a CUDA
tensor divided by a Python scalar is multiplied by its reciprocal).
On the CPU, ``torch.pow`` of two 0-d f32 tensors gives XLA's f32
``b ** t`` for b2 at every step up to 3000 and for b1 until b1^t is
subnormal (an integer power does not: ``0.999 ** 3`` is one ulp off).

Clipping promotes each gradient to f32 before it scales it, as JAX's
``g * scale`` with a strong f32 scale does; torch would keep a bf16
gradient bf16.  The promotion happens leaf by leaf inside the update,
so no f32 copy of every gradient is held at once.  The clipping norm
sums the reference's leaves in its order: a stage leaf's layers
(stacked in the reference) are summed first, then added as one leaf.

Trees are dicts, lists and tuples of tensors, walked in the reference's
order (``repro_torch.pytree``).  A leaf may be a ``DTensor`` (the
sharded train step's state): the update runs on its local part, and
the clipping norm sums each leaf's squares over the mesh dims it is
sharded on and no others, so a replicated part counts once and every
rank clips by the reference's global norm.

:meth:`AdamW.update_` writes the new
parameters and moments into the given tensors (the trainer's state is
too large to hold twice; the reference donates it);
:meth:`AdamW.update` runs it on copies.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import pytree
from repro_torch.bridge import layer_groups
from repro_torch.distributed.collectives import all_reduce_
from repro_torch.distributed.sharding import like, local, shard_groups

Tree = Any
F32 = torch.float32

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, params: Tree) -> AdamWState:
        ps = pytree.leaves(params)
        dev = ps[0].device if ps else None

        def zeros(p):
            lp = local(p)
            return like(p, torch.zeros(lp.shape, dtype=F32,
                                       device=lp.device))
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          pytree.tree_map(zeros, params),
                          pytree.tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree):
        """(new params, new state), the inputs left as they are."""
        def copy(tree):
            return pytree.tree_map(torch.clone, tree)
        return self.update_(grads, AdamWState(state.step, copy(state.mu),
                                              copy(state.nu)), copy(params))

    @torch.no_grad()
    def update_(self, grads: Tree, state: AdamWState, params: Tree):
        """:meth:`update` written into ``params`` and the moments, leaf
        by leaf."""
        step = state.step + 1
        dev = step.device
        t = step.to(F32)
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(_f32(self.clip_norm, dev) / (gnorm + 1e-9),
                                max=1.0)
        lr = (self.lr if self.schedule is None
              else _f32(self.lr, dev) * self.schedule(step))
        c1 = 1 - torch.pow(_f32(B1, dev), t)
        c2 = 1 - torch.pow(_f32(B2, dev), t)
        for g, m, v, p in zip(pytree.leaves(grads), pytree.leaves(state.mu),
                              pytree.leaves(state.nu),
                              pytree.leaves(params)):
            g, m, v, p = local(g), local(m), local(v), local(p)
            gf = g.to(F32) if scale is None else g.to(F32) * scale
            # b·m + (1 − b)·g, rounded as the reference's expression
            m.mul_(B1).add_((1 - B1) * gf)
            v.mul_(B2).add_((1 - B2) * (gf * gf))
            delta = (m / c1) / (torch.sqrt(v / c2) + EPS)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(F32)
            p.copy_(p.to(F32) - lr * delta)
        return params, AdamWState(step, state.mu, state.nu)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares, leaf by leaf in the reference's
    order (a stage leaf's layers summed first; a sharded leaf's local
    sum summed over the ranks holding its other parts)."""
    def sq(t):
        return torch.sum(torch.square(local(t).to(F32)))
    total = 0
    for g in layer_groups(tree):
        layers = isinstance(g, pytree.Layers)
        v = sum(sq(t) for t in g) if layers else sq(g)
        for grp in shard_groups(g[0] if layers else g):
            v = all_reduce_(v.clone(), grp)
        total = total + v
    return torch.sqrt(total)


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to 1 over ``warmup`` steps, then a cosine down to
    ``floor`` at ``total``; f32 in, f32 out."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(F32)
        dev = s.device
        warm = s / _f32(max(1, warmup), dev)
        prog = torch.clamp((s - warmup) / _f32(max(1, total - warmup), dev),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn
