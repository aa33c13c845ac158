"""Block-wise scaling-factor optimization (paper §3.3, Eq. 5–7; twin of
``repro.core.blockwise``).

Two-branch objective per transformer block:

    argmin_{α_s, α_r1, α_r2}  E(F(X, W),  F(X_q, W_q'))    # error propagation
                            + E(F(X_q, W), F(X_q, W_q'))    # same-input distortion
with  E(f1, f2) = ‖f1 − f2‖₂² + D_NLC(f1, f2)               (Eq. 5)
      D_NLC     = −log(cosine_similarity(f1, f2))           (Eq. 6)

X is the full-precision calibration stream and X_q the quantized stream.
Only the three scale fields of each QLinear are learnable; signs and
int4 codes stay fixed.  AdamW, zero weight decay, lr 5e-4 for α_s and
1e-3 for α_r1 / α_r2 as the reference implements it: the angular
factors' gradients are scaled by ``lr_r / lr`` and one optimizer runs at
``lr``.  (Adam's update does not depend on the gradient's scale apart
from eps, so all three train at about ``lr``; kept for parity.)

The loss runs on :class:`~repro_torch.core.qlinear.DequantView`s: the
reference takes its gradients through ``QLinear.__matmul_permuted__``,
the dequantize-then-matmul product, and so does the port.  The packed
kernel gives no gradients and is never on this path.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core.qlinear import (DequantView, QLinear, QuantConfig,
                                      scale_params, with_scales)
from repro_torch.core.select import map_tree
from repro_torch.optim.adamw import AdamW

Tree = Any
BlockFn = Callable[[Tree, torch.Tensor], torch.Tensor]


def nlc(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Negative-log cosine similarity over the feature dim (Eq. 6).  The
    cosine is clamped to [1e-3, 1] with ``torch.clamp``, whose gradient
    is zero outside the range, as the reference's ``jnp.clip``."""
    a, b = f1.to(torch.float32), f2.to(torch.float32)
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + 1e-8
    c = torch.clamp(num / den, 1e-3, 1.0)
    return -torch.mean(torch.log(c))


def metric(f1: torch.Tensor, f2: torch.Tensor, cosine: bool = True
           ) -> torch.Tensor:
    """Eq. 5 distance: MSE + NLC."""
    d = f1.to(torch.float32) - f2.to(torch.float32)
    m = torch.mean(d * d)
    return m + nlc(f1, f2) if cosine else m


def _is_scaled(x) -> bool:
    return isinstance(x, (QLinear, DequantView))


def extract_scales(q_block: Tree) -> Dict[Tuple, Dict[str, torch.Tensor]]:
    """{path: {"alpha_s", "alpha_r1", "alpha_r2"}} of every QLinear or
    view in the block."""
    out = {}

    def visit(path, leaf):
        if _is_scaled(leaf):
            out[path] = scale_params(leaf)
        return leaf
    map_tree(q_block, visit)
    return out


def inject_scales(q_block: Tree, scales: Dict[Tuple, Dict]) -> Tree:
    return map_tree(q_block, lambda path, leaf: with_scales(
        leaf, scales[path]) if _is_scaled(leaf) else leaf)


def dequant_views(q_block: Tree, dtype) -> Tree:
    """The block with every QLinear replaced by its DequantView in
    ``dtype``: what :func:`block_loss` and :func:`optimize_block_scales`
    take."""
    return map_tree(q_block, lambda _, leaf: leaf.dequant_view(dtype)
                    if isinstance(leaf, QLinear) else leaf)


def block_loss(block_fn: BlockFn, fp_block: Tree, views: Tree,
               x_fp: List[torch.Tensor], x_q: List[torch.Tensor],
               qcfg: QuantConfig) -> float:
    """The Eq.-7 objective averaged over the calibration batches, at the
    views' current scales (no learning)."""
    total = 0.0
    with torch.no_grad():
        for xf, xq in zip(x_fp, x_q):
            yq = block_fn(views, xq)
            total += float(metric(block_fn(fp_block, xf), yq,
                                  qcfg.cosine_loss)
                           + metric(block_fn(fp_block, xq), yq,
                                    qcfg.cosine_loss))
    return total / max(1, len(x_q))


def _refuse_packed(path, leaf):
    if isinstance(leaf, QLinear):
        raise TypeError(f"{path}: scale learning takes DequantViews "
                        "(dequant_views); the packed kernel gives no "
                        "gradients")
    return leaf


def optimize_block_scales(block_fn: BlockFn, fp_block: Tree, views: Tree,
                          x_fp: List[torch.Tensor], x_q: List[torch.Tensor],
                          qcfg: QuantConfig) -> Tree:
    """Learn the α's of every DequantView in ``views`` (Eq. 7) and return
    the views with them.

    block_fn(params, x) -> block output (the embedding function F).
    x_fp / x_q: per-calibration-batch input streams.  ``views`` comes
    from :func:`dequant_views`; a QLinear in it is refused.
    """
    map_tree(views, _refuse_packed)
    scales0 = extract_scales(views)
    if not scales0 or not qcfg.learn_scales:
        return views

    # fixed targets per batch: F(X, W) and F(X_q, W)
    with torch.no_grad():
        targets = [(block_fn(fp_block, xf), block_fn(fp_block, xq))
                   for xf, xq in zip(x_fp, x_q)]

    opt = AdamW(lr=qcfg.lr)
    opt_state = opt.init(scales0)
    r_gain = qcfg.lr_r / qcfg.lr
    scales = scales0
    for _ in range(qcfg.steps):
        for xq, (y1, y2) in zip(x_q, targets):
            leaves = {k: {f: t.detach().requires_grad_(True)
                          for f, t in g.items()} for k, g in scales.items()}
            yq = block_fn(inject_scales(views, leaves), xq)
            loss = (metric(y1, yq, qcfg.cosine_loss)
                    + metric(y2, yq, qcfg.cosine_loss))
            loss.backward()
            # per-group lr: angular factors train faster (paper: 5e-4 / 1e-3)
            grads = {k: {"alpha_s": g["alpha_s"].grad,
                         "alpha_r1": g["alpha_r1"].grad * r_gain,
                         "alpha_r2": g["alpha_r2"].grad * r_gain}
                     for k, g in leaves.items()}
            scales, opt_state = opt.update(
                grads, opt_state, {k: {f: t.detach() for f, t in g.items()}
                                   for k, g in leaves.items()})
    return inject_scales(views, scales)
