"""Gradient compression with error feedback (twin of
``repro.distributed.compression``).

The compressor runs as a quantize→dequantize transform on the averaged
gradient tree with an error-feedback residual carried in the train
state; applied to the averaged gradient it equals compressing each
replica's contribution to a compressed all-reduce (EF-SGD, Karimireddy
et al., 2019).

Two compressors:
  * ``int8``: per-tensor absmax int8 (8× wire reduction)
  * ``topk``: magnitude top-k% sparsification (k default 10%)

A tensor here is one leaf of the reference: the reference stacks a
stage's layers on a leading axis, so its absmax, its top-k threshold
and its ``wire_bytes`` term are taken over all of a stage's layers at
once.  The port keeps one tensor per layer and groups them back
(``bridge.layer_groups``): one absmax, one threshold and one "+4" per
stacked leaf, as in the reference.

The gradients and the residual are updated in place (the trainer's
state is too large to hold twice; the reference donates it): pass
copies to keep the inputs.

A leaf may be a ``DTensor`` (the sharded train step's ZeRO state): the
transform runs on its local part with the reference's whole-leaf
statistics.  int8's absmax is the max over the ranks that hold the
leaf's other parts; top-k's threshold is the k-th largest |g| of the
whole leaf, found without gathering it by a bisection over the f32 bit
patterns of |g| (non-negative floats order as their bits), one summed
count per step: 31 all-reduces of one integer per sharded leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.bridge import layer_groups
from repro_torch.distributed.collectives import all_reduce_
from repro_torch.distributed.sharding import like, local, shard_groups

Tree = Any
F32 = torch.float32


@dataclass(frozen=True)
class CompressionConfig:
    kind: Optional[str] = None     # None | "int8" | "topk"
    topk_frac: float = 0.1


def init_residual(grads: Tree) -> Tree:
    def zeros(g):
        lg = local(g)
        return like(g, torch.zeros(lg.shape, dtype=F32, device=lg.device))
    return pytree.tree_map(zeros, grads)


def _parts(group) -> List[torch.Tensor]:
    return list(group) if isinstance(group, pytree.Layers) else [group]


def _int8_scale(gf: Iterable[torch.Tensor], groups=()) -> torch.Tensor:
    """absmax / 127 over the whole leaf; the parts come one at a time,
    and the max is taken over ``groups`` too."""
    amax = torch.stack([torch.max(torch.abs(x)) for x in gf]).max()
    for g in groups:
        amax = all_reduce_(amax.clone(), g, "max")
    return amax / torch.tensor(127.0, dtype=F32, device=amax.device) + 1e-12


def _int8_qdq(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def _topk_thresh(gf: Iterable[torch.Tensor], frac: float) -> torch.Tensor:
    """The k-th largest |g| over the whole leaf, k = max(1, ⌊size·frac⌋)
    (``jax.lax.top_k(|g|, k)[0][-1]``): the least of the k largest.
    ``torch.kthvalue`` gives the same value but selects with one thread
    block per slice on CUDA (2.2 s for the 311 M |g| of qwen2.5-3b's
    embedding, ``chip_smoke.py``'s ``[train topk]`` on an NVIDIA H100
    80GB HBM3 at 700 W); ``torch.topk`` selects across blocks."""
    flat = torch.cat([torch.abs(x).reshape(-1) for x in gf])
    k = max(1, int(flat.numel() * frac))
    return torch.topk(flat, k, sorted=False).values.min()


def _topk_thresh_sharded(gf: List[torch.Tensor], frac: float, size: int,
                         groups) -> torch.Tensor:
    """:func:`_topk_thresh` of a leaf of ``size`` elements whose local
    parts are ``gf``: the largest t with at least k elements of |g| >= t
    over ``groups`` is the k-th largest |g| itself."""
    k = max(1, int(size * frac))
    bits = [torch.abs(x).reshape(-1).view(torch.int32) for x in gf]
    lo, hi = 0, 0x7F800000                   # 0.0 .. +inf
    while lo < hi:
        mid = (lo + hi + 1) // 2
        c = sum(torch.count_nonzero(b >= mid) for b in bits)
        for g in groups:
            c = all_reduce_(c.clone(), g)
        lo, hi = (mid, hi) if int(c) >= k else (lo, mid - 1)
    return torch.tensor(lo, dtype=torch.int32,
                        device=bits[0].device).view(F32)


def compress(grads: Tree, residual: Tree,
             ccfg: CompressionConfig) -> Tuple[Tree, Tree]:
    """(compressed grads, new residual).  No-op when kind is None."""
    if ccfg.kind is None:
        return grads, residual
    if ccfg.kind not in ("int8", "topk"):
        raise ValueError(ccfg.kind)
    for g, r in zip(layer_groups(grads), layer_groups(residual)):
        groups = shard_groups(_parts(g)[0])
        size = sum(x.numel() for x in _parts(g))
        gs = [local(x) for x in _parts(g)]
        rs = [local(y) for y in _parts(r)]
        if ccfg.kind == "int8":
            scale = _int8_scale((x.to(F32) + y for x, y in zip(gs, rs)),
                                groups)
        elif groups:
            thresh = _topk_thresh_sharded(
                [x.to(F32) + y for x, y in zip(gs, rs)], ccfg.topk_frac,
                size, groups)
        else:
            thresh = _topk_thresh((x.to(F32) + y for x, y in zip(gs, rs)),
                                  ccfg.topk_frac)
        for x, y in zip(gs, rs):
            gf = x.to(F32) + y
            dq = (_int8_qdq(gf, scale) if ccfg.kind == "int8"
                  else torch.where(torch.abs(gf) >= thresh, gf, 0.0))
            x.copy_(dq)
            torch.sub(gf, dq, out=y)
    return grads, residual


def wire_bytes(grads: Tree, ccfg: CompressionConfig) -> int:
    """Bytes a compressed DP all-reduce would move per replica."""
    total = 0
    for g in layer_groups(grads):
        size = sum(x.numel() for x in _parts(g))
        if ccfg.kind == "int8":
            total += size + 4
        elif ccfg.kind == "topk":
            total += int(size * ccfg.topk_frac) * (4 + 4)
        else:
            total += size * 4
    return total
