"""Structured 1-D salient-channel mask (paper §3.2).

Input channels are ranked by a saliency statistic and the top ρ of K are
kept at 4-bit; the rest binarize.  The salient-first channel permutation
derived from the mask (stable order) makes the packed layout contiguous:
``[0:k_s) int4 | [k_s:K) binary``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def round_salient(k: int, ratio: float, multiple: int) -> int:
    """Salient channel count: ratio·K rounded to a pack-friendly
    multiple, clamped to [multiple, K - multiple]."""
    k_s = int(round(ratio * k / multiple)) * multiple
    return max(multiple, min(k_s, k - multiple))


def structured_mask(saliency: torch.Tensor, ratio: float, multiple: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rank channels, return (mask bool (K,), perm (K,) salient-first, k_s).

    The top-k_s pick breaks ties toward the lower channel index, as
    ``jax.lax.top_k`` does, and ``perm`` is the stable salient-first
    order: salient channels in their original relative order, then the
    rest.
    """
    k = saliency.shape[-1]
    k_s = round_salient(k, ratio, multiple)
    top_idx = torch.argsort(-saliency, stable=True)[:k_s]
    mask = torch.zeros((k,), dtype=torch.bool, device=saliency.device)
    mask[top_idx] = True
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    return mask, order.to(torch.int32), k_s
