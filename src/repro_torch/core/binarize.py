"""Binarization with learnable scaling factors (paper §3.1, §3.3, Eq. 9).

    W_q' = (α_r1 × α_r2) ∘ (α_s · sign(W))

with α_s, α_r1 per output channel (N,) and α_r2 per input channel (K,).
The analytic init is α_s = mean |w| over the input dim, α_r1 = α_r2 = 1.
Weight convention is (K=in, N=out) throughout.
"""
from __future__ import annotations

from typing import Dict

import torch


def analytic_alpha(w: torch.Tensor) -> torch.Tensor:
    """α per output channel: mean |w| over the input dim. w: (..., K, N)."""
    return torch.mean(torch.abs(w.to(torch.float32)), dim=-2)


def binarize_init(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Signs + scale init for a (…, K, N) weight slice."""
    lead, k, n = w.shape[:-2], w.shape[-2], w.shape[-1]
    return {
        "sign": torch.where(w >= 0, 1.0, -1.0).to(torch.bfloat16),
        "alpha_s": analytic_alpha(w),
        "alpha_r1": torch.ones(lead + (n,), dtype=torch.float32,
                               device=w.device),
        "alpha_r2": torch.ones(lead + (k,), dtype=torch.float32,
                               device=w.device),
    }


def dequant_binary(sign: torch.Tensor, alpha_s: torch.Tensor,
                   alpha_r1: torch.Tensor, alpha_r2: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Eq. 9: (α_r1 × α_r2) ∘ (α_s sign(W)) -> (..., K, N)."""
    col = (alpha_s * alpha_r1)[..., None, :]
    row = alpha_r2[..., :, None]
    return (sign.to(torch.float32) * col * row).to(dtype)
