"""Single matmul entry points (twin of ``repro.models.linear``).

``dense(x, w)`` takes a plain (K, N) tensor or any quantized weight
object exposing ``__matmul_x__(x)`` (``QLinear``, ``QLinearGroup``);
``expert_dense(x, w)`` is the per-expert batched product over stacked
(E, K, N) weights or objects exposing ``__expert_matmul__(x)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def dense(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    if hasattr(w, "__matmul_x__"):
        y = w.__matmul_x__(x)
    else:
        y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def expert_dense(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert batched matmul: x (E, C, K) @ w (E, K, N) -> (E, C, N)."""
    if hasattr(w, "__expert_matmul__"):
        return w.__expert_matmul__(x)
    return x @ w.to(x.dtype)
