"""Single matmul entry point (twin of ``repro.models.linear``).

``dense(x, w)`` takes a plain (K, N) tensor or any quantized weight
object exposing ``__matmul_x__(x)`` (``QLinear``, ``QLinearGroup``).
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
