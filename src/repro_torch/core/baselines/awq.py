"""AWQ (Lin et al., 2023): activation-aware weight scaling + RTN (twin of
``repro.core.baselines.awq``).

Per-input-channel scales s = stat^α lift the weights before RTN and are
divided back after; α is grid-searched to minimize the layer-output MSE
on calibration samples.  No mask, no learned factors: the paper's App.-B
comparison point.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.baselines.rtn import rtn_quantize


def awq_search(w: torch.Tensor, act_absmean: Optional[torch.Tensor],
               bits: int, x_sample: Optional[torch.Tensor] = None,
               grid: int = 20) -> Tuple[torch.Tensor, int]:
    """(fake-quant w (K, N), index g of the chosen α = g / grid).  The
    index is -1 when no grid point beats plain RTN (the initial
    candidate), or when there are no statistics."""
    if act_absmean is None:
        return rtn_quantize(w, bits), -1
    stat = act_absmean.to(torch.float32)
    stat = stat / (torch.mean(stat) + 1e-8) + 1e-4
    x = None
    if x_sample is not None and x_sample.numel():
        x = x_sample.to(torch.float32)
    wf = w.to(torch.float32)

    best_err, best, best_g = math.inf, rtn_quantize(w, bits), -1
    for g in range(grid):
        s = torch.pow(stat, g / grid)[:, None]             # (K, 1)
        wq = rtn_quantize(wf * s, bits).to(torch.float32) / s
        if x is None:
            err = torch.mean(torch.square(wq - wf))
        else:
            err = torch.mean(torch.square(x @ wq - x @ wf))
        err = float(err)
        if err < best_err:
            best_err, best, best_g = err, wq.to(w.dtype), g
    return best, best_g


def awq_quantize(w: torch.Tensor, act_absmean: Optional[torch.Tensor],
                 bits: int, x_sample: Optional[torch.Tensor] = None,
                 grid: int = 20) -> torch.Tensor:
    """Fake-quant w (K, N) with the best activation-aware scaling."""
    return awq_search(w, act_absmean, bits, x_sample, grid)[0]


def bits_per_weight(bits: int, k: int, n: int) -> float:
    # b-bit codes + fp16 scale/zero per output channel + fp16 s per
    # input channel
    return bits + (2 * n + k) * 16 / (k * n)
