"""Calibration-time activation statistics (twin of the absmean / sqmean
part of ``repro.core.calibrate``).

The structured mask (paper §3.2) ranks the input channels of each linear
by E[|x_i|] over the calibration set.  :func:`collect_stats` swaps every
quantizable weight for a recording :class:`StatsWeight` and runs the
block forward over the calibration batches; the wrapper computes the
same matmul, so the forward is unchanged.  The running sums stay on the
tensors' device: nothing is copied to the host per call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core.select import map_quantizable

Tree = Any


class StatsWeight:
    """Drop-in weight that records per-input-channel Σ|x| and Σx²."""

    def __init__(self, w: torch.Tensor):
        self.w = w
        self.sum_abs = None
        self.sum_sq = None
        self.count = 0

    def _record(self, x: torch.Tensor) -> None:
        xf = x.to(torch.float32).reshape(-1, x.shape[-1])
        s_abs = torch.sum(torch.abs(xf), dim=0)
        s_sq = torch.sum(xf * xf, dim=0)
        if self.sum_abs is None:
            self.sum_abs, self.sum_sq = s_abs, s_sq
        else:
            self.sum_abs = self.sum_abs + s_abs
            self.sum_sq = self.sum_sq + s_sq
        self.count += xf.shape[0]

    def __matmul_x__(self, x: torch.Tensor) -> torch.Tensor:
        self._record(x)
        return x @ self.w.to(x.dtype)

    def _mean(self, total: torch.Tensor) -> torch.Tensor:
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, one ulp away from the reference's quotient
        return total / torch.full_like(total, max(1, self.count))

    @property
    def absmean(self) -> torch.Tensor:
        return self._mean(self.sum_abs)

    @property
    def sqmean(self) -> torch.Tensor:
        return self._mean(self.sum_sq)


def collect_stats(forward: Callable[[Tree, Any], Any], params: Tree,
                  batches: List[Any], min_dim: int = 64
                  ) -> Dict[Tuple, torch.Tensor]:
    """Run ``forward(wrapped_params, batch)`` per batch without autograd;
    return {path: absmean (K,)} for every quantizable leaf that saw
    input."""
    wrappers: Dict[Tuple, StatsWeight] = {}

    def wrap(path, leaf):
        wrappers[path] = StatsWeight(leaf)
        return wrappers[path]

    wrapped = map_quantizable(params, wrap, min_dim=min_dim)
    with torch.no_grad():
        for batch in batches:
            forward(wrapped, batch)
    return {k: sw.absmean for k, sw in wrappers.items()
            if sw.sum_abs is not None}
