"""Calibration-time activation statistics (twin of
``repro.core.calibrate``).

The structured mask (paper §3.2) ranks the input channels of each linear
by E[|x_i|] over the calibration set.  :func:`collect_stats` swaps every
quantizable weight for a recording :class:`StatsWeight` and runs the
block forward over the calibration batches; the wrapper computes the
same matmul, so the forward is unchanged.  For the baselines,
:func:`collect_wrappers` returns the wrappers themselves, which can also
hold the input Gram matrix (GPTQ's and BiLLM's Hessian) and a capped
sample of input rows (AWQ's grid search).  The running sums stay on the
tensors' device, in f32: nothing is copied to the host per call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.select import map_quantizable

Tree = Any


class StatsWeight:
    """Drop-in weight that records per-input-channel Σ|x| and Σx² (per
    expert for a stacked expert weight), optionally the input Gram
    matrix Σ xᵀx (the Hessian H = 2·Σ xᵀx / count) and a capped sample
    of raw input rows."""

    def __init__(self, w: torch.Tensor, collect_hessian: bool = False,
                 sample_rows: int = 0):
        self.w = w
        self.sum_abs = None
        self.sum_sq = None
        self.count = 0
        self.collect_hessian = collect_hessian
        self.h = None
        self.sample_rows = sample_rows
        self.samples: List[torch.Tensor] = []

    def _record(self, x: torch.Tensor, per_expert: bool = False) -> None:
        """Add one call's input.  ``per_expert``: x is (E, C, K) and the
        channel sums are per expert, (E, K), over the capacity rows only
        (``count`` counts C); the Gram matrix and the row sample still
        take every expert's rows at once, as the reference does."""
        x32 = x.to(torch.float32)
        xf = x32.reshape(-1, x.shape[-1])
        rows, dim = (x32, 1) if per_expert else (xf, 0)
        s_abs = torch.sum(torch.abs(rows), dim=dim)
        s_sq = torch.sum(rows * rows, dim=dim)
        if self.sum_abs is None:
            self.sum_abs, self.sum_sq = s_abs, s_sq
        else:
            self.sum_abs = self.sum_abs + s_abs
            self.sum_sq = self.sum_sq + s_sq
        self.count += rows.shape[dim]
        if self.collect_hessian:
            g = xf.T @ xf
            if self.h is None:
                self.h = g
            else:
                self.h += g
        # the reference's cap: a whole call's first rows are appended
        # while fewer than sample_rows are held
        if self.sample_rows and \
                sum(s.shape[0] for s in self.samples) < self.sample_rows:
            self.samples.append(xf[:self.sample_rows].clone())

    def __matmul_x__(self, x: torch.Tensor) -> torch.Tensor:
        self._record(x)
        return x @ self.w.to(x.dtype)

    def __expert_matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, C, K) @ the stacked (E, K, N) weight, recording per
        expert."""
        self._record(x, per_expert=True)
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

    @property
    def hessian(self) -> torch.Tensor:
        return 2.0 * self.h / self.h.new_tensor(float(max(1, self.count)))

    @property
    def x_sample(self) -> Optional[torch.Tensor]:
        return torch.cat(self.samples, 0) if self.samples else None


def collect_stats(forward: Callable[[Tree, Any], Any], params: Tree,
                  batches: List[Any], min_dim: int = 64
                  ) -> Dict[Tuple, torch.Tensor]:
    """Run ``forward(wrapped_params, batch)`` per batch without autograd;
    return {path: absmean (K,), or (E, K) per expert} for every
    quantizable leaf that saw input."""
    wrappers = collect_wrappers(forward, params, batches, min_dim=min_dim)
    return {k: sw.absmean for k, sw in wrappers.items()
            if sw.sum_abs is not None}


def collect_wrappers(forward: Callable[[Tree, Any], Any], params: Tree,
                     batches: List[Any], *, min_dim: int = 64,
                     collect_hessian: bool = False, sample_rows: int = 0
                     ) -> Dict[Tuple, StatsWeight]:
    """Like :func:`collect_stats`, but return the wrappers themselves
    (absmean, sqmean, Hessian, input sample), keyed by leaf path."""
    wrappers: Dict[Tuple, StatsWeight] = {}

    def wrap(path, leaf):
        wrappers[path] = StatsWeight(leaf, collect_hessian=collect_hessian,
                                     sample_rows=sample_rows)
        return wrappers[path]

    wrapped = map_quantizable(params, wrap, min_dim=min_dim)
    with torch.no_grad():
        for batch in batches:
            forward(wrapped, batch)
    return wrappers
