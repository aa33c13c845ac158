"""PB-LLM (Shang et al., 2023): partially binarized LLM (twin of
``repro.core.baselines.pbllm``).

The top 10% of weights by |w| (UNSTRUCTURED: scattered positions) keep
8-bit RTN; the other 90% are binarized with an analytic α per output
channel over the non-salient weights only.  The unstructured mask costs
a full bit per weight (App. A): b = 0.1·8 + 0.9·1 + 1 = 2.7 b/w, the
paper's central criticism that PTQ1.61's structured mask removes.
"""
from __future__ import annotations

import torch

from repro_torch.core.baselines import column_sum


def pbllm_quantize(w: torch.Tensor, salient_frac: float = 0.1,
                   salient_bits: int = 8) -> torch.Tensor:
    """Fake-quant w (K, N)."""
    wf = w.to(torch.float32)
    k, n = wf.shape
    absw = torch.abs(wf)
    n_sal = max(1, int(round(salient_frac * k * n)))
    thresh = torch.sort(absw.reshape(-1)).values[-n_sal]
    mask = absw >= thresh                            # unstructured (K, N)

    # salient: 8-bit RTN on the salient values (grid per output channel)
    qmax = 2 ** salient_bits - 1
    mid = (qmax + 1) // 2
    wmax = torch.amax(torch.where(mask, absw, 0.0), dim=0, keepdim=True)
    scale = torch.clamp_min(2 * wmax / torch.full_like(wmax, qmax), 1e-8)
    q = torch.clamp(torch.round(wf / scale) + mid, 0, qmax)
    sal = (q - mid) * scale

    # non-salient: binarize, α over the non-salient entries only
    cnt = torch.clamp_min(torch.sum(~mask, dim=0, keepdim=True), 1)
    alpha = column_sum(torch.where(mask, 0.0, absw)) / cnt
    bin_ = torch.where(wf >= 0, alpha, -alpha)
    return torch.where(mask, sal, bin_).to(w.dtype)


def bits_per_weight(salient_frac: float = 0.1, salient_bits: int = 8,
                    k: int = 4096, n: int = 4096) -> float:
    return (salient_frac * salient_bits + (1 - salient_frac) * 1.0
            + 1.0                       # unstructured mask bitmap
            + 2 * n * 16 / (k * n))     # scales
