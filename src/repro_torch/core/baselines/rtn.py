"""Round-to-nearest b-bit quantization, per output channel, asymmetric
(twin of ``repro.core.baselines.rtn``).

The weakest baseline of the paper's tables (2-bit RTN collapses); also
the primitive that PB-LLM (8-bit salient) and AWQ (after scaling) reuse.
"""
from __future__ import annotations

import torch


def rtn_quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quant w (..., K, N) with a min/max grid per output channel
    (N).  The divisor is a tensor on w's device (``core/int4.py``)."""
    wf = w.to(torch.float32)
    qmax = 2 ** bits - 1
    wmin = torch.amin(wf, dim=-2, keepdim=True)
    wmax = torch.amax(wf, dim=-2, keepdim=True)
    scale = torch.clamp_min((wmax - wmin) / torch.full_like(wmax, qmax),
                            1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
    q = torch.clamp(torch.round(wf / scale) + zero, 0, qmax)
    return ((q - zero) * scale).to(w.dtype)


def bits_per_weight(bits: int, k: int, n: int) -> float:
    """b-bit codes + fp16 scale and zero per output channel."""
    return bits + (2 * n * 16) / (k * n)
