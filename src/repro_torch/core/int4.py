"""4-bit quantization of salient input channels (paper §3.2, App. A).

Per input channel asymmetric min/max quantization: one scale and one
zero-point per salient channel.  q = clamp(round(w/s) + z, 0, 15);
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict

import torch

QMAX = 15


def quantize_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w: (..., k_s, N) salient slice -> {q (uint8 codes), s, z per channel}."""
    wf = w.to(torch.float32)
    wmin = torch.amin(wf, dim=-1)
    wmax = torch.amax(wf, dim=-1)
    scale = torch.clamp_min((wmax - wmin) / QMAX, 1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0, QMAX)
    q = torch.clamp(torch.round(wf / scale[..., None]) + zero[..., None],
                    0, QMAX)
    return {"q": q.to(torch.uint8), "s": scale, "z": zero}


def dequant_int4(q: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    return ((q.to(torch.float32) - z[..., None]) * s[..., None]).to(dtype)
