"""GPTQ (Frantar et al., 2022) (twin of ``repro.core.baselines.gptq``).

Column-by-column quantization over the input dimension with second-order
error compensation: after input channel k of every output channel is
quantized, its error is carried into the channels not yet quantized
through the inverse Hessian's Cholesky factor.

    H = 2 Σ xᵀx / count + λI    (λ = percdamp · mean diag; dead
                                 channels H_ii = 0 get 1 first)
    Hinv = Cholesky(H⁻¹)ᵀ        (upper triangular)
    for k in 0..K-1:
        q_k   = quant(w_k)
        err_k = (w_k − q_k) / Hinv[k,k]
        W[k+1:, :] −= Hinv[k, k+1:]ᵀ · err_k

The loop runs one input channel at a time in the weight's own (K, N)
layout, so each update touches the contiguous rows below k; the grid is
one min/max range per output channel.  It is the reference's
unblocked O(K²·N) order; a lazy-batch (blocked) variant would sum in
another order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _grid(w: torch.Tensor, bits: int
          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-output-channel min/max grid of w (K, N): scale (N,), zero
    (N,), qmax."""
    qmax = 2 ** bits - 1
    wmin = torch.amin(w, dim=0)
    wmax = torch.amax(w, dim=0)
    scale = torch.clamp_min((wmax - wmin) / torch.full_like(wmax, qmax),
                            1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
    return scale, zero, qmax


def inverse_hessian_factor(h: torch.Tensor, percdamp: float = 0.01
                           ) -> torch.Tensor:
    """Upper Cholesky factor of (H + dead + λI)⁻¹, in the reference's
    order (inverse first).  ``torch.linalg`` raises where the matrix is
    not positive definite."""
    diag = torch.diagonal(h)
    dead = diag <= 0
    h = h.clone()
    torch.diagonal(h).add_(dead.to(h.dtype))
    damp = percdamp * torch.mean(torch.where(dead, 0.0, diag))
    torch.diagonal(h).add_(damp)
    return torch.linalg.cholesky(torch.linalg.inv(h), upper=True)


def gptq_columns(w: torch.Tensor, hinv: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, qmax: int) -> torch.Tensor:
    """The sequential loop over the K input channels of w (K, N, f32):
    the dequantized codes (K, N).  Elementwise only, with every divisor
    a tensor on w's device and no host read inside the loop."""
    k = w.shape[0]
    wbuf = w.clone()
    out = torch.empty_like(w)
    for i in range(k):
        row = wbuf[i]
        q = torch.clamp(torch.round(row / scale) + zero, 0, qmax)
        dq = (q - zero) * scale
        err = (row - dq) / hinv[i, i]
        wbuf[i + 1:] -= torch.outer(hinv[i, i + 1:], err)
        out[i] = dq
    return out


def gptq_quantize(w: torch.Tensor, hessian: Optional[torch.Tensor],
                  bits: int, percdamp: float = 0.01) -> torch.Tensor:
    """Fake-quant w (K, N) given the layer's input Hessian (K, K)."""
    k = w.shape[0]
    wf = w.to(torch.float32)
    if hessian is None:
        h = torch.eye(k, dtype=torch.float32, device=w.device)
    else:
        h = hessian.to(torch.float32)
    hinv = inverse_hessian_factor(h, percdamp)
    scale, zero, qmax = _grid(wf, bits)
    return gptq_columns(wf, hinv, scale, zero, qmax).to(w.dtype)


def bits_per_weight(bits: int, k: int, n: int) -> float:
    return bits + (2 * n * 16) / (k * n)
