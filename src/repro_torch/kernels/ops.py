"""Public kernel entry points of the port (twin of ``repro.kernels.ops``).

Every wrapper picks its route from the tensor's device alone: the CUDA
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
There is no feasibility gate and no fallback on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matmul import binary_matmul
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.mixed_matmul import mixed_matmul as _mixed
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill


def mixed_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """PTQ1.61 linear forward for a 2-D QLinear ``q``: x (..., K) ->
    (..., N) in x.dtype.  x is cast to bf16 (the kernel's operand type)
    and taken in original channel order; the salient-first gather by
    ``q.perm`` happens inside the kernel.  A row-parallel view's perm
    gathers its K channels from a wider x.  With ``out_dtype=
    torch.float32`` the result is the f32 accumulator before its
    rounding to bf16."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    y = _mixed(xf, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
               q.alpha_r2, perm=q.perm, out_dtype=out_dtype or torch.bfloat16)
    return y.reshape(lead + (q.n,)).to(out_dtype or x.dtype)


__all__ = ["binary_matmul", "int4_matmul", "mixed_matmul",
           "paged_attention", "paged_prefill"]
