"""Fused PTQ1.61 linear: wrapper of ``csrc/mixed_matmul.cu``.

Twin of ``repro.kernels.mixed_matmul`` (the Pallas TPU kernel and its
in-kernel-gather variant).  On a CUDA tensor :func:`mixed_matmul`
launches the hand-written kernel; on a CPU tensor it runs
``ref.mixed_matmul_ref``.  Hopper needs no feasibility gate: the kernel
takes every shape the packing allows (k_s even, k_b a multiple of 8),
and a CUDA call it cannot take raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, I, P

KERNEL = CudaKernel("mixed_matmul.cu", "mixed_matmul_launch",
                    [P] * 10 + [I] * 4 + [P])


def mixed_matmul(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                 z4: torch.Tensor, bits: torch.Tensor, alpha_s: torch.Tensor,
                 alpha_r1: torch.Tensor, alpha_r2: torch.Tensor,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) bf16 — in original channel order when ``perm`` (K,) is
    given (the gather happens inside the kernel), else salient-first.
    Returns (M, N) bf16: the f32 accumulator rounded once, as the TPU
    kernel's output is cast to the activation dtype."""
    if x.device.type == "cpu":
        return ref.mixed_matmul_ref(x, w4, s4, z4, bits, alpha_s, alpha_r1,
                                    alpha_r2, perm).to(torch.bfloat16)
    m, k = x.shape
    k_s, n = w4.shape[0] * 2, bits.shape[1]
    k_b = bits.shape[0] * 8
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    _check(k_s + k_b == k, f"k_s+k_b={k_s}+{k_b} != K={k}")
    _check(w4.dtype == torch.uint8 and bits.dtype == torch.uint8,
           "packed weights must be uint8")
    _check(w4.shape[1] == n or k_s == 0, "w4 and bits disagree on N")
    for name, t, size in (("s4", s4, k_s), ("z4", z4, k_s),
                          ("alpha_s", alpha_s, n), ("alpha_r1", alpha_r1, n),
                          ("alpha_r2", alpha_r2, k_b)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (size,),
               f"{name} must be f32 ({size},)")
    if perm is not None:
        _check(perm.dtype == torch.int32 and tuple(perm.shape) == (k,),
               "perm must be int32 (K,)")
    tensors = (x, w4, s4, z4, bits, alpha_s, alpha_r1, alpha_r2) + (
        () if perm is None else (perm,))
    for t in tensors:
        _check(t.is_contiguous() and t.device == x.device,
               "all operands must be contiguous on one device")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), None if perm is None else perm.data_ptr(),
                  w4.data_ptr(), s4.data_ptr(), z4.data_ptr(),
                  bits.data_ptr(), alpha_s.data_ptr(), alpha_r1.data_ptr(),
                  alpha_r2.data_ptr(), y.data_ptr(), m, n, k, k_s, stream)
    return y


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixed_matmul: {msg}")
