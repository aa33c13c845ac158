"""Packed int4 matmul: wrapper of ``csrc/int4_matmul.cu``.

Twin of ``repro.kernels.int4_matmul`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`int4_matmul` launches the hand-written kernel; on a
CPU tensor it runs ``ref.int4_matmul_ref``.  A CUDA call the kernel
cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, I, P, check_operands

KERNEL = CudaKernel("int4_matmul.cu", "int4_matmul_launch",
                    [P] * 5 + [I] * 3 + [P])


def int4_matmul(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                z4: torch.Tensor) -> torch.Tensor:
    """y (M, N) = x @ ((q−z)·s) in x.dtype.  x (M, K) (bf16 on the
    card); w4 (K/2, N) u8 nibbles; s4, z4 (K,) f32 per input channel."""
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, w4, s4, z4)
    m, k = x.shape
    n = w4.shape[1]
    check_operands("int4_matmul", x, {"w4": w4},
                   {"s4": (s4, k), "z4": (z4, k)})
    if w4.shape[0] * 2 != k:
        raise ValueError(f"int4_matmul: w4 span {w4.shape[0] * 2} != K={k}")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), w4.data_ptr(), s4.data_ptr(), z4.data_ptr(),
                  y.data_ptr(), m, n, k, stream)
    return y
