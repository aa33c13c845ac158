"""Packed 1-bit matmul: wrapper of ``csrc/binary_matmul.cu``.

Twin of ``repro.kernels.binary_matmul`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`binary_matmul` launches the hand-written kernel; on a
CPU tensor it runs ``ref.binary_matmul_ref``.  A CUDA call the kernel
cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, I, P, check_operands

KERNEL = CudaKernel("binary_matmul.cu", "binary_matmul_launch",
                    [P] * 5 + [I] * 3 + [P])


def binary_matmul(x: torch.Tensor, bits: torch.Tensor,
                  alpha_out: torch.Tensor, alpha_in: torch.Tensor
                  ) -> torch.Tensor:
    """y (M, N) = ((x·α_in) @ unpack(bits))·α_out in x.dtype.  x (M, K)
    (bf16 on the card); bits (K/8, N) u8; alpha_out (N,), alpha_in (K,)
    f32."""
    if x.device.type == "cpu":
        return ref.binary_matmul_ref(x, bits, alpha_out, alpha_in)
    m, k = x.shape
    n = bits.shape[1]
    check_operands("binary_matmul", x, {"bits": bits},
                   {"alpha_out": (alpha_out, n), "alpha_in": (alpha_in, k)})
    if bits.shape[0] * 8 != k:
        raise ValueError(f"binary_matmul: bits span {bits.shape[0] * 8} "
                         f"!= K={k}")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), bits.data_ptr(), alpha_in.data_ptr(),
                  alpha_out.data_ptr(), y.data_ptr(), m, n, k, stream)
    return y
