"""Packed 1-bit matmul: the packed-matmul body of ``csrc/mixed_matmul.cu``
with the int4 span empty.

Twin of ``repro.kernels.binary_matmul`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`binary_matmul` launches the hand-written kernel (x·α_in
is staged as the binary span's x·α_r2, α_out is its output scale); on a
CPU tensor it runs ``ref.binary_matmul_ref``.  A CUDA call the kernel
cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.mixed_matmul import (ARGTYPES, check_packed,
                                              launch_packed)

KERNEL = CudaKernel("mixed_matmul.cu", "packed_matmul_launch", ARGTYPES)


def binary_matmul(x: torch.Tensor, bits: torch.Tensor,
                  alpha_out: torch.Tensor, alpha_in: torch.Tensor
                  ) -> torch.Tensor:
    """y (M, N) = ((x·α_in) @ unpack(bits))·α_out in x.dtype.  x (M, K)
    (bf16 on the card); bits (K/8, N) u8; alpha_out (N,), alpha_in (K,)
    f32."""
    if x.device.type == "cpu":
        return ref.binary_matmul_ref(x, bits, alpha_out, alpha_in)
    k, n = bits.shape[0] * 8, bits.shape[1]
    check_packed("binary_matmul", x, k, n, (bits,),
                 ((alpha_out, n), (alpha_in, k)))
    return launch_packed(KERNEL, x, None, None, None, None, bits, alpha_out,
                         None, alpha_in, n, 0)
