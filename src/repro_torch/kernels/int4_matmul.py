"""Packed int4 matmul: the packed-matmul body of ``csrc/mixed_matmul.cu``
with the binary span empty.

Twin of ``repro.kernels.int4_matmul`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`int4_matmul` launches the hand-written kernel; on a
CPU tensor it runs ``ref.int4_matmul_ref``.  A CUDA call the kernel
cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.mixed_matmul import (ARGTYPES, check_packed,
                                              launch_packed)

KERNEL = CudaKernel("mixed_matmul.cu", "packed_matmul_launch", ARGTYPES)


def int4_matmul(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                z4: torch.Tensor) -> torch.Tensor:
    """y (M, N) = x @ ((q−z)·s) in x.dtype.  x (M, K) (bf16 on the
    card); w4 (K/2, N) u8 nibbles; s4, z4 (K,) f32 per input channel."""
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, w4, s4, z4)
    k, n = w4.shape[0] * 2, w4.shape[1]
    check_packed("int4_matmul", x, k, n, (w4,), ((s4, k), (z4, k)))
    return launch_packed(KERNEL, x, None, w4, s4, z4, None, None, None,
                         None, n, k)
