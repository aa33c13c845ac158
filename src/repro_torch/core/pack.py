"""Bit-exact packing for sub-2-bit storage (layout of ``repro.core.pack``).

* 1-bit weights: 8 signs per uint8 byte along the input (K) dimension —
  bit j of byte i is the sign of channel k = 8*i + j (1 = +1, 0 = -1).
* 4-bit weights: two nibbles per uint8 byte along K — low nibble is
  channel 2*i, high nibble 2*i+1.

Both layouts keep the output (N) dimension contiguous.  All functions are
shape-polymorphic in leading dims, so stacked (L, K, N) weights pack the
same way as 2-D ones.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def _bshape(ndim: int, axis: int):
    return (1,) * (axis + 1) + (8,) + (1,) * (ndim - axis - 1)


def pack_bits(signs: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack ±1 (or bool) signs along `axis` (a multiple of 8):
    (..., K, N) -> (..., K//8, N) uint8."""
    axis = axis % signs.ndim
    k = signs.shape[axis]
    if k % 8:
        raise ValueError(f"K={k} not a multiple of 8")
    bits = (signs > 0).to(torch.uint8)
    shp = signs.shape[:axis] + (k // 8, 8) + signs.shape[axis + 1:]
    bits = bits.reshape(shp)
    weights = torch.tensor([1 << s for s in range(8)], dtype=torch.uint8,
                           device=signs.device)
    return torch.sum(bits * weights.reshape(_bshape(signs.ndim, axis)),
                     dim=axis + 1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, axis: int = -2,
                dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (..., K//8, N) -> ±1 in `dtype` (..., K, N)."""
    axis = axis % packed.ndim
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(axis + 1)
            >> shifts.reshape(_bshape(packed.ndim, axis))) & 1
    out_shape = (packed.shape[:axis] + (packed.shape[axis] * 8,)
                 + packed.shape[axis + 1:])
    return bits.reshape(out_shape).to(dtype) * 2 - 1


def pack_nibbles(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack uint4 values (0..15) along `axis` (a multiple of 2) into uint8."""
    axis = axis % q.ndim
    k = q.shape[axis]
    if k % 2:
        raise ValueError(f"K={k} not a multiple of 2")
    q = q.to(torch.uint8)
    q = q.reshape(q.shape[:axis] + (k // 2, 2) + q.shape[axis + 1:])
    lo = q.select(axis + 1, 0)
    hi = q.select(axis + 1, 1)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor, axis: int = -2,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (..., K//2, N) -> values 0..15 in `dtype` (..., K, N)."""
    axis = axis % packed.ndim
    stacked = torch.stack([packed & 0xF, packed >> 4], dim=axis + 1)
    out_shape = (packed.shape[:axis] + (packed.shape[axis] * 2,)
                 + packed.shape[axis + 1:])
    return stacked.reshape(out_shape).to(dtype)


def split_cols(a: torch.Tensor, splits: Sequence[int]) -> List[torch.Tensor]:
    """Split the trailing (N) axis into per-member slices (views).  Both
    packed layouts keep N contiguous, so slicing packed columns out of
    an N-fused matrix is bit-exact."""
    return list(torch.split(a, [int(s) for s in splits], dim=-1))


def packed_nbytes(k_salient: int, k_binary: int, n: int) -> int:
    """Storage bytes for one quantized (K, N) matrix (weights only)."""
    return (k_binary // 8) * n + (k_salient // 2) * n


__all__ = ["pack_bits", "unpack_bits", "pack_nibbles", "unpack_nibbles",
           "split_cols", "packed_nbytes"]
