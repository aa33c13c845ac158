"""QLinear — the packed PTQ1.61 weight and its forward (twin of
``repro.core.qlinear``).

Storage layout (per (K, N) linear, K = input dim):
  perm        (K,)  int32   salient-first stable channel permutation
  w4          (k_s/2, N) u8 packed int4 codes of salient channels
  s4, z4      (k_s,) f32    per-salient-channel scale / zero-point
  bits        (k_b/8, N) u8 packed signs of binarized channels
  alpha_s     (N,) f32      analytic row scale (Eq. 2)
  alpha_r1    (N,) f32      angular factor, output side (Eq. 9)
  alpha_r2    (k_b,) f32    angular factor, input side (Eq. 9)

Forward:
  y = x[.., perm_s] @ W4deq  +  ((x[.., perm_b] * α_r2) @ sign) * (α_s·α_r1)

The packed arrays are pre-permuted, so the forward needs one activation
gather.  :meth:`QLinear.__matmul_x__` goes through
``repro_torch.kernels.ops.mixed_matmul``: the CUDA kernel on a CUDA
tensor (the gather happens inside the kernel), its plain PyTorch version
on a CPU tensor.  :meth:`QLinear.__matmul_permuted__` is the dequantize-
then-matmul path in the activation dtype, kept as an oracle.

:class:`QLinearGroup` stores several same-input projections (QKV,
gate+up) as one quantized matrix concatenated along N, sharing one
permutation, one int4 scale set and one α_r2.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core import binarize, int4, pack, saliency as sal


@dataclass(frozen=True)
class QuantConfig:
    """PTQ1.61 hyper-parameters (paper §4.1 defaults) used by the
    data-free path."""

    ratio: float = 0.2            # salient input-channel fraction
    multiple: int = 128           # k_s rounding


FIELDS = ("perm", "w4", "s4", "z4", "bits", "alpha_s", "alpha_r1",
          "alpha_r2")


@dataclass
class QLinear:
    perm: torch.Tensor
    w4: torch.Tensor
    s4: torch.Tensor
    z4: torch.Tensor
    bits: torch.Tensor
    alpha_s: torch.Tensor
    alpha_r1: torch.Tensor
    alpha_r2: torch.Tensor
    k_s: int
    k: int
    n: int

    @property
    def k_b(self) -> int:
        return self.k - self.k_s

    def map(self, fn) -> "QLinear":
        """Apply ``fn`` to every tensor field (device moves, layer
        slicing of stacked weights)."""
        return dataclasses.replace(
            self, **{f: fn(getattr(self, f)) for f in FIELDS})

    def dequant_salient(self, dtype=torch.bfloat16) -> torch.Tensor:
        q = pack.unpack_nibbles(self.w4, axis=-2, dtype=torch.float32)
        return int4.dequant_int4(q, self.s4, self.z4, dtype)

    def dequant_binary(self, dtype=torch.bfloat16) -> torch.Tensor:
        sign = pack.unpack_bits(self.bits, axis=-2, dtype=torch.float32)
        return binarize.dequant_binary(sign, self.alpha_s, self.alpha_r1,
                                       self.alpha_r2, dtype)

    def to_dense(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The (K, N) fake-quant matrix in original channel order."""
        wq = torch.cat([self.dequant_salient(dtype),
                        self.dequant_binary(dtype)], dim=-2)
        inv = torch.argsort(self.perm.long(), dim=-1)
        return wq[..., inv, :]

    def __matmul_x__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., K) -> (..., N) through ``ops.mixed_matmul``."""
        from repro_torch.kernels import ops
        return ops.mixed_matmul(x, self)

    def __matmul_permuted__(self, xp: torch.Tensor) -> torch.Tensor:
        """Dequantize-then-matmul over already salient-first activations,
        in the activation dtype (the oracle path)."""
        xs, xb = xp[..., :self.k_s], xp[..., self.k_s:]
        y4 = xs @ self.dequant_salient(xp.dtype)
        sign = pack.unpack_bits(self.bits, axis=-2, dtype=xp.dtype)
        yb = (xb * self.alpha_r2.to(xp.dtype)) @ sign
        yb = yb * (self.alpha_s * self.alpha_r1).to(xp.dtype)
        return y4 + yb


def quantize_linear(w: torch.Tensor, act_stat: Optional[torch.Tensor],
                    qcfg: QuantConfig) -> QLinear:
    """PTQ1.61 initial quantization of one 2-D (K, N) weight (no
    learning).  ``act_stat`` is the per-input-channel saliency statistic
    (K,); without one the data-free |w| magnitude is used."""
    if w.ndim != 2:
        raise ValueError(f"quantize_linear takes a 2-D weight, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if act_stat is None:
        act_stat = torch.mean(torch.abs(w.to(torch.float32)), dim=-1)
    _, perm, k_s = sal.structured_mask(act_stat, qcfg.ratio, qcfg.multiple)
    wp = w[perm.long()]
    ws, wb = wp[:k_s], wp[k_s:]
    q4 = int4.quantize_int4(ws)
    w4 = pack.pack_nibbles(q4["q"], axis=-2)
    b = binarize.binarize_init(wb)
    bits = pack.pack_bits(b["sign"], axis=-2)
    return QLinear(perm, w4, q4["s"], q4["z"], bits, b["alpha_s"],
                   b["alpha_r1"],
                   b["alpha_r2"], k_s=k_s, k=k, n=n)


@dataclass
class QLinearGroup:
    """Several same-input projections fused along N into one weight.

    ``inner`` is a plain (K, ΣN_i) tensor (exact fp fusion) or a
    :class:`QLinear` quantized over the concatenated weight; ``splits``
    records each member's output width.
    """

    inner: Any
    splits: Tuple[int, ...]

    @property
    def n(self) -> int:
        return sum(self.splits)

    @property
    def k(self) -> int:
        if isinstance(self.inner, QLinear):
            return self.inner.k
        return self.inner.shape[-2]

    def __matmul_x__(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.inner, QLinear):
            return self.inner.__matmul_x__(x)
        return x @ self.inner.to(x.dtype)

    def split_out(self, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(pack.split_cols(y, self.splits))

    def members(self) -> Tuple[Any, ...]:
        """Per-member unfused views over the same (fp or packed) data."""
        if not isinstance(self.inner, QLinear):
            return tuple(pack.split_cols(self.inner, self.splits))
        q = self.inner
        return tuple(
            QLinear(q.perm, w4, q.s4, q.z4, bits, a_s, a_r1, q.alpha_r2,
                    k_s=q.k_s, k=q.k, n=ni)
            for w4, bits, a_s, a_r1, ni in zip(
                pack.split_cols(q.w4, self.splits),
                pack.split_cols(q.bits, self.splits),
                pack.split_cols(q.alpha_s, self.splits),
                pack.split_cols(q.alpha_r1, self.splits),
                self.splits))


def quantize_linear_group(ws: Sequence[torch.Tensor],
                          act_stat: Optional[torch.Tensor],
                          qcfg: QuantConfig) -> QLinearGroup:
    """PTQ1.61-quantize same-K weights as one layout fused along N."""
    ks = {w.shape[-2] for w in ws}
    if len(ks) != 1:
        raise ValueError(f"fused members must share K, got {sorted(ks)}")
    splits = tuple(int(w.shape[-1]) for w in ws)
    fused = torch.cat(list(ws), dim=-1)
    return QLinearGroup(quantize_linear(fused, act_stat, qcfg), splits)
