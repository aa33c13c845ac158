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
then-matmul path in the activation dtype, kept as an oracle; it runs
through the QLinear's :class:`DequantView`.

Scale learning (``core.blockwise``) needs gradients with respect to the
α's, which the CUDA kernel does not give.  It runs on a
:class:`DequantView` instead (:meth:`QLinear.dequant_view`): the int4
matrix and the signs dequantized once, and the reference's
``__matmul_permuted__`` product over them, in plain differentiable
tensor code.  Only the calibration pipeline builds such views; what it
returns, and what serving runs, are ``QLinear``s.

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
    """PTQ1.61 hyper-parameters (paper §4.1 defaults)."""

    ratio: float = 0.2            # salient input-channel fraction
    multiple: int = 128           # k_s rounding
    steps: int = 20               # block-wise optimization epochs
    lr: float = 5e-4              # AdamW lr for scales (paper: 5e-4 / 1e-3)
    lr_r: float = 1e-3            # lr for angular factors
    cosine_loss: bool = True      # D_NLC term (Eq. 5-6)
    learn_scales: bool = True     # Table-3 "Learnable Scalar" toggle


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
        return self.dequant_view(xp.dtype).__matmul_permuted__(xp)

    def dequant_view(self, dtype) -> "DequantView":
        """The differentiable view for scale learning, with the int4
        matrix and the signs dequantized once in ``dtype``."""
        return DequantView(
            self.perm, self.dequant_salient(dtype),
            pack.unpack_bits(self.bits, axis=-2, dtype=dtype),
            self.alpha_s, self.alpha_r1, self.alpha_r2, k_s=self.k_s)


@dataclass
class DequantView:
    """A QLinear's forward over fixed dequantized weights with free α's:
    ``x[.., perm]`` split at k_s, ``y = x_s @ w4deq + ((x_b·α_r2) @
    sign)·(α_s·α_r1)`` in the dtype of ``w4deq``, as the reference's
    ``QLinear.__matmul_permuted__`` computes it.  Gradients flow to the
    α's through ordinary tensor ops."""

    perm: torch.Tensor
    w4deq: torch.Tensor           # (k_s, N) in the activation dtype
    sign: torch.Tensor            # (k_b, N) ±1 in the activation dtype
    alpha_s: torch.Tensor
    alpha_r1: torch.Tensor
    alpha_r2: torch.Tensor
    k_s: int

    def __matmul_x__(self, x: torch.Tensor) -> torch.Tensor:
        return self.__matmul_permuted__(x[..., self.perm.long()])

    def __matmul_permuted__(self, xp: torch.Tensor) -> torch.Tensor:
        xs, xb = xp[..., :self.k_s], xp[..., self.k_s:]
        y4 = xs @ self.w4deq.to(xp.dtype)
        yb = (xb * self.alpha_r2.to(xp.dtype)) @ self.sign.to(xp.dtype)
        return y4 + yb * (self.alpha_s * self.alpha_r1).to(xp.dtype)


def scale_params(q) -> dict:
    """The learnable subset for block-wise optimization (Eq. 7 argmin)
    of a QLinear or its DequantView."""
    return {"alpha_s": q.alpha_s, "alpha_r1": q.alpha_r1,
            "alpha_r2": q.alpha_r2}


def with_scales(q, s: dict):
    return dataclasses.replace(q, alpha_s=s["alpha_s"],
                               alpha_r1=s["alpha_r1"],
                               alpha_r2=s["alpha_r2"])


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
