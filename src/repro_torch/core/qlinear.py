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
gather.  Every field may carry a leading expert axis E (a stacked MoE
weight: one mask and one set of scales per (K, N) slice, one ``k_s``
for all); :meth:`QLinear.__expert_matmul__` is its per-expert product
x (E, C, K) -> (E, C, N), dequantize-then-matmul in the activation
dtype as the reference's ``einsum`` (no kernel of the port runs it).
:meth:`QLinear.__matmul_x__` goes through
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

    def __expert_matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, C, K) with stacked per-expert fields -> (E, C, N): the
        per-expert gather by ``perm``, the int4 product and the sign
        product scaled by α_r2, α_s and α_r1, over weights dequantized
        in the activation dtype."""
        return self.dequant_view(x.dtype).__expert_matmul__(x)

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

    def __expert_matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """The stacked twin: x (E, C, K), fields (E, ...) -> (E, C, N)."""
        idx = self.perm.long()[:, None, :].expand(x.shape)
        xp = torch.gather(x, -1, idx)
        xs, xb = xp[..., :self.k_s], xp[..., self.k_s:]
        y4 = xs @ self.w4deq.to(x.dtype)
        yb = (xb * self.alpha_r2[:, None, :].to(x.dtype)) @ \
            self.sign.to(x.dtype)
        return y4 + yb * (self.alpha_s * self.alpha_r1)[:, None, :].to(
            x.dtype)


def scale_params(q) -> dict:
    """The learnable subset for block-wise optimization (Eq. 7 argmin)
    of a QLinear or its DequantView."""
    return {"alpha_s": q.alpha_s, "alpha_r1": q.alpha_r1,
            "alpha_r2": q.alpha_r2}


def with_scales(q, s: dict):
    return dataclasses.replace(q, alpha_s=s["alpha_s"],
                               alpha_r1=s["alpha_r1"],
                               alpha_r2=s["alpha_r2"])


def _quantize_slice(w: torch.Tensor, act_stat: torch.Tensor,
                    qcfg: QuantConfig):
    """One (K, N) slice -> (the 8 fields in FIELDS order, k_s)."""
    _, perm, k_s = sal.structured_mask(act_stat, qcfg.ratio, qcfg.multiple)
    wp = w[perm.long()]
    ws, wb = wp[:k_s], wp[k_s:]
    q4 = int4.quantize_int4(ws)
    b = binarize.binarize_init(wb)
    return (perm, pack.pack_nibbles(q4["q"], axis=-2), q4["s"], q4["z"],
            pack.pack_bits(b["sign"], axis=-2), b["alpha_s"],
            b["alpha_r1"], b["alpha_r2"]), k_s


def quantize_linear(w: torch.Tensor, act_stat: Optional[torch.Tensor],
                    qcfg: QuantConfig) -> QLinear:
    """PTQ1.61 initial quantization of one (…, K, N) weight (no
    learning).  ``act_stat`` is the per-input-channel saliency statistic
    (…, K) (or (K,), shared by every slice); without one the data-free
    |w| magnitude is used.  A stacked weight is quantized slice by slice
    with a mask of its own each; ``k_s`` is the first slice's (the mask
    rounds every slice of one K alike), and every field gets the leading
    shape back."""
    k, n = w.shape[-2], w.shape[-1]
    if act_stat is None:
        act_stat = torch.mean(torch.abs(w.to(torch.float32)), dim=-1)
    if w.ndim == 2:
        fields, k_s = _quantize_slice(w, act_stat, qcfg)
    else:
        lead = w.shape[:-2]
        wf = w.reshape((-1, k, n))
        sf = act_stat.reshape((-1, k)) if act_stat.ndim > 1 else None
        outs = [_quantize_slice(wf[i], act_stat if sf is None else sf[i],
                                qcfg) for i in range(wf.shape[0])]
        k_s = outs[0][1]
        fields = tuple(torch.stack([o[0][j] for o in outs]).reshape(
            lead + outs[0][0][j].shape) for j in range(len(FIELDS)))
    return QLinear(*fields, k_s=k_s, k=k, n=n)


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

    def __expert_matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """Fused per-expert forward: x (E, C, K) -> (E, C, ΣN_i), one
        batched product (and, quantized, one per-expert gather) for the
        whole group."""
        if isinstance(self.inner, QLinear):
            return self.inner.__expert_matmul__(x)
        return x @ self.inner.to(x.dtype)

    def split_out(self, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(pack.split_cols(y, self.splits))

    def members(self) -> Tuple[Any, ...]:
        """Per-member unfused views over the same (fp or packed) data;
        stacked inners split along N alike.  A 2-D packed member's
        fields are contiguous copies instead: the packed matmul takes
        contiguous operands only, and a column view of a row-major
        (rows, N) field is strided (a stacked member is dequantized per
        call and stays a view)."""
        if not isinstance(self.inner, QLinear):
            return tuple(pack.split_cols(self.inner, self.splits))
        q = self.inner
        cut = ((lambda t: pack.split_cols(t, self.splits)) if q.w4.ndim == 3
               else (lambda t: [c.contiguous()
                                for c in pack.split_cols(t, self.splits)]))
        return tuple(
            QLinear(q.perm, w4, q.s4, q.z4, bits, a_s, a_r1, q.alpha_r2,
                    k_s=q.k_s, k=q.k, n=ni)
            for w4, bits, a_s, a_r1, ni in zip(
                cut(q.w4), cut(q.bits), cut(q.alpha_s), cut(q.alpha_r1),
                self.splits))

    @classmethod
    def fuse(cls, members: Sequence[Any]) -> "QLinearGroup":
        """The inverse of :meth:`members`: same-input weights that share
        one ``perm``, ``s4``, ``z4`` and ``alpha_r2`` (the first
        member's are kept) concatenated along N, or plain tensors so
        concatenated.  Pack order keeps N contiguous, so the group's
        bytes are the members' own."""
        first = members[0]
        splits = tuple(int(m.shape[-1] if isinstance(m, torch.Tensor)
                           else m.n) for m in members)
        if isinstance(first, torch.Tensor):
            return cls(torch.cat(list(members), dim=-1), splits)
        cat = lambda f: torch.cat([getattr(m, f) for m in members],  # noqa: E731
                                  dim=-1)
        return cls(dataclasses.replace(
            first, w4=cat("w4"), bits=cat("bits"), alpha_s=cat("alpha_s"),
            alpha_r1=cat("alpha_r1"), n=sum(splits)), splits)


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
