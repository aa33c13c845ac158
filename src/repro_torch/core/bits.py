"""Average bits-per-weight accounting (paper Appendix A; twin of
``repro.core.bits``).

    b = 1·r_b + b_salient·(1−r_b) + b_index + b_additional

* weight bits: binary channels at 1 bit, salient at 4;
* b_index: the 1-D structured mask is K bits per (K,N) matrix
  (≈0.0002 b/w at 4096² — the salient-first permutation is derivable from
  the mask, costing nothing extra);
* b_additional: fp16 scale storage — α_s, α_r1 (N each), α_r2 (k_b),
  int4 per-channel scale+zero (2·k_s).

For reference, the same accounting applied to the baselines (App. A):
PB-LLM 0.1·8 + 0.9·1 + 1(unstructured mask) = 2.7 b/w; BiLLM 1.0 + 0.1 +
1.0 = 2.1 b/w (``core.baselines.driver.method_bits``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.core.qlinear import QLinear, QLinearGroup
from repro_torch.core.select import map_tree

SCALE_BITS = 16


@dataclass(frozen=True)
class BitsReport:
    weight_bits: float
    index_bits: float
    additional_bits: float
    total_bits: float
    n_weights: int

    def row(self) -> str:
        return (f"{self.weight_bits:.4f} + {self.index_bits:.6f} + "
                f"{self.additional_bits:.4f} = {self.total_bits:.4f}")


def qlinear_bits(q: QLinear) -> BitsReport:
    """One QLinear; a stacked one (leading expert axes) counts each
    slice's mask and scales."""
    lead = math.prod(q.bits.shape[:-2])
    n_w = lead * q.k * q.n
    weight_bits = (q.k_b * 1 + q.k_s * 4) / q.k
    index_bits = lead * q.k / n_w
    additional = lead * (2 * q.n + q.k_b + 2 * q.k_s) * SCALE_BITS / n_w
    return BitsReport(weight_bits, index_bits, additional,
                      weight_bits + index_bits + additional, n_w)


def model_bits(qparams: Any) -> Dict[str, Any]:
    """Aggregate over every QLinear (inside groups too); also count the
    floating-point parameters that stay unquantized."""
    reports: List[BitsReport] = []
    exempt = 0

    def visit(_, leaf):
        nonlocal exempt
        if isinstance(leaf, QLinearGroup):
            leaf = leaf.inner
        if isinstance(leaf, QLinear):
            reports.append(qlinear_bits(leaf))
        elif isinstance(leaf, torch.Tensor):
            exempt += leaf.numel()
        return leaf

    map_tree(qparams, visit)
    q_weights = sum(r.n_weights for r in reports)
    bit_sum = sum(r.total_bits * r.n_weights for r in reports)
    return {
        "avg_bits_per_quantized_weight": bit_sum / max(1, q_weights),
        "quantized_weights": q_weights,
        "exempt_params": exempt,
        "exempt_fraction": exempt / max(1, exempt + q_weights),
        "per_layer": reports,
        "checkpoint_gbytes": (bit_sum / 8 + exempt * 2) / 1e9,
    }


def paper_closed_form(k: int = 4096, n: int = 4096, ratio: float = 0.2
                      ) -> BitsReport:
    """The Appendix-A worked example (4096×4096, 20% salient)."""
    k_s = int(k * ratio)
    k_b = k - k_s
    weight_bits = (k_b * 1 + k_s * 4) / k
    index_bits = k / (k * n)
    additional = (2 * n + k_b + 2 * k_s) * SCALE_BITS / (k * n)
    return BitsReport(weight_bits, index_bits, additional,
                      weight_bits + index_bits + additional, k * n)
