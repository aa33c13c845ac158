"""Average bits-per-weight accounting (paper Appendix A; twin of
``repro.core.bits``).

    b = 1·r_b + b_salient·(1−r_b) + b_index + b_additional
"""
from __future__ import annotations

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


def qlinear_bits(q: QLinear) -> BitsReport:
    n_w = q.k * q.n
    weight_bits = (q.k_b * 1 + q.k_s * 4) / q.k
    index_bits = q.k / n_w
    additional = (2 * q.n + q.k_b + 2 * q.k_s) * SCALE_BITS / n_w
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
