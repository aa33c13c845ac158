"""Data-free PTQ1.61 quantization (the data-free path of
``repro.core.pipeline``).

``quantize_params_data_free`` ranks input channels by |w| magnitude,
quantizes salient channels to int4 and binarizes the rest with analytic
scales, with no calibration data and no learning.  ``fuse=True`` first
concatenates QKV and gate+up along N and quantizes each fused matrix as
one layout (shared permutation, int4 scales and α_r2), so each block
runs 2 packed matmuls for its input projections instead of 5.
Calibrated PTQ1.61 is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.qlinear import QLinearGroup, QuantConfig, quantize_linear
from repro_torch.core.select import map_quantizable, map_tree

Tree = Any


def quantize_params_data_free(params: Tree, qcfg: QuantConfig,
                              min_dim: int = 64, fuse: bool = False) -> Tree:
    if fuse:
        from repro_torch.models.transformer import fuse_params_for_decode
        params = fuse_params_for_decode(params)
    params = map_quantizable(params, lambda _, w: quantize_linear(w, None,
                                                                  qcfg),
                             min_dim=min_dim)
    if fuse:
        def visit(_, leaf):
            if isinstance(leaf, QLinearGroup) and \
                    isinstance(leaf.inner, torch.Tensor) and \
                    leaf.k >= min_dim:
                return dataclasses.replace(
                    leaf, inner=quantize_linear(leaf.inner, None, qcfg))
            return leaf
        params = map_tree(params, visit)
    return params
