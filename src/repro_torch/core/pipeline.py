"""PTQ1.61 quantization pipelines (twin of ``repro.core.pipeline``).

``quantize_params_data_free`` ranks input channels by |w| magnitude,
quantizes salient channels to int4 and binarizes the rest with analytic
scales, with no calibration data and no learning.  ``fuse=True`` first
concatenates QKV and gate+up along N and quantizes each fused matrix as
one layout (shared permutation, int4 scales and α_r2), so each block
runs 2 packed matmuls for its input projections instead of 5; a MoE
block's stacked expert pair (E, K, F) becomes one (E, K, 2F) group with
one such layout per expert.  Stacked expert weights are quantized slice
by slice (``qlinear.quantize_linear``), with a mask per expert.  An
encoder-decoder model's encoder and cross-attention projections are
quantized one by one: the fusion walks the decoder's ``stages`` alone,
as the reference's does.

``quantize_model_ptq161`` is the calibrated method (paper Fig. 2),
block by block in depth order with error propagation:

  1. embed the calibration segments -> FP stream X and quantized stream X_q;
  2. per block:
       a. per-linear input-channel statistics on the X_q stream,
       b. structured mask + int4 / binary initial quantization (§3.2),
       c. block-wise scale learning (§3.3, Eq. 7),
       d. propagate both streams through the FP / quantized block.

It returns one unfused ``QLinear`` per projection.  The quantized stream
runs through the dequantized views of scale learning, the reference's
XLA dequant product, so the calibration never touches the packed
kernel; serving the result does.  Preprocessing by restorative LoRA
(§3.4) is composed by the caller (``core.preprocess.restorative_lora``,
then a quantizer), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blockwise
from repro_torch.core.calibrate import collect_stats
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


def _block_forward(cfg: ArchConfig, kind: str, attn_chunk: int = 1024):
    from repro_torch.models import transformer as T

    def fn(block_params: Tree, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        return T.block_full(cfg, kind, block_params, x, positions,
                            causal=True, attn_chunk=attn_chunk)
    return fn


def quantize_model_ptq161(
        cfg: ArchConfig, params: Tree,
        calib_batches: List[Dict[str, torch.Tensor]], qcfg: QuantConfig,
        min_dim: int = 64, attn_chunk: int = 1024,
        block_losses: Optional[List[Tuple[float, float]]] = None) -> Tree:
    """Calibrated PTQ1.61 over a decoder-only model.  Returns params with
    every quantizable leaf replaced by a learned QLinear, in the port's
    per-layer layout.  With ``block_losses`` given, appends each block's
    Eq.-7 loss before and after learning (two extra passes per block).
    An encoder-decoder model raises the reference's AssertionError."""
    from repro_torch.models import model as M
    if cfg.enc_dec:
        raise AssertionError("calibrated PTQ driver targets decoder-only LMs")

    with torch.no_grad():
        x_fp = [M.embed_tokens(cfg, params, b["tokens"])
                for b in calib_batches]
    x_q = list(x_fp)

    qstages = []
    for si, stage in enumerate(cfg.stages):
        layers = []
        for lp in params["stages"][si]:
            qblocks = []
            for pi, kind in enumerate(stage.pattern):
                fp_block = lp[pi]
                fwd = _block_forward(cfg, kind, attn_chunk)

                # (a) input-channel stats on the quantized stream
                stats = collect_stats(fwd, fp_block, x_q, min_dim=min_dim)

                # (b) initial quantization
                q_block = map_quantizable(
                    fp_block, lambda path, w: quantize_linear(
                        w, stats.get(path), qcfg), min_dim=min_dim)

                # (c) scale learning (Eq. 7) on views dequantized once
                views = blockwise.dequant_views(q_block, x_q[0].dtype)
                before = (blockwise.block_loss(fwd, fp_block, views, x_fp,
                                               x_q, qcfg)
                          if block_losses is not None else None)
                views = blockwise.optimize_block_scales(
                    fwd, fp_block, views, x_fp, x_q, qcfg)
                q_block = blockwise.inject_scales(
                    q_block, blockwise.extract_scales(views))
                if block_losses is not None:
                    block_losses.append((before, blockwise.block_loss(
                        fwd, fp_block, views, x_fp, x_q, qcfg)))

                # (d) propagate (block_full returns x + f(x))
                with torch.no_grad():
                    x_fp = [fwd(fp_block, x) for x in x_fp]
                    x_q = [fwd(views, x) for x in x_q]
                del views
                qblocks.append(q_block)
            layers.append(tuple(qblocks))
        qstages.append(layers)

    qparams = dict(params)
    qparams["stages"] = qstages
    return qparams
