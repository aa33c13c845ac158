"""Quantization preprocessing by restorative LoRA (paper §3.4, App. D;
twin of ``repro.core.preprocess``).

Pretrained checkpoints have scattered salient weights, which per-channel
scales handle badly.  Before quantization:

  1. build an initial quantized model Q0(W) (data-free PTQ1.61 without
     scale learning), frozen as fake-quant dense matrices;
  2. attach rank-r LoRA factors to every quantizable linear and train
     them so that Q0(W) + scale·BA recovers the model's behaviour on
     language-model batches (Adam through ``model.forward_loss``);
  3. merge the learned low-rank compensation into the full-precision
     weights: W' = W + scale·BA.

Nothing extra ships at inference: W' is quantized like any checkpoint
(``quantize_params_data_free`` or ``quantize_model_ptq161``).

The port keeps one parameter entry per layer, so LoRA factors are keyed
by the port's tree paths (``path_key``), one pair per layer, where the
reference keys one stacked pair per stage leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import quantize_params_data_free
from repro_torch.core.qlinear import QLinear, QuantConfig
from repro_torch.core.select import map_quantizable, map_tree
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW

Tree = Any


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    rank: int = 32                # paper: rank 32
    steps: int = 10_000           # paper: 10K steps
    lr: float = 1e-4
    lora_alpha: float = 16.0
    seed: int = 7


def path_key(path: Tuple) -> str:
    """A tree path as a string in the reference's ``keystr`` form:
    ``['stages'][0][3][0]['attn']['wq']``."""
    return "".join(f"[{p!r}]" for p in path)


def init_lora(params: Tree, pcfg: PreprocessConfig,
              min_dim: int = 64) -> Dict[str, Dict[str, torch.Tensor]]:
    """{path: {"a": (..., r, N), "b": (..., K, r)}} in f32 for every
    quantizable leaf, with r = min(rank, K // 2, N // 2): A ~ 0.01·N(0, 1)
    drawn from one generator seeded with ``pcfg.seed`` (leaf by leaf in
    tree order), B = 0, so the compensation starts at zero."""
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    gen = None

    def visit(path, w):
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(pcfg.seed)
        lead = tuple(w.shape[:-2])
        k, n = w.shape[-2:]
        r = min(pcfg.rank, k // 2, n // 2)
        a = 0.01 * torch.randn(lead + (r, n), generator=gen,
                               dtype=torch.float32, device=w.device)
        b = torch.zeros(lead + (k, r), dtype=torch.float32, device=w.device)
        lora[path_key(path)] = {"a": a, "b": b}
        return w

    map_quantizable(params, visit, min_dim=min_dim)
    return lora


def merge_lora(base: Tree, lora: Dict[str, Dict[str, torch.Tensor]],
               scale: float, min_dim: int = 64) -> Tree:
    """Each quantizable leaf of ``base`` plus scale·B@A, summed in f32
    and returned in the leaf's dtype.  One leaf's f32 sum exists at a
    time; under autograd the gradient reaches A and B through it."""
    def visit(path, w):
        ab = lora.get(path_key(path))
        if ab is None:
            return w
        delta = scale * torch.einsum("...kr,...rn->...kn", ab["b"], ab["a"])
        return (w.to(torch.float32) + delta).to(w.dtype)
    return map_quantizable(base, visit, min_dim=min_dim)


def initial_dense(params: Tree, qcfg: QuantConfig, min_dim: int = 64
                  ) -> Tree:
    """Q0(W): data-free PTQ1.61 without scale learning, every quantized
    leaf replaced by its fake-quant dense matrix (bf16, as the
    reference's ``QLinear.to_dense``)."""
    q0 = quantize_params_data_free(
        params, dataclasses.replace(qcfg, learn_scales=False),
        min_dim=min_dim)
    return map_tree(q0, lambda _, x: x.to_dense()
                    if isinstance(x, QLinear) else x)


def lora_loss(cfg: ArchConfig, q0_dense: Tree,
              lora: Dict[str, Dict[str, torch.Tensor]], scale: float,
              batch: Dict[str, torch.Tensor], min_dim: int = 64,
              attn_chunk: int = 1024) -> torch.Tensor:
    """The training loss: ``forward_loss`` of Q0(W) + scale·BA."""
    eff = merge_lora(q0_dense, lora, scale, min_dim=min_dim)
    return M.forward_loss(cfg, eff, batch, attn_chunk=attn_chunk)


def restorative_lora(cfg: ArchConfig, params: Tree,
                     batches: List[Dict[str, torch.Tensor]],
                     qcfg: QuantConfig,
                     pcfg: PreprocessConfig = PreprocessConfig(),
                     min_dim: int = 64,
                     log: Optional[Callable[[str], None]] = None,
                     attn_chunk: int = 1024,
                     losses: Optional[List[float]] = None) -> Tree:
    """Return the preprocessed full-precision checkpoint W' = W + scale·BA.

    ``batches``: dicts of tokens and targets (B, S), cycled over
    ``pcfg.steps`` Adam steps.  With ``losses`` given, appends every
    step's loss (read back from the device each step)."""
    _log = log or (lambda s: None)
    q0_dense = initial_dense(params, qcfg, min_dim)
    lora = init_lora(params, pcfg, min_dim=min_dim)
    if not lora:
        return params
    scale = pcfg.lora_alpha / pcfg.rank
    opt = AdamW(lr=pcfg.lr)
    opt_state = opt.init(lora)

    n = len(batches)
    for i in range(pcfg.steps):
        leaves = [t.requires_grad_(True) for ab in lora.values()
                  for t in ab.values()]
        loss = lora_loss(cfg, q0_dense, lora, scale, batches[i % n],
                         min_dim, attn_chunk)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = {k: {f: next(flat) for f in ab} for k, ab in lora.items()}
        lora, opt_state = opt.update(grads, opt_state, lora)
        loss = loss.detach()
        if losses is not None:
            losses.append(float(loss))
        if i % max(1, pcfg.steps // 10) == 0:
            _log(f"restorative-lora step {i}: loss {float(loss):.4f}")
    del q0_dense

    # merge the restorative compensation into the full-precision weights
    with torch.no_grad():
        return merge_lora(params, lora, scale, min_dim=min_dim)
