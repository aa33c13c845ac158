"""Sequential calibrated driver for the baseline quantizers (twin of
``repro.core.baselines.driver``).

Mirrors the PTQ1.61 pipeline (block by block, statistics on the
propagated quantized stream), but each quantizable leaf becomes a
FAKE-QUANT dense tensor of the weight's dtype: exactly how the paper
evaluates the baselines (their unstructured masks are not servable
below 2 bits, which is the paper's point).  The model then runs its
dense ``torch.matmul`` path, as the reference runs ``einsum``.

Methods: rtn-{2,3,4,8} | gptq-{2,3,4} | awq-2 | pbllm | billm.

A stacked expert weight (E, K, N) is quantized expert by expert, as the
reference does, with what its wrapper recorded: AWQ takes the expert's
own channel means but the row sample of every expert at once (mostly
expert 0's capacity rows), BiLLM the diagonal of the Hessian merged over
every expert, and GPTQ the identity in place of a Hessian (the
reference tracks no per-expert Hessian).

On an encoder-decoder model it does what the reference does, faults
included: it quantizes the decoder's ``stages`` alone (the encoder
stays in its dtype), and each decoder block is calibrated without the
encoder's output, so its cross-attention attends the block's own
stream.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.baselines import awq, billm, gptq, pbllm, rtn
from repro_torch.core.calibrate import StatsWeight, collect_wrappers
from repro_torch.core.pipeline import _block_forward
from repro_torch.core.select import map_quantizable

Tree = Any


def parse_method(method: str):
    m = re.fullmatch(r"(rtn|gptq|awq)-(\d+)", method)
    if m:
        return m.group(1), int(m.group(2))
    if method in ("pbllm", "billm"):
        return method, None
    raise ValueError(f"unknown baseline {method!r}")


def method_bits(method: str, k: int = 4096, n: int = 4096) -> float:
    kind, b = parse_method(method)
    if kind == "rtn":
        return rtn.bits_per_weight(b, k, n)
    if kind == "gptq":
        return gptq.bits_per_weight(b, k, n)
    if kind == "awq":
        return awq.bits_per_weight(b, k, n)
    if kind == "pbllm":
        return pbllm.bits_per_weight(k=k, n=n)
    return billm.bits_per_weight()


def quantize_model_baseline(
        cfg: ArchConfig, params: Tree,
        calib_batches: List[Dict[str, torch.Tensor]], method: str,
        min_dim: int = 64, attn_chunk: int = 1024,
        choices: Optional[Dict[tuple, Any]] = None) -> Tree:
    """Fake-quantize every quantizable leaf of a decoder-only model with
    ``method``, in the port's per-layer layout.  Params on the card
    quantize on the card.  With ``choices`` given, records per leaf
    (stage, layer, pattern position) + path what the search picked:
    AWQ's α index, BiLLM's (salient rows, split index); a list of them,
    one per expert, for a stacked expert weight."""
    from repro_torch.models import model as M
    kind, b = parse_method(method)
    needs_h = kind in ("gptq", "billm")
    sample_rows = 256 if kind == "awq" else 0

    with torch.no_grad():
        x_q = [M.embed_tokens(cfg, params, batch["tokens"])
               for batch in calib_batches]

    qstages = []
    for si, stage in enumerate(cfg.stages):
        layers = []
        for li, lp in enumerate(params["stages"][si]):
            qblocks = []
            for pi, bk in enumerate(stage.pattern):
                fp_block = lp[pi]
                fwd = _block_forward(cfg, bk, attn_chunk)
                wrappers = collect_wrappers(
                    fwd, fp_block, x_q, min_dim=min_dim,
                    collect_hessian=needs_h, sample_rows=sample_rows)

                def qfn(path, w):
                    sw = wrappers.get(path)
                    if w.ndim > 2:      # stacked experts: slice by slice
                        outs = [_quant_one(kind, b, w[e], sw, e)
                                for e in range(w.shape[0])]
                        wq = torch.stack([o[0] for o in outs])
                        picked = [o[1] for o in outs]
                        if picked[0] is None:
                            picked = None
                    else:
                        wq, picked = _quant_one(kind, b, w, sw)
                    if choices is not None and picked is not None:
                        choices[(si, li, pi) + path] = picked
                    return wq

                with torch.no_grad():
                    q_block = map_quantizable(fp_block, qfn, min_dim=min_dim)
                    x_q = [fwd(q_block, x) for x in x_q]
                del wrappers
                qblocks.append(q_block)
            layers.append(tuple(qblocks))
        qstages.append(layers)

    qparams = dict(params)
    qparams["stages"] = qstages
    return qparams


def _quant_one(kind: str, b: Optional[int], w: torch.Tensor,
               sw: Optional[StatsWeight], expert: Optional[int] = None):
    """(fake-quant w, what the method's search picked or None) for one
    (K, N) weight, or slice ``expert`` of a stacked one."""
    if kind == "rtn":
        return rtn.rtn_quantize(w, b), None
    if kind == "gptq":
        h = None if sw is None or sw.h is None or expert is not None \
            else sw.hessian
        return gptq.gptq_quantize(w, h, b), None
    if kind == "awq":
        absmean = None if sw is None or sw.sum_abs is None else sw.absmean
        if absmean is not None and expert is not None:
            absmean = absmean[expert]
        xs = None if sw is None else sw.x_sample
        return awq.awq_search(w, absmean, b, x_sample=xs)
    if kind == "pbllm":
        return pbllm.pbllm_quantize(w), None
    if kind == "billm":
        hd = None
        if sw is not None and sw.h is not None:
            hd = torch.diagonal(sw.hessian)
        wq, rows, split = billm.billm_search(w, hd)
        return wq, (rows, split)
    raise ValueError(kind)
