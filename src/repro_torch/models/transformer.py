"""Transformer assembly for the paged serving path (dense subset of
``repro.models.transformer``).

A stage's parameters are a list over its layers, each a tuple over the
stage's block pattern.  Depth is a Python loop; the page pools
``(L, P+1, ps, hkv, dh)`` are updated in place layer by layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, Stage
from repro_torch.core.qlinear import QLinearGroup
from repro_torch.models import layers as L

Tree = Any
KINDS = ("dense",)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; the port serves "
            f"{KINDS} blocks")


def init_block(cfg: ArchConfig, kind: str) -> Tree:
    _check_kind(kind)
    return {"ln1": L.init_norm(cfg), "attn": L.init_attention(cfg),
            "ln2": L.init_norm(cfg), "mlp": L.init_mlp(cfg)}


def init_stage(cfg: ArchConfig, stage: Stage) -> List[Tuple[Tree, ...]]:
    return [tuple(init_block(cfg, k) for k in stage.pattern)
            for _ in range(stage.repeats)]


# ---------------------------------------------------------------------------
# Decode fast path: N-fused projection layouts (QKV, gate+up)
# ---------------------------------------------------------------------------
def _fusable(d, names) -> bool:
    return d is not None and all(isinstance(d.get(k), torch.Tensor)
                                 for k in names)


def fuse_block_params(p: Tree) -> Tree:
    """Fuse one block's same-input projections along N: ``wq/wk/wv``
    become one ``wqkv`` group and ``wg/wu`` one ``wgu`` group.
    Concatenating fp tensors is exact; quantize with
    ``quantize_params_data_free(..., fuse=True)`` to get fused packed
    layouts."""
    p = dict(p)
    attn = p.get("attn")
    if _fusable(attn, ("wq", "wk", "wv")):
        attn = dict(attn)
        ws = [attn.pop(k) for k in ("wq", "wk", "wv")]
        attn["wqkv"] = QLinearGroup(torch.cat(ws, dim=-1),
                                    tuple(int(w.shape[-1]) for w in ws))
        p["attn"] = attn
    mlp = p.get("mlp")
    if _fusable(mlp, ("wg", "wu")):
        mlp = dict(mlp)
        ws = [mlp.pop(k) for k in ("wg", "wu")]
        mlp["wgu"] = QLinearGroup(torch.cat(ws, dim=-1),
                                  tuple(int(w.shape[-1]) for w in ws))
        p["mlp"] = mlp
    return p


def fuse_params_for_decode(params: Tree) -> Tree:
    new = dict(params)
    new["stages"] = [[tuple(fuse_block_params(bp) for bp in lp)
                      for lp in sp] for sp in params["stages"]]
    return new


def _kind_window(cfg: ArchConfig, kind: str) -> Optional[int]:
    return cfg.attn_window if kind == "dense" else None


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill
# ---------------------------------------------------------------------------
def block_step_paged(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
                     pos: torch.Tensor, cache: Tree,
                     block_tables: torch.Tensor, context_lens: torch.Tensor,
                     layer: int):
    _check_kind(kind)
    h, cache = L.attention_decode_paged(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), pos, cache,
        block_tables, context_lens, layer=layer,
        window=_kind_window(cfg, kind))
    x = x + h
    return x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x)), \
        cache


def stage_step_paged(cfg: ArchConfig, stage: Stage, sparams, x, pos,
                     caches, block_tables, context_lens):
    """Decode walk over a stage.  A tick with no live block-table row
    skips the walk: x and the pools pass through untouched."""
    if not bool((block_tables >= 0).any()):
        return x, caches
    for layer, lp in enumerate(sparams):
        for i, kind in enumerate(stage.pattern):
            x, _ = block_step_paged(cfg, kind, lp[i], x, pos, caches[i],
                                    block_tables, context_lens, layer)
    return x, caches


def block_prefill_step_paged(cfg: ArchConfig, kind: str, p: Tree,
                             x: torch.Tensor, positions: torch.Tensor,
                             cache: Tree, bt_read, bt_write, start, length,
                             layer: int):
    _check_kind(kind)
    h, cache = L.attention_prefill_paged(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), positions, cache,
        bt_read, bt_write, start, length, layer=layer,
        window=_kind_window(cfg, kind))
    x = x + h
    return x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x)), \
        cache


def stage_prefill_step_paged(cfg: ArchConfig, stage: Stage, sparams, x,
                             positions, caches, bt_read, bt_write, start,
                             length):
    for layer, lp in enumerate(sparams):
        for i, kind in enumerate(stage.pattern):
            x, _ = block_prefill_step_paged(cfg, kind, lp[i], x, positions,
                                            caches[i], bt_read, bt_write,
                                            start, length, layer)
    return x, caches


def stage_copy_pages(stage: Stage, pool_stage: Tree, src: torch.Tensor,
                     dst: torch.Tensor) -> Tree:
    """Copy-on-write page copies ``pool[:, dst] = pool[:, src]`` across
    every layer of the stage, in place."""
    for pool in pool_stage:
        for t in (pool["k"], pool["v"]):
            t[:, dst.long()] = t[:, src.long()]
    return pool_stage


def init_stage_cache_paged(cfg: ArchConfig, stage: Stage, num_pages: int,
                           page_size: int, dtype=torch.bfloat16,
                           device="cpu") -> Tuple[Dict[str, torch.Tensor], ...]:
    for kind in stage.pattern:
        _check_kind(kind)
    return tuple(L.make_paged_cache(cfg, num_pages, page_size,
                                    stage.repeats, dtype, device)
                 for _ in stage.pattern)
