"""Model facade for the paged serving path (subset of
``repro.models.model``): parameter declaration, embedding and head,
paged caches, one paged decode step and one chunked paged prefill step.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.linear import dense
from repro_torch.models.param import P, materialize

Tree = Any


def declare_params(cfg: ArchConfig) -> Tree:
    if cfg.enc_dec or cfg.frontend:
        raise NotImplementedError("the port serves decoder-only LMs")
    d, v = cfg.d_model, cfg.vocab_padded
    p: Dict[str, Tree] = {
        "embed": P((v, d), "normal"),
        "stages": [T.init_stage(cfg, s) for s in cfg.stages],
        "final_norm": L.init_norm(cfg),
    }
    if not cfg.tied_embeddings:
        p["lm_head"] = P((d, v), "scaled")
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> Tree:
    return materialize(declare_params(cfg), seed, device)


def embed_tokens(cfg: ArchConfig, params: Tree, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head_weight(cfg: ArchConfig, params: Tree):
    if cfg.tied_embeddings:
        return params["embed"].T
    return params["lm_head"]


def logits_fn(cfg: ArchConfig, params: Tree, x: torch.Tensor
              ) -> torch.Tensor:
    """Final norm and the head, a plain matmul in the activation dtype;
    padded vocabulary entries are masked to the f32 minimum."""
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = dense(x, _head_weight(cfg, params))
    if cfg.vocab_padded == cfg.vocab:
        return logits
    keep = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
    return torch.where(keep, logits.to(torch.float32),
                       torch.finfo(torch.float32).min)


def init_paged_caches(cfg: ArchConfig, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cpu"):
    """Page pools for every stage: per attention block
    ``(L, num_pages + 1, ps, hkv, dh)`` with the dump page last."""
    return tuple(T.init_stage_cache_paged(cfg, s, num_pages, page_size,
                                          dtype, device)
                 for s in cfg.stages)


def copy_pages(cfg: ArchConfig, caches, src: torch.Tensor,
               dst: torch.Tensor):
    """Apply queued copy-on-write page copies in place."""
    return tuple(T.stage_copy_pages(stage, cs, src, dst)
                 for stage, cs in zip(cfg.stages, caches))


def decode_step_paged(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                      pos: torch.Tensor, caches, block_tables: torch.Tensor,
                      context_lens: torch.Tensor):
    """One paged decode step.  token/pos (B,) int32; block_tables
    (B, nblk) int32 (-1 = unassigned); context_lens (B,) int32 (0 =
    inactive).  Returns (logits (B, V), caches)."""
    x = embed_tokens(cfg, params, token[:, None])
    for stage, sp, c in zip(cfg.stages, params["stages"], caches):
        x, _ = T.stage_step_paged(cfg, stage, sp, x, pos, c, block_tables,
                                  context_lens)
    return logits_fn(cfg, params, x)[:, 0], caches


def prefill_step_paged(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
                       caches, bt_read: torch.Tensor, bt_write: torch.Tensor,
                       start, length):
    """Advance one request's paged prefill by one chunk.  tokens (1, C)
    int32, zero-padded past ``length``; bt_read/bt_write (nblk,) its
    block-table row and writable twin; start the page-aligned chunk
    origin and length the live tokens (host ints or device int32
    scalars).  Returns (logits (1, V) at chunk row length-1, caches)."""
    c = tokens.shape[1]
    dev = tokens.device
    if isinstance(start, torch.Tensor):
        positions = start.to(torch.int32) + torch.arange(
            c, dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(start, start + c, dtype=torch.int32,
                                 device=dev)
    positions = positions[None]
    x = embed_tokens(cfg, params, tokens)
    for stage, sp, cch in zip(cfg.stages, params["stages"], caches):
        x, _ = T.stage_prefill_step_paged(cfg, stage, sp, x, positions, cch,
                                          bt_read, bt_write, start, length)
    if isinstance(length, torch.Tensor):
        x = x.index_select(1, (length - 1).reshape(1).long())
    else:
        x = x[:, length - 1:length]
    return logits_fn(cfg, params, x)[:, 0], caches
