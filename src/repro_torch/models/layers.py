"""Transformer layers for the paged serving path (subset of
``repro.models.layers``): norms, RoPE, the fused QKV projection, the
gated MLP, and paged decode / chunked-prefill attention over the shared
KV page pool.

All linear weights are (in_features, out_features) and every matmul
goes through :func:`repro_torch.models.linear.dense`, so packed
``QLinear`` / ``QLinearGroup`` weights drop in.  Tensors are updated in
place where the JAX package returned new arrays: the page pools are
written where they lie.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.models.linear import dense
from repro_torch.models.param import P

Tree = Any


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, d: Optional[int] = None) -> Tree:
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": P((d,), "ones")}
    return {"scale": P((d,), "ones"), "bias": P((d,), "zeros")}


def apply_norm(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].to(torch.float32)
        return y.to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, dh), positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------
def init_attention(cfg: ArchConfig) -> Tree:
    d, dh = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": P((d, hq * dh), "scaled"),
        "wk": P((d, hkv * dh), "scaled"),
        "wv": P((d, hkv * dh), "scaled"),
        "wo": P((hq * dh, d), "scaled"),
    }
    if cfg.qkv_bias:
        p["bq"] = P((hq * dh,), "zeros")
        p["bk"] = P((hkv * dh,), "zeros")
        p["bv"] = P((hkv * dh,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = P((dh,), "ones")
        p["k_norm"] = P((dh,), "ones")
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, hq, dh), k/v (B, S, hkv, dh), roped.  The
    fused ``wqkv`` group runs one matmul (one activation gather) for all
    three projections."""
    dh, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    if "wqkv" in p:
        g = p["wqkv"]
        q, k, v = g.split_out(dense(x, g))
        if "bq" in p:
            q = q + p["bq"].to(q.dtype)
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
    else:
        q = dense(x, p["wq"], p.get("bq"))
        k = dense(x, p["wk"], p.get("bk"))
        v = dense(x, p["wv"], p.get("bv"))
    q = q.reshape(q.shape[:-1] + (hq, dh))
    k = k.reshape(k.shape[:-1] + (hkv, dh))
    v = v.reshape(v.shape[:-1] + (hkv, dh))
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Paged attention (serving runtime)
# ---------------------------------------------------------------------------
def make_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                     n_layers: int, dtype=torch.bfloat16,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """KV page pools ``(L, num_pages + 1, ps, hkv, dh)`` for one layer
    stack.  The extra physical page at index ``num_pages`` is the dump
    page: masked writes may land there, and no block table references
    it.  The pool keeps the logical head dim."""
    shape = (n_layers, num_pages + 1, page_size, cfg.n_kv_heads,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_key_positions(block_tables: torch.Tensor, page_size: int
                        ) -> torch.Tensor:
    """(B, nblk) block tables -> (B, nblk*page_size) implied key
    positions; unassigned blocks (entry < 0) yield -1."""
    b, nblk = block_tables.shape
    kp = (torch.arange(nblk, dtype=torch.int32,
                       device=block_tables.device)[:, None] * page_size
          + torch.arange(page_size, dtype=torch.int32,
                         device=block_tables.device)[None, :])
    kp = torch.where(block_tables[:, :, None] >= 0, kp[None], -1)
    return kp.reshape(b, nblk * page_size)


def attention_decode_paged(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                           pos: torch.Tensor, cache: Tree,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, layer: int,
                           window: Optional[int] = None):
    """Single-token decode against the shared page pool.

    x (B, 1, D); pos (B,) absolute positions; cache {"k", "v"} pools
    (L, P+1, ps, hkv, dh); block_tables (B, nblk) int32 (-1 =
    unassigned); lengths (B,) int32 live context (pos+1 for active rows,
    0 for inactive).  The new K/V is written into its page (rows without
    a page write the dump page), then the paged attention kernel reads
    the slot's pages.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    dump, ps = ck.shape[1] - 1, ck.shape[2]
    nblk = block_tables.shape[1]
    blk = torch.clamp(torch.div(pos, ps, rounding_mode="floor"), 0,
                      nblk - 1).long()
    page = block_tables[torch.arange(b, device=x.device), blk].long()
    page = torch.where(page >= 0, page, dump)
    slot = (pos % ps).long()
    ck[layer, page, slot] = k[:, 0].to(ck.dtype)
    cv[layer, page, slot] = v[:, 0].to(cv.dtype)
    o = paged_attention(q[:, 0].to(ck.dtype).contiguous(), ck[layer],
                        cv[layer], block_tables, lengths, window=window,
                        softcap=cfg.logit_softcap)
    o = o.to(x.dtype).reshape(b, 1, -1)
    return dense(o, p["wo"]), cache


def attention_prefill_paged(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                            positions: torch.Tensor, cache: Tree,
                            bt_read: torch.Tensor, bt_write: torch.Tensor,
                            start, length, *, layer: int,
                            window: Optional[int] = None):
    """One chunk of paged prefill for one request: project the chunk's
    Q/K/V, then one fused kernel call writes K/V into the request's
    pool pages and attends the chunk over its context pages plus the
    in-chunk causal prefix.

    x (1, C, D) (rows past ``length`` are padding); positions (1, C);
    bt_read (nblk,) the request's block table; bt_write (nblk,) its
    writable row (shared blocks -1); start the page-aligned chunk
    origin; length the live tokens.  K/V are cast to the pool dtype
    before both the write and the in-chunk attention.
    """
    c = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, positions)
    pdt = cache["k"].dtype
    o = paged_prefill(q[0].to(pdt).contiguous(), k[0].to(pdt).contiguous(),
                      v[0].to(pdt).contiguous(), cache["k"], cache["v"],
                      bt_read, bt_write, start, length, layer=layer,
                      window=window, softcap=cfg.logit_softcap)
    o = o.to(x.dtype).reshape(1, c, -1)
    return dense(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ArchConfig) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": P((d, f), "scaled"), "wu": P((d, f), "scaled"),
            "wd": P((f, d), "scaled")}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    raise ValueError(name)


def apply_mlp(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    if "wgu" in p:
        gu = p["wgu"]
        g, u = gu.split_out(dense(x, gu))
        g = _act(cfg.act, g)
    else:
        g = _act(cfg.act, dense(x, p["wg"]))
        u = dense(x, p["wu"])
    return dense(g * u, p["wd"])
