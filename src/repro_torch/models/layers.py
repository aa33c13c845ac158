"""Transformer layers (subset of ``repro.models.layers``): norms, RoPE,
the fused QKV projection, the gated MLP, the token-choice mixture of
experts (one device, and group-local under a mesh), full-sequence
attention (the calibration forward and whole-prompt prefill; self- or
cross-attention), decode against the contiguous ring caches, and paged
decode / chunked-prefill attention over the shared KV page pool.

All linear weights are (in_features, out_features) and every matmul
goes through :func:`repro_torch.models.linear.dense`, so packed
``QLinear`` / ``QLinearGroup`` weights drop in.  Tensors are updated in
place where the JAX package returned new arrays: the page pools and
ring caches are written where they lie.

Decode ring caches are ``window`` slots per decode row with a parallel
int32 absolute-position array (``"p"``, -1 = empty) for the masks: slot
``pos % window`` holds position ``pos``.

Under a mesh whose tensor-parallel degree does not divide the run-time
KV heads (``_uneven``: phi4-mini and llava at tp 16, recurrentgemma's
10 heads) a rank computes its whole query heads (``Shards.heads``) over
every KV head, and its decode caches hold every run-time KV head over
its chunk of the window (the reference's "ctx" layout) or over the
whole window; a decode step combines the ranks' softmax partials over
"model" (:func:`attend_split`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import QLinear
from repro_torch.distributed import collectives as C
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.models.linear import dense, expert_dense
from repro_torch.models.param import P

Tree = Any
NEG_INF = -1e30
CTX_QUEUE = ("ROADMAP.md queue 1, item 2 (the cross K/V's context-sharded "
             "layout)")


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, d: Optional[int] = None) -> Tree:
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": P((d,), (None,), "ones")}
    return {"scale": P((d,), (None,), "ones"),
            "bias": P((d,), (None,), "zeros")}


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
def init_attention(cfg: ArchConfig, cross: bool = False) -> Tree:
    """Q/K/V/O projections; a cross-attention block (``cross``) has no
    q/k/v biases and no q/k norms, as in the reference."""
    d, dh = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": P((d, hq * dh), ("embed", "heads"), "scaled"),
        "wk": P((d, hkv * dh), ("embed", "kv_heads"), "scaled"),
        "wv": P((d, hkv * dh), ("embed", "kv_heads"), "scaled"),
        "wo": P((hq * dh, d), ("heads", "embed"), "scaled"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = P((hq * dh,), ("heads",), "zeros")
        p["bk"] = P((hkv * dh,), ("kv_heads",), "zeros")
        p["bv"] = P((hkv * dh,), ("kv_heads",), "zeros")
    if cfg.qk_norm and not cross:
        p["q_norm"] = P((dh,), (None,), "ones")
        p["k_norm"] = P((dh,), (None,), "ones")
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _kv_heads_local(cfg: ArchConfig, shards) -> bool:
    """True when this rank's columns of wk / wv are whole KV heads of
    its query heads: no replication to the TP degree (``kv_heads_run``
    is the true count) and the TP degree divides the KV heads."""
    hkv = cfg.n_kv_heads
    return (shards.par.kv_heads_run(hkv, cfg.n_heads) == hkv
            and hkv % shards.tp == 0)


def _uneven(cfg: ArchConfig, shards) -> bool:
    """True under ``shards`` when the run-time KV heads do not divide
    tp: a rank then computes its whole query heads (``Shards.heads``,
    possibly none) against every KV head, each query head reading its
    own (:func:`_per_head_kv`), and its decode caches hold every
    run-time KV head (``transformer.declare_stage_cache``'s "ctx"
    layout, or the whole window)."""
    return shards is not None and shards.par.kv_heads_run(
        cfg.n_kv_heads, cfg.n_heads) % shards.tp != 0


def _kv_replicated(cfg: ArchConfig, p: Tree, xkv: torch.Tensor, shards,
                   narrow: bool = True, chunk: bool = False):
    """K and V (B, Sk, hkv_run / tp * dh) of this rank's run-time KV
    heads when a shard of wk / wv cuts through a head, or the heads are
    replicated to the TP degree: every true head is projected, repeated
    ``kv_heads_run / hkv`` times consecutively as the reference repeats
    them, and this rank's heads are kept.  Without ``narrow``
    (:func:`_uneven`): every true head, (B, Sk, hkv * dh).  No rank
    projects what another projects, as the reference's GSPMD partitions
    the product: with ``chunk`` (``xkv`` this rank's chunk of the
    sequence-parallel stream) the small KV leaves are gathered over
    "model" (their gradients reduce-scattered back; a packed leaf's
    column view along N, ``Shards.gather_model``), every true head is
    projected on the chunk and the result gathered along the sequence
    (``Shards.stream_in``, whose backward reduce-scatters the gradient
    back to the chunk); on a replicated ``xkv`` each rank projects its
    own columns of wk / wv and the columns are gathered over "model"
    (backward: the reduce-scatter of their gradient)."""
    dh, hkv = cfg.head_dim_, cfg.n_kv_heads
    run = shards.par.kv_heads_run(hkv, cfg.n_heads)
    per = run // shards.tp
    out = []
    for w, b in (("wk", "bk"), ("wv", "bv")):
        bias = p.get(b)
        if chunk:
            y = shards.stream_in(dense(
                xkv, shards.gather_model(p[w], 1),
                None if bias is None else shards.gather_model(bias, 0)))
        else:
            y = shards.gather_model(dense(xkv, p[w], bias), xkv.ndim - 1)
        if not narrow:
            out.append(y)
            continue
        y = y.reshape(y.shape[:-1] + (hkv, dh))
        y = torch.repeat_interleave(y, run // hkv, dim=-2)
        y = y.narrow(-2, shards.tp_rank * per, per)
        out.append(y.reshape(y.shape[:-2] + (per * dh,)))
    return out


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                 positions: torch.Tensor, xkv: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None,
                 use_rope: bool = True, shards=None,
                 chunk: Optional[torch.Tensor] = None):
    """x (B, S, D) -> q (B, S, hq, dh) and, from ``xkv`` (B, Sk, D; x by
    default), k/v (B, Sk, hkv, dh); roped at ``positions`` and
    ``kv_positions`` unless ``use_rope`` is off (cross-attention).  The
    fused ``wqkv`` group runs one matmul (one activation gather) for all
    three projections.  With ``shards`` (``models.common.Shards``) the
    weights are this rank's column shards and the heads its own: hq /
    tp query heads and ``kv_heads_run`` / tp KV heads; where those do
    not divide tp (:func:`_uneven`), the query heads of
    ``Shards.heads`` (``wq`` and ``bq`` cut to them by
    ``Shards.head_part``) and every true KV head.  ``chunk``: this
    rank's chunk of the sequence-parallel stream that x was gathered
    from; replicated KV heads are projected on it
    (:func:`_kv_replicated`)."""
    dh = cfg.head_dim_
    if xkv is None:
        xkv, kv_positions = x, positions
    kv_in = xkv if chunk is None else chunk
    if "wqkv" in p and xkv is x:
        g = p["wqkv"]
        q, k, v = g.split_out(dense(x, g))
        if "bq" in p:
            q = q + p["bq"].to(q.dtype)
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
    elif _uneven(cfg, shards):
        bq = p.get("bq")
        q = dense(x, shards.head_part(p["wq"], cfg.n_heads, 1),
                  None if bq is None else shards.head_part(bq, cfg.n_heads,
                                                           0))
        k, v = _kv_replicated(cfg, p, kv_in, shards, narrow=False,
                              chunk=chunk is not None)
    else:
        q = dense(x, p["wq"], p.get("bq"))
        if shards is None or _kv_heads_local(cfg, shards):
            k = dense(xkv, p["wk"], p.get("bk"))
            v = dense(xkv, p["wv"], p.get("bv"))
        else:
            k, v = _kv_replicated(cfg, p, kv_in, shards,
                                  chunk=chunk is not None)
    q = q.reshape(q.shape[:-1] + (q.shape[-1] // dh, dh))
    k = k.reshape(k.shape[:-1] + (k.shape[-1] // dh, dh))
    v = v.reshape(v.shape[:-1] + (v.shape[-1] // dh, dh))
    if "q_norm" in p:
        qn, kn = p["q_norm"], p["k_norm"]
        if shards is not None:          # replicated scales on local heads
            qn, kn = shards.enter(qn), shards.enter(kn)
        q = _qk_norm(q, qn)
        k = _qk_norm(k, kn)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def kv_index(n_q: int, n_k: int, lo: int, hi: int) -> torch.Tensor:
    """The K/V head each query head of [lo, hi) reads, of ``n_k`` K/V
    heads under ``n_q`` query heads (the GQA group of query head j is j
    // (n_q / n_k); run-time replicas are consecutive, so it is the same
    head for the true and the run-time count)."""
    return torch.arange(lo, hi) // (n_q // n_k)


def _per_head_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, shards):
    """Every true KV head (B, Sk, hkv, dh) -> the one each of this
    rank's query heads reads, (B, Sk, hi - lo, dh): a rank's whole query
    heads may straddle two KV groups (phi4-mini at tp 16: rank 1's query
    heads 2-3 read KV heads 0 and 1), so the heads attend one to one."""
    lo, hi = shards.heads(cfg.n_heads)
    idx = kv_index(cfg.n_heads, k.shape[2], lo, hi).to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------------------
# Full-sequence attention and the ring caches (plain PyTorch, as the
# reference leaves both to XLA)
# ---------------------------------------------------------------------------
def _attend(q, k, v, mask, softcap: Optional[float]) -> torch.Tensor:
    """q (B, Sq, hq, dh), k/v (B, Sk, hkv, dh), mask (B or 1, Sq, Sk)
    bool -> (B, Sq, hq, dh) f32.  Scores and softmax in f32; the weights
    are cast to the V dtype before PV, with f32 sums.  A rank that holds
    no query head (and so no K/V head) gets an empty output through the
    same operations, which keeps its autograd graph, and with it the
    order of its collectives, the other ranks'."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv if hkv else 1
    qr = q.reshape(b, sq, hkv, rep, dh).to(torch.float32)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k.to(torch.float32))
    s = s / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w, v.to(torch.float32))
    return o.reshape(b, sq, hq, dh)


def _attend_chunked(q, k, v, q_pos, kv_pos, causal: bool,
                    window: Optional[int], softcap: Optional[float],
                    chunk: int) -> torch.Tensor:
    """Streaming softmax over KV chunks of ``chunk`` keys (O(Sq·chunk)
    memory).  Positions (B, Sq) / (B, Sk) int32; masking is positional,
    and position -1 marks padding."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv if hkv else 1
    if sk % chunk:
        raise ValueError(f"key length {sk} is not a multiple of {chunk}")
    qf = q.to(torch.float32).reshape(b, sq, hkv, rep, dh) / math.sqrt(dh)
    m = torch.full((b, hkv, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, dh), device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        pb = kv_pos[:, None, c0:c0 + chunk]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        valid = pb <= q_pos[:, :, None] if causal else pb >= 0
        valid = valid & (pb >= 0)
        if window is not None:
            valid = valid & (q_pos[:, :, None] - pb < window)
        s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p,
                                                   vb)
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)


def make_cache(cfg: ArchConfig, batch: int, window: int, n_layers: int,
               dtype=torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    """KV ring buffers for one layer stack: k/v ``(L, B, W, hkv, dh)``
    and positions ``"p"`` ``(L, B, W)`` int32, all zeros."""
    shape = (n_layers, batch, window, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "p": torch.zeros(shape[:3], dtype=torch.int32, device=device)}


def attention_full(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None, attn_chunk: int = 1024,
                   use_rope: bool = True, xkv: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   cache_window: Optional[int] = None,
                   return_kv: bool = False, shards=None):
    """Attention over a whole sequence (the calibration forward, the
    loss and whole-prompt prefill).  x (B, S, D), positions (B, S)
    int32, -1 for padding (never attended).  Cross-attention passes
    ``xkv`` (B, Sk, D) with its ``kv_positions`` (the keys and values
    come from it; x by default) and ``use_rope=False``.  Key lengths
    longer than ``attn_chunk`` that it divides stream over key chunks.  With
    ``cache_window``, also returns the decode ring cache built from the
    K/V computed here; with ``return_kv``, those K/V themselves (the
    cross-attention's decode cache).  With ``shards`` (the sharded
    train step, and sharded serving): x is the stream (this rank's
    chunk of it on the sequence-parallel stream, ``Shards.along``),
    which enters whole (``Shards.stream_in``); ``xkv`` is the encoder's
    output, whole on every model rank (entered here unless the encoder
    ran sequence-parallel and gathered it once, ``model.encode``); the
    heads are this rank's (the ring cache holds this rank's run-time KV
    heads), and ``wo``'s row shard gives partial sums that leave into
    the stream (``Shards.row``: all-reduced, or reduce-scattered to the
    chunk; it also runs a packed ``wo``'s row view)."""
    chunk = None
    if shards is not None:
        if xkv is None and shards.seq is not None:
            chunk = x
        x = shards.stream_in(x)
        if xkv is not None and not shards.splits(xkv.shape[1]):
            xkv = shards.enter(xkv)
    q, k, v = _project_qkv(cfg, p, x, positions, xkv, kv_positions,
                           use_rope, shards, chunk)
    if xkv is None:
        kv_positions = positions
    ka, va = k, v
    if _uneven(cfg, shards):
        if return_kv:
            raise NotImplementedError(
                f"{cfg.name}: cross K/V caches whose run-time KV heads do "
                f"not divide tp={shards.tp} wait for {CTX_QUEUE}")
        ka, va = _per_head_kv(cfg, k, v, shards)
    sk = k.shape[1]
    if sk > attn_chunk and sk % attn_chunk == 0:
        o = _attend_chunked(q, ka, va, positions, kv_positions, causal,
                            window, cfg.logit_softcap, attn_chunk)
    else:
        qp, kp = positions[:, :, None], kv_positions[:, None, :]
        mask = kp <= qp if causal else torch.ones_like(kp <= qp)
        mask = mask & (kp >= 0)
        if window is not None:
            mask = mask & (qp - kp < window)
        o = _attend(q, ka, va, mask, cfg.logit_softcap)
    o = o.to(x.dtype).reshape(x.shape[:-1] + (o.shape[2] * o.shape[3],))
    out = (dense(o, p["wo"]) if shards is None else
           shards.row(o, p["wo"], (cfg.n_heads, cfg.head_dim_)))
    if return_kv:
        return out, k, v
    if cache_window is None:
        return out
    if _uneven(cfg, shards):
        return out, _ctx_cache(cfg, k, v, positions, cache_window, shards)
    return out, ring_cache_from_kv(k, v, positions, cache_window)


def _ctx_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor, window: int, shards
               ) -> Dict[str, torch.Tensor]:
    """The decode cache of a rank whose run-time KV heads do not divide
    tp (``transformer.declare_stage_cache``): the ring of every run-time
    KV head (the true heads of k / v repeated as the reference repeats
    them), cut to this rank's chunk of the window where tp divides it
    (the "ctx" layout: slots [r·W/tp, (r+1)·W/tp)), else whole;
    positions ``"p"`` whole on every rank, as declared."""
    rep = shards.par.kv_heads_run(cfg.n_kv_heads, cfg.n_heads) // k.shape[2]
    ring = ring_cache_from_kv(torch.repeat_interleave(k, rep, dim=2),
                              torch.repeat_interleave(v, rep, dim=2),
                              positions, window)
    if window % shards.tp == 0:
        wc = window // shards.tp
        for name in ("k", "v"):
            # a copy, never a view: with one row a rank's slots are a
            # contiguous block of the whole ring, and a view would keep
            # the whole ring's storage alive in the cache
            ring[name] = ring[name].narrow(1, shards.tp_rank * wc,
                                           wc).clone()
    return ring


def ring_cache_from_kv(k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, window: int
                       ) -> Dict[str, torch.Tensor]:
    """Ring cache from prefill K/V (B, S, hkv, dh) and positions (B, S):
    keep the last ``window`` slots (padding them with position -1 when
    S < window) and order them so that slot = position % window.  Ties
    among padding slots keep their order (stable sort), so the bytes
    equal the reference's."""
    s = k.shape[1]
    if s >= window:
        k_c, v_c, p_c = k[:, -window:], v[:, -window:], positions[:, -window:]
    else:
        pad = window - s
        k_c = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_c = F.pad(v, (0, 0, 0, 0, 0, pad))
        p_c = F.pad(positions, (0, pad), value=-1)
    order = torch.argsort(torch.remainder(p_c, window), dim=1, stable=True)
    rows = order[:, :, None, None].expand(-1, -1, k_c.shape[2], k_c.shape[3])
    return {"k": torch.gather(k_c, 1, rows), "v": torch.gather(v_c, 1, rows),
            "p": torch.gather(p_c, 1, order)}


def attention_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                     pos: torch.Tensor, cache: Tree, *, layer: int,
                     window: Optional[int] = None, shards=None):
    """Single-token decode against the stacked ring caches.

    x (B, 1, D); pos (B,) absolute position of the new token; cache
    {"k", "v": (L, B, W, hkv, dh), "p": (L, B, W)}.  The new K/V and its
    position are written in place at ``[layer, b, pos % W]``; then the
    row attends every slot whose position is live and not in the future.
    With ``shards`` (sharded serving) the heads are this rank's, the
    cache holds its rows and run-time KV heads, and ``wo`` is the row
    product of ``Shards.row``.
    """
    b = x.shape[0]
    if shards is not None:
        x = shards.enter(x)
    if _uneven(cfg, shards):
        return _attention_decode_ctx(cfg, p, x, pos, cache, layer, window,
                                     shards), cache
    q, k, v = _project_qkv(cfg, p, x, pos[:, None], shards=shards)
    ck, cv, cp = cache["k"], cache["v"], cache["p"]
    bi = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, ck.shape[2]).long()
    ck[layer, bi, slot] = k[:, 0].to(ck.dtype)
    cv[layer, bi, slot] = v[:, 0].to(cv.dtype)
    cp[layer, bi, slot] = pos.to(cp.dtype)
    qp, kp = pos[:, None, None], cp[layer][:, None, :]
    mask = (kp <= qp) & (kp >= 0)
    if window is not None:
        mask = mask & (qp - kp < window)
    o = _attend(q, ck[layer], cv[layer], mask, cfg.logit_softcap)
    o = o.to(x.dtype).reshape(b, 1, -1)
    if shards is not None:
        return shards.row(o, p["wo"]), cache
    return dense(o, p["wo"]), cache


def attend_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, softcap: Optional[float]):
    """:func:`_attend` over one part of the keys, as a generator that
    yields what the parts combine: ("max", the part's row maxima), then
    ("sum", its sums of exp(s - M)) and ("sum", its f32 accumulator of
    the weights (rounded to the V dtype, as :func:`_attend` rounds them)
    times V), each time receiving the combined value (M the maximum over
    every part, then the sum); it returns the (B, Sq, hq, dh) f32
    output.  The parts' results add up to :func:`_attend` over all the
    keys up to the order of f32 sums; a row with no live key is spread
    evenly over every key, as there."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qr = q.reshape(b, sq, hkv, hq // hkv, dh).to(torch.float32)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k.to(torch.float32))
    s = s / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    m = yield "max", torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    l = yield "sum", torch.sum(e, dim=-1)
    w = (e / l[..., None]).to(v.dtype).to(torch.float32)
    o = yield "sum", torch.einsum("bhrqk,bkhd->bqhrd", w,
                                  v.to(torch.float32))
    return o.reshape(b, sq, hq, dh)


def drive_split(parts) -> list:
    """Run the :func:`attend_split` generators of every part in lock
    step, combining what they yield in part order (the maximum, or the
    f32 sum) as an all-reduce over the parts would: each part's output,
    all equal."""
    msgs = [next(g) for g in parts]
    while True:
        op, vals = msgs[0][0], [t for _, t in msgs]
        tot = vals[0].clone()
        for t in vals[1:]:
            tot = torch.maximum(tot, t) if op == "max" else tot + t
        outs = []
        for g in parts:
            try:
                outs.append(g.send(tot.clone()))
            except StopIteration as done:
                outs.append(done.value)
        if not isinstance(outs[0], tuple):
            return outs
        msgs = outs


def _attention_decode_ctx(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                          pos: torch.Tensor, cache: Tree, layer: int,
                          window: Optional[int], shards) -> torch.Tensor:
    """:func:`attention_decode` of a rank whose run-time KV heads do not
    divide tp (:func:`_uneven`), against its caches of every run-time KV
    head: over its chunk of the window (the "ctx" layout, when the
    cache's slots are fewer than the positions ``"p"``'s) or the whole
    window.  Every rank projects the new token's K/V for every KV head;
    the rank whose chunk holds slot ``pos % W`` writes it, and every
    rank its position (``"p"`` is whole on each).  The query heads are
    gathered over "model"; each rank attends its slots for every head
    in f32, and with the "ctx" layout the partials combine over "model"
    (an all-reduce of the maxima, then of the sums and accumulators:
    :func:`attend_split`).  This rank's heads of the output go through
    ``wo``'s row product."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, pos[:, None], shards=shards)
    ck, cv, cp = cache["k"], cache["v"], cache["p"]
    rep = ck.shape[3] // k.shape[2]
    k = torch.repeat_interleave(k[:, 0], rep, dim=1)
    v = torch.repeat_interleave(v[:, 0], rep, dim=1)
    wc, w = ck.shape[2], cp.shape[2]
    lo = shards.tp_rank * wc if wc < w else 0
    bi = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, w).long()
    mine = slot - lo
    own = ((mine >= 0) & (mine < wc))[:, None, None]
    mine = mine.clamp(0, wc - 1)
    ck[layer, bi, mine] = torch.where(own, k.to(ck.dtype), ck[layer, bi, mine])
    cv[layer, bi, mine] = torch.where(own, v.to(cv.dtype), cv[layer, bi, mine])
    cp[layer, bi, slot] = pos.to(cp.dtype)
    qp, kp = pos[:, None, None], cp[layer][:, None, lo:lo + wc]
    mask = (kp <= qp) & (kp >= 0)
    if window is not None:
        mask = mask & (qp - kp < window)
    q = shards.gather_heads(q, cfg.n_heads, 2)
    part = attend_split(q, ck[layer], cv[layer], mask, cfg.logit_softcap)
    group = shards.group("model") if wc < w and shards.tp > 1 else None
    msg = next(part)
    try:
        while True:
            op, t = msg
            if group is not None:
                t = C.all_reduce_(t.contiguous(), group, op)
            msg = part.send(t)
    except StopIteration as done:
        o = done.value
    hlo, hhi = shards.heads(cfg.n_heads)
    o = o[:, :, hlo:hhi].to(x.dtype).reshape(b, 1, (hhi - hlo) * o.shape[3])
    return shards.row(o, p["wo"], (cfg.n_heads, cfg.head_dim_))


def attention_cross_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                           xk: torch.Tensor, xv: torch.Tensor, shards=None
                           ) -> torch.Tensor:
    """One decode step of cross-attention: x (B, 1, D) projected to the
    query alone (no RoPE), attending every position of the cached
    encoder K/V (B, S_enc, hkv, dh), then ``wo``.  With ``shards``
    (sharded serving) the query heads are this rank's (``wq``'s column
    view), the cached K/V its run-time KV heads, and ``wo`` the row
    product of ``Shards.row``.  Run-time KV heads that do not divide tp
    (a context-sharded cross cache) raise ``NotImplementedError``."""
    b = x.shape[0]
    if _uneven(cfg, shards):
        raise NotImplementedError(
            f"{cfg.name}: cross K/V caches whose run-time KV heads do not "
            f"divide tp={shards.tp} wait for {CTX_QUEUE}")
    if shards is not None:
        x = shards.enter(x)
    q = dense(x, p["wq"]).reshape(b, 1, -1, cfg.head_dim_)
    mask = torch.ones((b, 1, xk.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = _attend(q, xk, xv, mask, cfg.logit_softcap)
    o = o.to(x.dtype).reshape(b, 1, -1)
    return dense(o, p["wo"]) if shards is None else shards.row(o, p["wo"])


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


def scatter_pages(pool: Dict[str, torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, positions: torch.Tensor,
                  bt_row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter prefill K/V into pool pages, every layer at once, in place.

    pool {"k", "v"} (L, P+1, ps, hkv, dh); k/v (L, S, hkv, dh) at the
    token ``positions`` (S,) int32; bt_row (nblk,) the owning request's
    (writable) block table.  Rows at position -1 or in an unassigned
    block (entry -1) are dropped, as the reference's out-of-range
    scatter drops them: they are aimed at the dump page and write back
    what it already holds, so every byte of the pool, dump page
    included, is the reference's, and nothing is read back to the host.
    """
    dump, ps = pool["k"].shape[1] - 1, pool["k"].shape[2]
    t = positions.long()
    tc = t.clamp_min(0)
    blk = torch.clamp(torch.div(tc, ps, rounding_mode="floor"), 0,
                      bt_row.shape[0] - 1)
    page = bt_row.long()[blk]
    valid = (t >= 0) & (page >= 0)
    page = torch.where(valid, page, dump)
    slot = tc % ps
    for name, src in (("k", k), ("v", v)):
        dst = pool[name]
        src = torch.where(valid[None, :, None, None], src.to(dst.dtype),
                          dst[:, page, slot])
        dst[:, page, slot] = src
    return pool


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
    return {"wg": P((d, f), ("embed", "ffn"), "scaled"),
            "wu": P((d, f), ("embed", "ffn"), "scaled"),
            "wd": P((f, d), ("ffn", "embed"), "scaled")}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    raise ValueError(name)


def apply_mlp(cfg: ArchConfig, p: Tree, x: torch.Tensor, shards=None
              ) -> torch.Tensor:
    """The gated MLP; with ``shards``, over this rank's ffn columns of
    wg / wu and rows of wd: the stream enters whole
    (``Shards.stream_in``) and the partial sums leave into it
    (``Shards.row``: all-reduced, or reduce-scattered to this rank's
    chunk of the sequence-parallel stream; a packed wd's row view sums
    f32 partials and rounds once)."""
    if shards is not None:
        x = shards.stream_in(x)
    if "wgu" in p:
        gu = p["wgu"]
        g, u = gu.split_out(dense(x, gu))
        g = _act(cfg.act, g)
    else:
        g = _act(cfg.act, dense(x, p["wg"]))
        u = dense(x, p["wu"])
    if shards is None:
        return dense(g * u, p["wd"])
    return shards.row(g * u, p["wd"])


# ---------------------------------------------------------------------------
# Mixture of experts: token-choice top-k, capacity dispatch by scatter
# (the reference's ``apply_moe``, its shard_map branch under Shards)
# ---------------------------------------------------------------------------
def init_moe(cfg: ArchConfig) -> Tree:
    """The router stays f32 and is never quantized (not a projection
    name of ``core.select``); expert weights are stacked (E, K, N)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {"router": P((d, e), ("embed", None), "scaled", torch.float32),
            "wg": P((e, d, f), ("experts", "embed", "ffn"), "scaled"),
            "wu": P((e, d, f), ("experts", "embed", "ffn"), "scaled"),
            "wd": P((e, f, d), ("experts", "ffn", "embed"), "scaled")}


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for a call routing ``n_tokens`` tokens: k · factor
    · T / E rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(math.ceil(m.top_k * m.capacity_factor * n_tokens / m.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def _top_k(logits: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken toward the lower index,
    as ``jax.lax.top_k`` does: a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows by comparison (``F.one_hot`` reads its input's range
    back to the host, a synchronization per layer on the card)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_dispatch(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor
                 ) -> Dict[str, Any]:
    """Route tokens xt (T, D).  Returns the top-k experts ``gate_e`` (T, k)
    and their softmaxed weights ``gate_w`` in the activation dtype, and
    per (token, slot) in token-major order the expert ``dest_e`` (E, the
    ghost expert, where the slot overflowed), its capacity row
    ``dest_c`` and ``keep``.  A slot's row is its rank among the earlier
    slots routed to the same expert; rows at or past the capacity
    ``cap`` (an int) overflow."""
    m = cfg.moe
    cap = moe_capacity(cfg, xt.shape[0])
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    gate_w, gate_e = _top_k(logits, m.top_k)
    gate_w = torch.softmax(gate_w, dim=-1).to(xt.dtype)
    flat_e = gate_e.reshape(-1)
    onehot = _one_hot(flat_e, m.n_experts, torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = pos < cap
    return {"gate_e": gate_e, "gate_w": gate_w, "keep": keep,
            "dest_e": torch.where(keep, flat_e,
                                  torch.full_like(flat_e, m.n_experts)),
            "dest_c": torch.where(keep, pos, torch.zeros_like(pos)),
            "cap": cap}


def apply_moe(cfg: ArchConfig, p: Tree, x: torch.Tensor, shards=None
              ) -> torch.Tensor:
    """Capacity-bound token-choice MoE over x (B, S, D).  Every token of
    the call is routed (the capacity follows B·S); slots past an
    expert's capacity are dropped, their residual path passes through.

    The combine is a fixed-order sum over each token's k slots in the
    activation dtype, slot 0 first: the reference's scatter-add of
    ``repeat(arange(T), k)``, without atomics, so repeated calls give
    the same bits on the card.

    With ``shards`` (the sharded train step, and sharded serving) the
    MoE is the reference's group-local one (``_apply_moe_shard_map``):
    x holds this data rank's whole rows, every position, on every model
    rank (the caller gathers the sequence-parallel stream first,
    ``Shards.stream_rep``, as the reference's shard_map takes its input
    whole over "model"), which it routes alone with the capacity of
    their token count, the same on every model rank; the output is the
    stream (this rank's chunk of the sequence-parallel one).  Float
    experts run over this rank's ffn part (an EP leaf is resharded to
    it, ``Shards.experts``) and the combine's partial sums leave into
    the stream (``Shards.stream_out``); packed experts (sharded
    serving) take the reference's quantized layout: ``wg`` / ``wu``
    over this rank's ffn columns of every expert, g·u gathered over
    "model", ``wd`` whole at full K, no partial sums, the output cut to
    the rank's chunk (``distributed.sharding.expert_local`` lays them
    out at placement).  Where the reference keeps the whole-batch function
    under a mesh, so does the port: with rows of one token every data
    rank routes the whole batch and keeps its rows, and with the batch
    not split over data (``par.shard_batch`` off) every data rank holds
    and routes the whole batch."""
    if shards is None:
        return _moe(cfg, p, x)
    if x.shape[1] > 1 or not shards.par.shard_batch:
        return _moe(cfg, p, x, shards)
    rows = shards.rows(x.shape[0] * shards.dp)
    return _moe(cfg, p, shards.data_gather(x), shards)[rows]


def _moe(cfg: ArchConfig, p: Tree, x: torch.Tensor, shards=None
         ) -> torch.Tensor:
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    r = moe_dispatch(cfg, p["router"], xt)
    dest_e, dest_c, keep = r["dest_e"].long(), r["dest_c"].long(), r["keep"]
    src = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    buf = torch.zeros((m.n_experts + 1, r["cap"], d), dtype=x.dtype,
                      device=x.device)
    buf[dest_e, dest_c] = xt[src]        # duplicates land on the ghost only
    buf = buf[:m.n_experts]
    gate_w = r["gate_w"]
    packed = isinstance(p.get("wd"), QLinear)
    if shards is not None:
        buf, gate_w = shards.enter(buf), shards.enter(gate_w)
        if not packed:
            p = {"wg": shards.experts(p["wg"], m.n_experts, 2),
                 "wu": shards.experts(p["wu"], m.n_experts, 2),
                 "wd": shards.experts(p["wd"], m.n_experts, 1)}

    if "wgu" in p:
        g, u = p["wgu"].split_out(expert_dense(buf, p["wgu"]))
        g = _act(cfg.act, g)
    else:
        g = _act(cfg.act, expert_dense(buf, p["wg"]))
        u = expert_dense(buf, p["wu"])
    gu = g * u                                             # (E, cap, F/tp)
    if shards is not None and packed:
        gu = shards.gather_model(gu, 2)                    # (E, cap, F)
    y = expert_dense(gu, p["wd"])                          # (E, cap, D)

    gathered = y[dest_e.clamp(0, m.n_experts - 1), dest_c]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=y.dtype, device=y.device))
    w = gate_w.reshape(-1)[:, None].to(gathered.dtype)
    contrib = (gathered * w).reshape(t, m.top_k, d)
    out = torch.zeros((t, d), dtype=gathered.dtype, device=x.device)
    for j in range(m.top_k):
        out = out + contrib[:, j]
    out = out.reshape(b, s, d)
    if shards is None:
        return out
    return shards.stream_part(out) if packed else shards.stream_out(out)


def moe_aux_loss(cfg: ArchConfig, x: torch.Tensor, router: torch.Tensor,
                 shards=None) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E · Σ_e (share of
    tokens whose top-1 is e) · (mean router probability of e).

    With ``shards`` x holds this data rank's whole rows (every position,
    as :func:`apply_moe` takes them) and the loss is over
    the global batch, as the reference leaves it to GSPMD: the top-1
    counts and the token count are summed over the data ranks, and the
    result is this rank's share (its probabilities' sum over the global
    count), so the shares sum to the global loss once."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1).to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)     # first maximum: lower index
    counts = torch.sum(_one_hot(top1, m.n_experts, torch.float32), dim=0)
    n = torch.full((), float(t), device=x.device)
    if shards is not None:
        counts, n = shards.data_sum(counts), shards.data_sum(n)
    frac_tokens = counts / n
    frac_probs = torch.sum(probs, dim=0) / n
    return m.n_experts * torch.sum(frac_tokens * frac_probs)
