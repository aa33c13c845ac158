"""Transformer assembly (the decoder block kinds of
``repro.models.transformer``: ``dense``, ``moe``, ``local``, ``rglru``,
``mlstm`` and ``slstm``): the full-sequence forward (calibration, loss),
whole-prompt prefill with its decode caches, decode over the contiguous
ring caches, and the paged serving path.

``dense``, ``moe`` and ``local`` are attention blocks (``ATTN_KINDS``);
a ``moe`` block's feed-forward is ``layers.apply_moe`` over stacked
expert weights, and its full-sequence forward can report the router's
load-balancing loss; a ``local`` block attends a sliding window of
``cfg.local_window`` keys.  The recurrent kinds (``models.recurrent``)
carry per-slot state instead of keys and values: an ``rglru`` block is
the Griffin recurrent block and the gated MLP (state ``h``, ``conv``);
an ``mlstm`` block is the xLSTM matrix-memory cell alone (``c``, ``n``)
and an ``slstm`` block the scalar-memory cell with its gated FFN (``h``,
``c``, ``n``, ``m``).

An encoder-decoder model's decoder blocks (``cross=True``) add a
cross-attention (``ln_x``, ``xattn``) between the self-attention and
the feed-forward: no RoPE, every encoder position attended.  Its K/V are
projected once at prefill and cached beside the ring cache, ``{"self":
ring, "xk", "xv": (L, B, S_enc, hkv, dh)}``; a decode step projects the
query alone against them.  The paged path does not serve such blocks
(``models.model`` refuses it, as the reference does).

A stage's parameters are a list over its layers, each a tuple over the
stage's block pattern.  Depth is a Python loop; a stage's caches are a
tuple over the pattern of stacked tensors — ring caches ``(L, B, W,
hkv, dh)`` with positions ``(L, B, W)``, page pools ``(L, P+1, ps, hkv,
dh)``, recurrent state ``(L, B, ...)`` at the decode batch
(``recurrent.init_recurrent_state``) — updated in place layer by layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Stage
from repro_torch.core.qlinear import QLinearGroup
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.param import P, stack_p

Tree = Any
ATTN_KINDS = ("dense", "moe", "local")
XLSTM_KINDS = ("mlstm", "slstm")
KINDS = ATTN_KINDS + ("rglru",) + XLSTM_KINDS


def _check_kind(kind: str) -> None:
    """An unknown kind raises the reference's ``ValueError(kind)``."""
    if kind not in KINDS:
        raise ValueError(kind)


def init_block(cfg: ArchConfig, kind: str, cross: bool = False) -> Tree:
    _check_kind(kind)
    p = _init_block(cfg, kind)
    if cross:
        p["ln_x"] = L.init_norm(cfg)
        p["xattn"] = L.init_attention(cfg, cross=True)
    return p


def _init_block(cfg: ArchConfig, kind: str) -> Tree:
    if kind == "rglru":
        return {"ln1": L.init_norm(cfg), "rec": R.init_rglru(cfg),
                "ln2": L.init_norm(cfg), "mlp": L.init_mlp(cfg)}
    if kind == "mlstm":
        return {"ln1": L.init_norm(cfg), "cell": R.init_mlstm(cfg)}
    if kind == "slstm":
        return {"ln1": L.init_norm(cfg), "cell": R.init_slstm(cfg)}
    return {"ln1": L.init_norm(cfg), "attn": L.init_attention(cfg),
            "ln2": L.init_norm(cfg),
            "mlp": L.init_moe(cfg) if kind == "moe" else L.init_mlp(cfg)}


def _norm(cfg: ArchConfig, p: Tree, x: torch.Tensor, shards=None
          ) -> torch.Tensor:
    """A block's norm of the stream (this rank's chunk of it on the
    sequence-parallel stream, whose scale's gradient is then summed
    over "model", ``Shards.stream_leaf``)."""
    return L.apply_norm(cfg, p if shards is None else shards.stream_leaf(p),
                        x)


def _ffn(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
         shards=None, aux: Optional[List[torch.Tensor]] = None
         ) -> torch.Tensor:
    """The block's feed-forward on its normed input: the gated MLP, or
    the mixture of experts over every token of the call (with
    ``shards``, the group-local MoE of this data rank's whole rows,
    gathered from the sequence-parallel stream once for the routing and
    the load-balancing loss, ``Shards.stream_rep``).  With ``aux``, a
    moe block appends its router's load-balancing loss to it."""
    if kind != "moe":
        return L.apply_mlp(cfg, p, x, shards)
    if shards is not None:
        x = shards.stream_rep(x)
    if aux is not None:
        aux.append(L.moe_aux_loss(cfg, x, p["router"], shards))
    return L.apply_moe(cfg, p, x, shards)


def init_stage(cfg: ArchConfig, stage: Stage, cross: bool = False
               ) -> List[Tuple[Tree, ...]]:
    return [tuple(init_block(cfg, k, cross) for k in stage.pattern)
            for _ in range(stage.repeats)]


# ---------------------------------------------------------------------------
# Decode fast path: N-fused projection layouts (QKV, gate+up)
# ---------------------------------------------------------------------------
def _fusable(d, names) -> bool:
    return d is not None and all(isinstance(d.get(k), torch.Tensor)
                                 for k in names)


def fuse_block_params(p: Tree) -> Tree:
    """Fuse one block's same-input projections along N: ``wq/wk/wv``
    become one ``wqkv`` group and ``wg/wu`` one ``wgu`` group; stacked
    expert pairs (E, K, F) become one (E, K, 2F) group.
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


def unfuse_block_params(p: Tree) -> Tree:
    """Inverse of :func:`fuse_block_params`: per-projection weights as
    unfused views over the same (fp or packed) data — the oracle the
    fused path is tested against."""
    p = dict(p)
    attn = p.get("attn")
    if attn is not None and "wqkv" in attn:
        attn = dict(attn)
        attn["wq"], attn["wk"], attn["wv"] = attn.pop("wqkv").members()
        p["attn"] = attn
    mlp = p.get("mlp")
    if mlp is not None and "wgu" in mlp:
        mlp = dict(mlp)
        mlp["wg"], mlp["wu"] = mlp.pop("wgu").members()
        p["mlp"] = mlp
    return p


def unfuse_params_for_oracle(params: Tree) -> Tree:
    new = dict(params)
    new["stages"] = [[tuple(unfuse_block_params(bp) for bp in lp)
                      for lp in sp] for sp in params["stages"]]
    return new


def _kind_window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """The attention window of a block kind: ``local_window`` for
    ``local``, ``attn_window`` (None: full causal) for dense and moe."""
    if kind == "local":
        return cfg.local_window
    return cfg.attn_window if kind in ATTN_KINDS else None


def _cache_window(cfg: ArchConfig, kind: str, max_seq: int) -> int:
    """Ring slots a block kind's decode cache holds: its window, at most
    ``max_seq``."""
    w = _kind_window(cfg, kind)
    return min(w, max_seq) if w is not None else max_seq


# ---------------------------------------------------------------------------
# Full sequence (calibration)
# ---------------------------------------------------------------------------
def _cross(cfg: ArchConfig, p: Tree, x: torch.Tensor,
           positions: torch.Tensor, enc_out, enc_pos, attn_chunk: int,
           return_kv: bool = False, shards=None):
    """A decoder block's cross-attention on its ``ln_x``-normed input
    over ``enc_out`` at ``enc_pos``: non-causal, no RoPE.  Without
    ``enc_out`` the keys come from the block's own normed stream, as in
    the reference (its ``quantize_model_baseline`` calibrates a block
    so).  With ``shards``, over this rank's heads."""
    return L.attention_full(cfg, p["xattn"], _norm(cfg, p["ln_x"], x, shards),
                            positions, causal=False, attn_chunk=attn_chunk,
                            use_rope=False, xkv=enc_out,
                            kv_positions=enc_pos, return_kv=return_kv,
                            shards=shards)


def block_full(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               attn_chunk: int = 1024,
               aux: Optional[List[torch.Tensor]] = None,
               enc_out: Optional[torch.Tensor] = None,
               enc_pos: Optional[torch.Tensor] = None,
               shards=None) -> torch.Tensor:
    """One block over a whole sequence: x (B, S, D), positions (B, S)
    -> x + attention (or the RG-LRU), + the cross-attention over
    ``enc_out`` (B, S_enc, D) at ``enc_pos`` in a decoder block of an
    encoder-decoder model, then + MLP or MoE; x + the xLSTM cell for
    mlstm and slstm (whose FFN is inside the cell).  With ``aux`` given,
    a moe block appends its router's load-balancing loss to it.  With
    ``shards`` (the sharded train step, any kind), ``p`` holds this
    rank's tensor-parallel shards, gathered over data, and x this data
    rank's rows: replicated over "model", or this rank's chunk of the
    sequence (positions whole) where ``shards.seq`` is set
    (``Shards.along``), on which the norms and the residual adds run; a
    moe block's aux is this data rank's share of the global batch's."""
    _check_kind(kind)
    if kind in XLSTM_KINDS:
        return _xlstm_seq(cfg, kind, p, x, shards)[0]
    if kind == "rglru":
        h, _, _ = R.rglru_seq(cfg, p["rec"], _norm(cfg, p["ln1"], x, shards),
                              shards=shards)
        x = x + h
        return x + L.apply_mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x, shards),
                               shards)
    h = L.attention_full(cfg, p["attn"], _norm(cfg, p["ln1"], x, shards),
                         positions, causal=causal,
                         window=_kind_window(cfg, kind),
                         attn_chunk=attn_chunk, shards=shards)
    x = x + h
    if "xattn" in p:
        x = x + _cross(cfg, p, x, positions, enc_out, enc_pos, attn_chunk,
                       shards=shards)
    return x + _ffn(cfg, kind, p["mlp"], _norm(cfg, p["ln2"], x, shards),
                    shards, aux)


def stage_full(cfg: ArchConfig, stage: Stage, sparams, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               attn_chunk: int = 1024, enc_out=None, enc_pos=None,
               remat: bool = False, shards=None, sspec=None):
    """A stage's layers over a whole sequence (the loss forward, the
    encoder).  Returns (x, aux): aux is the f32 sum of the moe blocks'
    auxiliary losses in depth order (0 for dense blocks).  With
    ``remat`` each superblock (one pass over the pattern) keeps only
    its inputs for the backward pass and runs again there
    (``torch.utils.checkpoint``), as the reference wraps its scanned
    body in ``jax.checkpoint``.  With ``shards``, ``sparams`` are this
    rank's shards and ``sspec`` their specs: each superblock gathers
    its leaves over data first, inside the checkpoint, so that remat
    gathers them again in the recomputation; on the sequence-parallel
    stream (``shards.seq``) x is this rank's chunk, and so is what a
    checkpoint keeps."""
    def superblock(x, aux, lp, li):
        if shards is not None:
            lp = shards.gather_tree(lp, sspec[li])
        for i, kind in enumerate(stage.pattern):
            a: List[torch.Tensor] = []
            x = block_full(cfg, kind, lp[i], x, positions, causal=causal,
                           attn_chunk=attn_chunk, aux=a, enc_out=enc_out,
                           enc_pos=enc_pos, shards=shards)
            for t in a:
                aux = aux + t
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(sparams):
        if remat:
            x, aux = checkpoint(superblock, x, aux, lp, li,
                                use_reentrant=False)
        else:
            x, aux = superblock(x, aux, lp, li)
    return x, aux


# ---------------------------------------------------------------------------
# Whole-prompt prefill, and decode over the contiguous ring caches
# ---------------------------------------------------------------------------
def block_prefill(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
                  positions: torch.Tensor, max_seq: int,
                  attn_chunk: int = 1024, enc_out=None, enc_pos=None,
                  shards=None):
    """One block over a whole (left-padded) prompt.  Returns (x, cache):
    the ring cache {"k", "v": (B, W, hkv, dh), "p": (B, W)} of an
    attention block ({"self": ring, "xk", "xv": (B, S_enc, hkv, dh)} with
    a cross-attention, whose K/V over ``enc_out`` are kept as they were
    computed), or a recurrent block's final state: rglru {"h": (B, R),
    "conv": (B, cw-1, R)}, mlstm {"c", "n"}, slstm {"h", "c", "n", "m"}.
    The recurrence runs over the padding too, as in the reference.

    With ``shards`` (sharded serving, every kind) ``p`` holds this
    rank's leaves and packed views and x this data rank's rows,
    replicated over "model"; the caches are as the reference declares
    them (``declare_stage_cache``): an attention block's ring (and cross
    K/V) of this rank's run-time KV heads, an rglru block's state of its
    R / tp channels, the xLSTM state whole on every model rank (the
    mLSTM's heads gathered over "model" here, the sLSTM's scan
    replicated); row-parallel products go through ``Shards.row``.  On
    the sequence-parallel stream (``shards.seq``) x is this rank's
    chunk, as in :func:`block_full`; the caches come from the gathered
    input and are the same."""
    _check_kind(kind)
    if kind in XLSTM_KINDS:
        x, state = _xlstm_seq(cfg, kind, p, x, shards)
        if kind == "mlstm" and shards is not None:
            state = {k: shards.gather_heads(v, cfg.n_heads, 1)
                     for k, v in state.items()}
        return x, state
    if kind == "rglru":
        h, h_n, conv = R.rglru_seq(cfg, p["rec"],
                                   _norm(cfg, p["ln1"], x, shards),
                                   shards=shards)
        x = x + h
        return x + L.apply_mlp(cfg, p["mlp"],
                               _norm(cfg, p["ln2"], x, shards), shards), \
            {"h": h_n, "conv": conv}
    h, cache = L.attention_full(
        cfg, p["attn"], _norm(cfg, p["ln1"], x, shards), positions,
        causal=True, window=_kind_window(cfg, kind),
        attn_chunk=attn_chunk,
        cache_window=_cache_window(cfg, kind, max_seq), shards=shards)
    x = x + h
    if "xattn" in p:
        h, xk, xv = _cross(cfg, p, x, positions, enc_out, enc_pos,
                           attn_chunk, return_kv=True, shards=shards)
        x = x + h
        cache = {"self": cache, "xk": xk, "xv": xv}
    return x + _ffn(cfg, kind, p["mlp"], _norm(cfg, p["ln2"], x, shards),
                    shards), cache


def _xlstm_seq(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
               shards=None):
    """An mlstm or slstm block over a whole sequence: (x + the cell,
    its final state; the mLSTM's of this rank's heads under
    ``shards``)."""
    seq = R.mlstm_seq if kind == "mlstm" else R.slstm_seq
    h, state = seq(cfg, p["cell"], _norm(cfg, p["ln1"], x, shards),
                   shards=shards)
    return x + h, state


def _stack(caches: List[Tree]) -> Tree:
    """Per-layer cache dicts (nested for a cross block) -> one dict of
    tensors stacked on a leading layer axis."""
    if isinstance(caches[0], dict):
        return {k: _stack([c[k] for c in caches]) for k in caches[0]}
    return torch.stack(caches)


def stage_prefill(cfg: ArchConfig, stage: Stage, sparams, x: torch.Tensor,
                  positions: torch.Tensor, max_seq: int,
                  attn_chunk: int = 1024, enc_out=None, enc_pos=None,
                  shards=None, sspec=None):
    """Prefill a stage.  Returns (x, caches): per pattern position, the
    layers' caches stacked on a leading layer axis.  With ``shards``
    (sharded serving) ``sparams`` are this rank's local leaves and
    packed views and ``sspec`` their specs (each layer's leaves over
    data gathered first), and the caches hold this rank's rows and
    run-time KV heads; x is this rank's chunk of the sequence-parallel
    stream where ``shards.seq`` is set."""
    per_pos: List[List[Tree]] = [[] for _ in stage.pattern]
    for li, lp in enumerate(sparams):
        if shards is not None:
            lp = shards.gather_tree(lp, sspec[li])
        for i, kind in enumerate(stage.pattern):
            x, c = block_prefill(cfg, kind, lp[i], x, positions, max_seq,
                                 attn_chunk, enc_out, enc_pos, shards)
            per_pos[i].append(c)
    return x, tuple(_stack(cs) for cs in per_pos)


def _rglru_step(cfg: ArchConfig, p: Tree, x: torch.Tensor, cache: Tree,
                layer: int, promote: bool, shards=None) -> torch.Tensor:
    """One decode step of an rglru block against its stacked state,
    written back in place at ``layer``.  With ``promote`` the conv state
    takes the step's dtype first, as the reference's scanned contiguous
    decode returns it (an f32 model's state leaves its bf16 declaration
    at the first step); without, it is written back into its buffer's
    dtype, as the reference's unrolled paged walk does.  ``shards``
    (sharded serving): the state holds this rank's channels."""
    out, h, conv = R.rglru_step(cfg, p["rec"], L.apply_norm(cfg, p["ln1"], x),
                                cache["h"][layer], cache["conv"][layer],
                                shards)
    if promote and cache["conv"].dtype != conv.dtype:
        cache["conv"] = cache["conv"].to(conv.dtype)
    cache["h"][layer] = h
    cache["conv"][layer] = conv
    x = x + out
    return x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x),
                           shards)


def _xlstm_step(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
                cache: Tree, layer: int, shards=None) -> torch.Tensor:
    """One decode step of an mlstm or slstm block against its stacked
    f32 state, written back at ``layer``: the mLSTM's (B, H, dk, dv)
    matrix memory is updated where it lies.  ``shards`` (sharded
    serving): the state is whole on every model rank."""
    z = L.apply_norm(cfg, p["ln1"], x)
    if kind == "mlstm":
        return x + R.mlstm_step_(cfg, p["cell"], z, cache["c"][layer],
                                 cache["n"][layer], shards)
    out, state = R.slstm_step(cfg, p["cell"], z,
                              {k: v[layer] for k, v in cache.items()},
                              shards)
    for k, v in state.items():
        cache[k][layer] = v
    return x + out


def block_step(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
               pos: torch.Tensor, cache: Tree, max_seq: int, layer: int,
               shards=None):
    """One decode step of one block against its stacked caches at
    ``layer``; with ``shards`` (sharded serving, every kind), as
    :func:`block_prefill`."""
    _check_kind(kind)
    if kind in XLSTM_KINDS:
        return _xlstm_step(cfg, kind, p, x, cache, layer, shards), cache
    if kind == "rglru":
        return _rglru_step(cfg, p, x, cache, layer, promote=True,
                           shards=shards), cache
    cross = "xattn" in p
    h, _ = L.attention_decode(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), pos,
        cache["self"] if cross else cache, layer=layer,
        window=_kind_window(cfg, kind), shards=shards)
    x = x + h
    if cross:
        x = x + L.attention_cross_decode(
            cfg, p["xattn"], L.apply_norm(cfg, p["ln_x"], x),
            cache["xk"][layer], cache["xv"][layer], shards)
    return x + _ffn(cfg, kind, p["mlp"], L.apply_norm(cfg, p["ln2"], x),
                    shards), cache


def stage_step(cfg: ArchConfig, stage: Stage, sparams, x: torch.Tensor,
               pos: torch.Tensor, caches, max_seq: int, shards=None,
               sspec=None):
    """Decode walk over a stage; each layer writes its slot of the
    stacked ring caches in place.  With ``shards`` and the stage's
    ``sspec``, as :func:`stage_prefill`."""
    for layer, lp in enumerate(sparams):
        if shards is not None:
            lp = shards.gather_tree(lp, sspec[layer])
        for i, kind in enumerate(stage.pattern):
            x, _ = block_step(cfg, kind, lp[i], x, pos, caches[i], max_seq,
                              layer, shards)
    return x, caches


def init_stage_cache(cfg: ArchConfig, stage: Stage, batch: int,
                     max_seq: int, dtype=torch.bfloat16, device="cpu",
                     enc_len: int = 0) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Empty decode caches for a stage: per pattern position
    ``L.make_cache`` with every position -1 (under ``"self"`` beside
    zero cross K/V ``"xk"``, ``"xv"`` (L, B, enc_len, hkv, dh) for an
    encoder-decoder model given ``enc_len``), or a recurrent block's
    zero state at the decode batch."""
    out = []
    for kind in stage.pattern:
        _check_kind(kind)
        if kind not in ATTN_KINDS:
            out.append(R.init_recurrent_state(cfg, kind, batch,
                                              stage.repeats, device))
            continue
        c = L.make_cache(cfg, batch, _cache_window(cfg, kind, max_seq),
                         stage.repeats, dtype, device)
        c["p"].fill_(-1)
        if cfg.enc_dec and enc_len:
            x = L.make_cache(cfg, batch, enc_len, stage.repeats, dtype,
                             device)
            c = {"self": c, "xk": x["k"], "xv": x["v"]}
        out.append(c)
    return tuple(out)


def declare_stage_cache(cfg: ArchConfig, par, stage: Stage, batch: int,
                        max_seq: int, enc_len: int = 0) -> Tuple[Tree, ...]:
    """The decode caches of a stage as P leaves with logical axes (the
    reference's ``init_stage_cache``, the layout :func:`init_stage_cache`
    and :func:`stage_prefill` build), stacked on a leading ``layers``
    dim: ring caches of ``kv_heads_run`` heads, positions -1, the KV
    heads over "model" where they divide tp, else the window over
    "ctx" (each rank holds every run-time KV head over its chunk of the
    window, which ``layers.attention_full`` fills and
    ``layers.attention_decode`` reads), else replicated; an encoder-decoder block's cross K/V beside
    them (``enc_len`` positions); a recurrent block's state."""
    per_pos = []
    for kind in stage.pattern:
        _check_kind(kind)
        if kind in ATTN_KINDS:
            w = _cache_window(cfg, kind, max_seq)
            hkv = par.kv_heads_run(cfg.n_kv_heads, cfg.n_heads)
            tp = max(par.tp, 1)
            if hkv % tp == 0:
                kv_axes = ("batch", None, "kv_heads", None)
            elif w % tp == 0:
                kv_axes = ("batch", "ctx", "kv_heads", None)
            else:
                kv_axes = ("batch", None, None, None)
            shape = (batch, w, hkv, cfg.head_dim_)
            c = {"k": P(shape, kv_axes, "zeros"),
                 "v": P(shape, kv_axes, "zeros"),
                 "p": P((batch, w), ("batch", None), "neg_ones",
                        torch.int32)}
            if cfg.enc_dec and enc_len:
                xa = (("batch", None, "kv_heads", None) if hkv % tp == 0
                      else (("batch", "ctx", "kv_heads", None)
                            if enc_len % tp == 0
                            else ("batch", None, None, None)))
                xs = (batch, enc_len, hkv, cfg.head_dim_)
                c = {"self": c, "xk": P(xs, xa, "zeros"),
                     "xv": P(xs, xa, "zeros")}
        else:
            c = R.declare_recurrent_state(cfg, kind, batch)
        per_pos.append(stack_p(c, stage.repeats))
    return tuple(per_pos)


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill
# ---------------------------------------------------------------------------
def block_step_paged(cfg: ArchConfig, kind: str, p: Tree, x: torch.Tensor,
                     pos: torch.Tensor, cache: Tree,
                     block_tables: torch.Tensor, context_lens: torch.Tensor,
                     layer: int):
    """Paged variant of :func:`block_step` for attention blocks; a
    recurrent block keeps its per-slot state and steps as on the
    contiguous path (an rglru block's conv state keeps its buffer's
    dtype)."""
    _check_kind(kind)
    if kind in XLSTM_KINDS:
        return _xlstm_step(cfg, kind, p, x, cache, layer), cache
    if kind == "rglru":
        return _rglru_step(cfg, p, x, cache, layer, promote=False), cache
    h, cache = L.attention_decode_paged(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), pos, cache,
        block_tables, context_lens, layer=layer,
        window=_kind_window(cfg, kind))
    x = x + h
    return x + _ffn(cfg, kind, p["mlp"], L.apply_norm(cfg, p["ln2"], x)), \
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
    """One block of one chunk of paged prefill: attention kinds only (the
    engine refuses chunked prefill for the others, as the reference)."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"chunked paged prefill supports attention blocks only, got "
            f"{kind!r}: serve recurrent stages with whole-prompt prefill")
    h, cache = L.attention_prefill_paged(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), positions, cache,
        bt_read, bt_write, start, length, layer=layer,
        window=_kind_window(cfg, kind))
    x = x + h
    return x + _ffn(cfg, kind, p["mlp"], L.apply_norm(cfg, p["ln2"], x)), \
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


def stage_splice_paged(cfg: ArchConfig, stage: Stage, pool_stage: Tree,
                       cache1_stage: Tree, slot: int,
                       bt_row: torch.Tensor) -> Tree:
    """Splice one request's whole-prompt prefill caches (batch 1), in
    place: attention caches scatter into the pages of ``bt_row`` by
    absolute token position; recurrent state goes into decode slot
    ``slot``."""
    for kind, pool, c1 in zip(stage.pattern, pool_stage, cache1_stage):
        _check_kind(kind)
        if kind in ATTN_KINDS:
            L.scatter_pages(pool, c1["k"][:, 0], c1["v"][:, 0],
                            c1["p"][0, 0], bt_row)
        else:
            for name in pool:
                pool[name][:, slot] = c1[name][:, 0]
    return pool_stage


def stage_copy_pages(stage: Stage, pool_stage: Tree, src: torch.Tensor,
                     dst: torch.Tensor) -> Tree:
    """Copy-on-write page copies ``pool[:, dst] = pool[:, src]`` across
    every layer of the stage's attention pools, in place; recurrent
    per-slot state owns no pages and passes through."""
    for kind, pool in zip(stage.pattern, pool_stage):
        if kind not in ATTN_KINDS:
            continue
        for t in (pool["k"], pool["v"]):
            t[:, dst.long()] = t[:, src.long()]
    return pool_stage


def init_stage_cache_paged(cfg: ArchConfig, stage: Stage, num_pages: int,
                           page_size: int, dtype=torch.bfloat16,
                           device="cpu", n_slots: int = 1
                           ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Attention blocks share one ``(num_pages, page_size)`` pool per
    pattern position; a recurrent block keeps per-slot state at the
    decode batch ``n_slots`` (at its own dtypes, not the pools').  A
    stage of recurrent blocks alone has no pool: its requests still hold
    pages in the engine's tables, as in the reference."""
    out = []
    for kind in stage.pattern:
        _check_kind(kind)
        if kind in ATTN_KINDS:
            out.append(L.make_paged_cache(cfg, num_pages, page_size,
                                          stage.repeats, dtype, device))
        else:
            out.append(R.init_recurrent_state(cfg, kind, n_slots,
                                              stage.repeats, device))
    return tuple(out)
