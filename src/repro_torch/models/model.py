"""Model facade (twin of ``repro.models.model``): parameter declaration,
embedding and head, the causal-LM loss, whole-prompt prefill and decode
over the contiguous ring caches, and the paged serving path (page
pools, one paged decode step, one chunked paged prefill step, and the
splice of a whole-prompt prefill into pages).

The frontends are stubs over precomputed embeddings, as in the
reference: a vision model (``cfg.frontend == "vision"``) takes
``vision_embeds`` (B, F, D) in place of its first F token embeddings
when a batch carries them, and text alone otherwise; an
encoder-decoder model (``cfg.enc_dec``) encodes ``frames`` (B, S_enc,
D) with a non-causal dense stack (``params["enc"]``) whose output every
decoder block cross-attends.  The paged path refuses encoder-decoder
models, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Stage
from repro_torch.core.qlinear import QLinear, QLinearGroup
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.linear import dense
from repro_torch.distributed.sharding import distribute_tree, local_tree
from repro_torch.models.common import Parallel, Shards
from repro_torch.models.param import P, count_params, materialize

Tree = Any
XENT_CHUNK = 512
ENC_FRAMES = 1024       # seamless stub: the speech-frame budget a request has


def _enc_stage(cfg: ArchConfig) -> Stage:
    return Stage(("dense",), cfg.n_enc_layers)


def declare_params(cfg: ArchConfig, par: Optional[Parallel] = None) -> Tree:
    """The model's P tree.  ``par`` (default one device) changes no
    leaf: parameters keep the true KV head count, and the replication
    to the TP degree happens at run time (``layers``), as in the
    reference."""
    d, v = cfg.d_model, cfg.vocab_padded
    p: Dict[str, Tree] = {
        "embed": P((v, d), ("vocab", "embed"), "normal"),
        "stages": [T.init_stage(cfg, s, cross=cfg.enc_dec)
                   for s in cfg.stages],
        "final_norm": L.init_norm(cfg),
    }
    if not cfg.tied_embeddings:
        p["lm_head"] = P((d, v), ("embed", "vocab"), "scaled")
    if cfg.enc_dec:
        p["enc"] = {"stages": [T.init_stage(cfg, _enc_stage(cfg))],
                    "final_norm": L.init_norm(cfg)}
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu",
                par: Optional[Parallel] = None) -> Tree:
    return materialize(declare_params(cfg, par), seed, device)


def n_params(cfg: ArchConfig, par: Optional[Parallel] = None) -> int:
    """Parameters declared for ``cfg`` (the reference's ``n_params``)."""
    return count_params(declare_params(cfg, par))


def embed_tokens(cfg: ArchConfig, params: Tree, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head_weight(cfg: ArchConfig, params: Tree):
    if cfg.tied_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _mask_pad(cfg: ArchConfig, logits: torch.Tensor, offset: int = 0
              ) -> torch.Tensor:
    """Padded vocabulary entries -> the f32 minimum; ``logits`` are the
    vocabulary entries from ``offset`` on (a vocab-parallel shard)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    keep = torch.arange(offset, offset + logits.shape[-1],
                        device=logits.device) < cfg.vocab
    return torch.where(keep, logits.to(torch.float32),
                       torch.finfo(torch.float32).min)


def _embed_sharded(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
                   shards) -> torch.Tensor:
    """The vocab-parallel lookup: this rank's rows of the embedding
    (gathered over data) give the tokens they hold, zeros elsewhere,
    summed over "model" into the stream (``Shards.stream_out``: this
    rank's chunk of the sequence-parallel one)."""
    e = shards.gather(params["embed"], shards.specs["embed"])
    if shards.tp == 1:
        return e[tokens.long()]
    rows = e.shape[0]
    idx = tokens.long() - shards.tp_rank * rows
    inside = (idx >= 0) & (idx < rows)
    x = e[idx.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return shards.stream_out(x)


def _head_sharded(cfg: ArchConfig, params: Tree, shards):
    """This rank's vocabulary columns of the head, gathered over data,
    and the vocabulary offset of its first column."""
    key = "embed" if cfg.tied_embeddings else "lm_head"
    w = shards.gather(params[key], shards.specs[key])
    w = w.T if cfg.tied_embeddings else w
    return w, shards.tp_rank * w.shape[1]


def logits_fn(cfg: ArchConfig, params: Tree, x: torch.Tensor
              ) -> torch.Tensor:
    """Final norm and the head, a plain matmul in the activation dtype;
    padded vocabulary entries are masked to the f32 minimum."""
    x = L.apply_norm(cfg, params["final_norm"], x)
    return _mask_pad(cfg, dense(x, _head_weight(cfg, params)))


def softmax_xent_chunked(cfg: ArchConfig, params: Tree, x: torch.Tensor,
                         targets: torch.Tensor, chunk: int = XENT_CHUNK,
                         shards=None) -> torch.Tensor:
    """Mean cross entropy of the head over x (B, S, D) against targets
    (B, S), targets < 0 masked out, without forming (B, S, V) logits:
    sequence chunks of ``chunk`` positions, each recomputed in the
    backward pass (activation checkpointing).

    With ``shards`` the rows are this data rank's and the head's
    columns its vocabulary shard: the log-sum-exp takes its max and its
    sum over "model", the target's logit comes from the rank that holds
    it, and the mean divides by the masked count of every data rank, so
    the data ranks' losses sum to the global mean.  On the
    sequence-parallel stream (``shards.seq``) x is this rank's chunk:
    the final norm runs on it and the normed stream enters whole
    (``Shards.stream_in``) before the head."""
    norm = params["final_norm"]
    if shards is None:
        x = L.apply_norm(cfg, norm, x)
        w, off = _head_weight(cfg, params), 0
    else:
        norm = shards.stream_leaf(shards.gather_tree(
            norm, shards.specs["final_norm"]))
        x = shards.stream_in(L.apply_norm(cfg, norm, x))
        w, off = _head_sharded(cfg, params, shards)
    b, s, _ = x.shape
    parallel = shards is not None and shards.tp > 1
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s

    def chunk_loss(xx, tt):
        logits = _mask_pad(cfg, dense(xx, w).to(torch.float32), off)
        tgt = tt.clamp_min(0).long()
        if not parallel:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
        else:
            m = shards.model_max(torch.amax(logits, dim=-1))
            lse = m + torch.log(shards.leave(
                torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
            idx = tgt - off
            inside = (idx >= 0) & (idx < logits.shape[-1])
            picked = torch.gather(
                logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])
            picked = shards.leave(torch.where(inside, picked[..., 0], 0.0))
        mask = (tt >= 0).to(torch.float32)
        return torch.sum((lse - picked) * mask), torch.sum(mask)

    loss = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for c0 in range(0, s, chunk):
        l_c, n_c = checkpoint(chunk_loss, x[:, c0:c0 + chunk],
                              targets[:, c0:c0 + chunk], use_reentrant=False)
        loss, cnt = loss + l_c, cnt + n_c
    if shards is not None:
        cnt = shards.data_sum(cnt)
    return loss / torch.clamp_min(cnt, 1.0)


def _backbone_inputs(cfg: ArchConfig, params: Tree,
                     batch: Dict[str, torch.Tensor], shards=None):
    """Token embeddings, the first F of them replaced by the batch's
    ``vision_embeds`` (B, F, D) in a vision model, and positions
    (default 0..S-1 per row).  On the sequence-parallel stream
    (``shards.seq``) the embeddings are this rank's chunk of positions
    [lo, hi), and the vision embeddings of those positions take their
    place (the splice of the whole, cut to the chunk); positions stay
    whole."""
    tokens = batch["tokens"]
    x = (embed_tokens(cfg, params, tokens) if shards is None
         else _embed_sharded(cfg, params, tokens, shards))
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"]
        lo = 0 if shards is None or shards.seq is None else shards.chunk()[0]
        k = max(0, min(ve.shape[1] - lo, x.shape[1]))
        x = torch.cat([ve[:, lo:lo + k].to(x.dtype), x[:, k:]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    return x, positions


def encode(cfg: ArchConfig, params: Tree, frames: torch.Tensor,
           attn_chunk: int = 1024, shards=None):
    """The encoder over precomputed frame embeddings (the stub
    frontend): frames (B, S_enc, D) -> (enc_out (B, S_enc, D), enc_pos
    (B, S_enc) = 0..S_enc-1), non-causal, then the encoder's final
    norm.  With ``shards``, ``frames`` are this data rank's rows and the
    encoder's leaves its shards, gathered over data a superblock at a
    time (not rematerialized, as in the reference).  Its stream is
    sequence-parallel where ``Shards.splits`` S_enc (the reference
    hints the frames so): each rank runs its chunk of the frames, and
    the normed output is gathered over "model" once here for every
    decoder block's cross K/V (its backward reduce-scatters their
    gradients, which ``layers.attention_full`` then leaves alone)."""
    b, s, _ = frames.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=frames.device).expand(b, s)
    x = frames
    enc = params["enc"]
    espec = None
    if shards is not None:
        shards = shards.along(s)
        espec = shards.specs["enc"]
        x = shards.stream_part(frames)
    for si, sp in enumerate(enc["stages"]):
        x, _ = T.stage_full(cfg, _enc_stage(cfg), sp, x, pos, causal=False,
                            attn_chunk=attn_chunk, shards=shards,
                            sspec=None if espec is None
                            else espec["stages"][si])
    norm = enc["final_norm"]
    if shards is None:
        return L.apply_norm(cfg, norm, x), pos
    norm = shards.stream_leaf(shards.gather_tree(norm, espec["final_norm"]))
    x = L.apply_norm(cfg, norm, x)
    return (x if shards.seq is None else shards.stream_in(x)), pos


def _encoded(cfg: ArchConfig, params: Tree, batch, attn_chunk: int,
             shards=None):
    """(enc_out, enc_pos) of the batch's ``frames`` for an
    encoder-decoder model (a batch without them raises the reference's
    KeyError), else (None, None)."""
    if not cfg.enc_dec:
        return None, None
    return encode(cfg, params, batch["frames"], attn_chunk, shards)


def forward_loss(cfg: ArchConfig, params: Tree,
                 batch: Dict[str, torch.Tensor],
                 attn_chunk: int = 1024, remat: bool = False,
                 shards=None) -> torch.Tensor:
    """Causal-LM loss plus 0.01 times the MoE blocks' load-balancing
    loss (0 for a dense decoder).  batch: tokens (B, S) and targets
    (B, S) int (-1 = masked), optional positions (B, S); optional
    ``vision_embeds`` (B, F, D) for a vision model, ``frames`` (B,
    S_enc, D) for an encoder-decoder one.  ``remat`` recomputes each
    decoder superblock in the backward pass (the encoder is not
    rematerialized, as in the reference); the loss and its gradients
    are the same.

    With ``shards`` (``models.common.Shards``, the sharded train step)
    ``params`` are this rank's local shards and the batch its data rows
    (``frames`` too); the result is this data rank's share of the
    global mean loss plus its share of the aux (the shares sum to the
    global loss over the data ranks), and the gradients reach each
    local shard reduced over the ranks.  Under a mesh with more than
    one data rank the MoE is the reference's group-local function
    (``layers.apply_moe``), and with ``par.sp`` the residual stream
    between blocks is this rank's chunk of the sequence
    (``Shards.along``)."""
    if shards is not None:
        shards = shards.along(batch["tokens"].shape[1])
    x, positions = _backbone_inputs(cfg, params, batch, shards)
    enc_out, enc_pos = _encoded(cfg, params, batch, attn_chunk, shards)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (stage, sp) in enumerate(zip(cfg.stages, params["stages"])):
        x, a = T.stage_full(
            cfg, stage, sp, x, positions, causal=True,
            attn_chunk=attn_chunk, enc_out=enc_out, enc_pos=enc_pos,
            remat=remat, shards=shards,
            sspec=None if shards is None else shards.specs["stages"][si])
        aux = aux + a
    loss = softmax_xent_chunked(cfg, params, x, batch["targets"],
                                shards=shards)
    return loss + 0.01 * aux


def _holds(tree: Tree, pred) -> bool:
    """True when a node of ``tree`` satisfies ``pred``."""
    if pred(tree):
        return True
    if isinstance(tree, dict):
        return any(_holds(v, pred) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds(v, pred) for v in tree)
    return False


def check_shardable(cfg: ArchConfig, par: Parallel,
                    params: Optional[Tree] = None, ep: bool = False,
                    serving: bool = False) -> None:
    """Refuse what the sharded step does not run.

    Training (the default): packed (``QLinear``, ``QLinearGroup``)
    leaves in ``params`` (``NotImplementedError``: the train step takes
    floating-point parameters).  Serving (``serving``: ``prefill`` and
    ``decode_step`` with ``shards``) runs every block kind and the
    encoder-decoder model (its cross K/V context-sharded where its
    run-time KV heads do not divide tp), on packed leaves unfused or
    fused (``QLinearGroup``: ``wqkv``, ``wgu``).  Both: tensor-parallel
    shards that would cut a stored leaf unevenly (``ValueError``): the
    ffn, the padded vocabulary, the rnn width, the columns of the query
    and KV heads and of the xLSTM's projections, or (under EP, ``ep``)
    the experts.  The reference's placement refuses these too: JAX
    places only even shards (``jit``'s ``in_shardings`` and
    ``device_put`` of ``declare_quantized``'s specs raise its
    "should be divisible" ``ValueError``), so padding them would be a
    feature the reference lacks.  Head counts themselves are not among
    them: a rank computes its whole heads (``Shards.heads``:
    phi4-mini's 24 query heads, llava's 56, recurrentgemma's 10 and the
    RG-LRU's 8 gate heads, the xLSTM's 4, at tp 16), and the byte rows
    of packed leaves take uneven chunks
    (``distributed.sharding.qlinear_local``)."""
    kinds = {k for s in cfg.stages for k in s.pattern}
    tp = par.tp
    if not serving and params is not None and _holds(
            params, lambda x: isinstance(x, (QLinear, QLinearGroup))):
        raise NotImplementedError(
            f"{cfg.name}: the sharded train step takes floating-point "
            "parameters, not packed QLinear leaves")
    d, dh = cfg.d_model, cfg.head_dim_
    splits = [("d_ff", cfg.d_ff), ("padded vocabulary", cfg.vocab_padded)]
    if kinds & set(T.ATTN_KINDS):
        splits += [("query head columns", cfg.n_heads * dh),
                   ("KV head columns", cfg.n_kv_heads * dh)]
    if "rglru" in kinds:
        splits.append(("rnn width", cfg.rnn_width or d))
    if "mlstm" in kinds:
        splits += [("mLSTM key columns", d),
                   ("mLSTM value columns", int(cfg.mlstm_proj_factor * d))]
    if "slstm" in kinds:
        splits.append(("sLSTM gate columns", 4 * d))
    if "moe" in kinds and ep:
        splits.append(("experts under EP", cfg.moe.n_experts))
    for what, n in splits:
        if n % tp:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over "
                             f"tp={tp}")


# the leaves whose output columns are query heads: a rank's view of a
# packed one takes its whole heads (``Shards.heads``)
HEAD_LEAVES = ("wq", "w_q", "w_k", "w_v", "w_gate")


def head_count(cfg: ArchConfig, declared: Tree, path) -> Optional[int]:
    """The heads of the output columns of the leaf at ``path`` when a
    rank's column view must take whole heads of them (a query
    projection of attention or of the mLSTM: its output axis "heads"
    in the declaration ``declared``), else None (KV, ffn, rnn and the
    sLSTM's gates keep their N / tp columns)."""
    node = declared
    for k in path:
        node = node[k]
    if path[-1] in HEAD_LEAVES and node.axes[-1] == "heads":
        return cfg.n_heads
    return None


# ---------------------------------------------------------------------------
# Whole-prompt prefill and decode over the contiguous ring caches
# ---------------------------------------------------------------------------
def _logits_sharded(cfg: ArchConfig, params: Tree, x: torch.Tensor,
                    shards) -> torch.Tensor:
    """:func:`logits_fn` over this rank's vocabulary columns of the head,
    gathered over "model": every rank gets the whole vocabulary."""
    norm = shards.gather_tree(params["final_norm"],
                              shards.specs["final_norm"])
    x = shards.enter(L.apply_norm(cfg, norm, x))
    w, off = _head_sharded(cfg, params, shards)
    return shards.gather_model(_mask_pad(cfg, dense(x, w), off), x.ndim - 1)


def prefill(cfg: ArchConfig, params: Tree, batch: Dict[str, torch.Tensor],
            max_seq: int, attn_chunk: int = 1024, shards=None):
    """Whole-sequence prefill.  batch: tokens (B, S) int32 and optional
    positions (B, S) int32 (-1 = left padding); ``vision_embeds`` or
    ``frames`` as for :func:`forward_loss`.  Returns (last-token logits
    (B, 1, V), caches): per stage and pattern position, ring caches
    {"k", "v": (L, B, W, hkv, dh), "p": (L, B, W)} (under "self", beside
    the cross K/V "xk", "xv" (L, B, S_enc, hkv, dh) of an
    encoder-decoder model), or recurrent state {"h": (L, B, R), "conv":
    (L, B, cw-1, R)}.

    With ``shards`` (sharded serving, ``shard_for_serving``) ``params``
    are this rank's local leaves and packed views and the batch (and
    ``frames``) its data rows, or every row when the batch is not split
    over data (``par.shard_batch`` off); the embedding and head are
    vocab-parallel, the encoder and the blocks run this rank's heads,
    ffn columns and RG-LRU channels, the MoE is the reference's
    group-local one (``layers.apply_moe``), and the logits are gathered
    over "model", so every rank returns the whole vocabulary of its
    rows.  The caches are this rank's, in the layout of
    :func:`declare_caches`: its rows, its run-time KV heads (self and
    cross), its RG-LRU channels, the xLSTM state whole.  With
    ``par.sp`` the stream between blocks is this rank's chunk of the
    prompt (``Shards.along``), and the last position comes from the
    rank that holds it (``Shards.stream_last``)."""
    if shards is not None:
        shards = shards.along(batch["tokens"].shape[1])
    x, positions = _backbone_inputs(cfg, params, batch, shards)
    enc_out, enc_pos = _encoded(cfg, params, batch, attn_chunk, shards)
    caches = []
    for si, (stage, sp) in enumerate(zip(cfg.stages, params["stages"])):
        x, c = T.stage_prefill(
            cfg, stage, sp, x, positions, max_seq, attn_chunk, enc_out,
            enc_pos, shards,
            None if shards is None else shards.specs["stages"][si])
        caches.append(c)
    if shards is not None:
        return (_logits_sharded(cfg, params, shards.stream_last(x), shards),
                tuple(caches))
    return logits_fn(cfg, params, x[:, -1:]), tuple(caches)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device="cpu", enc_len: int = 0):
    """Empty decode caches for every stage: ring caches (positions -1)
    and zero recurrent state, ``batch`` rows each; with ``enc_len``, an
    encoder-decoder model's zero cross K/V of that many positions."""
    return tuple(T.init_stage_cache(cfg, s, batch, max_seq, dtype, device,
                                    enc_len)
                 for s in cfg.stages)


def declare_caches(cfg: ArchConfig, par: Parallel, batch: int,
                   max_seq: int, enc_len: int = 0) -> Tree:
    """The decode caches of every stage as P leaves with logical axes
    (the reference's ``init_caches``; ``transformer.declare_stage_cache``):
    what :func:`init_caches` builds and :func:`prefill` returns, for
    ``launch.inputs.decode_inputs``."""
    return tuple(T.declare_stage_cache(cfg, par, s, batch, max_seq, enc_len)
                 for s in cfg.stages)


def decode_step(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                pos: torch.Tensor, caches, max_seq: int, shards=None,
                enc_len: Optional[int] = None):
    """One decode step over the ring caches, every row.  token/pos (B,)
    int32.  Returns (logits (B, V), caches).  With ``shards``, as
    :func:`prefill`: this rank's rows, leaves and caches, the logits of
    the whole vocabulary.  ``enc_len``: an encoder-decoder model's
    encoder positions, which tell a rank whose run-time KV heads tp does
    not divide whether its cross K/V are its chunk of them or all of
    them (required there: ``layers.attention_cross_decode``)."""
    if shards is None:
        x = embed_tokens(cfg, params, token[:, None])
    else:
        x = _embed_sharded(cfg, params, token[:, None], shards)
    for si, (stage, sp, c) in enumerate(zip(cfg.stages, params["stages"],
                                            caches)):
        x, _ = T.stage_step(
            cfg, stage, sp, x, pos, c, max_seq, shards,
            None if shards is None else shards.specs["stages"][si], enc_len)
    if shards is not None:
        return _logits_sharded(cfg, params, x, shards)[:, 0], caches
    return logits_fn(cfg, params, x)[:, 0], caches


def shard_for_serving(cfg: ArchConfig, par: Parallel, params: Tree,
                      specs: Tree, mesh):
    """Place ``params`` (whole on every rank; packed leaves unfused or
    fused) on ``mesh`` by ``specs`` (``launch.qdeclare.declare_quantized``'s,
    or ``distributed.sharding.specs_for_tree(..., params=params)``: the
    unfused leaves' specs in both) and return (``Shards``, this rank's
    tree for :func:`prefill` and :func:`decode_step`): local tensors,
    each packed leaf as its ``qlinear_local`` view (the row views' O(K)
    vectors gathered over "model" once here; a query projection's
    columns those of the rank's whole heads, ``head_count``), each
    packed expert leaf as its ``expert_local`` one (wg / wu over ffn,
    wd whole, gathered once here whatever the storage spec), and each
    fused group (``wqkv``, ``wgu``) as its ``group_local`` one: its
    members placed by the specs of the unfused leaves of their names,
    their views side by side along N.  Refuses what sharded serving
    does not run (:func:`check_shardable` with ``serving``)."""
    check_shardable(cfg, par, params, serving=True)
    shards = Shards(mesh, par, specs)
    placed = distribute_tree(params, specs, mesh)
    declared = declare_params(cfg, par)
    return shards, local_tree(placed, specs, shards,
                              lambda path: head_count(cfg, declared, path))


def splice_prefill(cfg: ArchConfig, caches, cache1, slot: int):
    """Copy a batch-1 prefill cache into decode row ``slot`` of every
    ring and recurrent state, in place: the whole row, positions
    included, so nothing of the row's previous occupant stays live."""
    for cs, c1s in zip(caches, cache1):
        for c, c1 in zip(cs, c1s):
            for name in c:
                c[name][:, slot] = c1[name][:, 0]
    return caches


def init_paged_caches(cfg: ArchConfig, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cpu", n_slots: int = 1):
    """Page pools for every stage: per attention block
    ``(L, num_pages + 1, ps, hkv, dh)`` with the dump page last; per
    recurrent block its state at the decode batch ``n_slots``.  An
    encoder-decoder model keeps static cross K/V per request and is not
    paged (the reference's ``NotImplementedError``)."""
    if cfg.enc_dec:
        raise NotImplementedError("paged serving does not support enc-dec")
    return tuple(T.init_stage_cache_paged(cfg, s, num_pages, page_size,
                                          dtype, device, n_slots)
                 for s in cfg.stages)


def splice_prefill_paged(cfg: ArchConfig, caches, cache1, slot: int,
                         bt_row: torch.Tensor):
    """Scatter a batch-1 prefill cache into the pool pages of ``bt_row``
    (-1 entries and padding positions are dropped) and its recurrent
    state into decode slot ``slot``, in place."""
    return tuple(T.stage_splice_paged(cfg, stage, cs, c1, slot, bt_row)
                 for stage, cs, c1 in zip(cfg.stages, caches, cache1))


def copy_pages(cfg: ArchConfig, caches, src: torch.Tensor,
               dst: torch.Tensor):
    """Apply queued copy-on-write page copies in place (recurrent
    per-slot state owns no pages)."""
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
    scalars).  Returns (logits (1, V) at chunk row length-1, caches).
    Attention stages of a decoder-only model alone, as the reference."""
    if cfg.enc_dec:
        raise NotImplementedError("chunked prefill does not support enc-dec")
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
