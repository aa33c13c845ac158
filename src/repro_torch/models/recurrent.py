"""Recurrent blocks (twin of ``repro.models.recurrent``): the Griffin
RG-LRU block of RecurrentGemma and the xLSTM cells (mLSTM, sLSTM).

    RG-LRU: in-proj -> [causal depthwise conv -> RG-LRU] * gelu(gate)
            -> out-proj

The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` is elementwise.
Over a whole sequence (calibration, the loss, whole-prompt prefill) it
runs as a log-depth doubling scan in plain PyTorch: ceil(log2 S) rounds
of ``(a, b) <- (a * a_shift, a * b_shift + b)``, which autograd follows
(the Eq.-7 scale learning takes its gradients through it).  The
reference leaves the scan to XLA's ``associative_scan``; the two sum in
another order, so they agree to rounding, not bit for bit.

The mLSTM (matrix memory) runs a sequence chunkwise: within a chunk of
``chunk`` positions a gated linear attention with the decay matrix
masked to -inf above the diagonal before ``exp`` (the reference's
``where(causal, exp(decay), 0)`` gives the same values, but its
gradient is ``0 * inf`` there); across chunks the (dk x dv) state C and
the normalizer n, in f32.  The sLSTM (scalar memory, block-diagonal
recurrent matrices per head) is strictly sequential: a Python loop over
the positions, wrapped in :class:`SLSTMScan`, an autograd Function whose
backward walks the positions in reverse and takes the recurrent weight's
gradient as one contraction at the end, as the reference's custom VJP.
Decode is a single-step update of the carried state for every kind.

Every weight matmul goes through :func:`repro_torch.models.linear.dense`,
so the projections quantize (``w_x``, ``w_gate``, ``w_out``; ``w_q``,
``w_k``, ``w_v``; ``w_gates``, ``w_up``, ``w_down``); the block-diagonal
gate weights ``w_inp`` / ``w_rec`` and ``r_gates``, the conv, ``lam``,
the mLSTM's gate projection ``w_if`` and ``b_gates`` stay in floating
point (``w_if`` and ``b_gates`` f32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.linear import dense
from repro_torch.models.param import P

Tree = Any
RG_HEADS = 8            # block-diagonal gate heads (Griffin appendix)
_RG_C = 8.0             # Griffin's fixed exponent scale
# The decode state's conv window is declared at the reference's default
# parameter dtype; ``h`` is f32.
CONV_STATE_DTYPE = torch.bfloat16


def init_rglru(cfg: ArchConfig) -> Tree:
    d = cfg.d_model
    r = cfg.rnn_width or d
    hd = r // RG_HEADS
    return {
        "w_x": P((d, r), ("embed", "rnn"), "scaled"),
        "w_gate": P((d, r), ("embed", "rnn"), "scaled"),
        "conv_w": P((cfg.conv_width, r), (None, "rnn"), "scaled"),
        "conv_b": P((r,), ("rnn",), "zeros"),
        "w_inp": P((RG_HEADS, hd, hd), (None, None, None), "scaled"),
        "w_rec": P((RG_HEADS, hd, hd), (None, None, None), "scaled"),
        "lam": P((r,), ("rnn",), "ones", torch.float32),
        "w_out": P((r, d), ("rnn", "embed"), "scaled"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def _rg_gates(p: Tree, x: torch.Tensor, shards=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., R) -> input gate i_t and recurrence gate r_t (f32), each a
    block-diagonal product over the heads of ``w_inp`` / ``w_rec``
    (RG_HEADS, or a tensor-parallel rank's part of them).  With
    ``shards`` and gate heads that tp does not divide (``w_inp`` whole,
    wider than x), x is this rank's channels, which cut through a head
    (:func:`_rg_gates_cut`)."""
    h, hd = p["w_inp"].shape[:2]
    if shards is not None and h * hd != x.shape[-1]:
        return _rg_gates_cut(p, x, shards)
    shp = x.shape[:-1]
    xh = x.reshape(shp + (h, -1)).to(torch.float32)
    gi = torch.einsum("...hd,hde->...he", xh, p["w_inp"].to(torch.float32))
    gr = torch.einsum("...hd,hde->...he", xh, p["w_rec"].to(torch.float32))
    return (torch.sigmoid(gi.reshape(shp + (-1,))),
            torch.sigmoid(gr.reshape(shp + (-1,))))


def _rg_gates_cut(p: Tree, x: torch.Tensor, shards
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates of this rank's R / tp channels (``x``, their inputs)
    where they cut through the gate heads (recurrentgemma's 8 heads of
    320 over tp 16: 160 channels, half a head): a channel's gate takes
    its head's whole input, so x is gathered over "model" (backward:
    the gradient's reduce-scatter), and each head the rank's channels
    touch runs its input through the columns of ``w_inp[h]`` /
    ``w_rec[h]`` of those channels (the whole leaves, replicated)."""
    r_loc = x.shape[-1]
    hd = p["w_inp"].shape[1]
    lo = shards.tp_rank * r_loc
    xf = shards.gather_model(x, x.ndim - 1).to(torch.float32)
    gi, gr = [], []
    for h in range(lo // hd, -(-(lo + r_loc) // hd)):
        a = max(lo, h * hd) - h * hd
        e = min(lo + r_loc, (h + 1) * hd) - h * hd
        xh = xf[..., h * hd:(h + 1) * hd]
        gi.append(xh @ p["w_inp"][h, :, a:e].to(torch.float32))
        gr.append(xh @ p["w_rec"][h, :, a:e].to(torch.float32))
    return torch.sigmoid(torch.cat(gi, -1)), torch.sigmoid(torch.cat(gr, -1))


def _rg_decay(p: Tree, r_t: torch.Tensor) -> torch.Tensor:
    """a_t = sigmoid(lam) ** (c * r_t), in log space: log sigmoid(lam) =
    -softplus(-lam), softplus as log(exp(x) + 1) (``jax.nn.softplus``)."""
    lam = p["lam"].to(torch.float32)
    log_a = -torch.logaddexp(-lam, torch.zeros_like(lam))
    return torch.exp(_RG_C * r_t * log_a)


def _causal_conv(p: Tree, x: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width cw over x (B, S, R); ``state``
    (B, cw-1, R), the previous inputs, or None (zeros).  Returns the
    output and the last cw-1 inputs, both in x's dtype."""
    cw = p["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * p["conv_w"][i].to(x.dtype) for i in range(cw))
    return out + p["conv_b"].to(x.dtype), xp[:, -(cw - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t * h_{t-1} + b_t, h_0 = 0, along dim 1: a
    Hillis-Steele doubling scan, ceil(log2 S) rounds, each composing
    every element with the one ``d`` steps earlier (the first ``d`` are
    already whole prefixes)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _input(a_t: torch.Tensor, i_t: torch.Tensor, u: torch.Tensor
           ) -> torch.Tensor:
    """b_t = sqrt(max(1 - a_t^2, 1e-8)) * i_t * u (f32)."""
    return torch.sqrt(torch.clamp_min(1.0 - a_t * a_t, 1e-8)) * (
        i_t * u.to(torch.float32))


def rglru_seq(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              h0: Optional[torch.Tensor] = None,
              conv0: Optional[torch.Tensor] = None, shards=None):
    """The block over a whole sequence: x (B, S, D) -> (out (B, S, D),
    the final h (B, R) f32, the conv state (B, cw-1, R)).  A carried
    ``h0`` folds into the first step: b_1 += a_1 * h0.

    With ``shards`` (the sharded train step, and sharded serving) x is
    the stream, which enters whole (``Shards.stream_in``: gathered from
    this rank's chunk of the sequence-parallel one), so the conv and
    the scan see every position; this rank holds R / tp channels
    (``_rg_local``), their state too; the scan is elementwise per
    channel, and ``w_out`` is the row product of ``Shards.row``, which
    leaves into the stream."""
    if shards is not None:
        x, p = shards.stream_in(x), _rg_local(p, shards)
    gate = _gelu(dense(x, p["w_gate"]))
    u = dense(x, p["w_x"])
    u, conv_state = _causal_conv(p, u, conv0)
    i_t, r_t = _rg_gates(p, u, shards)
    a_t = _rg_decay(p, r_t)                                 # (B, S, R) f32
    b_t = _input(a_t, i_t, u)
    if h0 is not None:
        b_t = torch.cat([b_t[:, :1] + a_t[:, :1]
                         * h0.to(torch.float32)[:, None], b_t[:, 1:]], dim=1)
    h = linear_scan(a_t, b_t)
    return _row(h.to(x.dtype) * gate, p["w_out"], shards), h[:, -1], \
        conv_state


def _rg_local(p: Tree, shards) -> Tree:
    """An RG-LRU block's leaves as this rank uses them: its column
    shards of ``w_x`` and ``w_gate``, the conv's and ``lam``'s channels
    (local leaves already), and its RG_HEADS / tp heads of the
    replicated ``w_inp`` / ``w_rec`` (``Shards.part``); where tp does
    not divide the gate heads, the whole of both, of which
    :func:`_rg_gates_cut` takes the columns of this rank's channels
    (their gradients summed over "model", ``Shards.enter``)."""
    if p["w_inp"].shape[0] % shards.tp:
        return dict(p, w_inp=shards.enter(p["w_inp"]),
                    w_rec=shards.enter(p["w_rec"]))
    return dict(p, w_inp=shards.part(p["w_inp"], 0),
                w_rec=shards.part(p["w_rec"], 0))


def _row(x: torch.Tensor, w, shards, heads=None) -> torch.Tensor:
    """The block's output projection: ``dense`` on one device, the row
    product of ``Shards.row`` (this rank's input columns; ``heads`` (n,
    width) where they are its whole heads) with ``shards``."""
    return dense(x, w) if shards is None else shards.row(x, w, heads)


def rglru_step(cfg: ArchConfig, p: Tree, x: torch.Tensor, h: torch.Tensor,
               conv_state: torch.Tensor, shards=None):
    """One decode step: x (B, 1, D), h (B, R), conv_state (B, cw-1, R).
    Returns (out (B, 1, D), h (B, R) f32, conv state in x's dtype).
    With ``shards`` (sharded serving), as :func:`rglru_seq`: h and the
    conv state are this rank's R / tp channels."""
    if shards is not None:
        x, p = shards.enter(x), _rg_local(p, shards)
    gate = _gelu(dense(x, p["w_gate"]))
    u = dense(x, p["w_x"])
    u, conv_state = _causal_conv(p, u, conv_state)
    i_t, r_t = _rg_gates(p, u, shards)
    a_t = _rg_decay(p, r_t)[:, 0]
    b_t = _input(a_t, i_t[:, 0], u[:, 0])
    h = a_t * h.to(torch.float32) + b_t
    return _row(h[:, None].to(x.dtype) * gate, p["w_out"], shards), h, \
        conv_state


def init_rglru_state(cfg: ArchConfig, batch: int, n_layers: int,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Zero decode state of a stage's rglru layers, stacked on a leading
    layer axis: ``h`` (L, B, R) f32 and ``conv`` (L, B, cw-1, R)."""
    r = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((n_layers, batch, r), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, r),
                                dtype=CONV_STATE_DTYPE, device=device)}


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigmoid(x) = -softplus(-x), softplus as log(exp(x) + 1)
    (``jax.nn.softplus``; torch's ``softplus`` turns linear above 20)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell), chunkwise gated linear attention
# ---------------------------------------------------------------------------
def init_mlstm(cfg: ArchConfig) -> Tree:
    d = cfg.d_model
    m = int(cfg.mlstm_proj_factor * d)          # value / gate width
    h = cfg.n_heads
    return {
        "w_q": P((d, d), ("embed", "heads"), "scaled"),
        "w_k": P((d, d), ("embed", "heads"), "scaled"),
        "w_v": P((d, m), ("embed", "heads"), "scaled"),
        "w_gate": P((d, m), ("embed", "heads"), "scaled"),
        "w_if": P((d, 2 * h), ("embed", None), "scaled",
                  torch.float32),
        "w_out": P((m, d), ("heads", "embed"), "scaled"),
    }


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    """The mLSTM's (dk, dv) per head."""
    d = cfg.d_model
    return d // cfg.n_heads, int(cfg.mlstm_proj_factor * d) // cfg.n_heads


def _mlstm_qkvg(cfg: ArchConfig, p: Tree, x: torch.Tensor, shards=None):
    """x (..., D) -> q, k (scaled by 1/sqrt(dk)), v per head in f32, the
    output gate silu(x @ w_gate) in x's dtype, and the log input and
    forget gates (..., H) in f32.  With ``shards`` the heads are this
    rank's (``Shards.heads``: H / tp, or whole heads of an uneven split,
    possibly none): the projections' columns of those heads
    (``Shards.head_part``) and its heads' columns of the replicated
    ``w_if`` (``Shards.part``)."""
    h = cfg.n_heads
    dk, dv = _mlstm_dims(cfg)
    w_if = p["w_if"]
    ws = [p[n] for n in ("w_q", "w_k", "w_v", "w_gate")]
    if shards is not None:
        w_if = shards.part(w_if.reshape(-1, 2, h), 2).reshape(
            w_if.shape[0], -1)
        ws = [shards.head_part(w, h, 1) for w in ws]
        lo, hi = shards.heads(h)
        h = hi - lo
    q = dense(x, ws[0])
    k = dense(x, ws[1])
    v = dense(x, ws[2])
    g = F.silu(dense(x, ws[3]))
    shp = x.shape[:-1]
    q = q.reshape(shp + (h, dk)).to(torch.float32)
    k = k.reshape(shp + (h, dk)).to(torch.float32) / torch.tensor(
        math.sqrt(dk), dtype=torch.float32, device=x.device)
    v = v.reshape(shp + (h, dv)).to(torch.float32)
    gates = (x.to(torch.float32) @ w_if.to(torch.float32)).reshape(
        shp + (2, h))
    return (q, k, v, g, _log_sigmoid(gates[..., 0, :]),
            _log_sigmoid(gates[..., 1, :]))


def mlstm_seq(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              state: Optional[Tree] = None, chunk: int = 256, shards=None):
    """The block over a whole sequence, chunk by chunk: x (B, S, D) ->
    (out (B, S, D), {"c": (B, H, dk, dv), "n": (B, H, dk)} f32).  S must
    be a multiple of min(chunk, S).  With ``shards`` (the sharded train
    step, and sharded serving's prefill) x is the stream, which enters
    whole (``Shards.stream_in``), the heads and their state are this
    rank's (``Shards.heads``), and ``w_out`` is the row product of
    ``Shards.row``, which leaves into the stream."""
    if shards is not None:
        x = shards.stream_in(x)
    b, s, _ = x.shape
    q, k, v, g, log_i, log_f = _mlstm_qkvg(cfg, p, x, shards)
    h, dv = q.shape[-2], v.shape[-1]
    o, state = mlstm_chunks(q, k, v, log_i, log_f, state, chunk)
    o = o.reshape(b, s, h * dv).to(x.dtype)
    return _row(o * g, p["w_out"], shards, (cfg.n_heads, dv)), state


def mlstm_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_i: torch.Tensor, log_f: torch.Tensor,
                 state: Optional[Tree] = None, chunk: int = 256):
    """The mLSTM's recurrence over a sequence, chunk by chunk, each head
    on its own: q, k (B, S, H, dk), v (B, S, H, dv), the log gates (B,
    S, H), all f32 -> (the read-out (B, S, H, dv) f32, the final state
    {"c": (B, H, dk, dv), "n": (B, H, dk)} f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    l = min(chunk, s)
    assert s % l == 0, (s, l)
    if state is None:
        c = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    else:
        c = state["c"].to(torch.float32)
        n = state["n"].to(torch.float32)
    above = ~torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    outs = []
    for c0 in range(0, s, l):
        qc, kc, vc = q[:, c0:c0 + l], k[:, c0:c0 + l], v[:, c0:c0 + l]
        lic, lfc = log_i[:, c0:c0 + l], log_f[:, c0:c0 + l]
        cum_f = torch.cumsum(lfc, dim=1)                    # (B, L, H)
        # A[t, s] = exp(cum_f[t] - cum_f[s] + log_i[s]) for s <= t
        decay = cum_f[:, :, None, :] - cum_f[:, None, :, :] + lic[:, None]
        a = torch.exp(decay.masked_fill(above[None, :, :, None],
                                        float("-inf")))
        scores = torch.einsum("blhd,bmhd->blmh", qc, kc) * a
        o_intra = torch.einsum("blmh,bmhv->blhv", scores, vc)
        n_intra = torch.einsum("blmh,bmhd->blhd", a, kc)
        # the carried state, decayed to each position
        dec_t = torch.exp(cum_f)
        o_inter = torch.einsum("blhd,bhdv->blhv", qc, c) * dec_t[..., None]
        n_inter = torch.einsum("blhd,bhd->blh", qc, n) * dec_t
        den = torch.abs(torch.einsum("blhd,blhd->blh", qc, n_intra)
                        + n_inter)
        outs.append((o_intra + o_inter)
                    / torch.clamp_min(den, 1.0)[..., None])
        # the state at the end of the chunk
        tail = torch.exp(cum_f[:, -1:, :] - cum_f + lic)     # (B, L, H)
        f_all = torch.exp(cum_f[:, -1])
        c = c * f_all[:, :, None, None] + torch.einsum(
            "blhd,blhv,blh->bhdv", kc, vc, tail)
        n = n * f_all[:, :, None] + torch.einsum("blhd,blh->bhd", kc, tail)
    return torch.cat(outs, dim=1), {"c": c, "n": n}


def mlstm_state_step_(c: torch.Tensor, n: torch.Tensor, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, log_i: torch.Tensor,
                      log_f: torch.Tensor) -> torch.Tensor:
    """The state arithmetic of one decode step, in place on the f32
    state c (B, H, dk, dv), n (B, H, dk), in the reference's order (c * f
    + i * (k ⊗ v)): q, k (B, H, dk), v (B, H, dv), log gates (B, H) ->
    the normalized read-out (B, H, dv)."""
    i_t = torch.exp(log_i)[..., None, None]
    f_t = torch.exp(log_f)[..., None, None]
    kv = k[..., :, None] * v[..., None, :]
    c.mul_(f_t).add_(kv.mul_(i_t))
    del kv
    n.mul_(f_t[..., 0]).add_(i_t[..., 0] * k)
    num = torch.einsum("bhd,bhdv->bhv", q, c)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    return num / torch.clamp_min(den, 1.0)[..., None]


def mlstm_step_(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                c: torch.Tensor, n: torch.Tensor, shards=None
                ) -> torch.Tensor:
    """One decode step that updates the f32 state in place: x (B, 1, D),
    c (B, H, dk, dv), n (B, H, dk) -> out (B, 1, D).

    With ``shards`` (sharded serving) the state is the whole one,
    replicated over "model" (as the reference declares it), and every
    model rank updates it alike, as the sLSTM's scan: this rank's heads
    (``Shards.heads``, possibly none) of the step's q, k, v and gates
    (one token each) are gathered over "model" (``Shards.gather_heads``
    with the backward of ``Shards.gather_rep``), and ``w_out``'s row
    product takes this rank's heads of the read-out."""
    if shards is not None:
        x = shards.enter(x)
    q, k, v, g, log_i, log_f = _mlstm_qkvg(cfg, p, x, shards)
    h = cfg.n_heads
    if shards is not None:
        q, k, v, log_i, log_f = (shards.gather_heads(t, h, 2, rep=True)
                                 for t in (q, k, v, log_i, log_f))
    o = mlstm_state_step_(c, n, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                          log_f[:, 0])
    if shards is not None:
        o = shards.part(o, 1)
    o = o.reshape(x.shape[0], 1, o.shape[1] * o.shape[2])
    return _row(o.to(x.dtype) * g, p["w_out"], shards,
                (h, _mlstm_dims(cfg)[1]))


def mlstm_step(cfg: ArchConfig, p: Tree, x: torch.Tensor, state: Tree):
    """One decode step: x (B, 1, D), state {c, n} -> (out (B, 1, D), the
    new f32 state); the state given is left as it was."""
    c = state["c"].to(torch.float32, copy=True)
    n = state["n"].to(torch.float32, copy=True)
    return mlstm_step_(cfg, p, x, c, n), {"c": c, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory cell, block-diagonal recurrence) and its gated FFN
# ---------------------------------------------------------------------------
SLSTM_STATE = ("h", "c", "n", "m")


def init_slstm(cfg: ArchConfig) -> Tree:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = int(round(cfg.slstm_ff_factor * d / 128) * 128)
    return {
        "w_gates": P((d, 4 * d), ("embed", "heads"), "scaled"),
        "r_gates": P((4, h, hd, hd), (None, None, None, None),
                     "scaled"),
        "b_gates": P((4 * d,), (None,), "zeros", torch.float32),
        "w_up": P((d, f), ("embed", "ffn"), "scaled"),
        "w_gate": P((d, f), ("embed", "ffn"), "scaled"),
        "w_down": P((f, d), ("ffn", "embed"), "scaled"),
    }


def _cell_nopar(cfg: ArchConfig, pre: torch.Tensor, st: Tree) -> Tree:
    """One sLSTM step from its pre-activations pre (B, 4D) = zx + R·h +
    b (gates z, i, f, o), stabilized by the running max m; no weights."""
    zi, ii, fi, oi = pre.to(torch.float32).chunk(4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_i = _log_sigmoid(ii)
    log_f = _log_sigmoid(fi)
    m_new = torch.maximum(log_f + st["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + st["m"] - m_new)
    c = f_s * st["c"] + i_s * z
    n = torch.clamp_min(f_s * st["n"] + i_s, 1e-6)
    return {"h": o * (c / n), "c": c, "n": n, "m": m_new}


def _slstm_cell(cfg: ArchConfig, p: Tree, zx: torch.Tensor, st: Tree
                ) -> Tree:
    """One timestep: zx (B, 4D), the input's contribution; the recurrent
    term through the (4, H, hd, hd) blocks of ``r_gates``."""
    b, d = zx.shape[0], zx.shape[1] // 4
    hh = st["h"].reshape(b, cfg.n_heads, -1)
    rec = torch.einsum("bhd,ghde->bghe", hh,
                       p["r_gates"].to(torch.float32)).reshape(b, 4 * d)
    pre = zx.to(torch.float32) + rec + p["b_gates"].to(torch.float32)
    return _cell_nopar(cfg, pre, st)


def _slstm_scan_ref(cfg: ArchConfig, p_rec: Tree, zx: torch.Tensor,
                    state: Tree):
    """Plain-autograd scan (the oracle of :class:`SLSTMScan`): zx
    (B, T, 4D) -> (final state, hs (B, T, D))."""
    hs = []
    for t in range(zx.shape[1]):
        state = _slstm_cell(cfg, p_rec, zx[:, t], state)
        hs.append(state["h"])
    return state, torch.stack(hs, dim=1)


def _rec_term(rgF: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """R·h with the weight laid out once as (H, hd, 4·hd): h (B, D) ->
    (B, 4D) in the (gate, head, e) order of the pre-activations."""
    b = h.shape[0]
    nh = rgF.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", h.reshape(b, nh, -1), rgF)
    return rec.reshape(b, nh, 4, -1).transpose(1, 2).reshape(b, -1)


def _rg_fwd_layout(r_gates: torch.Tensor) -> torch.Tensor:
    """(g, h, hd, he) -> (h, hd, g·he)."""
    g, h, d, e = r_gates.shape
    return r_gates.to(torch.float32).permute(1, 2, 0, 3).reshape(h, d, g * e)


def _rg_bwd_layout(r_gates: torch.Tensor) -> torch.Tensor:
    """(g, h, hd, he) -> (h, g·he, hd), for the gradient of h_{t-1}."""
    g, h, d, e = r_gates.shape
    return r_gates.to(torch.float32).permute(1, 0, 3, 2).reshape(h, g * e, d)


def _scan_forward(cfg: ArchConfig, rgF: torch.Tensor, bg: torch.Tensor,
                  zx: torch.Tensor, state: Tree, keep: bool):
    """The f32 recurrence over zx (B, T, 4D).  Returns (final state, hs
    (B, T, D), and with ``keep`` the per-step pre-activations (T, B, 4D)
    and the states entering each step, stacked (T, B, D))."""
    hs, pres, prev = [], [], {k: [] for k in SLSTM_STATE}
    for t in range(zx.shape[1]):
        pre = zx[:, t] + _rec_term(rgF, state["h"]) + bg
        if keep:
            pres.append(pre)
            for k in SLSTM_STATE:
                prev[k].append(state[k])
        state = _cell_nopar(cfg, pre, state)
        hs.append(state["h"])
    saved = ((torch.stack(pres), {k: torch.stack(v) for k, v in prev.items()})
             if keep else None)
    return state, torch.stack(hs, dim=1), saved


class SLSTMScan(torch.autograd.Function):
    """The sLSTM scan with the reference's deferred weight gradient
    (``repro.models.recurrent._slstm_scan_f32`` and its custom VJP):
    the forward keeps each step's pre-activations and the states that
    entered it; the backward walks the steps in reverse, taking each
    step's VJP of :func:`_cell_nopar`, and forms dR = Σ_t h_{t-1} ⊗
    dpre_t and db = Σ_t dpre_t as one contraction over (T, B) each.

    apply(cfg, r_gates, b_gates, zx, h0, c0, n0, m0) -> (hs (B, T, D),
    hN, cN, nN, mN), all f32; the gradients come back in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, cfg, r_gates, b_gates, zx, h0, c0, n0, m0):
        rg = r_gates.to(torch.float32)
        state = {"h": h0.to(torch.float32), "c": c0.to(torch.float32),
                 "n": n0.to(torch.float32), "m": m0.to(torch.float32)}
        state, hs, (pres, prev) = _scan_forward(
            cfg, _rg_fwd_layout(rg), b_gates.to(torch.float32),
            zx.to(torch.float32), state, keep=True)
        ctx.cfg = cfg
        ctx.dtypes = tuple(t.dtype for t in (r_gates, b_gates, zx, h0, c0,
                                             n0, m0))
        ctx.save_for_backward(rg, pres, *(prev[k] for k in SLSTM_STATE))
        return (hs,) + tuple(state[k] for k in SLSTM_STATE)

    @staticmethod
    def backward(ctx, d_hs, *d_final):
        rg, pres, *prev_l = ctx.saved_tensors
        prev = dict(zip(SLSTM_STATE, prev_l))
        cfg = ctx.cfg
        g4, nh = rg.shape[0], rg.shape[1]
        t_len, b = pres.shape[0], pres.shape[1]
        rgB = _rg_bwd_layout(rg)
        zeros = torch.zeros_like(prev["h"][0])
        dst = {k: (zeros if d is None else d.to(torch.float32))
               for k, d in zip(SLSTM_STATE, d_final)}
        d_hs = (torch.zeros((b, t_len, zeros.shape[-1]), device=rg.device)
                if d_hs is None else d_hs.to(torch.float32))
        dpres = [None] * t_len
        for t in reversed(range(t_len)):
            dst = dict(dst, h=dst["h"] + d_hs[:, t])   # h_t feeds the output
            with torch.enable_grad():
                pre = pres[t].detach().requires_grad_(True)
                st = {k: prev[k][t].detach().requires_grad_(True)
                      for k in SLSTM_STATE}
                out = _cell_nopar(cfg, pre, st)
                grads = torch.autograd.grad(
                    [out[k] for k in SLSTM_STATE],
                    [pre] + [st[k] for k in SLSTM_STATE],
                    [dst[k] for k in SLSTM_STATE], allow_unused=True)
            dpre = grads[0]
            dprev = {k: (torch.zeros_like(zeros) if gr is None else gr)
                     for k, gr in zip(SLSTM_STATE, grads[1:])}
            # dpre reaches h_{t-1} through the recurrent term too
            dp_h = dpre.reshape(b, g4, nh, -1).transpose(1, 2).reshape(
                b, nh, -1)
            dh_rec = torch.einsum("bhk,hkd->bhd", dp_h, rgB).reshape(b, -1)
            dst = dict(dprev, h=dprev["h"] + dh_rec)
            dpres[t] = dpre
        dpres = torch.stack(dpres)                          # (T, B, 4D)
        # deferred weight gradients: one contraction over (T, B) each
        hh_prev = prev["h"].reshape(t_len, b, nh, -1)
        dp = dpres.reshape(t_len, b, g4, nh, -1)
        d_rg = torch.einsum("tbhd,tbghe->ghde", hh_prev, dp)
        d_bg = dpres.sum(dim=(0, 1))
        d_zx = dpres.transpose(0, 1)
        grads = [d_rg, d_bg, d_zx] + [dst[k] for k in SLSTM_STATE]
        return (None,) + tuple(
            gr.to(dt) if need else None
            for gr, dt, need in zip(grads, ctx.dtypes,
                                    ctx.needs_input_grad[1:]))


def _slstm_scan(cfg: ArchConfig, p_rec: Tree, zx: torch.Tensor, state: Tree):
    """zx (B, T, 4D), state {h, c, n, m} (B, D) -> (final state, hs
    (B, T, D)) in f32.  Under autograd, when any input needs a gradient,
    through :class:`SLSTMScan`; otherwise the same loop keeps nothing."""
    args = (p_rec["r_gates"], p_rec["b_gates"], zx) + tuple(
        state[k] for k in SLSTM_STATE)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        hs, *final = SLSTMScan.apply(cfg, *args)
        return dict(zip(SLSTM_STATE, final)), hs
    st = {k: state[k].to(torch.float32) for k in SLSTM_STATE}
    st, hs, _ = _scan_forward(
        cfg, _rg_fwd_layout(p_rec["r_gates"]),
        p_rec["b_gates"].to(torch.float32), zx.to(torch.float32), st,
        keep=False)
    return st, hs


def _slstm_ffn(p: Tree, hs: torch.Tensor, shards=None) -> torch.Tensor:
    """The gated FFN; with ``shards``, over this rank's ffn columns of
    ``w_up`` / ``w_gate``, and ``w_down`` the row product of
    ``Shards.row``."""
    if shards is not None:
        hs = shards.enter(hs)
    up = _gelu(dense(hs, p["w_up"])) * dense(hs, p["w_gate"])
    return _row(up, p["w_down"], shards)


def slstm_seq(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              state: Optional[Tree] = None, shards=None):
    """The block over a whole sequence: x (B, S, D) -> (out (B, S, D),
    the final state {h, c, n, m} (B, D) f32).  The state starts at h = c
    = m = 0, n = 1e-6.

    With ``shards`` (the sharded train step; the reference's shard_map)
    x enters whole (``Shards.stream_in``), ``w_gates`` is
    column-parallel and ``zx`` is gathered over "model"
    (``Shards.gather_rep``: its gradient is not summed), the scan runs
    alike on every model rank over this data rank's rows with the
    replicated ``r_gates`` and ``b_gates``, and the FFN is
    tensor-parallel, its output leaving into the stream."""
    b, _, d = x.shape
    if shards is not None:
        x = shards.stream_in(x)
    zx = dense(x, p["w_gates"])                             # (B, S, 4D)
    if shards is not None:
        zx = shards.gather_rep(zx, 2)
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = {"h": z, "c": z, "n": z + 1e-6, "m": z}
    state, hs = _slstm_scan(
        cfg, {"r_gates": p["r_gates"], "b_gates": p["b_gates"]}, zx, state)
    return _slstm_ffn(p, hs.to(x.dtype), shards), state


def slstm_step(cfg: ArchConfig, p: Tree, x: torch.Tensor, state: Tree,
               shards=None):
    """One decode step: x (B, 1, D), state {h, c, n, m} (B, D) -> (out
    (B, 1, D), the new state).  With ``shards`` (sharded serving), as
    :func:`slstm_seq`: ``w_gates`` column-parallel and its output
    gathered over "model", the cell and its state replicated, the FFN
    tensor-parallel."""
    if shards is not None:
        x = shards.enter(x)
    zx = dense(x, p["w_gates"])[:, 0]
    if shards is not None:
        zx = shards.gather_rep(zx, 1)
    state = _slstm_cell(cfg, p, zx, state)
    return _slstm_ffn(p, state["h"][:, None].to(x.dtype), shards), state


def declare_recurrent_state(cfg: ArchConfig, kind: str, batch: int
                            ) -> Dict[str, P]:
    """The decode state of one layer of a recurrent ``kind`` as P
    leaves with the reference's logical axes (its
    ``init_recurrent_state``): rglru ``h`` f32 and ``conv`` over
    ("batch", ..., "rnn"), mlstm ``c``, ``n`` and slstm ``h``, ``c``,
    ``n``, ``m`` f32 with the batch alone sharded."""
    d = cfg.d_model
    f32 = torch.float32
    if kind == "rglru":
        r = cfg.rnn_width or d
        return {"h": P((batch, r), ("batch", "rnn"), "zeros", f32),
                "conv": P((batch, cfg.conv_width - 1, r),
                          ("batch", None, "rnn"), "zeros")}
    if kind == "mlstm":
        h = cfg.n_heads
        dv = int(cfg.mlstm_proj_factor * d) // h
        return {"c": P((batch, h, d // h, dv), ("batch", None, None, None),
                       "zeros", f32),
                "n": P((batch, h, d // h), ("batch", None, None), "zeros",
                       f32)}
    if kind == "slstm":
        return {k: P((batch, d), ("batch", None), "zeros", f32)
                for k in SLSTM_STATE}
    raise ValueError(kind)


def init_recurrent_state(cfg: ArchConfig, kind: str, batch: int,
                         n_layers: int, device="cpu"
                         ) -> Dict[str, torch.Tensor]:
    """Zero decode state of a stage's layers of a recurrent ``kind``,
    stacked on a leading layer axis: rglru ``h`` (L, B, R) f32 and
    ``conv`` (L, B, cw-1, R); mlstm ``c`` (L, B, H, dk, dv) and ``n``
    (L, B, H, dk) f32; slstm ``h``, ``c``, ``n``, ``m`` (L, B, D) f32."""
    d = cfg.d_model
    if kind == "rglru":
        return init_rglru_state(cfg, batch, n_layers, device)
    if kind == "mlstm":
        h = cfg.n_heads
        dv = int(cfg.mlstm_proj_factor * d) // h
        return {"c": torch.zeros((n_layers, batch, h, d // h, dv),
                                 dtype=torch.float32, device=device),
                "n": torch.zeros((n_layers, batch, h, d // h),
                                 dtype=torch.float32, device=device)}
    if kind == "slstm":
        return {k: torch.zeros((n_layers, batch, d), dtype=torch.float32,
                               device=device) for k in SLSTM_STATE}
    raise ValueError(kind)
