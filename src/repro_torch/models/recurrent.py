"""The Griffin RG-LRU block of RecurrentGemma (the RG-LRU half of
``repro.models.recurrent``).

    in-proj -> [causal depthwise conv -> RG-LRU] * gelu(gate) -> out-proj

The recurrence ``h_t = a_t * h_{t-1} + b_t`` is elementwise.  Over a
whole sequence (calibration, the loss, whole-prompt prefill) it runs as
a log-depth doubling scan in plain PyTorch: ceil(log2 S) rounds of
``(a, b) <- (a * a_shift, a * b_shift + b)``, which autograd follows
(the Eq.-7 scale learning takes its gradients through it).  The
reference leaves the scan to XLA's ``associative_scan``; the two sum in
another order, so they agree to rounding, not bit for bit.  Decode is a
single-step update of the carried state.

Every weight matmul goes through :func:`repro_torch.models.linear.dense`,
so ``w_x``, ``w_gate`` and ``w_out`` quantize; the block-diagonal gate
weights ``w_inp`` / ``w_rec`` (RG_HEADS, hd, hd), the conv and ``lam``
stay in floating point.
"""
from __future__ import annotations

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
        "w_x": P((d, r), "scaled"),
        "w_gate": P((d, r), "scaled"),
        "conv_w": P((cfg.conv_width, r), "scaled"),
        "conv_b": P((r,), "zeros"),
        "w_inp": P((RG_HEADS, hd, hd), "scaled"),
        "w_rec": P((RG_HEADS, hd, hd), "scaled"),
        "lam": P((r,), "ones", torch.float32),
        "w_out": P((r, d), "scaled"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def _rg_gates(p: Tree, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., R) -> input gate i_t and recurrence gate r_t (f32), each a
    block-diagonal product over RG_HEADS heads."""
    shp = x.shape[:-1]
    xh = x.reshape(shp + (RG_HEADS, -1)).to(torch.float32)
    gi = torch.einsum("...hd,hde->...he", xh, p["w_inp"].to(torch.float32))
    gr = torch.einsum("...hd,hde->...he", xh, p["w_rec"].to(torch.float32))
    return (torch.sigmoid(gi.reshape(shp + (-1,))),
            torch.sigmoid(gr.reshape(shp + (-1,))))


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
              conv0: Optional[torch.Tensor] = None):
    """The block over a whole sequence: x (B, S, D) -> (out (B, S, D),
    the final h (B, R) f32, the conv state (B, cw-1, R)).  A carried
    ``h0`` folds into the first step: b_1 += a_1 * h0."""
    gate = _gelu(dense(x, p["w_gate"]))
    u = dense(x, p["w_x"])
    u, conv_state = _causal_conv(p, u, conv0)
    i_t, r_t = _rg_gates(p, u)
    a_t = _rg_decay(p, r_t)                                 # (B, S, R) f32
    b_t = _input(a_t, i_t, u)
    if h0 is not None:
        b_t = torch.cat([b_t[:, :1] + a_t[:, :1]
                         * h0.to(torch.float32)[:, None], b_t[:, 1:]], dim=1)
    h = linear_scan(a_t, b_t)
    out = dense(h.to(x.dtype) * gate, p["w_out"])
    return out, h[:, -1], conv_state


def rglru_step(cfg: ArchConfig, p: Tree, x: torch.Tensor, h: torch.Tensor,
               conv_state: torch.Tensor):
    """One decode step: x (B, 1, D), h (B, R), conv_state (B, cw-1, R).
    Returns (out (B, 1, D), h (B, R) f32, conv state in x's dtype)."""
    gate = _gelu(dense(x, p["w_gate"]))
    u = dense(x, p["w_x"])
    u, conv_state = _causal_conv(p, u, conv_state)
    i_t, r_t = _rg_gates(p, u)
    a_t = _rg_decay(p, r_t)[:, 0]
    b_t = _input(a_t, i_t[:, 0], u[:, 0])
    h = a_t * h.to(torch.float32) + b_t
    out = dense(h[:, None].to(x.dtype) * gate, p["w_out"])
    return out, h, conv_state


def init_rglru_state(cfg: ArchConfig, batch: int, n_layers: int,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Zero decode state of a stage's rglru layers, stacked on a leading
    layer axis: ``h`` (L, B, R) f32 and ``conv`` (L, B, cw-1, R)."""
    r = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((n_layers, batch, r), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, r),
                                dtype=CONV_STATE_DTYPE, device=device)}
