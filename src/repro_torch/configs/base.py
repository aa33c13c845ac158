"""Architecture configuration schema.

Every assigned architecture (plus the paper's own LLaMA subjects) is an
``ArchConfig``.  A config is *declarative*: model code in ``repro_torch.models``
reads it to build parameter shapes, logical sharding axes and the forward
functions.  The same config powers 1-device smoke tests (via
``reduced()``), the 256/512-chip dry-run (full shapes, abstract values)
and the benchmarks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# Block kinds understood by repro_torch.models.transformer
#   "dense"      : GQA attention + gated MLP
#   "moe"        : GQA attention + mixture-of-experts MLP
#   "local"      : local (windowed, causal) attention + gated MLP
#   "rglru"      : Griffin-style recurrent block (conv + RG-LRU) + gated MLP
#   "mlstm"      : xLSTM mLSTM block (internal up/down projection, no MLP)
#   "slstm"      : xLSTM sLSTM block (+ small gated FFN)
BLOCK_KINDS = ("dense", "moe", "local", "rglru", "mlstm", "slstm")


@dataclass(frozen=True)
class Stage:
    """A run of layers scanned as a unit.

    ``pattern`` is the block-kind sequence inside one superblock;
    ``repeats`` is the scan length.  Total layers = len(pattern)*repeats.
    Heterogeneous stacks (RecurrentGemma 2:1, xLSTM 7:1) become a single
    scan over superblocks so the lowered HLO stays depth-independent.
    """

    pattern: Tuple[str, ...]
    repeats: int

    def __post_init__(self):
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # Dense-dispatch capacity factor used by the einsum-based token routing
    # (capacity = top_k * capacity_factor * tokens / n_experts).
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stages: Tuple[Stage, ...]
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None      # sliding-window size for "dense"/"moe"
    local_window: int = 2048               # window for "local" blocks
    rope_theta: float = 10000.0
    logit_softcap: Optional[float] = None

    # mlp
    act: str = "silu"                # silu (gated) | gelu (gated)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tied_embeddings: bool = False

    # MoE
    moe: Optional[MoEConfig] = None

    # recurrent families
    rnn_width: Optional[int] = None        # RG-LRU recurrence width
    conv_width: int = 4                    # temporal conv width (Griffin)
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 8.0 / 3.0

    # encoder-decoder (seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # multimodal frontends are STUBS: input_specs() provides precomputed
    # embeddings of this many positions which the model consumes directly.
    frontend: Optional[str] = None         # None | "vision" | "audio"
    frontend_tokens: int = 0               # e.g. vision patch tokens per image

    # citation / provenance string from the assignment table
    source: str = ""

    # ---- derived ----------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so the embedding/head shard 16-way TP
        (Megatron-style padding; padded logits are masked — models/model)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is bounded (window / recurrent) so the
        long_500k cell is runnable."""
        kinds = {k for s in self.stages for k in s.pattern}
        if kinds <= {"rglru", "mlstm", "slstm", "local"}:
            return True
        # dense/moe blocks with a sliding window are also bounded
        if ("dense" in kinds or "moe" in kinds) and self.attn_window is not None:
            return True
        return False

    def n_params(self) -> int:
        """Closed-form parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim_
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_kind = {}
        attn = d * (n_q * dh) + 2 * d * (n_kv * dh) + (n_q * dh) * d
        mlp = 3 * d * self.d_ff
        per_kind["dense"] = attn + mlp
        if self.moe:
            per_kind["moe"] = attn + self.moe.n_experts * mlp + d * self.moe.n_experts
        per_kind["local"] = attn + mlp
        if self.rnn_width:
            r = self.rnn_width
            # in-proj (d->2r), conv (4r), rg-lru gates (2 r*r/heads.. approx r*r/4*2), out (r->d), mlp
            per_kind["rglru"] = d * 2 * r + self.conv_width * r + 2 * (r * r // 8) + r * d + mlp
        m_in = int(self.mlstm_proj_factor * d)
        # mlstm: up(d->2m); q/k/v are slices of the up branch in our impl;
        # gates (m->3h scalar-ish); down(m->d)
        per_kind["mlstm"] = d * 2 * m_in + 3 * m_in + m_in * d
        f = int(self.slstm_ff_factor * d)
        per_kind["slstm"] = 4 * d * d + 4 * (d // max(1, n_q)) * d + 2 * d * f + f * d
        total = self.vocab * d  # embed
        if not self.tied_embeddings:
            total += self.vocab * d
        for s in self.stages:
            for k in s.pattern:
                total += per_kind.get(k, 0) * s.repeats
        if self.enc_dec:
            # encoder blocks: dense attn + mlp, plus decoder cross-attn
            total += self.n_enc_layers * (per_kind["dense"])
            total += self.n_layers * attn  # cross attention per decoder layer
        return total

    def active_params(self) -> int:
        """Params used per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        mlp = 3 * d * self.d_ff
        dead = (self.moe.n_experts - self.moe.top_k) * mlp
        n_moe_layers = sum(s.pattern.count("moe") * s.repeats for s in self.stages)
        return self.n_params() - dead * n_moe_layers

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {}
        scale["d_model"] = 64
        scale["n_heads"] = 4
        scale["n_kv_heads"] = max(1, min(self.n_kv_heads, 2))
        scale["head_dim"] = 16
        scale["d_ff"] = 128 if self.d_ff else 0
        scale["vocab"] = 512
        scale["rnn_width"] = 64 if self.rnn_width else None
        scale["local_window"] = 32
        scale["attn_window"] = 32 if self.attn_window else None
        scale["frontend_tokens"] = 8 if self.frontend else 0
        scale["n_enc_layers"] = 2 if self.enc_dec else 0
        # keep the pattern, shrink repeats to 1 (and cap pattern reps)
        stages = tuple(Stage(s.pattern[:8], 1) for s in self.stages[:2])
        scale["stages"] = stages
        if self.moe:
            scale["moe"] = MoEConfig(n_experts=min(self.moe.n_experts, 4),
                                     top_k=min(self.moe.top_k, 2),
                                     capacity_factor=self.moe.capacity_factor)
        return dataclasses.replace(self, **scale)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned): every LM arch gets these four.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention; everything else always runs."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture — 500k-token "
                       "decode state is unbounded ")
    return True, ""
