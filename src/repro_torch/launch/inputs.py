"""Meta-tensor input stand-ins and their Specs per shape cell (twin of
``repro.launch.inputs``).

``train_inputs``, ``prefill_inputs`` and ``decode_inputs`` return
(abstract inputs, Spec tree) for the step kind of a cell:
  train   : {tokens (B, S), targets (B, S) [, vision_embeds / frames]}
  prefill : {tokens (B, S) [, extras]}
  decode  : (token (B,), pos (B,), caches), the caches sized by the cell
            (ring windows bound the local and windowed kinds; recurrent
            state is O(1)).

Frontend stubs: llava's vision tower contributes ``frontend_tokens``
precomputed patch embeddings inside the sequence budget; seamless's
speech encoder sees ``ENC_FRAMES`` precomputed frame embeddings.  Meta
tensors hold no memory, so every architecture's cells declare at full
size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.select import map_tree
from repro_torch.distributed.sharding import Rules, Spec
from repro_torch.launch.qdeclare import meta
from repro_torch.models import model as M
from repro_torch.models.common import Parallel
from repro_torch.models.param import P

Tree = Any
ENC_FRAMES = 1024       # seamless stub: fixed speech-frame budget


def _bspec(rules: Rules, par: Parallel, *rest) -> Spec:
    """The batch dim over the data dims (None when the batch is not
    sharded, ``par.shard_batch`` off), then ``rest``."""
    if not par.shard_batch:
        return Spec((None,) + rest)
    dp = rules.dp_axes if len(rules.dp_axes) > 1 else rules.dp_axes[0]
    return Spec((dp,) + rest)


def train_inputs(cfg: ArchConfig, cell: ShapeCell, par: Parallel,
                 rules: Rules) -> Tuple[Dict, Dict]:
    b, s = cell.global_batch, cell.seq_len
    inp = {"tokens": meta((b, s), torch.int32),
           "targets": meta((b, s), torch.int32)}
    spec = {"tokens": _bspec(rules, par, None),
            "targets": _bspec(rules, par, None)}
    if cfg.frontend == "vision":
        inp["vision_embeds"] = meta((b, cfg.frontend_tokens, cfg.d_model),
                                    torch.bfloat16)
        spec["vision_embeds"] = _bspec(rules, par, None, None)
    if cfg.enc_dec:
        inp["frames"] = meta((b, ENC_FRAMES, cfg.d_model), torch.bfloat16)
        spec["frames"] = _bspec(rules, par, None, None)
    return inp, spec


def prefill_inputs(cfg: ArchConfig, cell: ShapeCell, par: Parallel,
                   rules: Rules) -> Tuple[Dict, Dict]:
    inp, spec = train_inputs(cfg, cell, par, rules)
    del inp["targets"], spec["targets"]
    return inp, spec


def decode_inputs(cfg: ArchConfig, cell: ShapeCell, par: Parallel,
                  rules: Rules) -> Tuple[Tuple, Tuple]:
    """((token, pos, caches), (their Specs)).  With the batch not
    sharded the caches' batch dim (dim 1, after the stacked layers) is
    taken off the data dims."""
    b = cell.global_batch
    decl = M.declare_caches(cfg, par, b, cell.seq_len,
                            enc_len=ENC_FRAMES if cfg.enc_dec else 0)
    caches = map_tree(decl, lambda _, p: meta(p.shape, p.dtype))

    def cache_spec(_, p: P) -> Spec:
        s = rules.spec(p.axes)
        if par.shard_batch:
            return s
        return Spec(None if i == 1 else a for i, a in enumerate(s))

    tspec = _bspec(rules, par)
    return ((meta((b,), torch.int32), meta((b,), torch.int32), caches),
            (tspec, tspec, map_tree(decl, cache_spec)))
