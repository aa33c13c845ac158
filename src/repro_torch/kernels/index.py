"""The paged kernels' page index maps.

Twins of ``repro.kernels.paged_attention.kv_block_index`` and
``repro.kernels.paged_prefill.ctx_block_index``: the page the TPU
kernels' K/V BlockSpecs address at each grid step.  The plain versions
in ``ref.py`` gather their pages through them, and the CUDA kernels'
key loops visit exactly the positions of the pages they leave
unclamped.  Each works on Python ints and on broadcastable int tensors
alike.
"""
from __future__ import annotations

from typing import Optional

import torch


def kv_block_index(bi, j, bt_flat, lens, *, ps: int, nblk: int,
                   window: Optional[int]):
    """Pool page read at decode step ``(bi, j)``: steps past the last
    live page, before the sliding-window start, or on inactive rows
    clamp onto a live page; unassigned entries (-1) read page 0."""
    if isinstance(bi, torch.Tensor) or isinstance(j, torch.Tensor):
        length = torch.as_tensor(lens)[bi]
        last = torch.clamp_min(torch.div(length - 1, ps,
                                         rounding_mode="floor"), 0)
        if window is None:
            first = torch.zeros_like(last)
        else:
            first = torch.minimum(
                torch.div(torch.clamp_min(length - window, 0), ps,
                          rounding_mode="floor"), last)
        jj = torch.minimum(torch.maximum(torch.as_tensor(j), first), last)
        return torch.clamp_min(torch.as_tensor(bt_flat)[bi * nblk + jj], 0)
    length = int(lens[bi])
    last = max((length - 1) // ps, 0)
    first = 0 if window is None else min(max(length - window, 0) // ps, last)
    jj = min(max(j, first), last)
    return max(int(bt_flat[bi * nblk + jj]), 0)


def ctx_block_index(j, bt_read, start, *, ps: int, nblk: int,
                    window: Optional[int]):
    """Context page read at prefill step ``j``: steps past the last
    context page (``j*ps >= start``), before the sliding-window start, or
    on dead entries clamp onto a fetched page; -1 entries read page 0."""
    if isinstance(j, torch.Tensor):
        start = torch.as_tensor(start, device=j.device)
        last = torch.clamp_min(torch.div(start, ps, rounding_mode="floor")
                               - 1, 0)
        if window is None:
            first = torch.zeros_like(last)
        else:
            first = torch.minimum(
                torch.div(torch.clamp_min(start + 1 - window, 0), ps,
                          rounding_mode="floor"), last)
        jj = torch.minimum(torch.maximum(j, first), last)
        return torch.clamp_min(torch.as_tensor(bt_read)[jj], 0)
    start = int(start)
    last = max(start // ps - 1, 0)
    first = 0 if window is None else min(max(start + 1 - window, 0) // ps,
                                         last)
    jj = min(max(j, first), last)
    return max(int(bt_read[jj]), 0)
