"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
roundings, in ordinary tensor code.  The kernel wrappers use them for
tensors that lie on the CPU; on the card they are what the kernels are
held against.

* ``mixed_matmul_ref`` — the fused PTQ1.61 linear: bf16 operands, int4
  weights dequantized in f32 and rounded to bf16, ``x_b·α_r2`` in f32
  rounded to bf16, f32 accumulation, returned unrounded (the wrapper
  rounds it to bf16 unless asked for the f32 accumulator).
* ``binary_matmul_ref`` — its binary span alone: ``x·α_in`` in f32
  rounded to bf16, a dot with ±1 into an f32 accumulator, times
  ``α_out``; returned in x.dtype.
* ``int4_matmul_ref`` — its int4 span alone: ``(q−z)·s`` in f32 rounded
  to bf16, x rounded to bf16, f32 accumulation; returned in x.dtype.
* ``paged_attention_ref`` — the dense-gather read of
  ``repro.models.layers.attention_decode_paged``: gather each slot's
  pages, mask by implied key positions, softmax, cast the weights to the
  V dtype, PV in f32.  Rows with ``context_lens == 0`` are zeros, as the
  kernel writes them.
* ``paged_prefill_ref`` — ``repro.kernels.paged_prefill.paged_prefill_xla``:
  the chunk's masked page writes, then the same page-tile online softmax
  over context pages and in-chunk keys.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import pack
from repro_torch.kernels.index import ctx_block_index, kv_block_index

NEG_INF = -1e30


def mixed_matmul_ref(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                     z4: torch.Tensor, bits: torch.Tensor,
                     alpha_s: torch.Tensor, alpha_r1: torch.Tensor,
                     alpha_r2: torch.Tensor,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) in original channel order when ``perm`` is given, else
    salient-first; returns (M, N) f32, the accumulator before the
    kernel's one rounding.  A ``perm`` may be shorter than x's rows (a
    row-parallel view gathers its channels from the whole activation)."""
    if perm is not None:
        x = x[:, perm.long()]
    xf = x.to(torch.bfloat16).to(torch.float32)
    k_s = w4.shape[-2] * 2
    q = pack.unpack_nibbles(w4, axis=-2, dtype=torch.float32)
    w = ((q - z4[:, None]) * s4[:, None]).to(torch.bfloat16)
    y4 = xf[:, :k_s] @ w.to(torch.float32)
    xb = (xf[:, k_s:] * alpha_r2[None, :]).to(torch.bfloat16)
    sign = pack.unpack_bits(bits, axis=-2, dtype=torch.float32)
    yb = xb.to(torch.float32) @ sign
    return y4 + yb * (alpha_s * alpha_r1)[None, :]


def binary_matmul_ref(x: torch.Tensor, bits: torch.Tensor,
                      alpha_out: torch.Tensor, alpha_in: torch.Tensor
                      ) -> torch.Tensor:
    """x (M, K); bits (K/8, N) u8; alpha_out (N,), alpha_in (K,) f32 ->
    (M, N) in x.dtype (an f32 x yields the f32 accumulator)."""
    xb = (x.to(torch.float32) * alpha_in[None, :]).to(torch.bfloat16)
    sign = pack.unpack_bits(bits, axis=-2, dtype=torch.float32)
    y = xb.to(torch.float32) @ sign
    return (y * alpha_out[None, :]).to(x.dtype)


def int4_matmul_ref(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                    z4: torch.Tensor) -> torch.Tensor:
    """x (M, K); w4 (K/2, N) u8 nibbles; s4, z4 (K,) f32 per input
    channel -> (M, N) in x.dtype."""
    q = pack.unpack_nibbles(w4, axis=-2, dtype=torch.float32)
    w = ((q - z4[:, None]) * s4[:, None]).to(torch.bfloat16)
    y = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return y.to(x.dtype)


def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, hq, dh); pools (P, ps, hkv, dh); block_tables (B, nblk);
    context_lens (B,) -> (B, hq, dh) f32."""
    b, hq, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    nblk = block_tables.shape[1]
    rep = hq // hkv
    bi = torch.arange(b, device=q.device)[:, None]
    j = torch.arange(nblk, device=q.device)[None, :]
    pages = kv_block_index(bi, j, block_tables.reshape(-1), context_lens,
                           ps=ps, nblk=nblk, window=window).long()
    k_ctx = k_pool[pages].reshape(b, nblk * ps, hkv, dh)
    v_ctx = v_pool[pages].reshape(b, nblk * ps, hkv, dh)
    kp = (j[..., None] * ps
          + torch.arange(ps, device=q.device)).reshape(1, nblk * ps)
    live = (block_tables >= 0).repeat_interleave(ps, dim=1)
    lens = context_lens.to(torch.int64)[:, None]
    mask = live & (kp < lens)
    if window is not None:
        mask = mask & (kp >= lens - window)
    qg = q.reshape(b, hkv, rep, dh).to(torch.float32)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, k_ctx.to(torch.float32))
    s = _softcap(s / math.sqrt(dh), softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v_pool.dtype).to(torch.float32)
    o = torch.einsum("bhrk,bkhd->bhrd", w, v_ctx.to(torch.float32))
    o = o.reshape(b, hq, dh)
    return torch.where((context_lens > 0)[:, None, None], o, 0.0)


def paged_prefill_ref(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, bt_read: torch.Tensor,
                      bt_write: torch.Tensor, start: int, length: int, *,
                      layer: int, window: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """q (C, hq, dh); k_new/v_new (C, hkv, dh) at the pool dtype; pools
    (L, P+1, ps, hkv, dh), updated in place at ``layer`` (the last page
    is the dump page for masked writes); returns o (C, hq, dh) f32."""
    c, hq, dh = q.shape
    _, pp, ps, hkv, _ = k_pool.shape
    nblk = bt_read.shape[0]
    rep = hq // hkv
    ncp = c // ps
    dump = pp - 1
    dev = q.device
    start, length = int(start), int(length)
    sm_scale = 1.0 / math.sqrt(dh)

    # -- the chunk's page writes: full page tiles, dump for masked ------
    idx = torch.arange(c, device=dev)
    cp = idx // ps
    blk = torch.clamp(start // ps + cp, 0, nblk - 1)
    page = bt_write.long()[blk]
    live_w = (cp * ps < length) & (page >= 0)
    page = torch.where(live_w, page, dump)
    k_pool[layer, page, idx % ps] = k_new
    v_pool[layer, page, idx % ps] = v_new

    # -- attend: context page tiles, then in-chunk tiles ----------------
    ctx_pages = ctx_block_index(torch.arange(nblk, device=dev), bt_read,
                                start, ps=ps, nblk=nblk,
                                window=window).long()
    kt = torch.cat([k_pool[layer][ctx_pages], k_new.reshape(ncp, ps, hkv, dh)])
    vt = torch.cat([v_pool[layer][ctx_pages], v_new.reshape(ncp, ps, hkv, dh)])
    qg = q.reshape(c, hkv, rep, dh).permute(1, 2, 0, 3).to(torch.float32)
    qp = start + torch.arange(c, device=dev)[None, None, :, None]
    slots = torch.arange(ps, device=dev)[None, None, None, :]
    m = torch.full((hkv, rep, c, 1), NEG_INF, device=dev)
    l = torch.zeros((hkv, rep, c, 1), device=dev)
    acc = torch.zeros((hkv, rep, c, dh), device=dev)
    bt_host = bt_read.tolist()
    for j in range(nblk + ncp):
        if j >= nblk:
            cpj = j - nblk
            if cpj * ps >= length:
                continue
            kp = start + cpj * ps + slots
            valid = (kp <= qp) & (kp < start + length)
        else:
            if bt_host[j] < 0 or j * ps >= start:
                continue
            if window is not None and (j + 1) * ps <= start + 1 - window:
                continue
            kp = j * ps + slots
            valid = kp < start
        if window is not None:
            valid = valid & (qp - kp < window)
        s = torch.einsum("hrcd,khd->hrck", qg, kt[j].to(torch.float32))
        s = _softcap(s * sm_scale, softcap)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        pv = p.to(vt.dtype).to(torch.float32)
        acc = acc * corr + torch.einsum("hrck,khd->hrcd", pv,
                                        vt[j].to(torch.float32))
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)
    return o.permute(2, 0, 1, 3).reshape(c, hq, dh)
