"""Paged flash-decode attention: wrapper of ``csrc/paged_attention.cu``.

Twin of ``repro.kernels.paged_attention`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`paged_attention` launches the hand-written kernel; on
a CPU tensor it runs ``ref.paged_attention_ref``.  There is no other
route: a CUDA call that the kernel cannot take raises.

The page the kernel reads at each key step follows
``index.kv_block_index``, as the plain version's gather does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, F, I, P

KERNEL = CudaKernel("paged_attention.cu", "paged_attention_launch",
                    [P] * 6 + [I] * 7 + [F, F, I, P])


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, hq, dh); k_pool/v_pool (P, ps, hkv, dh) of one layer;
    block_tables (B, nblk) int32 (-1 = unassigned); context_lens (B,)
    int32 (0 = inactive row -> zeros).  Returns (B, hq, dh) f32."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       context_lens, window=window,
                                       softcap=softcap)
    b, hq, dh = q.shape
    _, ps, hkv, dh_pool = k_pool.shape
    nblk = block_tables.shape[1]
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in (torch.bfloat16, torch.float32)
           and k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "q and the pools must share dtype bf16 or f32")
    _check(k_pool.shape == v_pool.shape and dh_pool == dh,
           f"pool shape {tuple(k_pool.shape)} does not fit q {tuple(q.shape)}")
    _check(hq % hkv == 0, f"hq={hq} not a multiple of hkv={hkv}")
    _check(hq // hkv * dh <= 1024, "rep * dh above 1024")
    _check(block_tables.dtype == torch.int32
           and context_lens.dtype == torch.int32
           and tuple(block_tables.shape) == (b, nblk)
           and tuple(context_lens.shape) == (b,),
           "block_tables (B, nblk) and context_lens (B,) must be int32")
    for t in (q, k_pool, v_pool, block_tables, context_lens):
        _check(t.is_contiguous() and t.device == q.device,
               "all operands must be contiguous on one device")
    out = torch.empty((b, hq, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), context_lens.data_ptr(),
                  out.data_ptr(), b, hq, hkv, dh, ps, nblk,
                  window or 0, float(softcap or 0.0), 1.0 / math.sqrt(dh),
                  int(q.dtype == torch.bfloat16), stream)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")
