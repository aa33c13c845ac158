"""Fused scatter + attend chunked prefill: wrapper of
``csrc/paged_prefill.cu``.

Twin of ``repro.kernels.paged_prefill`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`paged_prefill` launches the hand-written kernel,
which writes the chunk's K/V into the pool pages in place and returns
the chunk's attention output; on a CPU tensor it runs
``ref.paged_prefill_ref``, which does the same.  A CUDA call that the
kernel cannot take raises.

The context page the kernel reads at each step follows
``index.ctx_block_index``, as the plain version's gather does.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, F, I, P

KERNEL = CudaKernel("paged_prefill.cu", "paged_prefill_launch",
                    [P] * 8 + [I, I, P] + [I] * 9 + [F, F, I, P])

Scalar = Union[int, torch.Tensor]


def paged_prefill(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  bt_read: torch.Tensor, bt_write: torch.Tensor,
                  start: Scalar, length: Scalar, *, layer: int,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q (C, hq, dh); k_new/v_new (C, hkv, dh) already at the pool dtype;
    k_pool/v_pool (L, P+1, ps, hkv, dh), updated in place at ``layer``;
    bt_read (nblk,) the request's block table; bt_write (nblk,) its
    writable row (shared blocks -1); start the page-aligned chunk origin
    and length the live tokens (1..C), as host ints or device int32
    scalars.  Returns o (C, hq, dh) f32; rows past ``length`` are
    garbage."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, k_new, v_new, k_pool, v_pool,
                                     bt_read, bt_write, start, length,
                                     layer=layer, window=window,
                                     softcap=softcap)
    c, hq, dh = q.shape
    nlayers, pp, ps, hkv, dh_pool = k_pool.shape
    nblk = bt_read.shape[0]
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in (torch.bfloat16, torch.float32)
           and all(t.dtype == q.dtype for t in (k_new, v_new, k_pool, v_pool)),
           "q, k_new, v_new and the pools must share dtype bf16 or f32")
    _check(k_pool.shape == v_pool.shape and dh_pool == dh
           and tuple(k_new.shape) == (c, hkv, dh)
           and tuple(v_new.shape) == (c, hkv, dh),
           "shapes of q, k_new, v_new and the pools disagree")
    _check(c % ps == 0, f"chunk {c} not a multiple of page size {ps}")
    _check(hq % hkv == 0 and hq // hkv <= 16,
           f"hq={hq}, hkv={hkv}: need hkv | hq and hq/hkv <= 16")
    _check(dh <= 256, f"dh={dh} above 256")
    _check(0 <= layer < nlayers, f"layer {layer} out of range")
    _check(bt_read.dtype == torch.int32 and bt_write.dtype == torch.int32
           and tuple(bt_write.shape) == (nblk,),
           "bt_read and bt_write must be int32 (nblk,)")
    for t in (q, k_new, v_new, k_pool, v_pool, bt_read, bt_write):
        _check(t.is_contiguous() and t.device == q.device,
               "all operands must be contiguous on one device")
    meta = None
    start_h = length_h = 0
    if isinstance(start, torch.Tensor) or isinstance(length, torch.Tensor):
        meta = torch.stack([torch.as_tensor(start, device=q.device),
                            torch.as_tensor(length, device=q.device)]
                           ).to(torch.int32).reshape(2).contiguous()
    else:
        start_h, length_h = int(start), int(length)
        _check(start_h % ps == 0 and 0 < length_h <= c,
               f"start={start_h} must be page-aligned, 0 < length <= {c}")
    out = torch.empty((c, hq, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(), bt_read.data_ptr(),
                  bt_write.data_ptr(),
                  None if meta is None else meta.data_ptr(),
                  start_h, length_h, out.data_ptr(), c, hq, hkv, dh, ps,
                  nblk, pp, layer, window or 0, float(softcap or 0.0),
                  1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16),
                  stream)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_prefill: {msg}")
