"""Fused scatter + attend chunked prefill: wrapper of
``csrc/paged_prefill.cu``.

Twin of ``repro.kernels.paged_prefill`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`paged_prefill` launches the hand-written kernel,
which writes the chunk's K/V into the pool pages in place and returns
the chunk's attention output; on a CPU tensor it runs
``ref.paged_prefill_ref``, which does the same.  A CUDA call that the
kernel cannot take raises.

For bf16 the kernel runs on the tensor cores and splits the key
positions across blocks by ``index.paged_prefill_plan`` (computed once
per shape from C, hq, hkv, dh, nblk, ps, the SM count and the blocks an
SM holds, which the CUDA runtime reports); the splits' partials live in
a workspace kept per device and stream.  f32 takes one CUDA-core block
per query tile.  The context page the kernel reads for a key follows
``index.ctx_block_index``, as the plain version's gather does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, F, I, P
from repro_torch.kernels.index import SplitPlan, paged_prefill_plan
from repro_torch.kernels.paged_attention import split_workspace

KERNEL = CudaKernel("paged_prefill.cu", "paged_prefill_launch",
                    [P] * 8 + [I, I, P, P] + [I] * 9 + [F, F] + [I] * 5
                    + [P])

Scalar = Union[int, torch.Tensor]
# (C, hq, hkv, dh, nblk, ps, device index) -> plan of the bf16 kernel
_PLANS: Dict[Tuple, SplitPlan] = {}


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
    _check(hq % hkv == 0 and (hq // hkv <= 16 or q.dtype != torch.float32),
           f"hq={hq}, hkv={hkv}: need hkv | hq, and hq/hkv <= 16 for f32")
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
    dev = q.get_device()
    bf16 = q.dtype == torch.bfloat16
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws, tiling = None, (0, 0, 0)        # f32 takes no plan
    if bf16:
        plan = launch_plan(c, hq, hkv, dh, nblk, ps, dev)
        tiling = (plan.row_tiles, plan.splits, plan.span)
        ws = split_workspace(plan.ws_floats(c * hq, dh), dev, stream)
    vec = (dh * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k_new, v_new, k_pool, v_pool))
    KERNEL.launch(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(), bt_read.data_ptr(),
                  bt_write.data_ptr(),
                  None if meta is None else meta.data_ptr(),
                  start_h, length_h, out.data_ptr(), ws, c, hq, hkv, dh, ps,
                  nblk, pp, layer, window or 0, float(softcap or 0.0),
                  1.0 / math.sqrt(dh), *tiling, int(vec), int(bf16), stream)
    return out


def resident_blocks(dev: int, dh: int) -> int:
    """Blocks of the bf16 kernel for head dim ``dh`` that one SM of card
    ``dev`` holds at once, as the CUDA runtime computes it."""
    fn = KERNEL.library().paged_prefill_occupancy
    fn.argtypes = [I, ctypes.POINTER(I)]
    fn.restype = I
    blocks = I(0)
    with torch.cuda.device(dev):
        err = fn(dh, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"paged_prefill_occupancy(dh={dh}) failed: CUDA "
                           f"error {err}, {blocks.value} blocks")
    return blocks.value


def launch_plan(c: int, hq: int, hkv: int, dh: int, nblk: int, ps: int,
                dev: int) -> SplitPlan:
    """The cached plan of the bf16 kernel for one shape on card ``dev``."""
    key = (c, hq, hkv, dh, nblk, ps, dev)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _PLANS[key] = paged_prefill_plan(
            c, hq, hkv, dh, nblk, ps, sms, resident_blocks(dev, dh))
    return plan


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_prefill: {msg}")
