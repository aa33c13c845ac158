"""Paged flash-decode attention: wrapper of ``csrc/paged_attention.cu``.

Twin of ``repro.kernels.paged_attention`` (the Pallas TPU kernel).  On a
CUDA tensor :func:`paged_attention` launches the hand-written kernel; on
a CPU tensor it runs ``ref.paged_attention_ref``.  There is no other
route: a CUDA call that the kernel cannot take raises.

The kernel splits each slot's key positions across blocks by
``index.paged_attention_plan`` (computed once per shape from B, hkv,
nblk, ps, the SM count and the blocks an SM holds, which the CUDA
runtime reports); a second kernel combines the splits' partials in
split order.  The partials live in a workspace kept per device and
stream, which the prefill wrapper shares.  Nothing
is read back from the device.  The page the kernel reads for a key
follows ``index.kv_block_index``, as the plain version's gather does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, F, I, P
from repro_torch.kernels.index import SplitPlan, paged_attention_plan

KERNEL = CudaKernel("paged_attention.cu", "paged_attention_launch",
                    [P] * 7 + [I] * 7 + [F, F] + [I] * 4 + [P])

# (B, hkv, rep, dh, nblk, ps, bf16, device index) -> plan
_PLANS: Dict[Tuple, SplitPlan] = {}
# (device index, raw stream) -> workspace of the split partials, which both
# attention wrappers use (their calls run in stream order)
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


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
    _check(block_tables.dtype == torch.int32
           and context_lens.dtype == torch.int32
           and tuple(block_tables.shape) == (b, nblk)
           and tuple(context_lens.shape) == (b,),
           "block_tables (B, nblk) and context_lens (B,) must be int32")
    for t in (q, k_pool, v_pool, block_tables, context_lens):
        _check(t.is_contiguous() and t.device == q.device,
               "all operands must be contiguous on one device")
    out = torch.empty((b, hq, dh), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    dev = q.get_device()
    bf16 = q.dtype == torch.bfloat16
    plan = launch_plan(b, hkv, hq // hkv, dh, nblk, ps, bf16, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = split_workspace(plan.ws_floats(b * hq, dh), dev, stream)
    vec = (dh * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), context_lens.data_ptr(),
                  out.data_ptr(), ws, b, hq, hkv, dh, ps, nblk,
                  window or 0, float(softcap or 0.0), 1.0 / math.sqrt(dh),
                  plan.span, plan.splits, int(vec), int(bf16), stream)
    return out


def resident_blocks(dev: int, bf16: bool, rep: int, dh: int) -> int:
    """Blocks of the decode kernel one SM of card ``dev`` holds at once
    for this group size and head dim, as the CUDA runtime computes it
    from the kernel's registers and shared memory."""
    fn = KERNEL.library().paged_attention_occupancy
    fn.argtypes = [I, I, I, ctypes.POINTER(I)]
    fn.restype = I
    blocks = I(0)
    with torch.cuda.device(dev):
        err = fn(int(bf16), rep, dh, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"paged_attention_occupancy(rep={rep}, dh={dh}) "
                           f"failed: CUDA error {err}, {blocks.value} blocks")
    return blocks.value


def launch_plan(b: int, hkv: int, rep: int, dh: int, nblk: int, ps: int,
                bf16: bool, dev: int) -> SplitPlan:
    """The cached plan of one shape on card ``dev``."""
    key = (b, hkv, rep, dh, nblk, ps, bf16, dev)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _PLANS[key] = paged_attention_plan(
            b, hkv, nblk, ps, sms, resident_blocks(dev, bf16, rep, dh))
    return plan


def split_workspace(floats: int, dev: int, stream: int) -> Optional[int]:
    """The device address of the f32 split workspace of ``stream``, grown
    to ``floats`` (``SplitPlan.ws_floats``); None when the plan needs
    none."""
    if not floats:
        return None
    ws = _SCRATCH.get((dev, stream))
    if ws is None or ws.numel() < floats:
        ws = _SCRATCH[(dev, stream)] = torch.empty(
            floats, dtype=torch.float32, device=f"cuda:{dev}")
    return ws.data_ptr()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")
