"""Fused PTQ1.61 linear: wrapper of ``csrc/mixed_matmul.cu``.

Twin of ``repro.kernels.mixed_matmul`` (the Pallas TPU kernel and its
in-kernel-gather variant).  On a CUDA tensor :func:`mixed_matmul`
launches the hand-written kernel; on a CPU tensor it runs
``ref.mixed_matmul_ref``.  Hopper needs no feasibility gate: the kernel
takes every shape the packing allows (k_s even, k_b a multiple of 8),
and a CUDA call it cannot take raises.

Two options serve a row-parallel view of a packed leaf (a rank's byte
rows of ``w4`` and ``bits``, ``distributed.sharding.qlinear_local``):
its ``perm`` may be narrower than x's rows, whose channels it gathers
from the whole activation, and ``out_dtype=torch.float32`` returns the
f32 accumulator before its one rounding, so that the ranks' partial
sums add up before the product is rounded once.  Neither changes a bit
of a call without them.

The same kernel body runs ``binary_matmul`` and ``int4_matmul`` with one
span empty; :func:`launch_packed` is the launch all three share.  Its
host side is kept short: the launch plan (``index.packed_matmul_plan``)
is computed once per shape, and the workspaces (split-K partial sums,
gathered x) once per device and stream, grown when a larger shape needs
more.

A tensor that holds no data (a ``FakeTensor``, or one on the "meta"
device: the dry-run, ``launch/dryrun.py``) takes the shape route, the
op ``repro_torch::packed_matmul`` (:func:`packed_matmul`): it returns
the (M, N) output in the dtype asked for, its FLOP formula is
2·M·K·N, and a byte counter that sums an op's operands sees the packed
bytes the kernel reads.  It builds and launches nothing.  Real tensors
never take it.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.index import packed_matmul_plan, packed_nt

# one argument: the 64-bit words that packed_matmul_launch reads, as
# bytes (the 12 pointers, the stream, x's row stride and the f32-output
# flag, then the shape and the plan)
ARGTYPES = [ctypes.c_char_p]
KERNEL = CudaKernel("mixed_matmul.cu", "packed_matmul_launch", ARGTYPES)
_HEAD = struct.Struct("=15q")
OUT_DTYPES = (torch.bfloat16, torch.float32)

# (M, N, K, k_s, device index) -> (plan, its words packed: M, N, K, k_s,
# then nt, row_groups, col_tiles, n4, nb, splits, bounds...)
_PLANS: Dict[Tuple[int, ...], Tuple] = {}
# (device index, raw stream) -> [split-K workspace f32, gathered x bf16]
_SCRATCH: Dict[Tuple[int, int], list] = {}
# device index -> SMs; (device index, nt) -> resident blocks per SM
_SMS: Dict[int, int] = {}
_PER_SM: Dict[Tuple[int, int], int] = {}


def mixed_matmul(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor,
                 z4: torch.Tensor, bits: torch.Tensor, alpha_s: torch.Tensor,
                 alpha_r1: torch.Tensor, alpha_r2: torch.Tensor,
                 perm: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) bf16 — in original channel order when ``perm`` (K,) is
    given (the gather happens inside the kernel), else salient-first.
    With ``perm``, x may be wider than K: (M, K_x) whose channels the
    perm's entries (all below K_x) name.  Returns (M, N) bf16: the f32
    accumulator rounded once, as the TPU kernel's output is cast to the
    activation dtype; with ``out_dtype=torch.float32`` that accumulator
    itself."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"mixed_matmul: out_dtype must be bf16 or f32, "
                         f"got {out_dtype}")
    if holds_no_data(x):
        return packed_matmul(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
                             alpha_r2, out_dtype)
    if x.device.type == "cpu":
        return ref.mixed_matmul_ref(x, w4, s4, z4, bits, alpha_s, alpha_r1,
                                    alpha_r2, perm).to(out_dtype)
    k_s, n = w4.shape[0] * 2, bits.shape[1]
    k_b = bits.shape[0] * 8
    k = k_s + k_b
    check_packed("mixed_matmul", x, k if perm is None else x.shape[-1], n,
                 (w4, bits) if k_s else (bits,),
                 ((s4, k_s), (z4, k_s), (alpha_s, n), (alpha_r1, n),
                  (alpha_r2, k_b)))
    if perm is not None and (
            perm.dtype != torch.int32 or perm.shape != (k,)
            or not perm.is_contiguous()
            or perm.get_device() != x.get_device()):
        raise ValueError("mixed_matmul: perm must be contiguous int32 (K,) "
                         "on x's device")
    return launch_packed(KERNEL, x, perm, w4, s4, z4, bits, alpha_s,
                         alpha_r1, alpha_r2, n, k_s, k=k,
                         out_f32=out_dtype == torch.float32)


def holds_no_data(t: torch.Tensor) -> bool:
    """True for a tensor without storage behind it: a ``FakeTensor`` or
    a tensor on the "meta" device."""
    return t.is_meta or isinstance(t, FakeTensor)


@torch.library.custom_op("repro_torch::packed_matmul", mutates_args=())
def packed_matmul(x: torch.Tensor, perm: Optional[torch.Tensor],
                  w4: torch.Tensor, s4: torch.Tensor, z4: torch.Tensor,
                  bits: torch.Tensor, alpha_s: torch.Tensor,
                  alpha_r1: torch.Tensor, alpha_r2: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The shape route of :func:`mixed_matmul` for tensors that hold no
    data: x (M, K_x) and the eight packed fields -> (M, N) in
    ``out_dtype``.  Only its fake implementation runs."""
    raise RuntimeError("repro_torch::packed_matmul computes shapes only: "
                       "it takes tensors that hold no data (FakeTensor or "
                       "meta); real tensors go through mixed_matmul")


@packed_matmul.register_fake
def _(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1, alpha_r2, out_dtype):
    return x.new_empty((x.shape[0], bits.shape[1]), dtype=out_dtype)


def packed_shape(x_shape, w4_shape, bits_shape) -> Tuple[int, int, int]:
    """(M, K, N) of a packed product of x (M, K_x): K = k_s + k_b the
    weight's (two int4 rows a byte of ``w4``, eight signs a byte of
    ``bits``), N its columns."""
    return (int(x_shape[0]), int(w4_shape[0]) * 2 + int(bits_shape[0]) * 8,
            int(bits_shape[1]))


@register_flop_formula(torch.ops.repro_torch.packed_matmul)
def _packed_flops(x_shape, perm_shape, w4_shape, s4_shape, z4_shape,
                  bits_shape, *args, **kwargs) -> int:
    m, k, n = packed_shape(x_shape, w4_shape, bits_shape)
    return 2 * m * k * n


def check_packed(name: str, x: torch.Tensor, k: int, n: int,
                 packed: Sequence[torch.Tensor],
                 vectors: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Raise ``ValueError`` unless x is a contiguous bf16 (M, k) CUDA
    tensor, every ``packed`` tensor a contiguous uint8 (rows, n) matrix
    and every ``vectors`` entry ``(tensor, size)`` a contiguous f32
    vector of that size, all on x's card."""
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if (x.dtype != torch.bfloat16 or x.ndim != 2 or x.shape[1] != k
            or not x.is_contiguous()):
        raise ValueError(f"{name}: x must be contiguous bf16 (M, {k}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = x.get_device()
    for t in packed:
        if (t.dtype != torch.uint8 or t.ndim != 2 or t.shape[1] != n
                or not t.is_contiguous() or t.get_device() != dev):
            raise ValueError(f"{name}: packed weights must be contiguous "
                             f"uint8 (rows, {n}) on {x.device}")
    for t, size in vectors:
        if (t.dtype != torch.float32 or t.shape != (size,)
                or not t.is_contiguous() or t.get_device() != dev):
            raise ValueError(f"{name}: scales must be contiguous f32 "
                             f"({size},) on {x.device}")


def resident_blocks(dev: int, nt: int) -> int:
    """Blocks of the packed-matmul kernel with ``nt`` row tiles that one
    SM of card ``dev`` holds at once, as the CUDA runtime computes it
    from the kernel's registers and shared memory (cached)."""
    key = (dev, nt)
    hit = _PER_SM.get(key)
    if hit is None:
        fn = KERNEL.library().packed_matmul_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(nt, ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"packed_matmul_occupancy(nt={nt}) failed: "
                               f"CUDA error {err}, {blocks.value} blocks")
        hit = _PER_SM[key] = blocks.value
    return hit


def launch_plan(m: int, n: int, k: int, k_s: int, dev: int):
    """The cached plan of one shape on card ``dev`` and the words that
    follow the pointers and the stream in the launch argument."""
    key = (m, n, k, k_s, dev)
    hit = _PLANS.get(key)
    if hit is None:
        sms = _SMS.get(dev)
        if sms is None:
            sms = _SMS[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        plan = packed_matmul_plan(m, n, k, k_s, sms,
                                  resident_blocks(dev, packed_nt(m)))
        words = (m, n, k, k_s, plan.nt, plan.row_groups, plan.col_tiles,
                 plan.n4, plan.nb, plan.splits) + plan.bounds
        hit = _PLANS[key] = (plan, struct.pack(f"={len(words)}q", *words))
    return hit


def _scratch(plan, dev: int, stream: int):
    """The workspaces of one stream, grown to fit ``plan``."""
    s = _SCRATCH.get((dev, stream))
    if s is None:
        s = _SCRATCH[(dev, stream)] = [None, None]
    device = f"cuda:{dev}"
    if plan.ws_floats and (s[0] is None or s[0].numel() < plan.ws_floats):
        s[0] = torch.empty(plan.ws_floats, dtype=torch.float32, device=device)
    if plan.xg_elems and (s[1] is None or s[1].numel() < plan.xg_elems):
        s[1] = torch.empty(plan.xg_elems, dtype=torch.bfloat16, device=device)
    return s


def _ptr(t: Optional[torch.Tensor]):
    return 0 if t is None else t.data_ptr()


def launch_packed(kernel: CudaKernel, x: torch.Tensor,
                  perm: Optional[torch.Tensor], w4: Optional[torch.Tensor],
                  s4: Optional[torch.Tensor], z4: Optional[torch.Tensor],
                  bits: Optional[torch.Tensor],
                  alpha_s: Optional[torch.Tensor],
                  alpha_r1: Optional[torch.Tensor],
                  alpha_r2: Optional[torch.Tensor], n: int,
                  k_s: int, k: Optional[int] = None,
                  out_f32: bool = False) -> torch.Tensor:
    """Launch the packed-matmul body on checked operands; a span that is
    empty passes None for its tensors.  ``k`` is the weight's K (x's
    width by default; x may be wider under a ``perm``).  Returns y (M,
    N) bf16, or with ``out_f32`` the f32 accumulator.  The launch is
    counted under its shape (M, K, N); a K of 0 (a row-parallel view
    that holds no byte row) launches nothing and returns zeros."""
    m, ldx = x.shape
    k = ldx if k is None else k
    y = x.new_empty((m, n), dtype=torch.float32 if out_f32 else x.dtype)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    dev = x.get_device()
    plan, words = launch_plan(m, n, k, k_s, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws, xg = _scratch(plan, dev, stream)
    kernel.launch(_HEAD.pack(x.data_ptr(), _ptr(perm), _ptr(w4), _ptr(s4),
                             _ptr(z4), _ptr(bits), _ptr(alpha_s),
                             _ptr(alpha_r1), _ptr(alpha_r2), y.data_ptr(),
                             _ptr(ws), _ptr(xg), stream, ldx, int(out_f32))
                  + words,
                  shape=(m, k, n))
    return y
