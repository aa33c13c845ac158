"""Abstract quantized-parameter declaration for sharded serving (twin of
``repro.launch.qdeclare``).

Walks the P-declared parameter tree; every quantizable leaf becomes a
``QLinear`` of meta tensors (packed shapes per ``QuantConfig``), with
the matching QLinear of Specs emitted in the same pass: no weights, no
device memory.  The port's ``QLinear`` has no ``use_kernel`` field: the
device picks the route.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import QLinear, QuantConfig
from repro_torch.core.saliency import round_salient
from repro_torch.core.select import is_quantizable, map_tree
from repro_torch.distributed.sharding import Rules, qlinear_specs
from repro_torch.models import model as M
from repro_torch.models.common import Parallel
from repro_torch.models.param import P

Tree = Any


def meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` that holds no memory."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def declare_qlinear(p: P, qcfg: QuantConfig) -> QLinear:
    """P((..., K, N)) -> a QLinear of meta tensors with the packed
    shapes and dtypes the quantizer gives."""
    lead = tuple(p.shape[:-2])
    k, n = p.shape[-2:]
    k_s = round_salient(k, qcfg.ratio, qcfg.multiple)
    k_b = k - k_s
    return QLinear(
        perm=meta(lead + (k,), torch.int32),
        w4=meta(lead + (k_s // 2, n), torch.uint8),
        s4=meta(lead + (k_s,), torch.float32),
        z4=meta(lead + (k_s,), torch.float32),
        bits=meta(lead + (k_b // 8, n), torch.uint8),
        alpha_s=meta(lead + (n,), torch.float32),
        alpha_r1=meta(lead + (n,), torch.float32),
        alpha_r2=meta(lead + (k_b,), torch.float32),
        k_s=k_s, k=k, n=n)


def declare_quantized(cfg: ArchConfig, par: Parallel, qcfg: QuantConfig,
                      rules: Rules, min_dim: int = 256) -> Tuple[Tree, Tree]:
    """(abstract quantized params, Spec tree), one structure: the
    quantizable leaves as :func:`declare_qlinear` and QLinears of Specs
    (``distributed.sharding.qlinear_specs``), the rest as meta tensors
    and their Specs."""
    declared = M.declare_params(cfg, par)
    abstract = map_tree(declared, lambda path, p: _declare(path, p, qcfg,
                                                           min_dim))

    def spec(path, p):
        q = abstract
        for key in path:
            q = q[key]
        if isinstance(q, QLinear):
            return qlinear_specs(p.axes, q.k_s, q.k, q.n, rules)
        return rules.spec(p.axes)

    return abstract, map_tree(declared, spec)


def _declare(path, p: P, qcfg: QuantConfig, min_dim: int):
    t = meta(p.shape, p.dtype)
    return declare_qlinear(p, qcfg) if is_quantizable(path, t, min_dim) else t
