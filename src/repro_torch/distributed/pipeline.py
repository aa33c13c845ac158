"""GPipe-style pipeline parallelism (twin of
``repro.distributed.pipeline``).

Stages live on consecutive ranks of a mesh dim ("stage"); microbatches
flow through the reference's schedule of ``n_micro + n_stages - 1``
ticks.  Each tick every stage applies its block: stage 0 to microbatch
``min(t, n_micro - 1)``, the others to what the previous stage sent at
the tick before; the last stage keeps its output as microbatch ``t -
n_stages + 1`` when that is one; then every stage sends its output to
the next around the ring (the reference's ``ppermute``, here one
``dist.batch_isend_irecv`` of a send and a receive per rank).  At the
end the last stage's outputs reach every rank of the stage group (a
broadcast: the reference's psum of outputs masked to the last stage).

Forward only, as in the reference's use; the other mesh dims hold
independent replicas of the pipeline.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.distributed.sharding import is_dtensor, mesh_axis_names

Tree = Any


def _ring_shift(y: torch.Tensor, group, nxt: int, prv: int) -> torch.Tensor:
    """Send ``y`` to global rank ``nxt`` and receive from ``prv``."""
    recv = torch.empty_like(y)
    y = y.contiguous()
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()
    return recv


@torch.no_grad()
def pipeline_apply(block_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                   stage_params: Tree, x_micro: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``y = stage_{S-1}(... stage_0(x))`` with the stages over the
    mesh dim ``axis``.

    stage_params: leaves (n_stages, ...): DTensors sharded on dim 0 over
    ``axis`` (each rank holds its stage) or whole tensors (each rank
    takes its own).  x_micro: (n_micro, mb, ...) microbatches, the same
    on every rank, on the mesh's device.  Returns (n_micro, mb, ...):
    the last stage's outputs, on every rank.
    """
    i = mesh_axis_names(mesh).index(axis)
    n_stages, idx = mesh.size(i), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = pytree.tree_map(
        lambda a: a.to_local()[0] if is_dtensor(a) else a[idx], stage_params)
    n_micro = x_micro.shape[0]
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)
    recv = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        y = block_fn(params, x_micro[min(t, n_micro - 1)] if idx == 0
                     else recv)
        out_t = t - (n_stages - 1)
        if idx == n_stages - 1 and 0 <= out_t < n_micro:
            outs[out_t] = y
        recv = y if n_stages == 1 else _ring_shift(y, group, nxt, prv)
    if n_stages > 1:
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
    return outs
