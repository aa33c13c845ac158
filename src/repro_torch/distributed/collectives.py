"""Collectives over one process group, differentiable where the sharded
train step needs them.

* :func:`all_gather` along a tensor dim; its backward reduce-scatters
  (sums) the gradient back to this rank's part: the FSDP gather of a
  leaf sharded over data, and the gather of a KV projection over
  "model".
* :func:`grad_sum`: the identity, whose backward sums the gradient over
  the group (Megatron's f; a replicated leaf's gradient over data).
* :func:`sum_over`: the sum over the group, whose backward is the
  identity (Megatron's g).
* :func:`all_to_all` from one tensor dim to another; its backward is
  the inverse all-to-all: the reshard of an expert leaf from its
  storage shard (experts over "model") to its compute shard (the ffn
  dim over "model").
* :func:`gather_narrow`: a gather whose backward keeps this rank's part
  of the gradient instead of summing it, for a gathered tensor that
  every rank of the group then uses in the same replicated computation.
* :func:`gather_seq` and :func:`scatter_seq`, the sequence-parallel
  pair over uneven chunks (rank r holding items [r·c, min((r+1)·c, n))
  of n, c = ceil(n / size)): the whole from every rank's chunk, whose
  backward reduce-scatters the gradient back to the chunk (or, for a
  whole that every rank uses alike, keeps this rank's chunk of it); and
  the sum over the group cut to this rank's chunk, whose backward
  gathers the gradient.  Each part is padded with zeros to c and the
  padding stripped after, so the pad changes no value.
* :func:`all_reduce_`: an in-place reduction without gradient.
* :func:`gather_chunks`: the whole tensor from every rank's uneven chunk
  of it (``torch.chunk``'s layout), without gradient: the O(K) vectors
  of a row-parallel packed leaf, once at placement.

Every rank of the group calls each of them in the same order.  With
NCCL the tensors lie on the rank's card, with gloo on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the names newer torch gives the tensor forms (same arguments)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``group`` in place ("sum" or "max")."""
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, xs, group=group)
    return out.movedim(0, dim)


def _scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    gs = g.movedim(dim, 0).contiguous()
    out = torch.empty((gs.shape[0] // n,) + tuple(gs.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _scatter_from(out, gs, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _chunk(n: int, size: int, rank: int):
    """[lo, hi) of rank's chunk of n items (``sharding.chunk_range``'s
    layout) and the chunk length c."""
    c = -(-n // size)
    lo = min(rank * c, n)
    return lo, min(lo + c, n), c


def _pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` padded with zeros along ``dim`` to ``n`` items."""
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _gather_seq(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    c = _chunk(n, dist.get_world_size(group), 0)[2]
    return _gather(_pad(x, dim, c), dim, group).narrow(dim, 0, n)


def _scatter_seq(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    size, n = dist.get_world_size(group), y.shape[dim]
    lo, hi, c = _chunk(n, size, dist.get_rank(group))
    return _scatter(_pad(y, dim, size * c), dim, group).narrow(dim, 0, hi - lo)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, group, rep):
        ctx.dim, ctx.group, ctx.rep = dim, group, rep
        ctx.lo, ctx.hi, _ = _chunk(n, dist.get_world_size(group),
                                   dist.get_rank(group))
        return _gather_seq(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.rep:
            g = g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo)
        else:
            g = _scatter_seq(g, ctx.dim, ctx.group)
        return g, None, None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.n, ctx.group = dim, y.shape[dim], group
        return _scatter_seq(y, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.dim, ctx.n, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


def _exchange(x: torch.Tensor, split: int, cat: int, group) -> torch.Tensor:
    """Part i of ``x`` along ``split`` goes to rank i; the parts received
    are joined along ``cat`` in rank order."""
    n = dist.get_world_size(group)
    xs = x.movedim(split, 0)
    xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:])).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return torch.cat([o.movedim(0, split) for o in out.unbind(0)], dim=cat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, cat, group):
        ctx.split, ctx.cat, ctx.group = split, cat, group
        return _exchange(x, split, cat, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.cat, ctx.split, ctx.group), None, None, None


class _GatherNarrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.k = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k), None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's parts of ``x`` joined along ``dim`` in rank order."""
    return _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split: int, cat: int, group) -> torch.Tensor:
    """``x`` cut into the group's size of parts along ``split``, part i
    sent to rank i, and the parts received joined along ``cat`` in rank
    order: ``split`` shrinks and ``cat`` grows by the group's size."""
    return _AllToAll.apply(x, split, cat, group)


def gather_narrow(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather`'s value; its backward narrows the gradient to
    this rank's part, for a result that every rank uses alike (each
    holds the whole gradient already)."""
    return _GatherNarrow.apply(x, dim, group)


def gather_seq(x: torch.Tensor, dim: int, n: int, group,
               rep: bool = False) -> torch.Tensor:
    """The whole ``n`` items along ``dim`` from every rank's chunk
    ``x`` of them (rank r: [r·c, min((r+1)·c, n)), c = ceil(n / size),
    possibly empty).  Backward: the gradient summed over the group and
    cut to this rank's chunk (a reduce-scatter), or with ``rep`` (a
    whole that every rank then uses alike, so each holds the whole
    gradient) this rank's chunk of it."""
    return _GatherSeq.apply(x, dim, n, group, rep)


def scatter_seq(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``y`` summed over the group
    (a reduce-scatter in :func:`gather_seq`'s layout); its backward
    gathers the gradient."""
    return _ScatterSeq.apply(y, dim, group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _GradSum.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


@torch.no_grad()
def gather_chunks(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """The whole (n, ...) tensor from every rank's chunk ``t`` of it
    along dim 0, rank r holding rows [r·c, min((r+1)·c, n)) with c =
    ceil(n / size): each chunk is padded to c, gathered, and the whole
    cut to n rows."""
    size = dist.get_world_size(group)
    c = -(-n // size)
    pad = t.new_zeros((c,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    out = t.new_empty((size * c,) + tuple(t.shape[1:]))
    _gather_into(out, pad, group=group)
    return out[:n]
