"""Shared model-side helpers (twin of ``repro.models.common``): the
run-time parallelism knobs, the mesh the caller runs under, sharding
hints, and :class:`Shards`, one rank's place on that mesh as the model
code needs it.

The reference leaves the layout of every activation to GSPMD and only
hints at it.  The port runs each rank's part of the step on local
tensors (``torch.distributed.tensor.DTensor`` holds the train state;
the model sees ``to_local()`` shards), so where the reference hints,
the port's model code calls the collectives of :class:`Shards`
explicitly: the FSDP gather of a block's leaves, Megatron's f and g
around the tensor-parallel products (on the sequence-parallel stream,
``par.sp``, the all-gather and reduce-scatter along the sequence that
take their place), the vocab-parallel embedding and
cross entropy, the experts' reshard under EP and the gathers of the
group-local MoE and the sLSTM's replicated scan, and in sharded serving
the row-parallel packed product (:meth:`Shards.row`).  Off a mesh, or on
a one-rank mesh, every helper here returns its input.

``shard_map_compat`` of the reference is a shim across JAX versions and
has no counterpart: ``distributed/pipeline.py`` runs its per-rank body
directly, with ``torch.distributed`` point-to-point operations.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.qlinear import QLinear, QLinearGroup
from repro_torch.core.select import map_tree
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (at, chunk_range, is_dtensor,
                                              placements)
from repro_torch.kernels import ops
from repro_torch.models.linear import dense

Tree = Any
DATA_DIMS = ("pod", "data")


@dataclass(frozen=True)
class Parallel:
    """Parallelism knobs the *model code* needs to know about (the
    reference's fields and defaults).

    The full mesh/rule mapping lives in ``repro_torch.distributed.
    sharding``; the model needs the tensor-parallel degree (to replicate
    KV heads) and whether the residual stream is sequence-parallel.
    With ``sp``, tp > 1 and more than one position (the sharded train
    step, sharded prefill, the encoder), each model rank holds its
    chunk of the stream's sequence between blocks (``Shards.along``:
    ``sharding.chunk_range``'s layout, as GSPMD pads the reference's
    hint), and each tensor-parallel sublayer gathers its input and
    reduce-scatters its output; without, the stream is replicated over
    "model" and each sublayer's output is all-reduced.  Decode (one
    position) keeps the replicated stream either way.  ``sp`` changes
    where the stream lives and which collectives run, not what is
    computed.
    """

    tp: int = 1                 # size of the "model" mesh axis
    dp: int = 1                 # size of the "data" (* pod) axes
    fsdp: bool = False          # ZeRO-3: shard params' embed dim over data
    sp: bool = True             # sequence-parallel activation constraints
    microbatches: int = 1       # gradient-accumulation chunks per step
    remat: bool = True          # activation checkpointing per superblock
    attn_chunk: int = 1024      # flash-style KV chunking threshold/size
    shard_batch: bool = True    # False when global batch < dp (long_500k)
    decode_unroll: bool = False  # the reference's unrolled decode loop

    def kv_heads_run(self, n_kv: int, n_q: Optional[int] = None) -> int:
        """Megatron-style KV-head replication for tensor parallelism.

        Replicate KV heads toward the TP degree so the KV projections
        shard over "model", subject to the GQA constraint that the
        run-time KV count divides the query-head count.  Where the head
        counts do not divide the TP degree, the largest valid count <=
        tp (the reference lets GSPMD pad the uneven shard; the port's
        sharded step gives each rank whole heads, ``Shards.heads``)."""
        if self.tp <= n_kv:
            return n_kv
        best = n_kv
        if n_q is None:
            return (self.tp // n_kv) * n_kv
        for cand in range(n_kv, self.tp + 1, n_kv):
            if n_q % cand == 0:
                best = cand
        return best


# ---------------------------------------------------------------------------
# The mesh the caller runs under, and the reference's hints
# ---------------------------------------------------------------------------
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the body under ``mesh`` (a ``DeviceMesh``): the counterpart
    of the reference's ``with mesh:``.  Nothing reads a mesh from the
    environment; the caller sets it here."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


def in_mesh() -> bool:
    """True under a mesh of more than one device."""
    m = current_mesh()
    return m is not None and m.size() > 1


def _batch_axes():
    m = current_mesh()
    names = m.mesh_dim_names if m is not None else ()
    return DATA_DIMS if "pod" in names else "data"


def batch_spec(*rest) -> tuple:
    """A spec with the batch dim over data (and pod) and the given tail
    axes."""
    return (_batch_axes(),) + rest


def hint(x, *axes):
    """The reference's sharding constraint: off a mesh, on a one-rank
    mesh, or on a local tensor it returns ``x``; a ``DTensor`` is
    redistributed to the placements of the spec ``axes``."""
    if not in_mesh() or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(axes, x.device_mesh))


def hint_act(x, par: Parallel):
    """Residual-stream hint: (batch, seq, d_model) with the batch over
    data (and pod) and, with ``par.sp``, the sequence over "model"."""
    if not in_mesh():
        return x
    batch = _batch_axes() if par.shard_batch and x.shape[0] > 1 else None
    if x.ndim == 3 and par.sp and x.shape[1] > 1:
        return hint(x, batch, "model", None)
    if x.ndim == 3:
        return hint(x, batch, None, None)
    return hint(x, batch, None)


# ---------------------------------------------------------------------------
# One rank's place on the mesh
# ---------------------------------------------------------------------------
class Shards:
    """One rank's place on a ``DeviceMesh`` with dims among ("pod",
    "data", "model"), and the collectives the model code calls on its
    local tensors.

    ``specs`` is the parameter tree's spec tree (``distributed.sharding.
    specs_for_tree``): per leaf, a tuple with, per tensor dim, None, a
    mesh dim name or a tuple of them.  A dim over data (and pod) is
    gathered before use (:meth:`gather`, whose backward is the
    reduce-scatter); a leaf sharded over "model" stays local, and the
    block code runs its products Megatron-style (:meth:`enter`,
    :meth:`leave`).  The batch of a step is split over the data ranks,
    pod-major, as the reference's ``("pod", "data")`` batch spec splits
    it.  Groups of one rank skip their collective, so a one-rank mesh
    computes what one device does.

    ``seq`` is the length of the sequence-parallel stream of the call
    (:meth:`along`), None where the stream is replicated over "model".
    """

    seq: Optional[int] = None

    def __init__(self, mesh, par: Parallel, specs: Tree):
        names = tuple(mesh.mesh_dim_names or ())
        if "model" not in names or "data" not in names:
            raise ValueError(f"a training mesh has 'data' and 'model' "
                             f"dims; this one has {names}")
        self.mesh, self.par, self.specs = mesh, par, specs
        self.data_dims = tuple(n for n in DATA_DIMS if n in names)
        self.tp = self._size("model")
        self.tp_rank = mesh.get_local_rank("model")
        self.dp, self.dp_rank = 1, 0
        for n in self.data_dims:             # pod-major
            self.dp_rank = self.dp_rank * self._size(n) + \
                mesh.get_local_rank(n)
            self.dp *= self._size(n)
        if (self.tp, self.dp) != (par.tp, par.dp):
            raise ValueError(f"mesh has tp={self.tp}, dp={self.dp}; "
                             f"Parallel says tp={par.tp}, dp={par.dp}")

    def _size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    def group(self, name: str):
        return self.mesh.get_group(name)

    def _groups(self, names) -> Tuple:
        return tuple(self.group(n) for n in names if self._size(n) > 1)

    # -- parameters ------------------------------------------------------
    def gather(self, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """A local leaf -> its tensor for compute: every dim over data
        (and pod) gathered, innermost mesh dim first; its backward
        reduce-scatters the gradient back to the shard.  A leaf with no
        dim over data gets its gradient summed over the data ranks
        instead.  Dims over "model" stay local.  A packed ``QLinear``
        (a serving view of ``distributed.sharding.qlinear_local``, which
        holds nothing over data) is returned as it is, and so is a fused
        group's view (``sharding.group_local``, which has no spec of its
        own: ``spec`` None)."""
        if isinstance(t, (QLinear, QLinearGroup)):
            return t
        over_data = False
        for i, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            for n in reversed(names):
                if n in self.data_dims:
                    over_data = True
                    if self._size(n) > 1:
                        t = C.all_gather(t, i, self.group(n))
        if not over_data:
            for g in self._groups(self.data_dims):
                t = C.grad_sum(t, g)
        return t

    def gather_tree(self, tree: Tree, spec_tree: Tree) -> Tree:
        """:meth:`gather` of every leaf of ``tree`` by its Spec."""
        return map_tree(tree, lambda path, t: self.gather(
            t, None if isinstance(t, QLinearGroup) else at(spec_tree, path)))

    def gather_model(self, t, dim: int):
        """``t`` gathered over "model" along ``dim`` (backward: the
        reduce-scatter of the gradient).  A column-parallel packed view
        (its N over "model") is gathered along N: ``w4``, ``bits``,
        ``alpha_s`` and ``alpha_r1`` along their last dim, beside the
        vectors it holds whole; the gathered fields are made contiguous,
        as the packed matmul takes them (a gather along the last dim
        is a strided view)."""
        if self.tp == 1:
            return t
        group = self.group("model")
        if isinstance(t, QLinear):
            cols = {f: C.all_gather(getattr(t, f), getattr(t, f).ndim - 1,
                                    group).contiguous()
                    for f in ("w4", "bits", "alpha_s", "alpha_r1")}
            return dataclasses.replace(t, **cols, n=t.n * self.tp)
        return C.all_gather(t, dim, group)

    # -- Megatron's f and g ------------------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f: the identity, whose backward sums the gradient over
        "model" (a replicated tensor entering a tensor-parallel
        region)."""
        return x if self.tp == 1 else C.grad_sum(x, self.group("model"))

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """g: the sum over "model" (a row-parallel product's partial
        sums), whose backward is the identity."""
        return x if self.tp == 1 else C.sum_over(x, self.group("model"))

    # -- the residual stream: replicated, or sequence-parallel --------------
    def splits(self, s: int) -> bool:
        """True when a stream of ``s`` positions is sequence-parallel:
        ``par.sp``, tp > 1 and s > 1 (the reference's ``hint_act``)."""
        return self.par.sp and self.tp > 1 and s > 1

    def along(self, s: int) -> "Shards":
        """This rank's place for a call whose stream has ``s`` positions:
        a copy whose ``seq`` is s where :meth:`splits`, else None.  The
        model's entry points (``forward_loss``, ``prefill``, ``encode``)
        take it once and pass it down, so a block recomputed in the
        backward pass sees the same layout."""
        view = copy.copy(self)
        view.seq = s if self.splits(s) else None
        return view

    def chunk(self) -> Tuple[int, int]:
        """[lo, hi) of this model rank's positions of the stream
        (``sharding.chunk_range``: ceil(seq / tp) a rank, the trailing
        ranks short or empty); every position when replicated."""
        if self.seq is None:
            raise ValueError("the stream is replicated over 'model'")
        return chunk_range(self.seq, self.tp, self.tp_rank)

    def stream_in(self, x: torch.Tensor) -> torch.Tensor:
        """The stream entering a tensor-parallel sublayer: this rank's
        chunk gathered along the sequence (backward: the gradient's
        reduce-scatter), or, replicated, Megatron's f (:meth:`enter`)."""
        if self.seq is None:
            return self.enter(x)
        return C.gather_seq(x, 1, self.seq, self.group("model"))

    def stream_rep(self, x: torch.Tensor) -> torch.Tensor:
        """The stream's whole rows for a computation every model rank
        runs alike (the MoE's routing and its aux loss): this rank's
        chunk gathered along the sequence, its backward keeping this
        rank's chunk of the gradient; replicated, ``x``."""
        if self.seq is None:
            return x
        return C.gather_seq(x, 1, self.seq, self.group("model"), rep=True)

    def stream_out(self, y: torch.Tensor) -> torch.Tensor:
        """A sublayer's partial sums leaving into the stream: summed over
        "model" and cut to this rank's chunk (a reduce-scatter; backward:
        the gradient's all-gather), or, replicated, all-reduced
        (:meth:`leave`)."""
        if self.seq is None:
            return self.leave(y)
        return C.scatter_seq(y, 1, self.group("model"))

    def stream_part(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a (B, S, ...) tensor every model rank
        holds whole (the encoder's frames, a packed MoE's output); the
        whole when replicated."""
        if self.seq is None:
            return x
        lo, hi = self.chunk()
        return x.narrow(1, lo, hi - lo)

    def stream_leaf(self, tree: Tree) -> Tree:
        """A replicated leaf (a norm's scale and bias) applied to the
        stream: on the sequence-parallel stream each rank's gradient
        covers its chunk alone, so it is summed over "model"
        (:meth:`enter`); replicated, the tree as it is."""
        if self.seq is None:
            return tree
        return map_tree(tree, lambda path, t: self.enter(t))

    def stream_last(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, D): the stream's last position on every model rank,
        from the rank whose chunk holds it (each rank's last row, or
        zeros from an empty chunk, gathered over "model")."""
        if self.seq is None:
            return x[:, -1:]
        last = x[:, -1:] if x.shape[1] else x.new_zeros(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        c = -(-self.seq // self.tp)
        return C.all_gather(last, 1, self.group("model")).narrow(
            1, (self.seq - 1) // c, 1)

    def row(self, x: torch.Tensor, w, heads: Optional[Tuple[int, int]] = None
            ) -> torch.Tensor:
        """A row-parallel product (``wo``, ``wd``) of this rank's input
        columns ``x`` (its heads or ffn columns) over the whole sequence,
        leaving into the stream (:meth:`stream_out`).  A plain leaf: the
        local product's partial sums summed over "model" (g), or
        reduce-scattered to this rank's chunk of the sequence-parallel
        stream.  A packed row view (``qlinear_local``): x gathered over
        "model" whole, the view's perm gathers its channels from it, the
        packed matmul returns its f32 accumulator, the partials are
        summed (or reduce-scattered) over "model" in f32 and rounded to
        bf16 once, as one device's kernel rounds its accumulator once (a
        bf16 sum of rounded partials would add up to tp/2 ulps).

        ``heads`` (n, width): x holds this rank's whole heads
        (:meth:`heads` of n) of ``width`` columns each; a plain leaf
        takes the rows of those heads (:meth:`head_part`), and a packed
        view's input is joined from the ranks' uneven head parts
        (:meth:`gather_heads`)."""
        if not isinstance(w, QLinear):
            if heads is not None:
                w = self.head_part(w, heads[0], 0)
            return self.stream_out(dense(x, w))
        if heads is None:
            xw = self.gather_model(x, x.ndim - 1)
        else:
            n, width = heads
            xh = x.reshape(x.shape[:-1] + (-1, width))
            xw = self.gather_heads(xh, n, xh.ndim - 2).reshape(
                x.shape[:-1] + (n * width,))
        y = ops.mixed_matmul(xw, w, out_dtype=torch.float32)
        if self.seq is not None:
            y = C.scatter_seq(y, 1, self.group("model"))
        elif self.tp > 1:
            y = C.all_reduce_(y.contiguous(), self.group("model"))
        return y.to(torch.bfloat16).to(x.dtype)

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's part along ``dim`` of a replicated leaf
        (or activation) that the rank uses only in part, in the layout
        of :meth:`heads` (even where tp divides the dim): the whole
        passes through :meth:`enter` before the cut, so its gradient,
        zero outside each rank's part, is summed over "model"."""
        if self.tp == 1:
            return t
        lo, hi = self.heads(t.shape[dim])
        return self.enter(t).narrow(dim, lo, hi - lo)

    # -- whole heads per rank ----------------------------------------------
    def heads(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this model rank's heads of ``n``: the ceil layout
        of ``distributed.sharding.chunk_range`` (``torch.chunk``'s,
        DTensor's ``Shard`` and GSPMD's padding), ceil(n / tp) heads a
        rank, the trailing ranks short or empty (phi4-mini's 24 query
        heads at tp 16: 2 on ranks 0-11, none on 12-15)."""
        return chunk_range(n, self.tp, self.tp_rank)

    def head_part(self, t, n: int, dim: int):
        """This rank's whole heads (:meth:`heads` of ``n``) of a leaf
        whose ``dim`` holds ``n`` heads and lies over "model" in even
        chunks (``t`` the local chunk: phi4-mini's ``wq`` at tp 16
        holds 1.5 heads a rank).  Where tp divides n the chunk is those
        heads; else the leaf is gathered over "model" and narrowed to
        them (backward: the reduce-scatter of a gradient that is zero
        outside the range, back into the storage chunk).  A packed
        view (sharded serving's column view, cut to the head range once
        at placement) is returned as it is."""
        if isinstance(t, QLinear) or self.tp == 1 or n % self.tp == 0:
            return t
        width = t.shape[dim] * self.tp // n
        lo, hi = self.heads(n)
        return C.all_gather(t, dim, self.group("model")).narrow(
            dim, lo * width, (hi - lo) * width)

    def gather_heads(self, t: torch.Tensor, n: int, dim: int,
                     rep: bool = False) -> torch.Tensor:
        """All ``n`` heads along ``dim`` from every rank's :meth:`heads`
        of them (``t``: this rank's, possibly none): each part padded
        with zeros to ceil(n / tp) heads, gathered over "model", and the
        padding stripped (in the ceil layout the heads are the first n
        of the padded whole).  Backward: the gradient's reduce-scatter
        (:meth:`gather_model`), or with ``rep`` this rank's part of it
        (:meth:`gather_rep`, for a computation every model rank runs
        alike)."""
        if self.tp == 1:
            return t
        group = self.group("model")
        c = -(-n // self.tp)
        if t.shape[dim] < c:
            shape = list(t.shape)
            shape[dim] = c - t.shape[dim]
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        whole = (C.gather_narrow(t, dim, group) if rep
                 else C.all_gather(t, dim, group))
        return whole.narrow(dim, 0, n)

    def gather_rep(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` gathered over "model" along ``dim`` for a computation
        that every model rank runs alike (the sLSTM's scan); its
        backward keeps this rank's part of the gradient, which every
        rank holds whole."""
        return t if self.tp == 1 else C.gather_narrow(t, dim,
                                                      self.group("model"))

    def experts(self, t: torch.Tensor, n_experts: int, ffn_dim: int
                ) -> torch.Tensor:
        """A floating-point expert leaf (E or E/tp, ...), gathered over
        data, -> its compute shard (E, ..., ffn/tp).  Under EP it holds
        E/tp whole experts, and the all-to-all over "model" trades them
        for every expert's ffn part (backward: the inverse all-to-all);
        without EP it is the compute shard already.  A packed leaf is
        refused: sharded serving lays its experts out once at placement
        (``distributed.sharding.expert_local``)."""
        if isinstance(t, QLinear):
            raise TypeError("a packed expert leaf takes the layout of "
                            "sharding.expert_local, not the all-to-all")
        if self.tp == 1 or t.shape[0] == n_experts:
            return t
        return C.all_to_all(t, ffn_dim, 0, self.group("model"))

    def data_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` joined, pod major (backward:
        the reduce-scatter)."""
        for n in reversed(self.data_dims):
            if self._size(n) > 1:
                x = C.all_gather(x, 0, self.group(n))
        return x

    def model_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over "model", without gradient."""
        if self.tp == 1:
            return x
        return C.all_reduce_(x.detach().clone(), self.group("model"), "max")

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks, without gradient (token counts,
        the reported loss)."""
        x = x.detach()
        groups = self._groups(self.data_dims)
        if groups:
            x = x.clone()
            for g in groups:
                C.all_reduce_(x, g, "sum")
        return x

    def rows(self, n: int) -> slice:
        """This data rank's rows of ``n`` (the batch over data, pod
        major); every row when the batch is not sharded
        (``par.shard_batch`` off: every data rank runs the same rows)."""
        if not self.par.shard_batch:
            return slice(0, n)
        if n % self.dp:
            raise ValueError(f"{n} rows do not split over {self.dp} data "
                             "ranks")
        k = n // self.dp
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)
