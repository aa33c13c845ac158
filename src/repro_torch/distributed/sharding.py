"""Logical axes -> mesh specs -> DTensor placements (twin of
``repro.distributed.sharding``).

One rule table turns every parameter / optimizer-state tree into a spec
tree for any mesh:

  vocab/heads/kv_heads/ffn/rnn/ctx -> "model"          (tensor parallel)
  experts                          -> "model" (EP) or replicated
  embed                            -> ("pod", "data") under FSDP, else
                                      replicated
  batch                            -> ("pod", "data")   (data parallel)
  layers / None                    -> replicated

Conflicts (one mesh dim twice in a spec) resolve first-come: later dims
degrade to replicated, as in the reference.

A :class:`Spec` is the port's ``PartitionSpec``: a tuple with, per
tensor dim, None, a mesh dim name, or a tuple of names.
:func:`placements` turns it into DTensor placements, one per mesh dim:
``Shard(i)`` where tensor dim i lies over that mesh dim, else
``Replicate()``.  A tensor dim over ("pod", "data") is sharded on both,
pod major, as JAX shards it.  Shards are even: a dim that a mesh dim
does not divide raises, but for the fields of a packed ``QLinear``.

A packed leaf's fields shard along the reference's ``qlinear_specs``
(``field_axes``): its byte rows (``w4`` (k_s/2, N), ``bits`` (k_b/8,
N)) and per-channel vectors (``perm``, ``s4``, ``z4``, ``alpha_r2``)
over the input dim's mesh dims, its columns and ``alpha_s``, ``alpha_r1``
over the output dim's.  Their lengths rarely divide the mesh (LLaMA-7B's
``wo`` at tp 4: 410 ``bits`` rows), so their chunks are uneven: rank r
of n holds ``[r·c, min((r+1)·c, len))`` with c = ceil(len / n), the
layout of ``torch.chunk`` and of GSPMD's padding, empty past the end.
:func:`qlinear_local` turns a placed leaf into this rank's view for the
packed matmul: column-parallel, its columns (a query projection whose
heads tp does not divide: the columns of the rank's whole heads,
:func:`head_view`); row-parallel, its byte rows with the O(K) vectors
that belong to them.  A stacked expert leaf
takes the reference's quantized MoE layout instead, whatever its
storage spec (:func:`expert_local`): ``wg`` / ``wu`` over ffn, ``wd``
whole.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.qlinear import FIELDS, QLinear
from repro_torch.core.select import map_tree
from repro_torch.distributed import collectives as C
from repro_torch.models.param import P

try:                                     # torch >= 2.4
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:                      # pragma: no cover - older torch
    from torch.distributed._tensor import DTensor, Replicate, Shard

Tree = Any


class Spec(tuple):
    """Per tensor dim: None, a mesh dim name or a tuple of names; a
    tuple of one name is that name, as ``PartitionSpec`` has it."""

    def __new__(cls, entries=()):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Rules:
    """Sharding rule table; built per run from the mesh and options."""

    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)      # ("pod", "data") multi-pod
    fsdp: bool = False
    ep: bool = False                          # shard MoE expert dim

    def axis_map(self) -> Dict[Optional[str], Any]:
        return {
            "vocab": self.tp_axis,
            "heads": self.tp_axis,
            "kv_heads": self.tp_axis,
            "ctx": self.tp_axis,
            "ffn": self.tp_axis,
            "rnn": self.tp_axis,
            "experts": self.tp_axis if self.ep else None,
            "embed": self.dp_axes if self.fsdp else None,
            "batch": self.dp_axes,
            "layers": None,
            None: None,
        }

    def spec(self, axes: Tuple[Optional[str], ...]) -> Spec:
        amap = self.axis_map()
        used = set()
        out = []
        for a in axes:
            mesh_ax = amap.get(a, None)
            flat = (mesh_ax,) if isinstance(mesh_ax, str) else \
                tuple(mesh_ax or ())
            if any(f in used for f in flat) or not flat:
                out.append(None)
            else:
                used.update(flat)
                out.append(mesh_ax if isinstance(mesh_ax, str) else flat)
        return Spec(out)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a stub's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def rules_for_mesh(mesh, *, fsdp: bool = False, ep: bool = False) -> Rules:
    dp = ("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",)
    return Rules(tp_axis="model", dp_axes=dp, fsdp=fsdp, ep=ep)


def specs_for_tree(declared: Tree, rules: Rules, params: Tree = None) -> Tree:
    """P declaration tree -> Spec tree (same structure).  Given the
    ``params`` the declaration describes, a leaf that is a packed
    ``QLinear`` there gets the QLinear of Specs of :func:`qlinear_specs`
    (as ``launch.qdeclare.declare_quantized`` gives it)."""
    def leaf(path, p):
        if not isinstance(p, P):
            raise TypeError(f"specs_for_tree expects P leaves, got {type(p)}")
        q = _find(params, path)
        if isinstance(q, QLinear):
            return qlinear_specs(p.axes, q.k_s, q.k, q.n, rules)
        return rules.spec(p.axes)
    return map_tree(declared, leaf)


def _find(tree: Tree, path: Tuple):
    """The node of ``tree`` at ``path``, or None where it has none."""
    for k in path:
        try:
            tree = tree[k]
        except (KeyError, IndexError, TypeError):
            return None
    return tree


def field_axes(prefix: Tuple, in_ax, out_ax) -> Dict[str, Tuple]:
    """Logical axes per QLinear field, given the weight's (prefix...,
    in_ax, out_ax) axes (the reference's ``core.qlinear.field_axes``)."""
    return {
        "perm": prefix + (in_ax,),
        "w4": prefix + (in_ax, out_ax),
        "s4": prefix + (in_ax,),
        "z4": prefix + (in_ax,),
        "bits": prefix + (in_ax, out_ax),
        "alpha_s": prefix + (out_ax,),
        "alpha_r1": prefix + (out_ax,),
        "alpha_r2": prefix + (in_ax,),
    }


def qlinear_specs(p_axes: Tuple, k_s: int, k: int, n: int,
                  rules: Rules) -> QLinear:
    """A QLinear of Specs for a weight declared with axes ``p_axes``
    (prefix..., in_axis, out_axis)."""
    fa = field_axes(p_axes[:-2], p_axes[-2], p_axes[-1])
    return QLinear(**{f: rules.spec(fa[f]) for f in FIELDS},
                   k_s=k_s, k=k, n=n)


# ---------------------------------------------------------------------------
# DTensor placements and the state on the mesh
# ---------------------------------------------------------------------------
def _names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(i)`` where tensor dim i of
    ``spec`` lies over it, else ``Replicate()``."""
    dim_of = {}
    for i, entry in enumerate(spec):
        for n in _names(entry):
            dim_of[n] = i
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh_axis_names(mesh))


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


@torch.no_grad()
def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a DTensor (the same storage, outside autograd:
    the sharded step differentiates its local tensors); a plain tensor
    as it is."""
    return t.to_local() if is_dtensor(t) else t


@torch.no_grad()
def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a local part shaped as ``ref``'s, as a DTensor placed as
    ``ref`` when ``ref`` is one."""
    if not is_dtensor(ref):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False)


def shard_groups(t) -> list:
    """The process groups of the mesh dims over which a DTensor is
    sharded (size > 1): a reduction over its whole value sums or takes
    the max of the local parts over these and no others, so a
    replicated part is counted once."""
    if not is_dtensor(t):
        return []
    mesh = t.device_mesh
    names = mesh_axis_names(mesh)
    return [mesh.get_group(n) for i, (n, pl) in
            enumerate(zip(names, t.placements))
            if isinstance(pl, Shard) and mesh.size(i) > 1]


def chunk_range(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of part ``i`` of ``n`` items cut into ``parts`` chunks
    of ceil(n / parts), the last ones short or empty (``torch.chunk``'s
    layout, which DTensor's ``Shard`` and GSPMD's padding share)."""
    c = -(-n // parts)
    lo = min(i * c, n)
    return lo, min(lo + c, n)


def local_part(full: torch.Tensor, mesh, places, uneven: bool = False
               ) -> torch.Tensor:
    """This rank's part of ``full`` under ``places`` (a view; mesh dims
    in order, so two mesh dims on one tensor dim shard it major
    first).  A dim a mesh dim does not divide raises, unless
    ``uneven``: then each rank takes its :func:`chunk_range`."""
    t = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n, size = mesh.size(i), t.shape[pl.dim]
            if size % n and not uneven:
                raise ValueError(
                    f"dim {pl.dim} of {tuple(full.shape)} does not split "
                    f"over {n} ranks of mesh dim "
                    f"{mesh_axis_names(mesh)[i]!r}")
            lo, hi = chunk_range(size, n, mesh.get_local_rank(i))
            t = t.narrow(pl.dim, lo, hi - lo)
    return t


def distribute(full, spec, mesh):
    """A full tensor (the same on every rank) -> a DTensor of a copy of
    its part under ``spec``, on the mesh's device, without
    communication.  A packed ``QLinear`` (``spec`` its QLinear of Specs)
    -> the same QLinear with every field so placed, in uneven chunks."""
    if isinstance(full, QLinear):
        return dataclasses.replace(full, **{
            f: _place(getattr(full, f), getattr(spec, f), mesh, True)
            for f in FIELDS})
    return _place(full, spec, mesh, False)


def _place(full: torch.Tensor, spec, mesh, uneven: bool) -> torch.Tensor:
    places = placements(spec, mesh)
    part = local_part(full, mesh, places, uneven)
    out = torch.empty(part.shape, dtype=part.dtype, device=mesh.device_type)
    out.copy_(part)
    return DTensor.from_local(out, mesh, places, run_check=False,
                              shape=full.shape, stride=full.stride())


def at(tree: Tree, path: Tuple) -> Any:
    """The node of ``tree`` at ``path`` (keys and indices, as
    ``core.select.map_tree`` gives them): a leaf's Spec in a spec tree
    of the same structure."""
    for k in path:
        tree = tree[k]
    return tree


def distribute_tree(tree: Tree, spec_tree: Tree, mesh) -> Tree:
    """The counterpart of ``named_shardings`` plus the device put: every
    tensor of ``tree`` distributed by its Spec in ``spec_tree``, every
    packed ``QLinear`` field by its QLinear of Specs."""
    return map_tree(tree, lambda path, t: distribute(t, at(spec_tree, path),
                                                     mesh))


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


# ---------------------------------------------------------------------------
# A rank's view of a placed packed leaf
# ---------------------------------------------------------------------------
def qlinear_role(spec: QLinear, tp_axis: str = "model") -> Optional[str]:
    """How a packed leaf with specs ``spec`` splits over ``tp_axis``:
    "row" (its input dim: the byte rows), "column" (its output dim) or
    None (replicated)."""
    w4 = tuple(spec.w4)
    if tp_axis in _names(w4[-2]):
        return "row"
    if tp_axis in _names(w4[-1]):
        return "column"
    return None


def _row_view(perm, s4, z4, alpha_r2, w4, bits, alpha_s, alpha_r1,
              k_s: int, rows4: Tuple[int, int], rowsb: Tuple[int, int]
              ) -> QLinear:
    """The row-parallel view of one rank: its byte rows ``w4`` (rows
    ``rows4`` of the leaf's, 2 channels each) and ``bits`` (``rowsb``, 8
    channels each), and of the leaf's whole O(K) vectors the entries of
    those channels: its salient-first ``perm`` (channels of the whole
    input), ``s4``, ``z4`` and ``alpha_r2``."""
    (a4, e4), (ab, eb) = rows4, rowsb
    lo_s, hi_s, lo_b, hi_b = 2 * a4, 2 * e4, 8 * ab, 8 * eb
    own = torch.cat([perm[lo_s:hi_s], perm[k_s + lo_b:k_s + hi_b]])
    return QLinear(own.contiguous(), w4, s4[lo_s:hi_s].contiguous(),
                   z4[lo_s:hi_s].contiguous(), bits, alpha_s, alpha_r1,
                   alpha_r2[lo_b:hi_b].contiguous(), k_s=hi_s - lo_s,
                   k=hi_s - lo_s + hi_b - lo_b, n=int(alpha_s.shape[-1]))


def local_view(q: QLinear, role: Optional[str], rank: int, tp: int
               ) -> QLinear:
    """Rank ``rank``'s view of the whole leaf ``q`` split ``role``-wise
    over ``tp`` ranks, as :func:`qlinear_local` builds it from the placed
    leaf: the packed matmul of x by a column view gives the rank's
    columns of x @ q; by a row view, of the whole x, the rank's partial
    sum of x @ q (the f32 partials of all ranks add up to the leaf's
    accumulator)."""
    if role is None or tp == 1:
        return q
    if role == "column":
        lo, hi = chunk_range(q.n, tp, rank)
        cut = lambda t: t[..., lo:hi].contiguous()
        return dataclasses.replace(q, w4=cut(q.w4), bits=cut(q.bits),
                                   alpha_s=cut(q.alpha_s),
                                   alpha_r1=cut(q.alpha_r1), n=hi - lo)
    rows4 = chunk_range(q.w4.shape[0], tp, rank)
    rowsb = chunk_range(q.bits.shape[0], tp, rank)
    return _row_view(q.perm, q.s4, q.z4, q.alpha_r2,
                     q.w4[rows4[0]:rows4[1]].contiguous(),
                     q.bits[rowsb[0]:rowsb[1]].contiguous(), q.alpha_s,
                     q.alpha_r1, q.k_s, rows4, rowsb)


def _refuse_data(spec: QLinear) -> None:
    """Raise for a packed leaf whose specs put a field over data."""
    for f in FIELDS:
        for entry in getattr(spec, f):
            if any(n != "model" for n in _names(entry)):
                raise NotImplementedError(
                    "a packed leaf sharded over data (FSDP): serving keeps "
                    "packed leaves replicated over data")


def _gather_columns(lq: QLinear, n: int, group) -> QLinear:
    """A column view's placed chunks (``w4``, ``bits``, ``alpha_s``,
    ``alpha_r1`` along N) gathered over ``group`` into the whole leaf's
    columns, once at placement."""
    def whole(t):
        return C.gather_chunks(t.movedim(-1, 0).contiguous(), n,
                               group).movedim(0, -1)
    return dataclasses.replace(lq, w4=whole(lq.w4), bits=whole(lq.bits),
                               alpha_s=whole(lq.alpha_s),
                               alpha_r1=whole(lq.alpha_r1), n=n)


def head_view(q: QLinear, heads: int, rank: int, tp: int) -> QLinear:
    """Rank ``rank``'s column view of the whole leaf ``q`` whose N
    columns are ``heads`` heads: the columns of its whole heads
    (:func:`chunk_range` of the heads; phi4-mini's ``wq`` at tp 16: 256
    columns on ranks 0-11, none on 12-15), ``perm`` and the O(K)
    vectors whole."""
    width = q.n // heads
    lo, hi = chunk_range(heads, tp, rank)
    cut = lambda t: t[..., lo * width:hi * width].contiguous()  # noqa: E731
    return dataclasses.replace(q, w4=cut(q.w4), bits=cut(q.bits),
                               alpha_s=cut(q.alpha_s),
                               alpha_r1=cut(q.alpha_r1),
                               n=(hi - lo) * width)


def qlinear_local(q: QLinear, spec: QLinear, shards,
                  heads: Optional[int] = None) -> QLinear:
    """This rank's view of a placed packed leaf ``q`` (fields DTensors
    placed by :func:`distribute` under ``spec``) for the packed matmul.

    Column-parallel (the output dim over "model": wq, wk, wv, wg, wu):
    the local fields are the view, N/tp columns of ``w4``, ``bits``,
    ``alpha_s`` and ``alpha_r1`` beside the whole ``perm``, ``s4``,
    ``z4`` and ``alpha_r2``.  A query projection whose ``heads`` tp
    does not divide takes the columns of the rank's whole heads
    instead (:func:`head_view`, possibly none), cut from its columns
    gathered over "model" once here.  Row-parallel (the input dim over "model":
    wo, wd): the local byte rows of ``w4`` and ``bits`` say which
    salient and binary channels the rank owns; the spec's chunks of
    ``perm`` (K), ``s4``/``z4`` (k_s) and ``alpha_r2`` (k_b) do not line
    up with them (LLaMA-7B's ``wo`` at tp 16: 51 channels of ``s4``
    against 26 rows = 52 channels of ``w4``), so those O(K) vectors are
    gathered over "model" here, once at placement, and cut to the
    rank's rows; the O(K·N) bytes never move.  The view's ``perm``
    names channels of the whole input, which a row-parallel product
    gathers first (``models.common.Shards.row``).  A packed leaf
    sharded over data (FSDP) is refused."""
    _refuse_data(spec)
    lq = q.map(local)
    role = qlinear_role(spec, "model")
    if role is None or shards.tp == 1:
        return lq
    if role == "column":
        if heads is not None and heads % shards.tp:
            return head_view(_gather_columns(lq, q.n, shards.group("model")),
                             heads, shards.tp_rank, shards.tp)
        if q.n % shards.tp:
            raise ValueError(f"a packed leaf of {q.n} columns does not "
                             f"split over tp={shards.tp}")
        return dataclasses.replace(lq, n=int(lq.alpha_s.shape[-1]))
    group, tp, r = shards.group("model"), shards.tp, shards.tp_rank
    rows4 = chunk_range(q.k_s // 2, tp, r)
    rowsb = chunk_range(q.k_b // 8, tp, r)
    if (lq.w4.shape[0], lq.bits.shape[0]) != (rows4[1] - rows4[0],
                                              rowsb[1] - rowsb[0]):
        raise ValueError(f"the placed byte rows {tuple(lq.w4.shape)}, "
                         f"{tuple(lq.bits.shape)} are not rank {r}'s "
                         f"chunks {rows4}, {rowsb}")
    whole = {f: C.gather_chunks(getattr(lq, f), n, group)
             for f, n in (("perm", q.k), ("s4", q.k_s), ("z4", q.k_s),
                          ("alpha_r2", q.k_b))}
    return _row_view(whole["perm"], whole["s4"], whole["z4"],
                     whole["alpha_r2"], lq.w4, lq.bits, lq.alpha_s,
                     lq.alpha_r1, q.k_s, rows4, rowsb)


# the stacked expert leaves whose ffn (N) the packed MoE splits over
# "model"; every other expert leaf (wd) is held whole
EXPERT_COLUMNS = ("wg", "wu")


def expert_local(q: QLinear, spec: QLinear, shards, column: bool
                 ) -> QLinear:
    """This rank's compute view of a placed packed expert leaf (fields
    (E, ...)), the layout of the reference's quantized
    ``_apply_moe_shard_map``: ``wg`` and ``wu`` (``column``) split over
    "model" along their ffn columns for all E experts, ``wd`` whole (run
    at full K, no partial sums).  Whatever the storage spec (EP: the
    experts over "model"; else the ffn), every field is gathered whole
    over "model" here, once at placement, then a column view keeps its
    N/tp columns; the packed bytes move once, never per call."""
    _refuse_data(spec)
    lq = q.map(local)
    if shards.tp > 1:
        group = shards.group("model")
        fields = {}
        for f in FIELDS:
            t = getattr(lq, f)
            for i, entry in enumerate(getattr(spec, f)):
                if "model" in _names(entry):
                    n = getattr(q, f).shape[i]
                    t = C.gather_chunks(t.movedim(i, 0).contiguous(), n,
                                        group).movedim(0, i).contiguous()
            fields[f] = t
        lq = dataclasses.replace(lq, **fields)
    if not column:
        return lq
    if q.n % shards.tp:
        raise ValueError(f"a packed expert leaf of {q.n} columns does not "
                         f"split over tp={shards.tp}")
    return local_view(lq, "column", shards.tp_rank, shards.tp)


def local_tree(tree: Tree, spec_tree: Tree, shards, heads=None) -> Tree:
    """A placed tree (:func:`distribute_tree`) -> this rank's local
    tensors, each packed leaf as its :func:`qlinear_local` view (given
    ``heads(path)``, the heads of a query projection's columns, or
    None), each packed expert leaf as its :func:`expert_local` one."""
    def leaf(path, t):
        if isinstance(t, QLinear) and t.w4.ndim == 3:
            return expert_local(t, at(spec_tree, path), shards,
                                path[-1] in EXPERT_COLUMNS)
        if isinstance(t, QLinear):
            return qlinear_local(t, at(spec_tree, path), shards,
                                 None if heads is None else heads(path))
        return local(t)
    return map_tree(tree, leaf)
