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
does not divide raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.qlinear import FIELDS, QLinear
from repro_torch.core.select import map_tree
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


def specs_for_tree(declared: Tree, rules: Rules) -> Tree:
    """P declaration tree -> Spec tree (same structure)."""
    def leaf(_, p):
        if isinstance(p, P):
            return rules.spec(p.axes)
        raise TypeError(f"specs_for_tree expects P leaves, got {type(p)}")
    return map_tree(declared, leaf)


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


def local_part(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's part of ``full`` under ``places`` (a view; mesh dims
    in order, so two mesh dims on one tensor dim shard it major
    first)."""
    t = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(
                    f"dim {pl.dim} of {tuple(full.shape)} does not split "
                    f"over {n} ranks of mesh dim "
                    f"{mesh_axis_names(mesh)[i]!r}")
            k = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, mesh.get_local_rank(i) * k, k)
    return t


def distribute(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A full tensor (the same on every rank) -> a DTensor of a copy of
    its part under ``spec``, on the mesh's device, without
    communication."""
    places = placements(spec, mesh)
    part = local_part(full, mesh, places)
    out = torch.empty(part.shape, dtype=part.dtype, device=mesh.device_type)
    out.copy_(part)
    return DTensor.from_local(out, mesh, places, run_check=False)


def at(tree: Tree, path: Tuple) -> Any:
    """The node of ``tree`` at ``path`` (keys and indices, as
    ``core.select.map_tree`` gives them): a leaf's Spec in a spec tree
    of the same structure."""
    for k in path:
        tree = tree[k]
    return tree


def distribute_tree(tree: Tree, spec_tree: Tree, mesh) -> Tree:
    """The counterpart of ``named_shardings`` plus the device put: every
    tensor of ``tree`` distributed by its Spec in ``spec_tree``."""
    return map_tree(tree, lambda path, t: distribute(t, at(spec_tree, path),
                                                     mesh))


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t
