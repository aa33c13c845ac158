"""Per-device analysis of one traced step: the counterpart of
``repro.launch.hlo_analysis``.

The reference compiles each cell and parses the optimized HLO, whose
``while`` loops (the scans over layers, microbatches and attention
chunks) it multiplies by their trip counts.  PyTorch has no HLO to
parse: the port's step runs eagerly, every layer and every microbatch
one op after another, so the ops themselves are counted as they are
dispatched and there are no trip counts to multiply.  The dry-run
(``launch/dryrun.py``) runs rank 0's step on tensors that hold no data
(``FakeTensorMode``) over a "fake" process group; :class:`StepAnalysis`
is the one context it runs the step in:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``, the matmul
  family plus the packed op ``repro_torch::packed_matmul`` (2·M·K·N,
  ``kernels/mixed_matmul.py``).  This is the reference's count of
  ``dot`` work: elementwise ops are not counted.
* **bytes**: every aten op that is not a view or a metadata op reads
  each of its tensor arguments once and writes each tensor it returns
  that is not one of its arguments once.  Eager PyTorch materializes
  every op, so this is the eager port's HBM traffic with no cache
  reuse (the record names it ``eager_op_bytes``); the reference's
  count is after XLA's fusion.
* **transcendentals**: output elements of exp, log, tanh, sigmoid,
  rsqrt, sqrt, erf, pow and the ops built on them (softmax, log-softmax,
  silu, gelu), as XLA counts them.
* **collectives**, counted where they are dispatched (the c10d ops the
  port's explicit collectives call, and the functional collectives of
  DTensor's own redistributions), not at the port's call sites: kind,
  result bytes, the group's size and its mesh axis, and operand and
  ring wire bytes by :func:`_derive_bytes`, the reference's formulas.
* **packed calls**: the packed op's calls by (M, K, N), as the CUDA
  kernel's wrapper counts its launches.
* **top contributors**, by aten op and by collective kind × axis.  The
  port's blocks are functions, not ``nn.Module``s, so there are no
  per-module rows.
* **memory**: the bytes of live storages, op by op: the step's
  arguments (this rank's state and inputs), its peak, its outputs, and
  the argument bytes it wrote in place (the state and caches the
  reference donates).

:func:`roofline_terms` keeps the reference's signature and formulas,
with the H100's data-sheet rates as defaults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.mixed_matmul import packed_shape

PACKED_OP = "repro_torch.packed_matmul"
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace.name, overload stripped) -> collective kind
_COLL_KIND = {
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.broadcast_": "broadcast",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
}
# c10d ops that take their results as arguments (output, input, ...):
# the result is argument 0 (a tensor, or a list of them)
_OUT_ARG0 = frozenset(k for k in _COLL_KIND if k.startswith("c10d."))

# ops that move no bytes: allocation, aliasing, metadata, host reads
_FREE = frozenset({
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten.detach",
    "aten.alias", "aten.lift_fresh", "aten._local_scalar_dense",
    "aten.resize_", "aten.set_", "aten.is_same_size", "aten.sym_size",
    "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset",
    "_c10d_functional.wait_tensor", "aten.is_nonzero",
})

# ops that write some elements of argument 0 in place: they move the
# elements written (twice: read and written, the reference's count of a
# scatter) and their other arguments, not the whole of argument 0
_SCATTER = frozenset(f"aten.{n}" for n in (
    "index_put_", "_index_put_impl_", "index_copy_", "index_add_",
    "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_",
    "masked_scatter_", "masked_fill_"))
# ops that read some elements of argument 0: they move what they
# return (twice) and their other arguments, not the whole of argument 0
_GATHER = frozenset(f"aten.{n}" for n in (
    "index", "index_select", "gather", "embedding", "take"))

# output elements of these count as transcendentals
_TRANSCENDENTAL = frozenset(
    f"aten.{n}" for n in (
        "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2",
        "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt",
        "sqrt_", "erf", "erf_", "pow", "pow_", "sin", "cos", "_softmax",
        "_log_softmax", "logsumexp", "silu", "silu_", "silu_backward",
        "gelu", "gelu_", "gelu_backward", "softplus", "logaddexp"))

# ---------------------------------------------------------------------------
# Roofline constants: NVIDIA H100 SXM5 80GB at 700 W (the card
# chip_smoke.py reports), from its data sheet, not measured.
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12        # HBM3 bytes/s (data sheet)
# bytes/s a GPU a direction across nodes: one NDR InfiniBand port (400
# Gb/s) per GPU (data sheet).  Every group of the production meshes
# spans more than one 8-GPU NVLink domain: "model" groups are 16
# consecutive ranks, "data" groups are strided by 16, "pod" groups by
# 256; so the link a collective waits on is the network's, not NVLink's.
ICI_BW = 50e9


def _derive_bytes(kind: str, result_bytes: int, g: int) -> Tuple[int, int]:
    """(operand_bytes, modeled ring wire bytes per device): the
    reference's formulas (``hlo_analysis._derive_bytes``)."""
    g = max(g, 1)
    if kind == "all-gather":
        op = result_bytes // g
        wire = result_bytes - op            # receive everyone else's shard
    elif kind == "reduce-scatter":
        op = result_bytes * g
        wire = result_bytes * (g - 1)       # send g-1 shards of result size
    elif kind == "all-reduce":
        op = result_bytes
        wire = int(2 * result_bytes * (g - 1) / g)
    elif kind == "all-to-all":
        op = result_bytes
        wire = int(result_bytes * (g - 1) / g)
    else:  # collective-permute: one send + one recv of the buffer
        op = result_bytes
        wire = result_bytes
    return op, wire


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   *, peak=PEAK_FLOPS, hbm=HBM_BW, ici=ICI_BW) -> Dict:
    """Three per-device roofline times (seconds) and the dominant term,
    as the reference's ``roofline_terms``: the inputs are per-device
    quantities, so there is no further division by devices."""
    t_compute = flops / peak
    t_memory = hbm_bytes / hbm
    t_collective = coll_bytes / ici
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_collective)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_time_lower_bound_s": bound,
        "compute_fraction": t_compute / bound if bound > 0 else 0.0,
    }


def _name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree, a dataclass leaf's (a packed ``QLinear``)
    field by field."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            out.extend(_tensors([getattr(t, f.name)
                                 for f in dataclasses.fields(t)]))
    return out


def _flat(x) -> List[torch.Tensor]:
    """The tensors of an op's argument or result: a tensor, or a list
    or tuple of them (nested once, as c10d's lists of lists)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(t for t in v if isinstance(t, torch.Tensor))
        return out
    return []


_INFO: Dict = {}


def _info(func) -> Tuple:
    """(name, moves bytes, transcendental, collective kind, the (index,
    name) of each argument it writes) of an op, cached."""
    hit = _INFO.get(func)
    if hit is None:
        name = _name(func)
        writes = tuple((i, a.name) for i, a in
                       enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write)
        hit = _INFO[func] = (name, name not in _FREE and not func.is_view,
                             name in _TRANSCENDENTAL, _COLL_KIND.get(name),
                             writes)
    return hit


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _storage(t: torch.Tensor):
    """The untyped storage under ``t`` (a DTensor's local part), or None
    for a tensor without one."""
    try:
        return _local(t).untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensors (a
    DTensor's local part; a QLinear's fields)."""
    seen = {}
    for t in _tensors(tree):
        st = _storage(t)
        if st is not None:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Counter(TorchDispatchMode):
    """Bytes, transcendentals, collectives and live storages, op by op."""

    def __init__(self, axes: Dict[str, str]):
        super().__init__()
        self.axes = axes
        self.ops: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "bytes": 0})
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: List[Dict] = []
        self.live: Dict[int, int] = {}       # storage id -> bytes
        self.refs: Dict[int, weakref.ref] = {}
        self.now = 0
        self.peak = 0
        self.args: Dict[int, int] = {}       # the arguments' storages
        self.written: set = set()            # argument storages written
        self.packed: Dict[str, int] = defaultdict(int)   # "MxKxN" -> calls

    # -- live storages -------------------------------------------------
    def _freed(self, key: int, _ref=None) -> None:
        self.now -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count the storages of ``tensors`` as live from now on (until
        they are freed)."""
        for t in tensors:
            st = _storage(t)
            if st is None:
                continue
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.refs[key] = weakref.ref(
                st, lambda r, k=key: self._freed(k, r))
            self.now += n
        self.peak = max(self.peak, self.now)

    def arguments(self, tensors: Iterable[torch.Tensor]) -> int:
        ts = list(tensors)
        self.track(ts)
        for t in ts:
            st = _storage(t)
            if st is not None:
                self.args[st._cdata] = st.nbytes()
        return sum(self.args.values())

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, counted, transcendental, kind, writes = _info(func)
        outs = _flat(out)
        if writes and self.args:
            for i, arg in writes:
                val = kwargs.get(arg, args[i] if i < len(args) else None)
                for t in _flat(val):
                    st = _storage(t)
                    if st is not None and st._cdata in self.args:
                        self.written.add(st._cdata)
        if kind is not None:
            self._collective(name, kind, args, kwargs, outs)
        if name == PACKED_OP:
            m, k, n = packed_shape(args[0].shape, args[2].shape,
                                   args[5].shape)
            self.packed[f"{m}x{k}x{n}"] += 1
        if outs and counted:
            ins = _flat(args) + (_flat(list(kwargs.values())) if kwargs
                                 else [])
            n = self._op_bytes(name, args, ins, outs)
            row = self.ops[name]
            row["count"] += 1
            row["bytes"] += n
            self.bytes += n
        if transcendental:
            self.transcendentals += sum(t.numel() for t in outs)
        self.track(outs)
        return out

    @staticmethod
    def _op_bytes(name, args, ins, outs) -> int:
        """Each tensor argument read once and each tensor returned that is
        not an argument written once; a scatter or a gather moves the
        elements it writes or reads, not the whole of argument 0."""
        if name in _SCATTER or name in _GATHER:
            base = args[0] if args and isinstance(args[0],
                                                  torch.Tensor) else None
            rest = sum(t.nbytes for t in ins if t is not base)
            if name in _GATHER:
                return rest + 2 * sum(t.nbytes for t in outs)
            vals = [t for t in ins if t is not base and
                    t.dtype not in (torch.int64, torch.int32, torch.bool)]
            return rest + sum(t.nbytes for t in vals)
        seen = {id(t) for t in ins}
        return sum(t.nbytes for t in ins) + sum(
            t.nbytes for t in outs if id(t) not in seen)

    def _collective(self, name, kind, args, kwargs, outs) -> None:
        if name in _OUT_ARG0:
            result = _flat(args[0])
            pg = next(dist.ProcessGroup.unbox(a) for a in args
                      if isinstance(a, torch.ScriptObject)
                      and "ProcessGroup" in str(a))
        else:
            result = outs
            group = kwargs.get("group_name", args[-1])
            pg = dist.distributed_c10d._resolve_process_group(group)
        g = pg.size()
        rb = sum(t.nbytes for t in result)
        opb, wire = _derive_bytes(kind, rb, g)
        self.collectives.append({
            "kind": kind, "result_bytes": rb, "operand_bytes": opb,
            "wire_bytes": wire, "group_size": g,
            "axis": self.axes.get(pg.group_name, "world" if g ==
                                  dist.get_world_size() else pg.group_name)})


def collective_summary(colls: List[Dict]) -> Dict:
    """The reference's ``module_analysis`` block of collectives: per kind
    {count, operand_bytes, wire_bytes}, and the totals; beside it the
    same per (kind, mesh axis)."""
    per_kind: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0})
    per_axis: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0,
                 "group_size": 0})
    for c in colls:
        for row, key in ((per_kind, c["kind"]),
                         (per_axis, f"{c['kind']}@{c['axis']}")):
            r = row[key]
            r["count"] += 1
            r["operand_bytes"] += c["operand_bytes"]
            r["wire_bytes"] += c["wire_bytes"]
        per_axis[f"{c['kind']}@{c['axis']}"]["group_size"] = c["group_size"]
    return {
        "per_kind": {k: dict(v) for k, v in sorted(per_kind.items())},
        "per_axis": {k: dict(v) for k, v in sorted(per_axis.items())},
        "operand_bytes": int(sum(k["operand_bytes"]
                                 for k in per_kind.values())),
        "wire_bytes": int(sum(k["wire_bytes"] for k in per_kind.values())),
        "n_collectives": int(sum(k["count"] for k in per_kind.values())),
    }


def mesh_axes(mesh) -> Dict[str, str]:
    """{process group name: mesh dim name} of ``mesh`` (a
    ``DeviceMesh``)."""
    if mesh is None:
        return {}
    return {mesh.get_group(n).group_name: n
            for n in (mesh.mesh_dim_names or ())}


class StepAnalysis(contextlib.AbstractContextManager):
    """The one context a traced step runs in: ``FlopCounterMode`` and the
    counter of bytes, transcendentals, collectives and live storages.

        with StepAnalysis(mesh) as sa:
            sa.arguments(state_and_inputs)
            out = step(...)
            sa.outputs(out)
        rec = sa.result()
    """

    def __init__(self, mesh=None):
        self.flop = FlopCounterMode(display=False)
        self.counter = _Counter(mesh_axes(mesh))
        self.arg_bytes = 0
        self.out_bytes = 0
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self) -> "StepAnalysis":
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self.flop)
        self._stack.enter_context(self.counter)
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def arguments(self, tree) -> int:
        """Count ``tree``'s tensors as the step's arguments (live from the
        start); returns their bytes."""
        self.arg_bytes = self.counter.arguments(_tensors(tree))
        return self.arg_bytes

    def outputs(self, tree) -> int:
        """The bytes of ``tree``'s storages that are not arguments'."""
        seen, n = set(), 0
        for t in _tensors(tree):
            st = _storage(t)
            if st is None or st._cdata in seen or \
                    st._cdata in self.counter.args:
                continue
            seen.add(st._cdata)
            n += st.nbytes()
        self.out_bytes = n
        return n

    def memory(self) -> Dict[str, int]:
        c = self.counter
        return {"argument_bytes": int(self.arg_bytes),
                "output_bytes": int(self.out_bytes),
                "peak_bytes": int(c.peak),
                "temp_bytes": int(c.peak - self.arg_bytes),
                "alias_bytes": int(sum(c.args[k] for k in c.written))}

    def flops(self) -> int:
        return int(self.flop.get_total_flops())

    def op_flops(self) -> Dict[str, int]:
        return {f"{p._qualified_op_name.replace('::', '.')}": int(v)
                for p, v in self.flop.get_flop_counts()
                .get("Global", {}).items()}

    def top_contributors(self, k: int) -> Dict[str, List[Dict]]:
        """Rows of the reference's ``top_contributors`` (name, mult,
        flops, bytes, coll_wire): one per aten op (``mult`` its calls)
        and one per collective kind × mesh axis."""
        flops = self.op_flops()
        rows = {}
        for name, r in self.counter.ops.items():
            rows[name] = {"name": name, "mult": int(r["count"]),
                          "flops": flops.get(name, 0),
                          "bytes": int(r["bytes"]), "coll_wire": 0}
        for name, f in flops.items():
            rows.setdefault(name, {"name": name, "mult": 0, "flops": 0,
                                   "bytes": 0, "coll_wire": 0})["flops"] = f
        for key, r in collective_summary(
                self.counter.collectives)["per_axis"].items():
            rows[key] = {"name": key, "mult": r["count"], "flops": 0,
                         "bytes": 0, "coll_wire": r["wire_bytes"]}
        rows = list(rows.values())
        return {
            "by_flops": sorted(rows, key=lambda r: -r["flops"])[:k],
            "by_bytes": sorted(rows, key=lambda r: -r["bytes"])[:k],
            "by_coll": sorted(rows, key=lambda r: -r["coll_wire"])[:k],
        }

    def result(self, k: int = 5) -> Dict:
        coll = collective_summary(self.counter.collectives)
        flops = float(self.flops())
        nbytes = float(self.counter.bytes)
        return {
            "flops_per_device": flops,
            "bytes_accessed_per_device": nbytes,
            "bytes_model": "eager_op_bytes",
            "top": self.top_contributors(k),
            "transcendentals": float(self.counter.transcendentals),
            "collectives": coll,
            "packed_calls": dict(sorted(self.counter.packed.items())),
            "memory": self.memory(),
            "roofline": roofline_terms(flops, nbytes, coll["wire_bytes"]),
        }
